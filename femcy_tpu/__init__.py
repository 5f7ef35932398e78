"""femcy-tpu: a finite-element framework in JAX / XLA.

A ground-up re-design of the capabilities of mo-hanxuan/FEMcy:

- static-shape, fixed-topology meshes whose assembly compiles to a single
  XLA program (vmapped per-element B^T C B + one sorted segment-sum scatter),
- a Jacobi-preconditioned CG that runs entirely inside ``jax.lax.while_loop``
  (zero host round-trips per iteration),
- geometric nonlinearity (updated-Lagrangian Newton-Raphson with adaptive
  load stepping) orchestrated on host around jitted device steps,
- multi-device scaling via ``jax.sharding.Mesh`` + ``shard_map`` with XLA
  collectives (elements sharded for assembly, rows for SpMV).

Reference capability surface: FEMcy (Taichi/CUDA) -- see SURVEY.md.  This
package is an independent implementation; files cite the reference as
``file:line`` only to document behavioural parity.
"""

import os

# FEM needs f64 accumulation for the published accuracy targets (<=0.1%
# stress error, nu=0.4999 near-incompressible cases).  Enable x64 before any
# JAX arrays are created.  Set FEMCY_TPU_X64=0 to run in f32 (accuracy-gated
# workloads should keep f64).
if os.environ.get("FEMCY_TPU_X64", "1") != "0":
    import jax

    jax.config.update("jax_enable_x64", True)

# An f32 matmul on an NVIDIA GPU runs in TF32 by default (about three decimal
# digits), too coarse for the <=0.1% stress gate once it enters every
# assembly einsum.  Force full-f32 matmul precision framework-wide.
# FEMCY_TPU_MATMUL_PRECISION overrides (e.g. "default" for TF32).
import jax as _jax  # noqa: E402

_jax.config.update(
    "jax_default_matmul_precision",
    os.environ.get("FEMCY_TPU_MATMUL_PRECISION", "highest"),
)

__version__ = "0.1.0"

from femcy_tpu.config import SolverConfig  # noqa: E402
from femcy_tpu.mesh import FEMesh  # noqa: E402
from femcy_tpu.system import FEMSystem  # noqa: E402
from femcy_tpu.io.inp import (  # noqa: E402
    InpBlockModel,
    InpModel,
    read_inp,
    read_inp_multi,
)
from femcy_tpu.multiblock import (  # noqa: E402
    ElementBlock,
    MultiBlockSystem,
    system_from_model,
)
from femcy_tpu.materials import (  # noqa: E402
    LinearIsotropic,
    LinearIsotropicPlaneStress,
    LinearIsotropicPlaneStrain,
    NeoHookean,
    material_from_inp,
)
from femcy_tpu import meshgen  # noqa: E402
from femcy_tpu.beam import (  # noqa: E402
    BeamModel,
    BeamSection,
    read_beam_inp,
    solve_beam,
)
from femcy_tpu.mixed import (  # noqa: E402
    MixedModel,
    MixedSystem,
    read_mixed_inp,
    solve_mixed,
)

__all__ = [
    "BeamModel",
    "BeamSection",
    "read_beam_inp",
    "solve_beam",
    "MixedModel",
    "MixedSystem",
    "read_mixed_inp",
    "solve_mixed",
    "SolverConfig",
    "FEMesh",
    "FEMSystem",
    "InpModel",
    "read_inp",
    "InpBlockModel",
    "read_inp_multi",
    "ElementBlock",
    "MultiBlockSystem",
    "system_from_model",
    "LinearIsotropic",
    "LinearIsotropicPlaneStress",
    "LinearIsotropicPlaneStrain",
    "NeoHookean",
    "material_from_inp",
    "meshgen",
    "__version__",
]
