"""DIA SpMV on an NVIDIA GPU: Pallas through Triton (``backend="triton"``).

y = A @ x with A stored by diagonal offset (solvers/dia.py).  The operator
is transposed once per solve to (K, n_pad), so each program's block of rows
reads K coalesced rows of values plus K shifted windows of the padded x;
the K multiply-adds stay in registers and y is written once.  XLA's own
fusion of the shifted-slice sum (solvers.dia.dia_spmv) reads the row-major
(n, K) values with a K-element stride per thread instead.

Measured on an NVIDIA H100 80GB HBM3 (700 W) at 555,579 dofs, K=59, f32:
0.064 ms per application against XLA's 0.098 ms (bytes bound 0.041 ms), and
6.16 ms against 7.46 ms for assemble + multigrid PCG end to end (PERF.md).

The kernel runs only when compiled for a GPU, or in interpret mode for
tests: asking for it on another backend raises.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: rows per program (a power of two, as Triton requires)
BLOCK = 512


@dataclasses.dataclass(frozen=True)
class SpmvPlan:
    n: int
    n_pad: int
    x_len: int
    block: int
    offsets: Tuple[int, ...]
    pad_lo: int
    interpret: bool = False


def kernel_available(dtype) -> bool:
    """Whether the auto choosers take the kernel: a GPU backend and a
    4-byte dtype (the measured configuration; f64 keeps the XLA path)."""
    return (
        jax.default_backend() == "gpu" and jnp.dtype(dtype).itemsize == 4
    )


def _require_gpu(interpret: bool):
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the Triton DIA SpMV needs a GPU backend (or interpret=True for "
            f"tests); JAX's backend is {jax.default_backend()!r}"
        )


def spmv_plan(n: int, offsets, interpret: bool = False,
              block: int = BLOCK) -> SpmvPlan:
    _require_gpu(interpret)
    offsets = tuple(int(o) for o in offsets)
    pad_lo = max(0, -min(offsets))
    pad_hi = max(0, max(offsets))
    n_pad = -(-n // block) * block
    return SpmvPlan(
        n=n, n_pad=n_pad, x_len=n_pad + pad_lo + pad_hi, block=block,
        offsets=offsets, pad_lo=pad_lo, interpret=interpret,
    )


def prep_values(plan: SpmvPlan, values):
    """(n, K) row-major values -> (K, n_pad) transposed operand (jittable).

    One 2x-traffic pass, amortized over every CG iteration of the solve.
    """
    return jnp.pad(values.T, ((0, 0), (0, plan.n_pad - plan.n)))


def spmv(plan: SpmvPlan, values_t, x):
    """y = A @ x on the transposed DIA operand (jittable)."""
    B, pad_lo = plan.block, plan.pad_lo

    def kernel(x_ref, vt_ref, y_ref):
        s = pl.program_id(0) * B
        acc = jnp.zeros((B,), vt_ref.dtype)
        for k, off in enumerate(plan.offsets):
            acc += vt_ref[k, pl.ds(s, B)] * x_ref[pl.ds(s + pad_lo + off, B)]
        y_ref[pl.ds(s, B)] = acc

    xpad = jnp.pad(x, (pad_lo, plan.x_len - plan.n - pad_lo))
    y = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((plan.n_pad,), values_t.dtype),
        grid=(plan.n_pad // B,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=plan.interpret,
        name="dia_spmv",
    )(xpad, values_t)
    return y[: plan.n]


def make_spmv(n: int, offsets, interpret: bool = False):
    """(prep, apply) pair for solvers.dia.dia_pcg_solve / the multigrid
    cycle; raises off-GPU unless ``interpret``."""
    plan = spmv_plan(n, offsets, interpret=interpret)
    return (
        lambda values: prep_values(plan, values),
        lambda values_t, x: spmv(plan, values_t, x),
    )
