"""Mixed B31-beam + continuum models: frame-stiffened solids.

The reference cannot express these at all -- it parses B31 then crashes
(/root/reference/reader/inp_info.py:98-100, 118-123) and allows one element
type per model (:125-128).  femcy_tpu's beam.py solves pure B31 lattices and
multiblock.py mixes continuum types; this module closes the last structural
silo: a SINGLE equation system over 6-dof nodes carrying BOTH beam blocks
(all six dofs) and continuum blocks (the three translations), so a
frame-stiffened plate/solid is one model.

Design (one jitted assembly program):

* global layout: 6 dofs per node.  Continuum element dofs map to
  ``node*6 + {0,1,2}``, beam dofs to ``node*6 + {0..5}``; the shared ELL
  pattern is the union of both graphs plus the full diagonal;
* rotation dofs of nodes touched by no beam element are automatically
  constrained (they carry no stiffness -- the standard mixed-dimension
  treatment), reported as ``n_auto_fixed``;
* assembly: the continuum blocks' batched ``BᵀCB`` einsum and the beams'
  batched local-stiffness + frame congruence (beam.py) scatter into one
  values array by precomputed slot targets -- no atomics, no search
  (same design as multiblock.py);
* solve: host direct below the dof crossover, ELL Jacobi-PCG above --
  identical machinery to the continuum paths;
* recovery: per-block continuum stress (translations only) and beam
  end forces in the local frame (beam.py's recovery math).

Linear statics (like beam.py): the beam element is the exact-static
Timoshenko stiffness, which has no updated-Lagrangian form here.  Loads are
``*Cload`` concentrated forces/moments and ``*Dsload`` tractions on
continuum faces.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from femcy_tpu import assembly, bc as bc_mod
from femcy_tpu.beam import (
    BeamSection,
    _element_frames,
    _local_stiffness,
    _read_beam_boundary,
    _read_beam_section,
    _read_cloads,
)
from femcy_tpu.config import SolverConfig
from femcy_tpu.mesh import FEMesh
from femcy_tpu.multiblock import ElementBlock
from femcy_tpu.solvers.cg import pcg_solve
from femcy_tpu.topology import ELLPattern, colidx_valid_mask

logger = logging.getLogger("femcy_tpu")


@dataclasses.dataclass
class BeamBlock:
    """One group of B31 elements sharing a section and a material."""

    elements: np.ndarray  # (E, 2) int32, 0-based into the shared nodes
    section: BeamSection
    E: float
    nu: float
    name: str = ""


@dataclasses.dataclass
class MixedModel:
    """A parsed mixed beam+solid ``.inp``."""

    nodes: np.ndarray
    solid_blocks: List[ElementBlock]
    beam_blocks: List[BeamBlock]
    #: (node, dof 0..5, value)
    dirichlet: List[Tuple[int, int, float]]
    #: (node, dof 0..5, value)
    cloads: List[Tuple[int, int, float]]
    neumann_bcs: list


def _union_pattern_6dof(
    n_nodes: int,
    solid_blocks: List[ElementBlock],
    beam_blocks: List[BeamBlock],
) -> Tuple[ELLPattern, List[np.ndarray], List[np.ndarray]]:
    """Shared ELL pattern over the 6-dof/node layout.

    Same construction as multiblock.build_union_pattern with two twists:
    per-block dof maps use the 6 stride (translations only for continuum),
    and the FULL diagonal is appended so rotation dofs carried by no beam
    still own a slot (they become unit rows under the auto-fix mask).
    """
    n_dof = 6 * n_nodes
    keys_per_block = []
    dofs_per_block = []
    for blk in solid_blocks:
        elements = blk.elements.astype(np.int64)
        edof = elements.shape[1] * 3
        element_dofs = (
            elements[:, :, None] * 6 + np.arange(3)
        ).reshape(elements.shape[0], edof)
        dofs_per_block.append(element_dofs)
    for bb in beam_blocks:
        elements = bb.elements.astype(np.int64)
        element_dofs = (
            elements[:, :, None] * 6 + np.arange(6)
        ).reshape(elements.shape[0], 12)
        dofs_per_block.append(element_dofs)
    for element_dofs in dofs_per_block:
        edof = element_dofs.shape[1]
        rows = np.broadcast_to(
            element_dofs[:, :, None], (*element_dofs.shape, edof)
        )
        cols = np.broadcast_to(
            element_dofs[:, None, :], (*element_dofs.shape, edof)
        )
        keys_per_block.append((rows * np.int64(n_dof) + cols).reshape(-1))
    diag_keys_all = (
        np.arange(n_dof, dtype=np.int64) * n_dof
        + np.arange(n_dof, dtype=np.int64)
    )
    keys = np.concatenate(keys_per_block + [diag_keys_all])
    uniq, inv = np.unique(keys, return_inverse=True)
    row_of = (uniq // n_dof).astype(np.int64)
    col_of = (uniq % n_dof).astype(np.int64)

    row_counts = np.bincount(row_of, minlength=n_dof)
    width = int(row_counts.max())
    row_start = np.zeros(n_dof + 1, dtype=np.int64)
    np.cumsum(row_counts, out=row_start[1:])
    pos_in_row = np.arange(uniq.shape[0], dtype=np.int64) - row_start[row_of]

    colidx = np.zeros((n_dof, width), dtype=np.int32)
    colidx[row_of, pos_in_row] = col_of
    slot_of_uniq = row_of * width + pos_in_row
    diag_slot = slot_of_uniq[np.searchsorted(uniq, diag_keys_all)].astype(
        np.int64
    )

    targets_all = slot_of_uniq[inv]
    scatter_targets = []
    start = 0
    for k in keys_per_block:
        scatter_targets.append(
            targets_all[start : start + k.shape[0]].astype(np.int64)
        )
        start += k.shape[0]
    force_targets = [d.reshape(-1).astype(np.int32) for d in dofs_per_block]

    pattern = ELLPattern(
        n_dof=n_dof,
        width=width,
        colidx=colidx,
        row_counts=row_counts.astype(np.int32),
        valid=colidx_valid_mask(colidx, row_counts),
        diag_slot=diag_slot,
        scatter_targets=targets_all.astype(np.int64),
        force_targets=np.concatenate(force_targets),
        element_dofs=dofs_per_block[0].astype(np.int32),
        csr_indptr=row_start,
        csr_indices=col_of.astype(np.int32),
        csr_slots=slot_of_uniq,
    )
    return pattern, scatter_targets, force_targets


@dataclasses.dataclass
class MixedResult:
    u: np.ndarray  # (N, 6)
    #: per solid block: (E, G, 3, 3) Cauchy stress and (E, G) Mises
    solid_stress: List[np.ndarray]
    solid_mises: List[np.ndarray]
    #: per beam block: (E, 12) local end forces (beam.py convention)
    beam_end_forces: List[np.ndarray]
    n_auto_fixed: int
    cg_iters: int  # 0 on the direct path


class MixedSystem:
    """Assemble and solve one frame-stiffened solid (linear statics)."""

    def __init__(
        self,
        nodes: np.ndarray,
        solid_blocks: List[ElementBlock],
        beam_blocks: List[BeamBlock],
        config: SolverConfig = SolverConfig(),
    ):
        if not beam_blocks and not solid_blocks:
            raise ValueError("need at least one block")
        self.nodes = np.asarray(nodes, dtype=np.float64)
        if self.nodes.shape[1] != 3:
            raise ValueError("mixed beam+solid models are 3-D")
        for blk in solid_blocks:
            if blk.element.dm != 3:
                raise ValueError(
                    f"block {blk.name!r}: mixed models need 3-D continuum "
                    f"elements, got dm={blk.element.dm}"
                )
        self.solid_blocks = solid_blocks
        self.beam_blocks = beam_blocks
        self.config = config
        self.n_nodes = self.nodes.shape[0]
        self.n_dof = 6 * self.n_nodes
        self.pattern, self._targets, self._force_targets = (
            _union_pattern_6dof(self.n_nodes, solid_blocks, beam_blocks)
        )
        # rotation dofs with no beam attached carry zero stiffness:
        # auto-constrain them (their ELL rows are the appended diagonal)
        has_rot = np.zeros(self.n_nodes, dtype=bool)
        for bb in beam_blocks:
            has_rot[np.unique(bb.elements)] = True
        auto = np.zeros(self.n_dof, dtype=bool)
        for c in (3, 4, 5):
            auto[np.nonzero(~has_rot)[0] * 6 + c] = True
        self.auto_fixed = auto
        # beam frames (host f64 geometry, once)
        self._beam_geo = [
            _element_frames(self.nodes, bb.elements, bb.section.n1)
            for bb in beam_blocks
        ]
        self._jit_assemble = jax.jit(self._assemble_impl)

    # ------------------------------------------------------------------ #
    def _assemble_impl(self, coords):
        """One program: every block's stiffness into the shared ELL values."""
        flat = jnp.zeros(self.n_dof * self.pattern.width, dtype=coords.dtype)
        ti = 0
        for blk in self.solid_blocks:
            dsdx, vol = assembly.gradients_and_volume(
                coords,
                jnp.asarray(blk.elements),
                jnp.asarray(blk.element.dshape_at_gp),
                jnp.asarray(blk.element.gauss_weights),
            )
            Ke = assembly.element_stiffness(
                dsdx, vol, jnp.asarray(blk.material.C)
            )
            flat = flat.at[jnp.asarray(self._targets[ti])].add(
                Ke.reshape(-1)
            )
            ti += 1
        for bb, (L_np, R_np) in zip(self.beam_blocks, self._beam_geo):
            G = bb.E / (2.0 * (1.0 + bb.nu))
            L = jnp.asarray(L_np, coords.dtype)
            R = jnp.asarray(R_np, coords.dtype)
            k_loc = _local_stiffness(L, bb.E, G, bb.section)
            Z = jnp.zeros_like(R)
            T = jnp.block([[R, Z, Z, Z], [Z, R, Z, Z],
                           [Z, Z, R, Z], [Z, Z, Z, R]])
            k_glob = jnp.einsum("eji,ejk,ekl->eil", T, k_loc, T)
            flat = flat.at[jnp.asarray(self._targets[ti])].add(
                k_glob.reshape(-1)
            )
            ti += 1
        return flat.reshape(self.n_dof, self.pattern.width)

    # ------------------------------------------------------------------ #
    def solve(self, model: MixedModel) -> MixedResult:
        cfg = self.config
        fixed = self.auto_fixed.copy()
        sval = np.zeros(self.n_dof)
        for (nid, dof, val) in model.dirichlet:
            fixed[nid * 6 + dof] = True
            sval[nid * 6 + dof] = val
        rhs = np.zeros(self.n_dof)
        for (nid, dof, val) in model.cloads:
            rhs[nid * 6 + dof] += val
        if model.neumann_bcs:
            # traction patterns on the continuum skin: evaluate on a 3-dof
            # FEMesh of the (single) solid block, then restride to 6
            if len(self.solid_blocks) != 1:
                raise NotImplementedError(
                    "*Dsload on mixed models supports one solid block"
                )
            blk = self.solid_blocks[0]
            m3 = FEMesh(self.nodes, blk.elements, blk.element)
            patterns, tractions = bc_mod.build_neumann_patterns(
                m3, model.neumann_bcs
            )
            if patterns.shape[0]:
                p3 = tractions @ patterns  # (3N,)
                p3 = p3.reshape(-1, 3)
                r6 = rhs.reshape(-1, 6)
                r6[:, :3] += p3
                rhs = r6.reshape(-1)

        values = self._jit_assemble(jnp.asarray(self.nodes))
        values_bc, b = bc_mod.apply_dirichlet_linear(
            values,
            jnp.asarray(self.pattern.colidx),
            jnp.asarray(self.pattern.diag_slot),
            jnp.asarray(rhs),
            jnp.asarray(fixed),
            jnp.asarray(sval),
        )
        cg_iters = 0
        use_direct = cfg.linear_solver == "direct" or (
            cfg.linear_solver == "auto"
            and self.n_dof < cfg.direct_solve_max_dof
        )
        if use_direct:
            import scipy.sparse.linalg as spla

            A = self.pattern.to_scipy(np.asarray(values_bc, np.float64))
            u = spla.spsolve(A.tocsc(), np.asarray(b, np.float64))
        else:
            x, iters, rmax = jax.jit(
                lambda v, bb: pcg_solve(
                    v,
                    jnp.asarray(self.pattern.colidx),
                    jnp.asarray(self.pattern.diag_slot),
                    bb,
                    eps=cfg.cg_eps,
                    max_iters=cfg.cg_max_iters,
                )
            )(values_bc, b)
            u = np.asarray(x)
            cg_iters = int(iters)
        u6 = u.reshape(self.n_nodes, 6)

        # --- recovery ----------------------------------------------------
        from femcy_tpu.system import mises_stress

        solid_stress, solid_mises = [], []
        ut = jnp.asarray(u6[:, :3].reshape(-1))
        for blk in self.solid_blocks:
            m3 = FEMesh(self.nodes, blk.elements, blk.element)
            dsdX0, _ = assembly.gradients_and_volume(
                jnp.asarray(self.nodes),
                jnp.asarray(blk.elements),
                jnp.asarray(blk.element.dshape_at_gp),
                jnp.asarray(blk.element.gauss_weights),
            )
            F = assembly.deformation_gradient(
                ut, jnp.asarray(blk.elements), dsdX0
            )
            stress = assembly.gp_stress(F, blk.material, large=False)
            solid_stress.append(np.asarray(stress))
            solid_mises.append(np.asarray(mises_stress(stress, blk.material)))
        beam_forces = []
        for bb, (L_np, R_np) in zip(self.beam_blocks, self._beam_geo):
            G = bb.E / (2.0 * (1.0 + bb.nu))
            L = jnp.asarray(L_np)
            R = jnp.asarray(R_np)
            k_loc = _local_stiffness(L, bb.E, G, bb.section)
            Z = jnp.zeros_like(R)
            T = jnp.block([[R, Z, Z, Z], [Z, R, Z, Z],
                           [Z, Z, R, Z], [Z, Z, Z, R]])
            ue = jnp.asarray(
                u6[bb.elements].reshape(bb.elements.shape[0], 12)
            )
            f_loc = jnp.einsum(
                "eij,ejk,ek->ei", k_loc, T, ue
            )
            beam_forces.append(np.asarray(f_loc))
        return MixedResult(
            u=u6,
            solid_stress=solid_stress,
            solid_mises=solid_mises,
            beam_end_forces=beam_forces,
            n_auto_fixed=int(self.auto_fixed.sum()),
            cg_iters=cg_iters,
        )


# --------------------------------------------------------------------------- #
# .inp front end
# --------------------------------------------------------------------------- #


def read_mixed_inp(file_name: str) -> MixedModel:
    """Parse a mixed beam+solid ``.inp``: the multi-block schema
    (io.inp.read_inp_multi) for nodes/blocks/materials/*Dsload, plus the
    beam-grade ``*Boundary`` (full dof ranges, named types), ``*Cload`` and
    ``*Beam Section`` blocks (beam.py's readers)."""
    from femcy_tpu.elements import get_element
    from femcy_tpu.io.inp import (
        _read_nodes,
        _sequence_nodes,
        _read_sets,
        read_inp_multi,
    )
    from femcy_tpu.materials import material_from_inp

    model = read_inp_multi(file_name)
    with open(file_name, "r") as fh:
        lines = fh.read().splitlines()
    nodes_dict = _read_nodes(lines)
    _, key2id = _sequence_nodes(nodes_dict)
    node_sets, _ = _read_sets(lines, key2id, require_instance=False)

    solid_blocks: List[ElementBlock] = []
    beam_blocks: List[BeamBlock] = []
    for bi, (etype, elset, elements) in enumerate(model.element_blocks):
        if etype.upper() == "B31":
            section = _read_beam_section(lines)
            mtype, params = model.material_of_block(bi)
            if not mtype.lower().startswith("elastic"):
                raise ValueError("B31 blocks need *Elastic materials")
            beam_blocks.append(
                BeamBlock(
                    elements=elements, section=section,
                    E=params[0], nu=params[1], name=elset,
                )
            )
        else:
            mtype, params = model.material_of_block(bi)
            solid_blocks.append(
                ElementBlock(
                    elements=elements,
                    element=get_element(etype),
                    material=material_from_inp(mtype, params, etype),
                    name=elset,
                )
            )
    dirichlet = _read_beam_boundary(lines, node_sets, key2id)
    cloads = _read_cloads(lines, node_sets, key2id)
    return MixedModel(
        nodes=model.nodes,
        solid_blocks=solid_blocks,
        beam_blocks=beam_blocks,
        dirichlet=dirichlet,
        cloads=cloads,
        neumann_bcs=model.neumann_bcs,
    )


def solve_mixed(
    model: MixedModel, config: SolverConfig = SolverConfig()
) -> MixedResult:
    """One-call front end: MixedModel -> MixedResult."""
    system = MixedSystem(
        model.nodes, model.solid_blocks, model.beam_blocks, config
    )
    return system.solve(model)
