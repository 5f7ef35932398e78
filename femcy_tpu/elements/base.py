"""Element definitions as static data + pure functions.

Design: the reference keeps Gauss tables in Taichi device fields and
duplicates every shape function in "ti scope" and "py scope"
(element_zoo/element_base.py:9-53).  Here an element type is a frozen
dataclass of *static numpy tables* (quadrature, shape values / gradients at
the quadrature points, facet tables, the GP->node extrapolation matrix, and
viz triangulation) plus one pure ``shape_fn`` / ``dshape_fn`` pair that is
only ever evaluated host-side at static natural coordinates.  Device code
never evaluates shape functions: assembly consumes the precomputed
``dshape_at_gp`` tables, so the hot path is pure batched linear algebra.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Callable, Dict, Sequence, Tuple

import numpy as np

# A facet is keyed by the sorted tuple of its local node ids, exactly like the
# reference's facet_natural_coos dicts (e.g. element_linear_triangular.py:35-53).
FacetKey = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class ElementType:
    """One finite-element family (e.g. CPS3, C3D10)."""

    name: str
    #: spatial dimension
    dm: int
    #: nodes per element
    n_nodes: int
    #: (G, dm) natural coordinates of the volume Gauss points
    gauss_points: np.ndarray
    #: (G,) Gauss weights
    gauss_weights: np.ndarray
    #: natural coordinate -> (n_nodes,) shape-function values (numpy, host-side)
    shape_fn: Callable[[np.ndarray], np.ndarray]
    #: natural coordinate -> (n_nodes, dm) d(shape)/d(natural) (numpy, host-side)
    dshape_fn: Callable[[np.ndarray], np.ndarray]
    #: facet -> list of facet-GP natural coordinates
    facet_natural_coos: Dict[FacetKey, Sequence[Sequence[float]]]
    #: facet -> list of facet-GP weights
    facet_point_weights: Dict[FacetKey, Sequence[float]]
    #: facet -> list of outward normals in natural coordinates, one per facet GP
    facet_natural_normals: Dict[FacetKey, Sequence[Sequence[float]]]
    #: Abaqus face number (S1..Sk, 0-based here) -> tuple of facets
    #: (ref: `inp_surface_num`, e.g. element_quadratic_triangular.py:70-72)
    inp_surface_num: Tuple[Tuple[FacetKey, ...], ...]
    #: (n_nodes, G) matrix M with nodal_vals = M @ gp_vals (GP->node patch
    #: extrapolation; ref: per-element `extrapolate` kernels)
    extrapolation_matrix: np.ndarray
    #: local-node triples triangulating each element's surface for viz
    #: (ref: per-element `getMesh`, e.g. element_quadratic_tetrahedral.py:258-274)
    viz_triangles: Tuple[Tuple[int, int, int], ...]
    #: facet -> the two in-plane natural axes of that facet.  When present,
    #: facet areas are integrated per-GP from the face Jacobian tangents
    #: (exact for planar quad faces); when None the reference's constant
    #: corner-triangle measure x weights is used (exact for simplex facets
    #: and for the half-edge 2D facets)
    facet_axes: Dict[FacetKey, Tuple[int, int]] = None

    # ------------------------------------------------------------------ #
    @property
    def n_gp(self) -> int:
        return self.gauss_points.shape[0]

    @property
    def edof(self) -> int:
        """dofs per element."""
        return self.n_nodes * self.dm

    @property
    def n_voigt(self) -> int:
        return 3 if self.dm == 2 else 6

    @property
    def integ_points_each_facet(self) -> int:
        return len(next(iter(self.facet_point_weights.values())))

    @cached_property
    def shape_at_gp(self) -> np.ndarray:
        """(G, n_nodes) shape values at the volume Gauss points."""
        return np.stack([self.shape_fn(gp) for gp in self.gauss_points])

    @cached_property
    def dshape_at_gp(self) -> np.ndarray:
        """(G, n_nodes, dm) shape gradients (natural) at the Gauss points."""
        return np.stack([self.dshape_fn(gp) for gp in self.gauss_points])

    # ------------------------------------------------------------------ #
    def facet_quadrature(
        self, nodes: np.ndarray, facet_local: Sequence[int]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Quadrature data of one boundary facet of one element (host-side).

        Parameters
        ----------
        nodes : (n_nodes, dm) global coordinates of this element's nodes
        facet_local : local node ids of the facet

        Returns
        -------
        normals : (Q, dm) outward unit normals at the facet Gauss points
        area_x_weight : (Q,) facet measure times Gauss weight
        shape_vals : (Q, n_nodes) element shape values at the facet GPs

        Same math as the reference's ``globalNormal`` (n_g = n_nat (dx/dxi)^-1,
        e.g. element_linear_tetrahedral.py:101-134) plus the shape values the
        reference's Neumann host loop evaluates per node
        (stiffnessMtrx.py:369-411), batched over the facet's Gauss points.
        """
        facet = tuple(sorted(int(i) for i in facet_local))
        coos = np.asarray(self.facet_natural_coos[facet], dtype=np.float64)
        weights = np.asarray(self.facet_point_weights[facet], dtype=np.float64)
        nat_normals = np.asarray(self.facet_natural_normals[facet], dtype=np.float64)

        normals = np.zeros((coos.shape[0], self.dm))
        shape_vals = np.zeros((coos.shape[0], self.n_nodes))
        axes = self.facet_axes.get(facet) if self.facet_axes else None
        aw = np.zeros(coos.shape[0])
        measure = None if axes is not None else self._facet_measure(nodes, facet)
        for q in range(coos.shape[0]):
            dsdn = self.dshape_fn(coos[q])
            dxdn = nodes.T @ dsdn
            g = nat_normals[q] @ np.linalg.inv(dxdn)
            normals[q] = g / (np.linalg.norm(g) + 1.0e-30)
            shape_vals[q] = self.shape_fn(coos[q])
            if axes is not None:
                # per-GP area element from the face Jacobian tangents; an
                # axes entry is either two natural-axis indices or a (2, dm)
                # array of natural tangent directions (needed for faces not
                # aligned with a coordinate plane, e.g. the slanted quad
                # face of a wedge)
                ax = np.asarray(axes)
                if ax.ndim == 2:
                    t1, t2 = dxdn @ ax[0], dxdn @ ax[1]
                else:
                    t1, t2 = dxdn[:, axes[0]], dxdn[:, axes[1]]
                aw[q] = np.linalg.norm(np.cross(t1, t2)) * weights[q]
            else:
                aw[q] = measure * weights[q]
        return normals, aw, shape_vals

    def _facet_measure(self, nodes: np.ndarray, facet: FacetKey) -> float:
        """Length (2D) / corner-triangle area (3D) of a facet.

        Matches the reference: 2D uses |x_f0 - x_f1| of the two lowest-indexed
        facet nodes (element_linear_triangular.py:117), 3D uses half the cross
        product of the first three sorted facet nodes
        (element_linear_tetrahedral.py:129-132) -- for quadratic tets that is
        the *corner* triangle of the (curved) face, with the facet weights
        scaled to integrate over the full face.
        """
        if self.dm == 2:
            return float(np.linalg.norm(nodes[facet[0]] - nodes[facet[1]]))
        v = np.cross(
            nodes[facet[1]] - nodes[facet[0]], nodes[facet[2]] - nodes[facet[0]]
        )
        return float(0.5 * np.linalg.norm(v))
