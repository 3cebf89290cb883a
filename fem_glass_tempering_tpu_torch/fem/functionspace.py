"""Function spaces: dofmaps, interpolation ownership, boundary dofs.

Replacement for dolfinx FunctionSpace/dofmap construction
(SURVEY.md §2b). A space is a scalar Lagrange element + an int32 dofmap
(n_cells, nloc); vector/tensor fields are *blocked*: the dof array has shape
(n_scalar_dofs, *value_shape) and every component shares the scalar dofmap,
mirroring the reference's VectorElement/TensorElement/blocked spaces
(ThermoViscoProblem.py:77-101).

CG continuity is established geometrically: lattice points of all cells are
quantized and deduplicated, which sidesteps edge/face orientation bookkeeping
for any degree. DG spaces get cell-contiguous dofs (no sharing).

Interpolation ownership: for every scalar dof we precompute a unique
(owner_cell, owner_local_point). Cross-space interpolation then becomes a
pure gather + batched matmul with NO scatter conflicts — for CG targets fed
by discontinuous expressions this reproduces the reference's last-cell-wins
overwrite semantics deterministically (dolfinx Function.interpolate writes
per-cell sequentially; we pick the highest-index incident cell).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from fem_glass_tempering_tpu_torch.fem.elements import LagrangeElement, lagrange_element, geometry_element
from fem_glass_tempering_tpu_torch.fem.mesh import Mesh


@dataclass
class FunctionSpace:
    mesh: Mesh
    family: str                   # 'CG' | 'DG'
    degree: int
    value_shape: tuple = ()
    # built in __post_init__
    element: LagrangeElement = field(init=False)
    dofmap: np.ndarray = field(init=False)        # (n_cells, nloc) int32
    n_scalar_dofs: int = field(init=False)
    dof_coords: np.ndarray = field(init=False)    # (n_scalar_dofs, gdim)
    owner_cell: np.ndarray = field(init=False)    # (n_scalar_dofs,) int32
    owner_lpoint: np.ndarray = field(init=False)  # (n_scalar_dofs,) int32

    def __post_init__(self):
        if self.family not in ("CG", "DG"):
            raise ValueError("Only CG and DG elements are supported")
        self.element = lagrange_element(self.mesh.cell_type, self.degree)
        self._build_dofmap()
        self._build_ownership()

    # ------------------------------------------------------------------
    @property
    def nloc(self) -> int:
        return self.element.nloc

    @property
    def value_size(self) -> int:
        return int(np.prod(self.value_shape)) if self.value_shape else 1

    @property
    def n_dofs(self) -> int:
        """Total dofs including value components."""
        return self.n_scalar_dofs * self.value_size

    def zeros(self, dtype=np.float64) -> np.ndarray:
        return np.zeros((self.n_scalar_dofs,) + tuple(self.value_shape), dtype=dtype)

    def full(self, value: float, dtype=np.float64) -> np.ndarray:
        return np.full((self.n_scalar_dofs,) + tuple(self.value_shape), value, dtype=dtype)

    # ------------------------------------------------------------------
    def _lattice_phys_coords(self) -> np.ndarray:
        """(n_cells, nloc, gdim) physical coordinates of all lattice points."""
        geom = geometry_element(self.mesh.cell_type)
        phi = geom.tabulate(self.element.nodes)          # (nloc, nverts)
        xc = self.mesh.cell_vertex_coords()              # (n_cells, nverts, gdim)
        return np.einsum("lv,cvg->clg", phi, xc)

    def _build_dofmap(self) -> None:
        mesh = self.mesh
        nloc = self.element.nloc
        if self.family == "DG":
            self.dofmap = np.arange(
                mesh.n_cells * nloc, dtype=np.int32
            ).reshape(mesh.n_cells, nloc)
            self.n_scalar_dofs = mesh.n_cells * nloc
            self.dof_coords = self._lattice_phys_coords().reshape(-1, mesh.gdim)
            return
        if self.degree == 1:
            # vertex dofs: reuse exact mesh connectivity
            self.dofmap = mesh.cells.astype(np.int32)
            self.n_scalar_dofs = mesh.n_nodes
            self.dof_coords = mesh.nodes.copy()
            return
        # geometric dedup for higher degree
        X = self._lattice_phys_coords().reshape(-1, mesh.gdim)
        bbox = X.max(axis=0) - X.min(axis=0)
        tol = 1e-8 * max(float(np.max(bbox)), 1.0)
        keys = np.round(X / tol).astype(np.int64)
        _, first_idx, inverse = np.unique(
            keys, axis=0, return_index=True, return_inverse=True
        )
        self.dofmap = inverse.astype(np.int32).reshape(mesh.n_cells, nloc)
        self.n_scalar_dofs = int(inverse.max()) + 1
        self.dof_coords = X[first_idx]

    def _build_ownership(self) -> None:
        """owner (cell, local point) per scalar dof; highest cell index wins,
        matching sequential per-cell interpolation overwrite order."""
        n_cells, nloc = self.dofmap.shape
        owner_cell = np.zeros(self.n_scalar_dofs, dtype=np.int32)
        owner_lp = np.zeros(self.n_scalar_dofs, dtype=np.int32)
        # iterate ascending so the last write is the highest cell index
        cell_ids = np.repeat(np.arange(n_cells, dtype=np.int32), nloc)
        lp_ids = np.tile(np.arange(nloc, dtype=np.int32), n_cells)
        flat = self.dofmap.ravel()
        owner_cell[flat] = cell_ids
        owner_lp[flat] = lp_ids
        self.owner_cell = owner_cell
        self.owner_lpoint = owner_lp

    # ------------------------------------------------------------------
    def facet_lattice_points(self) -> list[np.ndarray]:
        """For each local facet: indices of local lattice points lying on it
        (reference-coordinate plane test; valid by convexity)."""
        rc = self.mesh.ref_cell
        pts = self.element.nodes
        out = []
        for lf in range(rc.n_facets):
            fv = rc.facet_vertex_coords(lf)
            if rc.tdim == 1:
                on = np.abs(pts[:, 0] - fv[0, 0]) < 1e-12
            else:
                v0 = fv[0]
                A = (fv[1:] - v0).T  # (tdim, nfv-1)
                # normal(s): null space of A^T
                _, _, vt = np.linalg.svd(A.T, full_matrices=True)
                # a facet spans tdim-1 directions; remaining rows of vt are normals
                normals = vt[rc.tdim - 1:]
                d = (pts - v0) @ normals.T
                on = np.all(np.abs(d) < 1e-12, axis=1)
            out.append(np.nonzero(on)[0].astype(np.int32))
        return out

    def boundary_scalar_dofs(self, marker=None,
                             facet_mask=None) -> np.ndarray:
        """Scalar dofs lying on the mesh boundary; optional coordinate marker
        predicate marker(x: (n, gdim)) -> bool mask, and/or a bool
        `facet_mask` over the boundary-facet enumeration (e.g. from
        Mesh.boundary_facets_with_tag — the dolfinx
        locate_dofs_topological-by-meshtag pattern). This is the working
        replacement for the reference's broken Dirichlet path
        (ThermoViscoProblem.py:236-243, SURVEY.md §Quirks 3)."""
        facet_pts = self.facet_lattice_points()
        dofs = set()
        for k, (c, lf) in enumerate(zip(self.mesh.boundary_cell,
                                        self.mesh.boundary_local_facet)):
            if facet_mask is not None and not facet_mask[k]:
                continue
            for lp in facet_pts[lf]:
                dofs.add(int(self.dofmap[c, lp]))
        dofs = np.array(sorted(dofs), dtype=np.int32)
        if marker is not None:
            mask = marker(self.dof_coords[dofs])
            dofs = dofs[np.asarray(mask, dtype=bool)]
        return dofs
