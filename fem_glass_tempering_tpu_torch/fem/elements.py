"""Lagrange finite elements (CG/DG, arbitrary modest degree) with tabulation.

Replacement for Basix element tabulation (SURVEY.md §2b): basis
values and gradients at arbitrary reference points, computed at setup time
in numpy via a monomial Vandermonde solve, then copied onto the device
as constant tables for the operators.

CG and DG share the same local basis; they differ only in the dofmap
(continuity), handled by FunctionSpace. Interpolation points are the nodal
lattice points, matching the Lagrange dual basis — the analog of
`element.interpolation_points()` used throughout the reference
(ViscoelasticModel.py:107 et passim).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from fem_glass_tempering_tpu_torch.fem.reference_elements import ReferenceCell, get_cell


def _monomial_exponents(cell: ReferenceCell, degree: int) -> np.ndarray:
    """Exponent multi-indices of the polynomial space: total degree <= p on
    simplices, per-axis degree <= p on tensor cells. Shape (nloc, tdim)."""
    rng = range(degree + 1)
    d = cell.tdim
    if d == 1:
        exps = [(i,) for i in rng]
    elif d == 2:
        exps = [(i, j) for j in rng for i in rng]
    else:
        exps = [(i, j, k) for k in rng for j in rng for i in rng]
    if cell.simplex:
        exps = [e for e in exps if sum(e) <= degree]
    return np.array(exps, dtype=np.int64)


def _lattice_points(cell: ReferenceCell, degree: int) -> np.ndarray:
    """Equispaced nodal lattice on the reference cell, shape (nloc, tdim).

    Ordering: vertices first (in reference-vertex order) so that degree-1
    dofs coincide with cell vertices, then the remaining lattice points in
    lexicographic order. Cross-cell identification of shared CG dofs is done
    geometrically by FunctionSpace, so no edge/face orientation bookkeeping
    is needed here.
    """
    p = degree
    d = cell.tdim
    ticks = np.arange(p + 1) / p if p > 0 else np.array([0.0])
    if d == 1:
        pts = np.array([(t,) for t in ticks])
    elif d == 2:
        pts = np.array([(a, b) for b in ticks for a in ticks])
    else:
        pts = np.array([(a, b, c) for c in ticks for b in ticks for a in ticks])
    if cell.simplex:
        keep = pts.sum(axis=1) <= 1.0 + 1e-12
        pts = pts[keep]
    # vertices first
    verts = cell.vertices
    order = []
    used = np.zeros(len(pts), dtype=bool)
    for v in verts:
        idx = int(np.argmin(np.linalg.norm(pts - v, axis=1)))
        order.append(idx)
        used[idx] = True
    order += [i for i in range(len(pts)) if not used[i]]
    return pts[np.array(order)]


def _eval_monomials(points: np.ndarray, exps: np.ndarray) -> np.ndarray:
    """(npts, nmono) monomial values."""
    # points: (npts, d); exps: (nmono, d)
    return np.prod(points[:, None, :] ** exps[None, :, :], axis=2)


def _eval_monomial_grads(points: np.ndarray, exps: np.ndarray) -> np.ndarray:
    """(npts, nmono, d) monomial gradients."""
    npts, d = points.shape
    nm = len(exps)
    out = np.zeros((npts, nm, d))
    for ax in range(d):
        e = exps.copy()
        coef = e[:, ax].astype(np.float64)
        e[:, ax] = np.maximum(e[:, ax] - 1, 0)
        out[:, :, ax] = coef[None, :] * np.prod(
            points[:, None, :] ** e[None, :, :], axis=2
        )
    return out


@dataclass(frozen=True)
class LagrangeElement:
    """Scalar Lagrange element on a reference cell.

    Vector/tensor-valued spaces are built as blocked copies of this scalar
    element by FunctionSpace (value_shape), mirroring the reference's
    VectorElement/TensorElement/blocked `element` usage
    (ThermoViscoProblem.py:77-101).
    """

    cell: ReferenceCell
    degree: int
    nodes: np.ndarray        # (nloc, tdim) nodal/interpolation points
    _coeff: np.ndarray       # (nmono, nloc) basis coefficients in monomials
    _exps: np.ndarray        # (nmono, tdim)

    @property
    def nloc(self) -> int:
        return self.nodes.shape[0]

    def tabulate(self, points: np.ndarray) -> np.ndarray:
        """Basis values at `points`: shape (npts, nloc)."""
        return _eval_monomials(np.atleast_2d(points), self._exps) @ self._coeff

    def tabulate_grad(self, points: np.ndarray) -> np.ndarray:
        """Reference-coordinate basis gradients: shape (npts, nloc, tdim)."""
        g = _eval_monomial_grads(np.atleast_2d(points), self._exps)
        return np.einsum("pmd,ml->pld", g, self._coeff)

    def interpolation_points(self) -> np.ndarray:
        """Nodal points, the Lagrange dual evaluation points."""
        return self.nodes


@lru_cache(maxsize=None)
def lagrange_element(cell_name: str, degree: int) -> LagrangeElement:
    cell = get_cell(cell_name)
    nodes = _lattice_points(cell, degree)
    exps = _monomial_exponents(cell, degree)
    if len(exps) != len(nodes):
        raise AssertionError(
            f"dof/monomial mismatch on {cell_name} degree {degree}: "
            f"{len(nodes)} nodes vs {len(exps)} monomials"
        )
    V = _eval_monomials(nodes, exps)
    coeff = np.linalg.solve(V, np.eye(len(nodes)))
    # coeff[m, l]: coefficient of monomial m in basis function l — we solved
    # V @ C = I with V[p, m] = mono_m(node_p), so C maps monomial values to
    # basis values: phi_l(x) = sum_m mono_m(x) * C[m, l].
    return LagrangeElement(cell=cell, degree=degree, nodes=nodes, _coeff=coeff, _exps=exps)


# geometry (P1/Q1) element of a cell — used for coordinate maps
@lru_cache(maxsize=None)
def geometry_element(cell_name: str) -> LagrangeElement:
    return lagrange_element(cell_name, 1)
