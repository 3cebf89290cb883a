"""Quadrature rules on reference cells.

Gauss-Legendre on the interval, tensor products on quad/hex, and
Duffy-collapsed tensor rules on triangle/tet. Setup-time numpy only.
This replaces the quadrature half of the FFCx/Basix pipeline the reference
leans on (SURVEY.md §2b).
"""

from __future__ import annotations

import numpy as np


def gauss_legendre_01(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def _n_points_1d(degree: int) -> int:
    """Points needed for exactness to polynomial `degree`."""
    return max(1, (degree + 2) // 2)


def cell_quadrature(cell_name: str, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature exact (or near-exact for collapsed simplex rules) to
    polynomial `degree` on the reference cell.

    Returns (points (nq, tdim), weights (nq,)).
    """
    n = _n_points_1d(degree)
    x, w = gauss_legendre_01(n)

    if cell_name == "interval":
        return x.reshape(-1, 1), w

    if cell_name == "quad":
        X, Y = np.meshgrid(x, x, indexing="ij")
        W = np.outer(w, w)
        return np.stack([X.ravel(), Y.ravel()], axis=1), W.ravel()

    if cell_name == "hex":
        X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
        W = np.einsum("i,j,k->ijk", w, w, w)
        return np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1), W.ravel()

    if cell_name == "triangle":
        # Duffy transform of the unit square: (u, v) -> (u, v*(1-u)),
        # |J| = 1-u. Use one extra 1D point to absorb the Jacobian factor.
        xu, wu = gauss_legendre_01(n + 1)
        xv, wv = gauss_legendre_01(n + 1)
        U, V = np.meshgrid(xu, xv, indexing="ij")
        W = np.outer(wu, wv) * (1.0 - U)
        P = np.stack([U.ravel(), (V * (1.0 - U)).ravel()], axis=1)
        return P, W.ravel()

    if cell_name == "tet":
        # Double Duffy: (u,v,w) -> (u, v(1-u), w(1-u)(1-v... )) via the
        # standard collapse x=u, y=v(1-u), z=w(1-u-v(1-u)).
        m = n + 1
        xu, wu = gauss_legendre_01(m)
        U, V, Wc = np.meshgrid(xu, xu, xu, indexing="ij")
        X = U
        Y = V * (1.0 - U)
        Z = Wc * (1.0 - U - Y)
        jac = (1.0 - U) * (1.0 - U - Y)
        W = np.einsum("i,j,k->ijk", wu, wu, wu) * jac
        P = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
        return P, W.ravel()

    raise ValueError(f"unknown cell {cell_name!r}")


def facet_quadrature(cell_name: str, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature on the reference *facet* cell of `cell_name`.

    For interval cells facets are points: returns a single point of weight 1
    (a 0-d facet integral is a point evaluation, as in the reference's 1D
    `ds` boundary terms, ThermoViscoProblem.py:302-304).
    """
    if cell_name == "interval":
        return np.zeros((1, 0)), np.array([1.0])
    if cell_name in ("triangle", "quad"):
        p, w = cell_quadrature("interval", degree)
        return p, w
    if cell_name == "tet":
        return cell_quadrature("triangle", degree)
    if cell_name == "hex":
        return cell_quadrature("quad", degree)
    raise ValueError(f"unknown cell {cell_name!r}")
