"""Smoothed-aggregation AMG preconditioner for unstructured meshes.

Counterpart of fem_glass_tempering_tpu/solver/amg.py, the mesh-agnostic
stand-in for PETSc GAMG (the reference's PC, ThermoViscoProblem.py:344)
where geometric multigrid (solver/multigrid.py) cannot apply. The classic
smoothed-aggregation hierarchy is built ONCE at setup, host-side with scipy:

  1. strength graph  S_ij = |a_ij| > theta sqrt(a_ii a_jj),
  2. greedy aggregation (root + unclaimed neighbors, then attach leftovers),
  3. tentative piecewise-constant prolongator P0, smoothed
     P = (I - omega D^{-1} A) P0 with omega = 4/(3 rho(D^{-1}A)),
  4. Galerkin coarse operator A_c = P^T A P, recurse.

The runtime apply is a standard V-cycle in torch: Chebyshev smoothing with
each level's frozen diagonal, ELL matvecs, and ELL-stored transfer
operators. The hierarchy is frozen at the initial linearization (T_0, dt):
the Jacobian's only T-dependence is the small boundary radiation block,
and a frozen SPD preconditioner stays valid for CG.

The setup is the JAX package's, statement for statement, so the aggregates
and with them the iteration counts are identical; only the CSR -> ELL
conversion is vectorised.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def _csr_to_ell(A: sp.csr_matrix):
    n = A.shape[0]
    counts = np.diff(A.indptr)
    K = max(int(counts.max()), 1)
    cols = np.zeros((n, K), dtype=np.int32)
    vals = np.zeros((n, K))
    rows = np.repeat(np.arange(n), counts)
    slot = np.arange(len(A.indices)) - np.repeat(A.indptr[:-1], counts)
    cols[rows, slot] = A.indices
    vals[rows, slot] = A.data
    return cols, vals


def _aggregate(A: sp.csr_matrix, theta: float = 0.08) -> np.ndarray:
    """Greedy strength-based aggregation: returns agg id per node. A
    sequential pass in node order (the order decides the aggregates)."""
    n = A.shape[0]
    d = np.sqrt(np.abs(A.diagonal()))
    S = A.tocoo()
    strong = (np.abs(S.data) > theta * d[S.row] * d[S.col]) & (S.row != S.col)
    G = sp.csr_matrix((np.ones(strong.sum()),
                       (S.row[strong], S.col[strong])), shape=(n, n))
    agg = np.full(n, -1, dtype=np.int64)
    next_id = 0
    # pass 1: roots whose strong neighborhood is fully unclaimed
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = G.indices[G.indptr[i]:G.indptr[i + 1]]
        if np.all(agg[nbrs] < 0):
            agg[i] = next_id
            agg[nbrs] = next_id
            next_id += 1
    # pass 2: attach leftovers to a neighboring aggregate (or own)
    for i in range(n):
        if agg[i] >= 0:
            continue
        nbrs = G.indices[G.indptr[i]:G.indptr[i + 1]]
        claimed = nbrs[agg[nbrs] >= 0]
        if len(claimed):
            agg[i] = agg[claimed[0]]
        else:
            agg[i] = next_id
            next_id += 1
    return agg


class SmoothedAggregationMG:
    """V-cycle preconditioner from a frozen assembled Jacobian.

    Parameters: `ell` is an ops.spmv.EllMatrix for the heat operator;
    the hierarchy is built from its values at (T_freeze, dt). Each level
    and transfer keeps its int32 column array (`np_cols`, `np_Pc`) beside
    the device tensors."""

    def __init__(self, ell, T_freeze, dt, *, theta: float = 0.08,
                 nu: int = 2, max_levels: int = 10, coarse_n: int = 200,
                 coarse_iters: int = 30, dtype=torch.float64):
        self.nu = nu
        self.coarse_iters = coarse_iters
        self.dtype = dtype
        dev = ell.cols.device
        T_freeze = torch.as_tensor(T_freeze, dtype=dtype, device=dev)
        vals = ell.values_at(T_freeze, dt).detach().cpu().numpy().astype(
            np.float64)
        cols = ell.np_cols
        n = vals.shape[0]
        rows = np.repeat(np.arange(n), vals.shape[1])
        A = sp.csr_matrix((vals.reshape(-1),
                           (rows, cols.reshape(-1))), shape=(n, n))
        A.sum_duplicates()

        f = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        i64 = lambda a: torch.as_tensor(a.astype(np.int64), device=dev)
        self.levels = []       # dicts: cols, vals, diag, rho (+ numpy)
        self.transfers = []    # dicts: P (ell), R = P^T (ell) per level
        lvl_A = A
        for _ in range(max_levels):
            diag = lvl_A.diagonal()
            rho = self._rho(lvl_A, diag)
            c, v = _csr_to_ell(lvl_A.tocsr())
            self.levels.append({
                "cols": i64(c), "vals": f(v), "diag": f(diag),
                "rho": float(rho), "np_cols": c,
            })
            if lvl_A.shape[0] <= coarse_n:
                break
            agg = _aggregate(lvl_A.tocsr(), theta)
            n_agg = int(agg.max()) + 1
            if n_agg >= lvl_A.shape[0]:      # aggregation stalled
                break
            P0 = sp.csr_matrix((np.ones(lvl_A.shape[0]),
                                (np.arange(lvl_A.shape[0]), agg)),
                               shape=(lvl_A.shape[0], n_agg))
            omega = 4.0 / (3.0 * rho)
            Dinv = sp.diags(1.0 / diag)
            P = (P0 - omega * (Dinv @ (lvl_A @ P0))).tocsr()
            pc, pv = _csr_to_ell(P)
            rc, rv = _csr_to_ell(P.T.tocsr())
            self.transfers.append({
                "Pc": i64(pc), "Pv": f(pv), "Rc": i64(rc), "Rv": f(rv),
                "np_Pc": pc,
            })
            lvl_A = (P.T @ (lvl_A @ P)).tocsr()
            lvl_A.sum_duplicates()

    @staticmethod
    def _rho(A, diag) -> float:
        n = A.shape[0]
        v = np.sin(np.arange(n) * 0.7) + 0.01
        rho = 1.0
        for _ in range(15):
            w = (A @ v) / diag
            rho = np.linalg.norm(w) / np.linalg.norm(v)
            v = w / np.linalg.norm(w)
        return float(rho * 1.05)

    # ------------------------------------------------------------------
    @staticmethod
    def _ell_mv(cols, vals, x):
        return (vals * x[cols]).sum(dim=1)

    def _smooth(self, lvl, x, b, nu):
        # Chebyshev over D^{-1}A on [rho/4, rho]
        mv = lambda u: self._ell_mv(lvl["cols"], lvl["vals"], u)
        diag = lvl["diag"]
        lmax = lvl["rho"]
        lmin = lmax / 4.0
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        rk = 1.0 / sigma
        z = (b - mv(x)) / diag
        p = z / theta
        x = x + p
        for _ in range(max(nu - 1, 0)):
            z = (b - mv(x)) / diag
            rn = 1.0 / (2.0 * sigma - rk)
            p = rn * rk * p + (2.0 * rn / delta) * z
            x = x + p
            rk = rn
        return x

    def _cycle(self, i, b):
        lvl = self.levels[i]
        if i == len(self.transfers):
            return self._smooth(lvl, torch.zeros_like(b), b,
                                self.coarse_iters)
        x = self._smooth(lvl, torch.zeros_like(b), b, self.nu)
        r = b - self._ell_mv(lvl["cols"], lvl["vals"], x)
        t = self.transfers[i]
        rc = self._ell_mv(t["Rc"], t["Rv"], r)
        xc = self._cycle(i + 1, rc)
        x = x + self._ell_mv(t["Pc"], t["Pv"], xc)
        return self._smooth(lvl, x, b, self.nu)

    def preconditioner(self, T=None, dt=None):
        """Frozen V-cycle apply (ignores the current iterate — the
        hierarchy was built at T_freeze)."""
        return lambda r: self._cycle(0, r.to(self.dtype))
