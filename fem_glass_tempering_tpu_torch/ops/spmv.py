"""Assembled-Jacobian ELL SpMV path for the heat operator.

Counterpart of fem_glass_tempering_tpu/ops/spmv.py. Matrix-free Newton-CG
recomputes the full element assembly on every CG iteration (jvp of the
residual). For the heat Jacobian
  J(T) = M + dt*(alpha*K + SIPG) + dt*B'(T)
only the boundary linearization B'(T) changes between CG solves, so M and
(alpha*K + SIPG) are pre-assembled into device-resident ELL arrays at
setup (numpy), the per-iterate boundary blocks are added with one
scatter-add, and CG matvecs run as gather + row-sum:

  y[i] = sum_k vals[i, k] * x[cols[i, k]]

The structure is built without a Python loop over (row, col) pairs:
`np.unique` sorts the pairs by (row, col), so a pair's slot is its rank
within its row and the flat index of any pair is a `searchsorted` on
row * n + col. The arrays equal those of the JAX package's per-pair loop.
"""

from __future__ import annotations

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator


def _pair_keys(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    """row * n + col for every (a[e, l], b[e, m]) pair, in (e, l, m) order."""
    return (a[:, :, None].astype(np.int64) * n
            + b[:, None, :].astype(np.int64)).reshape(-1)


class EllMatrix:
    """Static ELL structure + assembly maps for a HeatOperator's Jacobian."""

    def __init__(self, op: HeatOperator):
        self.op = op
        n = op.fs.n_scalar_dofs
        dofmap = np.asarray(op.np_dofmap)       # (c, l)
        b_dofmap = np.asarray(op.np_b_dofmap)

        # ---- (row, col) pairs of all coupling sources, as row*n + col ----
        cell_keys = _pair_keys(dofmap, dofmap, n)
        keys = [cell_keys]
        b_keys = None
        if len(b_dofmap):
            b_keys = _pair_keys(b_dofmap, b_dofmap, n)
            keys.append(b_keys)
        facet_keys = []
        if op.is_dg:
            dp = np.asarray(op.np_i["dofmap_p"])
            dm = np.asarray(op.np_i["dofmap_m"])
            facet_keys = [_pair_keys(a, b, n)
                          for a, b in ((dp, dp), (dp, dm), (dm, dp), (dm, dm))]
            keys.extend(facet_keys)
        uniq = np.unique(np.concatenate(keys))   # sorted by (row, col)
        rows, cols = uniq // n, uniq % n
        counts = np.bincount(rows, minlength=n)
        K = int(counts.max())
        self.K = K
        self.n = n
        # a pair's slot: its rank among its row's sorted columns
        row_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(uniq)) - row_start[rows]
        flat_of = slot + K * rows
        # unused slots point at column 0 with zero values -> harmless
        ell_cols = np.zeros(n * K, dtype=np.int32)
        ell_cols[flat_of] = cols
        self.np_cols = ell_cols.reshape(n, K)

        def flat_idx(pair_keys):
            return flat_of[np.searchsorted(uniq, pair_keys)]

        # ---- constant element matrices pre-assembled (numpy) ----
        qw = np.asarray(op.np_qw)
        phi = np.asarray(op.np_phi)
        gphi = np.asarray(op.np_gphi)
        if qw.ndim == 1:       # uniform-mesh compact tables ((q,), (q,l,g))
            nc = dofmap.shape[0]
            qw = np.broadcast_to(qw, (nc,) + qw.shape)
            gphi = np.broadcast_to(gphi, (nc,) + gphi.shape)
        mass_el = op.c_mass * np.einsum("cq,ql,qm->clm", qw, phi, phi)
        stiff_el = op.c_diff * np.einsum("cq,cqlg,cqmg->clm", qw, gphi, gphi)
        cell_idx = flat_idx(cell_keys)
        # bincount adds its weights one by one in input order, so one call
        # over cells then facet blocks sums as a sequence of scatter-adds does
        vals_mass = np.bincount(cell_idx, weights=mass_el.reshape(-1),
                                minlength=n * K)
        stiff_idx, stiff_w = [cell_idx], [stiff_el.reshape(-1)]

        if op.is_dg:
            ein = np.einsum
            coef = op.c_diff * op.np_i["qw"]                      # (f, q)
            php, phm = op.np_i["phi_p"], op.np_i["phi_m"]
            dnp_, dnm = op.np_i["dnphi_p"], op.np_i["dnphi_m"]
            penh = (op.params.dg_penalty / op.np_i["h_p"])[:, None]
            # d r_p / d T_p etc. — matches the residual's SIPG terms
            Jpp = (ein("fq,fql,fqm->flm", coef * penh, php, php)
                   - 0.5 * ein("fq,fql,fqm->flm", coef, dnp_, php)
                   - 0.5 * ein("fq,fql,fqm->flm", coef, php, dnp_))
            Jpm = (-ein("fq,fql,fqm->flm", coef * penh, php, phm)
                   + 0.5 * ein("fq,fql,fqm->flm", coef, dnp_, phm)
                   - 0.5 * ein("fq,fql,fqm->flm", coef, php, dnm))
            Jmp = (-ein("fq,fql,fqm->flm", coef * penh, phm, php)
                   - 0.5 * ein("fq,fql,fqm->flm", coef, dnm, php)
                   + 0.5 * ein("fq,fql,fqm->flm", coef, phm, dnp_))
            Jmm = (ein("fq,fql,fqm->flm", coef * penh, phm, phm)
                   + 0.5 * ein("fq,fql,fqm->flm", coef, dnm, phm)
                   + 0.5 * ein("fq,fql,fqm->flm", coef, phm, dnm))
            for J, fk in zip((Jpp, Jpm, Jmp, Jmm), facet_keys):
                stiff_idx.append(flat_idx(fk))
                stiff_w.append(J.reshape(-1))
        vals_stiff = np.bincount(np.concatenate(stiff_idx),
                                 weights=np.concatenate(stiff_w),
                                 minlength=n * K)

        dev, dtype = op.device, op.dtype
        self.cols = torch.as_tensor(self.np_cols.astype(np.int64), device=dev)
        self.vals_mass = torch.as_tensor(vals_mass.reshape(n, K), dtype=dtype,
                                         device=dev)
        self.vals_stiff = torch.as_tensor(vals_stiff.reshape(n, K),
                                          dtype=dtype, device=dev)

        # boundary-block scatter indices (values recomputed per Newton iter)
        if b_keys is not None:
            self.np_b_flat_idx = flat_idx(b_keys).astype(np.int64)
            self.b_flat_idx = torch.as_tensor(self.np_b_flat_idx, device=dev)
        else:
            self.np_b_flat_idx = self.b_flat_idx = None

    # ------------------------------------------------------------------
    def values_at(self, T: torch.Tensor, dt) -> torch.Tensor:
        """ELL values of J(T) = mass + dt*(stiff + B'(T))."""
        op = self.op
        p = op.params
        vals = self.vals_mass + dt * self.vals_stiff
        if self.b_flat_idx is not None:
            Tb = torch.einsum("fql,fl->fq", op.b_phi, T[op.b_dofmap])
            dflux = p.boundary_scale * (
                4.0 * p.sigma * p.epsilon * Tb**3 + p.htc)
            blocks = torch.einsum("fq,fql,fqm->flm", op.b_qw * dt * dflux,
                                  op.b_phi, op.b_phi)
            # b_flat_idx repeats (facets sharing a dof pair): index_add
            vals = vals.reshape(-1).index_add(
                0, self.b_flat_idx, blocks.reshape(-1)).reshape(self.n, self.K)
        return vals

    def matvec(self, vals: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y = A x via ELL gather + row-sum."""
        return (vals * x[self.cols]).sum(dim=1)

    def make_matvec(self, T: torch.Tensor, dt):
        vals = self.values_at(T, dt)
        if self.op.has_bc:
            mask = self.op.bc_mask
            return lambda v: torch.where(
                mask, v, self.matvec(vals, torch.where(
                    mask, torch.zeros_like(v), v)))
        return lambda v: self.matvec(vals, v)
