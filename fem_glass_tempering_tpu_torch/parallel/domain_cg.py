"""Explicit domain decomposition for CG temperature spaces.

Counterpart of fem_glass_tempering_tpu/parallel/domain_cg.py. With
continuous elements the dofs on a partition interface are shared: each
rank stores a local dof vector (its cells' dofs, padded to the longest
rank's), keeps the values of shared dofs equal on every rank, and
- sums its assembly partials over the interface: every rank publishes its
  interface partials, gathers all ranks' publications (`all_gather`,
  parallel/comm.py) and SETS each interface dof to the sum of the
  publications that name it (the reference's scatter_forward);
- weights shared dofs by an ownership mask in the Newton / CG inner
  products and sums them over the ranks (PETSc's VecDot over ghosts).
The material chain runs on each rank's own sigma dofs (those whose owner
cell it holds). Rank p holds row p of the JAX version's (P, ...) arrays,
which the setup builds with the same partition (parallel/partition.py).
The spaces, the state, the step and the gathers are those of the DG
decomposition's `RankProblem` (parallel/domain.py).
"""

from __future__ import annotations

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.ops.assembly import (
    build_boundary_geometry,
    build_cell_geometry,
)
from fem_glass_tempering_tpu_torch.ops.scatter import GroupedScatter
from fem_glass_tempering_tpu_torch.parallel.comm import (
    all_gather,
    all_reduce_sum,
)
from fem_glass_tempering_tpu_torch.parallel.domain import RankProblem
from fem_glass_tempering_tpu_torch.parallel.partition import partition_cells


def _local_ids(gids: np.ndarray, sorted_gids: np.ndarray) -> np.ndarray:
    """Positions of `gids` in `sorted_gids` (every one present)."""
    return np.searchsorted(sorted_gids, gids).astype(np.int32)


class CGDDProblem(RankProblem):
    """Domain-decomposed coupled tempering problem (CG temperature): this
    rank's share, on `device_mesh.device`."""

    T_FAMILY = "CG"
    REFUSAL = "CGDDProblem requires a CG temperature space"

    # ------------------------------------------------------------------
    def _build_arrays(self) -> None:
        """The JAX version's (P, ...) arrays, row `rank` of them: its dict
        loops as searchsorted over each rank's sorted dof ids."""
        mesh, fs = self.mesh, self.fs_T
        Pn, p = self.n_parts, self.comm.rank
        nloc = fs.element.nloc
        part = partition_cells(mesh, Pn)
        self.part = part
        cells_by_dev = [np.nonzero(part == r)[0].astype(np.int32)
                        for r in range(Pn)]
        L = max(len(c) for c in cells_by_dev)
        local_gids = [np.unique(fs.dofmap[c]) for c in cells_by_dev]
        Lg = max(len(g) for g in local_gids)
        own_dev = part[fs.owner_cell]
        touch = np.zeros(fs.n_scalar_dofs, dtype=np.int32)
        for g in local_gids:
            touch[g] += 1

        cg = build_cell_geometry(mesh, fs)
        bg = build_boundary_geometry(mesh, fs, 5 * fs.degree,
                                     with_grad=False)
        q = cg.qweights.shape[1]
        cl, gids = cells_by_dev[p], local_gids[p]
        qw = np.zeros((L, q))
        gphi = np.zeros((L, q, nloc, mesh.gdim))
        ldof = np.zeros((L, nloc), dtype=np.int32)
        qw[: len(cl)] = cg.qweights[cl]
        gphi[: len(cl)] = cg.grad_phys[cl]
        ldof[: len(cl)] = _local_ids(fs.dofmap[cl], gids)

        bdev = part[bg.cell]
        B = max(int((bdev == r).sum()) for r in range(Pn)) or 1
        idx = np.nonzero(bdev == p)[0]
        b_qw = np.zeros((B, bg.qweights.shape[1]))
        b_phi = np.zeros((B,) + bg.phi.shape[1:])
        b_ldof = np.zeros((B, nloc), dtype=np.int32)
        b_qw[: len(idx)] = bg.qweights[idx]
        b_phi[: len(idx)] = bg.phi[idx]
        b_ldof[: len(idx)] = _local_ids(fs.dofmap[bg.cell[idx]], gids)

        n = len(gids)
        valid = np.zeros(Lg)
        valid[:n] = 1.0
        own = np.zeros(Lg)
        own[:n] = (own_dev[gids] == p).astype(float)
        iface = [np.nonzero(touch[g] > 1)[0].astype(np.int32)
                 for g in local_gids]
        S = max((len(v) for v in iface), default=1) or 1
        pub_gid = np.full((Pn, S), -1, dtype=np.int64)
        for r, lst in enumerate(iface):
            pub_gid[r, : len(lst)] = local_gids[r][lst]
        pub_lidx = np.zeros(S, dtype=np.int32)
        pub_lidx[: len(iface[p])] = iface[p]
        # row r of the flattened (P*S) publication accumulates into local
        # dof map_acc[r], or into the dump slot Lg
        flat = pub_gid.reshape(-1)
        pos = np.minimum(np.searchsorted(gids, flat), n - 1)
        map_acc = np.where((flat >= 0) & (gids[pos] == flat), pos,
                           Lg).astype(np.int32)
        is_iface = np.zeros(Lg)
        is_iface[iface[p]] = 1.0

        slot_of_cell = np.full(mesh.n_cells, -1, dtype=np.int32)
        slot_of_cell[cl] = np.arange(len(cl), dtype=np.int32)
        sg_tab, sg_src = self._sigma_rows(part, slot_of_cell)

        self.n_local_dofs, self.n_local_cells = Lg, L
        self.local_gids = gids
        dev = self.device
        f, i = self._float, self._index
        self.arrs = dict(
            qw=f(qw), gphi=f(gphi), phi=f(cg.phi), ldof=i(ldof),
            b_ldof=i(b_ldof), b_qw=f(b_qw), b_phi=f(b_phi),
            own=f(own), valid=f(valid), is_iface=f(is_iface),
            pub_lidx=i(pub_lidx), map_acc=i(map_acc),
            sg_tab=f(sg_tab), sg_src=i(sg_src))
        # the segment sums, one group of distinct targets at a time, over
        # the rows that carry something: padded cells and facets add exact
        # zeros to slot 0, padded publications go to the dump slot
        self._nc, self._nb = len(cl), len(idx)
        self._sc_cell = GroupedScatter(ldof[: len(cl)], Lg, dev)
        self._sc_b = GroupedScatter(b_ldof[: len(idx)], Lg, dev)
        keep = np.nonzero(map_acc < Lg)[0]
        self._acc_rows = i(keep)
        self._sc_acc = GroupedScatter(map_acc[keep], Lg, dev)
        self._diag_cell = self._cell_diag()
        # what the gathers place: owned T dofs
        own_l = np.nonzero(own[:n] > 0)[0]
        self._gather_maps(ldof, sg_src, own_l, gids[own_l])

    # ------------------------------------------------------------------
    def _dot(self, a, b):
        """Shared dofs counted once: weighted by the ownership mask."""
        return all_reduce_sum(torch.dot(a * self.arrs["own"], b), self.comm)

    def _halo_sum(self, r):
        """Ghost accumulation: publish the interface partials, gather
        every rank's, SET each interface dof to their sum."""
        A = self.arrs
        allv = all_gather(r[A["pub_lidx"]], self.comm)
        acc = self._sc_acc(allv[self._acc_rows])
        return torch.where(A["is_iface"] > 0, acc, r)

    def _local_residual(self, T, T_prev):
        A, pc, dt = self.arrs, self.params, self.dt
        gphi = A["gphi"]
        Tc, Tpc = T[A["ldof"]], T_prev[A["ldof"]]
        Tq, Tpq = Tc @ A["phi"].T, Tpc @ A["phi"].T
        # the per-cell contractions as products and sums over the tables:
        # batched matrix products of one row a cell are slow on the card
        gTq = (gphi * Tc[:, None, :, None]).sum(2)           # (c, q, g)
        mass_src = A["qw"] * ((Tq - Tpq) - dt * pc.f)
        r_cell = mass_src @ A["phi"]
        r_cell = r_cell + dt * pc.alpha * (
            gphi * (A["qw"][..., None] * gTq)[:, :, None, :]).sum((1, 3))
        r = self._sc_cell(r_cell[: self._nc])
        Tb = torch.einsum("fql,fl->fq", A["b_phi"], T[A["b_ldof"]])
        gflux = pc.boundary_scale * (
            (pc.sigma * pc.epsilon) * (Tb**4 - pc.T_ambient**4)
            + pc.htc * (Tb - pc.T_ambient))
        r_b = torch.einsum("fq,fql->fl", A["b_qw"] * dt * gflux, A["b_phi"])
        return self._halo_sum(r + self._sc_b(r_b[: self._nb]))

    def _cell_diag(self):
        """The cell integrals' part of the diagonal (T-independent)."""
        A, pc = self.arrs, self.params
        gphi = A["gphi"]
        d = A["qw"] @ (A["phi"] * A["phi"])
        d = d + self.dt * pc.alpha * (
            A["qw"][..., None] * (gphi * gphi).sum(3)).sum(1)
        return self._sc_cell(d[: self._nc])

    def _local_diag(self, T):
        A, pc, dt = self.arrs, self.params, self.dt
        Tb = torch.einsum("fql,fl->fq", A["b_phi"], T[A["b_ldof"]])
        dflux = pc.boundary_scale * (
            4.0 * pc.sigma * pc.epsilon * Tb**3 + pc.htc)
        d_b = torch.einsum("fq,fql,fql->fl", A["b_qw"] * dt * dflux,
                           A["b_phi"], A["b_phi"])
        dd = self._halo_sum(self._diag_cell + self._sc_b(d_b[: self._nb]))
        # padded slots: identity rows
        return dd * A["valid"] + (1.0 - A["valid"])
