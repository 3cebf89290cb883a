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
"""

from __future__ import annotations

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.config import RunConfig
from fem_glass_tempering_tpu_torch.device import resolve_dtype
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.fem.mesh import Mesh
from fem_glass_tempering_tpu_torch.models.viscoelastic import (
    TABLEAU_SIZE,
    ViscoelasticEngine,
    ViscoState,
)
from fem_glass_tempering_tpu_torch.ops.assembly import (
    build_boundary_geometry,
    build_cell_geometry,
)
from fem_glass_tempering_tpu_torch.ops.scatter import GroupedScatter
from fem_glass_tempering_tpu_torch.parallel.comm import (
    DeviceMesh,
    all_gather,
    all_reduce_sum,
    gather_rows,
)
from fem_glass_tempering_tpu_torch.parallel.partition import partition_cells
from fem_glass_tempering_tpu_torch.solver.newton import newton_solve

# the T-space fields of the state (the rest live at the sigma points)
_T_FIELDS = ("T", "T_prev", "Tf", "Tf_prev", "Tf_partial", "phi", "xi")


def _local_ids(gids: np.ndarray, sorted_gids: np.ndarray) -> np.ndarray:
    """Positions of `gids` in `sorted_gids` (every one present)."""
    return np.searchsorted(sorted_gids, gids).astype(np.int32)


class CGDDProblem:
    """Domain-decomposed coupled tempering problem (CG temperature): this
    rank's share, on `device_mesh.device`."""

    def __init__(self, mesh: Mesh, config: RunConfig, device_mesh: DeviceMesh,
                 dtype=torch.float64):
        fe = config.fe
        if fe.T_family != "CG":
            raise ValueError("CGDDProblem requires a CG temperature space")
        self.config = config
        self.mesh = mesh
        self.dtype = resolve_dtype(dtype)
        self.comm = device_mesh
        self.device = device_mesh.device
        self.n_parts = device_mesh.size
        self.fs_T = FunctionSpace(mesh, "CG", fe.T_degree)
        self.fs_sigma = FunctionSpace(mesh, fe.sigma_family, fe.sigma_degree,
                                      value_shape=(mesh.tdim, mesh.tdim))
        self.engine = ViscoelasticEngine(
            self.fs_T, self.fs_sigma, config.params, config.time.dt,
            physics_mode=config.physics_mode, dtype=self.dtype,
            device=self.device)
        self.params = config.params
        self.dt = config.time.dt
        self._build_arrays()

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

        # sigma dofs by owner cell, with their evaluation rows
        fs_s = self.fs_sigma
        sdev = part[fs_s.owner_cell]
        Ls = max(int((sdev == r).sum()) for r in range(Pn)) or 1
        if (fs_s.family, fs_s.degree) == (fs.family, fs.degree):
            tab_rows = np.eye(nloc)[fs_s.owner_lpoint]
        else:
            tab = fs.element.tabulate(fs_s.element.interpolation_points())
            tab_rows = tab[fs_s.owner_lpoint]
        slot_of_cell = np.full(mesh.n_cells, -1, dtype=np.int32)
        slot_of_cell[cl] = np.arange(len(cl), dtype=np.int32)
        sidx = np.nonzero(sdev == p)[0]
        sg_tab = np.zeros((Ls, nloc))
        sg_src = np.zeros(Ls, dtype=np.int32)
        sg_dof = np.full(Ls, -1, dtype=np.int64)
        sg_tab[: len(sidx)] = tab_rows[sidx]
        sg_src[: len(sidx)] = slot_of_cell[fs_s.owner_cell[sidx]]
        sg_dof[: len(sidx)] = sidx

        self.Lg, self.n_local_cells, self.n_local_sigma = Lg, L, Ls
        self.local_gids = gids
        self.sg_dof = sg_dof
        dev = self.device
        f = lambda a: torch.as_tensor(a, dtype=self.dtype, device=dev)
        i = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                      device=dev)
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
        self._sg_ldof = i(ldof[sg_src])
        self._diag_cell = self._cell_diag()
        # what the gathers place: owned T dofs, valid sigma dofs
        own_l = np.nonzero(own[:n] > 0)[0]
        self._own_lids, self._own_gids = i(own_l), i(gids[own_l])
        sv = np.nonzero(sg_dof >= 0)[0]
        self._sg_lids, self._sg_gids = i(sv), i(sg_dof[sv])

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

    def _eval_sigma(self, name, arr):
        """A T-space field at this rank's sigma points."""
        src = arr[self._sg_ldof]                             # (Ls, nloc)
        return torch.einsum("tl,tl->t", self.arrs["sg_tab"], src)

    # ------------------------------------------------------------------
    def init_state(self) -> ViscoState:
        """This rank's initial state: (Lg,) T-space fields, (Ls, d, d)
        sigma-space fields."""
        p = self.params
        Lg, Ls, d = self.Lg, self.n_local_sigma, self.mesh.tdim
        f = lambda shape, v=0.0: torch.full(shape, v, dtype=self.dtype,
                                            device=self.device)
        return ViscoState(
            t=f(()),
            T=f((Lg,), p.T_0), T_prev=f((Lg,), p.T_0),
            Tf=f((Lg,), p.T_0), Tf_prev=f((Lg,), p.T_0),
            Tf_partial=f((Lg, TABLEAU_SIZE), p.T_0),
            phi=f((Lg,)), xi=f((Lg,)),
            thermal_strain=f((Ls, d, d)),
            total_strain=f((Ls, d, d)),
            deviatoric_strain=f((Ls, d, d)),
            s_tilde=f((Ls, TABLEAU_SIZE, d, d)),
            sigma_tilde=f((Ls, TABLEAU_SIZE, d, d)),
            s_partial=f((Ls, TABLEAU_SIZE, d, d)),
            sigma_partial=f((Ls, TABLEAU_SIZE, d, d)),
            sigma=f((Ls, d, d)),
        )

    def step(self, state: ViscoState):
        """One coupled step -> (state, converged on every rank, newton,
        cg); every rank must call it."""
        sc = self.config.solver
        res = newton_solve(
            lambda T: self._local_residual(T, state.T), state.T,
            jac_diag_fn=self._local_diag,
            rtol=sc.newton_rtol, atol=sc.newton_atol,
            max_it=sc.newton_max_it, cg_rtol=sc.cg_rtol,
            cg_atol=sc.cg_atol, cg_max_it=sc.cg_max_it, dot=self._dot)
        st = self.engine.material_step_with(state, res.x, self._eval_sigma)
        failed = torch.tensor(0.0 if res.converged else 1.0,
                              dtype=self.dtype, device=self.device)
        ok = bool(all_reduce_sum(failed, self.comm) == 0)
        return st, ok, res.iters, res.krylov_iters

    # ------------------------------------------------------------------
    def _gather_T(self, arr):
        return gather_rows(arr[self._own_lids], self._own_gids,
                           self.fs_T.n_scalar_dofs, self.comm)

    def _gather_S(self, arr):
        return gather_rows(arr[self._sg_lids], self._sg_gids,
                           self.fs_sigma.n_scalar_dofs, self.comm)

    def gather_T(self, state: ViscoState) -> torch.Tensor:
        """The global temperature, on every rank."""
        return self._gather_T(state.T)

    def gather_sigma(self, state: ViscoState) -> torch.Tensor:
        """The global (n_S, d, d) stress, on every rank."""
        return self._gather_S(state.sigma)

    def gather_state(self, state: ViscoState) -> ViscoState:
        """The global-layout ViscoState, on every rank: what the writers
        and io/checkpoint.py take."""
        return ViscoState(*(
            state.t if name == "t"
            else self._gather_T(v) if name in _T_FIELDS
            else None if v is None
            else self._gather_S(v)
            for name, v in zip(ViscoState._fields, state)))
