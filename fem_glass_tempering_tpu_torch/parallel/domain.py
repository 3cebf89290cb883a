"""Explicit domain decomposition for DG temperature spaces.

Counterpart of fem_glass_tempering_tpu/parallel/domain.py. The mesh is cut
into contiguous blocks of cells (parallel/partition.py) and each rank, one
process of a torch.distributed group, holds its block: row p of the JAX
version's (P, ...) arrays, padded to the longest rank's as there. With DG
elements the dofs are cell-local, so the only communication is
- the halo: every rank publishes the values of its interface cells, gathers
  every rank's publication (`all_gather`, parallel/comm.py) and reads the
  remote side of each cross-partition SIPG facet from it. A cross facet is
  computed on both of its ranks, each forming only its own cell's rows, so
  the halo runs one way;
- the sums of the Newton / CG inner products (`all_reduce_sum`).
Both collectives carry the tangent in forward mode, from which the Newton
loop takes its Jacobian action (torch.func.jvp, or a dual level as the step
here does). The cell term is the hand-written kernel K3
(ops/cuda_dg_cell.py) over the rank's real cells, with the single-cell
tables of a uniform box where the mesh is one; the facet terms and the
Jacobi diagonal are plain PyTorch, as in the JAX version, with the facet
weights folded into their tables. The material chain is local: a sigma
dof lives on the rank of its owner cell, whose T dofs the rank holds.

Padded rows (cells, boundary facets, interior and cross facets; at P = 1
the single zero-weight cross facet) add exact zeros to slot 0 in the JAX
version; here the sums run over the real rows alone. Padded cell slots
keep their initial T and get identity rows in the Jacobi diagonal; they
enter the inner products as in the JAX version.

`RankProblem` is what this module and parallel/domain_cg.py share: the
spaces and the material engine, the rank's sigma rows, the initial state,
the step and the gathers to the global layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F

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
    build_interior_geometry,
)
from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
    PreparedDGCellResidual,
)
from fem_glass_tempering_tpu_torch.ops.scatter import GroupedScatter
from fem_glass_tempering_tpu_torch.parallel.comm import (
    DeviceMesh,
    all_gather,
    all_reduce_sum,
    gather_rows,
)
from fem_glass_tempering_tpu_torch.parallel.partition import build_dd_layout
from fem_glass_tempering_tpu_torch.solver.newton import newton_solve

# the T-space fields of the state (the rest live at the sigma points)
T_FIELDS = ("T", "T_prev", "Tf", "Tf_prev", "Tf_partial", "phi", "xi")


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    """`arr` padded with zeros to n rows (JAX's `_pad_to`)."""
    out = np.zeros((n,) + arr.shape[1:], dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


class RankProblem:
    """This rank's share of a domain-decomposed coupled tempering problem,
    on `device_mesh.device`. A subclass builds its arrays
    (`_build_arrays`, which calls `_sigma_rows` and `_gather_maps`) and
    the local residual, Jacobi diagonal and inner product of its T space;
    every rank must call `step` and the gathers together."""

    T_FAMILY = ""
    REFUSAL = ""

    def __init__(self, mesh: Mesh, config: RunConfig, device_mesh: DeviceMesh,
                 dtype=torch.float64):
        fe = config.fe
        if fe.T_family != self.T_FAMILY:
            raise ValueError(self.REFUSAL)
        self.config = config
        self.mesh = mesh
        self.dtype = resolve_dtype(dtype)
        self.comm = device_mesh
        self.device = device_mesh.device
        self.n_parts = device_mesh.size
        self.fs_T = FunctionSpace(mesh, fe.T_family, fe.T_degree)
        self.fs_sigma = FunctionSpace(mesh, fe.sigma_family, fe.sigma_degree,
                                      value_shape=(mesh.tdim, mesh.tdim))
        self.engine = ViscoelasticEngine(
            self.fs_T, self.fs_sigma, config.params, config.time.dt,
            physics_mode=config.physics_mode, dtype=self.dtype,
            device=self.device)
        self.params = config.params
        self.dt = config.time.dt
        self._build_arrays()

    def _float(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                               device=self.device)

    def _index(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64),
                               device=self.device)

    # ------------------------------------------------------------------
    def _sigma_rows(self, part, slot_of_cell) -> tuple:
        """This rank's sigma dofs (those whose owner cell it holds), padded
        to the longest rank's count Ls: the rows that evaluate a T-space
        field there (identity rows where the spaces coincide) and the
        owner cells' local slots -> (sg_tab (Ls, nloc), sg_src (Ls,));
        `sg_dof` (Ls,) holds their global ids, -1 padding."""
        fs, fs_s, p = self.fs_T, self.fs_sigma, self.comm.rank
        nloc = fs.element.nloc
        sdev = part[fs_s.owner_cell]
        Ls = max(int((sdev == r).sum()) for r in range(self.n_parts)) or 1
        if (fs_s.family, fs_s.degree) == (fs.family, fs.degree):
            tab_rows = np.eye(nloc)[fs_s.owner_lpoint]
        else:
            tab = fs.element.tabulate(fs_s.element.interpolation_points())
            tab_rows = tab[fs_s.owner_lpoint]
        sidx = np.nonzero(sdev == p)[0]
        n = len(sidx)
        sg_tab = np.zeros((Ls, nloc))
        sg_src = np.zeros(Ls, dtype=np.int32)
        sg_dof = np.full(Ls, -1, dtype=np.int64)
        sg_tab[:n] = tab_rows[sidx]
        sg_src[:n] = slot_of_cell[fs_s.owner_cell[sidx]]
        sg_dof[:n] = sidx
        self.n_local_sigma, self.sg_dof = Ls, sg_dof
        return sg_tab, sg_src

    def _gather_maps(self, ldof, sg_src, t_lids, t_gids) -> None:
        """The index tensors of the sigma evaluation and of the gathers:
        `ldof` (L, nloc) local T dof of each cell slot, `t_lids` the local
        T dofs this rank places in the global vector, `t_gids` theirs."""
        self._sg_ldof = self._index(ldof[sg_src])
        self._own_lids, self._own_gids = self._index(t_lids), \
            self._index(t_gids)
        sv = np.nonzero(self.sg_dof >= 0)[0]
        self._sg_lids, self._sg_gids = self._index(sv), \
            self._index(self.sg_dof[sv])

    def _eval_sigma(self, name, arr):
        """A T-space field at this rank's sigma points."""
        src = arr[self._sg_ldof]                             # (Ls, nloc)
        return torch.einsum("tl,tl->t", self.arrs["sg_tab"], src)

    # ------------------------------------------------------------------
    def init_state(self) -> ViscoState:
        """This rank's initial state: (n_local_dofs,) T-space fields,
        (Ls, d, d) sigma-space fields."""
        p = self.params
        n, Ls, d = self.n_local_dofs, self.n_local_sigma, self.mesh.tdim
        f = lambda shape, v=0.0: torch.full(shape, v, dtype=self.dtype,
                                            device=self.device)
        return ViscoState(
            t=f(()),
            T=f((n,), p.T_0), T_prev=f((n,), p.T_0),
            Tf=f((n,), p.T_0), Tf_prev=f((n,), p.T_0),
            Tf_partial=f((n, TABLEAU_SIZE), p.T_0),
            phi=f((n,)), xi=f((n,)),
            thermal_strain=f((Ls, d, d)),
            total_strain=f((Ls, d, d)),
            deviatoric_strain=f((Ls, d, d)),
            s_tilde=f((Ls, TABLEAU_SIZE, d, d)),
            sigma_tilde=f((Ls, TABLEAU_SIZE, d, d)),
            s_partial=f((Ls, TABLEAU_SIZE, d, d)),
            sigma_partial=f((Ls, TABLEAU_SIZE, d, d)),
            sigma=f((Ls, d, d)),
        )

    def _jacobian_action(self, T_prev):
        """x -> (v -> J(x) v): the tangent of the local residual in a
        forward-mode dual level. torch.func.jvp, newton_solve's default,
        gives the same bits at a higher host cost: it wraps every
        operation, and builds a class for every autograd.Function call
        (the collectives) under its transform."""
        def at(x):
            def mv(v):
                with fwAD.dual_level():
                    r = self._local_residual(fwAD.make_dual(x, v), T_prev)
                    return fwAD.unpack_dual(r).tangent
            return mv
        return at

    def step(self, state: ViscoState):
        """One coupled step -> (state, converged on every rank, newton,
        cg); every rank must call it."""
        sc = self.config.solver
        res = newton_solve(
            lambda T: self._local_residual(T, state.T), state.T,
            jac_diag_fn=self._local_diag,
            matvec_fn=self._jacobian_action(state.T),
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
            else self._gather_T(v) if name in T_FIELDS
            else None if v is None
            else self._gather_S(v)
            for name, v in zip(ViscoState._fields, state)))


class DDProblem(RankProblem):
    """Domain-decomposed coupled tempering problem (DG temperature): this
    rank's share, on `device_mesh.device`."""

    T_FAMILY = "DG"
    REFUSAL = ("DDProblem requires a DG temperature space; use "
               "parallel.sharding for CG")

    def _build_arrays(self) -> None:
        """Row `rank` of the JAX version's (P, ...) arrays (`arrs`), and
        the views of their real rows that the step reads."""
        mesh, fs = self.mesh, self.fs_T
        Pn, p = self.n_parts, self.comm.rank
        nloc = fs.element.nloc
        layout, part, aux = build_dd_layout(mesh, nloc, fs.dofmap, Pn)
        self.layout, self.part = layout, part
        L = layout.n_local_cells
        soc = aux["slot_of_cell"]
        cl = aux["cells_by_dev"][p]

        cg = build_cell_geometry(mesh, fs)
        # boundary degree 5p matches HeatOperator (T^4 radiation integrand)
        bg = build_boundary_geometry(mesh, fs, 5 * fs.degree,
                                     with_grad=False)
        ig = build_interior_geometry(mesh, fs)
        pen_h = self.params.dg_penalty / ig.h_p

        # boundary facets by owning rank
        bdev = part[bg.cell]
        B = max(int((bdev == r).sum()) for r in range(Pn)) or 1
        bidx = np.nonzero(bdev == p)[0]

        # intra-rank interior facets
        I_ = max((len(v) for v in aux["intra_by_dev"]), default=1) or 1
        iidx = aux["intra_by_dev"][p]

        def dn(f, grad):
            """Normal derivatives of the basis along the '+' normal."""
            return np.einsum("fqlg,fqg->fql", grad[f], ig.normal_p[f])

        # cross-rank facets, both sides: this rank forms its own cell's rows
        cross = aux["cross_by_dev_side"][p]
        cf = np.array([f for f, _ in cross], dtype=np.int64)
        mine_p = np.array([s == 0 for _, s in cross], dtype=bool)
        sel = lambda a_p, a_m: np.where(  # noqa: E731
            mine_p.reshape((-1,) + (1,) * (a_p.ndim - 1)), a_p, a_m)
        n_cross = layout.n_cross
        dnp_c, dnm_c = dn(cf, ig.grad_p), dn(cf, ig.grad_m)

        sg_tab, sg_src = self._sigma_rows(part, soc)
        valid = np.zeros(L * nloc)
        valid[: len(cl) * nloc] = 1.0

        f, i, pad = self._float, self._index, _pad_rows
        # each facet's two sides stacked (axis 1): the '+' and '-' cells of
        # an intra-rank facet, the basis and its normal derivative on this
        # rank's and on the remote side of a cross facet
        ia_ph = f(pad(np.stack([ig.phi_p[iidx], ig.phi_m[iidx]], 1), I_))
        ia_dn = f(pad(np.stack([dn(iidx, ig.grad_p), dn(iidx, ig.grad_m)],
                               1), I_))
        cr_my = f(pad(np.stack([sel(ig.phi_p[cf], ig.phi_m[cf]),
                                sel(dnp_c, dnm_c)], 1), n_cross))
        cr_rm = f(pad(np.stack([sel(ig.phi_m[cf], ig.phi_p[cf]),
                                sel(dnm_c, dnp_c)], 1), n_cross))
        self.arrs = dict(
            qw=f(pad(cg.qweights[cl], L)), gphi=f(pad(cg.grad_phys[cl], L)),
            phi=f(cg.phi),
            b_slot=i(pad(soc[bg.cell[bidx]], B)),
            b_qw=f(pad(bg.qweights[bidx], B)), b_phi=f(pad(bg.phi[bidx], B)),
            ia_sp=i(pad(soc[ig.cell_p[iidx]], I_)),
            ia_sm=i(pad(soc[ig.cell_m[iidx]], I_)),
            ia_qw=f(pad(ig.qweights[iidx], I_)),
            ia_php=ia_ph[:, 0], ia_phm=ia_ph[:, 1],
            ia_dnp=ia_dn[:, 0], ia_dnm=ia_dn[:, 1],
            ia_pen=f(pad(pen_h[iidx], I_)),
            cr_slot=i(pad(soc[sel(ig.cell_p[cf], ig.cell_m[cf])], n_cross)),
            cr_qw=f(pad(ig.qweights[cf], n_cross)),
            cr_ph_my=cr_my[:, 0], cr_ph_rm=cr_rm[:, 0],
            cr_dn_my=cr_my[:, 1], cr_dn_rm=cr_rm[:, 1],
            cr_pen=f(pad(pen_h[cf], n_cross)),
            cr_sign=f(pad(np.where(mine_p, -1.0, 1.0), n_cross)),
            cr_recv=i(layout.cross_recv_flat[p]),
            send_slot=i(layout.send_cell_slot[p]),
            sg_tab=f(sg_tab), sg_src=i(sg_src),
            valid_dof=f(valid),
        )
        self.n_local_cells, self.n_local_dofs = L, L * nloc
        nc = len(cl)
        ldof = np.arange(L * nloc).reshape(L, nloc)
        self._gather_maps(ldof, sg_src, np.arange(nc * nloc),
                          layout.global_dof_of_local[p][: nc * nloc])
        self._prepare(nc, len(bidx), ia_ph[: len(iidx)],
                      ia_dn[: len(iidx)], cr_my[: len(cf)], cr_rm[: len(cf)])

    def _prepare(self, nc, nb, ia_ph, ia_dn, cr_my, cr_rm) -> None:
        """The step's tables, over the real rows of `arrs`: the K3 call
        over the real cells, the facet weights times dt alpha, one scatter
        of every facet row into the cell slots, the constant part of the
        Jacobi diagonal. (f, 2, q, nloc) stacks hold a facet's two sides."""
        A, pc, dt = self.arrs, self.params, self.dt
        nloc, L = self.fs_T.element.nloc, self.n_local_cells
        ni, ncr = len(ia_ph), len(cr_my)
        self._nc = nc
        if self.mesh.structured is not None:
            # a uniform box: the rank's cells are congruent, so K3 takes
            # single-cell tables (by value on the card)
            qw, gphi = A["qw"][0], A["gphi"][0]
        else:
            qw, gphi = A["qw"][:nc], A["gphi"][:nc]
        self._cell_term = PreparedDGCellResidual(qw, gphi, A["phi"])
        # Every product in the residual is an einsum with a constant table
        # or between two tensors that carry tangents: forward-mode AD of a
        # product of a dual and a plain tensor (or a number) takes a slow
        # path through the zero tangent, ~30x the time of either. So the
        # weights are folded into tables here. The boundary flux
        # s (sigma eps (T^4 - Ta^4) + htc (T - Ta)) is a table of each of
        # T^4, T and 1.
        ein, bs, pe = torch.einsum, pc.boundary_scale, pc.sigma * pc.epsilon
        b_phi, qwdt = A["b_phi"][:nb], A["b_qw"][:nb] * dt
        w = torch.stack([bs * pe * qwdt, bs * pc.htc * qwdt,
                         -bs * (pe * pc.T_ambient**4
                                + pc.htc * pc.T_ambient) * qwdt], 1)
        self._b = dict(slot=A["b_slot"][:nb], phi=b_phi, qwdt=qwdt,
                       phi2=b_phi * b_phi, ones=torch.ones_like(qwdt),
                       rows=w[..., None] * b_phi[:, None])  # (f, 3, q, l)
        # intra-rank facets: the values and half normal derivatives on
        # both sides (f, 2 kinds, 2 sides, q, nloc) give the jump and the
        # mean derivative at the points; the rows of the '+' and the '-'
        # cell for each of them. With w_ph = coef (pen jump - avg) and
        # w_dn = coef jump / 2 (JAX domain.py:259-274) the '+' rows are
        # w_ph php - w_dn dnp, the '-' rows -w_ph phm - w_dn dnm.
        da = dt * pc.alpha
        coef, pen = da * A["ia_qw"][:ni], A["ia_pen"][:ni, None]
        sign = torch.tensor([1.0, -1.0], dtype=self.dtype,
                            device=self.device)[:, None, None]
        ph_rows, dn_rows = ia_ph * sign, -ia_dn
        c4 = coef[:, None, :, None]
        self._ia = dict(
            slots=torch.stack([A["ia_sp"][:ni], A["ia_sm"][:ni]], 1),
            vals=torch.stack([ia_ph, 0.5 * ia_dn], 1),
            rows=torch.stack([c4 * (pen[..., None, None] * ph_rows
                                    + 0.5 * dn_rows), -c4 * ph_rows], 1))
        # cross-rank facets: the values and half derivatives of this
        # rank's and of the remote cell give D and the mean derivative Av;
        # the rows are coef (pen D + s Av) ph_my + coef s D / 2 dn_my
        # (JAX domain.py:280-292)
        c_cr, p_cr = da * A["cr_qw"][:ncr], A["cr_pen"][:ncr, None]
        s_cr = A["cr_sign"][:ncr, None]
        ph_my, dn_my = cr_my[:, 0], cr_my[:, 1]
        c3, p3, s3 = c_cr[..., None], p_cr[..., None], s_cr[..., None]
        self._cr = dict(
            slot=A["cr_slot"][:ncr], recv=A["cr_recv"][:ncr],
            my=torch.stack([ph_my, 0.5 * dn_my], 1),
            rm=torch.stack([cr_rm[:, 0], 0.5 * cr_rm[:, 1]], 1),
            rows=torch.stack([c3 * (p3 * ph_my + 0.5 * s3 * dn_my),
                              c3 * s3 * ph_my], 1))
        slots = [t.reshape(-1).cpu().numpy() for t in (
            self._b["slot"], self._ia["slots"], self._cr["slot"])]
        self._sc_facets = GroupedScatter(np.concatenate(slots), L,
                                         self.device)
        self._sc_b = GroupedScatter(slots[0], L, self.device)

        # the T-independent part of the diagonal (JAX domain.py:305-325)
        qw, gphi, phi = A["qw"][:nc], A["gphi"][:nc], A["phi"]
        d = qw @ (phi * phi) + da * (
            qw[..., None] * (gphi * gphi).sum(3)).sum(1)
        d_f = torch.cat([
            torch.zeros((nb, nloc), dtype=self.dtype, device=self.device),
            (ein("fq,fsql->fsl", coef * pen, ia_ph * ia_ph)
             + ein("fq,fsql->fsl", coef, ph_rows * dn_rows)
             ).reshape(-1, nloc),
            ein("fq,fql->fl", c_cr * p_cr, ph_my * ph_my)
            + ein("fq,fql->fl", c_cr * s_cr, ph_my * dn_my)])
        d = F.pad(d, (0, 0, 0, L - nc)) + self._sc_facets(d_f, (nloc,))
        valid = A["valid_dof"]
        self._const_diag = d.reshape(-1) * valid + (1.0 - valid)

    # ------------------------------------------------------------------
    def _dot(self, a, b):
        return all_reduce_sum(torch.dot(a, b), self.comm)

    def _cross_rows(self, Tc):
        """The cross-rank SIPG facets' rows of this rank's cells, through
        the halo: every rank publishes its interface cells and gathers
        everyone's. Every rank takes part, with or without cross facets of
        its own."""
        cr, ein = self._cr, torch.einsum
        allv = all_gather(Tc[self.arrs["send_slot"]], self.comm)
        my = ein("fkql,fl->fkq", cr["my"], Tc[cr["slot"]])
        rm = ein("fkql,fl->fkq", cr["rm"], allv[cr["recv"]])
        w = torch.stack([my[:, 0] - rm[:, 0], my[:, 1] + rm[:, 1]], 1)
        return ein("fkq,fkql->fl", w, cr["rows"])

    def _local_residual(self, T, T_prev):
        """This rank's rows of the residual; T is (L * nloc,)."""
        pc, dt, nloc = self.params, self.dt, self.fs_T.element.nloc
        L, nc, ein = self.n_local_cells, self._nc, torch.einsum
        Tc = T.reshape(L, nloc)
        # mass + source + diffusion: K3 over the real cells
        r = self._cell_term(Tc[:nc], T_prev.reshape(L, nloc)[:nc], dt=dt,
                            c_mass=1.0, c_diff=pc.alpha, f_src=pc.f)
        if nc < L:
            r = F.pad(r, (0, 0, 0, L - nc))
        # boundary Robin terms
        b, ia = self._b, self._ia
        Tb = ein("fql,fl->fq", b["phi"], Tc[b["slot"]])
        # intra-rank SIPG facets: jump and mean derivative, both cells' rows
        v = ein("fksql,fsl->fksq", ia["vals"], Tc[ia["slots"]])
        w = torch.stack([v[:, 0, 0] - v[:, 0, 1], v[:, 1, 0] + v[:, 1, 1]],
                        1)
        rows = [ein("fkq,fkql->fl", torch.stack([Tb**4, Tb, b["ones"]], 1),
                    b["rows"]),
                ein("fkq,fksql->fsl", w, ia["rows"]).reshape(-1, nloc)]
        if self.n_parts > 1:
            rows.append(self._cross_rows(Tc))
        r = r + self._sc_facets(torch.cat(rows), (nloc,))
        return r.reshape(-1)

    def _local_diag(self, T):
        """The Jacobi diagonal at T: the constant part and the boundary's
        radiation and convection."""
        pc, nloc = self.params, self.fs_T.element.nloc
        b = self._b
        Tb = torch.einsum("fql,fl->fq", b["phi"],
                          T.reshape(-1, nloc)[b["slot"]])
        dflux = pc.boundary_scale * (
            4.0 * pc.sigma * pc.epsilon * Tb**3 + pc.htc)
        d_b = torch.einsum("fq,fql->fl", b["qwdt"] * dflux, b["phi2"])
        return self._const_diag + self._sc_b(d_b, (nloc,)).reshape(-1)
