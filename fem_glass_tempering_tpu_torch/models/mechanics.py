"""Mechanical-equilibrium coupling for the viscoelastic chain.

Counterpart of fem_glass_tempering_tpu/models/mechanics.py. The reference
sets total strain := -thermal strain and skips force balance
(ViscoelasticModel.py:136-139). With `RunConfig.mechanics='equilibrium'`
each step:

  1. the thermal strain increment d_eps_th = scalar_th * I and the scaled
     time xi come from the usual T-space chain;
  2. the displacement increment du solves the quasi-static equilibrium
     div( sigma_hist + C_eff : (eps(du) - d_eps_th) ) = 0, with C_eff the
     effective Prony tangent at xi and sigma_hist the decayed accumulated
     stress (ops/elasticity.py, ops/grid_elasticity.py);
  3. the engine's total strain becomes eps(du) - d_eps_th, and the usual
     eq. 15-18 updates give a stress field in (weak) equilibrium.

With du = 0 this is the reference's semantics. A coupling is called as
`mech(state, xi, scalar_th)` by ViscoelasticEngine.material_step and
returns (eps(du) at the sigma-space points, du); `last_cg_iters` holds
the count of its last elasticity CG solve. RankMechanicsCoupling is the
grid coupling on one rank of the grid-sharded step
(parallel/grid_shard.py).
"""

from __future__ import annotations

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.ops.assembly import build_cell_geometry
from fem_glass_tempering_tpu_torch.ops.elasticity import ElasticityOperator
from fem_glass_tempering_tpu_torch.ops.grid_elasticity import (
    GridElasticityOperator,
)
from fem_glass_tempering_tpu_torch.solver.grid_mg import (
    GridElastMG,
    RankGridElastMG,
)
from fem_glass_tempering_tpu_torch.solver.krylov import pcg


def _effective_moduli(eng, xi_q):
    """G_eff, K_eff: the Prony tangent at scaled time xi_q (tableau axis
    summed), with the relax factor the stress update uses."""
    G = torch.sum(eng.g_n * eng._relax_factor(
        xi_q[..., None] / eng.lambda_g_n), dim=-1)
    K = torch.sum(eng.k_n * eng._relax_factor(
        xi_q[..., None] / eng.lambda_k_n), dim=-1)
    return G, K


def _history_stress(eng, state, xi_S):
    """The decayed accumulated stress at the sigma-space points xi_S
    ((nS,) or grid-shaped; the source fields flat or shaped alike) ->
    xi_S.shape + (d, d): the engine's eq. 16a/b decay of the mode's
    source fields."""
    ref = eng.mode == "reference"
    s_src = state.s_tilde if ref else state.s_partial
    sig_src = state.sigma_tilde if ref else state.sigma_partial
    s_src = s_src.reshape(xi_S.shape + s_src.shape[-3:])
    sig_src = sig_src.reshape(xi_S.shape + sig_src.shape[-3:])
    texp_g = eng._decay(xi_S[..., None] / eng.lambda_g_n)[..., None, None]
    texp_k = eng._decay(xi_S[..., None] / eng.lambda_k_n)[..., None, None]
    return torch.sum(s_src * texp_g + sig_src * texp_k, dim=-3)


class DGNodeMechAdapter:
    """GridMechanicsCoupling for a DG T space: the elasticity solve lives on
    the sigma-space node grid, so the DG dof arrays (xi, the thermal-strain
    scalar) go through the T -> sigma cross-eval first (the engine's
    `to_sigma.eval`: each node takes its owner cell's value, the highest
    cell index winning)."""

    def __init__(self, inner, ev):
        self.inner = inner
        self._ev = ev

    @property
    def last_cg_iters(self):
        return self.inner.last_cg_iters

    def __call__(self, state, xi, scalar_th, precond=None):
        return self.inner(state, self._ev("T", xi),
                          self._ev("T", scalar_th), precond=precond)

    def build_precond(self, state):
        return self.inner.build_precond(
            state._replace(xi=self._ev("T", state.xi)))


class MechanicsCoupling:
    """Equilibrium mechanics on any mesh: the gather-assembled elasticity
    operator with Jacobi-CG."""

    def __init__(self, fs_T: FunctionSpace, fs_sigma: FunctionSpace,
                 engine, dtype=torch.float64, cg_rtol: float = 1e-10,
                 cg_max_it: int = 2000, inc_rtol: float = 0.0):
        self.engine = engine
        self.d = fs_T.mesh.tdim
        dev = engine.device
        self.elast = ElasticityOperator(fs_sigma, dtype=dtype, device=dev)
        self.cg_rtol = cg_rtol
        self.cg_max_it = cg_max_it
        self.inc_rtol = inc_rtol
        # tabulations at the elasticity operator's quadrature points
        qp = build_cell_geometry(fs_T.mesh, self.elast.fs).qpoints_ref
        f = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=dev)
        i64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64),
                                        device=dev)
        self.tab_T = f(fs_T.element.tabulate(qp))         # (q, lT)
        self.dof_T = i64(fs_T.dofmap)                     # (c, lT)
        self.tab_S = f(fs_sigma.element.tabulate(qp))     # (q, lS)
        self.dof_S = i64(fs_sigma.dofmap)                 # (c, lS)
        self.I = f(np.eye(self.d))
        self.last_cg_iters = None

    def build_precond(self, state):
        """No lagged preconditioner on the gather path (Jacobi-CG)."""
        return None

    def _T_at_q(self, arr):
        """T-space dof array -> (c, q) values at the quadrature points."""
        return torch.einsum("ql,cl->cq", self.tab_T, arr[self.dof_T])

    def _S_at_q(self, arr):
        """sigma-space dof array (n, ...) -> (c, q, ...)."""
        return torch.einsum("ql,cl...->cq...", self.tab_S, arr[self.dof_S])

    def __call__(self, state, xi, scalar_th):
        """eps(du) at the sigma-space dofs, and du. xi, scalar_th: T-space
        dof arrays; `state` provides the decayed history (and du, the warm
        start)."""
        eng = self.engine
        xi_q = self._T_at_q(xi)                            # (c, q)
        th_q = self._T_at_q(scalar_th)
        eps0_q = th_q[..., None, None] * self.I            # (c, q, d, d)
        G_eff, K_eff = _effective_moduli(eng, xi_q)
        xi_S = eng.to_sigma.eval("T", xi)                  # (nS,)
        sigma_hist_q = self._S_at_q(_history_stress(eng, state, xi_S))
        du, iters = self.elast.solve_increment(
            sigma_hist_q, eps0_q, G_eff, K_eff,
            rtol=self.cg_rtol, max_it=self.cg_max_it,
            x0=state.du, rtol_r0=self.inc_rtol)
        self.last_cg_iters = iters
        return self.elast.strain_at_sigma_dofs(du), du


class GridMechanicsCoupling:
    """Gather-free equilibrium mechanics on uniform box meshes
    (ops/grid_elasticity.py): the coupling of MechanicsCoupling on
    grid-shaped fields, with the vector V-cycle of solver/grid_mg.py as the
    CG preconditioner ("mg"; any other `preconditioner` is Jacobi-CG).
    `pad_axis0` appends ghost node planes along axis 0 (the sharded
    step's layout); `grid_shaped=True` takes and returns (*grid, ...)
    fields, False the flat (n, ...) ViscoState layout, reshaped at the
    boundary. `rank_form` runs it on one rank's rows of a grid split along
    axis 0 (RankMechanicsCoupling; with the block tables only)."""

    def __init__(self, fs_sigma, engine, dtype=torch.float32,
                 cg_rtol: float = 1e-10, cg_max_it: int = 2000,
                 pad_axis0: int = 0, grid_shaped: bool = False,
                 preconditioner: str = "mg", inc_rtol: float = 0.0,
                 use_tables: bool = True):
        self.engine = engine
        dev = engine.device
        self.el = GridElasticityOperator(fs_sigma, dtype=dtype,
                                         pad_axis0=pad_axis0, device=dev)
        self.d = self.el.d
        self.cg_rtol = cg_rtol
        self.cg_max_it = cg_max_it
        self.inc_rtol = inc_rtol
        # materialized block-stencil tables for the CG / V-cycle matvecs,
        # or the cell recompute
        self.use_tables = use_tables
        self.grid_shaped = grid_shaped
        self.I = torch.eye(self.d, dtype=dtype, device=dev)
        self.last_cg_iters = None
        # the vector geometric MG preconditions the CG: Jacobi-CG stalls
        # on thin plates
        self.mg = None
        if preconditioner != "mg":
            return

        def make_level_op(level_mesh):
            fsl = FunctionSpace(level_mesh, "CG", 1,
                                value_shape=(self.d, self.d))
            return GridElasticityOperator(fsl, dtype=dtype, device=dev)

        # the frozen instantaneous moduli of the dense coarse solve (xi = 0:
        # relax factor 1 -> G = sum g_n, K = sum k_n), from the numpy
        # tableau. Only in trapezoid-xi mode: the reference Taylor relax
        # factor 1 - y/2 turns negative for y > 2, and a positive frozen
        # coarse inverse then breaks CG
        frozen = None
        if engine.xi_formula == "trapezoid":
            tb = engine.tableaus
            frozen = (float(np.sum(tb.g_n)), float(np.sum(tb.k_n)))
        self.mg = GridElastMG(self.el, make_level_op, frozen_moduli=frozen,
                              use_tables=use_tables)

    def _moduli_at(self, xi_g):
        """(G_q, K_q) at the nodal scaled-time grid xi_g, per cell and
        quadrature point."""
        return _effective_moduli(self.engine,
                                 self.el.cell_avg_from_nodes(xi_g))

    def rank_form(self, device_mesh, rows) -> "RankMechanicsCoupling":
        """This coupling on rank `device_mesh.rank` of a grid split along
        axis 0, `rows` every rank's planes [lo, hi) of the (padded) grid."""
        return RankMechanicsCoupling(self, device_mesh, rows)

    def build_precond(self, state):
        """The elasticity V-cycle frozen at `state` (a jac_every chunk's
        start): per-level tables, smoother factors and spectrum bounds.
        The CG system itself stays exact, rebuilt in every call; only the
        preconditioner is reused. None without the V-cycle."""
        if self.mg is None:
            return None
        G_eff, K_eff = self._moduli_at(state.xi.reshape(self.el.grid))
        return self.mg.preconditioner_g(G_eff, K_eff)

    def __call__(self, state, xi, scalar_th, precond=None):
        el = self.el
        eng = self.engine
        grid = el.grid
        d = self.d
        xi_g = xi.reshape(grid)
        th_q = el.cell_avg_from_nodes(scalar_th.reshape(grid))
        eps0_q = th_q[..., None, None] * self.I
        G_eff, K_eff = self._moduli_at(xi_g)
        # the decayed history stress at the nodes, then at the quad points
        sigma_hist_q = el.tensor_at_q(
            _history_stress(eng, state, xi_g))

        zero = torch.zeros(grid + (d,), dtype=G_eff.dtype,
                           device=G_eff.device)
        b = -el.residual_g(zero, sigma_hist_q, eps0_q, G_eff, K_eff)
        if self.use_tables:
            tbl = el.stencil_table_g(G_eff, K_eff)
            mv = lambda v: el.matvec_table_g(tbl, v)  # noqa: E731
        else:
            tbl = None
            mv = el.make_matvec_g(G_eff, K_eff)
        diag = el.jacobian_diag_g(G_eff, K_eff)
        if precond is None and self.mg is not None:
            precond = self.mg.preconditioner_g(G_eff, K_eff,
                                               fine_table=tbl)
        # warm start from the previous step's displacement: the test stays
        # relative to ||b||, so the accuracy is the same
        x0 = None
        if state.du is not None:
            x0 = state.du.reshape(grid + (d,)).to(b.dtype)
        res = pcg(mv, b, x0=x0, diag=diag, precond=precond,
                  rtol=self.cg_rtol, max_it=self.cg_max_it,
                  rtol_r0=self.inc_rtol)
        self.last_cg_iters = res.iters
        eps = el.strain_at_nodes(res.x)                   # (*grid, d, d)
        if self.grid_shaped:
            return eps, res.x
        return eps.reshape(-1, d, d), res.x.reshape(-1, d)


class RankMechanicsCoupling:
    """GridMechanicsCoupling on one rank of a grid split along axis 0
    (parallel/grid_shard.py): its fields are the rank's rows of the padded
    grid, flat ((L M, ...)). Each call exchanges the halo planes of xi,
    the thermal-strain scalar and the decayed history stress (summed over
    the Prony terms: 2 + d^2 values a node) once, computes the cell terms
    of the slab's window (ops/grid_elasticity.py GridElasticitySlab), and
    solves on the owned rows: the CG's action is the slab's table over
    the halo of its vector, every dot summed over the ranks, the V-cycle
    GridElastMG's rank form (solver/grid_mg.py RankGridElastMG). The
    strain at the nodes takes the displacement's halo (a node's owner
    cell reads the next plane). `last_collectives` counts the collectives
    of its last call (halo exchanges included; parallel/comm.py), and
    `last_converged` says whether its CG met its tolerance (the same on
    every rank: its norms are global). Every rank must call it
    together."""

    def __init__(self, coupling: GridMechanicsCoupling, device_mesh, rows):
        # imported here: the parallel package imports this module
        from fem_glass_tempering_tpu_torch.parallel import comm
        self._collectives = comm
        self.coupling = coupling
        self.engine = coupling.engine
        if not coupling.use_tables:
            raise ValueError("the rank form needs the block tables "
                             "(use_tables=True)")
        self.comm = device_mesh
        self.d = coupling.d
        self.cg_rtol, self.cg_max_it = coupling.cg_rtol, coupling.cg_max_it
        self.inc_rtol = coupling.inc_rtol
        self.slab = coupling.el.slab(*rows[device_mesh.rank])
        self.mg = (RankGridElastMG(coupling.mg, device_mesh, rows)
                   if coupling.mg is not None else None)
        self.last_cg_iters = self.last_collectives = None
        self.last_converged = None

    def _halo(self, x):
        return self._collectives.halo_exchange(x, self.comm)

    def _count(self) -> int:
        c = self._collectives
        return c.all_reduce_sum.count + c.all_reduce_max.count

    def _dot(self, u, v):
        return self._collectives.all_reduce_sum(
            torch.dot(u.reshape(-1), v.reshape(-1)), self.comm)

    def _moduli(self, xi_ext):
        return _effective_moduli(self.engine,
                                 self.slab.cell_avg_from_nodes(xi_ext))

    def build_precond(self, state):
        """The V-cycle frozen at `state` (GridMechanicsCoupling's), None
        without it."""
        if self.mg is None:
            return None
        xi_ext = self._halo(state.xi.reshape(self.slab.slab_grid))
        return self.mg.preconditioner(*self._moduli(xi_ext))

    def __call__(self, state, xi, scalar_th, precond=None):
        """(eps(du) (L M, d, d), du (L M, d)) on this rank's rows."""
        count0 = self._count()
        slab, d = self.slab, self.d
        shape = slab.slab_grid
        xi_g = xi.reshape(shape)
        hist = _history_stress(self.engine, state, xi_g)  # (*shape, d, d)
        ext = self._halo(torch.cat([
            xi_g[..., None], scalar_th.reshape(shape)[..., None],
            hist.reshape(shape + (d * d,))], dim=-1))
        xi_e, th_e = ext[..., 0], ext[..., 1]
        hist_e = ext[..., 2:].reshape(ext.shape[:-1] + (d, d))
        G_eff, K_eff = self._moduli(xi_e)
        th_q = slab.cell_avg_from_nodes(th_e)
        eps0_q = th_q[..., None, None] * self.coupling.I
        sigma_hist_q = slab.tensor_at_q(hist_e)
        zero = torch.zeros(slab.grid + (d,), dtype=G_eff.dtype,
                           device=G_eff.device)
        b = -slab.residual_r(zero, sigma_hist_q, eps0_q, G_eff, K_eff)
        tbl = slab.stencil_table_r(G_eff, K_eff)
        mv = lambda v: slab.matvec_table_r(tbl, self._halo(v))  # noqa: E731
        diag = slab.jacobian_diag_r(G_eff, K_eff)
        if precond is None and self.mg is not None:
            precond = self.mg.preconditioner(G_eff, K_eff, fine_table=tbl)
        x0 = (None if state.du is None
              else state.du.reshape(shape + (d,)).to(b.dtype))
        res = pcg(mv, b, x0=x0, diag=diag, precond=precond,
                  rtol=self.cg_rtol, max_it=self.cg_max_it,
                  rtol_r0=self.inc_rtol, dot=self._dot)
        self.last_cg_iters, self.last_converged = res.iters, res.converged
        eps = slab.strain_at_nodes_r(self._halo(res.x))
        self.last_collectives = self._count() - count0
        return eps.reshape(-1, d, d), res.x.reshape(-1, d)
