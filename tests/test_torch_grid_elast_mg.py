"""The vector elasticity V-cycle of the PyTorch port (solver/grid_mg.py
GridElastMG) against the JAX package's, on the CPU in f64.

Two hierarchies: a 16x16x4 thin plate (column-smoothed fine level, 50:1
cells; dense coarse inverse at the frozen instantaneous moduli) and a
12x12x12 cube (point smoothing; with the dense coarse solve, and without
it down to a smoothed 3x3x3 level). Held to JAX's:
- level dims, axes, smoother kinds, the element tables EG/EK and the
  Gershgorin stats (rtol 1e-12), the dense coarse inverse (rtol 1e-12 of
  its max);
- the column blocks, their block-Thomas solve on a seeded vector, the
  closed-form small inverse, the Gershgorin bound and the power-iteration
  bound (rtol 1e-12);
- one V-cycle apply on a seeded vector (rtol 1e-11 of max|value|);
- the MG-preconditioned elasticity CG: equal iteration counts, the
  solution at 1e-9.
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.ops.grid_elasticity import (
    GridElasticityOperator as JGEl,
)
from fem_glass_tempering_tpu.solver.grid_mg import GridElastMG as JMG
from fem_glass_tempering_tpu.solver.krylov import pcg as jpcg
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace as TFS
from fem_glass_tempering_tpu_torch.models.viscoelastic import PronyTableaus
from fem_glass_tempering_tpu_torch.ops.grid_elasticity import (
    GridElasticityOperator,
)
from fem_glass_tempering_tpu_torch.solver.grid_mg import GridElastMG
from fem_glass_tempering_tpu_torch.solver.krylov import pcg

F64 = torch.float64
TB = PronyTableaus.nielsen()
FROZEN = (float(np.sum(TB.g_n)), float(np.sum(TB.k_n)))
CASES = {
    "plate": (lambda m: m.box_mesh_3d(16, 16, 4, 1.0, 1.0, 0.01), FROZEN),
    "cube": (lambda m: m.box_mesh_3d(12, 12, 12), FROZEN),
    "cube_smooth": (lambda m: m.box_mesh_3d(12, 12, 12), None),
}
T = lambda a: torch.tensor(np.asarray(a), dtype=F64)  # noqa: E731
J = jnp.asarray


def _close(a, b, what, rtol=1e-12):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(
        a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300),
        err_msg=what)


def _pair(name):
    mk, frozen = CASES[name]
    tfs = TFS(mk(tmesh), "CG", 1, value_shape=(3, 3))
    jfs = JFS(mk(jmesh), "CG", 1, value_shape=(3, 3))
    top = GridElasticityOperator(tfs, dtype=F64, device="cpu")
    jop = JGEl(jfs, dtype=jnp.float64)
    tmg = GridElastMG(top, lambda m: GridElasticityOperator(
        TFS(m, "CG", 1, value_shape=(3, 3)), dtype=F64, device="cpu"),
        frozen_moduli=frozen)
    jmg = JMG(jop, lambda m: JGEl(JFS(m, "CG", 1, value_shape=(3, 3)),
                                  dtype=jnp.float64), frozen_moduli=frozen)
    return tmg, jmg


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return request.param, _pair(request.param)


def _moduli(op, seed):
    """Seeded positive per-cell-quadrature moduli around the Prony sums."""
    rng = np.random.default_rng(seed)
    q = op.qw1.shape[0]
    G = FROZEN[0] * (0.5 + rng.random(op.dims + (q,)))
    K = FROZEN[1] * (0.5 + rng.random(op.dims + (q,)))
    return G, K


def test_hierarchy_and_tables_match_jax(pair):
    name, (tmg, jmg) = pair
    assert [o.dims for o in tmg.ops] == [o.dims for o in jmg.ops]
    assert tmg.axes == jmg.axes
    assert tmg._smoothers == jmg._smoothers
    assert tmg._col_axis == jmg._col_axis
    assert tmg._dense_coarse == jmg._dense_coarse
    expect = {"plate": (2, "column", True), "cube": (2, "point", True),
              "cube_smooth": (3, "point", False)}[name]
    assert (len(tmg.ops), tmg._smoothers[0], tmg._dense_coarse) == expect
    for (tt, jt), (te, je) in zip(zip(tmg._tables, jmg._tables),
                                  zip(tmg._EGK, jmg._EGK)):
        for a, b in zip(tt + te, jt + je):
            _close(a, b, "element tables")
    if tmg.coarse_inv is None:
        assert jmg.coarse_inv is None
    else:
        _close(tmg.coarse_inv, jmg.coarse_inv, "dense coarse inverse")


def test_small_inverse_matches_jax_and_linalg():
    rng = np.random.default_rng(3)
    for d in (1, 2, 3):
        M = rng.standard_normal((50, d, d)) + 3.0 * np.eye(d)
        got = GridElastMG._inv_small(T(M))
        _close(got, JMG._inv_small(J(M)), f"inverse {d}x{d}")
        _close(got, torch.linalg.inv(T(M)), f"inverse {d}x{d} vs linalg",
               rtol=1e-10)


def test_smoother_data_match_jax(pair):
    """Per-cell coefficients: the column blocks and their line solve, or
    the Gershgorin bound; and the power-iteration bound of the column
    smoother."""
    name, (tmg, jmg) = pair
    top, jop = tmg.ops[0], jmg.ops[0]
    G, K = _moduli(top, 1)
    Gc, Kc = G.mean(-1), K.mean(-1)
    rng = np.random.default_rng(2)
    r = rng.standard_normal(top.grid + (3,))
    if tmg._smoothers[0] == "column":
        tD, tU = tmg._column_blocks(0, T(Gc), T(Kc))
        jD, jU = jmg._column_blocks(0, J(Gc), J(Kc))
        _close(tD, jD, "diagonal blocks")
        _close(tU, jU, "upper blocks")
        tz = tmg._column_solver(0, tD, tU)
        jz = jmg._column_solver(0, jD, jU)
        _close(tz(T(r)), jz(J(r)), "block-Thomas solve")
        tmv = top.make_matvec_g(T(G), T(K))
        jmv = jop.make_matvec_g(J(G), J(K))
        _close(GridElastMG._power_rho(tmv, tz, top.grid + (3,), F64,
                                      torch.device("cpu")),
               JMG._power_rho(jmv, jz, jop.grid + (3,), jnp.float64),
               "power-iteration bound")
    else:
        _close(tmg._rho_bound(top, tmg._tables[0], T(G.max(-1)),
                              T(K.max(-1))),
               jmg._rho_bound(jop, jmg._tables[0], J(G.max(-1)),
                              J(K.max(-1))), "Gershgorin bound")


def test_vcycle_apply_matches_jax(pair):
    name, (tmg, jmg) = pair
    G, K = _moduli(tmg.ops[0], 4)
    r = np.random.default_rng(5).standard_normal(tmg.ops[0].grid + (3,))
    got = tmg.preconditioner_g(T(G), T(K))(T(r))
    want = jmg.preconditioner_g(J(G), J(K))(J(r))
    _close(got, want, "V-cycle apply", rtol=1e-11)
    if name == "plate":
        # the cell-recompute matvecs give the same cycle
        tmg.use_tables = False
        try:
            alt = tmg.preconditioner_g(T(G), T(K))(T(r))
        finally:
            tmg.use_tables = True
        _close(alt, got, "V-cycle apply, cell recompute", rtol=1e-11)


def test_vcycle_apply_holds_no_reference_to_itself(pair):
    """Dropping the V-cycle apply frees its level matvecs (and tables) at
    once, with the cyclic collector off."""
    _, (tmg, _) = pair
    G, K = _moduli(tmg.ops[0], 4)
    r = T(np.random.default_rng(5).standard_normal(tmg.ops[0].grid + (3,)))
    gc.collect()
    gc.disable()
    try:
        pc = tmg.preconditioner_g(T(G), T(K))
        cells = dict(zip(pc.__code__.co_freevars,
                         (c.cell_contents for c in pc.__closure__)))
        mv = weakref.ref(cells["matvecs"][0])
        assert bool(torch.isfinite(pc(r)).all())
        del pc, cells
        assert mv() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("name", ["plate", "cube"])
def test_mg_cg_matches_jax(name):
    """The preconditioned elasticity solve of a thermal-strain load: equal
    CG counts, the solution at 1e-9, the fine table shared with the
    V-cycle as the coupling shares it."""
    tmg, jmg = _pair(name)
    top, jop = tmg.ops[0], jmg.ops[0]
    G, K = _moduli(top, 6)
    rng = np.random.default_rng(7)
    q = top.qw1.shape[0]
    th = -5e-5 * (1.0 + rng.random(top.dims + (q,)))
    eps0 = th[..., None, None] * np.eye(3)
    sig = np.zeros(top.dims + (q, 3, 3))

    zt = torch.zeros(top.grid + (3,), dtype=F64)
    bt = -top.residual_g(zt, T(sig), T(eps0), T(G), T(K))
    tbl = top.stencil_table_g(T(G), T(K))
    rt = pcg(lambda v: top.matvec_table_g(tbl, v), bt,
             diag=top.jacobian_diag_g(T(G), T(K)),
             precond=tmg.preconditioner_g(T(G), T(K), fine_table=tbl),
             rtol=1e-10, max_it=500)

    def jax_solve():
        b = -jop.residual_g(jnp.zeros(jop.grid + (3,)), J(sig), J(eps0),
                            J(G), J(K))
        jt = jop.stencil_table_g(J(G), J(K))
        return jpcg(lambda v: jop.matvec_table_g(jt, v), b,
                    diag=jop.jacobian_diag_g(J(G), J(K)),
                    precond=jmg.preconditioner_g(J(G), J(K), fine_table=jt),
                    rtol=1e-10, max_it=500)

    rj = jax.jit(jax_solve)()
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters) and 3 < rt.iters < 100
    _close(rt.x, rj.x, "solution", rtol=1e-9)
