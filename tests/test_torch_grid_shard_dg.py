"""The port's grid-sharded DG-1 step (solver/grid_dg.py GridDGOperator and
its slabs, DGMultigrid's grid route and its rank form, the DG route of
parallel/grid_shard.py GridShardedProblem) against the JAX package's, on
the CPU.

JAX runs in this process on its virtual devices (tests/conftest.py); the
port runs in two groups of P = 4 gloo ranks and in P = 2 ranks, spawned
once for the module (tests/torch_grid_shard_dg_ranks.py, which imports no
JAX), while the tests compute JAX's side. Mirrors tests/test_grid_dg.py
(the operator, the vertex map, the transfers, the sharded step) at P = 4.

Tolerances: the grid operator against JAX's and against the port's flat
DGStencilMatrix at rtol 1e-12 (JAX's test's); dg_to_nodes_g and prolong_g
bit for bit, restrict_g at 1e-14 (JAX's), DGMultigrid's grid apply at
1e-12 of its max. Bit for bit: a slab's Jacobian action and diagonal
against the whole grid's rows (the residual within 1e-14: its mean is
summed over the ranks), the rank form's transfers and preconditioner
apply against the whole grid's. The sharded step against JAX's
GridShardedProblem at the same P: T and Tf at max-rel 1e-11, Newton
equal, CG within max(5, 2%) (the dots sum in another order), as
tests/test_torch_grid_shard.py holds CG-1. The mechanics plate is held to
JAX's unsharded ThermoViscoProblem at JAX's own tolerances (T 1e-9 and
sigma 1e-5 of their max, tests/test_grid_dg.py:222): JAX's sharded
mechanics step takes ~40 s to compile on a CPU host, its unsharded one ~5 s.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_grid_shard_dg_ranks as R
from fem_glass_tempering_tpu import config as jcfg
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.models.problem import (
    ThermoViscoProblem as JaxProblem,
)
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.parallel.grid_shard import (
    GridShardedProblem as JaxGridSharded,
)
from fem_glass_tempering_tpu.solver.grid_dg import (
    GridDGOperator as JaxGridDG,
)
from fem_glass_tempering_tpu.solver.grid_dg import (
    dg_to_nodes_g as jax_dg_to_nodes_g,
)
from fem_glass_tempering_tpu.solver.grid_dg import (
    dg_vertex_offsets as jax_dg_vertex_offsets,
)
from fem_glass_tempering_tpu.solver.multigrid import DGMultigrid as JaxDGMG
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.ops.interpolation import build_cross_eval
from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks
from fem_glass_tempering_tpu_torch.solver.grid_dg import (
    GridDGOperator,
    dg_to_nodes_g,
    dg_vertex_offsets,
)
from fem_glass_tempering_tpu_torch.solver.multigrid import DGMultigrid

P = 4
DT = 0.1
PLATE = (8, 4, 4, 1.0, 1.0, 0.01)
# the DG multigrid's grid route: the 8x4x4 plate, its node grid padded
# with 3 ghost planes (P = 4), Chebyshev GridMG
MG_PAD0 = 3
MG_KW = dict(smoother="chebyshev", nu_pre=2, nu_post=2, coarse="auto")
JAX_P4 = ("plate", "pad2", "ghost_rank", "dryrun_mixed")


@pytest.fixture(scope="module")
def ranks():
    """The port's processes, running while the tests compute JAX's side."""
    with ThreadPoolExecutor(3) as ex:
        yield SimpleNamespace(
            main=[ex.submit(run_ranks, R.rank_body, P, "cpu", group,
                            threads=1) for group in range(len(R.GROUPS))],
            two=ex.submit(run_ranks, R.two_rank_body, 2, "cpu", threads=1))


def _jax_sharded(name, n_dev):
    dims, cfg, steps = R.CASES[name]
    sp = JaxGridSharded(jmesh.box_mesh_3d(*dims), cfg(jcfg),
                        devices=jax.devices()[:n_dev])
    st, ok, ni, ki = sp.run(sp.init_state(), steps)
    assert ok
    flat = sp.gather_state(st)
    return dict(newton=ni, cg=ki, cell_pad0=sp.cell_pad0,
                T_padded=np.asarray(st.T), Tf_padded=np.asarray(st.Tf),
                **{f: np.asarray(getattr(flat, f)) for f in R.STEP_FIELDS})


def _jax_unsharded(name):
    dims, cfg, steps = R.CASES[name]
    prob = JaxProblem(mesh=jmesh.box_mesh_3d(*dims), config=cfg(jcfg))
    prob.setup()
    st, ok, ni, ki = prob._multi_step_jit(prob.state, steps)
    assert bool(ok)
    return dict(newton=int(ni), cg=int(ki),
                **{f: np.asarray(getattr(st, f)) for f in R.STEP_FIELDS})


def _jax_heat(mesh, family="DG"):
    return JHeat(JFS(mesh, family, 1), jcfg.ModelParams(), DT,
                 dtype=jnp.float64)


def _seeded(shape, seed):
    rng = np.random.default_rng(seed)
    return (700 + 100 * rng.random(shape), 700 + 100 * rng.random(shape),
            rng.standard_normal(shape))


def _jax_grid_route():
    """JAX's GridDGOperator (residual, Jacobian action, diagonal) and
    DGMultigrid(coarse_kind="grid") on the 8x4x4 plate at the seeded
    inputs of `_seeded`."""
    mesh = jmesh.box_mesh_3d(*PLATE)
    op = JaxGridDG(_jax_heat(mesh))
    shape = op.dims + (op.nloc,)
    T, Tp, v = (jnp.asarray(a) for a in _seeded(shape, 1))
    mg = JaxDGMG(_jax_heat(mesh), lambda m: _jax_heat(m, "CG"),
                 dtype=jnp.float64, coarse_kind="grid", grid_pad0=MG_PAD0,
                 mg_kwargs=MG_KW)
    mg.freeze(None, DT)
    x_cg = jnp.asarray(np.random.default_rng(3).standard_normal(
        mg._node_grid))
    apply = jax.jit(lambda T, r: mg.preconditioner_g(
        T, DT, op.make_matvec_g(T, DT))(r))
    return dict(
        residual=np.asarray(op.residual_g(T, Tp, DT)),
        matvec=np.asarray(op.make_matvec_g(T, DT)(v)),
        diag=np.asarray(op.jacobian_diag_g(T, DT)),
        prolong=np.asarray(mg.prolong_g(x_cg)),
        restrict=np.asarray(mg.restrict_g(v)),
        restrict_state=np.asarray(mg.restrict_state_g(T)),
        apply=np.asarray(apply(T, v)), rho=mg._frozen_rho,
        levels=len(mg.cg_mg.ops), grid0=mg.cg_mg.ops[0].grid)


@pytest.fixture(scope="module")
def jax_side(ranks):
    """JAX's GridShardedProblem on the step cases (P = 4; the plate thin
    in x at P = 2), its unsharded mechanics run and its grid route on the
    8x4x4 plate; in three threads at once."""
    if len(jax.devices()) < P:
        pytest.skip(f"needs {P} virtual devices")
    with ThreadPoolExecutor(3) as ex:
        jobs = {name: ex.submit(_jax_sharded, name, P) for name in JAX_P4}
        jobs["xthin"] = ex.submit(_jax_sharded, "xthin", 2)
        jobs["mech"] = ex.submit(_jax_unsharded, "mech")
        jobs["grid_route"] = ex.submit(_jax_grid_route)
        return {k: job.result() for k, job in jobs.items()}


@pytest.fixture(scope="module")
def main(ranks):
    """Per rank: every P = 4 result of the groups."""
    groups = [job.result() for job in ranks.main]
    return [{k: v for g in groups for k, v in g[p].items()}
            for p in range(P)]


@pytest.fixture(scope="module")
def two(ranks):
    return ranks.two.result()


def _close(a, b, rtol, what):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0, err_msg=what)


def _max_rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _heat(dims=PLATE, family="DG"):
    return HeatOperator(FunctionSpace(box_mesh_3d(*dims), family, 1),
                        ModelParams(), DT, dtype=torch.float64, device="cpu",
                        interior_device_tables=False)


def _grid_mg():
    mg = DGMultigrid(_heat(), lambda m: HeatOperator(
        FunctionSpace(m, "CG", 1), ModelParams(), DT, dtype=torch.float64,
        device="cpu"), dtype=torch.float64, coarse_kind="grid",
        grid_pad0=MG_PAD0, mg_kwargs=MG_KW)
    mg.freeze(None, DT)
    return mg


# ---- the grid operator, the vertex map, the grid route (this process) ----
def test_grid_operator_matches_jax_and_flat(jax_side):
    """tests/test_grid_dg.py:44 and :62 on the port: residual, Jacobian
    action and diagonal against JAX's GridDGOperator and the port's flat
    DGStencilMatrix at rtol 1e-12."""
    op = GridDGOperator(_heat())
    shape = op.dims + (op.nloc,)
    T, Tp, v = (torch.as_tensor(a) for a in _seeded(shape, 1))
    jx = jax_side["grid_route"]
    got = dict(residual=op.residual_g(T, Tp, DT),
               matvec=op.make_matvec_g(T, DT)(v),
               diag=op.jacobian_diag_g(T, DT))
    flat = dict(residual=op.st.residual(T.reshape(-1), Tp.reshape(-1), DT),
                matvec=op.st.make_matvec(T.reshape(-1), DT)(v.reshape(-1)),
                diag=op.st.jacobian_diag(T.reshape(-1), DT))
    for k, a in got.items():
        assert a.shape == shape
        _close(a.numpy(), jx[k], 1e-12, f"{k} against JAX's")
        _close(a.numpy().reshape(-1), flat[k].numpy(), 1e-12,
               f"{k} against the flat block stencil")


def test_dg_to_nodes_bit_for_bit():
    """tests/test_grid_dg.py:81: the vertex offsets equal JAX's, and the
    slice-based DG-1 -> CG-1 map equals JAX's and the port's cross
    evaluation (dolfinx's last-cell-wins) bit for bit."""
    mesh = box_mesh_3d(4, 3, 2)
    vo, ngrid = dg_vertex_offsets(mesh)
    jvo, jngrid = jax_dg_vertex_offsets(jmesh.box_mesh_3d(4, 3, 2))
    assert vo == [tuple(o) for o in jvo] and ngrid == tuple(jngrid)
    fs = FunctionSpace(mesh, "DG", 1)
    u = np.random.default_rng(2).standard_normal(fs.n_scalar_dofs)
    got = dg_to_nodes_g(torch.as_tensor(u.reshape(4, 3, 2, 8)), vo, ngrid)
    ref = jax_dg_to_nodes_g(jnp.asarray(u.reshape(4, 3, 2, 8)), jvo, jngrid)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    ce = build_cross_eval(FunctionSpace(mesh, "CG", 1), {"T": fs},
                          device="cpu")
    assert np.array_equal(got.numpy().reshape(-1),
                          ce.eval("T", torch.as_tensor(u)).numpy())


def test_grid_route_matches_jax(jax_side):
    """DGMultigrid(coarse_kind="grid", grid_pad0=3) on the 8x4x4 plate:
    JAX's padded GridMG hierarchy and frozen rho; prolong_g bit for bit,
    restrict_g and restrict_state_g at 1e-14 (tests/test_grid_dg.py:98),
    one preconditioner_g apply on a seeded residual at 1e-12 of its max."""
    mg = _grid_mg()
    jx = jax_side["grid_route"]
    assert len(mg.cg_mg.ops) == jx["levels"]
    assert mg.cg_mg.ops[0].grid == tuple(jx["grid0"])
    assert mg._frozen_rho == pytest.approx(jx["rho"], rel=1e-12)
    shape = mg.stencil.cell_dims + (mg.stencil.nloc,)
    T, _, v = (torch.as_tensor(a) for a in _seeded(shape, 1))
    x_cg = torch.as_tensor(np.random.default_rng(3).standard_normal(
        mg._node_grid))
    assert np.array_equal(mg.prolong_g(x_cg).numpy(), jx["prolong"])
    _close(mg.restrict_g(v).numpy(), jx["restrict"], 1e-14, "restrict_g")
    _close(mg.restrict_state_g(T).numpy(), jx["restrict_state"], 1e-14,
           "restrict_state_g")
    op = GridDGOperator(_heat())
    y = mg.preconditioner_g(T, DT, op.make_matvec_g(T, DT))(v)
    assert _max_rel(y.numpy(), jx["apply"]) <= 1e-12


# ---- the slabs (this process) ------------------------------------------
@pytest.mark.parametrize("dims,split", [
    ((8, 4, 4, 1.0, 1.0, 0.01), (0, 2, 4, 6, 8)),
    ((8, 4, 4, 1.0, 1.0, 0.01), (0, 1, 8)),
    ((10, 4, 3, 1.0, 1.0, 0.01), (0, 3, 6, 9, 12)),
    ((5, 4, 3, 1.0, 1.0, 0.01), (0, 2, 4, 6, 8)),
    ((4, 4, 4, 0.01, 1.0, 1.0), (0, 2, 4))], ids=str)
def test_slab_rows_equal_the_whole_grid(dims, split):
    """A slab of cell layers [lo, hi) of the padded cell grid (ghost layers
    past cx), given its halo: the Jacobian action and the diagonal equal
    the whole grid's rows bit for bit, the residual within 1e-14 of its
    max (its mean summed over the slabs' real cells); ghost rows zero
    (the diagonal one). The x faces land on the first and the last real
    layer, wherever the split puts them."""
    op = GridDGOperator(_heat(dims))
    shape = op.dims + (op.nloc,)
    T, Tp, v = (torch.as_tensor(a) for a in _seeded(shape, 5))
    r = op.residual_g(T, Tp, DT)
    d = op.jacobian_diag_g(T, DT)
    y = op.make_matvec_g(T, DT)(v)
    G, cx = split[-1], dims[0]

    def padded(a):
        return torch.cat([a, a[-1:].expand((G - cx,) + a.shape[1:])])

    Tg, Tpg, vg = padded(T), padded(Tp), padded(v)
    real = sum(float(torch.sum(T[lo:min(hi, cx)]))
               for lo, hi in zip(split[:-1], split[1:]) if lo < cx)
    for lo, hi in zip(split[:-1], split[1:]):
        sl = op.slab(lo, hi)

        def ext(x, src, lo=lo, hi=hi):
            z = torch.zeros_like(x[:1])
            return torch.cat([z if lo == 0 else src[lo - 1:lo], x,
                              z if hi == G else src[hi:hi + 1]])
        n = sl.n_real
        rr = sl.residual_r(ext(Tg[lo:hi], Tg), Tpg[lo:hi], DT,
                           lambda s: torch.as_tensor(real, dtype=s.dtype))
        dd = sl.jacobian_diag_r(Tg[lo:hi], DT)
        yy = sl.make_matvec_r(Tg[lo:hi], DT,
                              lambda x, ext=ext: ext(x, vg))(vg[lo:hi])
        assert torch.equal(dd[:n], d[lo:lo + n])
        assert torch.equal(yy[:n], y[lo:lo + n])
        if n:
            assert float(((rr[:n] - r[lo:lo + n]).abs()
                          / r.abs().max()).max()) <= 1e-14
        assert bool((rr[n:] == 0).all() and (yy[n:] == 0).all()
                    and (dd[n:] == 1).all())


# ---- the rank forms ------------------------------------------------------
def _transfers(main, two):
    out = [(f"P4-{name}", r["transfers"][name]) for r in main
           for name in ("pad2", "ghost_rank")]
    return out + [("P2-xthin", r["transfers"]) for r in two]


def test_rank_transfers_bit_for_bit(main, two):
    """The four maps between a rank's cell layers and its node rows
    (restrict, restrict_state, the sigma cross evaluation, prolong), on
    the 10x4x3 and 5x4x3 layouts at P = 4 (cells [3p, 3p+3) against
    nodes [3p, 3p+3), and [2p, 2p+2) against [2p, 2p+2): rank 3 of the
    second holds ghosts alone) and the plate thin in x at P = 2: the
    whole grid's rows bit for bit, each one re-partition."""
    for tag, t in _transfers(main, two):
        for k in ("restrict", "restrict_state", "to_nodes", "prolong"):
            assert t[f"{k}_equal"], (tag, k)
        assert t["repartitions_to_nodes_prolong"] == 2, tag


def test_rank_preconditioner_equals_whole_grid(main, two):
    """RankDGMultigrid's apply, gathered, against DGMultigrid's
    preconditioner_g over the whole grid on the same inputs: bit for bit
    (the column solve along axis 0 on the plate thin in x included), zero
    on ghost cells. One apply makes 2 halo exchanges of cell layers and 2
    re-partitions; its CG-1 correction on these small grids is GridMG's
    dense level, replicated after one all-gather (an all-gather more a
    column solve along axis 0)."""
    for tag, t in _transfers(main, two):
        assert t["apply_equal"] and t["apply_ghost_zero"], (
            tag, t["apply_max_rel"])
        c = t["collectives"]
        assert (c["cell_halos"], c["repartitions"], c["node_halos"]) == (
            2, 2, 0), (tag, c)
        assert c["other_sums"] == (3 if tag == "P2-xthin" else 1), (tag, c)


# ---- the sharded step ----------------------------------------------------
@pytest.mark.parametrize("name", ["plate", "pad2", "ghost_rank"])
def test_sharded_step_matches_jax(main, jax_side, name):
    """P = 4 port ranks against JAX's GridShardedProblem on 4 virtual
    devices (tests/test_grid_dg.py `_run_cfg`): T and Tf at max-rel 1e-11,
    Newton equal, CG within max(5, 2%); the ranks in lockstep."""
    jx = jax_side[name]
    got = main[0][name]
    assert got["cell_pad0"] == jx["cell_pad0"] == {
        "plate": 0, "pad2": 2, "ghost_rank": 3}[name]
    for r in main:
        g = r[name]
        assert g["ok"] and g["newton"] == jx["newton"]
        assert abs(g["cg"] - jx["cg"]) <= max(5, 0.02 * jx["cg"])
        for f in ("T", "Tf"):
            assert _max_rel(g[f], jx[f]) <= 1e-11, (name, f)
        assert (g["newton"], g["cg"]) == (got["newton"], got["cg"])
        assert all(np.array_equal(g[f], got[f]) for f in R.STEP_FIELDS)


@pytest.mark.parametrize("name", ["plate", "pad2", "ghost_rank"])
def test_rank_rows_are_jax_shards(main, jax_side, name):
    """Rank p's cell layers are JAX's shard p of the padded cell grid,
    the ghost layers (edge-padded from layer cx - 1, on another rank for
    5x4x3) included, at max-rel 1e-11."""
    jx = jax_side[name]
    for p, r in enumerate(main):
        lo, hi = r[name]["cell_rows"][p]
        for f in ("T", "Tf"):
            want = jx[f"{f}_padded"][lo:hi].reshape(-1)
            assert _max_rel(r[name][f"rank_{f}"], want) <= 1e-11, (p, f)


def test_mixed_precision_matches_jax(main, jax_side):
    """The dry run's "gspmd-dg" config in mixed precision (f64 Newton
    over the f32 twins of the grid operator and DGMultigrid) at P = 4
    against JAX's: T and Tf at max-rel 1e-11, Newton equal, CG within
    max(5, 2%)."""
    jx = jax_side["dryrun_mixed"]
    for r in main:
        g = r["dryrun_mixed"]
        assert g["ok"] and g["newton"] == jx["newton"]
        assert abs(g["cg"] - jx["cg"]) <= max(5, 0.02 * jx["cg"])
        for f in ("T", "Tf"):
            assert _max_rel(g[f], jx[f]) <= 1e-11, f


def test_mechanics_matches_jax(main, jax_side):
    """tests/test_grid_dg.py:222 at P = 4 (equilibrium mechanics, the
    cell-grid xi and thermal scalar through the vertex map into the node
    grid's elasticity solve) against JAX's unsharded ThermoViscoProblem:
    T within 1e-9 and sigma within 1e-5 of their max, Newton equal, CG
    within max(5, 2%); every elasticity CG converged."""
    jx = jax_side["mech"]
    for r in main:
        g = r["mech"]
        assert g["ok"] and all(g["mech_converged"])
        assert len(g["mech_iters"]) == R.CASES["mech"][2]
        assert g["newton"] == jx["newton"]
        assert abs(g["cg"] - jx["cg"]) <= max(5, 0.02 * jx["cg"])
        assert _max_rel(g["T"], jx["T"]) <= 1e-9
        assert _max_rel(g["sigma"], jx["sigma"]) <= 1e-5


def test_column_smoother_along_x(two, jax_side):
    """A plate thin in x (cells 0.0025 x 0.25 x 0.25) at P = 2: the column
    smoother runs along axis 0, across the ranks (on all-gathered cell
    layers), as JAX's does on 2 devices: T and Tf at max-rel 1e-11, Newton
    equal, CG within max(5, 2%)."""
    jx = jax_side["xthin"]
    for r in two:
        g = r["xthin"]
        assert g["smoother"] == ("column", 0)
        assert g["ok"] and g["newton"] == jx["newton"]
        assert abs(g["cg"] - jx["cg"]) <= max(5, 0.02 * jx["cg"])
        for f in ("T", "Tf"):
            assert _max_rel(g[f], jx[f]) <= 1e-11, f
