"""Equilibrium mechanics on the port's grid-sharded CG-1 step
(parallel/grid_shard.py with mechanics="equilibrium"; the padded
GridElasticityOperator and its slabs, GridElastMG's padding and its rank
form, GridMechanicsCoupling's grid-shaped and rank forms) against the JAX
package's, on the CPU in f64 (the dry run's config in f32, as JAX runs it).

JAX runs in this process on its virtual devices (tests/conftest.py); the
port runs in P = 4 and P = 2 gloo ranks and in one more process for its
unsharded run and the world-size-1 problem, spawned once for the module
(tests/torch_grid_shard_mech_ranks.py, which imports no JAX), while the
tests compute JAX's side. Mirrors tests/test_grid_elasticity.py:75-111,
:126 and :217 and the dry run's "gspmd-mechanics" strategy.

Tolerances: the padded operator and one GridElastMG apply against JAX's
at rtol 1e-12. Bit for bit: a slab's table, diagonal, table action,
residual and nodal strain against the whole grid's rows (each is
the whole grid's computation over a window of cells; a row of a contraction
over another batch may round otherwise on other hardware), and the rank
form of GridElastMG against the unsharded cycle with the point smoother,
and where the line smoother runs along axis 0 (replicated). With the line
smoother along axis 2 the rank form lies within 1e-10 of the unsharded
cycle's max: its power iteration's norms sum each rank's squares in
another order (measured ~1e-12). The sharded step at P = 4 against JAX's:
T and Tf at rtol 1e-11, sigma, total strain and du within 1e-6 of their
max (JAX's own bound against its flat path), Newton equal, heat and
elasticity CG within max(5, 2%). Against the port's unsharded run: T at
rtol 1e-10, sigma within 1e-6 of its max; over one rank the unsharded
run's counts and bits.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_grid_shard_mech_ranks as M
from fem_glass_tempering_tpu import config as jcfg
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.models.mechanics import (
    GridMechanicsCoupling as JCoupling,
)
from fem_glass_tempering_tpu.models.viscoelastic import (
    ViscoelasticEngine as JEngine,
)
from fem_glass_tempering_tpu.ops.grid_elasticity import (
    GridElasticityOperator as JGridElast,
)
from fem_glass_tempering_tpu.parallel.grid_shard import (
    GridShardedProblem as JaxGridSharded,
)
from fem_glass_tempering_tpu.solver.grid_mg import GridElastMG as JElastMG
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
from fem_glass_tempering_tpu_torch.models.mechanics import (
    GridMechanicsCoupling,
)
from fem_glass_tempering_tpu_torch.models.viscoelastic import (
    ViscoelasticEngine,
)
from fem_glass_tempering_tpu_torch.ops.grid_elasticity import (
    GridElasticityOperator,
)
from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks
from fem_glass_tempering_tpu_torch.solver.grid_mg import GridElastMG

P = 4
F64 = torch.float64
# the dry run's "gspmd-mechanics" counts (Newton, CG) on 8 TPU chips
# (MULTICHIP_r05.json): the heat solve's, which no padding moves
DRYRUN_COUNTS = (14, 14)


def _jax_plate_cfg():
    return jcfg.RunConfig(
        fe=jcfg.FEConfig(T_family="CG", T_degree=1),
        time=jcfg.TimeConfig(0.0, 0.2, 0.1),
        solver=jcfg.SolverConfig(linear_operator="stencil"),
        output=jcfg.OutputConfig(write_every=0, formats=()),
        mechanics="equilibrium", physics_mode="corrected",
        xi_formula="trapezoid")


def _jax_plate_case(devs):
    """JAX's GridShardedProblem on the plate case; each step's elasticity
    CG count logged through jax.debug.callback from a wrapper around its
    coupling (the step rebuilt around it; the JAX package is not
    edited)."""
    dims, _, steps = M.CASES["plate"]
    sp = JaxGridSharded(jmesh.box_mesh_3d(*dims, 1.0, 1.0, 0.01),
                        _jax_plate_cfg(), devices=devs)
    inner, log = sp.mech, []

    class Logged:
        def build_precond(self, state):
            return inner.build_precond(state)

        def __call__(self, *args, **kw):
            out = inner(*args, **kw)
            jax.debug.callback(lambda it: log.append(int(it)),
                               inner.last_cg_iters)
            return out
    sp.mech = Logged()
    sp._build_step()
    st, ok, ni, ki = sp.run(sp.init_state(), steps)
    assert ok
    flat = sp.gather_state(st)
    return dict(newton=ni, cg=ki, mech=list(log),
                T_padded=np.asarray(st.T).reshape(-1),
                du_padded=np.asarray(st.du).reshape(-1, 3),
                **{f: np.asarray(getattr(flat, f)) for f in M.STEP_FIELDS})


def _jax_elastic_op(mesh, pad=0):
    return JGridElast(JFS(mesh, "CG", 1, value_shape=(3, 3)),
                      dtype=jnp.float64, pad_axis0=pad)


def _jax_mg_apply(name):
    """JAX's GridElastMG over the padded grid of case `name` at P = 4, one
    apply to the case's inputs (tests/torch_grid_shard_mech_ranks.py)."""
    pad0 = M.mg_pad(name, P)
    _, G, K, r = M.mg_build(name, pad0)
    dims, lengths, frozen = M.MG_CASES[name]
    jmg = JElastMG(_jax_elastic_op(jmesh.box_mesh_3d(*dims, *lengths), pad0),
                   _jax_elastic_op, frozen_moduli=frozen)
    apply = jax.jit(lambda G, K, r: jmg.preconditioner_g(G, K)(r))
    x = apply(*(jnp.asarray(a.numpy()) for a in (G, K, r)))
    return dict(x=np.asarray(x), dims=[op.dims for op in jmg.ops],
                dense=jmg.coarse_inv is not None, pad0=jmg.pad0,
                phys0=jmg.phys0)


# (c)'s cases: a dense coarse level (the trapezoid xi's frozen moduli) and
# a smoothed one (the reference xi's)
JAX_MG = ("column_dense", "point")


@pytest.fixture(scope="module", autouse=True)
def jobs():
    """What takes long, started together as the module starts: the port's
    processes, and JAX's compiled cases in threads; the tests run
    meanwhile and wait for what they read."""
    devs = jax.devices()
    assert len(devs) >= P, f"needs {P} virtual devices"
    with ThreadPoolExecutor(3 + 1 + len(JAX_MG)) as ex:
        yield SimpleNamespace(
            main=ex.submit(run_ranks, M.rank_body, P, "cpu", threads=1),
            two=ex.submit(run_ranks, M.two_rank_body, 2, "cpu", threads=1),
            ref=ex.submit(run_ranks, M.reference_body, 1, "cpu",
                          threads=1),
            jax_plate=ex.submit(_jax_plate_case, devs[:P]),
            jax_mg={name: ex.submit(_jax_mg_apply, name)
                    for name in JAX_MG})


@pytest.fixture(scope="module")
def jax_side(jobs):
    return jobs.jax_plate.result()


@pytest.fixture(scope="module")
def main(jobs):
    return jobs.main.result()


@pytest.fixture(scope="module")
def two(jobs):
    return jobs.two.result()


@pytest.fixture(scope="module")
def ref(jobs):
    return jobs.ref.result()[0]


def _close(a, b, rtol, what):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0, err_msg=what)


def _within(a, b, frac, what):
    """|a - b| <= frac max|b| everywhere."""
    scale = max(float(np.abs(b).max()), 1e-300)
    assert float(np.abs(a - b).max()) <= frac * scale, what


# ---- (a) the padded operator against JAX's ---------------------------------
def _ops(pad0, dims=(5, 4, 3), lengths=(1.0, 0.8, 0.05)):
    mesh = box_mesh_3d(*dims, *lengths)
    op = GridElasticityOperator(FunctionSpace(mesh, "CG", 1,
                                              value_shape=(3, 3)),
                                dtype=F64, pad_axis0=pad0, device="cpu")
    jmesh_ = jmesh.box_mesh_3d(*dims, *lengths)
    jop = JGridElast(JFS(jmesh_, "CG", 1, value_shape=(3, 3)),
                     dtype=jnp.float64, pad_axis0=pad0)
    return op, jop


def _op_inputs(op, seed=0):
    """Seeded cell coefficients, history stress, thermal strain and a
    displacement over the padded grid (the ghost planes random too)."""
    rng = np.random.default_rng(seed)
    q = op.qw1.shape[0]
    G = 1.0 + rng.random(op.dims + (q,))
    K = 2.0 + rng.random(op.dims + (q,))
    sh = rng.standard_normal(op.dims + (q, 3, 3))
    sh = 0.5 * (sh + np.swapaxes(sh, -1, -2))
    e0 = rng.standard_normal(op.dims + (q,))[..., None, None] * np.eye(3)
    u = rng.standard_normal(op.grid + (3,))
    return G, K, sh, e0, u


@pytest.mark.parametrize("pad0", [0, 2, 3])
def test_padded_operator_matches_jax(pad0):
    """tests/test_grid_elasticity.py:126 and :217 on the port: pin mask
    equal to JAX's, cell and table actions, diagonal, residual and nodal
    strain at rtol 1e-12; the ghost planes are identity rows (a zero
    residual, zero strain), the physical rows the unpadded operator's bit
    for bit."""
    op, jop = _ops(pad0)
    assert op.grid == tuple(jop.grid) and op.base_grid == jop.base_grid
    assert np.array_equal(op.np_pin_mask, np.asarray(jop.pin_mask_g))
    G, K, sh, e0, u = _op_inputs(op)
    t, j = torch.as_tensor, jnp.asarray
    B = op.stencil_table_g(t(G), t(K))
    got = dict(
        cell=op.make_matvec_g(t(G), t(K))(t(u)),
        table=op.matvec_table_g(B, t(u)),
        diag=op.jacobian_diag_g(t(G), t(K)),
        residual=op.residual_g(t(u), t(sh), t(e0), t(G), t(K)),
        strain=op.strain_at_nodes(t(u)))
    jB = jop.stencil_table_g(j(G), j(K))
    want = dict(
        cell=jop.make_matvec_g(j(G), j(K))(j(u)),
        table=jop.matvec_table_g(jB, j(u)),
        diag=jop.jacobian_diag_g(j(G), j(K)),
        residual=jop.residual_g(j(u), j(sh), j(e0), j(G), j(K)),
        strain=jop.strain_at_nodes(j(u)))
    for k in got:
        a, b = got[k].numpy(), np.asarray(want[k])
        np.testing.assert_allclose(a, b, rtol=1e-12,
                                   atol=1e-12 * float(np.abs(b).max()),
                                   err_msg=k)
    if pad0:
        for k in ("cell", "table"):
            assert torch.equal(got[k][-pad0:], t(u)[-pad0:]), k
        assert bool((got["residual"][-pad0:] == 0.0).all())
        assert bool((got["diag"][-pad0:] == 1.0).all())
        assert bool((got["strain"][-pad0:] == 0.0).all())
        op0, _ = _ops(0)
        u0 = t(u)[:op0.grid[0]]
        assert torch.equal(got["table"][:-pad0], op0.matvec_table_g(
            op0.stencil_table_g(t(G), t(K)), u0))
        assert torch.equal(got["strain"][:-pad0], op0.strain_at_nodes(u0))


# ---- (b) a slab's rows -------------------------------------------------------
@pytest.mark.parametrize("split", [(0, 3, 6, 9), (0, 2, 4, 6, 9), (0, 1, 9),
                                   (0, 8, 9), (0, 6, 9)], ids=str)
def test_slab_rows_equal_the_whole_grid(split):
    """A slab of planes [lo, hi) of the padded grid (5x4x3 cells, 3 ghost
    planes; [6, 9) holds only ghosts), given its halo and its window's
    cells, reproduces the whole grid's rows bit for bit: the block table,
    the table action, the diagonal, the residual, the nodal
    strain, and the V-cycle's line blocks and Gershgorin ratios."""
    op, _ = _ops(3)
    G, K, sh, e0, u = (torch.as_tensor(a) for a in _op_inputs(op, seed=1))
    G0 = op.grid[0]
    mg = GridElastMG(op, M.elastic_op, frozen_moduli=None)
    whole = dict(
        table=op.stencil_table_g(G, K),
        diag=op.jacobian_diag_g(G, K),
        residual=op.residual_g(u, sh, e0, G, K),
        strain=op.strain_at_nodes(u))
    whole["action"] = op.matvec_table_g(whole["table"], u)
    Gc, Kc = G.mean(-1), K.mean(-1)
    Dg, Ug = mg._column_blocks(0, Gc, Kc)
    ratio = mg._rho_ratio(op, mg._tables[0], G.amax(-1), K.amax(-1))
    for lo, hi in zip(split[:-1], split[1:]):
        sl = op.slab(lo, hi)
        (c0, c1), (a, b) = sl._cells0, sl.own_cells
        assert sl.cell_grid == (c1 - c0,) + op.dims[1:]
        assert c0 <= a <= b <= c1

        def ext(x, lo=lo, hi=hi):
            z = torch.zeros_like(x[:1])
            return torch.cat([z if lo == 0 else x[lo - 1:lo], x[lo:hi],
                              z if hi == G0 else x[hi:hi + 1]])
        w = lambda x: x[c0:c1]  # noqa: E731
        B_r = sl.stencil_table_r(w(G), w(K))
        got = dict(
            table=B_r, action=sl.matvec_table_r(B_r, ext(u)),
            diag=sl.jacobian_diag_r(w(G), w(K)),
            residual=sl.residual_r(ext(u), w(sh), w(e0), w(G), w(K)),
            strain=sl.strain_at_nodes_r(ext(u)))
        for k, v in got.items():
            assert torch.equal(v, whole[k][lo:hi]), (k, lo, hi)
        Dr, Ur = mg._column_blocks(0, w(Gc), w(Kc), op=sl)
        assert torch.equal(Dr[1:-1], Dg[lo:hi])
        assert torch.equal(Ur[1:-1], Ug[lo:hi])
        rr = mg._rho_ratio(sl, mg._tables[0], w(G).amax(-1), w(K).amax(-1))
        assert torch.equal(rr[1:-1], ratio[lo:hi])


# ---- (c) GridElastMG with level-0 padding against JAX's ---------------------
@pytest.mark.parametrize("name", JAX_MG)
def test_padded_elast_mg_matches_jax(jobs, name):
    """One apply of GridElastMG over a fine grid with 3 ghost planes (the
    16x16x6 plate and the 12x12x12 cube at P = 4) against JAX's, with
    JAX's hierarchy, within 1e-12 of its max: the dense coarse level
    (frozen moduli, as the trapezoid xi gives them; line smoothing above
    it) and the smoothed one (none, the reference xi's; point smoothing
    on three levels). (A hierarchy of five line-smoothed levels lies
    within ~2e-11 of JAX's, padded or not: each level's power-iteration
    bound rounds otherwise in XLA; my CPU run.)"""
    jx = jobs.jax_mg[name].result()
    pad0 = M.mg_pad(name, P)
    mg, G, K, r = M.mg_build(name, pad0)
    assert [op.dims for op in mg.ops] == jx["dims"]
    assert (mg.coarse_inv is not None) == jx["dense"]
    assert jx["dense"] == (M.MG_CASES[name][2] is not None)
    assert (mg.pad0, mg.phys0) == (jx["pad0"], jx["phys0"]) and pad0 == 3
    _within(mg.preconditioner_g(G, K)(r).numpy(), jx["x"], 1e-12, name)


# ---- (d) the rank form against the unsharded cycle --------------------------
@pytest.mark.parametrize("P_", [4, 2], ids=["P4", "P2"])
@pytest.mark.parametrize("name", list(M.MG_CASES))
def test_rank_elast_mg_matches_unsharded(main, two, name, P_):
    """GridElastMG's rank form, gathered on every rank, against the
    unsharded cycle on the same padded grid: bit for bit with the point
    smoother and where the levels run replicated (the line smoother along
    axis 0 of the plate thin along axis 0), within 1e-10 of the max with
    the line smoother along axis 2."""
    runs = main if P_ == 4 else two
    got = [r[f"mg_{name}"] for r in runs]
    g0 = got[0]
    x = g0["unsharded"]
    for g in got[1:]:
        assert np.array_equal(g["x"], g0["x"])
    if name == "thin_axis0":
        assert g0["smoothers"][0] == "column" and not any(g0["sharded"])
    else:
        assert g0["sharded"][0]
    if g0["smoothers"][0] == "point" or not any(g0["sharded"]):
        assert np.array_equal(g0["x"], x), name
    else:
        _within(g0["x"], x, 1e-10, name)
    if name == "column" and P_ == 2:
        # four sharded levels, axis 0 halved twice on the ranks' slabs
        assert g0["sharded"] == [True, True, True, True, False]


# ---- (e)-(g) the sharded step ---------------------------------------------
def test_sharded_mechanics_matches_jax(main, jax_side):
    """tests/test_grid_elasticity.py:75-111's plate at P = 4 (3 ghost
    planes: rank 3 holds only ghosts) against JAX's GridShardedProblem on
    4 virtual devices: T and Tf at rtol 1e-11; sigma, total strain and du
    within 1e-6 of their max; Newton equal; heat and elasticity CG within
    max(5, 2%)."""
    jx = jax_side
    for r in main:
        got = r["plate"]
        assert got["ok"] and got["newton"] == jx["newton"]
        assert abs(got["cg"] - jx["cg"]) <= max(5, 0.02 * jx["cg"])
        for a, b in zip(got["mech"], jx["mech"]):
            assert abs(a - b) <= max(5, 0.02 * b), (got["mech"], jx["mech"])
        for f in ("T", "Tf"):
            _close(got[f], jx[f], 1e-11, f)
        for f in ("sigma", "total_strain", "du"):
            _within(got[f], jx[f], 1e-6, f)


def test_rank_rows_are_jax_shards(main, jax_side):
    """Rank p's rows of T and du are JAX's shard p of the padded grid
    (ghost planes included): T at rtol 1e-11, du within 1e-6 of its
    max."""
    jx = jax_side
    M_ = jx["T_padded"].size // main[0]["plate"]["rows"][-1][1]
    for p, r in enumerate(main):
        lo, hi = r["plate"]["rows"][p]
        _close(r["plate"]["rank_T"], jx["T_padded"][lo * M_:hi * M_],
               1e-11, f"rank {p} T")
        _within(r["plate"]["rank_du"].reshape(-1, 3),
                jx["du_padded"][lo * M_:hi * M_], 1e-6, f"rank {p} du")


def test_dryrun_gspmd_mechanics_counts_equal_jax(main):
    """The dry run's "gspmd-mechanics" strategy (12x6x4, f32, 2 steps,
    reference xi: the V-cycle's coarsest level smoothed) at P = 4: Newton
    and CG equal to JAX's, T, sigma and du finite, the ranks in
    lockstep."""
    for r in main:
        got = r["dryrun"]
        assert got["ok"] and (got["newton"], got["cg"]) == DRYRUN_COUNTS
        assert all(np.isfinite(got[f]).all() for f in M.STEP_FIELDS)
        assert got["mech"] == main[0]["dryrun"]["mech"]
        assert np.array_equal(got["sigma"], main[0]["dryrun"]["sigma"])
    T = main[0]["dryrun"]["T"]
    mp = ModelParams()
    assert mp.T_ambient < T.min() <= T.max() < mp.T_0


@pytest.mark.parametrize("P_", [4, 2], ids=["P4", "P2"])
def test_sharded_mechanics_matches_unsharded(main, two, ref, P_):
    """The ranks against the port's unsharded ThermoViscoProblem: T and Tf
    at rtol 1e-10, sigma, total strain and du within 1e-6 of their max,
    heat counts equal; the ranks in lockstep (equal counts, equal
    bits)."""
    runs = main if P_ == 4 else two
    un = ref["unsharded"]
    got = runs[0]["plate"]
    assert (got["newton"], got["cg"]) == (un["newton"], un["cg"])
    for f in ("T", "Tf"):
        _close(got[f], un[f], 1e-10, f)
    for f in ("sigma", "total_strain", "du"):
        _within(got[f], un[f], 1e-6, f)
    for r in runs[1:]:
        assert (r["plate"]["newton"], r["plate"]["cg"],
                r["plate"]["mech"]) == (got["newton"], got["cg"],
                                        got["mech"])
        assert all(np.array_equal(r["plate"][f], got[f])
                   for f in M.STEP_FIELDS)


def test_world_size_one_equals_unsharded(ref):
    """Over one rank (no ghost plane: the V-cycle's dense level is the
    unsharded run's) the unsharded run's counts and bits."""
    one, un = ref["world_size_1"], ref["unsharded"]
    assert one["ok"] and (one["newton"], one["cg"], sum(one["mech"])) == (
        un["newton"], un["cg"], un["mech"])
    for f in M.STEP_FIELDS:
        assert np.array_equal(one[f], un[f]), f


# ---- the coupling's forms ------------------------------------------------
def _engines(dims, lengths=(1.0, 1.0, 0.01)):
    xi_formula = "trapezoid"
    mesh = box_mesh_3d(*dims, *lengths)
    fs_T, fs_S = (FunctionSpace(mesh, "CG", 1),
                  FunctionSpace(mesh, "CG", 1, value_shape=(3, 3)))
    eng = ViscoelasticEngine(fs_T, fs_S, ModelParams(), 0.1, dtype=F64,
                             physics_mode="corrected",
                             xi_formula=xi_formula, device="cpu")
    jm = jmesh.box_mesh_3d(*dims, *lengths)
    jfs_T, jfs_S = JFS(jm, "CG", 1), JFS(jm, "CG", 1, value_shape=(3, 3))
    jeng = JEngine(jfs_T, jfs_S, jcfg.ModelParams(), 0.1,
                   physics_mode="corrected", xi_formula=xi_formula,
                   dtype=jnp.float64)
    return eng, fs_S, jeng, jfs_S, fs_T.n_scalar_dofs


def _coupling_inputs(n, seed):
    rng = np.random.default_rng(seed)
    xi = 0.05 + 0.01 * rng.random(n)
    th = -5e-5 * (1.0 + 0.3 * rng.random(n))
    return xi, th


def test_jacobi_preconditioner_matches_jax():
    """GridMechanicsCoupling(preconditioner="jacobi"): no V-cycle, a
    Jacobi-CG solve (JAX models/mechanics.py:141-147, :168); on a 4x3x2
    unit box against JAX's: du within 1e-10 of its max, the CG count
    equal."""
    eng, fs_S, jeng, jfs_S, n = _engines((4, 3, 2), (1.0, 1.0, 1.0))
    mech = GridMechanicsCoupling(fs_S, eng, dtype=F64, cg_rtol=1e-10,
                                 preconditioner="jacobi")
    jmech = JCoupling(jfs_S, jeng, dtype=jnp.float64, cg_rtol=1e-10,
                      preconditioner="jacobi")
    assert mech.mg is None and jmech.mg is None
    assert mech.build_precond(eng.init_state()) is None
    xi, th = _coupling_inputs(n, 4)
    _, du = mech(eng.init_state(), torch.as_tensor(xi), torch.as_tensor(th))
    call = jax.jit(lambda st, xi, th: jmech(st, xi, th)[1:] + (
        jmech.last_cg_iters,))
    jdu, jit_ = call(jeng.init_state(), jnp.asarray(xi), jnp.asarray(th))
    _within(du.numpy(), np.asarray(jdu), 1e-10, "du")
    assert mech.last_cg_iters == int(jit_) > 10


def test_grid_shaped_padded_coupling():
    """GridMechanicsCoupling(grid_shaped=True) takes and returns the
    (padded) grid's fields: unpadded, the flat coupling's bits; with 3
    ghost planes (the sharded step's layout on one device; its V-cycle
    smooths the padded level where the unpadded one solves it densely)
    eps and du within 1e-7 of the flat solve's max on the physical rows
    (both CG solves to rtol 1e-10), zero strain on the ghost planes."""
    eng, fs_S, *_, n = _engines((8, 6, 4))
    xi, th = (torch.as_tensor(a) for a in _coupling_inputs(n, 5))
    flat = GridMechanicsCoupling(fs_S, eng, dtype=F64, cg_rtol=1e-10)
    st = eng.init_state()
    eps_f, du_f = flat(st, xi, th)
    for pad0 in (0, 3):
        mech = GridMechanicsCoupling(fs_S, eng, dtype=F64, cg_rtol=1e-10,
                                     pad_axis0=pad0, grid_shaped=True)
        el = mech.el
        gx = el.base_grid[0]

        def grid(a, pad0=pad0):
            g = a.reshape(el.base_grid + tuple(a.shape[1:]))
            return torch.cat([g, g[-1:].expand((pad0,) + g.shape[1:])])
        gst = st._replace(**{f: grid(getattr(st, f)) for f in (
            "s_partial", "sigma_partial", "s_tilde", "sigma_tilde", "du")})
        eps, du = mech(gst, grid(xi), grid(th))
        assert du.shape == el.grid + (3,) and eps.shape == el.grid + (3, 3)
        if pad0 == 0:
            assert torch.equal(eps.reshape(-1, 3, 3), eps_f)
            assert torch.equal(du.reshape(-1, 3), du_f)
            assert mech.last_cg_iters == flat.last_cg_iters
        else:
            assert bool((eps[gx:] == 0).all())
            _within(eps[:gx].reshape(-1, 3, 3).numpy(), eps_f.numpy(), 1e-7,
                    "eps")
            _within(du[:gx].reshape(-1, 3).numpy(), du_f.numpy(), 1e-7,
                    "du")
