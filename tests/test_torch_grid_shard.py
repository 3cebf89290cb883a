"""The port's grid-sharded step (parallel/grid_shard.py GridShardedProblem,
the padded GridHeatOperator and its slabs, GridMG and its rank form,
K2's halo form) against the JAX package's, on the CPU.

JAX runs in this process on its virtual devices (tests/conftest.py); the
port runs in P = 4 gloo ranks and in P = 2 ranks spawned once for the
module (tests/torch_grid_shard_ranks.py, which imports no JAX), and its
unsharded runs and a world-size-1 GridShardedProblem in one more process,
while the tests compute JAX's side. Mirrors tests/test_grid_ops.py:131-191
and tests/test_grid_mg.py:87-149 at P = 4, and the dry run's "gspmd-grid"
strategy; a short solve() with the sharded writer and a checkpoint at
P = 4 (tests/test_torch_sharded_io.py holds the output to JAX's).

Tolerances: gathered T and Tf against JAX's GridShardedProblem at rtol
1e-11 (Newton equal, CG within max(5, 2%): the dots' sums run in another
order), against the port's unsharded ThermoViscoProblem at 1e-10 (sigma
1e-6 of its max), as JAX's tests hold its own. GridMG against JAX's at
rtol 1e-12. Bit for bit: a slab's tables, diagonal and Jacobian action
against the whole grid's rows, K2's halo form against the full-grid form,
the rank form of GridMG against the unsharded cycle. A slab's residual
rows lie within 1e-14 (max-rel) of the whole grid's: its boundary-flux
einsums run over the slab's cells, and torch may contract a three-operand
einsum in another order for another batch.
"""

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_grid_shard_ranks as R
from fem_glass_tempering_tpu import config as jcfg
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.ops.grid import GridHeatOperator as JGrid
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.parallel.grid_shard import (
    GridShardedProblem as JaxGridSharded,
)
from fem_glass_tempering_tpu.solver.grid_mg import GridMG as JaxGridMG
from fem_glass_tempering_tpu_torch.config import (
    FEConfig,
    ModelParams,
    RunConfig,
)
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
from fem_glass_tempering_tpu_torch.models.viscoelastic import ViscoState
from fem_glass_tempering_tpu_torch.ops.grid import GridHeatOperator
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks
from fem_glass_tempering_tpu_torch.parallel.grid_shard import (
    GridShardedProblem,
)

P = 4
JAX_CASES = ("grid_ops", "grid_mg", "dryrun")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's processes, running while the tests compute JAX's side."""
    work = str(tmp_path_factory.mktemp("grid_shard"))
    with ThreadPoolExecutor(4) as ex:
        yield SimpleNamespace(
            main=[ex.submit(run_ranks, R.rank_body, P, "cpu", group, work,
                            threads=1) for group in range(len(R.GROUPS))],
            two=ex.submit(run_ranks, R.two_rank_body, 2, "cpu", threads=1),
            ref=ex.submit(run_ranks, R.reference_body, 1, "cpu", work,
                          threads=1))


def _jax_cfg(name):
    """The JAX twin of R.CASES[name]'s config."""
    c = R.CASES[name][1]()
    s = c.solver
    return jcfg.RunConfig(
        fe=jcfg.FEConfig(T_family="CG", T_degree=1),
        time=jcfg.TimeConfig(c.time.t_start, c.time.t_end, c.time.dt),
        solver=jcfg.SolverConfig(
            newton_rtol=s.newton_rtol, newton_atol=s.newton_atol,
            cg_rtol=s.cg_rtol, cg_max_it=s.cg_max_it,
            linear_operator=s.linear_operator,
            preconditioner=s.preconditioner, mg_smoother=s.mg_smoother,
            newton_inc_forcing=s.newton_inc_forcing, cg_dtype=s.cg_dtype),
        output=jcfg.OutputConfig(write_every=0, formats=()),
        dtype=c.dtype)


def _jax_heat(mesh, dtype=jnp.float64):
    return JHeat(JFS(mesh, "CG", 1), jcfg.ModelParams(), R.MG_DT,
                 dtype=dtype)


def _jax_step_case(name, devs):
    dims, _, steps = R.CASES[name]
    sp = JaxGridSharded(jmesh.box_mesh_3d(*dims, 1.0, 1.0, 0.01),
                        _jax_cfg(name), devices=devs)
    st, ok, ni, ki = sp.run(sp.init_state(), steps)
    assert ok
    flat = sp.gather_state(st)
    return dict(newton=ni, cg=ki, T_padded=np.asarray(st.T),
                Tf_padded=np.asarray(st.Tf),
                **{f: np.asarray(getattr(flat, f)) for f in R.STEP_FIELDS})


def _jax_mg_apply(coarse):
    pad0 = (-(R.MG_DIMS[0] + 1)) % P
    T, r = R.mg_inputs(pad0)
    fine = JGrid(_jax_heat(jmesh.box_mesh_3d(*R.MG_DIMS, 1.0, 1.0, 0.01)),
                 pad_axis0=pad0, allow_const=False)
    mg = JaxGridMG(fine, _jax_heat, smoother="chebyshev", coarse=coarse)
    mg.freeze_rhos(R.MG_DT)
    apply = jax.jit(lambda T, r: mg.preconditioner_g(
        mg.linearization_states_g(T), R.MG_DT)(r))
    return dict(x=np.asarray(apply(jnp.asarray(T), jnp.asarray(r))),
                levels=len(mg.ops), dense=mg.coarse_inv is not None)


@pytest.fixture(scope="module")
def jax_side(ranks):
    """JAX's GridShardedProblem at P on every step case (counts, gathered
    fields, the padded T), and JAX's GridMG apply at the P = 4 layout;
    compiled in three threads at once."""
    devs = jax.devices()
    if len(devs) < P:
        pytest.skip(f"needs {P} virtual devices")
    with ThreadPoolExecutor(3) as ex:
        jobs = {f"mg_{c}": ex.submit(_jax_mg_apply, c)
                for c in ("smooth", "auto")}
        jobs.update({name: ex.submit(_jax_step_case, name, devs[:P])
                     for name in JAX_CASES})
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


@pytest.fixture(scope="module")
def ref(ranks):
    return ranks.ref.result()[0]


def _close(a, b, rtol, what):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0, err_msg=what)


# ---- the padded operator and its slabs (this process) -------------------
def _op_5x4x3():
    mesh = box_mesh_3d(5, 4, 3, 1.0, 1.0, 0.01)
    op = HeatOperator(FunctionSpace(mesh, "CG", 1), ModelParams(), 0.1,
                      dtype=torch.float64, device="cpu")
    return op


def _seeded_5x4x3(pad):
    rng = np.random.default_rng(1)
    g = (6, 5, 4)
    Tg, Tpg = (700 + 100 * rng.random(g) for _ in range(2))
    pc = [(0, pad), (0, 0), (0, 0)]
    T0 = ModelParams().T_0
    Tp, Tpp = (np.pad(a, pc, constant_values=T0) for a in (Tg, Tpg))
    v = rng.standard_normal((g[0] + pad,) + g[1:])
    return Tg, Tpg, Tp, Tpp, v


def test_padded_operator_identity_rows_and_jax():
    """tests/test_grid_ops.py:131-156 on the port: ghost planes are
    identity rows, the physical rows equal the unpadded operator's bit for
    bit; the residual equals JAX's padded operator's at rtol 1e-12."""
    op = _op_5x4x3()
    g0 = GridHeatOperator(op)
    g3 = GridHeatOperator(op, pad_axis0=3)
    assert g3.grid == (9, 5, 4) and g3.has_bc and not g3.const_ok
    Tg, Tpg, Tp, Tpp, v = _seeded_5x4x3(3)
    t = torch.as_tensor
    r0 = g0.residual_g(t(Tg), t(Tpg), 0.1)
    r3 = g3.residual_g(t(Tp), t(Tpp), 0.1)
    assert torch.equal(r3[:-3], r0)
    assert float(r3[-3:].abs().max()) <= 1e-12
    out = g3.make_matvec_g(t(Tp), 0.1)(t(v))
    assert torch.equal(out[-3:], t(v)[-3:])
    jop = JHeat(JFS(jmesh.box_mesh_3d(5, 4, 3, 1.0, 1.0, 0.01), "CG", 1),
                jcfg.ModelParams(), 0.1, dtype=jnp.float64)
    j3 = JGrid(jop, pad_axis0=3)
    jr = jax.jit(lambda T, Tp: j3.residual_g(T, Tp, 0.1))
    jmv = jax.jit(lambda T, v: j3.make_matvec_g(T, 0.1)(v))
    _close(r3.numpy(), np.asarray(jr(jnp.asarray(Tp), jnp.asarray(Tpp))),
           1e-12, "residual against JAX's")
    _close(out.numpy(), np.asarray(jmv(jnp.asarray(Tp), jnp.asarray(v))),
           1e-12, "Jacobian action against JAX's")
    with pytest.raises(ValueError, match="padded grid"):
        g3.residual(t(Tp).reshape(-1), t(Tpp).reshape(-1))


@pytest.mark.parametrize("split", [(0, 3, 6, 9), (0, 2, 4, 6, 9), (0, 1, 9),
                                   (0, 8, 9)], ids=str)
def test_slab_rows_equal_the_whole_grid(split):
    """A slab of planes [lo, hi) of the padded grid, given its halo,
    reproduces the whole grid's rows: tables, diagonal and Jacobian action
    bit for bit (K2's halo form on the CPU: its plain twin), the residual
    within 1e-14."""
    g3 = GridHeatOperator(_op_5x4x3(), pad_axis0=3)
    _, _, Tp, Tpp, v = (torch.as_tensor(a) for a in _seeded_5x4x3(3))
    G0 = g3.grid[0]
    r = g3.residual_g(Tp, Tpp, 0.1)
    d = g3.jacobian_diag_g(Tp, 0.1)
    vals = g3.stencil_values_g(Tp, 0.1)
    y = g3.make_matvec_g(Tp, 0.1)(v)
    vm = torch.where(g3.bc_mask_g, torch.zeros_like(v), v)
    for lo, hi in zip(split[:-1], split[1:]):
        sl = g3.slab(lo, hi)

        def ext(x, src, lo=lo, hi=hi):
            """Rows [lo, hi) of `src` given as x, between the neighbours'
            planes of src (zeros at the grid's ends)."""
            z = torch.zeros_like(x[:1])
            return torch.cat([z if lo == 0 else src[lo - 1:lo], x,
                              z if hi == G0 else src[hi:hi + 1]])
        Te = ext(Tp[lo:hi], Tp)
        assert torch.equal(sl.stencil_values_r(Te, 0.1),
                           vals[:, lo:hi].reshape(27, hi - lo, -1))
        assert torch.equal(sl.jacobian_diag_r(Te, 0.1), d[lo:hi])
        rr = sl.residual_r(Te, ext(Tpp[lo:hi], Tpp), 0.1)
        assert float(((rr - r[lo:hi]).abs() / r.abs().max()).max()) <= 1e-14
        mv = sl.make_matvec_r(Te, 0.1, lambda x, ext=ext: ext(x, vm))
        assert torch.equal(mv(v[lo:hi]), y[lo:hi])


# ---- GridMG ----------------------------------------------------------------
@pytest.mark.parametrize("coarse", ["auto", "smooth"])
def test_grid_mg_matches_jax(jax_side, coarse):
    """One apply of GridMG on the 12x6x4 plate's P = 4 layout (3 ghost
    planes; seed R.MG_SEED), f64: the port against JAX's at rtol 1e-12,
    with JAX's hierarchy."""
    pad0 = (-(R.MG_DIMS[0] + 1)) % P
    mg = R.grid_mg(coarse, pad0)
    jx = jax_side[f"mg_{coarse}"]
    assert len(mg.ops) == jx["levels"]
    assert (mg.coarse_inv is not None) == jx["dense"]
    _close(R.mg_apply(coarse, pad0), jx["x"], 1e-12, f"GridMG {coarse}")


@pytest.mark.parametrize("case", ["P4-auto", "P4-smooth", "P2-auto",
                                  "P2-smooth"])
def test_rank_grid_mg_equals_unsharded_bit_for_bit(main, two, case):
    """GridMG's rank form, gathered, against the unsharded cycle on the
    same padded grid: bit for bit. At P = 4 (13 planes + 3 ghosts) the
    coarse levels run replicated (rank 3 holds one physical plane); at
    P = 2 every level of 'smooth' is sharded, axis 0 halved on the
    ranks' slabs."""
    p, coarse = case.split("-")
    runs = main if p == "P4" else two
    got = [r[f"mg_{coarse}"] for r in runs]
    x = R.mg_apply(coarse, got[0]["pad0"])
    for g in got:
        assert np.array_equal(g["x"], x)
    if case == "P2-smooth":
        assert all(got[0]["sharded"]) and len(got[0]["sharded"]) == 4
    if case == "P4-smooth":
        assert got[0]["sharded"] == [True, False, False, False]


def test_halo_form_equals_full_grid_rows_bit_for_bit(main):
    """K2's halo twin on an uneven split of 13 planes over 4 ranks (halo
    through comm.halo_exchange) against the full-grid twin: bit for bit."""
    h = main[0]["halo"]
    assert np.array_equal(h["halo"].reshape(-1), h["full"])
    assert all(np.array_equal(r["halo"]["halo"], h["halo"]) for r in main)


# ---- the sharded step --------------------------------------------------
@pytest.mark.parametrize("name", ["grid_ops", "grid_mg"])
def test_sharded_step_matches_jax(main, jax_side, name):
    """P = 4 port ranks against JAX's GridShardedProblem on 4 virtual
    devices: gathered T and Tf at rtol 1e-11, Newton equal, CG within
    max(5, 2%)."""
    jx = jax_side[name]
    for r in main:
        got = r[name]
        assert got["ok"]
        assert got["newton"] == jx["newton"]
        assert abs(got["cg"] - jx["cg"]) <= max(5, 0.02 * jx["cg"])
        for f in ("T", "Tf"):
            _close(got[f], jx[f], 1e-11, f"{name} {f}")


@pytest.mark.parametrize("name", ["grid_ops", "grid_mg"])
def test_rank_rows_are_jax_shards(main, jax_side, name):
    """Rank p's rows are JAX's shard p of the padded grid (ghost planes
    included), at rtol 1e-11."""
    jx = jax_side[name]
    for p, r in enumerate(main):
        lo, hi = r[name]["rows"][p]
        for f in ("T", "Tf"):
            _close(r[name][f"rank_{f}"],
                   jx[f"{f}_padded"][lo:hi].reshape(-1), 1e-11,
                   f"{name} rank {p} {f}")


@pytest.mark.parametrize("name", ["grid_ops", "grid_mg"])
def test_sharded_step_matches_unsharded(main, ref, name):
    """P = 4 port ranks against the port's unsharded ThermoViscoProblem:
    T, Tf at rtol 1e-10, sigma within 1e-6 of its max; the ranks in
    lockstep (equal counts, equal bits)."""
    un = ref[name]
    got = main[0][name]
    for f in ("T", "Tf"):
        _close(got[f], un[f], 1e-10, f"{name} {f}")
    scale = max(float(np.abs(un["sigma"]).max()), 1e-30)
    np.testing.assert_allclose(got["sigma"] / scale, un["sigma"] / scale,
                               atol=1e-6)
    for r in main[1:]:
        assert (r[name]["newton"], r[name]["cg"]) == (got["newton"],
                                                      got["cg"])
        assert all(np.array_equal(r[name][f], got[f])
                   for f in R.STEP_FIELDS)


def test_world_size_one_matches_unsharded(ref):
    """GridShardedProblem over one rank: the unsharded run's counts and
    fields (rtol 1e-12)."""
    one, un = ref["world_size_1"], ref["grid_mg"]
    assert one["ok"] and one["newton"] == un["newton"]
    assert one["cg"] == un["cg"]
    for f in R.STEP_FIELDS:
        _close(one[f], un[f], 1e-12, f)


def test_mixed_precision_matches_f64(main):
    """tests/test_grid_mg.py:104-128 at P = 4: f64 Newton over the f32
    MG-CG twin against the f64 sharded run, T and Tf at rtol 1e-10."""
    for r in main:
        assert r["mixed"]["ok"]
        for f in ("T", "Tf"):
            _close(r["mixed"][f], r["grid_mg"][f], 1e-10, f"mixed {f}")


def test_mg_cuts_iterations_against_jacobi(main, ref):
    """tests/test_grid_mg.py:87-101: the MG-preconditioned run (P = 4,
    and over one rank) takes under half the CG iterations of the Jacobi
    one over 2 steps. The Jacobi run is the world-size-1 problem's: its
    7,813 iterations cost ~16 ms each over 4 gloo ranks on a CPU host."""
    jac = ref["jacobi"]
    assert jac["ok"]
    for mg in (main[0]["grid_mg"], ref["world_size_1"]):
        assert mg["cg_2"] < jac["cg"] / 2, (mg["cg_2"], jac["cg"])


def test_dryrun_gspmd_grid_counts_equal_jax(main, jax_side):
    """The dry run's "gspmd-grid" strategy (12x6x4, f32, 2 steps,
    Chebyshev MG) at P = 4: Newton and CG equal to JAX's, T finite."""
    jx = jax_side["dryrun"]
    for r in main:
        got = r["dryrun"]
        assert got["ok"] and np.isfinite(got["T"]).all()
        assert (got["newton"], got["cg"]) == (jx["newton"], jx["cg"])


# ---- the T spaces beside CG-1 -------------------------------------------
@pytest.mark.parametrize("fe,mechanics,slice_", [
    (dict(T_family="DG", T_degree=1), "none", "7e"),
    (dict(T_family="CG", T_degree=2), "none", "7f")],
    ids=["dg1", "cg2"])
def test_unported_routes_raise(fe, mechanics, slice_):
    """The T spaces beside CG-1 run: DG-1 T (slice 7e) and CG-2 T (slice
    7f), each on the 4x3x2 plate over a group of one rank in this
    process, 2 steps of the default config, against the port's unsharded
    ThermoViscoProblem at tests/test_grid_dg.py's and tests/test_grid2.py:
    237's tolerances (T 1e-9 and sigma 1e-8 of their max, CG at most 2x +
    8: the sharded step's coarse chain is GridMG, the unsharded one's
    GeometricMG or SA-AMG); tests/test_torch_grid_shard_dg.py and
    tests/test_torch_grid_shard_q2.py hold them to JAX's."""
    cfg = RunConfig(fe=FEConfig(**fe), mechanics=mechanics)
    from fem_glass_tempering_tpu_torch.config import TimeConfig
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )
    from fem_glass_tempering_tpu_torch.parallel.comm import make_device_mesh
    cfg = dataclasses.replace(cfg, time=TimeConfig(0.0, 0.2, 0.1))
    mesh = box_mesh_3d(4, 3, 2)
    dm = make_device_mesh("cpu")
    try:
        gs = GridShardedProblem(mesh, cfg, dm)
        st, ok, ni, ki = gs.run(gs.init_state(), 2)
        flat = gs.gather_state(st)
    finally:
        dm.close()
    un = ThermoViscoProblem(mesh=mesh, config=cfg, device="cpu")
    un.setup()
    st_u, ok_u, ni_u, ki_u = un.multi_step(un.state, 2)
    assert ok and ok_u
    assert (gs.dg_mg if slice_ == "7e" else gs.q2_mg) is not None
    assert ki <= 2 * ki_u + 8, (ki, ki_u)
    for f, tol in (("T", 1e-9), ("sigma", 1e-8)):
        a, b = getattr(flat, f).numpy(), getattr(st_u, f).numpy()
        scale = max(float(np.abs(b).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= tol * scale, f


# ---- sharded output -------------------------------------------------------
def test_sharded_io_raises(main, ref):
    """Sharded output at P = 4 on the 4x3x2 plate (5 planes and 3 ghost
    planes; rank 3 holds ghost planes only): solve() writes a piece a
    field, step and rank, an index a rank, and a checkpoint of every field
    a rank (rank 0's also `t` and meta.json); the series' last T is the
    gathered T bit for bit. That checkpoint (8 planes), loaded by a
    world-size-1 problem (5 planes), raises a ValueError naming both
    grids."""
    io = [r["io"] for r in main]
    assert io[0]["pad0"] == 3 and io[0]["rows"][3] == (6, 8)
    assert all(np.array_equal(r["series_T"], r["T"]) for r in io)
    files = io[0]["series_files"]
    assert len(files) == P + 2 * 2 * P
    assert {f"piece_T_000001_o{o:06d}.npz" for o in (0, 2, 4, 6)} <= set(
        files)
    ckpt = io[0]["ckpt_files"]
    assert len(ckpt) == 2 + (len(ViscoState._fields) - 1) * P
    assert "piece_du_000000_o000006.npz" in ckpt
    assert ref["io_grid"] == (5, 4, 3)
    assert "(8, 4, 3)" in ref["io_refusal"]
    assert "(5, 4, 3)" in ref["io_refusal"]


def test_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GridShardedProblem(box_mesh_3d(4, 3, 2), R.mg_cfg())


def test_ghost_rows_are_edge_padded():
    """shard_state pads the ghost planes by edge replication (JAX's
    `_to_grid`) and keeps rank p's planes; no process group needed for a
    layout of the caller's own."""
    gs = object.__new__(GridShardedProblem)
    gs.rows = [(0, 4), (4, 8), (8, 12), (12, 16)]
    gs.comm = SimpleNamespace(rank=3)
    gs._ngrid_base = (13, 7, 5)
    gs.pad0, gs.device, gs.dtype = 3, torch.device("cpu"), torch.float64
    T = torch.arange(13 * 35, dtype=torch.float64)
    fields = {k: None for k in ViscoState._fields}
    fields.update(t=torch.zeros(()), T=T)
    got = gs.shard_state(ViscoState(**fields)).T.reshape(4, 35)
    want = F.pad(T.reshape(1, 13, 35), (0, 0, 0, 3), mode="replicate")[0]
    assert torch.equal(got, want[12:16])
