"""The port's grid-sharded CG-2 step (ops/grid2.py GridQ2Slab, LatticeHalo,
LatticeNodeTransfers, Q2MG's grid route and its rank form RankQ2MG, the
lattice route of parallel/grid_shard.py GridShardedProblem) against the
JAX package's, on the CPU.

JAX runs in this process on its virtual devices (tests/conftest.py); the
port runs in two groups of P = 4 gloo ranks, in P = 2 ranks and in one
process of its own (a world-size-1 problem and the unsharded runs),
spawned once for the module (tests/torch_grid_shard_q2_ranks.py, which
imports no JAX), while the tests compute JAX's side. Mirrors
tests/test_grid2.py:237 (the sharded step) at P = 4.

Tolerances: a slab's Jacobian action, diagonal and flux tables against
the whole lattice's rows bit for bit, its residual within 1e-14 of the
max; Q2MG's grid route against JAX's at 1e-12 of the apply's max; the
rank form's halo and transfers bit for bit, its apply bit for bit with
point Chebyshev smoothing and within 1e-13 of the max with the line
smoother (the power iteration's sums of squares are summed over the
ranks). The sharded step against JAX's GridShardedProblem at P = 4: T and
Tf at max-rel 1e-11, Newton equal, CG within max(5, 2%) (the dots sum in
another order), as tests/test_torch_grid_shard.py holds CG-1; against the
port's unsharded ThermoViscoProblem at tests/test_grid2.py:237's (T 1e-9
and sigma 1e-8 of their max), Newton equal, CG within max(5, 2%).
"""

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_grid_shard_q2_ranks as R
from fem_glass_tempering_tpu import config as jcfg
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.io import sharded as jsharded
from fem_glass_tempering_tpu.models.viscoelastic import (
    ViscoState as JViscoState,
)
from fem_glass_tempering_tpu.ops.grid2 import GridHeatOperator2 as JG2
from fem_glass_tempering_tpu.ops.grid2 import Q2MG as JQ2MG
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.parallel.grid_shard import (
    GridShardedProblem as JaxGridSharded,
)
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
from fem_glass_tempering_tpu_torch.io.sharded import read_sharded_series
from fem_glass_tempering_tpu_torch.ops.grid2 import Q2MG, GridHeatOperator2
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks

P = 4
DT = 0.1
# Q2MG's grid route: the plate's node grid (7 planes) padded with one
# ghost plane (P = 4)
MG_PAD0 = 1
JAX_P4 = ("dryrun",)


@pytest.fixture(scope="module")
def work():
    with tempfile.TemporaryDirectory(prefix="fgt_q2_") as d:
        yield d


@pytest.fixture(scope="module")
def ranks(work):
    """The port's processes, running while the tests compute JAX's side."""
    with ThreadPoolExecutor(4) as ex:
        yield SimpleNamespace(
            main=[ex.submit(run_ranks, R.rank_body, P, "cpu", group, work,
                            threads=1) for group in (0, 1)],
            two=ex.submit(run_ranks, R.two_rank_body, 2, "cpu", threads=1),
            ref=ex.submit(run_ranks, R.ref_body, 1, "cpu", threads=1))


def _jax_sharded(name):
    dims, cfg, steps = R.CASES[name]
    sp = JaxGridSharded(jmesh.box_mesh_3d(*dims), cfg(jcfg),
                        devices=jax.devices()[:P])
    st, ok, ni, ki = sp.run(sp.init_state(), steps)
    assert ok
    flat = sp.gather_state(st)
    return dict(newton=ni, cg=ki, lat_pad0=sp.lat_pad0,
                **{f: np.asarray(getattr(flat, f)) for f in R.STEP_FIELDS})


def _jax_plate(work):
    """JAX's sharded plate through solve() (a snapshot a step, its
    checkpoint at step 2; the ranks wait for the file jax_ckpt_ready)."""
    ready = os.path.join(work, "jax_ckpt_ready")
    try:
        out = os.path.join(work, "jax_q2")
        dims, _, _ = R.CASES["plate"]
        sp = JaxGridSharded(jmesh.box_mesh_3d(*dims), R.io_cfg(jcfg, out),
                            devices=jax.devices()[:P])
        st = sp.solve()
        with open(ready, "w") as fh:
            fh.write("ok")
    finally:
        if not os.path.exists(ready):
            with open(ready, "w") as fh:
                fh.write("failed")
    flat = sp.gather_state(st)
    padded = {f: np.asarray(getattr(st, f)) for f in ("T", "Tf")}
    return dict(problem=sp, out=out, newton=sp.newton_iters,
                cg=sp.krylov_iters, lat_pad0=sp.lat_pad0, padded=padded,
                **{f: np.asarray(getattr(flat, f)) for f in R.STEP_FIELDS})


def _seeded(shape, seed):
    rng = np.random.default_rng(seed)
    return (700 + 100 * rng.random(shape), rng.standard_normal(shape))


def _jax_grid_route():
    """JAX's Q2MG(coarse_pad0=1) on the plate: one apply on a seeded
    residual at a seeded state, and its frozen rhos."""
    mesh = jmesh.box_mesh_3d(*R.PLATE)
    heat = lambda m, deg: JHeat(JFS(m, "CG", deg), jcfg.ModelParams(),  # noqa
                                DT, dtype=jnp.float64)
    fine = JG2(heat(mesh, 2))
    mg = JQ2MG(fine, lambda m: heat(m, 1), coarse_pad0=MG_PAD0)
    mg.freeze_rhos(DT)
    T, r = (jnp.asarray(a) for a in _seeded(fine.grid, 7))
    apply = jax.jit(lambda T, r: mg.preconditioner_g(
        mg.linearization_states_g(T), DT)(r))
    return dict(apply=np.asarray(apply(T, r)), rho2=mg._rho2,
                rhos=list(mg.gmg._frozen_rhos), grid0=mg.gmg.ops[0].grid)


@pytest.fixture(scope="module")
def jax_side(ranks, work):
    """JAX's GridShardedProblem on the P = 4 cases and its grid route, in
    three threads at once."""
    if len(jax.devices()) < P:
        pytest.skip(f"needs {P} virtual devices")
    with ThreadPoolExecutor(3) as ex:
        jobs = {name: ex.submit(_jax_sharded, name) for name in JAX_P4}
        jobs["plate"] = ex.submit(_jax_plate, work)
        jobs["grid_route"] = ex.submit(_jax_grid_route)
        return {k: job.result() for k, job in jobs.items()}


@pytest.fixture(scope="module")
def main(ranks, jax_side):
    """Per rank: every P = 4 result of the groups (whose output case
    waits for JAX's checkpoint)."""
    groups = [job.result() for job in ranks.main]
    return [{k: v for g in groups for k, v in g[p].items()}
            for p in range(P)]


@pytest.fixture(scope="module")
def two(ranks):
    return ranks.two.result()


@pytest.fixture(scope="module")
def ref(ranks):
    return ranks.ref.result()[0]


def _max_rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _heat(dims, degree):
    return HeatOperator(FunctionSpace(box_mesh_3d(*dims), "CG", degree),
                        ModelParams(), DT, dtype=torch.float64, device="cpu")


# ---- the slabs (this process) ------------------------------------------
@pytest.mark.parametrize("dims,split", [
    (R.PLATE, (0, 4, 8, 12, 16)),
    (R.PLATE, (0, 1, 13)),
    ((5, 4, 3, 1.0, 0.7, 0.01), (0, 3, 6, 9, 12)),
    ((5, 4, 3, 1.0, 0.7, 0.01), (0, 2, 4, 6, 8, 10, 12, 14, 16)),
    ((3, 4, 4, 0.01, 1.0, 1.0), (0, 5, 9))], ids=str)
def test_slab_rows_equal_the_whole_lattice(dims, split):
    """A slab of lattice planes [lo, hi) of the padded lattice, given its
    window of two halo planes a side: the Jacobian action, the diagonal
    and the linearised flux tables equal the whole lattice's rows bit for
    bit, the residual within 1e-14 of its max; ghost rows zero (the
    diagonal one). Splits with a rank of one lattice plane (0, 1) and
    ranks of ghost planes alone (the 5-cell axis over 8 ranks)."""
    op = GridHeatOperator2(_heat(dims, 2))
    g, g0 = op.grid, op.grid[0]
    rng = np.random.default_rng(5)
    T, Tp, v = (torch.as_tensor(a) for a in (
        700 + 100 * rng.random(g), 700 + 100 * rng.random(g),
        rng.standard_normal(g)))
    r = op.residual_g(T, Tp, DT)
    d = op.jacobian_diag_g(T, DT)
    y = op.make_matvec_g(T, DT)(v)
    flux = op._flux_lin_tables(T, DT)

    def window(x, lo, hi):
        w = torch.zeros((hi - lo + 4,) + g[1:], dtype=x.dtype)
        for j in range(max(lo - 2, 0), min(hi + 2, g0)):
            w[j - lo + 2] = x[j]
        return w
    seen_ghost = False
    for lo, hi in zip(split[:-1], split[1:]):
        sl = op.slab(lo, hi)
        n = sl.n_real
        seen_ghost |= n == 0
        Te = window(T, lo, hi)
        rr = sl.residual_r(Te, window(Tp, lo, hi), DT)
        dd = sl.jacobian_diag_r(Te, DT)
        yy = sl.make_matvec_r(Te, DT, lambda x, lo=lo, hi=hi: window(
            v, lo, hi))(torch.zeros(sl.slab_grid, dtype=T.dtype))
        assert torch.equal(dd[:n], d[lo:lo + n])
        assert torch.equal(yy[:n], y[lo:lo + n])
        if n:
            assert float((rr[:n] - r[lo:lo + n]).abs().max()
                         / r.abs().max()) <= 1e-14
        assert bool((rr[n:] == 0).all() and (yy[n:] == 0).all()
                    and (dd[n:] == 1).all())
        # the face tables of the slab's cells, against the whole's
        c0, c1 = sl._cells0
        for fc, W in zip(sl.faces, sl._flux_lin_tables(Te, DT)):
            k = op.faces.index(fc)
            want = flux[k] if fc.axis == 0 else flux[k][c0:c1]
            assert torch.equal(W, want), (lo, hi, fc.axis, fc.side)
    assert seen_ghost == (split[-2] >= g0)


# ---- Q2MG's grid route (this process) -------------------------------------
def test_grid_route_matches_jax(jax_side):
    """Q2MG(coarse_kind="grid", coarse_pad0=1) on the plate: JAX's padded
    GridMG chain (node grid 8x5x4) and frozen rhos, and one apply on a
    seeded residual at a seeded state within 1e-12 of JAX's max; without
    the padding the grid route equals the unsharded GeometricMG route
    within 1e-12."""
    jx = jax_side["grid_route"]
    heat1 = lambda m: HeatOperator(  # noqa: E731
        FunctionSpace(m, "CG", 1), ModelParams(), DT, dtype=torch.float64,
        device="cpu")
    fine = GridHeatOperator2(_heat(R.PLATE, 2))
    mg = Q2MG(fine, heat1, coarse_pad0=MG_PAD0, coarse_kind="grid")
    mg.freeze_rhos(DT)
    assert mg.gmg.ops[0].grid == tuple(jx["grid0"])
    assert mg._rho2 == pytest.approx(jx["rho2"], rel=1e-14)
    assert mg.gmg._frozen_rhos == pytest.approx(jx["rhos"], rel=1e-14)
    T, r = (torch.as_tensor(a) for a in _seeded(fine.grid, 7))
    y = mg.preconditioner_g(mg.linearization_states_g(T), DT)(r)
    assert _max_rel(y.numpy(), jx["apply"]) <= 1e-12
    outs = []
    for kind in ("grid", "geometric"):
        q = Q2MG(fine, heat1, coarse_kind=kind)
        q.freeze_rhos(DT)
        outs.append(q.preconditioner_g(q.linearization_states_g(T), DT)(r))
    assert _max_rel(outs[0].numpy(), outs[1].numpy()) <= 1e-12
    with pytest.raises(ValueError, match="coarse_kind='grid'"):
        Q2MG(fine, heat1, coarse_pad0=MG_PAD0)


# ---- the rank forms -------------------------------------------------------
def _rank_forms(main, two):
    return ([(f"P4-drift rank {p}", r["rank_form"])
             for p, r in enumerate(main)]
            + [(f"P2-xthin rank {p}", r["rank_form"])
               for p, r in enumerate(two)])


def test_rank_transfers_bit_for_bit(main, two):
    """The lattice halo (two planes a side) and the maps between a rank's
    lattice rows and its node rows (Q2MG's restriction and prolongation,
    the even-stride injection with its ghost-plane edge pad) on the
    drifting layout at P = 4 (lattice rows [3p, 3p + 3), node rows
    [2p, 2p + 2); rank 3's node rows are ghosts) and on the box thinnest
    along x at P = 2: the whole lattice's rows bit for bit."""
    assert main[2]["drift"]["lat_rows"][2] == (6, 9)
    assert main[2]["drift"]["rows"][2] == (4, 6)
    for tag, t in _rank_forms(main, two):
        for k in ("halo", "restrict", "prolong", "inject"):
            assert t[f"{k}_equal"], (tag, k)


def test_rank_preconditioner_equals_whole_lattice(main, two):
    """RankQ2MG's apply, gathered, against Q2MG's grid route over the
    whole lattice on the same inputs: bit for bit with point Chebyshev
    smoothing; within 1e-13 of the max with the line smoother (lines
    along z on the rank's columns; along x on the all-gathered lattice),
    whose power-iteration bound sums its norms over the ranks; zero on
    ghost rows. A point-smoothed apply at P = 4 makes 5 lattice halos
    (nu_pre + 1 + nu_post Jacobian actions) and 2 re-partitions
    (restriction, prolongation); a line-smoothed one along x 4 more
    all-gathers (one a line solve)."""
    for tag, t in _rank_forms(main, two):
        assert t["chebyshev"]["equal"], (tag, t["chebyshev"]["max_rel"])
        assert t["line"]["max_rel"] <= 1e-13, (tag, t["line"]["max_rel"])
        for s in ("line", "chebyshev"):
            assert t[s]["ghost_zero"], (tag, s)
    for p, r in enumerate(main):
        t = r["rank_form"]
        assert t["line"]["smoother"] == ("line", 2)
        c = t["chebyshev"]["collectives"]
        assert (c["lattice_halos"], c["repartitions"]) == (5, 2), (p, c)
    for r in two:
        t = r["rank_form"]
        assert t["line"]["smoother"] == ("line", 0)
        c = t["line"]["collectives"]
        assert c["other_sums"] - t["chebyshev"]["collectives"][
            "other_sums"] == 4, c


# ---- the sharded step ----------------------------------------------------
@pytest.mark.parametrize("name", ["plate", "dryrun"])
def test_sharded_step_matches_jax(main, jax_side, name):
    """P = 4 port ranks against JAX's GridShardedProblem on 4 virtual
    devices (tests/test_grid2.py:237's plate, 13 lattice planes and 3
    ghost planes; the dry run's "gspmd-q2"): T and Tf at max-rel 1e-11,
    Newton equal, CG within max(5, 2%); the ranks in lockstep."""
    jx = jax_side[name]
    got = main[0][name]
    assert got["lat_pad0"] == jx["lat_pad0"] == 3
    for r in main:
        g = r[name]
        assert g["ok"] and g["newton"] == jx["newton"]
        assert abs(g["cg"] - jx["cg"]) <= max(5, 0.02 * jx["cg"])
        for f in ("T", "Tf"):
            assert _max_rel(g[f], jx[f]) <= 1e-11, (name, f)
        assert (g["newton"], g["cg"]) == (got["newton"], got["cg"])
        assert all(np.array_equal(g[f], got[f]) for f in R.STEP_FIELDS)


def test_rank_rows_are_jax_shards(main, jax_side):
    """Rank p's lattice planes are JAX's shard p of the padded lattice,
    the ghost planes (edge-padded from plane 12, on rank 3) included, at
    max-rel 1e-11."""
    jx = jax_side["plate"]
    for p, r in enumerate(main):
        lo, hi = r["plate"]["lat_rows"][p]
        for f in ("T", "Tf"):
            want = jx["padded"][f][lo:hi].reshape(-1)
            assert _max_rel(r["plate"][f"rank_{f}"], want) <= 1e-11, (p, f)


def _against_unsharded(got, un):
    assert got["ok"] and un["ok"] and got["newton"] == un["newton"]
    assert abs(got["cg"] - un["cg"]) <= max(5, 0.02 * un["cg"])
    for f, tol in (("T", 1e-9), ("sigma", 1e-8)):
        b = un[f]
        assert float(np.abs(got[f] - b).max()) <= tol * np.abs(b).max(), f


@pytest.mark.parametrize("where,name", [
    ("P4", "drift"), ("P4", "ghost"), ("P2", "plate"), ("P2", "mixed"),
    ("P2", "xthin"), ("P1", "plate")])
def test_matches_unsharded(main, two, ref, where, name):
    """tests/test_grid2.py:237's check on the port: the sharded runs
    against the port's unsharded ThermoViscoProblem (its coarse chain
    GeometricMG), T within 1e-9 and sigma within 1e-8 of their max,
    Newton equal, CG within max(5, 2%): at P = 4 the drifting layout and
    the 2-cell axis (rank 2 one real lattice plane, rank 3 ghost planes
    alone), 1 step each, at P = 2 the plate in f64 and in mixed precision
    and the box thinnest along x, over a group of one rank the plate."""
    runs = dict(P4=[r[name] for r in main] if where == "P4" else None,
                P2=[r[name] for r in two] if where == "P2" else None,
                P1=[ref["world_size_1"]] if where == "P1" else None)[where]
    for got in runs:
        _against_unsharded(got, ref[name])
    if name == "ghost":
        assert runs[3]["lat_rows"][3] == (6, 8)
        assert runs[2]["lat_rows"][2] == (4, 6)
    if name == "xthin":
        assert runs[0]["smoother"] == ("line", 0)


def test_mixed_against_f64(two):
    """The mixed run (f64 Newton over the f32 twins of the lattice
    operator and Q2MG) against the f64 run at P = 2: T within 1e-9 of its
    max, Newton equal."""
    for r in two:
        assert r["mixed"]["newton"] == r["plate"]["newton"]
        assert _max_rel(r["mixed"]["T"], r["plate"]["T"]) <= 1e-9


def test_collectives_per_iteration(main):
    """The plate at P = 4: every Newton or CG iteration exchanges lattice
    windows (the Jacobian actions) and re-partitions between the lattice
    and the node grid (two a Q2MG apply)."""
    for r in main:
        c = r["plate"]["collectives"]
        its = r["plate"]["newton"] + r["plate"]["cg"]
        assert c["lattice_halos"] > its and c["repartitions"] >= 2 * its


def test_cg2_with_mechanics_raises(ref):
    """JAX's ValueError for CG-2 T with equilibrium mechanics."""
    assert ref["mechanics_refusal"] == (
        "equilibrium mechanics under sharded CG-2 is not wired yet — use "
        "the CG-1 path")


# ---- the Q2 files -------------------------------------------------------
def test_series_and_resume(main):
    """solve() of the plate at P = 4: a piece a field, step and rank (T
    and Tf at the rank's lattice offset, sigma at its node offset), the
    series' last snapshot equal to the gathered state bit for bit, a
    checkpoint at step 2; save -> load -> run(1) equals run(1), every
    field bit for bit, the same counts."""
    for r in main:
        io = r["io"]
        assert io["ok"] and all(io["loaded_bits"].values())
        assert all(io["resumed_bits"].values())
        assert io["counts"][0] == io["counts"][1]
        for f in R.SERIES_FIELDS:
            assert np.array_equal(io["series"][f][-1], io["flat"][f]), f
    files = main[0]["io"]["files"]
    assert {f"piece_T_000001_o{4 * p:06d}.npz" for p in range(P)} <= set(
        files)
    assert {f"piece_sigma_000001_o{2 * p:06d}.npz" for p in range(P)} <= set(
        files)
    assert len(files) == P + 2 * P * len(R.SERIES_FIELDS)


def test_files_against_jax(main, jax_side, work):
    """The Q2 files both ways at P = 4: the same pieces as JAX's series
    (JAX's one process writes one index, each rank one); the port's
    series against JAX's at max-rel 1e-11; the port reads JAX's series
    (its gathered state, bit for bit) and loads JAX's checkpoint of step
    2 (its lattice rows bit for bit); JAX's loader places the port's
    checkpoint on its shardings, every field bit for bit."""
    jx = jax_side["plate"]
    jdir = os.path.join(jx["out"], "sharded_series")

    def pieces(names):
        return sorted(n for n in names if n.startswith("piece_"))
    assert pieces(os.listdir(jdir)) == pieces(main[0]["io"]["files"])
    got = read_sharded_series(jdir)
    for f in R.SERIES_FIELDS:
        assert np.array_equal(got[f][-1], jx[f]), f
        assert _max_rel(main[0]["io"]["series"][f], got[f]) <= 1e-11, f
    for p, r in enumerate(main):
        io = r["io"]
        lo, hi = r["plate"]["lat_rows"][p]
        assert io["jax_t"] == pytest.approx(0.2, abs=1e-15)
        for f in ("T", "Tf"):
            assert np.array_equal(io["jax_rows"][f],
                                  jx["padded"][f][lo:hi].reshape(-1)), f
    sp = jx["problem"]
    jst, meta = jsharded.load_sharded_checkpoint(
        os.path.join(work, "port_q2", "sharded_ckpt_000002"),
        sp._state_shardings)
    want = main[0]["io"]["saved_padded"]
    assert meta["extra"]["done"] == 2
    assert np.asarray(jst.T).shape == (16, 9, 7)
    for f in JViscoState._fields:
        a = np.asarray(getattr(jst, f))
        assert np.array_equal(a.reshape(want[f].shape), want[f]), f
