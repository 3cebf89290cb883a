"""The port's per-rank output, checkpoints and multi-process entry of the
grid-sharded step (io/sharded.py, parallel/multihost.py,
GridShardedProblem.solve / save_checkpoint / load_checkpoint) against the
JAX package's, on the CPU.

The port runs in P = 4 gloo ranks (the 12x6x3 plate of JAX's
tests/test_sharded_io.py, and in 4 more its DG-1 case on a 10x6x3 plate),
in P = 2 ranks (the mechanics plate), in one
more process (its unsharded run) and in two subprocesses joined through
multihost.initialize at an explicit coordinator (tests/test_multihost.py),
all spawned once for the module (tests/torch_sharded_io_ranks.py, which
imports no JAX), while this process runs JAX's side: its checkpoint on 8
virtual devices, which the ranks wait for, its chunked solve on 4, and
its DG-1 checkpoint and solve on 4.

Bit for bit: the series read back against the gathered state; a resumed
run against the straight one with the same chunk boundaries (with
mechanics, du included); the files of either package read or loaded by
the other. Against JAX's runs: T and Tf at rtol 1e-11, Newton equal, CG
within max(5, 2%) (the dots' sums run in another order), as
tests/test_torch_grid_shard.py holds them. The multi-process run against
the unsharded port: max |dT| / max |T| below 1e-11, JAX's bound.
"""

import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import torch_sharded_io_ranks as S
from fem_glass_tempering_tpu import config as jcfg
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.io import sharded as jsharded
from fem_glass_tempering_tpu.models.viscoelastic import (
    ViscoState as JViscoState,
)
from fem_glass_tempering_tpu.parallel.grid_shard import (
    GridShardedProblem as JaxGridSharded,
)
from fem_glass_tempering_tpu_torch.io import sharded
from fem_glass_tempering_tpu_torch.models.viscoelastic import (
    TABLEAU_SIZE,
    ViscoState,
)
from fem_glass_tempering_tpu_torch.parallel import multihost
from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks

P = 4
TESTS = Path(__file__).resolve().parent


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _multihost(work):
    """The two worker processes of tests/test_multihost.py (the port's)."""
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(TESTS.parent), str(TESTS)])
    out = os.path.join(work, "multihost.npz")
    return [subprocess.Popen(
        [sys.executable, str(TESTS / "torch_sharded_io_ranks.py"),
         str(pid), str(port), out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)], out


def _jax_cfg(out, write_every=1, checkpoint_every=0, **solver):
    """tests/test_sharded_io.py `_cfg` (extra solver settings allowed)."""
    return jcfg.RunConfig(
        fe=jcfg.FEConfig(T_family="CG", T_degree=1),
        time=jcfg.TimeConfig(0.0, 0.3, 0.1),
        solver=jcfg.SolverConfig(linear_operator="stencil", **solver),
        output=jcfg.OutputConfig(output_dir=str(out),
                                 write_every=write_every,
                                 formats=("npz",),
                                 npz_fields=S.SERIES_FIELDS,
                                 checkpoint_every=checkpoint_every))


def _jax_plate():
    return jmesh.box_mesh_3d(*S.PLATE, 1.0, 1.0, 0.01)


def _jax_checkpoint(work):
    """JAX's GridShardedProblem on 8 virtual devices: 2 steps, its
    checkpoint (16 planes, 2 a piece; the ranks wait for the file
    jax_ckpt_ready), then one more step."""
    ready = os.path.join(work, "jax_ckpt_ready")
    try:
        sp = JaxGridSharded(_jax_plate(), _jax_cfg(work, write_every=0),
                            devices=jax.devices()[:8])
        st = sp.init_state()
        for _ in range(2):
            st, ok, _, _ = sp.run(st, 1)
            assert ok
        sp.save_checkpoint(os.path.join(work, "jax_ckpt"), st,
                           extra={"t": 0.2})
        with open(ready, "w") as fh:
            fh.write("ok")
    finally:
        if not os.path.exists(ready):
            with open(ready, "w") as fh:
                fh.write("failed")
    st3, ok, _, _ = sp.run(st, 1)
    return dict(problem=sp, ok=ok, pad0=sp.pad0,
                T=np.asarray(sp.gather_state(st3).T))


def _jax_solve(work):
    """JAX's GridShardedProblem.solve on 4 virtual devices, chunked as the
    port's chunked case."""
    out = os.path.join(work, "jax_solve")
    sp = JaxGridSharded(_jax_plate(), _jax_cfg(out, checkpoint_every=2,
                                               **S.CHUNKED),
                        devices=jax.devices()[:P])
    st = sp.solve()
    flat = sp.gather_state(st)
    return dict(newton=sp.newton_iters, cg=sp.krylov_iters, out=out,
                **{f: np.asarray(getattr(flat, f)) for f in S.SERIES_FIELDS})


def _jax_dg(work):
    """JAX's DG-1 GridShardedProblem (tests/test_sharded_io.py `_dg_cfg`)
    on S.DG_PLATE over 4 virtual devices: its solve() series, its
    checkpoint of step 2 (the ranks wait for the file jax_dg_ckpt_ready)
    and the step after it."""
    ready = os.path.join(work, "jax_dg_ckpt_ready")
    cfg = lambda out, we: jcfg.RunConfig(  # noqa: E731
        fe=jcfg.FEConfig(T_family="DG", T_degree=1),
        time=jcfg.TimeConfig(0.0, 0.3, 0.1),
        solver=jcfg.SolverConfig(linear_operator="stencil",
                                 newton_rtol=1e-10, cg_rtol=1e-10,
                                 cg_max_it=300),
        output=jcfg.OutputConfig(output_dir=str(out), write_every=we,
                                 formats=("npz",),
                                 npz_fields=S.SERIES_FIELDS),
        dtype="float64")
    mesh = jmesh.box_mesh_3d(*S.DG_PLATE, 1.0, 1.0, 0.01)
    try:
        sp = JaxGridSharded(mesh, cfg(work, 0), devices=jax.devices()[:P])
        st2, ok, _, _ = sp.run(sp.init_state(), 2)
        assert ok
        sp.save_checkpoint(os.path.join(work, "jax_dg_ckpt"), st2,
                           extra={"t": 0.2})
        with open(ready, "w") as fh:
            fh.write("ok")
    finally:
        if not os.path.exists(ready):
            with open(ready, "w") as fh:
                fh.write("failed")
    st3, ok3, _, _ = sp.run(st2, 1)
    out = os.path.join(work, "jax_dg_solve")
    sv = JaxGridSharded(mesh, cfg(out, 1), devices=jax.devices()[:P])
    flat = sv.gather_state(sv.solve())
    return dict(problem=sp, ok=ok3, cell_pad0=sp.cell_pad0,
                T_step3=np.asarray(sp.gather_state(st3).T), out=out,
                series={f: np.asarray(getattr(flat, f))
                        for f in S.SERIES_FIELDS})


@pytest.fixture(scope="module", autouse=True)
def side(tmp_path_factory):
    """Every process of the module and JAX's side, started at once."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    work = str(tmp_path_factory.mktemp("sharded_io"))
    procs, mh_out = _multihost(work)
    try:
        with ThreadPoolExecutor(7) as ex:
            yield SimpleNamespace(
                work=work, procs=procs, multihost_out=mh_out,
                main=ex.submit(run_ranks, S.rank_body, P, "cpu", work,
                               threads=1),
                mech=ex.submit(run_ranks, S.mech_body, 2, "cpu", work,
                               threads=1),
                ref=ex.submit(run_ranks, S.reference_body, 1, "cpu", work,
                              threads=1),
                dg=ex.submit(run_ranks, S.dg_body, P, "cpu", work,
                             threads=1),
                jax_ckpt=ex.submit(_jax_checkpoint, work),
                jax_solve=ex.submit(_jax_solve, work),
                jax_dg=ex.submit(_jax_dg, work))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


@pytest.fixture(scope="module")
def main(side):
    return side.main.result()


def _close(a, b, rtol, what):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=0.0, err_msg=what)


# ---- the writer and the reader on synthetic slabs ------------------------
# name -> (node grid, cell grid, local dofs a cell (None: a Q2 lattice,
# no local axis)); the cell fields T and Tf_partial, sigma on the nodes
LAYOUTS = {
    "node_pad0": ((8, 3, 2), None, None),
    "node_pad3": ((13, 3, 2), None, None),
    "dg_cells": ((6, 3, 3), (5, 2, 2), 8),
    "q2_lattice": ((5, 3, 2), (9, 5, 3), None),
}
EXTRA = {"T": (), "Tf_partial": (TABLEAU_SIZE,), "sigma": (3, 3)}


def _synthetic(name, world):
    """Seeded flat global fields of LAYOUTS[name], their grid-shaped arrays
    padded by edge replication to a multiple of `world` planes (JAX's
    `_to_grid`), and the writer's layout keywords."""
    grid, cells, nloc = LAYOUTS[name]
    rng = np.random.default_rng(17)
    pad0 = (-grid[0]) % world
    kw = dict(grid=(grid[0] + pad0,) + grid[1:], pad0=pad0)
    fields = ("T", "sigma")
    f_grid = {"T": grid, "sigma": grid}
    if cells is not None:
        cp = (-cells[0]) % world
        kw.update(cell_grid=(cells[0] + cp,) + cells[1:], cell_pad0=cp,
                  cell_fields=("T", "Tf_partial"),
                  cell_local_axis=nloc is not None)
        fields = ("T", "Tf_partial", "sigma")
        cg = cells + ((nloc,) if nloc else ())
        f_grid.update(T=cg, Tf_partial=cg)
    flat, padded = {}, {}
    for f in fields:
        n = int(np.prod(f_grid[f]))
        flat[f] = rng.standard_normal((n,) + EXTRA[f])
        g = flat[f].reshape(f_grid[f] + EXTRA[f])
        pad = kw["cell_pad0"] if (cells and f != "sigma") else pad0
        padded[f] = np.pad(g, [(0, pad)] + [(0, 0)] * (g.ndim - 1),
                           mode="edge")
    return flat, padded, kw


def _rank_rows(padded, world, rank):
    """Rank `rank`'s flat rows of every padded field."""
    out = {}
    for f, g in padded.items():
        L = g.shape[0] // world
        lead = g.ndim - len(EXTRA[f])
        slab = g[rank * L:(rank + 1) * L]
        out[f] = torch.as_tensor(slab.reshape((-1,) + slab.shape[lead:]))
    return out


def _write_port_series(path, name, world=P):
    flat, padded, kw = _synthetic(name, world)
    for r in range(world):
        w = sharded.ShardedSeriesWriter(str(path), fields=tuple(flat),
                                        rank=r, world_size=world, **kw)
        rows = _rank_rows(padded, world, r)
        for k in range(2):
            w.write(0.1 * (k + 1), SimpleNamespace(
                **{f: a + k for f, a in rows.items()}))
        w.close()
    return flat, padded, kw


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_port_series_read_by_both_readers(tmp_path, name):
    """The port's pieces at P = 4 (node grids with 0 and 3 ghost planes,
    a DG cell grid with its local axis, a Q2 lattice without): JAX's
    read_sharded_series and the port's give the input back bit for bit,
    flat and grid-shaped."""
    flat, padded, kw = _write_port_series(tmp_path, name)
    for read in (jsharded.read_sharded_series, sharded.read_sharded_series):
        got = read(str(tmp_path))
        np.testing.assert_array_equal(got["times"], [0.1, 0.2])
        for f, a in flat.items():
            assert np.array_equal(got[f], np.stack([a, a + 1])), (read, f)
        grid_shaped = read(str(tmp_path), flat=False)
        for f, g in padded.items():
            pad = g.shape[0] - np.shape(grid_shaped[f])[1]
            assert pad in (kw["pad0"], kw.get("cell_pad0", 0))
            assert np.array_equal(grid_shaped[f][0], g[:g.shape[0] - pad])
    names = os.listdir(tmp_path)
    assert {"index.json", "index_p1.json", "index_p3.json"} <= set(names)
    assert sum(n.startswith("piece_T_000001_") for n in names) == P


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_jax_series_read_by_port(tmp_path, name):
    """A series that JAX's writer streams from arrays with a NamedSharding
    over its 8 virtual devices, read by the port: the input, bit for
    bit."""
    flat, padded, kw = _synthetic(name, 8)
    mesh = JMesh(np.array(jax.devices()[:8]), ("x",))
    sh = NamedSharding(mesh, JP("x"))
    w = jsharded.ShardedSeriesWriter(str(tmp_path), fields=tuple(flat), **kw)
    w.write(0.1, SimpleNamespace(**{f: jax.device_put(jnp.asarray(g), sh)
                                    for f, g in padded.items()}))
    w.close()
    got = sharded.read_sharded_series(str(tmp_path))
    for f, a in flat.items():
        assert np.array_equal(got[f][0], a), f


def _synthetic_state(world):
    """Every ViscoState field on the 13x3x2 node grid padded for `world`
    ranks, seeded; -> (padded grid-shaped arrays, layout of rank 0)."""
    rng = np.random.default_rng(5)
    G = (13 + (-13) % world, 3, 2)
    shapes = dict(T=(), T_prev=(), Tf=(), Tf_prev=(),
                  Tf_partial=(TABLEAU_SIZE,), phi=(), xi=(),
                  thermal_strain=(3, 3), total_strain=(3, 3),
                  deviatoric_strain=(3, 3), s_tilde=(TABLEAU_SIZE, 3, 3),
                  sigma_tilde=(TABLEAU_SIZE, 3, 3),
                  s_partial=(TABLEAU_SIZE, 3, 3),
                  sigma_partial=(TABLEAU_SIZE, 3, 3), sigma=(3, 3), du=(3,))
    padded = {f: rng.standard_normal(G + e) for f, e in shapes.items()}
    padded["t"] = np.float64(0.25)
    return padded, G


def _rank_state(padded, G, world, rank):
    L = G[0] // world
    return ViscoState(**{f: torch.as_tensor(
        g if f == "t" else g[rank * L:(rank + 1) * L].reshape(
            (-1,) + g.shape[3:])) for f, g in padded.items()})


def test_checkpoint_round_trip_and_jax_loader(tmp_path):
    """save_sharded_checkpoint at P = 4 (16 planes), every field: each
    rank loads its rows back bit for bit; JAX's load_sharded_checkpoint
    places the same bits on its 8 virtual devices (2 planes a device);
    meta.json and `t` come from rank 0 alone."""
    padded, G = _synthetic_state(P)
    for r in range(P):
        layout = sharded.PlaneLayout(G, r, P)
        sharded.save_sharded_checkpoint(str(tmp_path),
                                        _rank_state(padded, G, P, r), layout,
                                        extra={"t": 0.25})
        if r == 0:
            assert {"meta.json", "piece_t_000000_o000000.npz"} <= set(
                os.listdir(tmp_path))
    assert sum(n.startswith("piece_t_") for n in os.listdir(tmp_path)) == 1
    for r in range(P):
        st, meta = sharded.load_sharded_checkpoint(
            str(tmp_path), sharded.PlaneLayout(G, r, P), device="cpu")
        want = _rank_state(padded, G, P, r)
        for f in ViscoState._fields:
            assert torch.equal(getattr(st, f), getattr(want, f)), f
    assert meta["shapes"]["T"] == list(G) and meta["extra"] == {"t": 0.25}
    mesh = JMesh(np.array(jax.devices()[:8]), ("x",))
    sh = NamedSharding(mesh, JP("x"))
    shardings = JViscoState(**{f: (NamedSharding(mesh, JP()) if f == "t"
                                   else sh) for f in JViscoState._fields})
    jst, _ = jsharded.load_sharded_checkpoint(str(tmp_path), shardings)
    for f in JViscoState._fields:
        assert np.array_equal(np.asarray(getattr(jst, f)), padded[f]), f


def test_checkpoint_loader_refuses_other_padding(tmp_path):
    """A checkpoint of 16 planes (P = 4) onto 3 ranks (15 planes): a
    ValueError that names both grids."""
    padded, G = _synthetic_state(P)
    for r in range(P):
        sharded.save_sharded_checkpoint(
            str(tmp_path), _rank_state(padded, G, P, r),
            sharded.PlaneLayout(G, r, P))
    with pytest.raises(ValueError, match=r"\(16, 3, 2\).*\(15, 3, 2\)"):
        sharded.load_sharded_checkpoint(
            str(tmp_path), sharded.PlaneLayout((15, 3, 2), 1, 3),
            device="cpu")


def test_loader_reads_only_the_covering_pieces(tmp_path, monkeypatch):
    """A checkpoint of 8 pieces (JAX's layout on 8 devices, 2 planes a
    piece) loaded by rank 1 of 4: it opens the 2 pieces of planes [4, 8)
    of each field and `t`, no other."""
    padded, G = _synthetic_state(8)
    for r in range(8):
        sharded.save_sharded_checkpoint(
            str(tmp_path), _rank_state(padded, G, 8, r),
            sharded.PlaneLayout(G, r, 8))
    opened = []
    real = np.load
    monkeypatch.setattr(sharded.np, "load",
                        lambda p, *a, **k: opened.append(
                            os.path.basename(p)) or real(p, *a, **k))
    st, _ = sharded.load_sharded_checkpoint(
        str(tmp_path), sharded.PlaneLayout(G, 1, P), device="cpu")
    assert sorted(n for n in opened if n.startswith("piece_T_0")) == [
        "piece_T_000000_o000004.npz", "piece_T_000000_o000006.npz"]
    assert len(opened) == 2 * (len(ViscoState._fields) - 1) + 1
    assert torch.equal(st.T, _rank_state(padded, G, P, 1).T)


# ---- the sharded solve, its output and checkpoints (P = 4) ---------------
def test_streamed_series_equals_gathered_state(main):
    """tests/test_sharded_io.py:32: the series' pieces, concatenated, equal
    the gathered state bit for bit across an uneven split (13 planes over
    4 ranks, 3 ghost planes); every rank wrote a piece a field and step
    (rank 3 holds one physical plane) and an index."""
    for r in main:
        s = r["series"]
        assert s["pad0"] == 3 and s["series"]["T"].shape[0] == 3
        for f in S.SERIES_FIELDS:
            assert np.array_equal(s["series"][f][-1], s["flat"][f]), f
        assert len(s["files"]) == P + 3 * P * len(S.SERIES_FIELDS)
        assert "index.json" in s["files"] and "index_p3.json" in s["files"]


def test_checkpoint_cadence(main):
    """tests/test_sharded_io.py:73: a checkpoint every 2 of 3 steps."""
    assert main[0]["series"]["ckpts"] == ["sharded_ckpt_000002"]


def test_series_write_makes_no_collective(main):
    """A write is this rank's device-to-host copy and its files: no
    collective; a piece of every field at the rank's plane offset."""
    for p, r in enumerate(main):
        s = r["series"]
        assert s["write_collectives"] == 0
        lo = s["rows"][p][0]
        assert f"piece_du_000000_o{lo:06d}.npz" in s["written"]
        assert len(s["written"]) == len(ViscoState._fields) - 1


def test_checkpoint_resume_bit_for_bit(main):
    """tests/test_sharded_io.py:50: run(2) -> save -> load -> run(1) ==
    run(3), every field bit for bit; the loaded state is the saved one
    (dtype, device, `t`); save makes one collective (its sync), load
    none."""
    for r in main:
        rs = r["resume"]
        assert rs["ok"] and all(rs["loaded_bits"].values())
        assert rs["loaded_device"] == "cpu" and rs["loaded_t"] == 0.2
        assert (rs["save_collectives"], rs["load_collectives"]) == (1, 0)
        for f, a in rs["straight"].items():
            assert np.array_equal(rs["resumed"][f], a), f
    assert len(main[0]["resume"]["files"]) == 1 + 1 + 16 * P


def test_chunked_solve_matches_jax(main, side):
    """solve() with write_every = 1 and a checkpoint every 2 steps, at a
    Newton tolerance where jac_every is 5, against JAX's solve on the
    same config at P = 4: Newton equal, CG within max(5, 2%), T and Tf at
    rtol 1e-11; its chunks take other counts than run(3)'s one."""
    jx = side.jax_solve.result()
    for r in main:
        c = r["chunked"]
        assert c["jac_every"] == 5 and c["run_ok"]
        assert c["newton"] == jx["newton"]
        assert abs(c["cg"] - jx["cg"]) <= max(5, 0.02 * jx["cg"])
        for f in ("T", "Tf"):
            _close(c[f], jx[f], 1e-11, f)
    c = main[0]["chunked"]
    assert (c["newton"], c["cg"]) != (c["run_newton"], c["run_cg"])


def test_jax_solve_series_read_by_port(side):
    """JAX's own solve series (4 devices) read by the port's reader: JAX's
    gathered state at the last step, bit for bit."""
    jx = side.jax_solve.result()
    got = sharded.read_sharded_series(os.path.join(jx["out"],
                                                   "sharded_series"))
    for f in S.SERIES_FIELDS:
        assert np.array_equal(got[f][-1], jx[f]), f


def test_jax_checkpoint_resumes_on_port(main, side):
    """JAX's checkpoint of step 2 (8 virtual devices, 16 planes) loaded at
    P = 4 (16 planes) and stepped once: T at rtol 1e-11 from JAX's
    step 3."""
    jx = side.jax_ckpt.result()
    assert jx["ok"]
    for r in main:
        got = r["jax_ckpt"]
        assert got["ok"] and got["t"] == pytest.approx(0.2, abs=1e-15)
        _close(got["T"], jx["T"], 1e-11, "T")


def test_port_checkpoint_loads_in_jax(main, side):
    """The port's checkpoint (P = 4, 4 planes a piece) loaded by JAX's
    load_sharded_checkpoint onto its GridShardedProblem's shardings (8
    devices): the port's state, every field bit for bit."""
    sp = side.jax_ckpt.result()["problem"]
    jst, meta = jsharded.load_sharded_checkpoint(
        os.path.join(side.work, "port_ckpt"), sp._state_shardings)
    want = main[0]["resume"]["saved_padded"]
    assert meta["extra"] == {"t": 0.2}
    for f in JViscoState._fields:
        a = np.asarray(getattr(jst, f))
        assert np.array_equal(a.reshape(want[f].shape), want[f]), f


def test_problem_refuses_a_checkpoint_of_other_padding(side):
    """JAX's checkpoint (16 planes) onto a world-size-1 problem (13
    planes): a ValueError naming both grids."""
    ref = side.ref.result()[0]
    assert ref["grid"] == (13, 7, 4)
    assert "(16, 7, 4)" in ref["refusal"] and "(13, 7, 4)" in ref["refusal"]


# ---- DG-1 T: cell-grid fields (P = 4) --------------------------------------
def test_dg_series_equals_gathered_state(side):
    """tests/test_sharded_io.py:97 at P = 4: solve()'s series of the DG-1
    plate (T and Tf on the cell grid, 10 layers padded to 12; sigma on the
    node grid, 11 planes padded to 12) equals the gathered state bit for
    bit at every rank; a piece a field, step and rank, at the rank's cell
    layer offset for T, and a checkpoint at step 2."""
    for r in side.dg.result():
        assert (r["cell_pad0"], r["pad0"]) == (2, 1)
        assert r["series"]["T"].shape[0] == 3
        for f in S.SERIES_FIELDS:
            assert np.array_equal(r["series"][f][-1], r["flat"][f]), f
        assert r["ckpts"] == ["sharded_ckpt_000002"]
        files = r["files"]
    assert {f"piece_T_000002_o{3 * p:06d}.npz" for p in range(P)} <= set(
        files)
    assert len(files) == P + 3 * P * len(S.SERIES_FIELDS)


def test_dg_checkpoint_resume_bit_for_bit(side):
    """tests/test_sharded_io.py:117 at P = 4: run(2) -> save -> load ->
    run(1) == run(3), every field bit for bit; the loaded state is the
    saved one."""
    for r in side.dg.result():
        assert r["ok"] and all(r["loaded_bits"].values())
        for f, a in r["straight"].items():
            assert np.array_equal(r["resumed"][f], a), f


def test_dg_files_cross_read(side):
    """The DG files both ways at P = 4: the port reads JAX's series (its
    gathered state, bit for bit) and resumes JAX's checkpoint of step 2
    (T at rtol 1e-11 from JAX's step 3); JAX's loader places the port's
    checkpoint on its shardings (cell-grid T-space fields, node-grid
    sigma fields), every field bit for bit."""
    jx = side.jax_dg.result()
    assert jx["ok"] and jx["cell_pad0"] == 2
    got = sharded.read_sharded_series(os.path.join(jx["out"],
                                                   "sharded_series"))
    for f in S.SERIES_FIELDS:
        assert np.array_equal(got[f][-1], jx["series"][f]), f
    ranks = side.dg.result()
    for r in ranks:
        assert r["ok_jax"] and r["jax_t"] == pytest.approx(0.2, abs=1e-15)
        _close(r["jax_T"], jx["T_step3"], 1e-11, "T")
    sp = jx["problem"]
    jst, meta = jsharded.load_sharded_checkpoint(
        os.path.join(side.work, "port_dg_ckpt"), sp._state_shardings)
    want = ranks[0]["saved_padded"]
    assert meta["extra"] == {"t": 0.2}
    assert np.asarray(jst.T).shape == (12, 6, 3, 8)
    for f in JViscoState._fields:
        a = np.asarray(getattr(jst, f))
        assert np.array_equal(a.reshape(want[f].shape), want[f]), f


# ---- mechanics (P = 2) ----------------------------------------------------
def test_mechanics_resume_bit_for_bit(side):
    """mechanics="equilibrium" on the 8x6x4 plate at P = 2: run(2) ->
    save -> load -> run(1) == run(2) + run(1), every field bit for bit,
    du included; the same heat and elasticity counts."""
    for r in side.mech.result():
        assert r["ok"] and r["has_du"] and r["du_max"] > 0
        assert all(r["loaded_bits"].values())
        assert all(r["resumed_bits"].values()), r["resumed_bits"]
        assert r["counts"][0] == r["counts"][1]


# ---- the multi-process entry ---------------------------------------------
def test_two_process_multihost_matches_unsharded(side):
    """tests/test_multihost.py:61 on the port: two processes joined through
    multihost.initialize at an explicit coordinator (gloo),
    make_multihost_problem, 2 steps, gather_to_host; T against the
    unsharded port's run, max |dT| / max |T| < 1e-11."""
    outs = []
    for p in side.procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(side.procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "OK" in out
    got = np.load(side.multihost_out)
    T_ref = side.ref.result()[0]["T"]
    assert int(got["world"]) == 2 and int(got["padded_rows"]) == 14 * 7 * 4
    rel = np.abs(got["T"] - T_ref).max() / np.abs(T_ref).max()
    assert rel < 1e-11, rel
