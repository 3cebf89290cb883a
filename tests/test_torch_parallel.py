"""The port's distributed strategies against the JAX package's, on the CPU.

JAX runs in this process on its virtual devices (tests/conftest.py); the
port runs in P = 4 gloo ranks spawned once for the module
(tests/torch_parallel_ranks.py, which imports no JAX), and in 2 ranks for
the command line, while the tests compute JAX's side and the port's
unsharded runs here. Mirrors tests/test_sharding.py (JAX marks it slow:
the sharded port is held to the unsharded port at JAX's tolerances),
tests/test_domain_cg.py (against the unsharded port at JAX's tolerances,
with JAX's CGDD arrays and Newton counts at the same P) and
tests/test_domain_decomposition.py::test_partition_contiguity_and_balance;
pins all_reduce_sum's forward-mode rule, the summed all-gather's bits and
--shard.
"""

import json
import os
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as R
from fem_glass_tempering_tpu import config as jcfg
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.models.problem import (
    ThermoViscoProblem as JaxProblem,
)
from fem_glass_tempering_tpu.parallel import partition as jpart
from fem_glass_tempering_tpu.parallel.domain_cg import CGDDProblem as JaxCGDD
from fem_glass_tempering_tpu.parallel.sharding import (
    make_device_mesh as jax_device_mesh,
    shard_problem as jax_shard_problem,
)
from fem_glass_tempering_tpu_torch.fem import mesh as port_mesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.main import main
from fem_glass_tempering_tpu_torch.parallel import partition
from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks

P = 4
CLI = ["--device", "cpu", "--shard", "--problem-dim", "2", "--t-element",
       "DG1", "--nx", "8", "--ny", "8", "--steps", "3", "--formats", "npz",
       "--write-every", "1"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's processes, running while the tests compute JAX's side:
    every case in P ranks, the unsharded references of the CGDD and the
    shard_problem cases in a process each, the command line in 2
    ranks."""
    out = tmp_path_factory.mktemp("shard_cli")
    with ThreadPoolExecutor(4) as ex:
        yield SimpleNamespace(
            main=ex.submit(run_ranks, R.rank_body, P, "cpu", threads=1),
            ref_cgdd=ex.submit(run_ranks, R.unsharded_cgdd_body, 1, "cpu",
                               threads=1),
            ref_shard=ex.submit(run_ranks, R.unsharded_shard_body, 1, "cpu",
                                threads=1),
            cli=ex.submit(run_ranks, R.cli_body, 2, "cpu",
                          CLI + ["--output-dir", str(out / "two")],
                          threads=1),
            out=out)


def _jax_devices():
    devs = jax.devices()
    if len(devs) < P:
        pytest.skip(f"needs {P} virtual devices")
    return devs[:P]


# ---- partition (numpy) ---------------------------------------------------
def test_partition_contiguity_and_balance():
    m = port_mesh.box_mesh_2d(8, 4)
    part = partition.partition_cells(m, 4)
    counts = np.bincount(part, minlength=4)
    assert counts.min() >= 7 and counts.max() <= 9
    assert set(part) == {0, 1, 2, 3}


@pytest.mark.parametrize("make,args,n_parts", [
    ("box_mesh_2d", (8, 4), 4), ("box_mesh_2d", (6, 4, 2.0, 1.0), 8),
    ("box_mesh_3d", (4, 4, 2), 4), ("box_mesh_3d", (5, 3, 2), 3),
    ("reference_glass_mesh_1d", (), 4)])
def test_partition_arrays_equal_jax(make, args, n_parts):
    m = getattr(port_mesh, make)(*args)
    mj = getattr(jmesh, make)(*args)
    np.testing.assert_array_equal(partition.partition_cells(m, n_parts),
                                  jpart.partition_cells(mj, n_parts))
    fs = FunctionSpace(m, "DG", 1)
    lay, part, aux = partition.build_dd_layout(m, fs.element.nloc, fs.dofmap,
                                               n_parts)
    lay_j, part_j, aux_j = jpart.build_dd_layout(mj, fs.element.nloc,
                                                 fs.dofmap, n_parts)
    np.testing.assert_array_equal(part, part_j)
    for f in vars(lay_j):
        np.testing.assert_array_equal(getattr(lay, f), getattr(lay_j, f),
                                      err_msg=f)
    for k, v in aux_j.items():
        if isinstance(v, list):
            assert len(aux[k]) == len(v)
            for a, b in zip(aux[k], v):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        else:
            np.testing.assert_array_equal(aux[k], v)
    vec = np.arange(lay.n_dofs_global, dtype=float)
    loc = partition.scatter_global_to_local(lay, vec)
    np.testing.assert_array_equal(loc, jpart.scatter_global_to_local(lay_j,
                                                                     vec))
    np.testing.assert_array_equal(partition.gather_local_to_global(lay, loc),
                                  vec)


def test_cgdd_shared_dofs_exist():
    """The partition creates shared interface dofs (JAX's sanity test)."""
    mesh = port_mesh.box_mesh_2d(6, 4)
    fs = FunctionSpace(mesh, "CG", 1)
    part = partition.partition_cells(mesh, 8)
    touch = {}
    for c in range(mesh.n_cells):
        for g in fs.dofmap[c]:
            touch.setdefault(int(g), set()).add(int(part[c]))
    assert sum(1 for s in touch.values() if len(s) > 1) >= 5


# ---- CGDDProblem -----------------------------------------------------------
@pytest.fixture(scope="module")
def jax_side(ranks):
    """JAX's CGDDProblem at P on each CGDD case (arrays, Newton and CG per
    step, gathered T) and JAX's shards of the DG box's heat operator,
    computed while the port's ranks run."""
    devices = _jax_devices()
    meshes = {"cg1_2d": lambda: jmesh.box_mesh_2d(6, 4, 2.0, 1.0),
              "hex": lambda: jmesh.box_mesh_3d(4, 4, 2),
              "cg2_2d": lambda: jmesh.box_mesh_2d(4, 4)}
    cgdd = {}
    for name, (_, degree, steps) in R.CGDD_CASES.items():
        cfg = jcfg.RunConfig(
            fe=jcfg.FEConfig(T_family="CG", T_degree=degree),
            time=jcfg.TimeConfig(0.0, steps * 0.1, 0.1),
            output=jcfg.OutputConfig(write_every=0, formats=()))
        dd = JaxCGDD(meshes[name](), cfg, n_parts=P, devices=devices)
        st = dd.init_state()
        newton, cg = [], []
        for _ in range(steps):
            st, ok, ni, ki = dd.step(st)
            assert ok
            newton.append(ni)
            cg.append(ki)
        cgdd[name] = dict(arrs={k: np.asarray(v) for k, v in dd.arrs.items()},
                          newton=newton, cg=cg, T=dd.gather_T(st))
    cfg = jcfg.RunConfig(fe=jcfg.FEConfig(T_family="DG", T_degree=1),
                         time=jcfg.TimeConfig(0.0, 0.5, 0.1),
                         output=jcfg.OutputConfig(write_every=0, formats=()))
    prob = JaxProblem(mesh=jmesh.box_mesh_2d(8, 8, 2.0, 2.0), config=cfg)
    prob.setup()
    jax_shard_problem(prob, jax_device_mesh(devices))
    h = prob.heat
    shards = {}
    for axis, arr, n in (("cells", h.dofmap, h.np_dofmap.shape[0]),
                         ("boundary", h.b_dofmap, h.np_b_dofmap.shape[0]),
                         ("interior", h.i_dofmap_p,
                          h.np_i["dofmap_p"].shape[0])):
        ordered = sorted(arr.addressable_shards, key=lambda s: s.device.id)
        shards[axis] = [(min(s.index[0].start, n), min(s.index[0].stop, n))
                        for s in ordered]
    return dict(cgdd=cgdd, shards=shards)


@pytest.mark.parametrize("name", sorted(R.CGDD_CASES))
def test_cgdd_matches_jax_and_single_device(ranks, jax_side, name):
    jx = jax_side["cgdd"][name]
    res = [r["cgdd"][name] for r in ranks.main.result()]
    for p, r in enumerate(res):
        # rank p holds row p of JAX's arrays
        for k, v in jx["arrs"].items():
            np.testing.assert_array_equal(r["arrs"][k],
                                          v if k == "phi" else v[p],
                                          err_msg=k)
        assert all(r["ok"])
        # lockstep: every rank's counts and gathered fields are the same
        assert r["newton"] == res[0]["newton"] and r["cg"] == res[0]["cg"]
        np.testing.assert_array_equal(r["T"], res[0]["T"])
    assert res[0]["newton"] == jx["newton"]
    assert abs(sum(res[0]["cg"]) - sum(jx["cg"])) <= 0.01 * sum(jx["cg"])
    ref = ranks.ref_cgdd.result()[0]["cgdd"][name]
    np.testing.assert_allclose(res[0]["T"], ref["T"], rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(res[0]["sigma"], ref["sigma"], rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(res[0]["T"], jx["T"], rtol=1e-10, atol=1e-9)


def test_cgdd_gather_state_matches_single(ranks):
    """gather_state gives the global layout on every rank, equal to the
    unsharded run, and feeds io/checkpoint.py unchanged."""
    res = [r["cgdd"]["hex"] for r in ranks.main.result()]
    for r in res:
        assert r["round_trip_equal"]
        for f, v in r["gathered"].items():
            np.testing.assert_array_equal(v, res[0]["gathered"][f])
    g = res[0]["gathered"]
    assert float(g["t"]) == pytest.approx(R.GATHER_STEPS * 0.1)
    ref = ranks.ref_cgdd.result()[0]["gather"]
    for f in R.STATE_FIELDS:
        np.testing.assert_allclose(g[f], ref[f], rtol=1e-9, atol=1e-11,
                                   err_msg=f)


# ---- the collectives -------------------------------------------------------
def test_all_reduce_sum_gives_the_reduced_tangent(ranks):
    """Under torch.func.jvp the tangent of all_reduce_sum(u * u) is the sum
    over the ranks of 2 u v: a plain dist.all_reduce in its place leaves
    each rank its own 2 u v."""
    res = [r["collectives"] for r in ranks.main.result()]
    y = sum(r["x"] ** 2 for r in res)
    t = sum(2 * r["x"] * r["v"] for r in res)
    for r in res:
        np.testing.assert_allclose(r["y"], y, rtol=1e-15)
        np.testing.assert_allclose(r["t"], t, rtol=1e-15)


def test_summed_all_gather_equals_all_gather_bit_for_bit(ranks):
    for r in (r["collectives"] for r in ranks.main.result()):
        assert np.array_equal(r["gathered"].view(np.int64),
                              r["all_gather"].view(np.int64))


# ---- shard_problem ----------------------------------------------------------
@pytest.mark.parametrize("name", sorted(R.SHARD_CASES))
def test_sharded_matches_single(ranks, name):
    ref = ranks.ref_shard.result()[0][name]
    res = [r["shard"][name] for r in ranks.main.result()]
    for r in res:
        # every rank takes the same counts and holds the same bits
        assert (r["newton"], r["cg"]) == (ref["newton"], ref["cg"])
        np.testing.assert_array_equal(r["T"], res[0]["T"])
    rtol = 1e-11 if name == "stencil" else 1e-12
    np.testing.assert_allclose(res[0]["T"], ref["T"], rtol=rtol, atol=1e-10)
    np.testing.assert_allclose(res[0]["sigma"], ref["sigma"], rtol=1e-10,
                               atol=1e-14)


def test_sharded_rows_are_jax_shards(ranks, jax_side):
    """Rank r holds the rows JAX's device r holds: contiguous blocks of
    ceil(n/P) cells, boundary facets and interior facets."""
    res = [r["shard"]["dg1_2d"]["rows"] for r in ranks.main.result()]
    for axis, rows in jax_side["shards"].items():
        assert [tuple(r[axis]) for r in res] == rows, axis


# ---- the command line -------------------------------------------------------
def test_shard_cli_world_size_one_and_two_ranks(ranks, capsys):
    """--shard as one rank equals the unsharded command line bit for bit;
    two ranks: rank 0 alone prints and writes, with the same counts and T
    within 1e-12."""
    runs = {}
    for tag, argv in (("plain", [a for a in CLI if a != "--shard"]),
                      ("one", CLI)):
        assert main(argv + ["--output-dir", str(ranks.out / tag)]) == 0
        runs[tag] = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert not torch.distributed.is_initialized()
    T = {tag: np.load(ranks.out / tag / "series.npz")["T"]
         for tag in ("plain", "one")}
    assert np.array_equal(T["one"], T["plain"])
    printed = ranks.cli.result()
    assert printed[1] == ""
    two = json.loads(printed[0].splitlines()[-1])
    for k in ("n_steps", "newton_iters", "krylov_iters"):
        assert two[k] == runs["one"][k] == runs["plain"][k]
    assert sorted(os.listdir(ranks.out / "two")) == ["series.npz"]
    T2 = np.load(ranks.out / "two" / "series.npz")["T"]
    np.testing.assert_allclose(T2, T["plain"], rtol=1e-12, atol=1e-10)
