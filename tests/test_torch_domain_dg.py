"""The port's DG domain decomposition (parallel/domain.py DDProblem)
against the JAX package's, on the CPU.

JAX runs in this process on its virtual devices (tests/conftest.py); the
port runs in P = 4 gloo ranks spawned once for the module
(tests/torch_dd_ranks.py, which imports no JAX), and its unsharded runs
and a world-size-1 DDProblem in one more process, while the tests compute
JAX's side. Mirrors tests/test_domain_decomposition.py at P = 4: T and
sigma against JAX's DDProblem and the unsharded run at JAX's tolerances,
gather_state, the tet box, the cross facets; besides, each rank's arrays
equal JAX's row, Newton per step equals JAX's and CG is within 2% (the
order of the summed dots moves JAX's own count by up to 3 between
partitions), and the halo carries the tangent of the Jacobian action.
"""

from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import torch_dd_ranks as R
from fem_glass_tempering_tpu import config as jcfg
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.parallel.domain import DDProblem as JaxDD
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.parallel import partition
from fem_glass_tempering_tpu_torch.parallel.comm import DeviceMesh, run_ranks
from fem_glass_tempering_tpu_torch.parallel.domain import DDProblem

P = 4
JAX_MESHES = {"slab": jmesh.reference_glass_mesh_1d,
              "box": lambda: jmesh.box_mesh_2d(6, 4, 2.0, 1.0),
              "tet": lambda: jmesh.box_mesh_3d(2, 2, 2, cell_type="tet")}


@pytest.fixture(scope="module")
def ranks():
    """The port's processes, running while the tests compute JAX's side."""
    with ThreadPoolExecutor(2) as ex:
        yield SimpleNamespace(
            main=ex.submit(run_ranks, R.rank_body, P, "cpu", threads=1),
            ref=ex.submit(run_ranks, R.reference_body, 1, "cpu",
                          threads=1))


@pytest.fixture(scope="module")
def jax_side(ranks):
    """JAX's DDProblem at P on every case (arrays, Newton and CG per step,
    gathered T and sigma, the slab's gathered state after GATHER_STEPS),
    and the arrays of the slab's at P = 1."""
    devs = jax.devices()
    if len(devs) < P:
        pytest.skip(f"needs {P} virtual devices")
    out = {}
    for name, (_, steps) in R.CASES.items():
        cfg = jcfg.RunConfig(
            fe=jcfg.FEConfig(T_family="DG", T_degree=1),
            time=jcfg.TimeConfig(0.0, steps * 0.1, 0.1),
            output=jcfg.OutputConfig(write_every=0, formats=()))
        dd = JaxDD(JAX_MESHES[name](), cfg, n_parts=P, devices=devs[:P])
        st = dd.init_state()
        res = dict(newton=[], cg=[],
                   arrs={k: np.asarray(v) for k, v in dd.arrs.items()})
        for k in range(steps):
            st, ok, ni, ki = dd.step(st)
            assert ok
            res["newton"].append(ni)
            res["cg"].append(ki)
            if name == "slab" and k + 1 == R.GATHER_STEPS:
                g = dd.gather_state(st)
                res["gathered"] = {f: np.asarray(getattr(g, f))
                                   for f in R.STATE_FIELDS}
        res["T"], res["sigma"] = dd.gather_T(st), dd.gather_sigma(st)
        out[name] = res
        if name == "slab":
            one = JaxDD(JAX_MESHES[name](), cfg, n_parts=1,
                        devices=devs[:1])
            out["slab_one_rank_arrs"] = {k: np.asarray(v)
                                         for k, v in one.arrs.items()}
    return out


def _arrays_equal_jax_row(got, jax_arrs, p):
    """Rank p holds row p of JAX's arrays (phi, replicated, whole):
    integer arrays exactly, float arrays at 1e-14."""
    assert sorted(got) == sorted(jax_arrs)
    for k, v in jax_arrs.items():
        want = v if k == "phi" else v[p]
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want, rtol=1e-14, atol=0,
                                       err_msg=k)


def _counts_match_jax(newton, cg, jx):
    assert newton == jx["newton"]
    for got, want in zip(cg, jx["cg"]):
        assert abs(got - want) <= 0.02 * want, (cg, jx["cg"])


@pytest.mark.parametrize("name", sorted(R.CASES))
def test_dd_matches_jax_and_single_device(ranks, jax_side, name):
    jx = jax_side[name]
    res = [r[name] for r in ranks.main.result()]
    for p, r in enumerate(res):
        _arrays_equal_jax_row(r["arrs"], jx["arrs"], p)
        assert all(r["ok"])
        # lockstep: every rank's counts and gathered fields are the same
        assert (r["newton"], r["cg"]) == (res[0]["newton"], res[0]["cg"])
        np.testing.assert_array_equal(r["T"], res[0]["T"])
        np.testing.assert_array_equal(r["sigma"], res[0]["sigma"])
    _counts_match_jax(res[0]["newton"], res[0]["cg"], jx)
    ref = ranks.ref.result()[0]["unsharded"][name]["end"]
    for want in (ref["T"], jx["T"]):
        np.testing.assert_allclose(res[0]["T"], want, rtol=1e-10, atol=1e-9)
    for want in (ref["sigma"], jx["sigma"]):
        np.testing.assert_allclose(res[0]["sigma"], want, rtol=1e-8,
                                   atol=1e-12)


def test_dd_gather_state_matches_single(ranks, jax_side):
    """gather_state gives the global layout on every rank, equal to the
    unsharded run and to JAX's gathered state; gather_T places what the
    port's gather_local_to_global places."""
    res = [r["slab"] for r in ranks.main.result()]
    for r in res:
        for f, v in r["gathered"].items():
            np.testing.assert_array_equal(v, res[0]["gathered"][f])
    g = res[0]["gathered"]
    assert float(g["t"]) == pytest.approx(R.GATHER_STEPS * 0.1)
    ref = ranks.ref.result()[0]["unsharded"]["slab"]["at_gather"]
    for f in R.STATE_FIELDS:
        for want in (ref[f], jax_side["slab"]["gathered"][f]):
            np.testing.assert_allclose(g[f], want, rtol=1e-9, atol=1e-11,
                                       err_msg=f)
    fs = FunctionSpace(R.CASES["slab"][0](), "DG", 1)
    lay, _, _ = partition.build_dd_layout(fs.mesh, fs.element.nloc,
                                          fs.dofmap, P)
    local = np.stack([r["local_T"] for r in res])
    assert np.array_equal(partition.gather_local_to_global(lay, local),
                          res[0]["T"])


def test_dd_halo_carries_the_tangent(ranks):
    """The jvp of each rank's residual equals its rows of the unsharded
    heat operator's jvp, cross facets included: the halo's all-gather
    reduces the tangent as well (a plain dist.all_gather leaves the
    remote side's tangent out)."""
    for r in ranks.main.result():
        for name in R.CASES:
            t = r[name]["tangent"]
            scale = np.abs(t["unsharded"]).max()
            np.testing.assert_allclose(t["local"], t["unsharded"], rtol=0,
                                       atol=1e-12 * scale, err_msg=name)


def test_dd_world_size_one(ranks, jax_side):
    """One rank: the arrays equal JAX's at P = 1 (the padded cross facet
    of zero weight included, which the step drops: it adds exact zeros),
    the run equals the unsharded one and takes JAX's P = 4 Newton counts
    (JAX's are the same at P = 1, 2, 4 and 8 on the slab)."""
    one = ranks.ref.result()[0]["one_rank"]
    _arrays_equal_jax_row(one["arrs"], jax_side["slab_one_rank_arrs"], 0)
    assert one["arrs"]["cr_qw"].shape[0] == 1
    assert not one["arrs"]["cr_qw"].any()
    assert all(one["ok"])
    _counts_match_jax(one["newton"], one["cg"], jax_side["slab"])
    ref = ranks.ref.result()[0]["unsharded"]["slab"]["end"]
    np.testing.assert_allclose(one["T"], ref["T"], rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(one["sigma"], ref["sigma"], rtol=1e-8,
                               atol=1e-12)
    t = one["tangent"]
    np.testing.assert_allclose(t["local"], t["unsharded"], rtol=0,
                               atol=1e-12 * np.abs(t["unsharded"]).max())


def test_dd_cross_facets_exist():
    """The P-way partition of the slab produces cross-rank facets, so the
    halo path runs (JAX's sanity test, at P = 4)."""
    mesh = R.CASES["slab"][0]()
    part = partition.partition_cells(mesh, P)
    cp, cm = mesh.interior_cell_p, mesh.interior_cell_m
    assert int((part[cp] != part[cm]).sum()) >= P - 1


def test_dd_refuses_a_cg_space():
    mesh_dev = DeviceMesh(rank=0, size=1, device=torch.device("cpu"),
                          backend="gloo")
    with pytest.raises(ValueError, match="DG temperature space"):
        DDProblem(R.CASES["box"][0](), R.config(1, family="CG"), mesh_dev)
