"""The dry run's "gspmd-mechanics" config (__graft_entry__.py:168-183: the
12x6x4 plate of 1.0 x 1.0 x 0.01, reference physics and xi, 2 steps) in
f64 on the port's grid-sharded step, and the reason the f32 config is not
held on more than one rank on the card (tests/test_torch_grid_shard_mech.py
holds the f32 config's counts to JAX's at P = 4 on the CPU).

The f64 run: P = 4 gloo ranks against one (tests/torch_grid_shard_mech_
ranks.py, no JAX): Newton and CG JAX's (14 / 14), the elasticity CG
within max(2, 2%), T bit for bit, sigma within 1e-4 of its max (the plate
is ill-conditioned: two f64 solves that each stop inside the CG's rtol
1e-8 part by up to ~1e-5 of the stress's max).

The stiffness: on that plate lambda_max / lambda_min of the elasticity
operator exceeds 1e9, far past 1 / eps(f32) ~ 8.4e6, and an f32 action
rounds the lowest mode by two orders more than its eigenvalue. So an f32
CG cannot resolve that mode: its solve stops near a true residual of
1e-4, its stress is ~10x the f64 one's, and whether p'Ap stays positive is the
rounding's luck (chip_ab.py dryrunmech logs it on the card).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_grid_shard_mech_ranks as M
import torch_grid_shard_ranks as R
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
from fem_glass_tempering_tpu_torch.models.mechanics import (
    GridMechanicsCoupling,
)
from fem_glass_tempering_tpu_torch.models.viscoelastic import (
    ViscoelasticEngine,
)
from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks
from fem_glass_tempering_tpu_torch.solver.grid_mg import (
    GridElastMG,
    RankGridElastMG,
)

P = 4
DRYRUN_COUNTS = (14, 14)
# the dry run's f32 |sigma| max on 8 TPU chips (MULTICHIP_r05.json)
JAX_F32_SIGMA_MAX = 4.390e-03


@pytest.fixture(scope="module")
def runs():
    """The f64 config over P = 4 gloo ranks and over one rank."""
    with ThreadPoolExecutor(2) as ex:
        four = ex.submit(run_ranks, M.dryrun64_body, P, "cpu", threads=1)
        one = ex.submit(run_ranks, M.dryrun64_body, 1, "cpu", threads=1)
        return four.result(), one.result()[0]


def test_dryrun_mechanics_f64_four_ranks_match_one(runs):
    """JAX's heat counts; the ranks in lockstep; T bit for bit, the
    elasticity CG within max(2, 2%) and sigma within 1e-4 of its max
    against the one rank (measured 1.7e-6; two ranks 1.0e-5)."""
    ranks, one = runs
    got = ranks[0]
    assert one["ok"] and (one["newton"], one["cg"]) == DRYRUN_COUNTS
    for r in ranks:
        assert r["ok"] and (r["newton"], r["cg"]) == DRYRUN_COUNTS
        assert r["mech"] == got["mech"]
        assert np.array_equal(r["sigma"], got["sigma"])
    e, e1 = sum(got["mech"]), sum(one["mech"])
    assert abs(e - e1) <= max(2, 0.02 * e1), (got["mech"], one["mech"])
    for f in ("T", "Tf"):
        assert np.array_equal(got[f], one[f]), f
    scale = float(np.abs(one["sigma"]).max())
    assert float(np.abs(got["sigma"] - one["sigma"]).max()) <= 1e-4 * scale
    # the f64 stress is an order of magnitude below the f32 run's
    assert scale < 0.2 * JAX_F32_SIGMA_MAX


def _dense(op, tbl, dtype):
    """The operator's matrix from its table action on the unit vectors."""
    n = int(np.prod(op.grid)) * op.d
    eye = torch.eye(n, dtype=dtype).reshape((n,) + op.grid + (op.d,))
    return torch.stack([op.matvec_table_g(tbl, eye[k]).reshape(-1)
                        for k in range(n)], dim=1)


def test_dryrun_plate_stiffness_outruns_f32():
    """The elasticity operator of the dry run's plate at its first step's
    moduli (xi = 0), built in f64: lambda_max / lambda_min > 1e9 (8.3e9
    measured), and the f32 operator's action on the lowest mode is off by
    more than 30 lambda_min (134 measured)."""
    dims, cfg_fn, _ = M.CASES["dryrun64"]
    cfg = cfg_fn()
    mesh = R.plate(dims)
    fs_T = FunctionSpace(mesh, "CG", 1)
    fs_S = FunctionSpace(mesh, "CG", 1, value_shape=(3, 3))
    ops = {}
    for dtype in (torch.float64, torch.float32):
        eng = ViscoelasticEngine(fs_T, fs_S, cfg.params, cfg.time.dt,
                                 physics_mode=cfg.physics_mode,
                                 shift_function=cfg.shift_function,
                                 xi_formula=cfg.xi_formula, dtype=dtype,
                                 device="cpu")
        mc = GridMechanicsCoupling(fs_S, eng, dtype=dtype,
                                   preconditioner="jacobi")
        G, K = mc._moduli_at(torch.zeros(mc.el.grid, dtype=dtype))
        ops[dtype] = (mc.el, mc.el.stencil_table_g(G, K))
    el, tbl = ops[torch.float64]
    A = _dense(el, tbl, torch.float64).numpy()
    np.testing.assert_allclose(A, A.T, rtol=0, atol=1e-12 * np.abs(A).max())
    w, V = np.linalg.eigh(A)
    assert w[0] > 0 and w[-1] / w[0] > 1e9, (w[0], w[-1])
    el32, tbl32 = ops[torch.float32]
    v = V[:, 0]
    Av32 = el32.matvec_table_g(tbl32, torch.as_tensor(
        v, dtype=torch.float32).reshape(el32.grid + (3,)))
    err = np.linalg.norm(Av32.double().numpy().reshape(-1) - w[0] * v)
    assert err > 30 * w[0], (err, w[0])


def test_rank_form_needs_the_tables():
    """The rank forms act through the block tables only: a cycle or
    coupling without them is refused before any collective."""
    mesh = box_mesh_3d(4, 3, 2, 1.0, 1.0, 0.1)
    mg = GridElastMG(M.elastic_op(mesh), M.elastic_op, use_tables=False)
    with pytest.raises(ValueError, match="block tables"):
        RankGridElastMG(mg, None, [(0, 5)])
    cfg = M.dryrun64_cfg()
    fs_S = FunctionSpace(mesh, "CG", 1, value_shape=(3, 3))
    eng = ViscoelasticEngine(FunctionSpace(mesh, "CG", 1), fs_S, cfg.params,
                             cfg.time.dt, xi_formula=cfg.xi_formula,
                             dtype=torch.float64, device="cpu")
    mc = GridMechanicsCoupling(fs_S, eng, dtype=torch.float64,
                               use_tables=False)
    with pytest.raises(ValueError, match="block tables"):
        mc.rank_form(None, [(0, 5)])
