"""Per-rank bodies of tests/test_torch_grid_shard_mech.py, run in processes
that `fem_glass_tempering_tpu_torch.parallel.comm.run_ranks` spawns: this
module imports the port alone (no JAX), and every body returns numpy data.

The step cases are the JAX package's tests/test_grid_elasticity.py:75-111
(the 8x6x4 plate, 2 steps, corrected physics, trapezoid xi, equilibrium
mechanics) and the dry run's "gspmd-mechanics" strategy
(__graft_entry__.py:168-183: the "gspmd-grid" config with mechanics,
12x6x4, f32, 2 steps). The V-cycle cases hold GridElastMG's rank form to
the unsharded cycle on one padded grid: a thin plate (line smoother along
axis 2) with a smoothed and a dense coarse level, a cube (point smoother)
with each, and a plate thin along axis 0 (line smoother along axis 0: the
levels run replicated).

Each body limits numpy's BLAS to one thread (threadpoolctl): the ranks
share the host's cores, and the dense coarse inverses' BLAS threads would
spin against each other. The unsharded cycle the rank form is held to is
computed under the same limit, in the ranks' process."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

import torch_grid_shard_ranks as R
from fem_glass_tempering_tpu_torch.config import (
    FEConfig,
    OutputConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
from fem_glass_tempering_tpu_torch.ops.grid_elasticity import (
    GridElasticityOperator,
)
from fem_glass_tempering_tpu_torch.parallel.comm import gather_rows
from fem_glass_tempering_tpu_torch.parallel.grid_shard import (
    GridShardedProblem,
)
from fem_glass_tempering_tpu_torch.solver.grid_mg import (
    GridElastMG,
    RankGridElastMG,
)

STEP_FIELDS = ("T", "Tf", "sigma", "total_strain", "du")


def plate_cfg():
    """tests/test_grid_elasticity.py:89-96."""
    return RunConfig(
        fe=FEConfig(T_family="CG", T_degree=1),
        time=TimeConfig(0.0, 0.2, 0.1),
        solver=SolverConfig(linear_operator="stencil"),
        output=OutputConfig(write_every=0, formats=()),
        mechanics="equilibrium", physics_mode="corrected",
        xi_formula="trapezoid")


def dryrun_cfg():
    """The dry run's "gspmd-mechanics" config (reference physics and xi,
    f32)."""
    return dataclasses.replace(R.dryrun_cfg(), mechanics="equilibrium")


def dryrun64_cfg():
    """That config in f64."""
    return dataclasses.replace(dryrun_cfg(), dtype="float64")


# name -> (mesh dims, config, steps)
CASES = {
    "plate": ((8, 6, 4), plate_cfg, 2),
    "dryrun": ((12, 6, 4), dryrun_cfg, 2),
    "dryrun64": ((12, 6, 4), dryrun64_cfg, 2),
}


def step_case(mesh_dev, name) -> dict:
    """GridShardedProblem on this rank: `steps` steps from the initial
    state; the counts (heat and elasticity), the layout, this rank's rows
    of T and du, the gathered fields."""
    dims, cfg, steps = CASES[name]
    gs = GridShardedProblem(R.plate(dims), cfg(), mesh_dev)
    st, ok, ni, ki = gs.run(gs.init_state(), steps)
    flat = gs.gather_state(st)
    return dict(ok=ok, newton=ni, cg=ki, mech=list(gs.last_mech_iters),
                rows=gs.rows, pad0=gs.pad0,
                mg_sharded=list(gs.mech.mg.sharded),
                rank_T=st.T.cpu().numpy(), rank_du=st.du.cpu().numpy(),
                **{f: getattr(flat, f).double().numpy()
                   for f in STEP_FIELDS})


# ---- GridElastMG's rank form ---------------------------------------------
# name -> (mesh dims, lengths, frozen moduli (None: smoothed coarse level))
MG_CASES = {
    "column": ((16, 16, 6), (1.0, 1.0, 0.01), None),
    "column_dense": ((16, 16, 6), (1.0, 1.0, 0.01), (3.0, 5.0)),
    "point": ((12, 12, 12), (1.0, 1.0, 1.0), None),
    "point_dense": ((12, 12, 12), (1.0, 1.0, 1.0), (3.0, 5.0)),
    "thin_axis0": ((4, 12, 12), (0.01, 1.0, 1.0), None),
}
MG_SEED = 7


def elastic_op(mesh, pad0=0, device="cpu"):
    return GridElasticityOperator(
        FunctionSpace(mesh, "CG", 1, value_shape=(3, 3)),
        dtype=torch.float64, pad_axis0=pad0, device=device)


def mg_pad(name, P):
    return (-(MG_CASES[name][0][0] + 1)) % P


def mg_build(name, pad0, device="cpu"):
    """The padded GridElastMG of case `name` and its inputs (seed
    MG_SEED): per-cell-quadrature G in [1, 2), K in [2, 3), r standard
    normal on every row of the padded grid."""
    dims, lengths, frozen = MG_CASES[name]
    fine = elastic_op(box_mesh_3d(*dims, *lengths), pad0, device)
    mg = GridElastMG(fine, lambda m: elastic_op(m, device=device),
                     frozen_moduli=frozen)
    rng = np.random.default_rng(MG_SEED)
    q = fine.qw1.shape[0]
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    G = t(1.0 + rng.random(fine.dims + (q,)))
    K = t(2.0 + rng.random(fine.dims + (q,)))
    r = t(rng.standard_normal(fine.grid + (3,)))
    return mg, G, K, r


def mg_apply(name, pad0) -> np.ndarray:
    """The unsharded padded cycle's apply to the case's r."""
    mg, G, K, r = mg_build(name, pad0)
    return mg.preconditioner_g(G, K)(r).numpy()


def mg_rank_apply(mesh_dev, name) -> dict:
    """GridElastMG's rank form on this rank's planes of the padded layout
    of mesh_dev.size ranks, given the coefficients of its slab's window
    cells; the result gathered; on rank 0 also the unsharded cycle's."""
    P = mesh_dev.size
    pad0 = mg_pad(name, P)
    mg, G, K, r = mg_build(name, pad0, mesh_dev.device)
    G0 = mg.ops[0].grid[0]
    L = G0 // P
    rows = [(q * L, (q + 1) * L) for q in range(P)]
    rmg = RankGridElastMG(mg, mesh_dev, rows)
    lo, hi = rows[mesh_dev.rank]
    (c0, c1), _ = rmg._cells(0)
    apply = rmg.preconditioner(G[c0:c1], K[c0:c1])
    x = gather_rows(apply(r[lo:hi]), slice(lo, hi), G0, mesh_dev)
    out = dict(x=x.cpu().numpy(), sharded=list(rmg.sharded), pad0=pad0,
               smoothers=list(mg._smoothers),
               dense=mg.coarse_inv is not None)
    if mesh_dev.rank == 0:
        out["unsharded"] = mg.preconditioner_g(G, K)(r).cpu().numpy()
    return out


def one_blas_thread(fn):
    @functools.wraps(fn)
    def body(*args):
        from threadpoolctl import threadpool_limits
        with threadpool_limits(limits=1):
            return fn(*args)
    return body


@one_blas_thread
def rank_body(mesh_dev) -> dict:
    """At P = 4: both step cases and every V-cycle case."""
    out = {name: step_case(mesh_dev, name) for name in ("plate", "dryrun")}
    out.update({f"mg_{name}": mg_rank_apply(mesh_dev, name)
                for name in MG_CASES})
    return out


@one_blas_thread
def two_rank_body(mesh_dev) -> dict:
    """At P = 2: every V-cycle case, and the plate's step."""
    out = {f"mg_{name}": mg_rank_apply(mesh_dev, name)
           for name in MG_CASES}
    out["plate"] = step_case(mesh_dev, "plate")
    return out


@one_blas_thread
def dryrun64_body(mesh_dev) -> dict:
    """The dry run's mechanics config in f64."""
    return step_case(mesh_dev, "dryrun64")


def card_body(mesh_dev) -> dict:
    """Two gloo ranks on one card: the plate's step and the rank form of
    the point-smoothed V-cycle (with its unsharded apply on rank 0)."""
    return dict(plate=step_case(mesh_dev, "plate"),
                mg_point=mg_rank_apply(mesh_dev, "point"))


@one_blas_thread
def reference_body(mesh_dev) -> dict:
    """In one process: the unsharded ThermoViscoProblem run of the plate
    case, and the plate case as a world-size-1 GridShardedProblem."""
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )

    dims, cfg, _ = CASES["plate"]
    prob = ThermoViscoProblem(mesh=R.plate(dims), config=cfg(),
                              device=mesh_dev.device)
    prob.setup()
    st = prob.solve()
    out = {"unsharded": dict(
        newton=prob.diagnostics.newton_iters,
        cg=prob.diagnostics.krylov_iters,
        mech=prob.diagnostics.mech_krylov_iters,
        **{f: getattr(st, f).numpy() for f in STEP_FIELDS})}
    out["world_size_1"] = step_case(mesh_dev, "plate")
    return out
