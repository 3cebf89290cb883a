"""Per-rank bodies of tests/test_torch_grid_shard.py (and of the card test
in tests/test_torch_cuda_kernels.py), run in processes that
`fem_glass_tempering_tpu_torch.parallel.comm.run_ranks` spawns: this module
imports the port alone (no JAX), and every body returns numpy data.

The step cases are the JAX package's tests/test_grid_ops.py:158-191 (the
12x6x3 plate, default solver), tests/test_grid_mg.py:87-149 (the 12x6x4
plate, `_cfg`: Chebyshev MG, CG rtol 1e-12, the increment forcing off; its
mixed-precision twin; Jacobi against MG) and the dry run's "gspmd-grid"
strategy (__graft_entry__.py:146-166: 12x6x4, f32, 2 steps)."""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.config import (
    FEConfig,
    ModelParams,
    OutputConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
from fem_glass_tempering_tpu_torch.io.sharded import read_sharded_series
from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
    stencil_matvec,
    stencil_matvec_halo,
)
from fem_glass_tempering_tpu_torch.ops.grid import GridHeatOperator
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.parallel.comm import (
    gather_rows,
    halo_exchange,
)
from fem_glass_tempering_tpu_torch.parallel.grid_shard import (
    GridShardedProblem,
)
from fem_glass_tempering_tpu_torch.solver.grid_mg import GridMG, RankGridMG

STEP_FIELDS = ("T", "Tf", "sigma")
# the GridMG apply: its residual and linearisation state (numpy, this seed)
MG_SEED = 14
MG_DIMS = (12, 6, 4)
MG_DT = 0.1


def mg_cfg(preconditioner="mg", cg_rtol=1e-12, steps=3, **extra):
    """tests/test_grid_mg.py `_cfg`."""
    return RunConfig(
        fe=FEConfig(T_family="CG", T_degree=1),
        time=TimeConfig(0.0, steps * 0.1, 0.1),
        solver=SolverConfig(linear_operator="stencil",
                            preconditioner=preconditioner,
                            mg_smoother="chebyshev", cg_rtol=cg_rtol,
                            newton_inc_forcing=0.0, **extra),
        output=OutputConfig(write_every=0, formats=()))


def ops_cfg():
    """tests/test_grid_ops.py's sharded-step config."""
    return RunConfig(fe=FEConfig(T_family="CG", T_degree=1),
                     time=TimeConfig(0.0, 0.3, 0.1),
                     solver=SolverConfig(linear_operator="stencil"),
                     output=OutputConfig(write_every=0, formats=()))


def dryrun_cfg():
    """__graft_entry__.py's `_build_problem(8, 4, 2, "float32")` config
    with the "gspmd-grid" strategy's preconditioner."""
    return RunConfig(
        fe=FEConfig(T_family="CG", T_degree=1, sigma_family="CG",
                    sigma_degree=1),
        time=TimeConfig(0.0, 0.1, 0.1),
        solver=SolverConfig(newton_rtol=1e-6, newton_atol=1e-6,
                            cg_rtol=1e-6, cg_max_it=500,
                            linear_operator="matrix_free",
                            preconditioner="mg", mg_smoother="chebyshev"),
        dtype="float32")


def mixed_cfg():
    cfg = mg_cfg()
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, cg_dtype="float32", newton_rtol=1e-12))


def plate(dims):
    return box_mesh_3d(*dims, 1.0, 1.0, 0.01)


# name -> (mesh dims, config, steps)
CASES = {
    "grid_ops": ((12, 6, 3), ops_cfg, 3),
    "grid_mg": ((12, 6, 4), mg_cfg, 3),
    "mixed": ((12, 6, 4), mixed_cfg, 3),
    "jacobi": ((12, 6, 4), lambda: mg_cfg("jacobi"), 2),
    "dryrun": ((12, 6, 4), dryrun_cfg, 2),
}


def step_case(mesh_dev, name) -> dict:
    """GridShardedProblem on this rank: `steps` steps from the initial
    state; the counts, this rank's rows of T and Tf, the gathered fields.
    The MG case also reports its counts after 2 steps (MG against
    Jacobi)."""
    dims, cfg, steps = CASES[name]
    gs = GridShardedProblem(plate(dims), cfg(), mesh_dev)
    st = gs.init_state()
    out = {"rows": gs.rows, "pad0": gs.pad0}
    if name == "grid_mg":
        st, ok2, ni2, ki2 = gs.run(st, 2)
        st, ok, ni, ki = gs.run(st, steps - 2)
        out.update(newton_2=ni2, cg_2=ki2)
        ok, ni, ki = ok and ok2, ni + ni2, ki + ki2
    else:
        st, ok, ni, ki = gs.run(st, steps)
    flat = gs.gather_state(st)
    out.update(ok=ok, newton=ni, cg=ki,
               rank_T=st.T.cpu().numpy(), rank_Tf=st.Tf.cpu().numpy(),
               **{f: getattr(flat, f).numpy() for f in STEP_FIELDS})
    if gs.rank_mg is not None:
        out["mg_sharded"] = list(gs.rank_mg.sharded)
    return out


def mg_inputs(pad0):
    """The GridMG apply's state and residual on the padded (13 + pad0,
    7, 5) grid: T physical in [700, 800) K (T_0 on the ghost planes),
    r standard normal everywhere."""
    rng = np.random.default_rng(MG_SEED)
    g = tuple(n + 1 for n in MG_DIMS)
    T = np.pad(700.0 + 100.0 * rng.random(g), [(0, pad0), (0, 0), (0, 0)],
               constant_values=ModelParams().T_0)
    r = rng.standard_normal((g[0] + pad0,) + g[1:])
    return T, r


def grid_mg(coarse, pad0, device="cpu", dtype=torch.float64):
    """The port's GridMG on the 12x6x4 plate's padded grid, frozen."""
    p = ModelParams()

    def heat(mesh):
        return HeatOperator(FunctionSpace(mesh, "CG", 1), p, MG_DT,
                            dtype=dtype, device=device)

    fine = GridHeatOperator(heat(plate(MG_DIMS)), pad_axis0=pad0,
                            tables=False)
    mg = GridMG(fine, heat, smoother="chebyshev", coarse=coarse)
    mg.freeze_rhos(MG_DT)
    return mg


def mg_apply(coarse, pad0, device="cpu") -> np.ndarray:
    """The unsharded GridMG apply to mg_inputs."""
    mg = grid_mg(coarse, pad0, device=device)
    T, r = (torch.as_tensor(a, device=device) for a in mg_inputs(pad0))
    apply = mg.preconditioner_g(mg.linearization_states_g(T), MG_DT)
    return apply(r).cpu().numpy()


def mg_rank_apply(mesh_dev, coarse) -> dict:
    """GridMG's rank form on this rank's planes of the padded layout of
    mesh_dev.size ranks, applied to mg_inputs; the result gathered."""
    P = mesh_dev.size
    pad0 = (-(MG_DIMS[0] + 1)) % P
    mg = grid_mg(coarse, pad0, device=mesh_dev.device)
    G0 = MG_DIMS[0] + 1 + pad0
    L = G0 // P
    rows = [(q * L, (q + 1) * L) for q in range(P)]
    rmg = RankGridMG(mg, mesh_dev, rows)
    lo, hi = rows[mesh_dev.rank]
    T, r = (torch.as_tensor(a[lo:hi], device=mesh_dev.device)
            for a in mg_inputs(pad0))
    apply = rmg.preconditioner(rmg.linearization_states(T), MG_DT)
    x = gather_rows(apply(r), slice(lo, hi), G0, mesh_dev)
    return dict(x=x.cpu().numpy(), sharded=list(rmg.sharded),
                rows=rmg.rows, pad0=pad0)


HALO_GRID = (13, 7, 5)
HALO_ROWS = ((0, 4), (4, 7), (7, 10), (10, 13))   # uneven, rank order


def halo_inputs(dtype=torch.float64, device="cpu"):
    """Seeded K2 tables and vector on the 13 x 7 x 5 grid: random values
    in every slot (both forms read the same x at each, zero past the
    grid's first and last plane)."""
    rng = np.random.default_rng(3)
    gx, M = HALO_GRID[0], HALO_GRID[1] * HALO_GRID[2]
    vals = torch.as_tensor(rng.standard_normal((27, gx, M)), dtype=dtype,
                           device=device)
    x = torch.as_tensor(rng.standard_normal(gx * M), dtype=dtype,
                        device=device)
    return vals, x


def halo_twin(mesh_dev, dtype=torch.float64) -> dict:
    """K2's halo form on this rank's uneven share of the 13 planes, its
    halo from comm.halo_exchange; the rows gathered, and the whole grid's
    product (the full-grid form) beside them."""
    vals, x = halo_inputs(dtype, mesh_dev.device)
    lo, hi = HALO_ROWS[mesh_dev.rank]
    M = vals.shape[-1]
    xe = halo_exchange(x.reshape(HALO_GRID[0], M)[lo:hi], mesh_dev)
    y = stencil_matvec_halo(vals[:, lo:hi].contiguous(), xe.reshape(-1),
                            (hi - lo,) + HALO_GRID[1:])
    full = stencil_matvec(vals, x, HALO_GRID)
    y_all = gather_rows(y.reshape(hi - lo, M), slice(lo, hi), HALO_GRID[0],
                        mesh_dev)
    return dict(halo=y_all.cpu().numpy(), full=full.cpu().numpy(),
                exchanges=halo_exchange.count)


# the sharded output's plate: 5 planes, at P = 4 three ghost planes, and
# rank 3 holds ghost planes only
IO_DIMS = (4, 3, 2)


def io_case(mesh_dev, work) -> dict:
    """solve() with the sharded writer (T and sigma every step) and a
    checkpoint after 2 steps, on the IO_DIMS plate; the files, the series'
    last T beside the gathered one. Rank 0 then creates `work`/io_ready
    (the checkpoint is complete: save_checkpoint returns once every rank
    has written)."""
    out = os.path.join(work, "io")
    cfg = dataclasses.replace(mg_cfg(steps=2), output=OutputConfig(
        output_dir=out, write_every=1, formats=("npz",),
        npz_fields=("T", "sigma"), checkpoint_every=2))
    gs = GridShardedProblem(plate(IO_DIMS), cfg, mesh_dev)
    st = gs.solve()
    flat = gs.gather_state(st)
    series = read_sharded_series(os.path.join(out, "sharded_series"))
    if mesh_dev.rank == 0:
        open(os.path.join(work, "io_ready"), "w").close()
    return dict(rows=gs.rows, pad0=gs.pad0, newton=gs.newton_iters,
                series_T=series["T"][-1], T=flat.T.numpy(),
                series_files=sorted(os.listdir(os.path.join(
                    out, "sharded_series"))),
                ckpt_files=sorted(os.listdir(os.path.join(
                    out, "sharded_ckpt_000002"))))


# the P = 4 cases, in two groups of ranks that run at once
GROUPS = (("grid_ops", "grid_mg"), ("mixed", "dryrun"))


def rank_body(mesh_dev, group, work) -> dict:
    """The P = 4 step cases of GROUPS[group] on this rank; the first group
    also applies GridMG's rank form and K2's halo form, the second first
    runs the sharded output (io_case)."""
    out = {"io": io_case(mesh_dev, work)} if group == 1 else {}
    out.update({name: step_case(mesh_dev, name) for name in GROUPS[group]})
    if group == 0:
        out["mg_auto"] = mg_rank_apply(mesh_dev, "auto")
        out["mg_smooth"] = mg_rank_apply(mesh_dev, "smooth")
        out["halo"] = halo_twin(mesh_dev)
    return out


def two_rank_body(mesh_dev) -> dict:
    """The rank form at P = 2, where every level of the 'smooth'
    hierarchy is sharded (axis 0 halved twice on the ranks' slabs)."""
    return {"mg_smooth": mg_rank_apply(mesh_dev, "smooth"),
            "mg_auto": mg_rank_apply(mesh_dev, "auto")}


def reference_body(mesh_dev, work) -> dict:
    """In one process: the unsharded ThermoViscoProblem runs of the step
    cases the tests compare with, the grid_mg case as a world-size-1
    GridShardedProblem, and io_case's checkpoint (8 planes at P = 4)
    loaded by a world-size-1 problem (5 planes)."""
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )

    out = {}
    for name in ("grid_ops", "grid_mg"):
        dims, cfg, steps = CASES[name]
        prob = ThermoViscoProblem(mesh=plate(dims), config=cfg(),
                                  device=mesh_dev.device)
        prob.setup()
        st = prob.solve()
        out[name] = {f: getattr(st, f).cpu().numpy() for f in STEP_FIELDS}
        out[name].update(newton=prob.diagnostics.newton_iters,
                         cg=prob.diagnostics.krylov_iters)
    out["world_size_1"] = step_case(mesh_dev, "grid_mg")
    # over one rank: 7,813 Jacobi-CG iterations in 2 steps, whose 4
    # collectives an iteration cost ~2-9 ms each over 4 gloo ranks on a
    # CPU host (127 s in all)
    out["jacobi"] = step_case(mesh_dev, "jacobi")
    gs = GridShardedProblem(plate(IO_DIMS), mg_cfg(steps=1), mesh_dev)
    ready, t0 = os.path.join(work, "io_ready"), time.monotonic()
    while not os.path.exists(ready):
        if time.monotonic() - t0 > 300:
            raise TimeoutError("io_case never wrote its checkpoint")
        time.sleep(0.05)
    try:
        gs.load_checkpoint(os.path.join(work, "io", "sharded_ckpt_000002"))
        out["io_refusal"] = ""
    except ValueError as e:
        out["io_refusal"] = str(e)
    out["io_grid"] = gs.grid
    return out


def card_body(mesh_dev) -> dict:
    """Two gloo ranks on one card: the grid_mg step case, and GridMG's
    'smooth' rank form at P = 2 (every level sharded) with K2's launches
    by form during its build and apply."""
    out = {"grid_mg": step_case(mesh_dev, "grid_mg")}
    full, halo = stencil_matvec.launches, stencil_matvec_halo.launches
    out["mg_smooth"] = mg_rank_apply(mesh_dev, "smooth")
    out["k2"] = dict(full=stencil_matvec.launches - full,
                     halo=stencil_matvec_halo.launches - halo)
    return out
