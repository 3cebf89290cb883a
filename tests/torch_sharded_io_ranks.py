"""Per-rank bodies of tests/test_torch_sharded_io.py, run in processes that
`fem_glass_tempering_tpu_torch.parallel.comm.run_ranks` spawns, and the
multi-process worker it starts as two subprocesses (`python
torch_sharded_io_ranks.py PID PORT OUT`): this module imports the port
alone (no JAX), and every body returns numpy data.

The step cases are the JAX package's tests/test_sharded_io.py (`_cfg`: the
12x6x3 plate, 13 planes, 3 steps, npz of T, Tf and sigma; `_dg_cfg`, its
DG-1 twin, on a 10x6x3 plate: 10 cell layers padded to 12 and 11 node
planes padded to 12 at P = 4) and tests/test_multihost.py (the 12x6x3
plate, 2 steps, no output); the mechanics case is
tests/torch_grid_shard_mech_ranks.py's plate (8x6x4, f64, equilibrium,
corrected physics, trapezoid xi).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.config import (
    FEConfig,
    OutputConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
from fem_glass_tempering_tpu_torch.io.sharded import (
    ShardedSeriesWriter,
    read_sharded_series,
)
from fem_glass_tempering_tpu_torch.models.viscoelastic import ViscoState
from fem_glass_tempering_tpu_torch.parallel import comm, multihost
from fem_glass_tempering_tpu_torch.parallel.grid_shard import (
    GridShardedProblem,
)

PLATE = (12, 6, 3)
DG_PLATE = (10, 6, 3)
SERIES_FIELDS = ("T", "Tf", "sigma")
# a Newton tolerance that resolves jac_every "auto" to 5: the operators
# of a chunk are frozen at its start, so solve()'s chunks of write_every
# steps take other counts than one run() of every step
CHUNKED = dict(newton_rtol=1e-6)
WAIT_S = 240.0


def plate(dims=PLATE):
    return box_mesh_3d(*dims, 1.0, 1.0, 0.01)


def io_cfg(out, write_every=1, checkpoint_every=0, steps=3, **solver):
    """tests/test_sharded_io.py `_cfg` (extra solver settings allowed)."""
    return RunConfig(
        fe=FEConfig(T_family="CG", T_degree=1),
        time=TimeConfig(0.0, steps * 0.1, 0.1),
        solver=SolverConfig(linear_operator="stencil", **solver),
        output=OutputConfig(output_dir=str(out), write_every=write_every,
                            formats=("npz",), npz_fields=SERIES_FIELDS,
                            checkpoint_every=checkpoint_every))


def dg_io_cfg(out, write_every=1, checkpoint_every=0):
    """tests/test_sharded_io.py `_dg_cfg`."""
    return RunConfig(
        fe=FEConfig(T_family="DG", T_degree=1),
        time=TimeConfig(0.0, 0.3, 0.1),
        solver=SolverConfig(linear_operator="stencil", newton_rtol=1e-10,
                            cg_rtol=1e-10, cg_max_it=300),
        output=OutputConfig(output_dir=str(out), write_every=write_every,
                            formats=("npz",), npz_fields=SERIES_FIELDS,
                            checkpoint_every=checkpoint_every),
        dtype="float64")


def multihost_cfg():
    """tests/test_multihost.py's config."""
    return RunConfig(fe=FEConfig(T_family="CG", T_degree=1),
                     time=TimeConfig(0.0, 0.2, 0.1),
                     solver=SolverConfig(linear_operator="stencil"),
                     output=OutputConfig(write_every=0, formats=()))


def host(state: ViscoState) -> dict:
    return {f: getattr(state, f).cpu().numpy() for f in ViscoState._fields
            if getattr(state, f) is not None}


def bits_equal(a: ViscoState, b: ViscoState) -> dict:
    """Per field: the same dtype, shape and bits."""
    return {f: bool(getattr(a, f).dtype == getattr(b, f).dtype
                    and torch.equal(getattr(a, f), getattr(b, f)))
            for f in ViscoState._fields if getattr(a, f) is not None}


def collectives() -> int:
    return comm.all_reduce_sum.count + comm.all_reduce_max.count


def wait_for(path: str) -> None:
    """Wait until `path` exists (the test process writes it)."""
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > WAIT_S:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)
    with open(path) as fh:
        if fh.read().strip() != "ok":
            raise RuntimeError(f"the test process failed before {path}")


# ---- P = 4 -----------------------------------------------------------------
def series_case(gs, work) -> dict:
    """tests/test_sharded_io.py:32 and :73: solve() with the writer and a
    checkpoint every 2 steps; the series read back, the gathered state,
    the files; and the collectives of one more write (none)."""
    out = gs.config.output.output_dir
    mesh_dev = gs.comm
    st = gs.solve()
    flat = gs.gather_state(st)
    series = read_sharded_series(os.path.join(out, "sharded_series"))
    w = ShardedSeriesWriter(os.path.join(work, f"count_{mesh_dev.rank}"),
                            fields=tuple(f for f in ViscoState._fields[1:]
                                         if getattr(st, f) is not None),
                            grid=gs.grid, pad0=gs.pad0, rank=mesh_dev.rank,
                            world_size=mesh_dev.size)
    c0 = collectives()
    w.write(0.3, st)
    return dict(newton=gs.newton_iters, cg=gs.krylov_iters, rows=gs.rows,
                grid=gs.grid, pad0=gs.pad0, series=series,
                flat={f: getattr(flat, f).numpy() for f in SERIES_FIELDS},
                files=sorted(os.listdir(os.path.join(out, "sharded_series"))),
                ckpts=sorted(d for d in os.listdir(out)
                             if d.startswith("sharded_ckpt")),
                write_collectives=collectives() - c0,
                written=sorted(os.listdir(w.dir)))


def resume_case(gs, work) -> dict:
    """tests/test_sharded_io.py:50: run(2) -> save -> load -> run(1)
    against run(3) from the start (jac_every resolves to 1 at rtol
    1e-12, so the chunks do not matter). The saved state gathered in the
    padded layout, for JAX's loader."""
    st2, ok2, _, _ = gs.run(gs.init_state(), 2)
    ck = os.path.join(work, "port_ckpt")
    c0 = collectives()
    gs.save_checkpoint(ck, st2, extra={"t": 0.2})
    save_collectives = collectives() - c0
    st2b = gs.load_checkpoint(ck)
    load_collectives = collectives() - c0 - save_collectives
    st3r, ok_r, _, _ = gs.run(st2b, 1)
    st3, ok3, _, _ = gs.run(gs.init_state(), 3)
    return dict(ok=ok2 and ok_r and ok3, loaded_bits=bits_equal(st2b, st2),
                loaded_device=str(st2b.T.device), loaded_t=float(st2b.t),
                save_collectives=save_collectives,
                load_collectives=load_collectives,
                resumed=host(gs.gather_state(st3r)),
                straight=host(gs.gather_state(st3)),
                saved_padded=multihost.gather_to_host(st2, gs.comm)._asdict(),
                files=sorted(os.listdir(ck)))


def chunked_case(mesh_dev, work) -> dict:
    """solve() in chunks of write_every = 1 with a checkpoint every 2
    steps, at a tolerance where jac_every is 5; and run(3) in one chunk
    from the start, beside it."""
    out = os.path.join(work, "chunked")
    gs = GridShardedProblem(plate(), io_cfg(out, checkpoint_every=2,
                                            **CHUNKED), mesh_dev)
    st = gs.solve()
    flat = gs.gather_state(st)
    _, ok, ni, ki = gs.run(gs.init_state(), 3)
    return dict(newton=gs.newton_iters, cg=gs.krylov_iters, run_ok=ok,
                run_newton=ni, run_cg=ki,
                jac_every=gs.config.solver.resolved_jac_every(),
                **{f: getattr(flat, f).numpy() for f in ("T", "Tf")})


def jax_ckpt_case(gs, work) -> dict:
    """JAX's checkpoint of step 2 (written on its 8 virtual devices, 16
    planes) loaded at P = 4 (16 planes) and stepped once."""
    wait_for(os.path.join(work, "jax_ckpt_ready"))
    st = gs.load_checkpoint(os.path.join(work, "jax_ckpt"))
    st3, ok, ni, ki = gs.run(st, 1)
    return dict(ok=ok, t=float(st.t), T=gs.gather_state(st3).T.numpy())


def rank_body(mesh_dev, work) -> dict:
    """Every P = 4 case; one problem serves all but the chunked one (its
    setup costs ~4 s at P = 4 on a CPU host, a step ~0.35 s)."""
    gs = GridShardedProblem(plate(), io_cfg(os.path.join(work, "series"),
                                            checkpoint_every=2), mesh_dev)
    return dict(series=series_case(gs, work), resume=resume_case(gs, work),
                chunked=chunked_case(mesh_dev, work),
                jax_ckpt=jax_ckpt_case(gs, work))


def dg_body(mesh_dev, work) -> dict:
    """DG-1 T (cell-grid T-space fields, 2 ghost cell layers and 1 ghost
    node plane at P = 4): tests/test_sharded_io.py:97 (solve() with the
    writer and a checkpoint at step 2; the series read back against the
    gathered state), :117 (run(2) -> save -> load -> run(1) against
    run(3)), and JAX's DG checkpoint of step 2 (4 devices) loaded and
    stepped once."""
    out = os.path.join(work, "dg_series")
    gs = GridShardedProblem(plate(DG_PLATE), dg_io_cfg(out,
                                                       checkpoint_every=2),
                            mesh_dev)
    st = gs.solve()
    flat = gs.gather_state(st)
    series = read_sharded_series(os.path.join(out, "sharded_series"))
    st2, ok2, _, _ = gs.run(gs.init_state(), 2)
    ck = os.path.join(work, "port_dg_ckpt")
    gs.save_checkpoint(ck, st2, extra={"t": 0.2})
    st2b = gs.load_checkpoint(ck)
    st3r, ok_r, _, _ = gs.run(st2b, 1)
    st3, ok3, _, _ = gs.run(gs.init_state(), 3)
    wait_for(os.path.join(work, "jax_dg_ckpt_ready"))
    stj = gs.load_checkpoint(os.path.join(work, "jax_dg_ckpt"))
    stj3, ok_j, _, _ = gs.run(stj, 1)
    return dict(
        ok=ok2 and ok_r and ok3, ok_jax=ok_j, newton=gs.newton_iters,
        cg=gs.krylov_iters, cell_pad0=gs.cell_pad0, pad0=gs.pad0,
        cell_rows=gs.cell_rows, series=series,
        flat={f: getattr(flat, f).numpy() for f in SERIES_FIELDS},
        files=sorted(os.listdir(os.path.join(out, "sharded_series"))),
        ckpts=sorted(d for d in os.listdir(out)
                     if d.startswith("sharded_ckpt")),
        loaded_bits=bits_equal(st2b, st2),
        resumed=host(gs.gather_state(st3r)),
        straight=host(gs.gather_state(st3)),
        saved_padded=multihost.gather_to_host(st2, gs.comm)._asdict(),
        jax_t=float(stj.t), jax_T=gs.gather_state(stj3).T.numpy())


# ---- P = 2: mechanics ------------------------------------------------------
def mech_body(mesh_dev, work) -> dict:
    """Equilibrium mechanics: run(2) -> save -> load -> run(1) against
    run(1) from the in-memory state, every field (du included)."""
    import torch_grid_shard_mech_ranks as M

    from threadpoolctl import threadpool_limits
    with threadpool_limits(limits=1):
        gs = GridShardedProblem(plate((8, 6, 4)), M.plate_cfg(), mesh_dev)
        st2, ok2, _, _ = gs.run(gs.init_state(), 2)
        ck = os.path.join(work, "mech_ckpt")
        gs.save_checkpoint(ck, st2)
        st2b = gs.load_checkpoint(ck)
        a, ok_a, ni_a, ki_a = gs.run(st2b, 1)
        mech_a = list(gs.last_mech_iters)
        b, ok_b, ni_b, ki_b = gs.run(st2, 1)
        mech_b = list(gs.last_mech_iters)
    return dict(ok=ok2 and ok_a and ok_b, loaded_bits=bits_equal(st2b, st2),
                resumed_bits=bits_equal(a, b), has_du=a.du is not None,
                counts=((ni_a, ki_a, mech_a), (ni_b, ki_b, mech_b)),
                du_max=float(a.du.abs().max()))


# ---- one process -----------------------------------------------------------
def reference_body(mesh_dev, work) -> dict:
    """The unsharded run of the multi-process case, and JAX's checkpoint
    (16 planes) refused by a world-size-1 problem (13 planes)."""
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )
    prob = ThermoViscoProblem(mesh=plate(), config=multihost_cfg(),
                              device=mesh_dev.device)
    prob.setup()
    T = prob.solve().T.cpu().numpy()
    wait_for(os.path.join(work, "jax_ckpt_ready"))
    gs = GridShardedProblem(plate(), io_cfg(work, write_every=0), mesh_dev)
    try:
        gs.load_checkpoint(os.path.join(work, "jax_ckpt"))
        refusal = ""
    except ValueError as e:
        refusal = str(e)
    return dict(T=T, refusal=refusal, grid=gs.grid)


# ---- the multi-process worker ---------------------------------------------
def multihost_main(pid: int, port: str, out: str) -> None:
    """tests/test_multihost.py's worker: one of two processes joined
    through multihost.initialize at an explicit coordinator (gloo, the
    CPU), 2 steps of make_multihost_problem, the state gathered to every
    process with gather_to_host; process 0 saves T (ghost planes
    dropped) to `out`."""
    torch.set_num_threads(1)
    mesh_dev = multihost.initialize(f"localhost:{port}", 2, pid,
                                    backend="gloo", device="cpu")
    try:
        sp = multihost.make_multihost_problem(plate(), multihost_cfg())
        st, ok, ni, ki = sp.run(sp.init_state(), 2)
        assert ok, "Newton failed in the multi-process run"
        g = multihost.gather_to_host(st)
        n = sp.fs_T.n_scalar_dofs
        if pid == 0:
            np.savez(out, T=g.T[:n], padded_rows=g.T.shape[0], newton=ni,
                     cg=ki, world=multihost.global_device_mesh().size)
        print(f"proc {pid}: OK newton={ni} cg={ki}", flush=True)
    finally:
        mesh_dev.close()


if __name__ == "__main__":
    multihost_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
