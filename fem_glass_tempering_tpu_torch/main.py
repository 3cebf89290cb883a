"""Command-line driver: the reference's main.py as a command-line tool.

Counterpart of fem_glass_tempering_tpu/main.py, flag for flag, plus
`--device`: the run goes on the GPU (`cuda`, the default, which raises
where no GPU is visible) unless `--device cpu` asks for the CPU. A JSON
config file written by either package's `RunConfig.to_json` drives both
command lines. The last line printed is one JSON object with the run's
time and iteration counts.

Examples:
  python -m fem_glass_tempering_tpu_torch.main                # default 1D run
  python -m fem_glass_tempering_tpu_torch.main --problem-dim 3 --nx 32 --steps 100
  python -m fem_glass_tempering_tpu_torch.main --device cpu --steps 3 --output-dir /tmp/out
  python -m fem_glass_tempering_tpu_torch.main --mesh mesh1d.msh --write-mesh out.msh
  torchrun --standalone --nproc-per-node 2 -m fem_glass_tempering_tpu_torch.main \
      --shard --device cpu --problem-dim 2 --t-element DG1 --nx 8 --ny 8 --steps 3
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fem_glass_tempering_tpu_torch",
        description="PyTorch + CUDA coupled thermo-viscoelastic glass "
                    "tempering solver",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default; raises "
                        "without a GPU) or cpu")
    p.add_argument("--config", help="JSON RunConfig file")
    p.add_argument("--mesh", help="gmsh .msh file to load")
    p.add_argument("--problem-dim", type=int, choices=(1, 2, 3), default=1)
    p.add_argument("--nx", type=int, default=32)
    p.add_argument("--ny", type=int, default=32)
    p.add_argument("--nz", type=int, default=8)
    p.add_argument("--steps", type=int, help="override number of time steps")
    p.add_argument("--dt", type=float)
    p.add_argument("--t-end", type=float, help="override end time")
    p.add_argument("--t-element", default=None, help="T element, e.g. DG1 / CG2")
    p.add_argument("--sigma-element", default=None)
    p.add_argument("--physics-mode", choices=("reference", "corrected"))
    p.add_argument("--mechanics", choices=("none", "equilibrium"))
    p.add_argument("--xi-formula", choices=("reference", "trapezoid"))
    p.add_argument("--dtype", choices=("float64", "float32"))
    p.add_argument("--dirichlet-bc", action="store_true")
    p.add_argument("--output-dir", default="output")
    p.add_argument("--write-every", type=int)
    p.add_argument("--formats", default=None,
                   help="comma list: npz,vtu,xdmf (xdmf needs h5py)")
    p.add_argument("--checkpoint-every", type=int)
    p.add_argument("--resume", help="checkpoint file to resume from")
    p.add_argument("--shard", action="store_true",
                   help="shard the heat operator's cells over the ranks of "
                        "a torch.distributed group (under torchrun: its "
                        "ranks, NCCL for --device cuda, gloo for cpu; "
                        "else one rank); rank 0 writes the output")
    p.add_argument("--write-mesh", help="write the mesh as gmsh 4.1 and exit")
    p.add_argument("--progress", action="store_true")
    p.add_argument("--profile-dir",
                   help="write a torch.profiler trace of the solve "
                        "(DIR/trace.json)")
    p.add_argument("--use-pallas", action="store_true",
                   help="sets use_pallas in the config, for parity with the "
                        "JAX command line; the hand-written CUDA kernels "
                        "run on the GPU whatever its value")
    p.add_argument("--preconditioner",
                   choices=("auto", "jacobi", "mg", "amg", "none"),
                   help="CG preconditioner: 'auto' (default) picks the "
                        "GAMG equivalent — geometric MG / DG p-MG on box "
                        "meshes, smoothed-aggregation AMG elsewhere")
    p.add_argument("--linear-operator",
                   choices=("matrix_free", "assembled", "stencil"))
    p.add_argument("--mg-max-levels", type=int,
                   help="cap on the geometric-MG hierarchy depth (0 = "
                        "coarsen to the floor)")
    p.add_argument("--mg-coarse", choices=("auto", "smooth", "dense"),
                   help="coarsest-level solve: auto = stop at <=4096 "
                        "nodes and solve exactly with a frozen dense "
                        "inverse; smooth = Chebyshev sweeps at the "
                        "full-depth floor; dense = dense inverse at an "
                        "explicit --mg-max-levels cap")
    p.add_argument("--cg-dtype", choices=("same", "float32"),
                   help="float32 runs the inner CG in f32 under an f64 "
                        "outer Newton (mixed precision)")
    p.add_argument("--mech-inc-rtol", type=float,
                   help="equilibrium-mechanics increment-relative CG "
                        "tolerance (default auto = 0.01; 0 = off, fixed "
                        "tolerance only)")
    p.add_argument("--newton-inc-forcing", type=float,
                   help="heat-chain increment-relative inexact-Newton "
                        "forcing (default auto = 0.05; 0 = off, every "
                        "inner CG solves to cg-rtol)")
    p.add_argument("--heat-form", choices=("reference", "physical"),
                   help="'physical' assembles the dimensional rho*cp/k "
                        "equation instead of the reference's "
                        "non-dimensionalized form")
    return p


def _parse_element(s: str) -> tuple[str, int]:
    fam = s[:2].upper()
    return fam, int(s[2:] or 1)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from fem_glass_tempering_tpu_torch.config import RunConfig
    from fem_glass_tempering_tpu_torch.device import resolve_device
    from fem_glass_tempering_tpu_torch.fem.mesh import (
        box_mesh_2d, box_mesh_3d, read_msh, reference_glass_mesh_1d,
    )
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    device = resolve_device(args.device)
    if (args.shard and device.type == "cuda" and device.index is None
            and "LOCAL_RANK" in os.environ):
        # torchrun: one card a rank on a host
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))

    cfg = RunConfig()
    if args.config:
        with open(args.config) as f:
            cfg = RunConfig.from_json(f.read())

    fe = cfg.fe
    if args.t_element:
        fam, deg = _parse_element(args.t_element)
        fe = dataclasses.replace(fe, T_family=fam, T_degree=deg)
    if args.sigma_element:
        fam, deg = _parse_element(args.sigma_element)
        fe = dataclasses.replace(fe, sigma_family=fam, sigma_degree=deg)
    cfg = dataclasses.replace(cfg, fe=fe)

    tc = cfg.time
    if args.dt:
        tc = dataclasses.replace(tc, dt=args.dt)
    if args.t_end is not None:
        tc = dataclasses.replace(tc, t_end=args.t_end)
    if args.steps:
        tc = dataclasses.replace(tc, t_end=tc.t_start + args.steps * tc.dt)
    cfg = dataclasses.replace(cfg, time=tc)

    oc = cfg.output
    oc = dataclasses.replace(oc, output_dir=args.output_dir)
    if args.write_every is not None:
        oc = dataclasses.replace(oc, write_every=args.write_every)
    if args.formats is not None:
        oc = dataclasses.replace(
            oc, formats=tuple(f for f in args.formats.split(",") if f))
    if args.checkpoint_every is not None:
        oc = dataclasses.replace(oc, checkpoint_every=args.checkpoint_every)
    cfg = dataclasses.replace(cfg, output=oc)
    if args.physics_mode:
        cfg = dataclasses.replace(cfg, physics_mode=args.physics_mode)
    if args.mechanics:
        cfg = dataclasses.replace(cfg, mechanics=args.mechanics)
    if args.xi_formula:
        cfg = dataclasses.replace(cfg, xi_formula=args.xi_formula)
    if args.dtype:
        cfg = dataclasses.replace(cfg, dtype=args.dtype)
    if args.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=True)
    if args.heat_form:
        cfg = dataclasses.replace(cfg, heat_form=args.heat_form)
    sc = cfg.solver
    if args.preconditioner:
        sc = dataclasses.replace(sc, preconditioner=args.preconditioner)
    if args.linear_operator:
        sc = dataclasses.replace(sc, linear_operator=args.linear_operator)
    if args.cg_dtype:
        sc = dataclasses.replace(sc, cg_dtype=args.cg_dtype)
    if args.mg_max_levels is not None:
        sc = dataclasses.replace(sc, mg_max_levels=args.mg_max_levels)
    if args.mg_coarse:
        sc = dataclasses.replace(sc, mg_coarse=args.mg_coarse)
    if args.mech_inc_rtol is not None:
        sc = dataclasses.replace(sc, mech_inc_rtol=args.mech_inc_rtol)
    if args.newton_inc_forcing is not None:
        sc = dataclasses.replace(sc, newton_inc_forcing=args.newton_inc_forcing)
    cfg = dataclasses.replace(cfg, solver=sc)

    if args.mesh:
        mesh = read_msh(args.mesh)
    elif args.problem_dim == 1:
        mesh = reference_glass_mesh_1d()
    elif args.problem_dim == 2:
        mesh = box_mesh_2d(args.nx, args.ny, 1.0, 1.0)
    else:
        mesh = box_mesh_3d(args.nx, args.ny, args.nz, 1.0, 1.0, 0.01)

    if args.write_mesh:
        from fem_glass_tempering_tpu_torch.fem.mshio import write_msh
        write_msh(args.write_mesh, mesh)
        print(f"wrote {args.write_mesh} ({mesh.n_cells} {mesh.cell_type} cells)")
        return 0

    mesh_dev = None
    if args.shard:
        from fem_glass_tempering_tpu_torch.parallel.sharding import (
            make_device_mesh, shard_problem,
        )
        mesh_dev = make_device_mesh(device)
    lead = mesh_dev is None or mesh_dev.rank == 0
    if not lead:
        # rank 0 writes; the others step alike (the same write_every
        # chunks) and write nothing
        cfg = dataclasses.replace(cfg, output=dataclasses.replace(
            cfg.output, formats=(), checkpoint_every=0))
    try:
        prob = ThermoViscoProblem(mesh=mesh, config=cfg, device=device)
        prob.setup(dirichlet_bc=args.dirichlet_bc)
        if args.resume:
            prob.resume_from(args.resume)
        if mesh_dev is not None:
            shard_problem(prob, mesh_dev)
        if args.profile_dir and lead:
            from fem_glass_tempering_tpu_torch.utils.profiling import (
                device_trace,
            )
            with device_trace(args.profile_dir, device=device):
                prob.solve(progress=args.progress)
        else:
            prob.solve(progress=args.progress and lead)
    finally:
        if mesh_dev is not None:
            mesh_dev.close()
    if lead:
        d = prob.diagnostics
        print(json.dumps({
            "elapsed_seconds": prob.elapsed_seconds,
            "n_steps": prob.n_steps,
            "newton_iters": d.newton_iters,
            "krylov_iters": d.krylov_iters,
            "io_seconds": d.io_seconds,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
