"""Per-rank bodies of tests/test_torch_parallel.py, run in processes that
`fem_glass_tempering_tpu_torch.parallel.comm.run_ranks` spawns: this module
imports the port alone (no JAX), and every body returns numpy data.

The configurations are the JAX package's multi-device tests'
(tests/test_sharding.py, tests/test_domain_cg.py), plus a CG-1 box on the
gather operator and the graded 1D slab, where the sharded heat operator
carries the residual of a CG space and per-cell tables."""

from __future__ import annotations

import contextlib
import io
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from fem_glass_tempering_tpu_torch.config import (
    FEConfig,
    OutputConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
from fem_glass_tempering_tpu_torch.fem.mesh import (
    box_mesh_2d,
    box_mesh_3d,
    reference_glass_mesh_1d,
)

# name -> (mesh, FE, steps, solver settings): tests/test_sharding.py's cases
SHARD_CASES = {
    "cg1_2d": (lambda: box_mesh_2d(8, 8, 2.0, 2.0),
               dict(T_family="CG", T_degree=1), 5, {}),
    "dg1_2d": (lambda: box_mesh_2d(8, 8, 2.0, 2.0),
               dict(T_family="DG", T_degree=1), 5, {}),
    "hex": (lambda: box_mesh_3d(4, 4, 2), dict(T_family="CG", T_degree=1),
            3, {}),
    "stencil": (lambda: box_mesh_3d(4, 4, 2),
                dict(T_family="CG", T_degree=1), 3,
                dict(linear_operator="stencil")),
    "cg1_gather": (lambda: box_mesh_2d(8, 8, 2.0, 2.0),
                   dict(T_family="CG", T_degree=1), 5,
                   dict(grid_native="off")),
    "slab": (reference_glass_mesh_1d, dict(T_family="DG", T_degree=1), 5,
             {}),
}
# name -> (mesh, T degree, steps): tests/test_domain_cg.py's cases
CGDD_CASES = {
    "cg1_2d": (lambda: box_mesh_2d(6, 4, 2.0, 1.0), 1, 4),
    "hex": (lambda: box_mesh_3d(4, 4, 2), 1, 4),
    "cg2_2d": (lambda: box_mesh_2d(4, 4), 2, 4),
}
# gather_state is read after this many steps of the "hex" case
GATHER_STEPS = 3
# the fields compared (tests/test_domain_cg.py's)
STATE_FIELDS = ("T", "Tf", "Tf_partial", "xi", "sigma", "sigma_partial")


def shard_config(name) -> RunConfig:
    _, fe, steps, solver = SHARD_CASES[name]
    return RunConfig(fe=FEConfig(**fe),
                     time=TimeConfig(0.0, steps * 0.1, 0.1),
                     solver=SolverConfig(**solver),
                     output=OutputConfig(write_every=0, formats=()))


def cgdd_config(name, steps=None) -> RunConfig:
    _, degree, n = CGDD_CASES[name]
    n = n if steps is None else steps
    return RunConfig(fe=FEConfig(T_family="CG", T_degree=degree),
                     time=TimeConfig(0.0, n * 0.1, 0.1),
                     output=OutputConfig(write_every=0, formats=()))


def solve_problem(name, mesh_dev=None, device="cpu") -> dict:
    """A SHARD_CASES run, sharded over `mesh_dev` when given."""
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )
    from fem_glass_tempering_tpu_torch.parallel.sharding import shard_problem

    if mesh_dev is not None:
        device = mesh_dev.device
    prob = ThermoViscoProblem(mesh=SHARD_CASES[name][0](),
                              config=shard_config(name), device=device)
    prob.setup()
    rows = None
    if mesh_dev is not None:
        shard_problem(prob, mesh_dev)
        rows = dict(prob.heat.rows)
    st = prob.solve()
    d = prob.diagnostics
    return dict(T=st.T.cpu().numpy(), sigma=st.sigma.cpu().numpy(),
                newton=d.newton_iters, cg=d.krylov_iters, rows=rows)


def cgdd_run(mesh_dev, name) -> dict:
    """A CGDD_CASES run; for "hex" the gathered state after GATHER_STEPS
    and its checkpoint round trip ride along."""
    from fem_glass_tempering_tpu_torch.io.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from fem_glass_tempering_tpu_torch.parallel.domain_cg import CGDDProblem

    dd = CGDDProblem(CGDD_CASES[name][0](), cgdd_config(name), mesh_dev)
    st = dd.init_state()
    out = dict(newton=[], cg=[], ok=[],
               arrs={k: v.cpu().numpy() for k, v in dd.arrs.items()})
    for k in range(CGDD_CASES[name][2]):
        st, ok, ni, ki = dd.step(st)
        out["ok"].append(ok)
        out["newton"].append(ni)
        out["cg"].append(ki)
        if name == "hex" and k + 1 == GATHER_STEPS:
            g = dd.gather_state(st)
            out["gathered"] = {f: getattr(g, f).cpu().numpy()
                               for f in ("t",) + STATE_FIELDS}
            with tempfile.TemporaryDirectory() as tmp:
                p = os.path.join(tmp, f"dd{mesh_dev.rank}.npz")
                save_checkpoint(p, g, extra={"t": float(g.t)})
                st2, _ = load_checkpoint(p, device=mesh_dev.device)
                out["round_trip_equal"] = bool(torch.equal(st2.T, g.T))
    out["T"] = dd.gather_T(st).cpu().numpy()
    out["sigma"] = dd.gather_sigma(st).cpu().numpy()
    out["local_T"] = st.T.cpu().numpy()
    return out


def collectives(mesh_dev) -> dict:
    """The comm layer's pins: all_reduce_sum under torch.func.jvp, and the
    summed all-gather against dist.all_gather."""
    from fem_glass_tempering_tpu_torch.parallel.comm import (
        all_gather,
        all_reduce_sum,
    )

    rng = np.random.default_rng(mesh_dev.rank)
    on = lambda a: torch.as_tensor(a, device=mesh_dev.device)  # noqa: E731
    x, v = on(rng.random(6)), on(rng.random(6))
    y, t = torch.func.jvp(lambda u: all_reduce_sum(u * u, mesh_dev),
                          (x,), (v,))
    pub = np.r_[rng.normal(size=4), -0.0, 0.0, np.inf, -np.inf, 1e-310,
                -1e-310]
    mine = all_gather(on(pub), mesh_dev)
    ref = [torch.empty(len(pub), dtype=torch.float64)
           for _ in range(mesh_dev.size)]
    dist.all_gather(ref, torch.as_tensor(pub))
    host = lambda a: a.cpu().numpy()  # noqa: E731
    return dict(x=host(x), v=host(v), y=host(y), t=host(t),
                gathered=host(mine), all_gather=torch.cat(ref).numpy())


def rank_body(mesh_dev) -> dict:
    """Every case of the module on this rank: the collectives' pins, the
    CGDD cases and the shard_problem cases."""
    return dict(collectives=collectives(mesh_dev),
                cgdd={n: cgdd_run(mesh_dev, n) for n in CGDD_CASES},
                shard={n: solve_problem(n, mesh_dev) for n in SHARD_CASES})


def unsharded_shard_body(mesh_dev) -> dict:
    """The shard_problem cases unsharded (a process of their own)."""
    return {n: solve_problem(n) for n in SHARD_CASES}


def unsharded_cgdd_body(mesh_dev) -> dict:
    """The CGDD cases as unsharded ThermoViscoProblems, and the "hex" case
    after GATHER_STEPS (a process of their own)."""
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )

    def solve(name, steps=None):
        prob = ThermoViscoProblem(mesh=CGDD_CASES[name][0](),
                                  config=cgdd_config(name, steps),
                                  device="cpu")
        prob.setup()
        st = prob.solve()
        return {f: getattr(st, f).numpy() for f in STATE_FIELDS}

    return dict(cgdd={n: solve(n) for n in CGDD_CASES},
                gather=solve("hex", GATHER_STEPS))


def card_body(mesh_dev) -> dict:
    """The two-rank run on one card (tests/test_torch_cuda_kernels.py):
    the collectives on CUDA tensors, the DG box and the graded slab
    sharded, the CGDD hex box."""
    return dict(collectives=collectives(mesh_dev),
                shard={n: solve_problem(n, mesh_dev)
                       for n in ("dg1_2d", "slab")},
                cgdd={"hex": cgdd_run(mesh_dev, "hex")})


def cli_body(mesh_dev, argv) -> str:
    """The command line with --shard inside a running group: what it
    printed on this rank."""
    from fem_glass_tempering_tpu_torch.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()
