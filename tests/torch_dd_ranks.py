"""Per-rank bodies of tests/test_torch_domain_dg.py (and of the card test
in tests/test_torch_cuda_kernels.py), run in processes that
`fem_glass_tempering_tpu_torch.parallel.comm.run_ranks` spawns: this module
imports the port alone (no JAX), and every body returns numpy data.

The cases are tests/test_domain_decomposition.py's: the graded 1D slab and
the 6x4 box for 5 steps, the 2x2x2 tet box for 2, DG-1 T at dt 0.1."""

from __future__ import annotations

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.config import (
    FEConfig,
    OutputConfig,
    RunConfig,
    TimeConfig,
)
from fem_glass_tempering_tpu_torch.fem.mesh import (
    box_mesh_2d,
    box_mesh_3d,
    reference_glass_mesh_1d,
)

# name -> (mesh, steps)
CASES = {
    "slab": (reference_glass_mesh_1d, 5),
    "box": (lambda: box_mesh_2d(6, 4, 2.0, 1.0), 5),
    "tet": (lambda: box_mesh_3d(2, 2, 2, cell_type="tet"), 2),
}
# gather_state is read after this many steps of the slab
GATHER_STEPS = 3
# the fields compared (tests/test_domain_decomposition.py's)
STATE_FIELDS = ("T", "Tf", "Tf_partial", "xi", "sigma", "sigma_partial")


def config(steps, family="DG") -> RunConfig:
    return RunConfig(fe=FEConfig(T_family=family, T_degree=1),
                     time=TimeConfig(0.0, steps * 0.1, 0.1),
                     output=OutputConfig(write_every=0, formats=()))


def host(state, fields=STATE_FIELDS) -> dict:
    return {f: getattr(state, f).cpu().numpy() for f in fields}


def halo_tangent(dd, state) -> dict:
    """The jvp of this rank's residual at its T along a tangent that is
    nonzero on every cell, against the rows of the unsharded heat
    operator's jvp: a halo whose tangent is not gathered leaves the cross
    facets' remote side out."""
    from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator

    T, dev = state.T, state.T.device
    n = dd.fs_T.n_scalar_dofs
    gd = dd.layout.global_dof_of_local[dd.comm.rank]
    valid = np.nonzero(gd >= 0)[0]
    v_global = np.random.default_rng(7).normal(size=n)
    on = lambda a: torch.as_tensor(a, dtype=dd.dtype, device=dev)  # noqa
    v = np.zeros(len(gd))
    v[valid] = v_global[gd[valid]]
    _, t = torch.func.jvp(lambda x: dd._local_residual(x, T), (T,),
                          (on(v),))
    heat = HeatOperator(dd.fs_T, dd.params, dd.dt, dtype=dd.dtype,
                        device=dev)
    Tg = dd.gather_T(state)
    _, t_ref = torch.func.jvp(lambda x: heat.residual(x, Tg), (Tg,),
                              (on(v_global),))
    return dict(local=t.cpu().numpy()[valid],
                unsharded=t_ref.cpu().numpy()[gd[valid]])


def dd_run(mesh_dev, name) -> dict:
    """A CASES run through DDProblem: this rank's arrays, the counts of
    every step, the gathered fields; for the slab the gathered state after
    GATHER_STEPS, and for every case the halo's tangent."""
    from fem_glass_tempering_tpu_torch.parallel.domain import DDProblem

    make, steps = CASES[name]
    dd = DDProblem(make(), config(steps), mesh_dev)
    st = dd.init_state()
    out = dict(newton=[], cg=[], ok=[],
               arrs={k: v.cpu().numpy() for k, v in dd.arrs.items()})
    for k in range(steps):
        st, ok, ni, ki = dd.step(st)
        out["ok"].append(ok)
        out["newton"].append(ni)
        out["cg"].append(ki)
        if name == "slab" and k + 1 == GATHER_STEPS:
            g = dd.gather_state(st)
            out["gathered"] = host(g, ("t",) + STATE_FIELDS)
    out["T"] = dd.gather_T(st).cpu().numpy()
    out["sigma"] = dd.gather_sigma(st).cpu().numpy()
    out["local_T"] = st.T.cpu().numpy()
    out["tangent"] = halo_tangent(dd, st)
    return out


def rank_body(mesh_dev) -> dict:
    """Every case of the module on this rank."""
    return {name: dd_run(mesh_dev, name) for name in CASES}


def unsharded(name, device="cpu") -> dict:
    """A CASES run as an unsharded ThermoViscoProblem: the fields at its
    end and, where it gets there, after GATHER_STEPS."""
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )

    make, steps = CASES[name]
    prob = ThermoViscoProblem(mesh=make(), config=config(steps),
                              device=device)
    prob.setup()
    st, out = prob.engine.init_state(), {}
    for k in range(steps):
        st, ok, _, _ = prob.multi_step(st, 1)
        assert ok
        if k + 1 == GATHER_STEPS:
            out["at_gather"] = host(st)
    out["end"] = host(st)
    return out


def reference_body(mesh_dev) -> dict:
    """The unsharded runs of every case, and the slab through DDProblem at
    world size 1 (this process's group of one)."""
    return dict(unsharded={name: unsharded(name) for name in CASES},
                one_rank=dd_run(mesh_dev, "slab"))


def card_body(mesh_dev) -> dict:
    """The slab on two ranks sharing one card
    (tests/test_torch_cuda_kernels.py)."""
    return dd_run(mesh_dev, "slab")
