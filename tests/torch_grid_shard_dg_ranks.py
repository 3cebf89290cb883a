"""Per-rank bodies of tests/test_torch_grid_shard_dg.py, run in processes
that `fem_glass_tempering_tpu_torch.parallel.comm.run_ranks` spawns: this
module imports the port alone (no JAX), and every body returns numpy
data.

The step cases are the JAX package's tests/test_grid_dg.py `_run_cfg`
plates (8x4x4, f64, rtol 1e-12, 3 steps; 10x4x3 and 5x4x3, whose cell
axis is padded with 2 and 3 ghost layers at P = 4, rank 3 of the second
holding ghost layers alone), its mechanics plate (:222: 8x4x3, trapezoid
xi, 2 steps), the dry run's "gspmd-dg" strategy (__graft_entry__.py:
192-205: 16x4x4, 2 steps) in mixed precision, and a plate thin in x
(4x4x4 cells of 0.0025 x 0.25 x 0.25), whose column smoother runs along
axis 0, across the ranks."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
from fem_glass_tempering_tpu_torch.parallel import comm
from fem_glass_tempering_tpu_torch.parallel.grid_shard import (
    GridShardedProblem,
)
from fem_glass_tempering_tpu_torch.solver.grid_dg import (
    CellNodeTransfers,
    dg_to_nodes_g,
)

STEP_FIELDS = ("T", "Tf", "sigma")
# the transfers' and the preconditioner's inputs (numpy, this seed)
SEED = 21


def dg_cfg(m, steps, rtol=1e-12):
    """tests/test_grid_dg.py `_run_cfg` (`m`: either package's config
    module)."""
    return m.RunConfig(
        fe=m.FEConfig(T_family="DG", T_degree=1, sigma_family="CG",
                      sigma_degree=1),
        time=m.TimeConfig(0.0, steps * 0.1, 0.1),
        solver=m.SolverConfig(newton_rtol=rtol, newton_atol=1e-10,
                              cg_rtol=rtol, cg_max_it=2000,
                              linear_operator="stencil",
                              preconditioner="mg", mg_smoother="chebyshev"),
        output=m.OutputConfig(write_every=0, formats=()), dtype="float64")


def mech_cfg(m, steps):
    """tests/test_grid_dg.py:222: equilibrium mechanics, trapezoid xi."""
    return dataclasses.replace(dg_cfg(m, steps), mechanics="equilibrium",
                               physics_mode="corrected",
                               xi_formula="trapezoid")


def dryrun_dg_cfg(m, cg_dtype="same"):
    """The dry run's "gspmd-dg" strategy (__graft_entry__.py:192-205)."""
    return m.RunConfig(
        fe=m.FEConfig(T_family="DG", T_degree=1, sigma_family="CG",
                      sigma_degree=1),
        time=m.TimeConfig(0.0, 0.1, 0.1),
        solver=m.SolverConfig(newton_rtol=1e-12, newton_atol=1e-10,
                              cg_rtol=1e-10, cg_max_it=500,
                              linear_operator="stencil",
                              preconditioner="mg", mg_smoother="chebyshev",
                              cg_dtype=cg_dtype),
        dtype="float64")


# name -> (box_mesh_3d arguments, config maker over a config module, steps)
CASES = {
    "plate": ((8, 4, 4, 1.0, 1.0, 0.01), lambda m: dg_cfg(m, 3), 3),
    "pad2": ((10, 4, 3, 1.0, 1.0, 0.01), lambda m: dg_cfg(m, 2), 2),
    "ghost_rank": ((5, 4, 3, 1.0, 1.0, 0.01), lambda m: dg_cfg(m, 2), 2),
    "dryrun_mixed": ((16, 4, 4, 1.0, 1.0, 0.01),
                     lambda m: dryrun_dg_cfg(m, "float32"), 2),
    "mech": ((8, 4, 3, 1.0, 1.0, 0.01), lambda m: mech_cfg(m, 2), 2),
    "xthin": ((4, 4, 4, 0.01, 1.0, 1.0), lambda m: dg_cfg(m, 2), 2),
    # one ghost cell layer at P = 2 (the card test)
    "pad1": ((9, 4, 3, 1.0, 1.0, 0.01), lambda m: dg_cfg(m, 2), 2),
}
# the P = 4 cases in two groups of ranks (run at once)
GROUPS = (("plate", "dryrun_mixed", "mech"), ("pad2", "ghost_rank"))


def problem(mesh_dev, name) -> GridShardedProblem:
    dims, cfg, _ = CASES[name]
    return GridShardedProblem(box_mesh_3d(*dims), cfg(tc), mesh_dev)


def step_case(mesh_dev, name) -> dict:
    """GridShardedProblem on case `name`: `steps` steps from the initial
    state; the gathered fields, this rank's rows of T and Tf, the counts."""
    gs = problem(mesh_dev, name)
    st, ok, ni, ki = gs.run(gs.init_state(), CASES[name][2])
    flat = gs.gather_state(st)
    out = dict(ok=ok, newton=ni, cg=ki, rank_T=st.T.cpu().numpy(),
               rank_Tf=st.Tf.cpu().numpy(), cell_rows=gs.cell_rows,
               cell_pad0=gs.cell_pad0, pad0=gs.pad0,
               smoother=(gs.dg_mg.smoother, gs.dg_mg.col_axis),
               **{f: getattr(flat, f).numpy() for f in STEP_FIELDS})
    if gs.mech is not None:
        out.update(mech_iters=list(gs.last_mech_iters),
                   mech_converged=list(gs.last_mech_converged))
    return out


def transfers_case(mesh_dev, name) -> dict:
    """On case `name`'s layout: the rank's transfers (restrict,
    restrict_state, to_nodes, prolong) and one preconditioner apply
    against the whole grid's on the same seeded inputs, computed on this
    rank (bit for bit where equal: `*_equal`; the apply's max-rel), and
    the collectives of one apply by kind."""
    gs = problem(mesh_dev, name)
    mg, rdmg, rank = gs.dg_mg, gs.rank_dg_mg, mesh_dev.rank
    dims, nloc = gs.cell_dims, gs.nloc
    rng = np.random.default_rng(SEED)
    cx, pad0, cp = dims[0], gs.pad0, gs.cell_pad0
    T = torch.as_tensor(700 + 100 * rng.random(dims + (nloc,)))
    r = torch.as_tensor(rng.standard_normal(dims + (nloc,)))
    xn = torch.as_tensor(rng.standard_normal(mg._node_grid))
    c0, c1 = gs.cell_rows[rank]
    n0, n1 = gs.rows[rank]

    def cells(a):
        """This rank's layers of a cell field, ghosts edge-padded."""
        if cp:
            a = torch.cat([a, a[-1:].expand((cp,) + a.shape[1:])])
        return a[c0:c1].clone()

    def nodes(a, mode):
        if pad0:
            fill = (a[-1:] if mode == "edge"
                    else torch.zeros_like(a[-1:])).expand(
                        (pad0,) + a.shape[1:])
            a = torch.cat([a, fill])
        return a[n0:n1]

    tr = rdmg.tr
    # the cell rows with their ghost layers zero (the step's vectors)
    r_rows = cells(r)
    r_rows[max(cx - c0, 0):] = 0.0
    got = dict(
        restrict=(tr.restrict(r_rows), nodes(mg.restrict_g(r), "zero")),
        restrict_state=(tr.restrict_state(cells(T)),
                        nodes(mg.restrict_state_g(T), "edge")),
        to_nodes=(gs.to_nodes.to_nodes(cells(T)), nodes(dg_to_nodes_g(
            T, gs._vert_offs, gs._ngrid_base), "edge")),
        prolong=(tr.prolong(nodes(xn, "zero")),
                 cells(mg.prolong_g(xn))))
    got["prolong"][1][max(cx - c0, 0):] = 0.0
    out = {k + "_equal": bool(torch.equal(a, b)) for k, (a, b) in got.items()}
    # one apply of the rank form against the whole grid's
    dt = gs.dt
    slab = gs.slab
    mv = slab.make_matvec_r(cells(T), dt, gs._cell_halo)
    apply = rdmg.preconditioner(cells(T), dt, mv)
    counts0 = (comm.halo_exchange.count, comm.Repartition.count,
               comm.all_reduce_sum.count, gs.cell_halos)
    y = apply(r_rows)
    counts = (comm.halo_exchange.count - counts0[0],
              comm.Repartition.count - counts0[1],
              comm.all_reduce_sum.count - counts0[2],
              gs.cell_halos - counts0[3])
    whole = mg.preconditioner_g(T, dt, gs.dg_op.make_matvec_g(T, dt))(r)
    y_all = comm.all_gather(y.contiguous(), mesh_dev)[:cx]
    out.update(
        apply_max_rel=float((y_all - whole).abs().max()
                            / whole.abs().max()),
        apply_equal=bool(torch.equal(y_all, whole)),
        apply_ghost_zero=bool((y[max(cx - c0, 0):] == 0).all()),
        collectives=dict(cell_halos=counts[3],
                         node_halos=counts[0] - counts[3],
                         repartitions=counts[1],
                         other_sums=counts[2] - counts[0] - counts[1]))
    # the transfers built alone: one re-partition each
    tr2 = CellNodeTransfers(gs._vert_offs, dims, gs.cell_rows, gs.rows,
                            mesh_dev)
    k0 = comm.Repartition.count
    tr2.to_nodes(cells(T))
    tr2.prolong(nodes(xn, "zero"))
    out["repartitions_to_nodes_prolong"] = comm.Repartition.count - k0
    return out


def rank_body(mesh_dev, group: int) -> dict:
    torch.set_num_threads(1)
    out = {name: step_case(mesh_dev, name) for name in GROUPS[group]}
    if group == 1:
        out["transfers"] = {name: transfers_case(mesh_dev, name)
                            for name in ("pad2", "ghost_rank")}
    return out


def two_rank_body(mesh_dev) -> dict:
    """P = 2: the plate thin in x (the column smoother along axis 0, on
    all-gathered cell layers) and its transfers."""
    torch.set_num_threads(1)
    return dict(xthin=step_case(mesh_dev, "xthin"),
                transfers=transfers_case(mesh_dev, "xthin"))


def one_rank_body(mesh_dev) -> dict:
    """World size 1: the 8x4x4 plate."""
    torch.set_num_threads(1)
    return dict(plate=step_case(mesh_dev, "plate"))


def card_body(mesh_dev) -> dict:
    """Two gloo ranks on one card: the 9x4x3 plate (one ghost cell
    layer), 2 steps."""
    return dict(pad1=step_case(mesh_dev, "pad1"))
