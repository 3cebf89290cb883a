"""Per-rank bodies of tests/test_torch_grid_shard_q2.py, run in processes
that `fem_glass_tempering_tpu_torch.parallel.comm.run_ranks` spawns: this
module imports the port alone (no JAX), and every body returns numpy
data.

The step cases are the JAX package's tests/test_grid2.py:237 plate (6x4x3
of 1 x 0.7 x 0.01, f64, rtol 1e-12, 2 steps, Chebyshev coarse chain under
the line-smoothed Q2MG) in f64 and in mixed precision, the dry run's
"gspmd-q2" strategy (__graft_entry__.py:213-235: the same plate at rtol
1e-10), and three layouts of it: a 5-cell x axis ("drift": at P = 4 the
11 lattice planes take 1 ghost plane, rank p holding [3p, 3p + 3), the 6
node planes 2, rank p holding [2p, 2p + 2), so rank 2's even lattice
planes 6 and 8 are nodes 3 and 4 of rank 1's and rank 2's rows, and rank
3 holds ghost nodes alone), a 2-cell x axis ("ghost": 5 lattice planes
over 8 rows, rank 2 holding one real plane and rank 3 ghost planes alone)
and a box thinnest along x ("xthin", 3x4x4 cells of 0.0033 x 0.25 x 0.25:
Q2MG's line smoother runs along axis 0, across the ranks)."""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
from fem_glass_tempering_tpu_torch.io.sharded import read_sharded_series
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
from fem_glass_tempering_tpu_torch.models.viscoelastic import ViscoState
from fem_glass_tempering_tpu_torch.ops.grid2 import (
    Q2MG,
    LatticeHalo,
    LatticeNodeTransfers,
    RankQ2MG,
)
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.parallel import comm, multihost
from fem_glass_tempering_tpu_torch.parallel.grid_shard import (
    GridShardedProblem,
)

STEP_FIELDS = ("T", "Tf", "sigma")
SERIES_FIELDS = ("T", "Tf", "sigma")
PLATE = (6, 4, 3, 1.0, 0.7, 0.01)
SEED = 23
WAIT_S = 240.0


def q2_cfg(m, steps=2, rtol=1e-12, cg_dtype="same", output=None):
    """tests/test_grid2.py:243 (`m`: either package's config module)."""
    return m.RunConfig(
        fe=m.FEConfig(T_family="CG", T_degree=2, sigma_family="CG",
                      sigma_degree=1),
        time=m.TimeConfig(0.0, steps * 0.1, 0.1),
        solver=m.SolverConfig(newton_rtol=rtol, newton_atol=1e-10,
                              cg_rtol=rtol, cg_max_it=300,
                              linear_operator="stencil",
                              preconditioner="mg", mg_smoother="chebyshev",
                              cg_dtype=cg_dtype),
        output=output or m.OutputConfig(write_every=0, formats=()),
        dtype="float64")


def io_cfg(m, out):
    """The plate's config with a snapshot of T, Tf and sigma a step and a
    checkpoint at step 2 in `out`."""
    return q2_cfg(m, output=m.OutputConfig(
        output_dir=str(out), write_every=1, formats=("npz",),
        npz_fields=SERIES_FIELDS, checkpoint_every=2))


# name -> (box_mesh_3d arguments, config maker over a config module, steps)
CASES = {
    "plate": (PLATE, lambda m: q2_cfg(m), 2),
    "dryrun": (PLATE, lambda m: q2_cfg(m, rtol=1e-10), 2),
    "mixed": (PLATE, lambda m: q2_cfg(m, cg_dtype="float32"), 2),
    "drift": ((5, 4, 3, 1.0, 0.7, 0.01), lambda m: q2_cfg(m, 1), 1),
    "ghost": ((2, 4, 3, 1.0, 0.7, 0.01), lambda m: q2_cfg(m, 1), 1),
    "xthin": ((3, 4, 4, 0.01, 1.0, 1.0), lambda m: q2_cfg(m, 1), 1),
}
# the port's runs of the second group of P = 4 ranks (the first runs the
# plate through solve(), io_case), of the two ranks, and the unsharded
# references
GROUP1 = ("dryrun", "drift", "ghost")
TWO = ("plate", "mixed", "xthin")
UNSHARDED = ("plate", "mixed", "drift", "ghost", "xthin")


def problem(mesh_dev, name) -> GridShardedProblem:
    dims, cfg, _ = CASES[name]
    return GridShardedProblem(box_mesh_3d(*dims), cfg(tc), mesh_dev)


def collectives():
    return (LatticeHalo.count, comm.Repartition.count,
            comm.halo_exchange.count, comm.all_reduce_sum.count)


def by_kind(c0, c1) -> dict:
    """The collectives between two `collectives()` readings by kind:
    lattice halos, re-partitions between the lattice and the node grid,
    halo exchanges of node planes, other sums (dots, all-gathers)."""
    lat, rep, halo, sums = (b - a for a, b in zip(c0, c1))
    return dict(lattice_halos=lat, repartitions=rep - lat, node_halos=halo,
                other_sums=sums - rep - halo)


def step_case(mesh_dev, name) -> dict:
    """GridShardedProblem on case `name`: `steps` steps from the initial
    state."""
    gs = problem(mesh_dev, name)
    c0 = collectives()
    st, ok, ni, ki = gs.run(gs.init_state(), CASES[name][2])
    return summary(gs, st, ok, ni, ki, by_kind(c0, collectives()))


def summary(gs, st, ok, ni, ki, counts) -> dict:
    """A run's gathered fields, this rank's rows of T and Tf, the counts
    and the collectives by kind."""
    flat = gs.gather_state(st)
    return dict(ok=ok, newton=ni, cg=ki, rank_T=st.T.cpu().numpy(),
                rank_Tf=st.Tf.cpu().numpy(), lat_rows=gs.lat_rows,
                lat_pad0=gs.lat_pad0, rows=gs.rows, pad0=gs.pad0,
                smoother=(gs.q2_mg.smoother, gs.q2_mg.line_axis),
                collectives=counts,
                **{f: getattr(flat, f).numpy() for f in STEP_FIELDS})


def _padded(a, n, mode):
    """A whole grid's rows padded along axis 0 to n: edge or zero."""
    g = a.shape[0]
    if n == g:
        return a
    fill = a[-1:] if mode == "edge" else torch.zeros_like(a[-1:])
    return torch.cat([a, fill.expand((n - g,) + tuple(a.shape[1:]))])


def _cg1(dtype=torch.float64):
    return lambda m: HeatOperator(FunctionSpace(m, "CG", 1),
                                  tc.ModelParams(), 0.1, dtype=dtype,
                                  device="cpu")


def rank_form_case(mesh_dev, name) -> dict:
    """On case `name`'s layout: the lattice halo, the transfers (restrict,
    prolong, inject) and RankQ2MG's apply against the whole lattice's on
    the same seeded inputs, computed on this rank: `*_equal` bit for bit,
    the applies' max-rel; Q2MG's own smoother (lines) and point Chebyshev
    (Q2MG(smoother="chebyshev")); the collectives of one apply by kind."""
    gs = problem(mesh_dev, name)
    mg, rank = gs.q2_mg, mesh_dev.rank
    fine = mg.fine
    g, ng = fine.grid, gs._ngrid_base
    G, NG = g[0] + gs.lat_pad0, gs.grid[0]
    lo, hi = gs.lat_rows[rank]
    n0, n1 = gs.rows[rank]
    rng = np.random.default_rng(SEED)
    T = torch.as_tensor(700 + 100 * rng.random(g))
    r = torch.as_tensor(rng.standard_normal(g))
    xn = torch.as_tensor(rng.standard_normal(ng))
    T_rows = _padded(T, G, "edge")[lo:hi].clone()
    r_rows = _padded(r, G, "zero")[lo:hi].clone()
    tr = LatticeNodeTransfers(fine.dims, gs.lat_rows, gs.rows, mesh_dev)
    halo = LatticeHalo(gs.lat_rows, g[0], mesh_dev)
    win = torch.zeros((hi - lo + 4,) + g[1:], dtype=T.dtype)
    for j in range(max(lo - 2, 0), min(hi + 2, g[0])):
        win[j - lo + 2] = T[j]
    got = dict(
        halo=(halo(T_rows), win),
        restrict=(tr.restrict(r_rows),
                  _padded(mg._restrict(r), NG, "zero")[n0:n1]),
        prolong=(tr.prolong(_padded(xn, NG, "zero")[n0:n1]),
                 _padded(mg._prolong(xn), G, "zero")[lo:hi]),
        inject=(tr.inject(T_rows), _padded(mg._inject(T), NG,
                                           "edge")[n0:n1]))
    out = {k + "_equal": bool(torch.equal(a, b)) for k, (a, b) in got.items()}
    dt = gs.dt
    cheb = Q2MG(fine, _cg1(), smoother="chebyshev",
                mg_kwargs={"smoother": "chebyshev"}, coarse_pad0=gs.pad0,
                coarse_kind="grid")
    cheb.freeze_rhos(dt)
    for tag, q, rq in (("line", mg, gs.rank_q2_mg),
                       ("chebyshev", cheb, RankQ2MG(cheb, mesh_dev,
                                                    gs.lat_rows, gs.rows))):
        apply = rq.preconditioner(T_rows, dt)
        c0 = collectives()
        y = apply(r_rows)
        counts = by_kind(c0, collectives())
        whole = q.preconditioner_g(q.linearization_states_g(T), dt)(r)
        y_all = comm.all_gather(y.contiguous(), mesh_dev)[:g[0]]
        out[tag] = dict(
            max_rel=float((y_all - whole).abs().max() / whole.abs().max()),
            equal=bool(torch.equal(y_all, whole)),
            ghost_zero=bool((y[max(g[0] - lo, 0):] == 0).all()),
            collectives=counts, smoother=(q.smoother, q.line_axis))
    return out


def io_case(mesh_dev, work) -> dict:
    """The plate at P = 4 through solve(): a snapshot a step and a
    checkpoint at step 2 (the run as `step_case`'s, the series read back
    against the gathered state); the checkpoint loaded, and run(1) from it
    against run(1) from the solved state; then JAX's checkpoint of step 2
    (its file `jax_ckpt_ready` in `work`) loaded."""
    out = os.path.join(work, "port_q2")
    dims, _, _ = CASES["plate"]
    gs = GridShardedProblem(box_mesh_3d(*dims), io_cfg(tc, out), mesh_dev)
    c0 = collectives()
    st = gs.solve()
    plate = summary(gs, st, True, gs.newton_iters, gs.krylov_iters,
                    by_kind(c0, collectives()))
    series = read_sharded_series(os.path.join(out, "sharded_series"))
    st2b = gs.load_checkpoint(os.path.join(out, "sharded_ckpt_000002"))
    a, ok_a, ni_a, ki_a = gs.run(st2b, 1)
    b, ok_b, ni_b, ki_b = gs.run(st, 1)
    ready = os.path.join(work, "jax_ckpt_ready")
    t0 = time.monotonic()
    while not os.path.exists(ready):
        if time.monotonic() - t0 > WAIT_S:
            raise TimeoutError("JAX's checkpoint never came")
        time.sleep(0.1)
    with open(ready) as fh:
        if fh.read() != "ok":
            raise RuntimeError("JAX's checkpoint failed")
    stj = gs.load_checkpoint(os.path.join(work, "jax_q2",
                                          "sharded_ckpt_000002"))
    return dict(
        plate=plate, io=dict(
            ok=ok_a and ok_b, series=series,
            flat={f: plate[f] for f in SERIES_FIELDS},
            files=sorted(os.listdir(os.path.join(out, "sharded_series"))),
            loaded_bits={f: bool(torch.equal(getattr(st2b, f),
                                             getattr(st, f)))
                         for f in ViscoState._fields},
            resumed_bits={f: bool(torch.equal(getattr(a, f), getattr(b, f)))
                          for f in ViscoState._fields},
            counts=((ni_a, ki_a), (ni_b, ki_b)),
            saved_padded=multihost.gather_to_host(st, gs.comm)._asdict(),
            jax_t=float(stj.t),
            jax_rows={f: getattr(stj, f).cpu().numpy() for f in ("T", "Tf")}))


def rank_body(mesh_dev, group: int, work: str) -> dict:
    torch.set_num_threads(1)
    if group == 0:
        return io_case(mesh_dev, work)
    out = {name: step_case(mesh_dev, name) for name in GROUP1}
    out["rank_form"] = rank_form_case(mesh_dev, "drift")
    return out


def two_rank_body(mesh_dev) -> dict:
    """P = 2: the plate in f64 and mixed precision and the box thinnest
    along x (lines along axis 0, on the all-gathered lattice), and the
    latter's rank form."""
    torch.set_num_threads(1)
    out = {name: step_case(mesh_dev, name) for name in TWO}
    out["rank_form"] = rank_form_case(mesh_dev, "xthin")
    return out


def ref_body(mesh_dev) -> dict:
    """World size 1: the plate's GridShardedProblem, the refusal of CG-2
    with mechanics, and the port's unsharded ThermoViscoProblem on every
    case of UNSHARDED (`steps` steps)."""
    torch.set_num_threads(1)
    out = dict(world_size_1=step_case(mesh_dev, "plate"))
    dims, cfg, _ = CASES["plate"]
    try:
        GridShardedProblem(box_mesh_3d(*dims), dataclasses.replace(
            cfg(tc), mechanics="equilibrium"), mesh_dev)
        out["mechanics_refusal"] = None
    except ValueError as e:
        out["mechanics_refusal"] = str(e)
    for name in UNSHARDED:
        dims, cfg, steps = CASES[name]
        prob = ThermoViscoProblem(mesh=box_mesh_3d(*dims), config=cfg(tc),
                                  device="cpu")
        prob.setup()
        st, ok, ni, ki = prob.multi_step(prob.state, steps)
        out[name] = dict(ok=ok, newton=ni, cg=ki,
                         **{f: getattr(st, f).numpy() for f in STEP_FIELDS})
    return out


def card_body(mesh_dev) -> dict:
    """Two gloo ranks on one card: the drift plate, 1 step."""
    return dict(drift=step_case(mesh_dev, "drift"))
