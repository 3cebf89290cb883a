"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py                  # a few minutes on an H100
    python3 chip_smoke.py --profile DIR    # also trace 5 full-size steps
                                           # into DIR/profile.txt

Phases (each raises on failure; the exit code is then nonzero):
  1. the card, the torch/CUDA versions, and the build of the hand-written
     CUDA kernels from fem_glass_tempering_tpu_torch/csrc (nvcc, sm_90a);
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes: K1 (material_tspace) at 1,062,761 dofs in f32
     and f64; K2 (stencil_matvec) on the three zero-at-missing-neighbour
     grids in f64 (later, in phase 4, on every multigrid level's real
     value tables of the full-size plate in f32); K3 (dg_cell_residual)
     on the 1D reference slab's tables and on the 65,536-cell hex DG-1
     plate with per-cell and with uniform tables, f64 and f32, with and
     without a per-point source, forward and through torch.func.jvp;
  3. parity of the whole path: a 16x16x8 f64 plate, 10 steps, stencil
     operator + geometric MG, Newton rtol 1e-10 -- the port on the GPU
     (kernels) against the port on the CPU (plain versions);
  4. the full-size run: the 3D CG-1 float-glass plate 160x160x40 cells
     (1,062,761 T dofs) in f32 at Newton/CG rtol 1e-5, stencil operator,
     Chebyshev-smoothed geometric MG, jac_every auto (= 5): one 5-step
     warm-up chunk, then 20 timed steps from a fresh initial state, with
     every kernel launch counter set to 0 just before the timed window
     and read just after;
  5. the default workload: ThermoViscoProblem() with no argument but the
     device (DG-1 / SIPG heat on the graded 1D slab, 96 T dofs, f64,
     Newton and CG rtol 1e-12, matrix-free CG, SA-AMG), 500 steps, held
     to the golden values and the Newton count of the CPU reference; then
     50 steps with the assembled ELL operator against the matrix-free
     run, and a checkpoint written at step 25 and resumed to step 50;
  6. the DG-1 plate at a real size: 64x64x16 hex cells, 524,288 T dofs,
     f64, rtol 1e-12, matrix-free CG + SA-AMG, 1 warm-up step and 3
     timed steps; before it the same configuration at 8x8x4 on the GPU
     against the port on the CPU (fields tight; iteration counts within
     the ties that rtol 1e-12 leaves, see dg_parity_phase).
Every main path (4, 5, 6) runs with the launch counters set to 0 just
before it and read just after. Then one JSON line per kernel, one {"kernels": [...]} line, the card's
name and power limit, and last {"ok": true, "device": {...}}.

A kernel's `ms` and `plain_ms` are CUDA-event means over back-to-back
calls of the wrapper (the host's cost of issuing a call shows where it
exceeds the device's); `device_ms` is the same call captured `reps` times
into a CUDA graph and replayed, which leaves the device time alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_FULL = (160, 160, 40)          # 1,024,000 hex cells, 1,062,761 dofs
WARMUP_STEPS = 5
TIMED_STEPS = 20
N_DG = (64, 64, 16)              # 65,536 hex cells, 524,288 DG-1 dofs
DG_TIMED_STEPS = 3
DG_PARITY_STEPS = 3
KERNELS = ("material_tspace", "stencil_matvec", "dg_cell_residual")
# the golden values of the default run (CPU reference, confirmed by the
# independent numpy/scipy oracle of the JAX package's test-suite)
GOLDEN = dict(T_surf=(644.5809518419135, 1e-8),
              T_core=(797.5500316300408, 1e-8),
              Tf_surf=(799.8808751898703, 1e-8),
              sigma_l2=(1.3725924857443605e-4, 1e-6))
GOLDEN_NEWTON = 1501
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
PEAK_OPS = {torch.float32: 67e12,   # non-tensor-core FP32, data sheet
            torch.float64: 34e12}   # non-tensor-core FP64, data sheet
# plain arithmetic per element, exp counted as one operation
K1_OPS_PER_DOF = 51
K2_OPS_PER_POINT = 54            # 27 multiplies + 27 adds


def k3_ops_per_cell(nloc: int, q: int, g: int) -> int:
    """Multiplies and adds of one cell of dg_cell_residual."""
    return q * (4 * nloc + 4 * nloc * g + g + 5 + 2 * nloc) + 2 * nloc


def k3_values_per_cell(nloc: int, q: int, g: int, uniform: bool,
                       with_src: bool) -> int:
    """Values a cell moves: Tc, Tpc in, r out, and its tables (the
    uniform tables and phi are O(1) for the whole call)."""
    n = 3 * nloc + (q if with_src else 0)
    return n if uniform else n + q + q * nloc * g


def reset_counts(port) -> None:
    for name in KERNELS:
        port[name].launches = 0


def read_counts(port) -> dict:
    return {name: port[name].launches for name in KERNELS}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Mean device time of fn() over `reps` back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Mean device time of fn(): `reps` calls captured into one CUDA graph
    and replayed, so the host's cost of issuing them (wrapper checks,
    ctypes, the dispatcher) lies outside the timed window. Inputs up to
    the 50 MB L2 stay cached from one call to the next."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound_ms(n_bytes: float, n_ops: float, dtype) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
def check_material_tspace(dev, port) -> dict:
    """K1 against its plain version at the main path's n, f32 and f64."""
    from fem_glass_tempering_tpu_torch.models.viscoelastic import (
        LAMBDA_M_N,
        M_N,
    )
    k = port["material_tspace"]
    ref = port["material_tspace_reference"]
    n = int(np.prod([d + 1 for d in N_FULL]))
    rng = np.random.default_rng(0)
    kw = dict(dt=0.1, H_over_Rg=627.8e3 / 8.314, Tb=869.0, m_n=M_N,
              lambda_m_n=LAMBDA_M_N)
    out = {}
    for dtype, rtol in ((torch.float32, 2e-6), (torch.float64, 1e-12)):
        T = torch.tensor(600.0 + 250.0 * rng.random(n), dtype=dtype,
                         device=dev)
        Tp = T + torch.tensor(rng.normal(0.0, 2.0, n), dtype=dtype,
                              device=dev)
        Tfp = torch.tensor(600.0 + 250.0 * rng.random((n, 6)), dtype=dtype,
                           device=dev)
        got = k(T, Tp, Tfp, **kw)
        want = ref(T, Tp, Tfp, **kw)
        torch.cuda.synchronize()
        err = 0.0
        for name, g, w in zip(("phi", "Tf_partial", "Tf", "xi"), got, want):
            # xi is a difference of two exps: scale its floor by the exps
            scale = (got[0].abs().max() if name == "xi" else w.abs().max())
            bad = (g - w).abs() > rtol * w.abs() + rtol * scale
            if bool(bad.any()) or not bool(torch.isfinite(g).all()):
                fail(f"material_tspace {dtype} {name}: max |diff| "
                     f"{float((g - w).abs().max()):.3e}")
            err = max(err, float((g - w).abs().max()))
        size = torch.finfo(dtype).bits // 8
        b, by = bound_ms(17 * n * size, K1_OPS_PER_DOF * n, dtype)
        entry = dict(dtype=str(dtype).split(".")[-1], n=n, max_abs_err=err,
                     rtol=rtol,
                     ms=time_ms(lambda: k(T, Tp, Tfp, **kw)),
                     device_ms=device_ms(lambda: k(T, Tp, Tfp, **kw)),
                     plain_ms=time_ms(lambda: ref(T, Tp, Tfp, **kw)),
                     bound_ms=b, bound_by=by)
        log("K1 check " + json.dumps(entry))
        out[entry["dtype"]] = entry
    return out


def stencil_case(grid, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    d = len(grid)
    vals = rng.standard_normal((3 ** d,) + grid)
    for o, off in enumerate(np.ndindex(*([3] * d))):
        for a, da in enumerate(off):
            sl = [slice(None)] * d
            if da != 1:
                sl[a] = slice(0, 1) if da == 0 else slice(grid[a] - 1,
                                                          grid[a])
                vals[(o,) + tuple(sl)] = 0.0
    x = rng.standard_normal(int(np.prod(grid)))
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    return t(vals).reshape(3 ** d, grid[0], -1), t(x)


def check_stencil(vals2, x, grid, rtol, port) -> float:
    """K2 against its plain version: |dy| <= rtol * (|vals| . |x|) row by
    row (cancellation makes |y| itself no scale)."""
    k, ref = port["stencil_matvec"], port["stencil_matvec_reference"]
    y = k(vals2, x, grid)
    y_ref = ref(vals2, x, grid)
    mag = ref(vals2.abs(), x.abs(), grid)
    torch.cuda.synchronize()
    diff = (y - y_ref).abs()
    if bool((diff > rtol * mag).any()) or not bool(torch.isfinite(y).all()):
        fail(f"stencil_matvec grid {grid} {vals2.dtype}: max |diff| "
             f"{float(diff.max()):.3e}")
    return float(diff.max())


# ----------------------------------------------------------------------
def dg_tables(mesh, dtype, dev, uniform):
    """Cell tables of a DG-1 space on `mesh` as the heat operator keeps
    them: per cell, or the single-cell form of a uniform box."""
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.ops.assembly import build_cell_geometry

    fs = FunctionSpace(mesh, "DG", 1)
    cg = build_cell_geometry(mesh, fs)
    qw, gphi = np.asarray(cg.qweights), np.asarray(cg.grad_phys)
    if uniform:
        qw, gphi = qw[0], gphi[0]
    t = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)
    return fs.dofmap.shape, t(qw), t(gphi), t(cg.phi)


def check_dg_cell_case(shape, qw, gphi, phi, rtol, port, *, c_mass,
                       with_src, seed=0) -> float:
    """K3 against its plain version on one set of tables: forward, the
    tangent through torch.func.jvp, and J dT = r(T + dT) - r(T). The bound
    per entry is rtol times the sum of the absolute values of every term
    (the mass and diffusion parts cancel on smooth data)."""
    k, ref = port["dg_cell_residual"], port["dg_cell_residual_reference"]
    dev, dtype = qw.device, qw.dtype
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    Tc = t(700.0 + 100.0 * rng.random(shape))
    Tpc = Tc + t(rng.normal(0.0, 3.0, shape))
    dTc = t(rng.standard_normal(shape))
    src = t(rng.standard_normal((shape[0], phi.shape[0]))) if with_src \
        else None
    kw = dict(dt=0.1, c_diff=0.83, f_src=0.37, c_mass=c_mass)
    got = k(Tc, Tpc, qw, gphi, phi, source_q=src, **kw)
    want = ref(Tc, Tpc, qw, gphi, phi, source_q=src, **kw)
    mag = ref(Tc.abs(), -Tpc.abs(), qw, gphi.abs(), phi.abs(),
              source_q=None if src is None else -src.abs(),
              **dict(kw, f_src=-abs(kw["f_src"])))
    fn = lambda u: k(u, Tpc, qw, gphi, phi, source_q=src, **kw)
    y, dy = torch.func.jvp(fn, (Tc,), (dTc,))
    zero = torch.zeros_like(Tc)
    dwant = ref(dTc, zero, qw, gphi, phi, **dict(kw, f_src=0.0))
    dmag = ref(dTc.abs(), zero, qw, gphi.abs(), phi.abs(),
               **dict(kw, f_src=0.0))
    y2 = fn(Tc + dTc)
    torch.cuda.synchronize()
    tag = (f"dg_cell_residual {tuple(shape)} {dtype} "
           f"{'uniform' if qw.dim() == 1 else 'per-cell'} tables, c_mass "
           f"{c_mass}, source {with_src}")
    for name, g, w, m in (("forward", got, want, mag), ("jvp primal", y,
                          want, mag), ("jvp tangent", dy, dwant, dmag)):
        if not bool(torch.isfinite(g).all()) or bool(
                ((g - w).abs() > rtol * m).any()):
            fail(f"{tag}: {name} max |diff| "
                 f"{float((g - w).abs().max()):.3e}")
    # linearity: the difference of two residuals carries their rounding
    lin_tol = 8 * torch.finfo(dtype).eps * (mag + dmag) + rtol * dmag
    if bool(((dy - (y2 - y)).abs() > lin_tol).any()):
        fail(f"{tag}: J dT != r(T + dT) - r(T), max |diff| "
             f"{float((dy - (y2 - y)).abs().max()):.3e}")
    return max(float((got - want).abs().max()),
               float((dy - dwant).abs().max()))


def check_dg_cell(dev, port) -> dict:
    """K3 at the 1D reference slab's tables (48 cells, nloc 2) and at the
    hex DG-1 plate's (65,536 cells, nloc 8) with per-cell and with uniform
    tables; timed at the plate's shape in f64, the main path's type."""
    from fem_glass_tempering_tpu_torch.fem.mesh import (
        box_mesh_3d,
        reference_glass_mesh_1d,
    )
    k, ref = port["dg_cell_residual"], port["dg_cell_residual_reference"]
    slab = reference_glass_mesh_1d()
    plate = box_mesh_3d(*N_DG, 1.0, 1.0, 0.01)
    out = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        errs = {}
        for label, mesh, uniform in (("slab", slab, False),
                                     ("plate per-cell", plate, False),
                                     ("plate uniform", plate, True)):
            shape, qw, gphi, phi = dg_tables(mesh, dtype, dev, uniform)
            errs[label] = max(
                check_dg_cell_case(shape, qw, gphi, phi, rtol, port,
                                   c_mass=cm, with_src=ws, seed=i)
                for i, (cm, ws) in enumerate(((1.0, False), (3.5825e6, True),
                                              (1.0, True))))
            if dtype == torch.float64 and mesh is plate:
                c, nloc = shape
                q, g = phi.shape[0], gphi.shape[-1]
                rng = np.random.default_rng(11)
                Tc = torch.tensor(700.0 + 100.0 * rng.random(shape),
                                  dtype=dtype, device=dev)
                Tpc = Tc + 1.0
                kw = dict(dt=0.1, c_diff=1.0, f_src=0.0)
                b, by = bound_ms(
                    8 * c * k3_values_per_cell(nloc, q, g, uniform, False),
                    c * k3_ops_per_cell(nloc, q, g), dtype)
                out["uniform" if uniform else "per_cell"] = dict(
                    cells=c, nloc=nloc, q=q, g=g, max_abs_err=errs[label],
                    ms=time_ms(lambda: k(Tc, Tpc, qw, gphi, phi, **kw)),
                    device_ms=device_ms(
                        lambda: k(Tc, Tpc, qw, gphi, phi, **kw)),
                    plain_ms=time_ms(
                        lambda: ref(Tc, Tpc, qw, gphi, phi, **kw), reps=10),
                    plain_device_ms=device_ms(
                        lambda: ref(Tc, Tpc, qw, gphi, phi, **kw)),
                    bound_ms=b, bound_by=by)
            del qw, gphi
        log(f"K3 check {str(dtype).split('.')[-1]} rtol {rtol} max |diff| "
            + json.dumps(errs))
    for form, entry in out.items():
        log(f"K3 {form} tables f64 " + json.dumps(entry))
    return out


# ----------------------------------------------------------------------
def plate_config(tc, steps, f32_bench):
    if f32_bench:       # the bench.py configuration
        solver = tc.SolverConfig(newton_rtol=1e-5, newton_atol=1e-6,
                                 cg_rtol=1e-5, cg_max_it=4000,
                                 linear_operator="stencil",
                                 preconditioner="mg",
                                 mg_smoother="chebyshev")
        dtype = "float32"
    else:
        solver = tc.SolverConfig(newton_rtol=1e-10, newton_atol=1e-9,
                                 cg_rtol=1e-10, cg_max_it=2000,
                                 linear_operator="stencil",
                                 preconditioner="mg")
        dtype = "float64"
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="CG", T_degree=1, sigma_family="CG",
                       sigma_degree=1),
        time=tc.TimeConfig(0.0, steps * 0.1, 0.1), solver=solver,
        output=tc.OutputConfig(write_every=0, formats=()), dtype=dtype)


def parity_phase(dev) -> dict:
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    res = {}
    for where in ("cpu", dev):
        p = ThermoViscoProblem(mesh=box_mesh_3d(16, 16, 8, 1.0, 1.0, 0.01),
                               config=plate_config(tc, 10, False),
                               device=where)
        p.setup()
        t0 = time.perf_counter()
        st, ok, ni, ki = p.multi_step(p.state, 10)
        if not ok:
            fail(f"16x16x8 parity run did not converge on {where}")
        res[str(where)] = (st, ni, ki, time.perf_counter() - t0)
    (sc, nc, kc, _), (sg, ng, kg, tg) = res["cpu"], res[str(dev)]
    out = dict(newton_cpu=nc, newton_gpu=ng, cg_cpu=kc, cg_gpu=kg,
               seconds_gpu=tg)
    for f in ("T", "Tf"):
        a, b = getattr(sc, f).numpy(), getattr(sg, f).cpu().numpy()
        out[f"{f}_max_rel"] = float(np.abs(a - b).max() / np.abs(a).max())
        if not out[f"{f}_max_rel"] < 1e-9:
            fail(f"parity {f}: {out[f'{f}_max_rel']:.3e}")
    a, b = sc.sigma.numpy(), sg.sigma.cpu().numpy()
    out["sigma_rel_to_max"] = float(np.abs(a - b).max() / np.abs(a).max())
    if not out["sigma_rel_to_max"] <= 1e-6:
        fail(f"parity sigma: {out['sigma_rel_to_max']:.3e}")
    if nc != ng or abs(kc - kg) > 2:
        fail(f"parity iterations: newton {nc}/{ng}, cg {kc}/{kg}")
    log("parity " + json.dumps(out))
    return out


def full_size_phase(dev, port, profile_dir) -> dict:
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    t0 = time.perf_counter()
    mesh = box_mesh_3d(*N_FULL, 1.0, 1.0, 0.01)
    prob = ThermoViscoProblem(mesh=mesh, config=plate_config(
        tc, TIMED_STEPS, True), device=dev)
    prob.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n = prob.fs_T.n_scalar_dofs
    levels = [lv.fine_dims for lv in prob._mg.levels]
    log(f"full size: {n} dofs, setup {setup_s:.1f} s, MG levels {levels}")

    # K2 on the real value tables of every stencil level, f32
    k2_levels = []
    rng = np.random.default_rng(3)
    T_levels = prob._mg.linearization_states(prob.state.T)
    for lvl, T in zip(prob._mg.levels, T_levels):
        g = prob._mg._grid_for(lvl)
        if lvl.coarse_dims is None:
            continue               # dense coarse solve: no stencil apply
        vals2 = g.stencil_values(T, prob.dt).reshape(27, g.grid[0], -1)
        x = torch.tensor(rng.standard_normal(g.n), dtype=prob.dtype,
                         device=dev)
        err = check_stencil(vals2, x, g.grid, 1e-5, port)
        k2_levels.append(dict(grid=g.grid, max_abs_err=err))
    log("K2 levels " + json.dumps(k2_levels))
    fine = prob._grid
    vals_fine = fine.stencil_values(prob.state.T, prob.dt).reshape(
        27, fine.grid[0], -1).contiguous()
    x_fine = torch.tensor(rng.standard_normal(n), dtype=prob.dtype,
                          device=dev)

    # warm-up chunk on the real initial transient, then the timed window
    st, ok, _, _ = prob.multi_step(prob.state, WARMUP_STEPS)
    torch.cuda.synchronize()
    if not ok:
        fail("warm-up chunk did not converge")
    state0 = prob.engine.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(port)
    t0 = time.perf_counter()
    st, ok, ni, ki = prob.multi_step(state0, TIMED_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated(dev)
    if not ok:
        fail("timed window did not converge")
    for f in ("T", "Tf", "sigma"):
        if not bool(torch.isfinite(getattr(st, f)).all()):
            fail(f"non-finite {f} after the timed window")
    T_np = st.T.cpu().numpy()
    if not (prob.params.T_ambient - 1 < T_np.min() <= T_np.max()
            < prob.params.T_0 + 1):
        fail(f"T out of [T_ambient, T_0]: {T_np.min()} .. {T_np.max()}")
    if launches["material_tspace"] != TIMED_STEPS:
        fail(f"material_tspace launched {launches['material_tspace']} "
             f"times in {TIMED_STEPS} steps")
    # every Newton iteration applies A and the V-cycle once before CG
    # starts, and each CG iteration once more; a V-cycle applies each
    # stencil level nu_pre + 1 + nu_post times: 1 + 5 x 6 = 31 at full size
    mg = prob._mg
    expect = 1 + (mg.nu_pre + 1 + mg.nu_post) * sum(
        lv.coarse_dims is not None for lv in mg.levels)
    per_apply = launches["stencil_matvec"] / max(ki + ni, 1)
    if launches["stencil_matvec"] == 0 or per_apply != expect:
        fail(f"stencil_matvec launches {launches['stencil_matvec']} for "
             f"{ni} Newton + {ki} CG iterations")
    out = dict(dofs=n, setup_s=setup_s, ms_per_step=elapsed / TIMED_STEPS
               * 1e3, newton_per_step=ni / TIMED_STEPS,
               cg_per_step=ki / TIMED_STEPS, launches=launches,
               stencil_launches_per_apply=per_apply,
               max_memory_allocated_bytes=peak,
               T_min=float(T_np.min()), T_max=float(T_np.max()))
    log("full size " + json.dumps(out))

    # material chain: the whole material step, and K1 alone, at this size
    T_new = st.T.clone()
    out["material_step_ms"] = time_ms(
        lambda: prob.engine.material_step(st, T_new, prob.dt), reps=10)
    out["vals_fine"], out["x_fine"], out["state"] = vals_fine, x_fine, st
    out["grid"] = fine.grid
    if profile_dir:
        profile(prob, dev, profile_dir)
    return out


def default_config(tc, steps, **solver):
    """The default RunConfig (DG-1 T / CG-1 sigma, f64, rtol 1e-12, 'auto'
    -> SA-AMG on the graded slab) cut to `steps` steps, no output."""
    return tc.RunConfig(time=tc.TimeConfig(0.0, steps * 0.1, 0.1),
                        solver=tc.SolverConfig(**solver),
                        output=tc.OutputConfig(write_every=0, formats=()))


def default_workload_phase(dev, port, scratch_dir) -> dict:
    """Phase 5: the reference's default workload on the card."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    prob = ThermoViscoProblem(device=dev)
    prob.setup()
    sc = prob.config.solver
    if (prob.fs_T.family, prob.fs_T.n_scalar_dofs, prob.n_steps,
            prob.dtype, sc.preconditioner, sc.linear_operator) != (
            "DG", 96, 500, torch.float64, "amg", "matrix_free"):
        fail("the default constructor is not the default workload")
    torch.cuda.synchronize()
    reset_counts(port)
    t0 = time.perf_counter()
    st = prob.solve()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(port)
    x = prob.fs_T.dof_coords[:, 0]
    T, Tf = st.T.cpu().numpy(), st.Tf.cpu().numpy()
    got = dict(T_surf=float(T[np.argmin(x)]),
               T_core=float(T[np.argmin(np.abs(x - 25.0))]),
               Tf_surf=float(Tf[np.argmin(x)]),
               sigma_l2=float(np.linalg.norm(
                   st.sigma.cpu().numpy()[:, 0, 0])))
    for name, (want, rel) in GOLDEN.items():
        if not abs(got[name] - want) <= rel * abs(want):
            fail(f"default run {name}: {got[name]!r} vs golden {want!r} "
                 f"(rel {rel})")
    d = prob.diagnostics
    if d.newton_iters != GOLDEN_NEWTON:
        fail(f"default run took {d.newton_iters} Newton iterations, the "
             f"CPU reference {GOLDEN_NEWTON}")
    for name in ("dg_cell_residual", "material_tspace"):
        if launches[name] == 0:
            fail(f"the default run never launched {name}")
    if launches["material_tspace"] != prob.n_steps:
        fail(f"material_tspace launched {launches['material_tspace']} times "
             f"in {prob.n_steps} steps")
    # a residual per Newton iteration; primal + tangent per Jacobian action
    # (one before CG starts and one per CG iteration)
    expect = d.newton_iters + 2 * (d.newton_iters + d.krylov_iters)
    if launches["dg_cell_residual"] != expect:
        fail(f"dg_cell_residual launched {launches['dg_cell_residual']} "
             f"times, expected {expect}")
    out = dict(dofs=96, steps=prob.n_steps, **got,
               newton=d.newton_iters, cg=d.krylov_iters,
               cg_per_newton=d.krylov_iters / d.newton_iters,
               ms_per_step=elapsed / prob.n_steps * 1e3,
               launches=launches,
               k3_launches_per_step=launches["dg_cell_residual"]
               / prob.n_steps)
    log("default workload " + json.dumps(out))

    # assembled (ELL SpMV) against matrix-free over 50 steps, and a
    # checkpoint written at step 25 and resumed to step 50
    finals = {}
    for lo in ("matrix_free", "assembled"):
        p = ThermoViscoProblem(config=default_config(
            tc, 50, linear_operator=lo), device=dev)
        p.setup()
        finals[lo] = p.solve()
    a, b = (finals[k].T.cpu().numpy() for k in ("matrix_free", "assembled"))
    out["assembled_T_max_rel"] = float(np.abs(a - b).max() / np.abs(a).max())
    if not out["assembled_T_max_rel"] < 1e-9:
        fail(f"assembled vs matrix-free T: {out['assembled_T_max_rel']:.3e}")
    first = ThermoViscoProblem(config=default_config(tc, 50), device=dev)
    first.setup()
    first.state, ok, _, _ = first.multi_step(first.state, 25)
    first.t = 25 * first.dt
    path = os.path.join(scratch_dir, "default_step25.npz")
    first.save_checkpoint(path)
    second = ThermoViscoProblem(config=default_config(tc, 50), device=dev)
    second.setup()
    second.resume_from(path)
    resumed, ok2, _, _ = second.multi_step(second.state, 25)
    if not (ok and ok2) or abs(second.t - 2.5) > 1e-12:
        fail("the checkpointed run did not converge or lost its time")
    worst = 0.0
    for f, want in finals["matrix_free"]._asdict().items():
        if want is None:
            continue
        diff = float((getattr(resumed, f) - want).abs().max())
        worst = max(worst, diff / max(float(want.abs().max()), 1e-300))
    out["checkpoint_resume_max_rel"] = worst
    if not worst < 1e-12:
        fail(f"resumed run differs from the whole run: {worst:.3e}")
    log("default workload, assembled + checkpoint " + json.dumps(
        {k: out[k] for k in ("assembled_T_max_rel",
                             "checkpoint_resume_max_rel")}))
    return out


def dg_plate_config(tc, steps):
    """DG-1 T / CG-1 sigma at the config defaults (f64, rtol 1e-12), with
    SA-AMG and the matrix-free operator stated: 'auto' on a structured
    box asks for the DG multigrid, which the port does not have yet."""
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="DG", T_degree=1, sigma_family="CG",
                       sigma_degree=1),
        time=tc.TimeConfig(0.0, steps * 0.1, 0.1),
        solver=tc.SolverConfig(preconditioner="amg",
                               linear_operator="matrix_free"),
        output=tc.OutputConfig(write_every=0, formats=()), dtype="float64")


def dg_parity_phase(dev) -> dict:
    """The DG plate configuration at 8x8x4, 3 steps: GPU against CPU."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    res = {}
    for where in ("cpu", dev):
        p = ThermoViscoProblem(mesh=box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01),
                               config=dg_plate_config(tc, DG_PARITY_STEPS),
                               device=where)
        p.setup()
        st, ok, ni, ki = p.multi_step(p.state, DG_PARITY_STEPS)
        if not ok:
            fail(f"8x8x4 DG parity run did not converge on {where}")
        res[str(where)] = (st, ni, ki)
    (sc, nc, kc), (sg, ng, kg) = res["cpu"], res[str(dev)]
    out = dict(newton_cpu=nc, newton_gpu=ng, cg_cpu=kc, cg_gpu=kg)
    for f in ("T", "Tf"):
        a, b = getattr(sc, f).numpy(), getattr(sg, f).cpu().numpy()
        out[f"{f}_max_rel"] = float(np.abs(a - b).max() / np.abs(a).max())
        if not out[f"{f}_max_rel"] < 1e-9:
            fail(f"DG parity {f}: {out[f'{f}_max_rel']:.3e}")
    a, b = sc.sigma.numpy(), sg.sigma.cpu().numpy()
    out["sigma_rel_to_max"] = float(np.abs(a - b).max() / np.abs(a).max())
    if not out["sigma_rel_to_max"] <= 1e-6:
        fail(f"DG parity sigma: {out['sigma_rel_to_max']:.3e}")
    # Iteration counts are held looser than in the CG-1 parity phase. At
    # rtol 1e-12 both loops stop on the last bits: a CG solve takes ~80
    # iterations here, and the last Newton increment of a step lies within
    # rounding of its threshold. The card's atomic scatter-adds (six facet
    # terms per dof, summed in an order that changes from run to run) and
    # its reductions round differently from the CPU, so one Newton
    # iteration per step and 5% of the CG total are ties, not faults. The
    # fields above are the check of the result.
    if abs(nc - ng) > DG_PARITY_STEPS or abs(kc - kg) > 0.05 * kc:
        fail(f"DG parity iterations: newton {nc}/{ng}, cg {kc}/{kg}")
    log("DG parity " + json.dumps(out))
    return out


def dg_plate_phase(dev, port) -> dict:
    """Phase 6: the DG-1 plate at 524,288 T dofs on the card."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    t0 = time.perf_counter()
    prob = ThermoViscoProblem(
        mesh=box_mesh_3d(*N_DG, 1.0, 1.0, 0.01),
        config=dg_plate_config(tc, DG_TIMED_STEPS), device=dev)
    prob.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    spent = prob.setup_seconds
    n = prob.fs_T.n_scalar_dofs
    if n != 8 * int(np.prod(N_DG)):
        fail(f"DG plate has {n} dofs")
    levels = [int(lv["diag"].shape[0]) for lv in prob._amg.levels]
    log(f"DG plate: {n} dofs, setup {setup_s:.1f} s (heat operator "
        f"{spent['heat']:.1f} s, ELL {spent['ell']:.1f} s, AMG "
        f"{spent['amg']:.1f} s), AMG levels {levels}")

    st, ok, ni0, ki0 = prob.multi_step(prob.state, 1)      # warm-up
    torch.cuda.synchronize()
    if not ok:
        fail("DG plate warm-up step did not converge")
    state0 = prob.engine.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(port)
    t0 = time.perf_counter()
    st, ok, ni, ki = prob.multi_step(state0, DG_TIMED_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated(dev)
    if not ok:
        fail("DG plate timed window did not converge")
    for f in ("T", "Tf", "sigma"):
        if not bool(torch.isfinite(getattr(st, f)).all()):
            fail(f"DG plate: non-finite {f}")
    T_np = st.T.cpu().numpy()
    if not (prob.params.T_ambient - 1 < T_np.min() <= T_np.max()
            < prob.params.T_0 + 1):
        fail(f"DG plate T out of [T_ambient, T_0]: {T_np.min()} .. "
             f"{T_np.max()}")
    if launches["material_tspace"] != DG_TIMED_STEPS:
        fail(f"DG plate: material_tspace launched "
             f"{launches['material_tspace']} times")
    expect = ni + 2 * (ni + ki)
    if launches["dg_cell_residual"] == 0 or \
            launches["dg_cell_residual"] != expect:
        fail(f"DG plate: dg_cell_residual launched "
             f"{launches['dg_cell_residual']} times, expected {expect}")
    out = dict(dofs=n, setup_s=setup_s, heat_setup_s=spent["heat"],
               ell_setup_s=spent["ell"], amg_setup_s=spent["amg"],
               amg_levels=levels,
               newton_per_step=ni / DG_TIMED_STEPS,
               cg_per_step=ki / DG_TIMED_STEPS,
               ms_per_step=elapsed / DG_TIMED_STEPS * 1e3,
               launches=launches,
               k3_launches_per_step=launches["dg_cell_residual"]
               / DG_TIMED_STEPS,
               max_memory_allocated_bytes=peak,
               T_min=float(T_np.min()), T_max=float(T_np.max()))
    log("DG plate " + json.dumps(out))

    # K3 at the very tensors the residual hands it
    heat = prob.heat
    Tc, Tpc = st.T[heat.dofmap], st.T_prev[heat.dofmap]
    kw = dict(dt=prob.dt, c_mass=heat.c_mass, c_diff=heat.c_diff,
              f_src=prob.params.f)
    k, ref = port["dg_cell_residual"], port["dg_cell_residual_reference"]
    got = k(Tc, Tpc, heat.qw, heat.gphi, heat.phi, **kw)
    want = ref(Tc, Tpc, heat.qw, heat.gphi, heat.phi, **kw)
    mag = ref(Tc.abs(), -Tpc.abs(), heat.qw, heat.gphi.abs(),
              heat.phi.abs(), **dict(kw, f_src=-abs(kw["f_src"])))
    torch.cuda.synchronize()
    if bool(((got - want).abs() > 1e-12 * mag).any()):
        fail("dg_cell_residual disagrees with its plain version on the "
             "plate's state")
    out["k3_ms_in_path"] = time_ms(
        lambda: k(Tc, Tpc, heat.qw, heat.gphi, heat.phi, **kw))
    out["k3_max_abs_err_in_path"] = float((got - want).abs().max())
    out["residual_ms"] = time_ms(
        lambda: heat.residual(st.T, st.T_prev, prob.dt), reps=10)
    v = torch.ones_like(st.T)
    out["jvp_matvec_ms"] = time_ms(lambda: torch.func.jvp(
        lambda u: heat.residual(u, st.T_prev, prob.dt), (st.T,), (v,)),
        reps=10)
    pc = prob._amg.preconditioner()
    out["amg_vcycle_ms"] = time_ms(lambda: pc(v), reps=10)
    log("DG plate layers " + json.dumps(
        {k_: out[k_] for k_ in ("k3_ms_in_path", "residual_ms",
                                "jvp_matvec_ms", "amg_vcycle_ms")}))
    return out


def profile(prob, dev, out_dir) -> None:
    """torch.profiler over 5 full-size steps: kernel time by name and the
    device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    os.makedirs(out_dir, exist_ok=True)
    state = prob.engine.init_state()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prob.multi_step(state, 5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    attr = ("device_time_total" if hasattr(ka[0], "device_time_total")
            else "cuda_time_total")
    busy_us = sum(getattr(e, attr) for e in ka
                  if getattr(e, "device_type", None) is not None
                  and "CUDA" in str(e.device_type))
    table = ka.table(sort_by=attr, row_limit=25)
    with open(os.path.join(out_dir, "profile.txt"), "w") as fh:
        fh.write(f"wall {wall * 1e3:.3f} ms for 5 steps\n{table}\n")
    log(f"profile: wall {wall * 1e3:.3f} ms / 5 steps, device kernels "
        f"{busy_us / 1e3:.3f} ms (busy share {busy_us / 1e3 / (wall * 1e3):.3f})")
    log(table)


def csr_library_ms(vals2, x, grid):
    """One PyTorch call that computes K2's function: a CSR sparse matrix
    holding the same 27 entries per row, times x -> (ms, its y)."""
    gx, M = vals2.shape[1], vals2.shape[2]
    n = gx * M
    gz = grid[-1]
    idx = torch.arange(n, device=x.device)
    i, m = idx // M, idx % M
    rows, cols, vs = [], [], []
    o = 0
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                s = (dy - 1) * gz + (dz - 1)
                r, c = i + dx - 1, m + s
                ok = (r >= 0) & (r < gx) & (c >= 0) & (c < M)
                rows.append(idx[ok])
                cols.append((r * M + c)[ok])
                vs.append(vals2[o].reshape(-1)[ok])
                o += 1
    A = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                             torch.cat(cols)]),
                                torch.cat(vs), (n, n)).coalesce()
    A = A.to_sparse_csr()
    del rows, cols, vs
    y = (A @ x[:, None])[:, 0]
    torch.cuda.synchronize()
    return time_ms(lambda: A @ x[:, None], reps=20), y


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="trace 5 full-size steps with torch.profiler and "
                         "write DIR/profile.txt")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from fem_glass_tempering_tpu_torch.ops import kernel_lib
    from fem_glass_tempering_tpu_torch.ops.cuda_kernels import (
        material_tspace,
        material_tspace_reference,
    )
    from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
        dg_cell_residual,
        dg_cell_residual_reference,
    )
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
        stencil_matvec,
        stencil_matvec_reference,
    )
    port = dict(dg_cell_residual=dg_cell_residual,
                dg_cell_residual_reference=dg_cell_residual_reference,
                material_tspace=material_tspace,
                material_tspace_reference=material_tspace_reference,
                stencil_matvec=stencil_matvec,
                stencil_matvec_reference=stencil_matvec_reference)
    if torch.cuda.device_count() < 1:
        fail("no CUDA device")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    lib = kernel_lib.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {lib.build_seconds:.1f} s) -> {lib.path}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  " + line.strip())

    # ---- phase 2: kernels against their plain versions ----
    k1 = check_material_tspace(dev, port)
    k2_small = []
    for grid in ((9, 7, 5), (12, 6, 3), (10, 8)):
        v2, x = stencil_case(grid, torch.float64, dev)
        k2_small.append(check_stencil(v2, x, grid, 1e-12, port))
    log(f"K2 zero-at-missing-neighbour grids f64 max |diff| {k2_small}")
    k3 = check_dg_cell(dev, port)

    # ---- phase 3: parity of the whole path, GPU vs CPU ----
    parity_phase(dev)

    # ---- phase 4: the full-size main path ----
    full = full_size_phase(dev, port, args.profile)
    vals2, x, grid = full.pop("vals_fine"), full.pop("x_fine"), full.pop("grid")
    full.pop("state")
    k2_err = check_stencil(vals2, x, grid, 1e-5, port)
    n = x.numel()
    b, by = bound_ms(29 * n * 4, K2_OPS_PER_POINT * n, torch.float32)
    k2_ms = time_ms(lambda: stencil_matvec(vals2, x, grid))
    k2_device_ms = device_ms(lambda: stencil_matvec(vals2, x, grid))
    k2_plain = time_ms(lambda: stencil_matvec_reference(vals2, x, grid),
                       reps=10)
    lib_ms, y_lib = csr_library_ms(vals2, x, grid)
    y = stencil_matvec(vals2, x, grid)
    mag = stencil_matvec_reference(vals2.abs(), x.abs(), grid)
    if bool(((y - y_lib).abs() > 1e-5 * mag).any()):
        fail("the CSR yardstick disagrees with the kernel")
    del y_lib
    del vals2, x
    torch.cuda.empty_cache()

    # ---- phase 5: the default workload ----
    scratch_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "chip_smoke")
    os.makedirs(scratch_dir, exist_ok=True)
    default = default_workload_phase(dev, port, scratch_dir)

    # ---- phase 6: the DG-1 plate, small against the CPU, then full ----
    dg_parity_phase(dev)
    plate = dg_plate_phase(dev, port)

    k1_32 = k1["float32"]
    sigma_ms = full["material_step_ms"] - k1_32["ms"]
    log(f"material step {full['material_step_ms']:.4f} ms, of which K1 "
        f"{k1_32['ms']:.4f} ms, sigma-space chain (plain torch) "
        f"{sigma_ms:.4f} ms")
    kernels = [
        dict(name="material_tspace", route="cuda",
             source="fem_glass_tempering_tpu_torch/csrc/material_tspace.cu",
             replaces="fem_glass_tempering_tpu/ops/pallas_kernels.py:88",
             launches=full["launches"]["material_tspace"],
             max_abs_err=k1_32["max_abs_err"], ms=k1_32["ms"],
             plain_ms=k1_32["plain_ms"], bound_ms=k1_32["bound_ms"],
             bound_by=k1_32["bound_by"], library_ms=None,
             device_ms=k1_32["device_ms"]),
        dict(name="stencil_matvec", route="cuda",
             source="fem_glass_tempering_tpu_torch/csrc/stencil_matvec.cu",
             replaces="fem_glass_tempering_tpu/ops/pallas_stencil.py:54",
             launches=full["launches"]["stencil_matvec"],
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain, bound_ms=b,
             bound_by=by, library_ms=lib_ms, device_ms=k2_device_ms),
        # timed at the DG plate's shape (65,536 hex cells, uniform tables,
        # f64); no single PyTorch call computes this function
        dict(name="dg_cell_residual", route="cuda",
             source="fem_glass_tempering_tpu_torch/csrc/dg_cell_residual.cu",
             replaces="fem_glass_tempering_tpu/ops/pallas_kernels.py:218",
             launches=plate["launches"]["dg_cell_residual"],
             max_abs_err=k3["uniform"]["max_abs_err"],
             ms=k3["uniform"]["ms"], plain_ms=k3["uniform"]["plain_ms"],
             bound_ms=k3["uniform"]["bound_ms"],
             bound_by=k3["uniform"]["bound_by"], library_ms=None,
             device_ms=k3["uniform"]["device_ms"],
             plain_device_ms=k3["uniform"]["plain_device_ms"],
             launches_default_run=default["launches"]["dg_cell_residual"],
             per_cell_tables=k3["per_cell"]),
    ]
    for k in kernels:
        log(json.dumps(k))
    log("summary " + json.dumps(dict(full, sigma_chain_ms=sigma_ms,
                                     k1_f64=k1["float64"])))
    log("summary default workload " + json.dumps(default))
    log("summary DG plate " + json.dumps(plate))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
