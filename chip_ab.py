"""Measure one checkout of the port on the card, for A/B comparisons.

Two versions are compared only within one call on one card, in turns
(PERF.md): unpack the other version beside this one (`git archive REV |
tar -x -C build/parent_tree`), then run this script once per tree and
turn, e.g. parent, change, change, parent:

    python3 chip_ab.py build/parent_tree kernels
    python3 chip_ab.py . kernels
    python3 chip_ab.py . kernels --source-flags dg_cell_residual.cu:-fmad=false
    python3 chip_ab.py build/parent_tree phase6
    python3 chip_ab.py . phase6

TREE is the root of a checkout that holds `chip_smoke.py` and the port's
package; everything is imported from there and built into TREE/build.
`dgparity` runs chip_smoke's 8x8x4 DG parity problem (SA-AMG,
matrix-free: K3 carries the cell term) on the CPU and on the card and
prints both counts, without holding them. To isolate what moves the card's
count, each of these flags moves one part of the card's arithmetic (it
leaves the CPU run's bits as they are): `--plain-cell-term` runs the cell
term's plain PyTorch version on the card in place of K3; `--cpu-dots`
computes the Newton and Krylov dot products and norms from CPU copies in
f64; `--cpu-spmv` computes every ELL SpMV (ops/spmv.py EllMatrix.matvec
and the SA-AMG levels' and transfers' ELL products) on CPU copies;
`--cpu-amg` runs the whole SA-AMG V-cycle on CPU copies of its levels;
`--cpu-residual` evaluates the gather residual (and so the matrix-free
Jacobian action, its jvp) and the diagonal on a CPU twin of the card's
heat operator.
`phase9` runs chip_smoke's phase 9 (the CG-2 lattice path) alone;
`phase11` runs chip_smoke's phase 4 (the full-size plate, whose warm-up
chunk phase 11 is held to) and phase 11 (the command-line entry point);
`phase10` runs phase 2's degree-2 K3 checks and phase 10 (the degree-2
parity cases, the CG-2 gather plate, the mixed CG-2 plate) alone.
`phase12` runs phase 12 alone (12a the 1M-dof mixed plate with bf16
V-cycle tables and its "same" arm, with K2's bf16-table instantiation
checked and timed; 12b-12e: bf16 parity, the custom-PDE API,
solve_scan, the native runtime), with each part's seconds.
`phase13` runs phase 13 alone (shard_problem and CGDDProblem: the
unsharded and one-NCCL-rank runs in this process, then two gloo ranks
on the card), with its seconds; `phase13d` phase 13d alone (the
grid-sharded CG-1 step: the small cases, the 1M-dof plate and the
coupled mechanics plate over one NCCL rank and two gloo ranks, K2's halo
form checked and timed), after phase 8b, whose state 13d(c) is held to,
then side phase 13d64 (the dry run's mechanics config in f64);
`phase13e` side phase 13e alone (the multi-process entry under torchrun,
two gloo ranks on the card, against the unsharded run); `phase13f` side
phase 13f alone (the grid-sharded DG-1 step: the small plates and phase
7b's 64x64x16 plate over one NCCL rank and two gloo ranks), after phase
7b, whose f64 run 13f(b) is held to; `phase13g` side phase 13g alone (the
grid-sharded CG-2 step: the small plates and phase 9b's 64x64x16 plate
over one NCCL rank and two gloo ranks), then phase 9b, which holds
13g(b)'s step 1 to its warm-up step.
`dryrunmech` runs phase 13d's dry-run mechanics config (12x6x4, 2 steps)
over one rank and over two gloo ranks, in f32 and in f64, on the CPU and
on the card, with every elasticity CG logged (the copy of solver/krylov.py
pcg in `_logged_pcg`, capped at DRYRUN_MECH_CAP iterations): its count,
its relative residual by iteration, its true residual at exit and how
often p'Ap came out <= 0, with |sigma| max of the last state.
`kernels` times K1 (material_tspace, n = 1,062,761, f32 and f64), K3
(dg_cell_residual, 65,536 hex cells, f64, uniform and per-cell tables; the
direct call, and the prepared call where the tree has one; and the
degree-2 shapes of phase 2: nloc 27 uniform f32 at 65,536 and 27,648
cells and f64, nloc 10 per-cell f64 at 67,584 tetrahedra, nloc 27
per-cell f32 and f64 at 27,648 hexes) and K2
(stencil_matvec on the 161x161x41 fine level: f32 and f64 tables, and
bf16 tables under an f32 and an f64 vector, bit-equal to the plain twin)
as chip_smoke's `device_ms` does: captured into a CUDA graph and
replayed, the median of five such measurements. `phase5`, `phase6` and `phase8b` run that phase
of the tree's chip_smoke alone. `--source-flags SRC:FLAG[,FLAG]` replaces the per-source
nvcc flags of a tree that has them, to compare builds of one source.
Prints one line `AB {...}` of JSON with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

import numpy as np


def measure_kernels(cs, port, dev) -> dict:
    import torch

    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.viscoelastic import (
        LAMBDA_M_N,
        M_N,
    )

    def median_ms(fn):
        return float(np.median([cs.device_ms(fn) for _ in range(5)]))

    out = {}
    n = int(np.prod([d + 1 for d in cs.N_FULL]))
    kw = dict(dt=0.1, H_over_Rg=627.8e3 / 8.314, Tb=869.0, m_n=M_N,
              lambda_m_n=LAMBDA_M_N)
    k1 = port["material_tspace"]
    for dtype in (torch.float32, torch.float64):
        rng = np.random.default_rng(0)
        T = torch.tensor(600.0 + 250.0 * rng.random(n), dtype=dtype,
                         device=dev)
        Tp = T + 1.0
        Tfp = torch.tensor(600.0 + 250.0 * rng.random((n, 6)), dtype=dtype,
                           device=dev)
        out[f"k1_{str(dtype).split('.')[-1]}_device_ms"] = median_ms(
            lambda: k1(T, Tp, Tfp, **kw))
    plate = box_mesh_3d(*cs.N_DG, 1.0, 1.0, 0.01)
    k3 = port["dg_cell_residual"]
    kw = dict(dt=0.1, c_diff=1.0, f_src=0.0)
    for uniform in (True, False):
        shape, qw, gphi, phi = cs.dg_tables(plate, torch.float64, dev,
                                            uniform)
        rng = np.random.default_rng(11)
        Tc = torch.tensor(700.0 + 100.0 * rng.random(shape),
                          dtype=torch.float64, device=dev)
        Tpc = Tc + 1.0
        key = "k3_uniform" if uniform else "k3_per_cell"
        out[f"{key}_direct_call_device_ms"] = median_ms(
            lambda: k3(Tc, Tpc, qw, gphi, phi, **kw))
        if "PreparedDGCellResidual" in port:
            call = port["PreparedDGCellResidual"](qw, gphi, phi)
            out[f"{key}_prepared_call_device_ms"] = median_ms(
                lambda: call(Tc, Tpc, **kw))
            out[f"{key}_prepared_call_ms"] = cs.time_ms(
                lambda: call(Tc, Tpc, **kw))
        out[f"{key}_direct_call_ms"] = cs.time_ms(
            lambda: k3(Tc, Tpc, qw, gphi, phi, **kw))
        del qw, gphi
    out.update(measure_k3_degree2(cs, dev, median_ms))
    out.update(measure_k2(cs, dev, median_ms))
    return out


def measure_k3_degree2(cs, dev, median_ms) -> dict:
    """K3 at the degree-2 shapes of phase 2, in the heat operator's
    prepared call: nloc 27 with uniform tables (the 64x64x16 CG-2 plate's
    65,536 hexes in f32 and f64, and phase 10b's 27,648 in f32), nloc 10
    with per-cell f64 tables (67,584 tetrahedra) and nloc 27 with per-cell
    f32 and f64 tables (phase 10b's 48x48x12 plate without its box
    metadata, as a non-uniform hex mesh gives)."""
    import torch

    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d

    out = {}
    hexes = box_mesh_3d(4, 4, 1, 4 / cs.N_CG2[0], 4 / cs.N_CG2[1],
                        0.01 / cs.N_CG2[2])
    per_cell_hexes = box_mesh_3d(48, 48, 12, 1.0, 1.0, 0.01)
    per_cell_hexes.structured = None
    kw = dict(dt=0.1, c_mass=1.0, c_diff=0.83, f_src=0.0)
    for key, mesh, dtype, cells in (
            ("k3_nloc27_uniform_f32", hexes, torch.float32, 65536),
            ("k3_nloc27_uniform_f32_10b", hexes, torch.float32, 27648),
            ("k3_nloc27_uniform_f64", hexes, torch.float64, 65536),
            ("k3_nloc10_per_cell_f64", box_mesh_3d(32, 32, 11,
                                                   cell_type="tet"),
             torch.float64, None),
            ("k3_nloc27_per_cell_f32", per_cell_hexes, torch.float32, None),
            ("k3_nloc27_per_cell_f64", per_cell_hexes, torch.float64, None)):
        heat, shape = cs.heat_tables(mesh, "CG", dtype, dev)
        shape = (cells or shape[0], shape[1])
        rng = np.random.default_rng(12)
        Tc = torch.tensor(700.0 + 100.0 * rng.random(shape), dtype=dtype,
                          device=dev)
        Tpc = Tc + 1.0
        call = heat._cell_term
        out[f"{key}_path"] = call.path
        out[f"{key}_device_ms"] = median_ms(lambda: call(Tc, Tpc, **kw))
        out[f"{key}_ms"] = cs.time_ms(lambda: call(Tc, Tpc, **kw))
        del heat, call, Tc, Tpc
    return out


def measure_k2(cs, dev, median_ms) -> dict:
    """K2 on random tables of the 161x161x41 fine level: f32 and f64
    tables, and bf16 tables under an f32 and an f64 vector (in the layout
    the tree's V-cycle gives them: pitched where the tree has
    `pitched_tables`), bit-equal to the plain twin."""
    import torch

    from fem_glass_tempering_tpu_torch.ops import cuda_stencil

    grid = tuple(d + 1 for d in cs.N_FULL)
    n = int(np.prod(grid))
    k = cuda_stencil.stencil_matvec
    rng = np.random.default_rng(3)
    vals = torch.tensor(rng.standard_normal((27, n)), dtype=torch.float32,
                        device=dev).reshape(27, grid[0], -1)
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        x = torch.tensor(rng.standard_normal(n), dtype=dtype, device=dev)
        v = vals.to(dtype)
        out[f"k2_{name}_tables_device_ms"] = median_ms(lambda: k(v, x, grid))
        del v
        pitched = getattr(cuda_stencil, "pitched_tables", None)
        vb = pitched(vals) if pitched else vals.to(torch.bfloat16)
        tag = f"k2_bf16_tables_{name}_vector"
        out[f"{tag}_equal"] = bool(torch.equal(
            k(vb, x, grid), cuda_stencil.stencil_matvec_reference(vb, x,
                                                                  grid)))
        out[f"{tag}_device_ms"] = median_ms(lambda: k(vb, x, grid))
        del vb
    return out


def measure_dg_parity(cs, dev) -> dict:
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )

    out, fields = {}, {}
    for tag, where in (("cpu", "cpu"), ("gpu", dev)):
        p = ThermoViscoProblem(mesh=box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01),
                               config=cs.dg_plate_config(
                                   tc, cs.DG_PARITY_STEPS), device=where)
        p.setup()
        st, ok, ni, ki = p.multi_step(p.state, cs.DG_PARITY_STEPS)
        out.update({f"converged_{tag}": bool(ok), f"newton_{tag}": ni,
                    f"cg_{tag}": ki})
        fields[tag] = st.T.cpu().numpy()
    a, b = fields["cpu"], fields["gpu"]
    out["T_max_rel"] = float(np.abs(a - b).max() / np.abs(a).max())
    return out


DRYRUN_MECH_CAP = 300


def _logged_pcg(log, cap):
    """solver/krylov.py pcg (no stall window, no residual replacement),
    capped at `cap` iterations, appending each solve's record to `log`."""
    import torch

    def pcg(matvec, b, *, x0=None, diag=None, rtol=1e-12, atol=0.0,
            max_it=1000, dot=None, precond=None, rtol_r0=0.0, **_):
        def norm(v):
            return torch.sqrt(dot(v, v))
        x = torch.zeros_like(b) if x0 is None else x0
        r = b - matvec(x)
        z = precond(r)
        p, rz = z, dot(r, z)
        bn, rn = norm(b), norm(r)
        tol = torch.clamp(rtol * bn, min=atol)
        if rtol_r0:
            tol = torch.maximum(tol, torch.where(
                rn < 0.3 * bn, rtol_r0 * rn, torch.zeros_like(rn)))
        hist, bad, k = [float(rn / bn)], 0, 0
        while k < min(max_it, cap) and bool(rn > tol):
            Ap = matvec(p)
            pAp = dot(p, Ap)
            bad += int(bool(pAp <= 0))
            alpha = rz / pAp
            x, r = x + alpha * p, r - alpha * Ap
            z = precond(r)
            rz_new = dot(r, z)
            p, rz = z + rz_new / rz * p, rz_new
            rn = norm(r)
            k += 1
            hist.append(float(rn / bn))
        log.append(dict(iters=k, converged=bool(rn <= tol),
                        tol_rel=float(tol / bn),
                        true_rel=float(norm(b - matvec(x)) / bn),
                        nonpositive_pAp=bad, rel_residual_first=hist[:13],
                        rel_residual_last=hist[-3:]))
        return SimpleNamespace(x=x, iters=k, converged=bool(rn <= tol),
                               residual_norm=rn)
    return pcg


def _dryrun_mech_body(mesh_dev, dtype) -> dict:
    """One rank of the dry-run mechanics config at `dtype`, its
    elasticity CG logged (`_logged_pcg`)."""
    import dataclasses

    import chip_smoke as cs
    import fem_glass_tempering_tpu_torch.models.mechanics as mech
    from fem_glass_tempering_tpu_torch.parallel.grid_shard import (
        GridShardedProblem,
    )
    make_mesh, cfg, _ = cs.gs_cases()["dryrun_mech"]
    log = []
    mech.pcg = _logged_pcg(log, DRYRUN_MECH_CAP)
    gs = GridShardedProblem(make_mesh(), dataclasses.replace(cfg, dtype=dtype),
                            mesh_dev)
    st, ok, ni, ki = gs.run(gs.init_state(), cs.GS_DRYRUN_STEPS)
    sigma = gs.gather_state(st).sigma
    return dict(newton=ni, cg=ki, elast=log,
                sigma_abs_max=float(sigma.abs().max()))


def measure_dryrun_mech(dev) -> dict:
    from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks
    out = {}
    for where in ("cpu", str(dev)):
        for P in (1, 2):
            for dtype in ("float32", "float64"):
                res = run_ranks(_dryrun_mech_body, P, where, dtype,
                                backend="gloo" if P > 1 else None,
                                threads=2, timeout=400)
                out[f"{where}_P{P}_{dtype}"] = res[0]
    return out


def _on_cpu(fn):
    """fn computed from CPU copies of its tensor arguments, the result
    moved back to the first tensor argument's device."""
    import torch

    def wrapped(*args):
        dev = next(a.device for a in args if isinstance(a, torch.Tensor))
        out = fn(*(a.cpu() if isinstance(a, torch.Tensor) else a
                   for a in args))
        return out.to(dev)
    return wrapped


def patch_parity_variants(args) -> None:
    """Monkeypatch the parts of the card's arithmetic that the dgparity
    flags move onto the CPU (nothing in the package has a switch)."""
    import functools

    import torch

    from fem_glass_tempering_tpu_torch.models import problem
    from fem_glass_tempering_tpu_torch.ops import cuda_dg_cell, heat, spmv
    from fem_glass_tempering_tpu_torch.solver import amg, newton
    if args.plain_cell_term:
        init = cuda_dg_cell.PreparedDGCellResidual.__init__

        def plain_init(self, *a, **kw):
            init(self, *a, **kw)
            self.path = "plain"
        cuda_dg_cell.PreparedDGCellResidual.__init__ = plain_init
    if args.cpu_dots:
        cpu_dot = _on_cpu(lambda u, v: torch.dot(u.reshape(-1),
                                                 v.reshape(-1)))
        problem.newton_solve = functools.partial(newton.newton_solve,
                                                 dot=cpu_dot)
    if args.cpu_spmv:
        ell_mv = _on_cpu(lambda cols, vals, x: (vals * x[cols]).sum(dim=1))
        spmv.EllMatrix.matvec = lambda self, vals, x: ell_mv(self.cols,
                                                             vals, x)
        amg.SmoothedAggregationMG._ell_mv = staticmethod(ell_mv)
    if args.cpu_amg:
        pre = amg.SmoothedAggregationMG.preconditioner

        def cpu_preconditioner(self, T=None, dt=None):
            if not hasattr(self, "_cpu_twin"):
                twin = object.__new__(type(self))
                twin.__dict__.update(self.__dict__)
                twin.levels = [{k: (v.cpu() if isinstance(v, torch.Tensor)
                                    else v) for k, v in lv.items()}
                               for lv in self.levels]
                twin.transfers = [{k: (v.cpu() if isinstance(v, torch.Tensor)
                                       else v) for k, v in t.items()}
                                  for t in self.transfers]
                self._cpu_twin = twin
            apply = pre(self._cpu_twin, T, dt)
            return lambda r: apply(r.cpu()).to(r.device)
        amg.SmoothedAggregationMG.preconditioner = cpu_preconditioner
    if args.cpu_residual:
        H = heat.HeatOperator
        h_init, residual, diag = H.__init__, H.residual, H.jacobian_diag

        def init_with_twin(self, fs, params, dt, **kw):
            h_init(self, fs, params, dt, **kw)
            if self.device.type == "cuda":
                self._cpu_twin = H(fs, params, dt, **dict(kw, device="cpu"))

        def twin_call(fn):
            def call(self, T, *rest, **kw):
                twin = getattr(self, "_cpu_twin", None)
                if twin is None:
                    return fn(self, T, *rest, **kw)
                return fn(twin, T.cpu(), *(r.cpu() if isinstance(
                    r, torch.Tensor) else r for r in rest), **kw).to(T.device)
            return call
        H.__init__ = init_with_twin
        H.residual = twin_call(residual)
        H.jacobian_diag = twin_call(diag)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", help="root of the checkout to measure")
    ap.add_argument("what", choices=("kernels", "phase5", "phase6",
                                     "phase8b", "phase9", "phase10",
                                     "phase11", "phase12", "phase13",
                                     "phase13d", "phase13e", "phase13f",
                                     "phase13g",
                                     "dgparity",
                                     "dryrunmech"))
    ap.add_argument("--source-flags", default="", metavar="SRC:FLAG[,FLAG]",
                    help="replace one source's nvcc flags (empty FLAG: none)")
    ap.add_argument("--plain-cell-term", action="store_true",
                    help="run the cell term's plain version on the card")
    ap.add_argument("--cpu-dots", action="store_true",
                    help="Newton and Krylov dot products on CPU copies")
    ap.add_argument("--cpu-spmv", action="store_true",
                    help="every ELL SpMV on CPU copies")
    ap.add_argument("--cpu-amg", action="store_true",
                    help="the SA-AMG V-cycle on CPU copies")
    ap.add_argument("--cpu-residual", action="store_true",
                    help="the gather residual and diagonal on a CPU twin")
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device visible", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from fem_glass_tempering_tpu_torch.ops import (
        cuda_dg_cell,
        cuda_kernels,
        cuda_stencil,
        kernel_lib,
    )
    if args.source_flags:
        src, _, flags = args.source_flags.partition(":")
        if src not in getattr(kernel_lib, "SOURCE_FLAGS", {}):
            print(f"chip_ab: {root} has no per-source flags for {src!r}",
                  file=sys.stderr)
            return 1
        kernel_lib.SOURCE_FLAGS[src] = tuple(f for f in flags.split(",") if f)
    patch_parity_variants(args)
    port = {name: getattr(mod, name)
            for mod in (cuda_dg_cell, cuda_kernels, cuda_stencil)
            for name in ("PreparedDGCellResidual", "dg_cell_residual",
                         "dg_cell_residual_reference", "material_tspace",
                         "material_tspace_reference", "stencil_matvec",
                         "stencil_matvec_halo", "stencil_matvec_reference")
            if hasattr(mod, name)}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.what == "kernels":
        res = measure_kernels(cs, port, dev)
    elif args.what == "dgparity":
        res = measure_dg_parity(cs, dev)
        res["k3_launches"] = cuda_dg_cell.dg_cell_residual.launches
    elif args.what == "dryrunmech":
        res = measure_dryrun_mech(dev)
    elif args.what == "phase9":
        parity = cs.cg2_parity_phase(dev, port)
        cs.drop_garbage("phase 9b")
        full = cs.cg2_plate_phase(dev, port)
        res = dict(parity=parity, plate=full)
    elif args.what == "phase10":
        k3 = cs.check_dg_cell_degree2(dev, port)
        parity = cs.degree2_parity_phase(dev, port)
        cs.drop_garbage("phase 10b")
        gather = cs.gather_plate_phase(dev, port)
        cs.drop_garbage("phase 10c")
        mixed = cs.mixed_plate_phase(dev, port)
        res = dict(k3_degree2=k3, parity=parity, gather=gather, mixed=mixed)
    elif args.what == "phase11":
        full = cs.full_size_phase(dev, port, None)
        warmup = full.pop("warmup")
        per_apply = full["stencil_launches_per_apply"]
        del full
        cs.drop_garbage("phase 11")
        scratch = os.path.join(root, "build", "chip_smoke")
        os.makedirs(scratch, exist_ok=True)
        t0 = time.perf_counter()
        res = cs.cli_phase(dev, port, warmup, per_apply, scratch)
        res["phase11_s"] = time.perf_counter() - t0
    elif args.what == "phase12":
        scratch = os.path.join(root, "build", "chip_smoke")
        os.makedirs(scratch, exist_ok=True)
        res, seconds = {}, {}
        for part, run in (
                ("bf16_plate", lambda: cs.bf16_plate_phase(dev, port)),
                ("bf16_parity", lambda: cs.bf16_parity_phase(dev, port)),
                ("forms", lambda: cs.forms_phase(dev, port)),
                ("solve_scan", lambda: cs.solve_scan_phase(dev, port)),
                ("native", lambda: cs.native_phase(dev, scratch))):
            cs.drop_garbage(part)
            t0 = time.perf_counter()
            res[part] = run()
            seconds[part] = time.perf_counter() - t0
        res["seconds"] = seconds
    elif args.what == "phase13":
        t0 = time.perf_counter()
        res = cs.distributed_phase(dev, port)
        res["phase13_s"] = time.perf_counter() - t0
    elif args.what == "phase13d":
        # 13d(c) is held to phase 8b's state: 8b first
        t0 = time.perf_counter()
        mech_ref = cs.mechanics_plate_phase(dev, port).pop("reference")
        res = dict(phase8b_s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        res.update(cs.grid_shard_phase(dev, port, mech_ref))
        res["phase13d_s"] = time.perf_counter() - t0
        res["13d64"] = cs.dryrun64_phase(dev, port)
    elif args.what == "phase13e":
        res = cs.multihost_phase(dev)
    elif args.what == "phase13f":
        # 13f(b) is held to phase 7b's f64 run: 7b first
        scratch = os.path.join(root, "build", "chip_smoke")
        os.makedirs(scratch, exist_ok=True)
        t0 = time.perf_counter()
        cs.dg_auto_plate_phase(dev, port, os.path.join(scratch,
                                                       cs.PHASE7B_REF))
        res = dict(phase7b_s=time.perf_counter() - t0)
        t0 = time.perf_counter()
        res.update(cs.grid_shard_dg_phase(dev, port, scratch))
        res["phase13f_s"] = time.perf_counter() - t0
    elif args.what == "phase13g":
        # phase 9b holds 13g(b)'s step 1: 13g first
        scratch = os.path.join(root, "build", "chip_smoke")
        os.makedirs(scratch, exist_ok=True)
        t0 = time.perf_counter()
        res = cs.grid_shard_q2_phase(dev, port, scratch)
        res["phase13g_s"] = time.perf_counter() - t0
        cs.drop_garbage("phase 9b")
        t0 = time.perf_counter()
        res["phase9b"] = cs.cg2_plate_phase(dev, port, scratch)
        res["phase9b_s"] = time.perf_counter() - t0
    elif args.what == "phase8b":
        full = cs.mechanics_plate_phase(dev, port)
        full.pop("reference")
        res = {k: full[k] for k in (
            "ms_per_step", "newton_per_step", "cg_per_step",
            "elast_cg_per_step", "setup_s", "layers_ms",
            "max_memory_allocated_bytes")}
    elif args.what == "phase5":
        scratch = os.path.join(root, "build", "chip_smoke")
        os.makedirs(scratch, exist_ok=True)
        full = cs.default_workload_phase(dev, port, scratch)
        res = {k: full[k] for k in ("ms_per_step", "newton", "cg")}
    else:
        full = cs.dg_plate_phase(dev, port)
        res = {k: full[k] for k in (
            "ms_per_step", "newton_per_step", "cg_per_step", "setup_s",
            "jvp_matvec_ms", "residual_ms", "amg_vcycle_ms", "k3_ms_in_path",
            "max_memory_allocated_bytes")}
    print("AB " + json.dumps(dict(
        tree=args.tree, what=args.what, source_flags=args.source_flags,
        plain_cell_term=args.plain_cell_term, cpu_dots=args.cpu_dots,
        cpu_spmv=args.cpu_spmv, cpu_amg=args.cpu_amg,
        cpu_residual=args.cpu_residual,
        card=cs.card_line(), torch=torch.__version__, **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
