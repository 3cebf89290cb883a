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
prints both counts, without holding them; `--plain-cell-term` runs the cell
term's plain PyTorch version on the card in place of K3, to isolate what
moves the counts. `kernels` times K1 (material_tspace, n = 1,062,761, f32 and f64) and K3
(dg_cell_residual, 65,536 hex cells, f64, uniform and per-cell tables; the
direct call, and the prepared call where the tree has one) as chip_smoke's
`device_ms` does: captured into a CUDA graph and replayed, the median of
five such measurements. `phase5`, `phase6` and `phase8b` run that phase
of the tree's chip_smoke alone. `--source-flags SRC:FLAG[,FLAG]` replaces the per-source
nvcc flags of a tree that has them, to compare builds of one source.
Prints one line `AB {...}` of JSON with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", help="root of the checkout to measure")
    ap.add_argument("what", choices=("kernels", "phase5", "phase6",
                                     "phase8b", "dgparity"))
    ap.add_argument("--source-flags", default="", metavar="SRC:FLAG[,FLAG]",
                    help="replace one source's nvcc flags (empty FLAG: none)")
    ap.add_argument("--plain-cell-term", action="store_true",
                    help="run the cell term's plain version on the card")
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
    if args.plain_cell_term:
        init = cuda_dg_cell.PreparedDGCellResidual.__init__

        def plain_init(self, *a, **kw):
            init(self, *a, **kw)
            self.path = "plain"
        cuda_dg_cell.PreparedDGCellResidual.__init__ = plain_init
    port = {name: getattr(mod, name)
            for mod in (cuda_dg_cell, cuda_kernels, cuda_stencil)
            for name in ("PreparedDGCellResidual", "dg_cell_residual",
                         "dg_cell_residual_reference", "material_tspace",
                         "material_tspace_reference", "stencil_matvec",
                         "stencil_matvec_reference") if hasattr(mod, name)}
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if args.what == "kernels":
        res = measure_kernels(cs, port, dev)
    elif args.what == "dgparity":
        res = measure_dg_parity(cs, dev)
        res["k3_launches"] = cuda_dg_cell.dg_cell_residual.launches
    elif args.what == "phase8b":
        full = cs.mechanics_plate_phase(dev, port)
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
        plain_cell_term=args.plain_cell_term,
        card=cs.card_line(), torch=torch.__version__, **res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
