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
     without a per-point source, forward and through torch.func.jvp,
     through both of its kernels (uniform tables by value in a prepared
     call, tables in device memory in a direct call), on cell counts that
     fill no whole block or warp, and on shapes with more quadrature
     points than local dofs; the host's share of a call, piece by piece;
  3. parity of the whole path: a 16x16x8 f64 plate, 10 steps, stencil
     operator + geometric MG, Newton rtol 1e-10 -- the port on the GPU
     (kernels) against the port on the CPU (plain versions);
  4. the full-size run: the 3D CG-1 float-glass plate 160x160x40 cells
     (1,062,761 T dofs) in f32 at Newton/CG rtol 1e-5, stencil operator,
     Chebyshev-smoothed geometric MG, jac_every auto (= 5): one 5-step
     warm-up chunk (its T and counts kept for phase 11), then 20 timed
     steps from a fresh initial state, with every kernel launch counter
     set to 0 just before the timed window and read just after;
  5. the default workload: ThermoViscoProblem() with no argument but the
     device (DG-1 / SIPG heat on the graded 1D slab, 96 T dofs, f64,
     Newton and CG rtol 1e-12, matrix-free CG, SA-AMG), 500 steps, held
     to the golden values and the Newton count of the CPU reference; then
     SIDE_STEPS (10) steps with the assembled ELL operator against the
     matrix-free run, and a checkpoint written at step 5 and resumed to
     step 10, equal to the whole run bit for bit in every field;
  6. the DG-1 plate on SA-AMG: 48x48x12 hex cells, 221,184 T dofs (the
     64x64x16 plate's host setup took 60-151 s), f64, rtol 1e-12,
     matrix-free CG + SA-AMG, 1 warm-up step and 1 timed step; before
     it the same configuration at 8x8x4 twice on the GPU (equal bits:
     the gather residual's scatter-adds are grouped, ops/scatter.py) and
     against the port on the CPU (fields tight, Newton equal, CG within
     1%: see dg_parity_phase);
  7. the DG-1 plate through preconditioner="auto" (the DG p-multigrid,
     column-smoothed, with its CG-1 geometric-MG correction) and the DG
     block stencil: (a) 8x8x4, 3 steps, the GPU against the CPU; (b) the
     64x64x16 plate in f64 and then with cg_dtype="float32" (mixed
     precision), each 1 warm-up step and 1 timed step, with the mixed
     run's T held to the f64 run's within 5e-3 K, the launch counts held
     to what the code implies (K1 once a step, K2 25 times a V-cycle, no
     K3), and K2 held to its plain version on every CG-1 level's real
     value tables in the run's dtype; then the layers of one CG iteration
     timed, and the memory each part of a step adds;
  8. equilibrium mechanics (mechanics="equilibrium": an elasticity solve
     with the vector V-cycle of solver/grid_mg.py in every step): (a) the
     JAX package's quenching-plate test, 4x4x16 CG-1, f64, 50 steps, the
     GPU against the CPU (fields, equal Newton / heat-CG / elasticity-CG
     counts, the membrane balance of the centre column), then an 8x8x4
     DG-1 plate through "auto" with mechanics, 3 steps, GPU against CPU;
     (b) the JAX package's first coupled row of 500k dofs or more, the
     128x128x32 plate (549,153 T dofs, 1,647,459 displacement dofs), f32,
     1 warm-up step and 2 timed steps: ms per step, the three iteration
     counts, exact K1/K2 launches, layer times, setup by part, peak
     memory, the residual-stress profile;
  9. the CG-2 lattice path (GridHeatOperator2 + Q2MG, ops/grid2.py, over
     the CG-1 GeometricMG, solver/multigrid.py): (a) the 5x5x3 and the
     32x32x4 CG-2 plates through "auto", f64, rtol 1e-12, 3 steps, the
     GPU against the CPU (the second with one smoothed coarse level, so K2
     runs inside the compared solve), then the lattice operator on the
     card against the gather operator at 1e-12 (K3 at nloc 27 held to its
     plain version there); (b) the JAX
     package's largest CG-2 row, the 64x64x16 plate (549,153 T dofs), f32,
     1 warm-up step and 3 timed steps: ms per step, Newton and CG per
     step, the layers (Q2MG apply and build, line factorisation and
     solve, coarse V-cycle apply), setup by part, peak memory, exact
     K1/K2/K3 launches, K2 on every smoothed coarse level, and K3 at
     nloc 27 at the plate's 65,536 cells against its bound;
 10. the rest of degree 2: (a) every degree-2 configuration the port runs
     (the DG-2 slab, the 2D CG-2 plate with CG-2 sigma, the CG-2 tet
     plate, the DG-2 box matrix-free and with the block stencil, the CG-2
     plate with grid_native="off" and SA-AMG, CG-2 mechanics, the 5x5x3
     CG-2 plate in mixed precision), f64, rtol 1e-12, 2 steps, the GPU
     against the CPU, with K3 launched exactly where the gather residual
     runs; (b) the 48x48x12 CG-2 plate (235,225 T dofs) on the gather
     path (grid_native="off", matrix-free, SA-AMG, f32, rtol 1e-5,
     jac_every 5), 1 warm-up step and 2 timed steps: ms per step, counts,
     setup by part, peak memory, K3 launches per step and K3 on the
     operator's tables against its bound; (c) the 64x64x16 CG-2 plate of
     phase 9b in f64 with the f32 twins of the lattice operator and of
     Q2MG (cg_dtype="float32", rtol 1e-12, "auto"), 1 + 1 steps, K1/K2
     launches exact, T after one step within 5e-3 K of an f64 run's;
 11. the command-line entry point (`fem_glass_tempering_tpu_torch.main`,
     called in this process, its output in a directory deleted after):
     (a) the full-size plate of phase 4 from a JSON config file, 5 steps,
     one npz + VTU snapshot: the printed counts equal to phase 4's warm-up
     chunk, the VTU's Temperature and the npz's T equal to its T bit for
     bit, K1 5 and K2 31 per CG or Newton iteration, file sizes, io
     seconds, the temper metrics of the written sigma; (b) the
     reference's default run, 6 steps, on the card with --profile-dir
     and on the CPU: equal counts, T and Tf within max-rel 1e-9, sigma
     1e-6 of max, temper profiles 1e-9, and the trace's K1 and K3 kernel
     events equal to their launch counts; (c) that run from a gmsh file
     (create_mesh, --mesh) with (b)'s counts, and the 64x64x16 plate
     through --write-mesh read back equal to the built mesh, with the
     write and read seconds. XDMF is not run (the card's machine has no
     h5py);
 12. bf16 V-cycle tables, the custom-PDE API, solve_scan and the native
     runtime: (a) the 1,062,761-dof CG-1 plate in mixed precision (f64
     Newton at rtol 1e-12 over the f32 CG and the f32 GeometricMG twin,
     Chebyshev) with mg_table_dtype="bfloat16", 1 warm-up step and 1
     timed step, then the same problem with the hierarchy's table dtype
     set to None ("same": f32 tables), 1 + 1 steps, then same and bf16
     once more (ms per step compared in turns): ms per step, counts,
     setup, peak memory, K2 launches per table dtype exact, T of the two
     arms within max-rel 1e-10, CG at most 2x; before that K2's bf16-table
     instantiation (f32 and f64 vector) bit-equal to its plain twin on
     every smoothed level's real tables and timed on the fine level's
     against its byte bound; (b) the 8x8x4 plate with those settings and
     a two-level V-cycle, 2 steps, GPU against CPU (Newton equal, CG
     within 1%, T 1e-9); (c) the tempering heat step as a
     ScalarResidualForm on a 256x256 CG-1 square, the reaction-diffusion
     MMS through the form layer, newton_direct on the validation slab
     and on a uniform slab (K3's batching rule: one launch per Jacobian
     column over per-cell tables, one for all columns over uniform
     ones), each GPU against CPU; (d) solve_scan on the default slab, 6
     steps in chunks of 3, equal bit for bit to solve()'s snapshots, counts and
     K1 / K3 launches equal; (e) the 1,024,000-hex plate: native facets
     equal to the numpy builder's, and its --write-mesh file read back
     through the native parser equal to the built mesh, with the seconds;
 13. distribution (parallel/): (a) two gloo ranks on this card, spawned
     (NCCL refuses two ranks on one device): shard_problem on the DG-1
     8x8x4 box ("auto", matrix-free: K3 on each rank's cells) and
     CGDDProblem on the 4x4 CG-2 square, 1 step each, and CGDDProblem
     on the JAX package's dry-run plate (8x4x2, f64), 1 step, held to the
     unsharded run on the card (T rtol 1e-12 / atol 1e-10; CGDD 1e-10 /
     1e-9), Newton equal on both ranks and to the unsharded run (CGDD:
     to one NCCL rank's), CG within 1%, the ranks in lockstep, K1 / K2 /
     K3 launches per rank exact; (b) the 64x64x16 DG-1 plate ("auto",
     matrix-free, f64), 1 + 1 steps unsharded, then the same problem
     sharded in place over one NCCL rank (bit-equal), then over the two
     gloo ranks (max-rel 1e-12, Newton equal); and the 160x160x40 CGDD
     plate (1,062,761 dofs, f32)
     in one capped step (one Newton iteration of CGDD_FULL_CG Jacobi-CG
     iterations: a converged step takes ~8,800) over one NCCL rank and
     over the two gloo ranks (finite, the ranks in lockstep); ms per step
     and per CG iteration, counts, setup seconds, peak memory per rank
     and K1 / K2 / K3 launches; (c) DDProblem (the DG domain
     decomposition, K3 on each rank's cells, K1 in its material step):
     the reference's graded slab, 3 steps on the two gloo ranks, held to
     the unsharded run on the card at JAX's tolerances (T 1e-10 / 1e-9,
     sigma 1e-8 / 1e-12, the gathered state 1e-9 / 1e-11), Newton equal
     to JAX's 4 / 3 / 3 and CG within 2% of its 217 / 164 / 166, the
     ranks in lockstep; then phase 7's 64x64x16 plate (524,288 dofs, f64)
     in one capped step (1 Newton x CGDD_FULL_CG CG) over one NCCL rank
     and over the two gloo ranks (T max-rel 1e-7, the ranks bit-equal):
     ms per CG iteration, setup seconds, peak memory and K1 / K3 launches
     per rank; (d) GridShardedProblem (the grid-sharded CG-1 step, K2's
     halo form on each rank's planes, K1 in its material step): JAX's
     12x6x4 MG plate (f64, CG rtol 1e-12, 3 steps) on the two gloo ranks
     against the unsharded run on the card (T, Tf rtol 1e-10, sigma 1e-6
     of its max, Newton equal, CG within max(5, 2%)) and the dry run's
     f32 "gspmd-grid" config at JAX's Newton / CG; then phase 4's plate
     (1 + 2 steps) over one NCCL rank and over the two gloo ranks (Newton
     equal, CG within 2%, T max-rel 1e-6, the ranks bit-equal): ms a step,
     counts, setup seconds, peak memory, K1 and K2 launches per rank by
     form (exact: no full-grid K2 on the sharded levels), halo exchanges
     an iteration; K2's halo form bit-equal to its twin and to the
     full-grid kernel's rows on the two-rank slabs of the plate's fine
     level, timed on the first (81 x 6,601 points); after the plate's
     timed window, on each rank, its output (grid_shard_io): solve() of
     2 steps with a snapshot a step and a checkpoint at step 2, the
     series' last snapshot equal to gather_state and save ->
     load_checkpoint -> run(1) equal to run(1) from the state, bit for
     bit, K1 and K2's launches held, s and MB a rank. With equilibrium
     mechanics (the elasticity CG on each rank's slab of the vector
     operator, GridElastMG's rank form; every elasticity CG must meet
     its tolerance): (a) also the dry run's "gspmd-mechanics" config in
     f32 (JAX's) over the one NCCL rank at JAX's Newton / CG, T held to
     the unsharded run on the card, and (side phase 13d64) its f64 twin
     over two gloo ranks held to one NCCL rank and that to the unsharded
     run (T, sigma and the elasticity CG count: GS_DRYRUN64_BANDS; in f32
     that plate's stiffness is below f32's resolution,
     GS_DRYRUN_MECH_JAX_SIGMA); (c) phase 8b's coupled plate (1 + 2
     steps, flux through the z faces) over one NCCL rank, held to 8b's
     unsharded state (Newton equal, heat CG within max(2, 10%),
     elasticity CG within 2%, T max-rel 1e-5, sigma within 1e-4 of its
     max on the centre column and 5e-3 in the relative 2-norm:
     GS_MECH_BANDS), and over the two gloo ranks, held to the one rank
     (heat counts equal, elasticity CG within 2%, T max-rel 1e-6, sigma
     1e-4 on the centre column and 1e-3 in the 2-norm): ms a step,
     counts, collectives an elasticity-CG iteration, setup seconds by
     part, peak memory per rank, K2's halo launches exact and K1 none
     (the trapezoid xi); (e, a side phase) the multi-process entry:
     `python -m torch.distributed.run --standalone --nproc-per-node 2
     chip_smoke.py --multihost-rank OUT`, two gloo ranks on cuda:0
     through multihost.initialize, JAX's tests/test_multihost.py plate
     (12x6x3, f64, 2 steps) within 1e-11 of the unsharded run on the
     card, K1 and K2's launches held on rank 0; (f, a side phase of its
     own) GridShardedProblem with DG-1 T (the cell-grid layout, the DG
     operator's slab on each rank's cell layers, DGMultigrid's grid route
     with its CG-1 correction on RankGridMG, K2's halo form on its
     sharded levels, K1 in the material step) over one NCCL rank and two
     gloo ranks, while the side process runs the same plates unsharded:
     (a) JAX's tests/test_grid_dg.py plates (8x4x4, 3 steps; 9x4x3, one
     ghost cell layer at P = 2, 2 steps; 8x4x3 with mechanics and the
     trapezoid xi, 2 steps) and the dry run's "gspmd-dg" config (16x4x4,
     2 steps) in f64 and mixed precision, each held to the unsharded run
     (T 1e-9 and sigma 1e-8 of their max, 1e-5 with mechanics; CG at most
     2x + 8) and the two ranks to the one (Newton equal, one apart in
     mixed precision; T max-rel 1e-12); (b) phase 7b's 64x64x16 plate
     (524,288 T dofs, f64), 1 + 1 steps on the one rank and on the two,
     and mixed (1 + 1) on the one, held to 7b's f64 run (T 1e-9 of its
     max, the mixed run 5e-3 K; Newton within one a step, CG at most 2x
     + 8) and the two ranks to the one: ms a step and a CG iteration,
     counts, collectives a CG iteration by kind (cell halos, node halos,
     re-partitions, other sums), setup s by part, peak memory, K1 and K2
     launches per rank (no full-grid K2, no K3); K2's halo form bit-equal
     to its twin on each rank's slab of the CG-1 correction's fine
     level at the run's tables; the output as 13d(b)'s, with cell-grid
     pieces; (g, a side phase in 13f's processes, after 13f)
     GridShardedProblem with CG-2 T (the lattice layout, GridQ2Slab's
     kron chain on each rank's lattice planes and a two-plane window,
     Q2MG's grid route in its rank form with its CG-1 chain on RankGridMG,
     K2's halo form on its sharded levels, K1 in the material step) over
     one NCCL rank and two gloo ranks, while the side process runs the
     same plates unsharded: (a) JAX's tests/test_grid2.py:237 plate
     (6x4x3 of 1 x 0.7 x 0.01, 2 steps, line-smoothed Q2MG) in f64 and
     mixed precision and the dry run's "gspmd-q2" config, each held to
     the unsharded run (T 1e-9 and sigma 1e-8 of their max) and the two
     ranks to the one (Newton equal, one apart in mixed precision; T
     max-rel 1e-12); (b) phase 9b's 64x64x16 plate (549,153 T dofs, f32),
     1 + 1 steps on the one rank and on the two, each writing T and its
     counts after step 1 (PHASE13G_REF) for phase 9b, which holds them to
     its warm-up step (T max-rel 1e-5, Newton equal, CG within 2%), and
     the two ranks to the one (T max-rel 1e-6, Newton equal): ms a step
     and a CG iteration, collectives a CG iteration by kind (lattice
     halos, node halos, re-partitions, other sums), setup s by part, peak
     memory, K1 and K2 launches per rank (no full-grid K2, no K3); K2's
     halo form bit-equal to its twin on each rank's slab of the coarse
     chain's fine level (f32); the output as 13d(b)'s, with lattice
     pieces.
Phase 2 also holds K3 at every degree-2 cell shape (nloc 3, 6, 9, 10, 27)
on the port's HeatOperator tables, f64 and f32, all in the element form,
and times nloc 27 (uniform f32 and f64, 65,536 cells) and nloc 10
(per-cell f64, 67,584 tetrahedra) against both bounds (the least work
given the prepared tables, and the quadrature form's) and against one
PyTorch call on the baked matrices (torch.addmm / torch.baddbmm), with
the bake's seconds and bytes.
Every main path (4, 5, 6, 7b f64, 7b mixed, 8b, 9b, 10b, 10c, 11a, 11b,
12a's two arms, 12b, 12d's two runs, each run of 13, 13d (13d(b)'s
output included), 13d64, 13f and 13g (their (b)'s output included) on
every rank, 13e's on rank 0) runs
with the launch counters set to 0 just before it and read just after; K2
also counts its launches per table dtype (an instantiation each), and its
halo form its own (`stencil_matvec_halo.launches`). A line
"phase N ends at S s" follows each phase, 13 and 13d included
(seconds since the kernel build began). Then one
JSON line per kernel, one {"kernels": [...]} line, the card's name and power limit,
and last {"ok": true, "device": {...}}.

Phases whose times feed no kernel's `ms` (dispatch-bound runs on tiny
meshes, the GPU-against-CPU runs, the command line, the native runtime,
phases 13, 13d64, 13e, 13f and 13g) run in SIDE_GROUPS: four processes
of their own on the same card, started after phase 4, beside this process's plates of phases 6,
7b, 8b, 10b and 10c, and joined before phase 9b. Their lines carry a
"[side ...]" prefix, their launch counters are their own, and their
checks fail the script as any other's do; the main process stops them
if it fails first. The phases that time a kernel for the kernels line
(2, 4, 9b, 12a, 13d) run with no side process beside them. Phase 13
runs its two gloo ranks beside its in-process runs, as 13d does.

A kernel's `ms` and `plain_ms` are CUDA-event means over back-to-back
calls of the wrapper (the host's cost of issuing a call shows where it
exceeds the device's); `device_ms` is the same call captured `reps` times
into a CUDA graph and replayed, which leaves the device time alone;
`device_cold_ms` is one launch between event pairs after a write over a
buffer larger than the L2, as the main path finds the kernel's inputs.
`bound_ms` counts operations against the data sheet's rates, which assume
fused multiply-adds (K3's counts the least work of its function given
its prepared tables, the element form's, whatever kernel runs;
`bound_quadrature_form_ms` counts the quadrature form's); `bound_unfused_ms` counts them at half those rates,
the floor of a source built with -fmad=false (K1 and K2 are; K3 is built
with contraction, ops/kernel_lib.py SOURCE_FLAGS, so `bound_ms` is its).
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import multiprocessing as mp
import os
import queue
import re
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

N_FULL = (160, 160, 40)          # 1,024,000 hex cells, 1,062,761 dofs
WARMUP_STEPS = 5
TIMED_STEPS = 20
N_DG = (64, 64, 16)              # 65,536 hex cells, 524,288 DG-1 dofs
# the DG-1 plate on SA-AMG (phase 6): at 64x64x16 its host setup (ELL,
# SA-AMG) took 60-151 s, and the script 1,179.1 s of its 1,200 on a slow
# host; 27,648 hex cells, 221,184 DG-1 dofs
N_DG_AMG = (48, 48, 12)
DG_TIMED_STEPS = 1
DG_PARITY_STEPS = 3
N_MECH = (128, 128, 32)          # 524,288 hex cells, 549,153 T dofs
MECH_TIMED_STEPS = 2
# the quenching plate: 50 steps with the reference xi, as the JAX
# package's test (its quench signature, the membrane balance, holds from
# there: at 20 steps the centre column is 7.7% asymmetric); 10 with the
# trapezoid xi, the strict parity run
MECH_PLATE_STEPS = dict(reference=50, trapezoid=10)
N_CG2 = (64, 64, 16)             # 65,536 hex cells, 549,153 CG-2 T dofs
CG2_TIMED_STEPS = 3
# the CG-2 plate on the gather path: the 48x48x12 row of the JAX
# package's CG-2 table (BENCH.md:355), 27,648 hex cells, 235,225 T dofs;
# at 64x64x16 its ELL and SA-AMG setup on the host took 98-135 s and the
# script 1,131 s of its 1,200 (an NVIDIA H100 80GB HBM3 at 700 W)
N_GATHER = (48, 48, 12)
GATHER_TIMED_STEPS = 2
MIXED_TIMED_STEPS = 1
DEGREE2_PARITY_STEPS = 2
KERNELS = ("material_tspace", "stencil_matvec", "dg_cell_residual")
# the golden values of the default run (CPU reference, confirmed by the
# independent numpy/scipy oracle of the JAX package's test-suite)
GOLDEN = dict(T_surf=(644.5809518419135, 1e-8),
              T_core=(797.5500316300408, 1e-8),
              Tf_surf=(799.8808751898703, 1e-8),
              sigma_l2=(1.3725924857443605e-4, 1e-6))
GOLDEN_NEWTON = 1501
# phase 5's assembled-operator and checkpoint runs
SIDE_STEPS = 10
GOLDEN_CG = 5962
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
# Data-sheet rates outside the tensor cores. They count a fused
# multiply-add as two operations: a kernel built with -fmad=false executes
# one instruction per operation and can reach half of them at most
# (bound_ms(..., fused=False)).
PEAK_OPS = {torch.float32: 67e12,
            torch.float64: 34e12}
L2_FLUSH_BYTES = 512 << 20       # ten times the 50 MB L2
# plain arithmetic per element, exp counted as one operation
K1_OPS_PER_DOF = 51
K2_OPS_PER_POINT = 54            # 27 multiplies + 27 adds


def k3_ops_per_cell(nloc: int, q: int, g: int) -> int:
    """Multiplies and adds of one cell of dg_cell_residual in the
    quadrature form (the TPU kernel's and the plain version's)."""
    return q * (4 * nloc + 4 * nloc * g + g + 5 + 2 * nloc) + 2 * nloc


def k3_values_per_cell(nloc: int, q: int, g: int, uniform: bool,
                       with_src: bool) -> int:
    """Values a cell moves in the quadrature form: Tc, Tpc in, r out, and
    its tables (the uniform tables and phi are O(1) for the whole call)."""
    n = 3 * nloc + (q if with_src else 0)
    return n if uniform else n + q + q * nloc * g


def k3_element_ops_per_cell(nloc: int) -> int:
    """Multiplies and adds of one cell in the element form: the products
    M (Tc - Tpc) and K Tc, nloc^2 multiply-adds each (the least work of
    the function given its prepared tables, whatever computes it)."""
    return 4 * nloc * nloc


def k3_element_values_per_cell(nloc: int, uniform: bool, with_f: bool,
                               with_src: bool) -> int:
    """Values a cell must move given its prepared tables: Tc, Tpc in, r
    out; per-cell tables add the symmetric M and K (nloc (nloc + 1)
    values together) and, with an f term, b; a source adds its element
    vector (uniform matrices are O(1) for the whole call)."""
    n = 3 * nloc + (nloc if with_src else 0)
    if not uniform:
        n += nloc * (nloc + 1) + (nloc if with_f else 0)
    return n


def k3_bounds(c: int, nloc: int, q: int, g: int, uniform: bool, dtype,
              with_f: bool = False, with_src: bool = False) -> dict:
    """K3's bound for `c` cells, restated as the least work of the
    function given its prepared tables (the element form's bytes and
    products), beside the bound that counts the quadrature form."""
    size = torch.finfo(dtype).bits // 8
    b, by = bound_ms(size * c * k3_element_values_per_cell(
        nloc, uniform, with_f, with_src), c * k3_element_ops_per_cell(nloc),
        dtype)
    bq, byq = bound_ms(size * c * k3_values_per_cell(nloc, q, g, uniform,
                                                     with_src),
                       c * k3_ops_per_cell(nloc, q, g), dtype)
    return dict(bound_ms=b, bound_by=by, bound_quadrature_form_ms=bq,
                bound_quadrature_form_by=byq)


def k3_yardstick(e, uniform, Tc, Tpc, kw) -> tuple[float, float,
                                                   torch.Tensor]:
    """One PyTorch call computing the cell term from the element form's
    baked tables `e` (ops/cuda_dg_cell.py bake_element_tables, a prepared
    call's or baked here for the yardstick alone): torch.addmm over a
    pre-stacked (cells, 2 nloc) input [Tc - Tpc, Tc] for uniform tables,
    torch.baddbmm over the per-cell matrices (unpacked from their
    triangles) for per-cell ones; the f term rides as the bias -> (ms,
    device ms, its r). A yardstick the port never calls."""
    nloc = Tc.shape[1]
    X = torch.cat([Tc - Tpc, Tc], dim=1)
    dtc = kw["dt"] * kw["c_diff"]
    c_mass = kw.get("c_mass", 1.0)
    bias = -kw["dt"] * kw["f_src"] * e["b"]
    if uniform:
        W = torch.cat([c_mass * e["M"].T, dtc * e["K"].T]).contiguous()
        fn = lambda: torch.addmm(bias, X, W)  # noqa: E731
    else:
        iu = torch.triu_indices(nloc, nloc, device=Tc.device)
        full = []
        for key, scale in (("M", c_mass), ("K", dtc)):
            A = torch.zeros((Tc.shape[0], nloc, nloc), dtype=Tc.dtype,
                            device=Tc.device)
            A[:, iu[0], iu[1]] = scale * e[key].T
            A[:, iu[1], iu[0]] = scale * e[key].T
            full.append(A)
        W = torch.cat(full, dim=1).contiguous()       # (cells, 2 nloc, nloc)
        X = X[:, None, :].contiguous()
        bias = bias.T[:, None, :].contiguous()
        fn = lambda: torch.baddbmm(bias, X, W)  # noqa: E731
    r = fn().reshape(Tc.shape)
    return time_ms(fn), device_ms(fn), r


def reset_counts(port) -> None:
    for name in KERNELS:
        port[name].launches = 0
    if "stencil_matvec_halo" in port:
        port["stencil_matvec_halo"].launches = 0
    by_table = port["stencil_matvec"].launches_by_table
    for k in by_table:
        by_table[k] = 0


def read_counts(port) -> dict:
    return {name: port[name].launches for name in KERNELS}


def read_k2_by_table(port) -> dict:
    """K2's launches per instantiation (its table dtype)."""
    return dict(port["stencil_matvec"].launches_by_table)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (-0.0 is not 0.0; a NaN equals its own
    bits)."""
    ints = {torch.float64: torch.int64, torch.float32: torch.int32}
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype in ints:
        a, b = a.view(ints[a.dtype]), b.view(ints[b.dtype])
    return bool(torch.equal(a, b))


LOG_PREFIX = ""                  # "[side ...] " in a side process


def log(msg: str) -> None:
    print(LOG_PREFIX + msg, flush=True)


def drop_garbage(before: str) -> None:
    """Collect what earlier phases left in reference cycles (a problem
    object holds gigabytes of device tables until the collector runs), so
    that a phase's peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory allocated before {before}: "
        f"{torch.cuda.memory_allocated()} bytes")


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


def device_cold_ms(fn, reps: int = 10) -> float:
    """Median device time of one fn() whose inputs the L2 does not hold:
    before each call a buffer of L2_FLUSH_BYTES is overwritten. The write
    keeps the device busy while the host enqueues the call, so the events
    bracket the kernel, not the wrapper."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def host_us(fn, reps: int = 2000) -> float:
    """Mean host time of fn() in microseconds (the device queue drained
    before and after; fn must not outrun the device by the queue's depth)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def bound_ms(n_bytes: float, n_ops: float, dtype,
             fused: bool = True) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate, whichever is larger. `fused=False`
    takes half the peak rate (no multiply-add contraction)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / (PEAK_OPS[dtype] * (1.0 if fused else 0.5)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------------
def check_material_tspace(dev, port) -> dict:
    """K1 against its plain version at the main path's n, f32 and f64;
    then where its tiles end raggedly (n below one tile, n = 7) and on a
    Tf_partial that is a view one element into a larger tensor, which
    takes the kernel's element-wise tile copy."""
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

    def agree(T, Tp, Tfp, rtol, tag) -> float:
        got = k(T, Tp, Tfp, **kw)
        want = ref(T, Tp, Tfp, **kw)
        torch.cuda.synchronize()
        err = 0.0
        for name, g, w in zip(("phi", "Tf_partial", "Tf", "xi"), got, want):
            # xi is a difference of two exps: scale its floor by the exps
            scale = (got[0].abs().max() if name == "xi" else w.abs().max())
            bad = (g - w).abs() > rtol * w.abs() + rtol * scale
            if (g.shape != w.shape or bool(bad.any())
                    or not bool(torch.isfinite(g).all())):
                fail(f"material_tspace {tag} {name}: max |diff| "
                     f"{float((g - w).abs().max()):.3e}")
            err = max(err, float((g - w).abs().max()))
        return err

    out = {}
    for dtype, rtol in ((torch.float32, 2e-6), (torch.float64, 1e-12)):
        name = str(dtype).split(".")[-1]
        T = torch.tensor(600.0 + 250.0 * rng.random(n), dtype=dtype,
                         device=dev)
        Tp = T + torch.tensor(rng.normal(0.0, 2.0, n), dtype=dtype,
                              device=dev)
        big = torch.tensor(600.0 + 250.0 * rng.random(6 * n + 1),
                           dtype=dtype, device=dev)
        view = big[1:].view(n, 6)    # contiguous, one element off 16 bytes
        Tfp = view.clone()
        err = agree(T, Tp, Tfp, rtol, f"{name} n={n}")
        ragged = {m: agree(T[:m].clone(), Tp[:m].clone(), Tfp[:m].clone(),
                           rtol, f"{name} n={m}") for m in (1000, 7)}
        if view.data_ptr() % 16 == 0 or not view.is_contiguous():
            fail("the unaligned K1 case is aligned")
        err_view = agree(T, Tp, view, rtol, f"{name} unaligned view")
        size = torch.finfo(dtype).bits // 8
        b, by = bound_ms(17 * n * size, K1_OPS_PER_DOF * n, dtype)
        entry = dict(dtype=name, n=n, max_abs_err=err, rtol=rtol,
                     max_abs_err_ragged=ragged,
                     max_abs_err_unaligned_view=err_view,
                     ms=time_ms(lambda: k(T, Tp, Tfp, **kw)),
                     device_ms=device_ms(lambda: k(T, Tp, Tfp, **kw)),
                     device_unaligned_view_ms=device_ms(
                         lambda: k(T, Tp, view, **kw)),
                     plain_ms=time_ms(lambda: ref(T, Tp, Tfp, **kw)),
                     bound_ms=b, bound_by=by)
        log("K1 check " + json.dumps(entry))
        out[name] = entry
        del big, view, Tfp
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
                       with_src, seed=0, prepared=False) -> float:
    """K3 against its plain version on one set of tables: forward, the
    tangent through torch.func.jvp, and J dT = r(T + dT) - r(T). The bound
    per entry is rtol times the sum of the absolute values of every term
    (the mass and diffusion parts cancel on smooth data). `prepared`: the
    call the heat operator makes (tables checked once; uniform tables that
    fit travel by value), else the direct call (tables in device memory)."""
    ref = port["dg_cell_residual_reference"]
    dev, dtype = qw.device, qw.dtype
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    Tc = t(700.0 + 100.0 * rng.random(shape))
    Tpc = Tc + t(rng.normal(0.0, 3.0, shape))
    dTc = t(rng.standard_normal(shape))
    src = t(rng.standard_normal((shape[0], phi.shape[0]))) if with_src \
        else None
    kw = dict(dt=0.1, c_diff=0.83, f_src=0.37, c_mass=c_mass)
    if prepared:
        call = port["PreparedDGCellResidual"](qw, gphi, phi, src)
        k = lambda u, v: call(u, v, **kw)
    else:
        k = lambda u, v: port["dg_cell_residual"](
            u, v, qw, gphi, phi, source_q=src, **kw)
    got = k(Tc, Tpc)
    want = ref(Tc, Tpc, qw, gphi, phi, source_q=src, **kw)
    mag = ref(Tc.abs(), -Tpc.abs(), qw, gphi.abs(), phi.abs(),
              source_q=None if src is None else -src.abs(),
              **dict(kw, f_src=-abs(kw["f_src"])))
    fn = lambda u: k(u, Tpc)
    y, dy = torch.func.jvp(fn, (Tc,), (dTc,))
    zero = torch.zeros_like(Tc)
    dwant = ref(dTc, zero, qw, gphi, phi, **dict(kw, f_src=0.0))
    dmag = ref(dTc.abs(), zero, qw, gphi.abs(), phi.abs(),
               **dict(kw, f_src=0.0))
    y2 = fn(Tc + dTc)
    torch.cuda.synchronize()
    tag = (f"dg_cell_residual {tuple(shape)} q={phi.shape[0]} {dtype} "
           f"{'uniform' if qw.dim() == 1 else 'per-cell'} tables, "
           f"{'prepared' if prepared else 'direct'} call, c_mass {c_mass}, "
           f"source {with_src}")
    for name, g, w, m in (("forward", got, want, mag), ("jvp primal", y,
                          want, mag), ("jvp tangent", dy, dwant, dmag)):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()) or bool(
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


K3_CASES = ((1.0, False), (3.5825e6, True), (1.0, True))   # c_mass, source


def check_dg_cell_shapes(dev, port, dtype, rtol) -> dict:
    """K3 where its kernels treat the cells differently: cell counts that
    fill no whole block or warp, more quadrature points than local dofs
    (triangles: nloc 3, q 9, a block-wide barrier; a shape without an
    unrolled instantiation), and uniform hex tables on either side of the
    size up to which they travel by value."""
    from fem_glass_tempering_tpu_torch.fem.mesh import (
        box_mesh_2d,
        box_mesh_3d,
    )
    from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
        PARAM_TABLE_BYTES,
        table_path,
    )
    rng = np.random.default_rng(5)
    t = lambda a: torch.tensor(a, dtype=dtype, device=dev)
    size = torch.finfo(dtype).bits // 8
    errs = {}

    def run(label, shape, qw, gphi, phi, prepared, want_path=None):
        if want_path is not None:
            got_path = port["PreparedDGCellResidual"](qw, gphi, phi).path
            if got_path != want_path:
                fail(f"K3 {label}: path {got_path}, expected {want_path}")
        errs[label] = max(
            check_dg_cell_case(shape, qw, gphi, phi, rtol, port, c_mass=cm,
                               with_src=ws, seed=i, prepared=prepared)
            for i, (cm, ws) in enumerate(K3_CASES))

    # hex DG-1 tables of a uniform box: by value and through shared memory
    _, qw, gphi, phi = dg_tables(box_mesh_3d(4, 4, 2, 1.0, 1.0, 0.01),
                                 dtype, dev, True)
    for cells in (65537, 5):
        run(f"hex uniform by value, {cells} cells", (cells, 8), qw, gphi,
            phi, True, "param")
        run(f"hex uniform shared, {cells} cells", (cells, 8), qw, gphi, phi,
            False)
        lead = (cells,)
        run(f"hex per-cell, {cells} cells", (cells, 8),
            qw.expand(lead + qw.shape).contiguous()
            * t(0.5 + rng.random(lead + qw.shape)),
            gphi.expand(lead + gphi.shape).contiguous()
            * t(0.5 + rng.random(lead + gphi.shape)), phi, True, "shared")
    # the boundary of the parameter path: the largest q that fits, and one
    # more (the runtime-q row kernel; then the split kernel)
    rec = (8 * 4 + 1) * size
    q_fit = PARAM_TABLE_BYTES // rec
    for q, path in ((q_fit, "param"), (q_fit + 1, "shared")):
        if table_path(8, q, 3, size, True) != path:
            fail(f"table_path(8, {q}, 3, {size}) is not {path}")
        run(f"hex uniform q={q} ({path})", (1001, 8), t(0.1 + rng.random(q)),
            t(rng.standard_normal((q, 8, 3))), t(rng.random((q, 8))), True,
            path)
    # triangles: q = 9 > nloc = 3
    shape, qw, gphi, phi = dg_tables(
        box_mesh_2d(9, 7, cell_type="triangle"), dtype, dev, False)
    run(f"triangles {shape} q={phi.shape[0]}", shape, qw, gphi, phi, True,
        "shared")
    # no unrolled instantiation: nloc 12, q 11, g 3 (the runtime-shape
    # split kernel); a degree-2 shape on random tables: nloc 10, q 11, g 3
    # (the element form)
    for nloc, path in ((12, "shared"), (10, "element")):
        for uniform in (True, False):
            lead = () if uniform else (50,)
            run(f"{path} (50, {nloc}) q=11 "
                f"{'uniform' if uniform else 'per-cell'}", (50, nloc),
                t(0.1 + rng.random(lead + (11,))),
                t(rng.standard_normal(lead + (11, nloc, 3))),
                t(rng.random((11, nloc))), True, path)
    return errs


def k3_host_breakdown(dev, port) -> dict:
    """Where the host's time of one K3 call goes, in microseconds, on a
    64-cell hex problem with uniform tables (the host's cost does not
    depend on the cell count, and the device keeps up)."""
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.ops import kernel_lib

    shape, qw, gphi, phi = dg_tables(box_mesh_3d(4, 4, 4, 1.0, 1.0, 0.01),
                                     torch.float64, dev, True)
    Tc = torch.full(shape, 700.0, dtype=torch.float64, device=dev)
    Tpc = Tc + 1.0
    kw = dict(dt=0.1, c_diff=1.0, f_src=0.0)
    call = port["PreparedDGCellResidual"](qw, gphi, phi)
    lib = kernel_lib.library().cdll
    out = torch.empty_like(Tc)
    stream = torch.cuda.current_stream().cuda_stream
    args = (1, Tc.data_ptr(), Tpc.data_ptr(), call._packed_ptr, None,
            out.data_ptr(), shape[0], 8, 8, 3, 0.1, 1.0, 1.0, 0.0, stream)

    class Empty(torch.autograd.Function):
        """The call's arguments through autograd.Function.apply with no
        work in forward: what the route that the call no longer takes
        costs before it launches anything."""

        @staticmethod
        def forward(Tc, Tpc, call, dt, c_mass, c_diff, f_src, with_src):
            return out

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.set_materialize_grads(False)

    res = dict(
        apply_empty_forward=host_us(
            lambda: Empty.apply(Tc, Tpc, call, 0.1, 1.0, 1.0, 0.0, True)),
        empty_like=host_us(lambda: torch.empty_like(Tc)),
        current_stream=host_us(
            lambda: kernel_lib.current_stream(dev.index)),
        ctypes_launch=host_us(
            lambda: lib.fgt_dg_cell_residual_param(*args)),
        # the launch as forward mode reaches it: through the dispatcher
        dispatcher_op=host_us(lambda: torch.ops.fgt_torch.dg_cell_launch(
            Tc, Tpc, None, None, None, None, call._id, 0.1, 1.0, 1.0, 0.0,
            True)),
        prepared_run=host_us(
            lambda: call.run(Tc, Tpc, 0.1, 1.0, 1.0, 0.0, True)),
        prepared_call=host_us(lambda: call(Tc, Tpc, **kw)),
        direct_call=host_us(
            lambda: port["dg_cell_residual"](Tc, Tpc, qw, gphi, phi, **kw)),
        # under torch.func.jvp, as the matrix-free matvec calls it: two
        # launches through the dispatcher op; beside it the transform's
        # own cost around one elementwise operation
        jvp_prepared_call=host_us(lambda: torch.func.jvp(
            lambda u: call(u, Tpc, **kw), (Tc,), (Tpc,)), reps=500),
        jvp_of_one_add=host_us(lambda: torch.func.jvp(
            lambda u: u + Tpc, (Tc,), (Tpc,)), reps=500),
    )
    # what run() spends on checking Tc and Tpc and on Python itself
    res["checks_and_python"] = res["prepared_run"] - res["empty_like"] \
        - res["current_stream"] - res["ctypes_launch"]
    log("K3 host time per call, us " + json.dumps(res))
    return res


def check_dg_cell(dev, port) -> dict:
    """K3 at the 1D reference slab's tables (48 cells, nloc 2) and at the
    hex DG-1 plate's (65,536 cells, nloc 8) with per-cell and with uniform
    tables, in the call the heat operator makes and in the direct call;
    the shapes of check_dg_cell_shapes; timed at the plate's shape in f64,
    the main path's type."""
    from fem_glass_tempering_tpu_torch.fem.mesh import (
        box_mesh_3d,
        reference_glass_mesh_1d,
    )
    from fem_glass_tempering_tpu_torch.ops import kernel_lib
    from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
        bake_element_tables,
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
            for prepared in (True, False):
                errs[f"{label}, {'prepared' if prepared else 'direct'}"] = \
                    max(check_dg_cell_case(
                        shape, qw, gphi, phi, rtol, port, c_mass=cm,
                        with_src=ws, seed=i, prepared=prepared)
                        for i, (cm, ws) in enumerate(K3_CASES))
            if dtype == torch.float64 and mesh is plate:
                c, nloc = shape
                q, g = phi.shape[0], gphi.shape[-1]
                rng = np.random.default_rng(11)
                Tc = torch.tensor(700.0 + 100.0 * rng.random(shape),
                                  dtype=dtype, device=dev)
                Tpc = Tc + 1.0
                kw = dict(dt=0.1, c_diff=1.0, f_src=0.0)
                call = port["PreparedDGCellResidual"](qw, gphi, phi)
                if call.path != ("param" if uniform else "shared"):
                    fail(f"K3 {label}: prepared call takes {call.path}")
                # the work is split across threads, never a sum: both
                # kernels give the same bits
                a, b_ = call(Tc, Tpc, **kw), k(Tc, Tpc, qw, gphi, phi, **kw)
                torch.cuda.synchronize()
                if not torch.equal(a, b_):
                    fail(f"K3 {label}: the prepared and the direct call "
                         f"differ by {float((a - b_).abs().max()):.3e}")
                bounds = k3_bounds(c, nloc, q, g, uniform, dtype)
                bu, byu = bound_ms(
                    8 * c * k3_element_values_per_cell(nloc, uniform, False,
                                                       False),
                    c * k3_element_ops_per_cell(nloc), dtype, fused=False)
                key = "uniform" if uniform else "per_cell"
                out[key] = dict(
                    cells=c, nloc=nloc, q=q, g=g, path=call.path,
                    max_abs_err=max(errs[f"{label}, prepared"],
                                    errs[f"{label}, direct"]),
                    ms=time_ms(lambda: call(Tc, Tpc, **kw)),
                    direct_call_ms=time_ms(
                        lambda: k(Tc, Tpc, qw, gphi, phi, **kw)),
                    device_ms=device_ms(lambda: call(Tc, Tpc, **kw)),
                    device_cold_ms=device_cold_ms(
                        lambda: call(Tc, Tpc, **kw)),
                    direct_call_device_ms=device_ms(
                        lambda: k(Tc, Tpc, qw, gphi, phi, **kw)),
                    plain_ms=time_ms(
                        lambda: ref(Tc, Tpc, qw, gphi, phi, **kw), reps=10),
                    plain_device_ms=device_ms(
                        lambda: ref(Tc, Tpc, qw, gphi, phi, **kw)),
                    **bounds, bound_unfused_ms=bu, bound_unfused_by=byu,
                    contracted="-fmad=false" not in kernel_lib.SOURCE_FLAGS[
                        "dg_cell_residual.cu"])
                # the library yardstick: the element form's tables, baked
                # here for it alone (degree 1 keeps the quadrature
                # kernels), under one addmm / baddbmm
                lib_ms, lib_dev, r = k3_yardstick(
                    bake_element_tables(qw, gphi, phi, None, dtype), uniform,
                    Tc, Tpc, kw)
                want = ref(Tc, Tpc, qw, gphi, phi, **kw)
                mag = ref(Tc.abs(), -Tpc.abs(), qw, gphi.abs(), phi.abs(),
                          **kw)
                if bool(((r - want).abs() > rtol * mag).any()):
                    fail(f"K3 {label}: the library yardstick disagrees")
                out[key].update(
                    library_ms=lib_ms, library_device_ms=lib_dev,
                    library_call="torch.addmm" if uniform
                    else "torch.baddbmm")
            del qw, gphi
        errs.update(check_dg_cell_shapes(dev, port, dtype, rtol))
        log(f"K3 check {str(dtype).split('.')[-1]} rtol {rtol} max |diff| "
            + json.dumps(errs))
    for form, entry in out.items():
        log(f"K3 {form} tables f64 " + json.dumps(entry))
    out["host_us"] = k3_host_breakdown(dev, port)
    return out


def heat_tables(mesh, family, dtype, dev, interior=False):
    """The port's own HeatOperator of a degree-2 space of `family` on
    `mesh` in `dtype` on `dev` -> (operator, cell shape): its cell term's
    tables are heat.qw, heat.gphi, heat.phi (uniform on a box)."""
    from fem_glass_tempering_tpu_torch.config import ModelParams
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator

    heat = HeatOperator(FunctionSpace(mesh, family, 2), ModelParams(), 0.1,
                        dtype=dtype, device=dev,
                        interior_device_tables=interior)
    return heat, tuple(heat.dofmap.shape)


def k3_degree2_meshes():
    """(label, mesh, family) of every degree-2 cell shape: nloc 3
    (interval), 6 (triangle), 9 (quadrilateral), 10 (tetrahedron, per-cell
    tables) and 27 (hexahedron, uniform tables)."""
    from fem_glass_tempering_tpu_torch.fem.mesh import (
        box_mesh_2d,
        box_mesh_3d,
        reference_glass_mesh_1d,
    )
    return (("nloc 3 interval (DG-2 slab)", reference_glass_mesh_1d(), "DG"),
            ("nloc 6 triangle", box_mesh_2d(9, 7, cell_type="triangle"),
             "CG"),
            ("nloc 9 quadrilateral", box_mesh_2d(40, 33, 2.0, 1.0), "CG"),
            ("nloc 10 tetrahedron", box_mesh_3d(4, 4, 3, cell_type="tet"),
             "CG"),
            ("nloc 27 hexahedron", box_mesh_3d(16, 16, 4, 1.0, 1.0, 0.01),
             "CG"))


def per_cell_hexes():
    """Phase 10b's 48x48x12 plate (1 x 1 x 0.01, 27,648 hexes) without
    its box metadata: the heat operator keeps per-cell tables, as on a
    graded or read hex mesh (nloc 27 at degree 2)."""
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d

    mesh = box_mesh_3d(*N_GATHER, 1.0, 1.0, 0.01)
    mesh.structured = None
    return mesh


def time_k3(port, call, Tc, Tpc, kw, qw, gphi, phi, uniform, rtol) -> dict:
    """K3's prepared call `call` on (Tc, Tpc) against its plain version and
    its bound: times (call, device, cold, plain) in ms."""
    ref = port["dg_cell_residual_reference"]
    got = call(Tc, Tpc, **kw)
    want = ref(Tc, Tpc, qw, gphi, phi, **kw)
    mag = ref(Tc.abs(), -Tpc.abs(), qw, gphi.abs(), phi.abs(), **kw)
    torch.cuda.synchronize()
    c, nloc = Tc.shape
    q, g = phi.shape[0], gphi.shape[-1]
    if bool(((got - want).abs() > rtol * mag).any()):
        fail(f"K3 ({c}, {nloc}) q={q} {Tc.dtype}: max |diff| "
             f"{float((got - want).abs().max()):.3e}")
    out = dict(
        cells=c, nloc=nloc, q=q, g=g, dtype=str(Tc.dtype).split(".")[-1],
        tables="uniform" if uniform else "per-cell", path=call.path,
        max_abs_err=float((got - want).abs().max()),
        ms=time_ms(lambda: call(Tc, Tpc, **kw)),
        device_ms=device_ms(lambda: call(Tc, Tpc, **kw)),
        device_cold_ms=device_cold_ms(lambda: call(Tc, Tpc, **kw)),
        plain_ms=time_ms(lambda: ref(Tc, Tpc, qw, gphi, phi, **kw), reps=5),
        **k3_bounds(c, nloc, q, g, uniform, Tc.dtype,
                    with_f=kw["f_src"] != 0.0))
    out["share"] = out["bound_ms"] / out["device_ms"]
    out["share_quadrature_form"] = (out["bound_quadrature_form_ms"]
                                    / out["device_ms"])
    if call.path == "element":
        out["bake_seconds"] = call.bake_seconds
        out["bake_bytes"] = call.bake_bytes
        lib_ms, lib_dev, r = k3_yardstick(call._elem, call.uniform, Tc,
                                          Tpc, kw)
        torch.cuda.synchronize()
        if bool(((r - want).abs() > rtol * mag).any()):
            fail(f"K3 ({c}, {nloc}) {Tc.dtype}: the "
                 f"{'addmm' if uniform else 'baddbmm'} yardstick disagrees")
        out.update(library_ms=lib_ms, library_device_ms=lib_dev,
                   library_call="torch.addmm" if uniform
                   else "torch.baddbmm")
    return out


def check_dg_cell_degree2(dev, port) -> dict:
    """K3 at every degree-2 cell shape on the tables of the port's own
    HeatOperator, f64 (1e-12) and f32 (1e-5 of the terms' magnitudes, as
    at degree 1), in the operator's prepared call and in the direct call,
    forward and through torch.func.jvp, every shape in the element form;
    then timed at the main paths' sizes: nloc 27 with uniform f32 and f64
    tables at 65,536 cells (the cell of the 64x64x16 CG-2 plate of phase
    9b), nloc 10 with per-cell f64 tables at 67,584 tetrahedra and nloc
    27 with per-cell f32 and f64 tables at 27,648 hexes (phase 10b's
    plate as a mesh without box metadata, as a non-uniform hex mesh
    gives), each against both its bounds and its addmm / baddbmm
    yardstick."""
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d

    errs = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for label, mesh, family in k3_degree2_meshes():
            heat, shape = heat_tables(mesh, family, dtype, dev)
            uniform = heat.qw.dim() == 1
            if uniform != (shape[1] in (3, 9, 27) and mesh.structured
                           is not None) or shape[1] != int(label.split()[1]):
                fail(f"K3 {label}: tables {tuple(heat.qw.shape)}, cells "
                     f"{shape}")
            if heat._cell_term.path != "element":
                fail(f"K3 {label}: the prepared call takes "
                     f"{heat._cell_term.path}, not the element form")
            errs[f"{label} {str(dtype).split('.')[-1]}"] = dict(
                cells=shape[0], q=int(heat.phi.shape[0]),
                tables="uniform" if uniform else "per-cell",
                path=heat._cell_term.path, max_abs_err=max(
                    check_dg_cell_case(shape, heat.qw, heat.gphi, heat.phi,
                                       rtol, port, c_mass=cm, with_src=ws,
                                       seed=i, prepared=pr)
                    for i, (cm, ws) in enumerate(K3_CASES)
                    for pr in (True, False)))
    log("K3 degree-2 shapes " + json.dumps(errs))
    rng = np.random.default_rng(12)
    out = dict(shapes=errs)
    kw = dict(dt=0.1, c_mass=1.0, c_diff=0.83, f_src=0.0)
    # the hex of the 64x64x16 plate (1 x 1 x 0.01): a 4 x 4 x 1 box of it
    hexes = box_mesh_3d(4, 4, 1, 4 / N_CG2[0], 4 / N_CG2[1], 0.01 / N_CG2[2])
    for key, mesh, family, dtype, cells in (
            ("nloc27_uniform_f32", hexes, "CG", torch.float32,
             int(np.prod(N_CG2))),
            ("nloc27_uniform_f64", hexes, "CG", torch.float64,
             int(np.prod(N_CG2))),
            ("nloc10_per_cell_f64", box_mesh_3d(32, 32, 11, cell_type="tet"),
             "CG", torch.float64, None)):
        heat, shape = heat_tables(mesh, family, dtype, dev)
        shape = (cells or shape[0], shape[1])
        Tc = torch.tensor(700.0 + 100.0 * rng.random(shape), dtype=dtype,
                          device=dev)
        Tpc = Tc + 1.0
        out[key] = time_k3(port, heat._cell_term, Tc, Tpc, kw, heat.qw,
                           heat.gphi, heat.phi, heat.qw.dim() == 1,
                           1e-12 if dtype == torch.float64 else 1e-5)
        log(f"K3 {key} " + json.dumps(out[key]))
        del heat, Tc, Tpc
    # per-cell hexes: one f64 operator's tables, rounded for f32 as the
    # f32 operator rounds its own (its build is ~10 s of host time)
    heat, shape = heat_tables(per_cell_hexes(), "CG", torch.float64, dev)
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        key = f"nloc27_per_cell_{'f32' if dtype == torch.float32 else 'f64'}"
        qw, gphi, phi = (t.to(dtype) for t in (heat.qw, heat.gphi, heat.phi))
        call = port["PreparedDGCellResidual"](qw, gphi, phi)
        Tc = torch.tensor(700.0 + 100.0 * rng.random(shape), dtype=dtype,
                          device=dev)
        Tpc = Tc + 1.0
        out[key] = time_k3(port, call, Tc, Tpc, kw, qw, gphi, phi, False,
                           rtol)
        log(f"K3 {key} " + json.dumps(out[key]))
        del call, qw, gphi, phi, Tc, Tpc
    del heat
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

    # warm-up chunk on the real initial transient, then the timed window;
    # phase 11 holds the command line's run to the warm-up chunk
    st, ok, ni, ki = prob.multi_step(prob.state, WARMUP_STEPS)
    torch.cuda.synchronize()
    if not ok:
        fail("warm-up chunk did not converge")
    warmup = dict(T=st.T.cpu().numpy(), newton=int(ni), cg=int(ki))
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
    expect = 1 + k2_launches_per_vcycle(prob._mg)
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
    out["warmup"] = warmup
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
    if (d.newton_iters, d.krylov_iters) != (GOLDEN_NEWTON, GOLDEN_CG):
        fail(f"default run took {d.newton_iters} Newton and "
             f"{d.krylov_iters} CG iterations, the CPU reference "
             f"{GOLDEN_NEWTON} and {GOLDEN_CG}")
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

    # assembled (ELL SpMV) against matrix-free over SIDE_STEPS steps, and
    # a checkpoint written halfway and resumed to the end
    n, half = SIDE_STEPS, SIDE_STEPS // 2
    finals = {}
    for lo in ("matrix_free", "assembled"):
        p = ThermoViscoProblem(config=default_config(
            tc, n, linear_operator=lo), device=dev)
        p.setup()
        finals[lo] = p.solve()
    a, b = (finals[k].T.cpu().numpy() for k in ("matrix_free", "assembled"))
    out["assembled_T_max_rel"] = float(np.abs(a - b).max() / np.abs(a).max())
    if not out["assembled_T_max_rel"] < 1e-9:
        fail(f"assembled vs matrix-free T: {out['assembled_T_max_rel']:.3e}")
    first = ThermoViscoProblem(config=default_config(tc, n), device=dev)
    first.setup()
    first.state, ok, _, _ = first.multi_step(first.state, half)
    first.t = half * first.dt
    path = os.path.join(scratch_dir, f"default_step{half}.npz")
    first.save_checkpoint(path)
    second = ThermoViscoProblem(config=default_config(tc, n), device=dev)
    second.setup()
    second.resume_from(path)
    resumed, ok2, _, _ = second.multi_step(second.state, n - half)
    if not (ok and ok2) or abs(second.t - half * second.dt) > 1e-12:
        fail("the checkpointed run did not converge or lost its time")
    # the resumed run repeats the whole run's bits, every field (JAX's
    # tests/test_io.py::test_checkpoint_resume_bitwise)
    differ = [f for f, want in finals["matrix_free"]._asdict().items()
              if want is not None and not bits_equal(getattr(resumed, f),
                                                     want)]
    out["checkpoint_resume_bit_equal"] = not differ
    if differ:
        fail(f"resumed run differs from the whole run in {differ}")
    log("default workload, assembled + checkpoint " + json.dumps(
        {k: out[k] for k in ("assembled_T_max_rel",
                             "checkpoint_resume_bit_equal")}))
    return out


def dg_plate_config(tc, steps, **solver):
    """DG-1 T / CG-1 sigma at the config defaults (f64, rtol 1e-12). By
    default SA-AMG and the matrix-free operator, stated: the mesh-agnostic
    path (phase 6); phase 7 passes preconditioner="auto" and
    linear_operator="stencil"."""
    kw = dict(preconditioner="amg", linear_operator="matrix_free")
    kw.update(solver)
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="DG", T_degree=1, sigma_family="CG",
                       sigma_degree=1),
        time=tc.TimeConfig(0.0, steps * 0.1, 0.1),
        solver=tc.SolverConfig(**kw),
        output=tc.OutputConfig(write_every=0, formats=()), dtype="float64")


DG_AUTO = dict(preconditioner="auto", linear_operator="stencil")


def dg_parity_phase(dev) -> dict:
    """The DG plate configuration at 8x8x4, 3 steps: the GPU twice, then
    against the CPU."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    runs = []
    for where in ("cpu", dev, dev):
        p = ThermoViscoProblem(mesh=box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01),
                               config=dg_plate_config(tc, DG_PARITY_STEPS),
                               device=where)
        p.setup()
        st, ok, ni, ki = p.multi_step(p.state, DG_PARITY_STEPS)
        if not ok:
            fail(f"8x8x4 DG parity run did not converge on {where}")
        runs.append((st, ni, ki))
    (sc, nc, kc), (sg, ng, kg), (sg2, ng2, kg2) = runs
    # The gather residual's scatter-adds go one group of distinct dofs at
    # a time (ops/scatter.py): the card repeats its bits from run to run
    repeat = all(torch.equal(getattr(sg, f), getattr(sg2, f))
                 for f in ("T", "Tf", "sigma"))
    out = dict(newton_cpu=nc, newton_gpu=ng, cg_cpu=kc, cg_gpu=kg,
               gpu_repeats_its_bits=repeat)
    if not repeat or (ng, kg) != (ng2, kg2):
        fail(f"DG parity: two runs on the card differ ({ng}/{ng2} Newton, "
             f"{kg}/{kg2} CG)")
    for f in ("T", "Tf"):
        a, b = getattr(sc, f).numpy(), getattr(sg, f).cpu().numpy()
        out[f"{f}_max_rel"] = float(np.abs(a - b).max() / np.abs(a).max())
        if not out[f"{f}_max_rel"] < 1e-9:
            fail(f"DG parity {f}: {out[f'{f}_max_rel']:.3e}")
    a, b = sc.sigma.numpy(), sg.sigma.cpu().numpy()
    out["sigma_rel_to_max"] = float(np.abs(a - b).max() / np.abs(a).max())
    if not out["sigma_rel_to_max"] <= 1e-6:
        fail(f"DG parity sigma: {out['sigma_rel_to_max']:.3e}")
    # Against the CPU the card rounds differently, not in another order,
    # and at rtol 1e-12 a CG solve of ~80 iterations stops on the last
    # bits: 1,169 CG on the card against 1,179. Each part of the card's
    # arithmetic moved alone to the CPU (K3, the dot products, the ELL
    # SpMVs, the AMG cycle, the gather residual) moves the count to either
    # side (1,163 .. 1,181), and with all of them there the card's run
    # equals the CPU's bit for bit (chip_ab.py dgparity). Newton equal,
    # CG within 1%
    if nc != ng or abs(kc - kg) > 0.01 * kc:
        fail(f"DG parity iterations: newton {nc}/{ng}, cg {kc}/{kg}")
    log("DG parity " + json.dumps(out))
    return out


def dg_plate_phase(dev, port) -> dict:
    """Phase 6: the DG-1 plate at 221,184 T dofs on the card (SA-AMG)."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    t0 = time.perf_counter()
    prob = ThermoViscoProblem(
        mesh=box_mesh_3d(*N_DG_AMG, 1.0, 1.0, 0.01),
        config=dg_plate_config(tc, DG_TIMED_STEPS), device=dev)
    prob.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    spent = prob.setup_seconds
    n = prob.fs_T.n_scalar_dofs
    if n != 8 * int(np.prod(N_DG_AMG)):
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

    # K3 at the very tensors the residual hands it, in the operator's
    # prepared call and in the direct one
    heat = prob.heat
    Tc, Tpc = st.T[heat.dofmap], st.T_prev[heat.dofmap]
    kw = dict(dt=prob.dt, c_mass=heat.c_mass, c_diff=heat.c_diff,
              f_src=prob.params.f)
    k, ref = port["dg_cell_residual"], port["dg_cell_residual_reference"]
    got = heat._cell_term(Tc, Tpc, **kw)
    got_direct = k(Tc, Tpc, heat.qw, heat.gphi, heat.phi, **kw)
    want = ref(Tc, Tpc, heat.qw, heat.gphi, heat.phi, **kw)
    mag = ref(Tc.abs(), -Tpc.abs(), heat.qw, heat.gphi.abs(),
              heat.phi.abs(), **dict(kw, f_src=-abs(kw["f_src"])))
    torch.cuda.synchronize()
    if heat._cell_term.path != "param" or not torch.equal(got, got_direct) \
            or bool(((got - want).abs() > 1e-12 * mag).any()):
        fail("dg_cell_residual disagrees with its plain version on the "
             "plate's state")
    out["k3_ms_in_path"] = time_ms(lambda: heat._cell_term(Tc, Tpc, **kw))
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


def dg_auto_parity_phase(dev) -> dict:
    """Phase 7a: the DG-1 plate through preconditioner="auto" (the DG
    p-multigrid) and the DG block stencil at 8x8x4, 3 steps, the GPU
    against the CPU. The block stencil adds its boundary-facet terms one
    group of distinct cells at a time, so the card repeats its own bits
    and the Newton counts must agree exactly; CG within 5%."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    res = {}
    for where in ("cpu", dev):
        p = ThermoViscoProblem(mesh=box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01),
                               config=dg_plate_config(tc, DG_PARITY_STEPS,
                                                      **DG_AUTO),
                               device=where)
        p.setup()
        if p._dg_mg is None or p._dg_mg.smoother != "column":
            fail(f"'auto' on the 8x8x4 DG plate is not the column-smoothed "
                 f"DG multigrid on {where}")
        st, ok, ni, ki = p.multi_step(p.state, DG_PARITY_STEPS)
        if not ok:
            fail(f"8x8x4 DG 'auto' parity run did not converge on {where}")
        res[str(where)] = (st, ni, ki)
    (sc, nc, kc), (sg, ng, kg) = res["cpu"], res[str(dev)]
    out = dict(newton_cpu=nc, newton_gpu=ng, cg_cpu=kc, cg_gpu=kg)
    for f in ("T", "Tf"):
        a, b = getattr(sc, f).numpy(), getattr(sg, f).cpu().numpy()
        out[f"{f}_max_rel"] = float(np.abs(a - b).max() / np.abs(a).max())
        if not out[f"{f}_max_rel"] <= 1e-9:
            fail(f"DG 'auto' parity {f}: {out[f'{f}_max_rel']:.3e}")
    a, b = sc.sigma.numpy(), sg.sigma.cpu().numpy()
    out["sigma_rel_to_max"] = float(np.abs(a - b).max() / np.abs(a).max())
    if not out["sigma_rel_to_max"] <= 1e-6:
        fail(f"DG 'auto' parity sigma: {out['sigma_rel_to_max']:.3e}")
    if nc != ng or abs(kc - kg) > 0.05 * kc:
        fail(f"DG 'auto' parity iterations: newton {nc}/{ng}, cg {kc}/{kg}")
    log("DG auto parity " + json.dumps(out))
    return out


def k2_launches_per_vcycle(mg) -> int:
    """K2 launches of one GeometricMG V-cycle: nu_pre + 1 + nu_post
    stencil applies on every level but the coarsest, and coarse_iters
    there unless it is the dense direct solve."""
    n = sum(mg.nu_pre + 1 + mg.nu_post for lv in mg.levels
            if lv.coarse_dims is not None)
    return n + (0 if mg.coarse_inv is not None else mg.coarse_iters)


def dg_auto_plate_run(dev, port, cg_dtype) -> tuple[dict, object]:
    """One phase 7b run: the 64x64x16 DG-1 plate through "auto" and the
    block stencil, 1 warm-up step and DG_TIMED_STEPS timed ones."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.ops.stencil import DGStencilMatrix

    tag = f"DG auto plate {cg_dtype}"
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    prob = ThermoViscoProblem(
        mesh=box_mesh_3d(*N_DG, 1.0, 1.0, 0.01),
        config=dg_plate_config(tc, DG_TIMED_STEPS, cg_dtype=cg_dtype,
                               **DG_AUTO), device=dev)
    prob.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(dev)
    setup_held = torch.cuda.memory_allocated(dev)
    mixed = cg_dtype == "float32"
    dg_mg = prob._dg_mg32 if mixed else prob._dg_mg
    if (prob.config.solver.preconditioner != "mg" or dg_mg is None
            or dg_mg.smoother != "column"
            or "colinv" not in dg_mg._frozen_smoother_data
            or not isinstance(prob._ell32 if mixed else prob._ell,
                              DGStencilMatrix)):
        fail(f"{tag}: 'auto' is not the column-smoothed DG multigrid with "
             f"the block stencil")
    if prob.heat.i_qw is not None:
        fail(f"{tag}: the interior-facet tables reached the card")
    n = prob.fs_T.n_scalar_dofs
    levels = [lv.fine_dims for lv in dg_mg.cg_mg.levels]
    log(f"{tag}: {n} dofs, setup {setup_s:.1f} s "
        + json.dumps(prob.setup_seconds) + f", CG-1 levels {levels}, "
        f"column types {int(dg_mg._frozen_smoother_data['colinv'].shape[0])}"
        f", rho {dg_mg._frozen_rho:.6f}")

    st, ok, ni0, ki0 = prob.multi_step(prob.state, 1)      # warm-up
    torch.cuda.synchronize()
    if not ok:
        fail(f"{tag}: warm-up step did not converge")
    # the timed window starts from a fresh state, with the problem's own
    # initial state still held: two states of ~200 MB each at this size
    del st
    state0 = prob.engine.init_state()
    torch.cuda.synchronize()
    window_held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(port)
    t0 = time.perf_counter()
    st, ok, ni, ki = prob.multi_step(state0, DG_TIMED_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated(dev)
    if not ok:
        fail(f"{tag}: timed window did not converge")
    for f in ("T", "Tf", "sigma"):
        if not bool(torch.isfinite(getattr(st, f)).all()):
            fail(f"{tag}: non-finite {f}")
    T_np = st.T.cpu().numpy()
    if not (prob.params.T_ambient - 1 < T_np.min() <= T_np.max()
            < prob.params.T_0 + 1):
        fail(f"{tag}: T out of [T_ambient, T_0]: {T_np.min()} .. "
             f"{T_np.max()}")
    # K1 once per step; one V-cycle per preconditioner apply, i.e. one
    # before each CG solve starts (one per Newton iteration) and one per
    # CG iteration; the block stencil carries the residual: no K3
    per_cycle = k2_launches_per_vcycle(dg_mg.cg_mg)
    expect = dict(material_tspace=DG_TIMED_STEPS,
                  stencil_matvec=per_cycle * (ni + ki), dg_cell_residual=0)
    if launches != expect or launches["stencil_matvec"] == 0:
        fail(f"{tag}: launches {launches}, expected {expect} "
             f"({ni} Newton + {ki} CG)")
    # K2 on the real value tables of every stencil level of the CG-1
    # correction, in the cycle's dtype (outside the counted window)
    cdt = torch.float32 if mixed else torch.float64
    rng = np.random.default_rng(4)
    cg = dg_mg.cg_mg
    k2_levels = []
    for lvl, Tc in zip(cg.levels, cg.linearization_states(
            dg_mg.restrict_state(st.T.to(cdt)))):
        if lvl.coarse_dims is None:
            continue               # dense coarse solve: no stencil apply
        g = cg._grid_for(lvl)
        vals2 = g.stencil_values(Tc, prob.dt).reshape(27, g.grid[0], -1)
        x = torch.tensor(rng.standard_normal(g.n), dtype=cdt, device=dev)
        k2_levels.append(dict(grid=g.grid, max_abs_err=check_stencil(
            vals2, x, g.grid, 1e-5 if mixed else 1e-12, port)))
    out = dict(dofs=n, cg_dtype=cg_dtype, setup_s=setup_s,
               k2_levels=k2_levels,
               setup_parts_s=prob.setup_seconds, cg1_levels=levels,
               column_types=int(
                   dg_mg._frozen_smoother_data["colinv"].shape[0]),
               frozen_rho=dg_mg._frozen_rho,
               newton_per_step=ni / DG_TIMED_STEPS,
               cg_per_step=ki / DG_TIMED_STEPS,
               ms_per_step=elapsed / DG_TIMED_STEPS * 1e3,
               launches=launches, k2_launches_per_vcycle=per_cycle,
               vcycles=ni + ki, max_memory_allocated_bytes=peak,
               setup_max_memory_allocated_bytes=setup_peak,
               held_after_setup_bytes=setup_held,
               held_before_window_bytes=window_held,
               state_bytes=sum(t.numel() * t.element_size() for t in st
                               if isinstance(t, torch.Tensor)),
               T_min=float(T_np.min()), T_max=float(T_np.max()))

    # the layers of one CG iteration, at the final state
    ell = prob._ell32 if mixed else prob._ell
    Tl = st.T.to(cdt)
    v = torch.ones_like(Tl)
    mv = ell.make_matvec(Tl, prob.dt)
    pc = dg_mg.preconditioner(Tl, prob.dt)
    inner = cg.preconditioner(cg.linearization_states(
        dg_mg.restrict_state(Tl)), prob.dt)
    vc = torch.ones(dg_mg.n_nodes, dtype=cdt, device=dev)
    data = dg_mg._frozen_smoother_data
    hres = prob._residual_operator(prob.heat, prob._grid, prob._ell)
    Tcg = dg_mg.restrict_state(Tl)
    out["layers_ms"] = dict(
        block_stencil_matvec=time_ms(lambda: mv(v), reps=20),
        pmg_vcycle=time_ms(lambda: pc(v), reps=10),
        cg1_vcycle=time_ms(lambda: inner(vc), reps=10),
        column_solve=time_ms(lambda: dg_mg._zsolve_apply(data, v), reps=20),
        p_transfers=time_ms(lambda: dg_mg.prolong(dg_mg.restrict(v)),
                            reps=20),
        residual_f64=time_ms(lambda: hres.residual(st.T, st.T_prev,
                                                   prob.dt), reps=10),
        operator_build=time_ms(lambda: (ell.make_matvec(Tl, prob.dt),
                                        dg_mg.preconditioner(Tl, prob.dt)),
                               reps=5),
        block_stencil_build=time_ms(lambda: ell.make_matvec(Tl, prob.dt),
                                    reps=5),
        cg1_vcycle_build=time_ms(lambda: cg.preconditioner(
            cg.linearization_states(Tcg), prob.dt), reps=5),
        material_step=time_ms(lambda: prob.engine.material_step(
            st, st.T, prob.dt), reps=5))
    # the device memory that each part of a step adds at its peak
    base = torch.cuda.memory_allocated(dev)
    out["peak_added_bytes"] = {}
    for part, fn in (
            ("operator_build", lambda: (ell.make_matvec(Tl, prob.dt),
                                        dg_mg.preconditioner(Tl, prob.dt))),
            ("pmg_vcycle", lambda: pc(v)),
            ("material_step", lambda: prob.engine.material_step(
                st, st.T, prob.dt))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        res = fn()
        torch.cuda.synchronize()
        out["peak_added_bytes"][part] = \
            torch.cuda.max_memory_allocated(dev) - base
        del res
    out["cg_iteration_ms_estimate"] = (
        out["layers_ms"]["block_stencil_matvec"]
        + out["layers_ms"]["pmg_vcycle"])
    log(tag + " " + json.dumps(out))
    return out, st.T.cpu()


def dg_auto_plate_phase(dev, port, ref_path=None) -> dict:
    """Phase 7b: the f64 run, then the mixed-precision run, whose T must
    lie within 5e-3 K of the f64 run's (the mixed-precision DG floor).
    `ref_path`: where the f64 run's T and counts go for phase 13f (an
    .npz, written whole or not at all)."""
    out = {}
    T = {}
    for cg_dtype in ("same", "float32"):
        drop_garbage(f"phase 7b {cg_dtype}")
        out[cg_dtype], T[cg_dtype] = dg_auto_plate_run(dev, port, cg_dtype)
        if cg_dtype == "same" and ref_path is not None:
            tmp = ref_path + ".part.npz"
            np.savez(tmp, T=T["same"].numpy(),
                     newton_per_step=out["same"]["newton_per_step"],
                     cg_per_step=out["same"]["cg_per_step"])
            os.replace(tmp, ref_path)
    diff = float((T["float32"] - T["same"]).abs().max())
    out["mixed_vs_f64_T_max_abs_K"] = diff
    if not diff <= 5e-3:
        fail(f"DG auto plate: mixed T differs from f64 T by {diff:.3e} K")
    log(f"DG auto plate: mixed vs f64 max |dT| {diff:.3e} K")
    return out


def z_faces(mids):
    """Flux only through the plate's z faces (z = 0 and z = 10): the
    sides are insulated, as in the JAX package's mechanics runs."""
    return (mids[:, 2] < 1e-9) | (mids[:, 2] > 10.0 - 1e-9)


def mech_plate_config(tc, steps, **kw):
    """The JAX package's coupled mechanics configurations on a CG-1
    plate: `kw` sets the solver, the dtype, the parameters and the xi
    formula (physics "corrected", mechanics "equilibrium")."""
    solver = kw.pop("solver", {})
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="CG", T_degree=1),
        time=tc.TimeConfig(0.0, steps * 0.1, 0.1),
        solver=tc.SolverConfig(**solver),
        output=tc.OutputConfig(write_every=0, formats=()),
        physics_mode="corrected", mechanics="equilibrium", **kw)


def centre_profile(prob, st):
    """z and sigma_xx of the sigma-space nodes on the plate's centre
    column (x = y = 25), sorted by z."""
    xs = prob.fs_sigma.dof_coords
    c = (np.abs(xs[:, 0] - 25.0) < 1e-9) & (np.abs(xs[:, 1] - 25.0) < 1e-9)
    z = xs[c][:, 2]
    o = np.argsort(z)
    return z[o], st.sigma[:, 0, 0].cpu().numpy()[c][o]


def gpu_cpu_runs(dev, make, steps, port=None):
    """The same problem `make(device)` for `steps` steps on the CPU and
    on the card -> {where: (state, newton, cg, elasticity CG per step,
    seconds, problem)}; with `port`, res["launches"] holds the kernel
    launches of the card's run (counters set to 0 just before it)."""
    res = {}
    for where in ("cpu", dev):
        p = make(where)
        if port is not None and where == dev:
            torch.cuda.synchronize()
            reset_counts(port)
        t0 = time.perf_counter()
        st, ok, ni, ki = p.multi_step(p.state, steps)
        if port is not None and where == dev:
            torch.cuda.synchronize()
            res["launches"] = read_counts(port)
        if not ok:
            fail(f"mechanics parity run did not converge on {where}")
        res[str(where)] = (st, ni, ki, list(p.last_mech_iters),
                           time.perf_counter() - t0, p)
    return res


def hold_parity(tag, res, dev, strict=True) -> dict:
    """GPU against CPU: T, Tf max-rel 1e-9 and equal Newton and heat-CG
    counts; with `strict`, also equal elasticity-CG counts in every step
    and sigma, du within 1e-6 of their max. Without it (the reference xi,
    mechanics_parity_phase) the elasticity-CG total within 5% and sigma
    within 1e-3 of its max, and the first step whose elasticity count
    differs is reported (None: none)."""
    (sc, nc, kc, mc, tc_, _), (sg, ng, kg, mg, tg, _) = (res["cpu"],
                                                        res[str(dev)])
    out = dict(newton_cpu=nc, newton_gpu=ng, cg_cpu=kc, cg_gpu=kg,
               elast_cg_cpu=sum(mc), elast_cg_gpu=sum(mg),
               first_elast_cg_difference=next(
                   (i for i, (a, b) in enumerate(zip(mc, mg)) if a != b),
                   None),
               seconds_cpu=tc_, seconds_gpu=tg)
    for f in ("T", "Tf", "sigma", "du"):
        a, b = getattr(sc, f).numpy(), getattr(sg, f).cpu().numpy()
        out[f"{f}_max_rel"] = float(np.abs(a - b).max() / np.abs(a).max())
    bad = [f for f, lim in (("T", 1e-9), ("Tf", 1e-9))
           + ((("sigma", 1e-6), ("du", 1e-6)) if strict
              else (("sigma", 1e-3),)) if not out[f"{f}_max_rel"] <= lim]
    if bad or (nc, kc) != (ng, kg) or (
            mc != mg if strict
            else abs(sum(mc) - sum(mg)) > 0.05 * sum(mc)):
        fail(f"{tag}: GPU against CPU {json.dumps(out)}, elasticity CG "
             f"per step {mc} / {mg}")
    return out


def centre_profile_stats(prob, st) -> dict:
    """The centre column's sigma_xx: |thickness mean|, max |.|, surfaces,
    core, and the largest difference from its mirror image."""
    z, pe = centre_profile(prob, st)
    return dict(membrane_mean=float(abs(np.trapezoid(pe, z)
                                        / (z[-1] - z[0]))),
                sigma_xx_max_abs=float(np.abs(pe).max()),
                sigma_xx_surfaces=(float(pe[0]), float(pe[-1])),
                sigma_xx_core=float(pe[len(pe) // 2]),
                asymmetry=float(np.abs(pe - pe[::-1]).max()))


def membrane_balance(tag, prob, st) -> dict:
    """The quench signature of tests/test_mechanics.py:98-112 on the
    centre column: |thickness mean of sigma_xx| < 5% of max|sigma_xx|,
    surfaces in tension, core in compression, symmetric to 5%."""
    o = centre_profile_stats(prob, st)
    peak = o["sigma_xx_max_abs"]
    if not (o["membrane_mean"] < 0.05 * peak
            and min(o["sigma_xx_surfaces"]) > 0 and o["sigma_xx_core"] < 0
            and o["asymmetry"] <= 0.05 * peak):
        fail(f"{tag}: no membrane balance {json.dumps(o)}")
    return o


def mechanics_parity_phase(dev, port) -> dict:
    """Phase 8a: the JAX package's quenching plate (tests/
    test_mechanics.py:60-112) with its reference xi and with the
    trapezoid xi of phase 8b, and a DG-1 plate with mechanics, each the
    GPU against the CPU.

    With the reference xi the vector V-cycle has no dense coarse solve
    (the frozen moduli need the trapezoid relax factor, models/
    mechanics.py), and two things let runs that round differently part:
    a warm elasticity solve stops at 1e-2 of its start residual (the
    increment tolerance) and keeps that start's rounding, so JAX moves
    against itself by ~5e-6 of max|sigma| in one step when its warm start
    moves by one ulp; and a cold solve of ~51 iterations ends on the rtol
    1e-12 test, where a run may take one iteration more. The port and the
    JAX package on one CPU agree in every count for the first four steps
    and part at the fifth (tests/test_torch_mechanics_plate.py), and differ
    by 632 against 647 elasticity CG in 50 steps. The card and the CPU
    may part so too: that run holds the temperatures, the heat counts and
    the membrane balance, and sigma to 1e-3, and reports the first step
    whose elasticity count differs. The trapezoid run (a dense coarse
    solve, a few iterations a step) is held strictly.
    The card's run of the JAX test's plate counts its kernel launches: K1
    once a step (the reference xi is K1's function), K2 in every heat
    V-cycle, no K3."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.mechanics import (
        DGNodeMechAdapter,
        GridMechanicsCoupling,
    )
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    def plate(xi):
        def make(where):
            p = ThermoViscoProblem(
                mesh=box_mesh_3d(4, 4, 16, 50.0, 50.0, 10.0),
                config=mech_plate_config(tc, MECH_PLATE_STEPS[xi],
                                         xi_formula=xi), device=where)
            p.setup(flux_marker=z_faces)
            if not isinstance(p._mech, GridMechanicsCoupling):
                fail("the quenching plate does not take the grid coupling")
            return p
        return make

    out = {}
    for xi in ("reference", "trapezoid"):
        tag = f"quenching plate, {xi} xi"
        strict = xi == "trapezoid"
        res = gpu_cpu_runs(dev, plate(xi), MECH_PLATE_STEPS[xi],
                           port=None if strict else port)
        o = hold_parity(tag, res, dev, strict=strict)
        st, ni, ki, mi, _, prob = res[str(dev)]
        if strict:
            o["membrane_gpu"] = centre_profile_stats(prob, st)
        else:
            o["membrane_gpu"] = membrane_balance(tag, prob, st)
            o["membrane_cpu"] = membrane_balance(tag, res["cpu"][5],
                                                 res["cpu"][0])
            # K1 once a step; one heat V-cycle per preconditioner apply
            # (one as each CG solve starts, one per CG iteration: the
            # outer operator is matrix-free); no K3 on the CG-1 grid
            expect = dict(material_tspace=MECH_PLATE_STEPS[xi],
                          stencil_matvec=k2_launches_per_vcycle(prob._mg)
                          * (ni + ki), dg_cell_residual=0)
            o["launches"] = res["launches"]
            if res["launches"] != expect:
                fail(f"{tag}: launches {res['launches']}, expected "
                     f"{expect} ({ni} Newton + {ki} CG)")
        o["elast_cg_per_step_gpu"] = mi
        o["elast_cg_per_step_cpu"] = res["cpu"][3]
        # the column solve of the plate's fine level (its smoother; the
        # full-width plate of 8b smooths point-wise), at the final state
        mech = prob._mech
        mg = mech.mg
        G, K = mech._moduli_at(st.xi.reshape(mech.el.grid))
        Dg, Ug = mg._column_blocks(0, G.mean(-1), K.mean(-1))
        zs = mg._column_solver(0, Dg, Ug)
        r = torch.ones(mech.el.grid + (3,), dtype=G.dtype, device=G.device)
        o["column_solve_ms"] = time_ms(lambda: zs(r), reps=20)
        o["column_planes"] = mech.el.grid[mg._col_axis[0]]
        o["dense_coarse"] = mg.coarse_inv is not None
        log(f"mechanics {tag} " + json.dumps(o))
        out[xi] = o

    def dg_plate(where):
        cfg = dataclasses.replace(
            dg_plate_config(tc, DG_PARITY_STEPS, **DG_AUTO),
            mechanics="equilibrium", physics_mode="corrected",
            xi_formula="trapezoid")
        p = ThermoViscoProblem(mesh=box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01),
                               config=cfg, device=where)
        p.setup()
        if not isinstance(p._mech, DGNodeMechAdapter):
            fail("the DG plate's mechanics is not the node-grid adapter")
        return p

    out["dg"] = hold_parity("DG mechanics", gpu_cpu_runs(
        dev, dg_plate, DG_PARITY_STEPS), dev)
    log("mechanics DG plate " + json.dumps(out["dg"]))
    return out


def coupled_plate_mesh():
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    return box_mesh_3d(*N_MECH, 50.0, 50.0, 10.0)


def coupled_plate_config(tc):
    """Phase 8b's coupled plate (and 13d(c)'s): f32, trapezoid xi, T_0 =
    900 K, MECH_TIMED_STEPS steps; the flux through the z faces alone is
    the problem's `flux_marker=z_faces`."""
    return mech_plate_config(
        tc, MECH_TIMED_STEPS, dtype="float32", xi_formula="trapezoid",
        params=dataclasses.replace(tc.ModelParams(), T_0=900.0),
        solver=dict(newton_rtol=1e-5, newton_atol=1e-6, cg_rtol=1e-5,
                    cg_max_it=2000, preconditioner="mg",
                    mg_smoother="chebyshev", linear_operator="stencil",
                    jac_every="auto"))


def mechanics_plate_phase(dev, port) -> dict:
    """Phase 8b: the 128x128x32 coupled plate of the JAX package
    (examples/mechanics_3d_tpu.py:63-80, BENCH.md "First >=500k coupled
    row"), f32, 1 warm-up step and MECH_TIMED_STEPS timed steps. The
    timed window's final T and sigma and its counts ride in
    out["reference"] (numpy; phase 13d(c) is held to them), which the
    caller pops before logging the rest."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.models.mechanics import (
        GridMechanicsCoupling,
    )
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.solver.krylov import pcg

    tag = "mechanics plate"
    t0 = time.perf_counter()
    prob = ThermoViscoProblem(mesh=coupled_plate_mesh(),
                              config=coupled_plate_config(tc), device=dev)
    prob.setup(flux_marker=z_faces)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mech = prob._mech
    if not isinstance(mech, GridMechanicsCoupling) or mech.mg is None:
        fail(f"{tag}: not the grid coupling with the vector V-cycle")
    n, nu = prob.fs_T.n_scalar_dofs, 3 * mech.el.n
    if (n, nu) != (549_153, 1_647_459):
        fail(f"{tag}: {n} T dofs, {nu} displacement dofs")
    mg = mech.mg
    levels = dict(heat=[lv.fine_dims for lv in prob._mg.levels],
                  elasticity=[op.dims for op in mg.ops],
                  elasticity_smoothers=mg._smoothers,
                  elasticity_dense_coarse=mg.coarse_inv is not None)
    log(f"{tag}: {n} T dofs, {nu} displacement dofs, setup {setup_s:.1f} s "
        + json.dumps(prob.setup_seconds) + " " + json.dumps(levels))

    st, ok, _, _ = prob.multi_step(prob.state, 1)           # warm-up
    torch.cuda.synchronize()
    if not ok:
        fail(f"{tag}: warm-up step did not converge")
    warm_mech = list(prob.last_mech_iters)
    del st
    state0 = prob.engine.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(port)
    t0 = time.perf_counter()
    st, ok, ni, ki = prob.multi_step(state0, MECH_TIMED_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated(dev)
    mi = list(prob.last_mech_iters)
    if not ok:
        fail(f"{tag}: timed window did not converge")
    for f in ("T", "Tf", "sigma", "du"):
        if not bool(torch.isfinite(getattr(st, f)).all()):
            fail(f"{tag}: non-finite {f}")
    T_np = st.T.cpu().numpy()
    if not (prob.params.T_ambient - 1 < T_np.min() <= T_np.max()
            < prob.params.T_0 + 1):
        fail(f"{tag}: T out of [T_ambient, T_0]: {T_np.min()} .. "
             f"{T_np.max()}")
    # K2: every Newton iteration applies the heat Jacobian (the stencil)
    # once before its CG starts and every CG iteration once more, each
    # with a heat V-cycle of k2_launches_per_vcycle stencil applies. No K1:
    # the trapezoid xi is not K1's function (K1 computes the reference xi,
    # as the JAX package's kernel does; models/viscoelastic.py), so the
    # T-space chain is plain PyTorch here, as it is plain XLA there. The
    # elasticity solve is plain PyTorch; no K3 on the CG-1 grid path
    per_apply = 1 + k2_launches_per_vcycle(prob._mg)
    expect = dict(material_tspace=0,
                  stencil_matvec=per_apply * (ni + ki), dg_cell_residual=0)
    if launches != expect or len(mi) != MECH_TIMED_STEPS:
        fail(f"{tag}: launches {launches}, expected {expect} ({ni} Newton "
             f"+ {ki} CG), elasticity CG per step {mi}")
    z, pe = centre_profile(prob, st)
    out = dict(dofs=n, displacement_dofs=nu, setup_s=setup_s,
               setup_parts_s=prob.setup_seconds, levels=levels,
               ms_per_step=elapsed / MECH_TIMED_STEPS * 1e3,
               newton_per_step=ni / MECH_TIMED_STEPS,
               cg_per_step=ki / MECH_TIMED_STEPS,
               elast_cg_per_step=sum(mi) / MECH_TIMED_STEPS,
               elast_cg_each_step=mi, elast_cg_warmup=warm_mech,
               launches=launches, k2_launches_per_apply=per_apply,
               max_memory_allocated_bytes=peak,
               T_min=float(T_np.min()), T_max=float(T_np.max()),
               sigma_xx_surface=float(pe[0]),
               sigma_xx_core=float(pe[len(pe) // 2]),
               sigma_xx_thickness_mean=float(
                   np.trapezoid(pe, z) / (z[-1] - z[0])),
               sigma_xx_max_abs=float(np.abs(pe).max()))

    # the layers, at the final state: K2 on the heat V-cycle's fine level,
    # then the elasticity solve's parts
    fine = prob._grid
    rng = np.random.default_rng(5)
    vals2 = fine.stencil_values(st.T, prob.dt).reshape(27, fine.grid[0], -1)
    x = torch.tensor(rng.standard_normal(n), dtype=prob.dtype, device=dev)
    out["k2_fine_max_abs_err"] = check_stencil(vals2, x, fine.grid, 1e-5,
                                               port)
    del vals2, x
    el = mech.el
    G, K = mech._moduli_at(st.xi.reshape(el.grid))
    tbl = el.stencil_table_g(G, K)
    pc = mg.preconditioner_g(G, K, fine_table=tbl)
    v = torch.tensor(rng.standard_normal(el.grid + (3,)), dtype=G.dtype,
                     device=dev)
    mv = lambda u: el.matvec_table_g(tbl, u)  # noqa: E731
    diag = el.jacobian_diag_g(G, K)

    def cg(k):
        return pcg(mv, v, diag=diag, precond=pc, rtol=0.0, max_it=k)

    layers = dict(
        elast_table_build=time_ms(lambda: el.stencil_table_g(G, K), reps=5),
        elast_vcycle_build=time_ms(
            lambda: mg.preconditioner_g(G, K, fine_table=tbl), reps=3,
            warm=1),
        elast_matvec=time_ms(lambda: mv(v), reps=10),
        elast_vcycle_apply=time_ms(lambda: pc(v), reps=5),
        elast_cg_iteration=(time_ms(lambda: cg(10), reps=2, warm=1)
                            - time_ms(lambda: cg(0), reps=2, warm=1)) / 10,
        material_step=time_ms(lambda: prob.engine.material_step(
            st, st.T, prob.dt), reps=5),
        column_solve=None)
    out["layers_ms"] = layers
    # the per-step estimate of the elasticity share from the layers: the
    # CG iterations, the CG's table build, and a V-cycle build per chunk
    out["elast_ms_per_step_estimate"] = (
        out["elast_cg_per_step"] * layers["elast_cg_iteration"]
        + layers["elast_table_build"]
        + layers["elast_vcycle_build"] / MECH_TIMED_STEPS)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    del pc
    pc = mg.preconditioner_g(G, K, fine_table=tbl)
    torch.cuda.synchronize()
    out["elast_vcycle_build_peak_added_bytes"] = \
        torch.cuda.max_memory_allocated(dev) - base
    out["elast_table_bytes"] = tbl.numel() * tbl.element_size()
    log(tag + " " + json.dumps(out))
    out["reference"] = dict(T=T_np, sigma=st.sigma.cpu().numpy(), newton=ni,
                            cg=ki, mech=mi)
    return out


def cg2_config(tc, steps, f32_bench):
    """The CG-2 plate configurations of the JAX package: with `f32_bench`
    the 64x64x16 row of BENCH.md:398 (examples/highorder_tpu.py:59-81:
    f32, rtol 1e-5, "mg"), else the f64 parity configuration of tests/
    test_grid2.py:173-205 (rtol 1e-12, "auto"); both on the lattice path
    ("stencil") with a Chebyshev-smoothed CG-1 GeometricMG under Q2MG."""
    if f32_bench:
        solver = tc.SolverConfig(newton_rtol=1e-5, newton_atol=1e-6,
                                 cg_rtol=1e-5, cg_max_it=4000,
                                 linear_operator="stencil",
                                 preconditioner="mg",
                                 mg_smoother="chebyshev")
        dtype = "float32"
    else:
        solver = tc.SolverConfig(newton_rtol=1e-12, newton_atol=1e-10,
                                 cg_rtol=1e-12, cg_max_it=500,
                                 linear_operator="stencil",
                                 preconditioner="auto",
                                 mg_smoother="chebyshev")
        dtype = "float64"
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="CG", T_degree=2, sigma_family="CG",
                       sigma_degree=1),
        time=tc.TimeConfig(0.0, steps * 0.1, 0.1), solver=solver,
        output=tc.OutputConfig(write_every=0, formats=()), dtype=dtype)


def device_bytes(obj, seen=None) -> int:
    """Bytes of the distinct CUDA tensors that `obj` holds in its
    attributes, its lists, tuples and dicts, and the port's objects it
    holds in turn."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cuda" or obj.data_ptr() in seen:
            return 0
        seen.add(obj.data_ptr())
        return obj.numel() * obj.element_size()
    if isinstance(obj, (list, tuple)):
        return sum(device_bytes(v, seen) for v in obj)
    if isinstance(obj, dict):
        return sum(device_bytes(v, seen) for v in obj.values())
    if type(obj).__module__.startswith("fem_glass_tempering_tpu_torch"):
        return sum(device_bytes(v, seen) for v in vars(obj).values())
    return 0


def cg2_parity_case(dev, port, dims) -> tuple[dict, object]:
    """One phase 9a run: the CG-2 plate of `dims` cells through "auto"
    (Q2MG with the line smoother over the CG-1 GeometricMG), f64, rtol
    1e-12, 3 steps, the GPU against the CPU, with the K2 launches of the
    GPU run held to the count its hierarchy implies."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.ops.grid2 import Q2MG

    tag = "CG-2 parity " + "x".join(map(str, dims))
    steps = DG_PARITY_STEPS
    res = {}
    for where in ("cpu", dev):
        p = ThermoViscoProblem(
            mesh=box_mesh_3d(*dims, lx=1.0, ly=1.0, lz=0.01),
            config=cg2_config(tc, steps, False), device=where)
        p.setup()
        if not isinstance(p._mg, Q2MG) or p._mg.smoother != "line":
            fail(f"{tag}: 'auto' is not Q2MG with the line smoother on "
                 f"{where}")
        st, counts = p.state, []
        k2_before = port["stencil_matvec"].launches
        for _ in range(steps):
            st, ok, ni, ki = p.step(st)
            if not ok:
                fail(f"{tag}: no convergence on {where}")
            counts.append((ni, ki))
        k2_run = port["stencil_matvec"].launches - k2_before
        res[str(where)] = (st, counts, p, k2_run)
    (sc, cc, _, _), (sg, cgc, pg, k2_gpu) = res["cpu"], res[str(dev)]
    nc, kc = (sum(c[i] for c in cc) for i in (0, 1))
    ng, kg = (sum(c[i] for c in cgc) for i in (0, 1))
    gmg = pg._mg.gmg
    smoothed = sum(lv.coarse_dims is not None for lv in gmg.levels)
    # one Q2MG apply (one coarse V-cycle) before each CG solve and one per
    # CG iteration
    k2_expect = k2_launches_per_vcycle(gmg) * (ng + kg)
    out = dict(dims=dims, dofs=pg.fs_T.n_scalar_dofs,
               coarse_levels=[lv.fine_dims for lv in gmg.levels],
               coarse_smoothed_levels=smoothed, counts_cpu=cc,
               counts_gpu=cgc, newton_cpu=nc, newton_gpu=ng, cg_cpu=kc,
               cg_gpu=kg, k2_launches_gpu_run=k2_gpu)
    if k2_gpu != k2_expect:
        fail(f"{tag}: {k2_gpu} K2 launches, expected {k2_expect}")
    for f in ("T", "Tf"):
        a, b = getattr(sc, f).numpy(), getattr(sg, f).cpu().numpy()
        out[f"{f}_max_rel"] = float(np.abs(a - b).max() / np.abs(a).max())
        if not out[f"{f}_max_rel"] <= 1e-9:
            fail(f"{tag} {f}: {out[f'{f}_max_rel']:.3e}")
    a, b = sc.sigma.numpy(), sg.sigma.cpu().numpy()
    out["sigma_rel_to_max"] = float(np.abs(a - b).max() / np.abs(a).max())
    if not out["sigma_rel_to_max"] <= 1e-6:
        fail(f"{tag} sigma: {out['sigma_rel_to_max']:.3e}")
    # Newton equal; CG equal, or within 1% where a solve that stops on
    # its last bits (rtol 1e-12) ends one iteration apart, as the port and
    # JAX do on the CPU from starts one ulp apart (tests/
    # test_torch_grid_mg.py)
    if nc != ng or abs(kc - kg) > 0.01 * kc:
        fail(f"{tag} iterations: {cc} / {cgc}")
    log(tag + " " + json.dumps(out))
    return out, pg


def cg2_parity_phase(dev, port) -> dict:
    """Phase 9a: the CG-2 plate GPU against CPU on the 5x5x3 plate of
    tests/test_grid2.py:173-205 (its coarse V-cycle one dense level) and
    on the 32x32x4 plate (5,445 CG-1 nodes: one smoothed coarse level,
    whose K2 runs inside the solve, over a dense one); then, on the first,
    GridHeatOperator2's residual, diagonal and Jacobian action on the card
    against the gather HeatOperator's (residual, diagonal,
    torch.func.jvp) at 1e-12, which runs K3 at nloc 27, held to its plain
    version on the same tables."""
    out, pg = cg2_parity_case(dev, port, (5, 5, 3))
    out["smoothed_case"], _ = cg2_parity_case(dev, port, (32, 32, 4))
    if out["smoothed_case"]["coarse_smoothed_levels"] < 1:
        fail("CG-2 parity 32x32x4: no smoothed coarse level")

    # the lattice operator against the gather operator, on the card, on
    # the inputs of tests/test_grid2.py (a residual of the size of its
    # terms: at a converged state it is their cancellation)
    heat, g2 = pg.heat, pg._grid2
    rng = np.random.default_rng(9)
    n = g2.n
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
    T = t(800.0 + 10.0 * rng.standard_normal(n))
    Tp = t(800.0 + 10.0 * rng.standard_normal(n))
    v = t(rng.standard_normal(n))
    k3_before = port["dg_cell_residual"].launches
    r_gather = heat.residual(T, Tp)
    d_gather = heat.jacobian_diag(T)
    jv_gather = torch.func.jvp(lambda u: heat.residual(u, Tp), (T,),
                               (v,))[1]
    torch.cuda.synchronize()
    k3_calls = port["dg_cell_residual"].launches - k3_before
    if k3_calls == 0:
        fail("the CG-2 gather residual did not launch K3")
    for name, got, want in (
            ("residual", g2.residual(T, Tp), r_gather),
            ("diagonal", g2.jacobian_diag(T), d_gather),
            ("Jacobian action", g2.make_matvec(T, pg.dt)(v), jv_gather)):
        rel = float((got - want).abs().max() / want.abs().max())
        out[f"grid2_vs_gather_{name.replace(' ', '_')}_max_rel"] = rel
        if not rel <= 1e-12:
            fail(f"GridHeatOperator2 {name} against the gather operator on "
                 f"the card: {rel:.3e}")
    out["k3_launches_operator_check"] = k3_calls
    # K3 at nloc 27 on the operator's own tables: its prepared call and
    # the direct one against the plain version, forward and jvp
    shape = tuple(heat.dofmap.shape)
    out["k3_nloc27_path"] = heat._cell_term.path
    out["k3_nloc27_max_abs_err"] = max(
        check_dg_cell_case(shape, heat.qw, heat.gphi, heat.phi, 1e-12, port,
                           c_mass=cm, with_src=ws, seed=i, prepared=pr)
        for i, (cm, ws) in enumerate(K3_CASES) for pr in (True, False))
    log("CG-2 parity " + json.dumps(out))
    return out


def cg2_plate_phase(dev, port, scratch_dir=None) -> dict:
    """Phase 9b: the JAX package's largest CG-2 row (BENCH.md:398), the
    64x64x16 plate with CG-2 T and CG-1 sigma, 549,153 T dofs, f32, 1
    warm-up step and CG2_TIMED_STEPS timed ones; then the layers, K2 on
    every smoothed coarse level's real tables, and K3 at nloc 27 at the
    plate's cell count (65,536 cells, f64, its prepared call) against its
    bound. With `scratch_dir`, the warm-up step holds phase 13g(b)'s step
    1 (hold_phase13g)."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.ops.grid2 import Q2MG

    tag = "CG-2 plate"
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    prob = ThermoViscoProblem(mesh=box_mesh_3d(*N_CG2, lx=1.0, ly=1.0,
                                               lz=0.01),
                              config=cg2_config(tc, CG2_TIMED_STEPS, True),
                              device=dev)
    prob.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(dev)
    setup_held = torch.cuda.memory_allocated(dev)
    mg = prob._mg
    n = prob.fs_T.n_scalar_dofs
    if (not isinstance(mg, Q2MG) or mg.smoother != "line"
            or prob._ell is not prob._grid2 or n != 549_153):
        fail(f"{tag}: {n} dofs, not the lattice path with the line-smoothed "
             f"Q2MG")
    gmg = mg.gmg
    levels = dict(coarse_mg=[lv.fine_dims for lv in gmg.levels],
                  coarse_mg_smoothed=sum(lv.coarse_dims is not None
                                         for lv in gmg.levels),
                  coarse_mg_dense_nodes=(
                      int(gmg.coarse_inv.shape[0])
                      if gmg.coarse_inv is not None else None),
                  line_axis=mg.line_axis)
    # the gather HeatOperator the lattice operator was built from: its
    # dofmap, cell scatter and boundary tables stay on the card, and the
    # lattice step never reads them
    gather_bytes = device_bytes(prob.heat)
    log(f"{tag}: {n} dofs, setup {setup_s:.1f} s "
        + json.dumps(prob.setup_seconds) + " " + json.dumps(levels)
        + f", held {setup_held} bytes, of them the gather heat operator "
        f"{gather_bytes}")

    st, ok, ni0, ki0 = prob.multi_step(prob.state, 1)      # warm-up
    torch.cuda.synchronize()
    if not ok:
        fail(f"{tag}: warm-up step did not converge")
    held_13g = (hold_phase13g(scratch_dir, st.T.cpu().numpy(), ni0, ki0)
                if scratch_dir is not None else None)
    del st
    state0 = prob.engine.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(port)
    t0 = time.perf_counter()
    st, ok, ni, ki = prob.multi_step(state0, CG2_TIMED_STEPS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated(dev)
    if not ok:
        fail(f"{tag}: timed window did not converge")
    for f in ("T", "Tf", "sigma"):
        if not bool(torch.isfinite(getattr(st, f)).all()):
            fail(f"{tag}: non-finite {f}")
    T_np = st.T.cpu().numpy()
    if not (prob.params.T_ambient - 1 < T_np.min() <= T_np.max()
            < prob.params.T_0 + 1):
        fail(f"{tag}: T out of [T_ambient, T_0]: {T_np.min()} .. "
             f"{T_np.max()}")
    # K1 once a step; one Q2MG apply before each CG solve (one per Newton
    # iteration) and one per CG iteration, each with one coarse V-cycle;
    # the fine lattice is sum-factorised plain PyTorch (no K2), and
    # GridHeatOperator2 carries the residual (no K3)
    per_apply = k2_launches_per_vcycle(gmg)
    expect = dict(material_tspace=CG2_TIMED_STEPS,
                  stencil_matvec=per_apply * (ni + ki), dg_cell_residual=0)
    if launches != expect or launches["stencil_matvec"] == 0:
        fail(f"{tag}: launches {launches}, expected {expect} ({ni} Newton "
             f"+ {ki} CG)")
    out = dict(dofs=n, setup_s=setup_s, setup_parts_s=prob.setup_seconds,
               levels=levels, ms_per_step=elapsed / CG2_TIMED_STEPS * 1e3,
               newton_per_step=ni / CG2_TIMED_STEPS,
               cg_per_step=ki / CG2_TIMED_STEPS,
               warmup_newton=ni0, warmup_cg=ki0, held_13g=held_13g,
               launches=launches,
               k2_launches_per_q2mg_apply=per_apply, q2mg_applies=ni + ki,
               max_memory_allocated_bytes=peak,
               setup_max_memory_allocated_bytes=setup_peak,
               held_after_setup_bytes=setup_held,
               gather_heat_operator_bytes=gather_bytes,
               T_min=float(T_np.min()), T_max=float(T_np.max()))

    # K2 on the real value tables of every smoothed coarse level, f32
    # (outside the counted window)
    rng = np.random.default_rng(6)
    T_levels = mg.linearization_states(st.T)
    k2_levels = []
    for lvl, Tl in zip(gmg.levels, T_levels[1:]):
        if lvl.coarse_dims is None:
            continue
        op = gmg._grid_for(lvl)
        vals2 = op.stencil_values(Tl, prob.dt).reshape(27, op.grid[0], -1)
        x = torch.tensor(rng.standard_normal(op.n), dtype=prob.dtype,
                         device=dev)
        k2_levels.append(dict(grid=op.grid, max_abs_err=check_stencil(
            vals2, x, op.grid, 1e-5, port)))
    out["k2_levels"] = k2_levels

    # the layers of one CG iteration and of a build, at the final state
    fine = prob._grid2
    dt = prob.dt
    v = torch.tensor(rng.standard_normal(n), dtype=prob.dtype, device=dev)
    vg = v.reshape(fine.grid)
    mv = fine.make_matvec(st.T, dt)
    pc = mg.preconditioner(T_levels, dt)
    zsolve = mg._line_solver(T_levels[0], dt)
    coarse = gmg.preconditioner(T_levels[1:], dt)
    vc = mg._restrict(vg).reshape(-1)
    layers = dict(
        q2mg_apply=time_ms(lambda: pc(v), reps=10),
        q2mg_build=time_ms(lambda: mg.preconditioner(T_levels, dt),
                           reps=3, warm=1),
        line_factorisation=time_ms(
            lambda: mg._ldl(*mg._line_bands(T_levels[0], dt)), reps=5),
        line_solve=time_ms(lambda: zsolve(vg), reps=10),
        power_rho=time_ms(lambda: mg._power_rho(
            fine.make_matvec_g(T_levels[0], dt), zsolve, fine.grid,
            fine.dtype, fine.device), reps=3, warm=1),
        coarse_mg_apply=time_ms(lambda: coarse(vc), reps=10),
        coarse_mg_build=time_ms(lambda: gmg.preconditioner(T_levels[1:],
                                                           dt), reps=5),
        fine_matvec=time_ms(lambda: mv(v), reps=20),
        fine_matvec_build=time_ms(lambda: fine.make_matvec(st.T, dt),
                                  reps=5),
        residual=time_ms(lambda: fine.residual(st.T, st.T_prev, dt),
                         reps=20),
        jacobian_diag=time_ms(lambda: fine.jacobian_diag(st.T, dt), reps=20),
        material_step=time_ms(lambda: prob.engine.material_step(
            st, st.T, dt), reps=5))
    # the device's own time of a Q2MG apply and a fine matvec: the same
    # calls captured into a CUDA graph and replayed; the rest of a call's
    # time is the host's
    for key, fn in (("q2mg_apply", lambda: pc(v)),
                    ("fine_matvec", lambda: mv(v))):
        layers[f"{key}_device"] = device_ms(fn, reps=2, replays=5)
    out["layers_ms"] = layers
    out["q2mg_apply_host_share"] = (
        1.0 - layers["q2mg_apply_device"] / layers["q2mg_apply"])
    out["cg_iteration_ms_estimate"] = layers["q2mg_apply"] \
        + layers["fine_matvec"]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    pc2 = mg.preconditioner(T_levels, dt)
    pc2(v)
    torch.cuda.synchronize()
    out["q2mg_build_apply_peak_added_bytes"] = \
        torch.cuda.max_memory_allocated(dev) - base
    del pc2

    # K3 at nloc 27 at the plate's cell count, f64, on the heat operator's
    # tables in the call the operator makes; no single PyTorch call
    # computes the cell term
    heat = prob.heat
    f64 = torch.float64
    t64 = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=f64,
                                 device=dev)
    qw, gphi, phi = t64(heat.np_qw), t64(heat.np_gphi), t64(heat.np_phi)
    c, nloc = tuple(heat.dofmap.shape)
    q, g = phi.shape[0], gphi.shape[-1]
    Tc = st.T.to(f64)[heat.dofmap]
    Tpc = Tc + 1.0
    kw = dict(dt=dt, c_mass=heat.c_mass, c_diff=heat.c_diff, f_src=0.0)
    call = port["PreparedDGCellResidual"](qw, gphi, phi)
    k, ref = port["dg_cell_residual"], port["dg_cell_residual_reference"]
    got, got_direct = call(Tc, Tpc, **kw), k(Tc, Tpc, qw, gphi, phi, **kw)
    want = ref(Tc, Tpc, qw, gphi, phi, **kw)
    mag = ref(Tc.abs(), -Tpc.abs(), qw, gphi.abs(), phi.abs(), **kw)
    torch.cuda.synchronize()
    if (not torch.equal(got, got_direct)
            or bool(((got - want).abs() > 1e-12 * mag).any())):
        fail(f"{tag}: K3 at nloc 27 disagrees with its plain version")
    out["k3_nloc27"] = dict(
        cells=c, nloc=nloc, q=q, g=g, path=call.path,
        max_abs_err=float((got - want).abs().max()),
        ms=time_ms(lambda: call(Tc, Tpc, **kw)),
        device_ms=device_ms(lambda: call(Tc, Tpc, **kw)),
        device_cold_ms=device_cold_ms(lambda: call(Tc, Tpc, **kw)),
        direct_call_device_ms=device_ms(
            lambda: k(Tc, Tpc, qw, gphi, phi, **kw)),
        plain_ms=time_ms(lambda: ref(Tc, Tpc, qw, gphi, phi, **kw), reps=5),
        **k3_bounds(c, nloc, q, g, True, f64))
    log(tag + " " + json.dumps(out))
    return out


def degree2_config(tc, steps, fe, dtype="float64", mechanics="none",
                   **solver):
    return tc.RunConfig(
        fe=tc.FEConfig(**fe), time=tc.TimeConfig(0.0, steps * 0.1, 0.1),
        solver=tc.SolverConfig(**solver),
        output=tc.OutputConfig(write_every=0, formats=()), dtype=dtype,
        mechanics=mechanics)


def degree2_cases():
    """Phase 10a's configurations: (label, mesh builder, FE choice,
    config keywords, CG band). The meshes and settings are those the port
    is held to the JAX package with (tests/test_torch_degree2_gather.py,
    tests/test_torch_degree2_twins.py); the defaults resolve "auto" to
    SA-AMG off the lattice path and to Q2MG on it. CG is held equal or
    within the band: 1% where the solves stop on rounding; 2% for the
    SA-AMG solve of the CG-2 plate, whose count moves by 4 in one step
    between starts one ulp apart on the CPU (ROADMAP.md Queue 3); 5% for
    mixed precision, whose f32 inner solves stop near the f32 floor."""
    from fem_glass_tempering_tpu_torch.fem.mesh import (
        box_mesh_2d,
        box_mesh_3d,
        reference_glass_mesh_1d,
    )
    cg2 = dict(T_family="CG", T_degree=2)
    dg2 = dict(T_family="DG", T_degree=2)
    plate = lambda: box_mesh_3d(3, 3, 2, 1.0, 1.0, 0.01)  # noqa: E731
    box = lambda: box_mesh_3d(3, 3, 2)                      # noqa: E731
    return (
        ("DG-2 slab", reference_glass_mesh_1d, dg2, {}, 0.01),
        ("2D CG-2 plate, sigma CG-2", lambda: box_mesh_2d(6, 3, 2.0, 1.0),
         dict(cg2, sigma_family="CG", sigma_degree=2), {}, 0.01),
        ("CG-2 tet plate", lambda: box_mesh_3d(2, 2, 2, cell_type="tet"),
         cg2, {}, 0.01),
        ("DG-2 box", box, dg2, {}, 0.01),
        ("DG-2 box, stencil", box, dg2, dict(linear_operator="stencil"),
         0.01),
        ("CG-2 plate, grid_native off, amg", plate, cg2,
         dict(grid_native="off", preconditioner="amg"), 0.02),
        ("CG-2 mechanics", lambda: box_mesh_3d(3, 3, 2, 1.0, 1.0, 0.1), cg2,
         dict(linear_operator="stencil", mechanics="equilibrium"), 0.01),
        ("CG-2 5x5x3 plate, mixed",
         lambda: box_mesh_3d(5, 5, 3, 1.0, 1.0, 0.01), cg2,
         dict(linear_operator="stencil", preconditioner="mg",
              mg_smoother="chebyshev", cg_max_it=500, cg_dtype="float32"),
         0.05))


def degree2_parity_case(dev, port, label, make_mesh, fe, kw, band) -> dict:
    """One phase 10a case, DEGREE2_PARITY_STEPS steps on the CPU and on the
    card: Newton equal in every step, the CG total within `band`, T and Tf
    within 1e-9 relative, sigma within 1e-6 of its max; K3 launched in the
    card's run exactly where the gather residual runs."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.ops.stencil import DGStencilMatrix

    steps = DEGREE2_PARITY_STEPS
    res = {}
    for where in ("cpu", dev):
        p = ThermoViscoProblem(mesh=make_mesh(), config=degree2_config(
            tc, steps, fe, **kw), device=where)
        p.setup()
        gather = p._grid2 is None and not isinstance(p._ell,
                                                     DGStencilMatrix)
        torch.cuda.synchronize()
        k3_before = port["dg_cell_residual"].launches
        t0 = time.perf_counter()
        st, counts, mech = p.state, [], []
        for _ in range(steps):
            st, ok, ni, ki = p.step(st)
            if not ok:
                fail(f"{label}: no convergence on {where}")
            counts.append((ni, ki))
            mech += p.last_mech_iters
        torch.cuda.synchronize()
        res[str(where)] = (st, counts, mech, time.perf_counter() - t0,
                           port["dg_cell_residual"].launches - k3_before,
                           gather, p)
    (sc, cc, mc, tcpu, _, _, pc), (sg, cgc, mg, tgpu, k3, gather, pg) = (
        res["cpu"], res[str(dev)])
    kc, kg = sum(c[1] for c in cc), sum(c[1] for c in cgc)
    out = dict(dofs=pg.fs_T.n_scalar_dofs, cells=int(pg.heat.dofmap.shape[0]),
               nloc=int(pg.heat.dofmap.shape[1]),
               preconditioner=pg.config.solver.preconditioner,
               operator=type(pg._ell).__name__ if pg._ell is not None
               else "matrix_free", gather_residual=gather,
               counts_cpu=cc, counts_gpu=cgc, elast_cg_cpu=mc,
               elast_cg_gpu=mg, cg_band=band, k3_launches_gpu=k3,
               k3_launches_per_step_gpu=k3 / steps, seconds_cpu=tcpu,
               seconds_gpu=tgpu)
    for f in ("T", "Tf", "sigma"):
        a, b = getattr(sc, f).numpy(), getattr(sg, f).cpu().numpy()
        out[f"{f}_max_rel"] = float(np.abs(a - b).max() / np.abs(a).max())
    bad = [f for f, lim in (("T", 1e-9), ("Tf", 1e-9), ("sigma", 1e-6))
           if not out[f"{f}_max_rel"] <= lim]
    if (bad or [c[0] for c in cc] != [c[0] for c in cgc]
            or abs(kc - kg) > band * kc):
        fail(f"{label}: GPU against CPU {json.dumps(out)}")
    if (k3 > 0) != gather:
        fail(f"{label}: {k3} K3 launches, the gather residual "
             f"{'runs' if gather else 'does not run'}")
    log(f"degree-2 parity {label} " + json.dumps(out))
    return out


def degree2_parity_phase(dev, port) -> dict:
    """Phase 10a: every degree-2 configuration the port runs, GPU against
    CPU (f64 Newton, rtol 1e-12)."""
    return {label: degree2_parity_case(dev, port, label, *rest)
            for label, *rest in degree2_cases()}


def gather_plate_config(tc, steps):
    """BENCH.md:351-354's CG-2 gather settings (matrix-free CG, frozen
    SA-AMG, f32, rtol 1e-5) with the lattice operator turned off, at the
    size BENCH.md:355 could not run; jac_every 5."""
    return degree2_config(
        tc, steps, dict(T_family="CG", T_degree=2, sigma_family="CG",
                        sigma_degree=1), dtype="float32",
        newton_rtol=1e-5, newton_atol=1e-6, cg_rtol=1e-5, cg_max_it=4000,
        linear_operator="matrix_free", preconditioner="amg",
        grid_native="off", jac_every=5)


def gather_plate_phase(dev, port) -> dict:
    """Phase 10b: the N_GATHER CG-2 plate on the gather path: the gather
    residual (K3 at nloc 27 with uniform f32 tables) under torch.func.jvp,
    SA-AMG over the assembled ELL Jacobian; 1 warm-up step and
    GATHER_TIMED_STEPS timed ones; then the layers and K3 on the
    operator's own tables against its bound."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    tag = "CG-2 gather plate"
    steps = GATHER_TIMED_STEPS
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    prob = ThermoViscoProblem(mesh=box_mesh_3d(*N_GATHER, lx=1.0, ly=1.0,
                                               lz=0.01),
                              config=gather_plate_config(tc, steps),
                              device=dev)
    prob.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated(dev)
    n = prob.fs_T.n_scalar_dofs
    amg = prob._amg
    if (prob._grid2 is not None or amg is None or prob._ell is not None
            or prob.heat.dofmap.shape[1] != 27
            or n != int(np.prod([2 * d + 1 for d in N_GATHER]))):
        fail(f"{tag}: not the gather path with SA-AMG")
    levels = [tuple(lv["vals"].shape) for lv in amg.levels]
    held = torch.cuda.memory_allocated(dev)
    log(f"{tag}: {n} dofs, setup {setup_s:.1f} s "
        + json.dumps(prob.setup_seconds) + f" amg levels {levels}, held "
        f"{held} bytes")

    st, ok, ni0, ki0 = prob.multi_step(prob.state, 1)      # warm-up
    torch.cuda.synchronize()
    if not ok:
        fail(f"{tag}: warm-up step did not converge")
    del st
    state0 = prob.engine.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(port)
    t0 = time.perf_counter()
    st, ok, ni, ki = prob.multi_step(state0, steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated(dev)
    if not ok:
        fail(f"{tag}: timed window did not converge")
    for f in ("T", "Tf", "sigma"):
        if not bool(torch.isfinite(getattr(st, f)).all()):
            fail(f"{tag}: non-finite {f}")
    T_np = st.T.cpu().numpy()
    if not (prob.params.T_ambient - 1 < T_np.min() <= T_np.max()
            < prob.params.T_0 + 1):
        fail(f"{tag}: T out of [T_ambient, T_0]: {T_np.min()} .. "
             f"{T_np.max()}")
    # K1 once a step (the reference xi), no stencil kernel off the
    # lattice, K3 in every residual and twice in every Jacobian action
    if (launches["material_tspace"] != steps
            or launches["stencil_matvec"] != 0
            or launches["dg_cell_residual"] == 0):
        fail(f"{tag}: launches {launches}")
    out = dict(dofs=n, cells=int(prob.heat.dofmap.shape[0]),
               setup_s=setup_s, setup_parts_s=prob.setup_seconds,
               amg_levels=levels, ms_per_step=elapsed / steps * 1e3,
               newton_per_step=ni / steps, cg_per_step=ki / steps,
               warmup_newton=ni0, warmup_cg=ki0, launches=launches,
               k3_launches_per_step=launches["dg_cell_residual"] / steps,
               max_memory_allocated_bytes=peak,
               setup_max_memory_allocated_bytes=setup_peak,
               held_after_setup_bytes=held,
               amg_bytes=device_bytes(amg),
               gather_heat_operator_bytes=device_bytes(prob.heat),
               T_min=float(T_np.min()), T_max=float(T_np.max()))

    # the layers of one CG iteration at the final state
    heat, dt = prob.heat, prob.dt
    rng = np.random.default_rng(7)
    v = torch.tensor(rng.standard_normal(n), dtype=prob.dtype, device=dev)
    pc = amg.preconditioner()
    jvp = lambda: torch.func.jvp(                           # noqa: E731
        lambda u: heat.residual(u, st.T_prev, dt), (st.T,), (v,))[1]
    out["layers_ms"] = dict(
        residual=time_ms(lambda: heat.residual(st.T, st.T_prev, dt),
                         reps=10),
        jvp_matvec=time_ms(jvp, reps=10),
        amg_vcycle=time_ms(lambda: pc(v), reps=10))
    # K3 on the operator's own tables, in the call the residual makes
    Tc = st.T[heat.dofmap]
    Tpc = st.T_prev[heat.dofmap]
    out["k3_in_path"] = time_k3(
        port, heat._cell_term, Tc, Tpc,
        dict(dt=dt, c_mass=heat.c_mass, c_diff=heat.c_diff,
             f_src=prob.params.f), heat.qw, heat.gphi, heat.phi, True, 1e-5)
    log(tag + " " + json.dumps(out))
    return out


def mixed_plate_config(tc, steps, cg_dtype):
    """BENCH.md:400's row (examples/highorder_tpu.py --rtol12): f64
    Newton at rtol 1e-12 over an f32 inner CG (cg_dtype "float32"), the
    lattice operator, "auto" (Q2MG, Chebyshev-smoothed coarse V-cycle)."""
    return degree2_config(
        tc, steps, dict(T_family="CG", T_degree=2, sigma_family="CG",
                        sigma_degree=1), dtype="float64",
        newton_rtol=1e-12, newton_atol=1e-10, cg_rtol=1e-12,
        cg_max_it=2000, linear_operator="stencil", preconditioner="auto",
        mg_smoother="chebyshev", cg_dtype=cg_dtype)


def mixed_plate_phase(dev, port) -> dict:
    """Phase 10c: the 64x64x16 CG-2 plate in f64 with the f32 twins of the
    lattice operator and of Q2MG, 1 warm-up step and MIXED_TIMED_STEPS
    timed ones; its first step's T against an f64 run's within 5e-3 K."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.ops.grid2 import Q2MG

    tag = "CG-2 mixed plate"
    steps = MIXED_TIMED_STEPS
    mesh = lambda: box_mesh_3d(*N_CG2, lx=1.0, ly=1.0, lz=0.01)  # noqa
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    prob = ThermoViscoProblem(mesh=mesh(), config=mixed_plate_config(
        tc, steps, "float32"), device=dev)
    prob.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mg = prob._mg32
    if (not isinstance(mg, Q2MG) or prob._mg is not None
            or prob._ell32 is not prob._grid2_32
            or prob._grid2_32.dtype != torch.float32):
        fail(f"{tag}: 'auto' is not the f32 Q2MG twin on the f32 lattice "
             f"operator")
    st1, ok, ni0, ki0 = prob.multi_step(prob.state, 1)     # warm-up
    torch.cuda.synchronize()
    if not ok:
        fail(f"{tag}: warm-up step did not converge")
    T1 = st1.T.cpu()
    del st1
    state0 = prob.engine.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(port)
    t0 = time.perf_counter()
    st, ok, ni, ki = prob.multi_step(state0, steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(port)
    peak = torch.cuda.max_memory_allocated(dev)
    if not ok or not bool(torch.isfinite(st.T).all()):
        fail(f"{tag}: timed window did not converge")
    per_apply = k2_launches_per_vcycle(mg.gmg)
    expect = dict(material_tspace=steps,
                  stencil_matvec=per_apply * (ni + ki), dg_cell_residual=0)
    if launches != expect or launches["stencil_matvec"] == 0:
        fail(f"{tag}: launches {launches}, expected {expect} ({ni} Newton "
             f"+ {ki} CG)")
    out = dict(dofs=prob.fs_T.n_scalar_dofs, setup_s=setup_s,
               setup_parts_s=prob.setup_seconds,
               ms_per_step=elapsed / steps * 1e3, newton_per_step=ni / steps,
               cg_per_step=ki / steps, warmup_newton=ni0, warmup_cg=ki0,
               launches=launches, k2_launches_per_q2mg_apply=per_apply,
               q2mg_applies=ni + ki, max_memory_allocated_bytes=peak)
    del prob, st, state0
    drop_garbage(f"{tag}: the f64 run")
    ref = ThermoViscoProblem(mesh=mesh(), config=mixed_plate_config(
        tc, 1, "same"), device=dev)
    ref.setup()
    st64, ok, n64, k64 = ref.multi_step(ref.state, 1)
    if not ok:
        fail(f"{tag}: the f64 step did not converge")
    out["f64_step1_counts"] = (n64, k64)
    out["mixed_step1_counts"] = (ni0, ki0)
    out["mixed_vs_f64_T_max_abs_K"] = float((T1 - st64.T.cpu()).abs().max())
    if not out["mixed_vs_f64_T_max_abs_K"] <= 5e-3:
        fail(f"{tag}: T differs from the f64 run by "
             f"{out['mixed_vs_f64_T_max_abs_K']:.3e} K")
    log(tag + " " + json.dumps(out))
    return out


# ----------------------------------------------------------------------
# Phase 11: the command-line entry point
# ----------------------------------------------------------------------
CLI_DEFAULT_STEPS = 6
CLI_DEFAULT_ARGV = ["--t-end", str(CLI_DEFAULT_STEPS * 0.1),
                    "--write-every", str(CLI_DEFAULT_STEPS // 2),
                    "--formats", "npz,vtu"]     # 2 snapshots
N_MSH = (64, 64, 16)             # 65,536 hex cells through --write-mesh


def run_cli(argv) -> str:
    """`python -m fem_glass_tempering_tpu_torch.main ARGV` in this process
    -> what it printed."""
    from fem_glass_tempering_tpu_torch.main import main as cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(argv)
    if rc != 0:
        fail(f"the command line {argv} exited {rc}")
    return buf.getvalue()


def cli_stats(argv) -> tuple[dict, float]:
    """The command line's last line (its JSON stats) and its wall time."""
    t0 = time.perf_counter()
    text = run_cli(argv)
    return json.loads(text.strip().splitlines()[-1]), time.perf_counter() - t0


def vtu_field(path: str, name: str) -> np.ndarray:
    """Decode one point-data array of a binary .vtu file (f64, flat),
    found by its name: a full XML parse of the 281 MB plate file costs
    seconds."""
    with open(path, "rb") as fh:
        data = fh.read()
    at = data.find(f'Name="{name}"'.encode())
    if at < 0:
        fail(f"{path} has no field {name}")
    start = data.index(b">", at) + 1
    raw = base64.b64decode(data[start:data.index(b"</DataArray>", start)])
    n = struct.unpack("<I", raw[:4])[0]
    return np.frombuffer(raw[4:4 + n], dtype=np.float64)


# a device kernel in torch.profiler's Chrome trace (written by Kineto,
# "cat" before "name"); a regular expression over the bytes, where
# json.load of the 459 MB trace of 11b takes seconds
_KERNEL_EVENT = re.compile(rb'"cat":\s*"kernel",\s*"name":\s*"([^"]*)"')


def trace_kernel_events(path: str) -> dict:
    """Device kernel events of a torch.profiler Chrome trace, by the
    port's kernel they belong to."""
    with open(path, "rb") as fh:
        names = _KERNEL_EVENT.findall(fh.read())
    pick = dict(material_tspace=(b"material_tspace_kernel",),
                stencil_matvec=(b"stencil_matvec_kernel",),
                dg_cell_residual=(b"dg_cell_row_kernel",
                                  b"dg_cell_split_kernel"))
    out = {k: sum(any(p in n for p in pats) for n in names)
           for k, pats in pick.items()}
    out["all_kernels"] = len(names)
    return out


def temper(fs_sigma, sigma, axis, fs_T=None, T=None) -> tuple:
    from fem_glass_tempering_tpu_torch.models.analysis import (
        temper_metrics,
        through_thickness_profile,
    )

    prof = through_thickness_profile(fs_sigma, sigma, axis=axis, T_fs=fs_T,
                                     T=T)
    return prof, temper_metrics(prof)


def cli_plate_run(dev, port, work, warmup, k2_per_apply) -> dict:
    """11a: the full-size CG-1 plate through the command line, 5 steps and
    one npz + VTU snapshot, held to phase 4's warm-up chunk."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d

    tag = "CLI plate"
    cfg_path = os.path.join(work, "plate.json")
    with open(cfg_path, "w") as fh:
        fh.write(plate_config(tc, WARMUP_STEPS, True).to_json())
    out_dir = os.path.join(work, "plate")
    reset_counts(port)
    stats, wall = cli_stats([
        "--device", str(dev), "--problem-dim", "3",
        "--nx", str(N_FULL[0]), "--ny", str(N_FULL[1]), "--nz", str(N_FULL[2]),
        "--config", cfg_path, "--write-every", str(WARMUP_STEPS),
        "--formats", "npz,vtu", "--output-dir", out_dir])
    launches = read_counts(port)
    t0 = time.perf_counter()
    ni, ki = stats["newton_iters"], stats["krylov_iters"]
    if (stats["n_steps"], ni, ki) != (WARMUP_STEPS, warmup["newton"],
                                      warmup["cg"]):
        fail(f"{tag}: {stats} against phase 4's warm-up chunk "
             f"{warmup['newton']} Newton / {warmup['cg']} CG")
    if (launches["material_tspace"] != WARMUP_STEPS
            or launches["stencil_matvec"] != k2_per_apply * (ni + ki)
            or launches["dg_cell_residual"] != 0):
        fail(f"{tag}: launches {launches} for {ni} Newton + {ki} CG "
             f"iterations ({k2_per_apply} K2 per apply)")
    files = {f: os.path.getsize(os.path.join(out_dir, f))
             for f in sorted(os.listdir(out_dir))}
    T_warm = warmup["T"]
    T_vtu = vtu_field(os.path.join(out_dir, "visco_00000.vtu"), "Temperature")
    with np.load(os.path.join(out_dir, "series.npz")) as z:
        T_npz, sigma = z["T"][-1], z["sigma"][-1]
    if not np.array_equal(T_vtu, T_warm.astype(np.float64)):
        fail(f"{tag}: the VTU's Temperature differs from the warm-up T by "
             f"{np.abs(T_vtu - T_warm).max():.3e}")
    if T_npz.dtype != T_warm.dtype or not np.array_equal(T_npz, T_warm):
        fail(f"{tag}: the npz's T differs from the warm-up T")
    if not np.isfinite(sigma).all():
        fail(f"{tag}: non-finite sigma in the npz")
    mesh = box_mesh_3d(*N_FULL, 1.0, 1.0, 0.01)
    fs_sigma = FunctionSpace(mesh, "CG", 1, value_shape=(3, 3))
    _, metrics = temper(fs_sigma, sigma, 2)
    out = dict(dofs=int(T_warm.size), steps=stats["n_steps"], newton=ni,
               cg=ki, elapsed_seconds=stats["elapsed_seconds"],
               io_seconds=stats["io_seconds"], wall_s=wall,
               launches=launches, file_bytes=files,
               T_bits_equal_phase4=True, temper_metrics=metrics,
               check_s=time.perf_counter() - t0)
    log(f"{tag} " + json.dumps(out))
    return out


def cli_default_runs(dev, port, work) -> dict:
    """11b: the reference's default run, CLI_DEFAULT_STEPS steps, through
    the command line on the card (traced with --profile-dir) and on the
    CPU."""
    from fem_glass_tempering_tpu_torch.config import RunConfig
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.fem.mesh import reference_glass_mesh_1d
    from fem_glass_tempering_tpu_torch.utils.profiling import TRACE_FILE

    tag = "CLI default run"
    trace_dir = os.path.join(work, "trace")
    runs = {}
    for where, device in (("gpu", str(dev)), ("cpu", "cpu")):
        extra = ["--profile-dir", trace_dir] if where == "gpu" else []
        reset_counts(port)
        stats, wall = cli_stats(CLI_DEFAULT_ARGV + [
            "--device", device, "--output-dir", os.path.join(work, where)]
            + extra)
        runs[where] = dict(stats=stats, wall_s=wall,
                           launches=read_counts(port))
    g, c = runs["gpu"]["stats"], runs["cpu"]["stats"]
    ni, ki = g["newton_iters"], g["krylov_iters"]
    if (g["n_steps"], ni, ki) != (c["n_steps"], c["newton_iters"],
                                  c["krylov_iters"]) or g["n_steps"] != (
                                  CLI_DEFAULT_STEPS):
        fail(f"{tag}: the card's counts {g} against the CPU's {c}")
    launches = runs["gpu"]["launches"]
    if (launches["material_tspace"] != CLI_DEFAULT_STEPS
            or launches["dg_cell_residual"] != ni + 2 * (ni + ki)):
        fail(f"{tag}: launches {launches} for {CLI_DEFAULT_STEPS} steps, "
             f"{ni} Newton and {ki} CG")
    if any(runs["cpu"]["launches"].values()):
        fail(f"{tag}: the CPU run launched {runs['cpu']['launches']}")
    fields = {}
    for where in runs:
        with np.load(os.path.join(work, where, "series.npz")) as z:
            fields[where] = {f: z[f][-1] for f in ("T", "Tf", "sigma")}
    out = dict(steps=CLI_DEFAULT_STEPS, newton=ni, cg=ki,
               wall_s={w: r["wall_s"] for w, r in runs.items()},
               elapsed_seconds={w: r["stats"]["elapsed_seconds"]
                                for w, r in runs.items()},
               io_seconds={w: r["stats"]["io_seconds"]
                           for w, r in runs.items()},
               launches=launches)
    for f in ("T", "Tf", "sigma"):
        a, b = fields["cpu"][f], fields["gpu"][f]
        out[f"{f}_max_rel"] = float(np.abs(a - b).max() / np.abs(a).max())
        if not out[f"{f}_max_rel"] <= (1e-6 if f == "sigma" else 1e-9):
            fail(f"{tag}: {f} GPU against CPU {out[f'{f}_max_rel']:.3e}")
    fe = RunConfig().fe
    mesh = reference_glass_mesh_1d()
    fs_T = FunctionSpace(mesh, fe.T_family, fe.T_degree)
    fs_sigma = FunctionSpace(mesh, fe.sigma_family, fe.sigma_degree,
                             value_shape=(1, 1))
    prof = {w: temper(fs_sigma, fields[w]["sigma"], 0, fs_T, fields[w]["T"])
            for w in runs}
    (pc, mc), (pg, mg) = prof["cpu"], prof["gpu"]
    scale = np.abs(pc.stress).max()
    out["profile_max_rel"] = max(
        float(np.abs(pc.stress - pg.stress).max() / scale),
        float(np.abs(pc.temperature - pg.temperature).max()
              / np.abs(pc.temperature).max()),
        max(abs(mc[k] - mg[k]) / (mc["thickness"] if k == "thickness"
                                  else scale) for k in mc))
    if not out["profile_max_rel"] <= 1e-9:
        fail(f"{tag}: temper profiles GPU against CPU "
             f"{out['profile_max_rel']:.3e}")
    out["temper_metrics"] = mg
    t0 = time.perf_counter()
    events = trace_kernel_events(os.path.join(trace_dir, TRACE_FILE))
    out["trace_scan_s"] = time.perf_counter() - t0
    out["trace_kernel_events"] = events
    out["trace_bytes"] = os.path.getsize(os.path.join(trace_dir, TRACE_FILE))
    for name in ("material_tspace", "dg_cell_residual"):
        if events[name] != launches[name]:
            fail(f"{tag}: the trace holds {events[name]} {name} kernel "
                 f"events, the launch counter {launches[name]}")
    log(f"{tag} " + json.dumps(out))
    return out


def cli_gmsh_runs(dev, work, default) -> dict:
    """11c: the default run from a gmsh file through --mesh, and the
    N_MSH plate written by --write-mesh (its seconds include building the
    mesh, ~0.1 s of them) and read back."""
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d, read_msh
    from fem_glass_tempering_tpu_torch.fem.mshio import create_mesh

    tag = "CLI gmsh"
    path = os.path.join(work, "mesh1d.msh")
    create_mesh(path)
    stats, wall = cli_stats(CLI_DEFAULT_ARGV + [
        "--device", str(dev), "--mesh", path,
        "--output-dir", os.path.join(work, "gmsh")])
    if (stats["n_steps"], stats["newton_iters"], stats["krylov_iters"]) != (
            CLI_DEFAULT_STEPS, default["newton"], default["cg"]):
        fail(f"{tag}: --mesh run {stats} against the default run's "
             f"{default['newton']} / {default['cg']}")
    with np.load(os.path.join(work, "gmsh", "series.npz")) as z, \
            np.load(os.path.join(work, "gpu", "series.npz")) as zd:
        T_diff = float(np.abs(z["T"][-1] - zd["T"][-1]).max())
    plate = os.path.join(work, "plate.msh")
    t0 = time.perf_counter()
    run_cli(["--device", str(dev), "--problem-dim", "3",
             "--nx", str(N_MSH[0]), "--ny", str(N_MSH[1]),
             "--nz", str(N_MSH[2]), "--write-mesh", plate])
    cli_write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    m = read_msh(plate)
    read_s = time.perf_counter() - t0
    ref = box_mesh_3d(*N_MSH, 1.0, 1.0, 0.01)
    if not (np.array_equal(m.nodes, ref.nodes)
            and np.array_equal(m.cells, ref.cells)):
        fail(f"{tag}: the {N_MSH} plate read back differs from the built one")
    out = dict(mesh_run=stats, mesh_run_wall_s=wall,
               T_max_abs_diff_to_default_run=T_diff, plate_cells=m.n_cells,
               msh_bytes=os.path.getsize(plate), cli_write_mesh_s=cli_write_s,
               read_msh_s=read_s)
    log(f"{tag} " + json.dumps(out))
    return out


def cli_phase(dev, port, warmup, k2_per_apply, scratch_dir) -> dict:
    """Phase 11: the command-line entry point, every call in this process
    with its output captured, into a directory deleted afterwards."""
    work = tempfile.mkdtemp(prefix="cli_", dir=scratch_dir)
    try:
        plate = cli_plate_run(dev, port, work, warmup, k2_per_apply)
        default = cli_default_runs(dev, port, work)
        gmsh = cli_gmsh_runs(dev, work, default)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("CLI: XDMF output is not run on the card (it needs h5py; h5py "
        f"importable here: {importlib.util.find_spec('h5py') is not None})")
    return dict(plate=plate, default=default, gmsh=gmsh)


# ----------------------------------------------------------------------
# Phase 12: bf16 V-cycle tables, the custom-PDE API, solve_scan and the
# native runtime
# ----------------------------------------------------------------------
BF16_TIMED_STEPS = 1
BF16_PARITY_STEPS = 2
SCAN_STEPS, SCAN_EVERY = 6, 3
# 65,536 quads, 66,049 CG-1 dofs on a square as wide as the reference
# slab is thick (50 length units)
FORMS_SQUARE, FORMS_SIDE = 256, 50.0
# 12e's mesh; if phase 12 runs over its budget, the 64x64x16 round trip
N_NATIVE = N_FULL                # 1,024,000 hex cells


def bf16_plate_config(tc, steps, table_dtype, **solver):
    """examples/profile_mixed_ablate.py:62-71 of the JAX package, its
    `bf16tbl` variant: f64 Newton at rtol 1e-12 over an f32 CG and the
    f32 GeometricMG twin (Chebyshev), the stencil operator, bf16 V-cycle
    tables; the material chain runs (the example stubs it)."""
    kw = dict(newton_rtol=1e-12, newton_atol=1e-10, cg_rtol=1e-12,
              cg_max_it=2000, linear_operator="stencil", preconditioner="mg",
              mg_smoother="chebyshev", cg_dtype="float32",
              mg_table_dtype=table_dtype)
    kw.update(solver)
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="CG", T_degree=1),
        time=tc.TimeConfig(0.0, steps * 0.1, 0.1),
        solver=tc.SolverConfig(**kw),
        output=tc.OutputConfig(write_every=0, formats=()), dtype="float64")


def k2_bf16_check(port, vals2, grid, dev) -> dict:
    """K2's bf16-table instantiation on real f32 value tables `vals2`
    (cast to bf16 in the pitched layout the V-cycle gives them), under an
    f32 and an f64 vector: equal to its plain twin bit for bit, timed
    against its byte bound and against the CSR yardstick on the same
    (bf16-rounded) values in the vector's dtype."""
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import pitched_tables

    k, ref = port["stencil_matvec"], port["stencil_matvec_reference"]
    vb = pitched_tables(vals2)
    n = vals2.shape[1] * vals2.shape[2]
    rng = np.random.default_rng(12)
    out = {}
    for dtype in (torch.float32, torch.float64):
        x = torch.tensor(rng.standard_normal(n), dtype=dtype, device=dev)
        y, y_ref = k(vb, x, grid), ref(vb, x, grid)
        torch.cuda.synchronize()
        if y.dtype != dtype or not torch.equal(y, y_ref):
            fail(f"stencil_matvec bf16 tables, {dtype} vector: max |diff| "
                 f"{float((y - y_ref).abs().max()):.3e}")
        size = torch.finfo(dtype).bits // 8
        b, by = bound_ms(27 * 2 * n + 2 * size * n, K2_OPS_PER_POINT * n,
                         dtype)
        e = dict(vector=str(dtype).split(".")[-1], n=n, max_abs_err=0.0,
                 ms=time_ms(lambda: k(vb, x, grid)),
                 device_ms=device_ms(lambda: k(vb, x, grid)),
                 device_cold_ms=device_cold_ms(lambda: k(vb, x, grid)),
                 plain_ms=time_ms(lambda: ref(vb, x, grid), reps=10),
                 bound_ms=b, bound_by=by, library_ms=None)
        # the CSR yardstick holds the same bf16-exact values in the
        # vector's dtype; it sums in another order
        e["share"] = b / e["device_ms"]
        e["library_ms"], y_lib = csr_library_ms(vb.to(dtype), x, grid)
        mag = ref(vb.abs(), x.abs(), grid)
        rtol = 1e-5 if dtype == torch.float32 else 1e-12
        if bool(((y - y_lib).abs() > rtol * mag).any()):
            fail(f"the CSR yardstick disagrees with K2 on bf16 tables, "
                 f"{dtype} vector")
        del y_lib, mag
        out[e["vector"]] = e
        log("K2 bf16 tables " + json.dumps(e))
    return out


def bf16_plate_run(prob, port, dev, steps) -> tuple[dict, object]:
    """1 warm-up step, then `steps` timed steps from a fresh state with
    the launch counters set to 0 just before them and read just after."""
    st, ok, ni0, ki0 = prob.multi_step(prob.state, 1)
    torch.cuda.synchronize()
    if not ok:
        fail("bf16 plate: warm-up step did not converge")
    del st
    state0 = prob.engine.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(port)
    t0 = time.perf_counter()
    st, ok, ni, ki = prob.multi_step(state0, steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches, by_table = read_counts(port), read_k2_by_table(port)
    if not ok or not bool(torch.isfinite(st.T).all()):
        fail("bf16 plate: timed window did not converge")
    return dict(ms_per_step=elapsed / steps * 1e3, newton=ni, cg=ki,
                newton_per_step=ni / steps, cg_per_step=ki / steps,
                warmup_newton=ni0, warmup_cg=ki0, launches=launches,
                k2_by_table=by_table,
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                    dev)), st


def bf16_plate_phase(dev, port) -> dict:
    """12a: the 1,062,761-dof CG-1 plate in mixed precision with bf16
    V-cycle tables, then on the same problem with the hierarchy's table
    dtype set to None (the "same" arm, f32 tables); K2 bf16 on every
    smoothed level's real tables, and timed on the fine level's."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.solver.multigrid import GeometricMG

    tag = "bf16 plate"
    steps = BF16_TIMED_STEPS
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    mesh = box_mesh_3d(*N_FULL, 1.0, 1.0, 0.01)
    prob = ThermoViscoProblem(mesh=mesh, config=bf16_plate_config(
        tc, steps, "bfloat16"), device=dev)
    prob.setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    mg = prob._mg32
    if (not isinstance(mg, GeometricMG) or prob._mg is not None
            or mg.table_dtype != torch.bfloat16 or mesh.facet_builder
            != "native"):
        fail(f"{tag}: not the f32 GeometricMG twin with bf16 tables on a "
             f"mesh whose facets the native runtime built "
             f"({mesh.facet_builder})")
    # K2 bf16 on every smoothed level's real tables, in the pitched layout
    # of the V-cycle's own cast; timed on the fine one
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import pitched_tables
    levels = []
    T_levels = mg.linearization_states(prob.state.T.to(torch.float32))
    for i, (lvl, T) in enumerate(zip(mg.levels, T_levels)):
        if lvl.coarse_dims is None:
            continue
        g = mg._grid_for(lvl)
        vals2 = g.stencil_values(T, prob.dt).reshape(27, g.grid[0], -1)
        if i == 0:
            timed = k2_bf16_check(port, vals2, g.grid, dev)
        else:
            x = torch.tensor(np.random.default_rng(i).standard_normal(g.n),
                             dtype=torch.float32, device=dev)
            vb = pitched_tables(vals2)
            if not torch.equal(port["stencil_matvec"](vb, x, g.grid),
                               port["stencil_matvec_reference"](vb, x,
                                                                g.grid)):
                fail(f"{tag}: K2 bf16 differs from its twin on level {i}")
        levels.append(g.grid)
        del vals2
    log(f"{tag}: K2 bf16 bit-equal on the smoothed levels {levels}")
    per_vcycle = k2_launches_per_vcycle(mg)
    # the two arms in turns, bf16 / same / same / bf16: ms per step is
    # compared within the pairs; T and the counts from the first pair
    windows = []
    for arm, tdt in (("bfloat16", torch.bfloat16), ("same", None),
                     ("same", None), ("bfloat16", torch.bfloat16)):
        mg.table_dtype = tdt        # read by the next operator build
        res, st = bf16_plate_run(prob, port, dev, steps)
        applies = res["newton"] + res["cg"]
        bt = res["k2_by_table"]
        # the V-cycle's grid levels stream the arm's tables; the system
        # matvec (f32 tables) runs once per apply, plus the f32 CG's
        # true-residual replacements (one every 50 iterations)
        vcycle = per_vcycle * applies
        if tdt is not None:
            streamed, system = bt["bfloat16"], bt["float32"]
        else:
            streamed, system = vcycle, bt["float32"] - vcycle
        if (res["launches"]["material_tspace"] != steps
                or res["launches"]["dg_cell_residual"] != 0
                or bt["float64"] != 0
                or (tdt is None and bt["bfloat16"] != 0)
                or streamed != vcycle
                or not applies <= system <= applies + res["cg"] // 50
                or res["launches"]["stencil_matvec"] != sum(bt.values())):
            fail(f"{tag} {arm}: launches {res['launches']} by table {bt} "
                 f"for {res['newton']} Newton + {res['cg']} CG "
                 f"({per_vcycle} per V-cycle)")
        res["k2_system_matvec_launches"] = system
        res["k2_vcycle_launches"] = streamed
        windows.append((arm, res, st.T.cpu()))
        del st
        log(f"{tag} {arm} " + json.dumps(res))
    (_, rb, Tb), (_, rs, Ts) = windows[0], windows[1]
    out = dict(dofs=prob.fs_T.n_scalar_dofs, setup_s=setup_s,
               setup_parts_s=prob.setup_seconds, mg_levels=[
                   lv.fine_dims for lv in mg.levels],
               k2_launches_per_vcycle=per_vcycle, bf16=rb, same=rs,
               ms_per_step_in_turns=[(a, r["ms_per_step"])
                                     for a, r, _ in windows],
               T_max_rel_bf16_vs_same=float((Tb - Ts).abs().max()
                                            / Ts.abs().max()),
               repeat_T_equal=bool(torch.equal(Tb, windows[3][2])
                                   and torch.equal(Ts, windows[2][2])),
               k2_bf16_timed=timed)
    if not out["T_max_rel_bf16_vs_same"] <= 1e-10:
        fail(f"{tag}: T of the bf16 arm differs from the same arm's by "
             f"max-rel {out['T_max_rel_bf16_vs_same']:.3e}")
    if not rb["cg"] <= 2 * rs["cg"]:
        fail(f"{tag}: CG {rb['cg']} with bf16 tables against {rs['cg']}")
    log(tag + " " + json.dumps({k: v for k, v in out.items()
                                if k not in ("bf16", "same")}))
    return out


def bf16_parity_phase(dev, port) -> dict:
    """12b: the 8x8x4 plate with 12a's settings and a two-level V-cycle
    (the 8x8x4 level smoothed with its bf16 tables, the dense solve
    below; "auto" would make the single level the dense solve, which
    streams no table), 2 steps, the GPU against the CPU: Newton equal,
    CG within 1%, T max-rel 1e-9."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    tag = "bf16 parity"
    steps = BF16_PARITY_STEPS
    res = {}
    for where in ("cpu", dev):
        p = ThermoViscoProblem(
            mesh=box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01),
            config=bf16_plate_config(tc, steps, "bfloat16",
                                     mg_coarse="dense", mg_max_levels=2),
            device=where)
        p.setup()
        if where == dev:
            torch.cuda.synchronize()
            reset_counts(port)
        st, ok, ni, ki = p.multi_step(p.state, steps)
        if not ok:
            fail(f"{tag}: did not converge on {where}")
        res[str(where)] = (st.T.cpu().numpy(), ni, ki)
        if where == dev:
            torch.cuda.synchronize()
            by_table = read_k2_by_table(port)
    (Tc, nc, kc), (Tg, ng, kg) = res["cpu"], res[str(dev)]
    out = dict(newton_cpu=nc, newton_gpu=ng, cg_cpu=kc, cg_gpu=kg,
               T_max_rel=float(np.abs(Tg - Tc).max() / np.abs(Tc).max()),
               k2_by_table_gpu=by_table)
    if (nc != ng or abs(kc - kg) > 0.01 * kc or not out["T_max_rel"] <= 1e-9
            or by_table["bfloat16"] == 0):
        fail(f"{tag}: {json.dumps(out)}")
    log(tag + " " + json.dumps(out))
    return out


def forms_phase(dev, port) -> dict:
    """12c: the custom-PDE API on the card against the CPU: the tempering
    heat step as a ScalarResidualForm on the FORMS_SQUARE CG-1 square of
    side FORMS_SIDE through newton_solve (unpreconditioned CG); the nonlinear reaction-diffusion MMS
    -u'' + u^3 = f; newton_direct on the 1D validation slab (DG-1)."""
    from fem_glass_tempering_tpu_torch.config import ModelParams
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.fem.mesh import (
        box_mesh_2d,
        interval_mesh,
        reference_glass_mesh_1d,
    )
    from fem_glass_tempering_tpu_torch.ops.forms import ScalarResidualForm
    from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
    from fem_glass_tempering_tpu_torch.solver.direct import newton_direct
    from fem_glass_tempering_tpu_torch.solver.newton import newton_solve

    p, dt = ModelParams(), 0.1
    out = {}
    # (1) the tempering heat residual as a form, one implicit step
    fs = FunctionSpace(box_mesh_2d(FORMS_SQUARE, FORMS_SQUARE, FORMS_SIDE,
                                   FORMS_SIDE), "CG", 1)
    x = fs.dof_coords / FORMS_SIDE
    T_prev_np = p.T_0 - 50.0 * np.sin(np.pi * x[:, 0]) * np.sin(
        np.pi * x[:, 1])
    heat = {}
    for where in ("cpu", dev):
        form = ScalarResidualForm(
            fs, cell_source=lambda u, gu, xq, Tp=None: u - Tp - dt * p.f,
            cell_flux=lambda u, gu, xq, Tp=None: dt * p.alpha * gu,
            boundary_flux=lambda u, xq, n, Tp=None: dt * p.boundary_scale * (
                p.sigma * p.epsilon * (u**4 - p.T_ambient**4)
                + p.htc * (u - p.T_ambient)),
            quad_degree=5, device=where)
        T_prev = torch.tensor(T_prev_np, device=form.device)
        Tp_q = T_prev[form.dofmap] @ form.phi.T
        t0 = time.perf_counter()
        res = newton_solve(lambda T: form.residual(T, Tp=Tp_q), T_prev,
                           rtol=1e-10, atol=1e-9, cg_rtol=1e-10,
                           cg_max_it=4000)
        if where == dev:
            torch.cuda.synchronize()
        if not res.converged:
            fail(f"forms heat step did not converge on {where}")
        heat[str(where)] = (res.x.cpu().numpy(), res.iters, res.krylov_iters,
                            time.perf_counter() - t0)
    (xc, nc, kc, tc_), (xg, ng, kg, tg) = heat["cpu"], heat[str(dev)]
    out["heat_step"] = dict(dofs=fs.n_scalar_dofs, newton_cpu=nc,
                            newton_gpu=ng, cg_cpu=kc, cg_gpu=kg,
                            seconds_cpu=tc_, seconds_gpu=tg,
                            T_max_rel=float(np.abs(xg - xc).max()
                                            / np.abs(xc).max()),
                            T_drop_max=float((T_prev_np - xc).max()))
    if nc != ng or not out["heat_step"]["T_max_rel"] <= 1e-9:
        fail(f"forms heat step: {json.dumps(out['heat_step'])}")
    # (2) -u'' + u^3 = f, u = sin(pi x), CG-2 on 64 cells, Dirichlet
    fs = FunctionSpace(interval_mesh(64), "CG", 2)
    xx = fs.dof_coords[:, 0]
    mms = {}
    for where in ("cpu", dev):
        form = ScalarResidualForm(
            fs, cell_source=lambda u, gu, xq: u**3 - (
                np.pi**2 * torch.sin(np.pi * xq[..., 0])
                + torch.sin(np.pi * xq[..., 0])**3),
            cell_flux=lambda u, gu, xq: gu,
            bc_dofs=fs.boundary_scalar_dofs(), bc_values=0.0,
            quad_degree=8, device=where)
        res = newton_solve(form.residual, torch.zeros(
            fs.n_scalar_dofs, dtype=torch.float64, device=form.device),
            rtol=1e-12, cg_rtol=1e-13, cg_max_it=2000)
        if not res.converged:
            fail(f"forms MMS did not converge on {where}")
        mms[str(where)] = (float(np.abs(res.x.cpu().numpy()
                                        - np.sin(np.pi * xx)).max()),
                           res.iters)
    out["mms"] = dict(err_cpu=mms["cpu"][0], err_gpu=mms[str(dev)][0],
                      newton_cpu=mms["cpu"][1], newton_gpu=mms[str(dev)][1])
    if (mms["cpu"][1] != mms[str(dev)][1] or not mms[str(dev)][0] < 2e-5
            or abs(mms["cpu"][0] - mms[str(dev)][0])
            > 1e-6 * mms["cpu"][0]):
        fail(f"forms MMS: {json.dumps(out['mms'])}")
    # (3) dense Newton on the validation slab (graded: per-cell tables),
    # and on a uniform slab of as many cells (uniform tables). K3's
    # batching rule: the dense Jacobian's jvp columns, vmapped, launch
    # once per column over per-cell tables and once for all columns over
    # uniform ones, besides the residual's launch and the jvp's primal
    for key, mesh in (("direct", reference_glass_mesh_1d()),
                      ("direct_uniform", interval_mesh(48))):
        fs = FunctionSpace(mesh, "DG", 1)
        direct = {}
        for where in ("cpu", dev):
            op = HeatOperator(fs, p, dt=dt, device=where)
            T_prev = torch.full((fs.n_scalar_dofs,), p.T_0,
                                dtype=torch.float64, device=op.device)
            if where == dev:
                torch.cuda.synchronize()
                reset_counts(port)
            xd, it, conv = newton_direct(lambda T: op.residual(T, T_prev),
                                         T_prev)
            if not conv:
                fail(f"newton_direct ({key}) did not converge on {where}")
            direct[str(where)] = (xd.cpu().numpy(), it)
            if where == dev:
                torch.cuda.synchronize()
                k3 = read_counts(port)["dg_cell_residual"]
        (xc, ic), (xg, ig) = direct["cpu"], direct[str(dev)]
        uniform = op.qw.dim() == 1
        per_iter = 3 if uniform else 2 + fs.n_scalar_dofs
        out[key] = dict(dofs=fs.n_scalar_dofs, iters_cpu=ic, iters_gpu=ig,
                        tables="uniform" if uniform else "per-cell",
                        T_max_rel=float(np.abs(xg - xc).max()
                                        / np.abs(xc).max()),
                        k3_launches_gpu=k3,
                        k3_launches_per_iteration=per_iter)
        if (ic != ig or not out[key]["T_max_rel"] <= 1e-9
                or uniform != (key == "direct_uniform")
                or k3 != ig * per_iter):
            fail(f"newton_direct: {json.dumps(out[key])}")
    log("forms " + json.dumps(out))
    return out


def solve_scan_phase(dev, port) -> dict:
    """12d: solve_scan on the default slab, SCAN_STEPS steps in chunks of
    SCAN_EVERY, against solve() with an on_snapshot hook on the card: the
    stacks equal the snapshots bit for bit, the counts and the K1 / K3
    launches equal."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    cfg = tc.RunConfig(time=tc.TimeConfig(0.0, SCAN_STEPS * 0.1, 0.1),
                       output=tc.OutputConfig(write_every=SCAN_EVERY,
                                              formats=()))
    runs = {}
    for how in ("solve", "solve_scan"):
        prob = ThermoViscoProblem(config=cfg, device=dev)
        prob.setup()
        torch.cuda.synchronize()
        reset_counts(port)
        t0 = time.perf_counter()
        if how == "solve":
            snaps = []
            prob.solve(on_snapshot=lambda t, s: snaps.append(s))
            res = {"times": torch.stack([s.t for s in snaps])}
            for f in ("T", "Tf", "sigma"):
                res[f] = torch.stack([getattr(s, f) for s in snaps])
        else:
            _, res = prob.solve_scan()
        torch.cuda.synchronize()
        runs[how] = (res, prob.diagnostics.newton_iters,
                     prob.diagnostics.krylov_iters, read_counts(port),
                     time.perf_counter() - t0)
    (ra, na, ka, la, ta), (rb, nb, kb, lb, tb) = (runs["solve"],
                                                  runs["solve_scan"])
    out = dict(steps=SCAN_STEPS, write_every=SCAN_EVERY,
               snapshots=int(rb["times"].shape[0]), newton=nb, cg=kb,
               launches_solve=la, launches_solve_scan=lb, seconds_solve=ta,
               seconds_solve_scan=tb,
               stacks_equal={f: bool(torch.equal(ra[f], rb[f]))
                             for f in ("times", "T", "Tf", "sigma")})
    if (not all(out["stacks_equal"].values()) or (na, ka) != (nb, kb)
            or out["snapshots"] != SCAN_STEPS // SCAN_EVERY
            or la["material_tspace"] != lb["material_tspace"]
            or la["dg_cell_residual"] != lb["dg_cell_residual"]
            or lb["material_tspace"] != SCAN_STEPS
            or lb["dg_cell_residual"] == 0):
        fail(f"solve_scan: {json.dumps(out)}")
    log("solve_scan " + json.dumps(out))
    return out


def native_phase(dev, scratch_dir) -> dict:
    """12e: the native runtime on the N_NATIVE plate: its facets equal the
    numpy builder's bit for bit; the plate written by --write-mesh and
    read back by read_msh through the native parser equals the built
    mesh."""
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d, read_msh
    from fem_glass_tempering_tpu_torch.utils import native

    tag = "native runtime"
    if not native.native_available():
        fail(f"{tag}: the library is unavailable: {native.native_error()}")
    t0 = time.perf_counter()
    m = box_mesh_3d(*N_NATIVE, 1.0, 1.0, 0.01)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = native.native_build_facets(m.cells, m.ref_cell)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = m._build_facets_numpy()
    numpy_s = time.perf_counter() - t0
    fields = ("boundary_cell", "boundary_local_facet", "interior_cell_p",
              "interior_local_facet_p", "interior_cell_m",
              "interior_local_facet_m")
    if m.facet_builder != "native" or not all(
            a.dtype == b.dtype and np.array_equal(a, b)
            for a, b in zip(nat, ref)):
        fail(f"{tag}: native facets differ from the numpy builder's "
             f"({m.facet_builder})")
    work = tempfile.mkdtemp(prefix="native_", dir=scratch_dir)
    try:
        path = os.path.join(work, "plate.msh")
        t0 = time.perf_counter()
        run_cli(["--device", str(dev), "--problem-dim", "3",
                 "--nx", str(N_NATIVE[0]), "--ny", str(N_NATIVE[1]),
                 "--nz", str(N_NATIVE[2]), "--write-mesh", path])
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        r = read_msh(path)
        read_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(work, ignore_errors=True)
    same = (r.msh_reader == "native" and r.facet_builder == "native"
            and r.cell_type == m.cell_type
            and np.array_equal(r.nodes, m.nodes)
            and np.array_equal(r.cells, m.cells)
            and all(np.array_equal(getattr(r, f), getattr(m, f))
                    for f in fields))
    out = dict(cells=m.n_cells, nodes=m.n_nodes,
               boundary_facets=m.n_boundary_facets,
               interior_facets=m.n_interior_facets, mesh_build_s=build_s,
               native_facets_s=native_s, numpy_facets_s=numpy_s,
               cli_write_mesh_s=write_s, msh_bytes=size,
               native_read_msh_s=read_s, read_equals_built=same)
    if not same:
        fail(f"{tag}: the plate read back differs: {json.dumps(out)}")
    log(tag + " " + json.dumps(out))
    return out



# ----------------------------------------------------------------------
# phase 13: distribution (parallel/): shard_problem and CGDDProblem over
# torch.distributed, two gloo ranks on this card and NCCL at world size 1
SHARD_BOX = (8, 8, 4)
# JAX's dry-run plate (__graft_entry__.py:133-145)
CGDD_PLATE = (8, 4, 2, 1.0, 1.0, 0.01)
CGDD_Q2 = (4, 4)
# 13a's steps: the dry-run plate's Jacobi-CG takes 621 + 508 + 537
# iterations in three (f64, rtol 1e-12), at 16 ms an iteration on one
# NCCL rank and 25 over two gloo ranks on an H100: 68.5 s for three steps
P13_STEPS = 1
P13_TIMED_STEPS = 1
P13_RANKS = 2
# The CGDD plate at full size runs one capped step: one Newton iteration of
# CGDD_FULL_CG Jacobi-CG iterations. Converged, a step takes ~8,800 CG
# iterations (the 80x80x40 plate's 8,815 in 4 Newton, f32, rtol 1e-5: the
# count follows the 40 layers through the 0.01 thickness), ~10 minutes on
# the card at its 70 ms an iteration (PERF.md).
CGDD_FULL_CG = 100
# 13c, the DG domain decomposition (DDProblem): the reference's own slab,
# DD_SLAB_STEPS steps, held to JAX's counts (DDProblem of the JAX package on
# the CPU, the same at P = 1, 2, 4 and 8: Newton and CG per step) and to the
# unsharded run on the card; then phase 7's plate in one capped step
DD_SLAB_STEPS = 3
DD_SLAB_JAX = ((4, 217), (3, 164), (3, 166))
DD_FIELDS = ("T", "Tf", "Tf_partial", "xi", "sigma", "sigma_partial")


def rank_port() -> dict:
    """The kernel wrappers whose launch counters a rank reads (each
    process counts its own launches)."""
    from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
        dg_cell_residual,
    )
    from fem_glass_tempering_tpu_torch.ops.cuda_kernels import material_tspace
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
        stencil_matvec,
        stencil_matvec_halo,
    )
    return dict(dg_cell_residual=dg_cell_residual,
                material_tspace=material_tspace,
                stencil_matvec=stencil_matvec,
                stencil_matvec_halo=stencil_matvec_halo)


def shard_box_config(tc, steps):
    """The DG-1 box through "auto" (the DG p-multigrid), matrix-free: the
    sharded heat operator carries the residual and its jvp (K3)."""
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="DG", T_degree=1, sigma_family="CG",
                       sigma_degree=1),
        time=tc.TimeConfig(0.0, steps * 0.1, 0.1),
        output=tc.OutputConfig(write_every=0, formats=()), dtype="float64")


def cgdd_config(tc, steps, degree=1, rtol=None, cap=None):
    """CG-1 / CG-2 T at the config defaults; `rtol` sets Newton's and
    CG's; `cap` stops Newton after one iteration of `cap` CG iterations."""
    solver = ({} if rtol is None
              else dict(newton_rtol=rtol, cg_rtol=rtol))
    if cap is not None:
        solver.update(newton_max_it=1, cg_max_it=cap)
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="CG", T_degree=degree),
        time=tc.TimeConfig(0.0, steps * 0.1, 0.1),
        solver=tc.SolverConfig(**solver),
        output=tc.OutputConfig(write_every=0, formats=()))


def dd_config(tc, steps, cap=None):
    """DG-1 T at the config defaults (f64, rtol 1e-12); `cap` stops Newton
    after one iteration of `cap` CG iterations."""
    solver = {} if cap is None else dict(newton_max_it=1, cg_max_it=cap)
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="DG", T_degree=1),
        time=tc.TimeConfig(0.0, steps * 0.1, 0.1),
        solver=tc.SolverConfig(**solver),
        output=tc.OutputConfig(write_every=0, formats=()))


def p13_meshes():
    from fem_glass_tempering_tpu_torch.fem.mesh import (
        box_mesh_2d,
        box_mesh_3d,
        reference_glass_mesh_1d,
    )
    return dict(shard_box=lambda: box_mesh_3d(*SHARD_BOX),
                dd_slab=reference_glass_mesh_1d,
                cgdd_plate=lambda: box_mesh_3d(*CGDD_PLATE),
                cgdd_q2=lambda: box_mesh_2d(*CGDD_Q2),
                shard_plate=lambda: box_mesh_3d(*N_DG, 1.0, 1.0, 0.01),
                cgdd_full=lambda: box_mesh_3d(*N_FULL, 1.0, 1.0, 0.01))


def k3_expected(newton, cg) -> int:
    """K3 launches of a matrix-free gather step: one residual a Newton
    iteration, primal + tangent a Jacobian action (one before CG starts
    and one a CG iteration)."""
    return newton + 2 * (newton + cg)


def shard_run(dev, port, mesh_name, steps, mesh_dev=None, warmup=False,
              prob=None) -> tuple[dict, object]:
    """A ThermoViscoProblem on the DG-1 box config, sharded over
    `mesh_dev` when given: `steps` steps from the initial state (after
    one warm-up step from it when `warmup`), counted and timed."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.parallel.sharding import shard_problem

    out = {}
    if prob is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prob = ThermoViscoProblem(mesh=p13_meshes()[mesh_name](),
                                  config=shard_box_config(tc, steps),
                                  device=dev)
        prob.setup()
        torch.cuda.synchronize()
        out["setup_s"] = time.perf_counter() - t0
    if mesh_dev is not None:
        t0 = time.perf_counter()
        shard_problem(prob, mesh_dev)
        out["shard_s"] = time.perf_counter() - t0
        out["rows"] = {k: list(v) for k, v in prob.heat.rows.items()}
    if warmup:
        _, ok, _, _ = prob.multi_step(prob.engine.init_state(), 1)
        if not ok:
            fail(f"{mesh_name}: the warm-up step did not converge")
    state0 = prob.engine.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(port)
    t0 = time.perf_counter()
    st, ok, ni, ki = prob.multi_step(state0, steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(port)
    if not ok:
        fail(f"{mesh_name}: did not converge")
    per_cycle = k2_launches_per_vcycle(prob._dg_mg.cg_mg)
    expect = dict(material_tspace=steps, dg_cell_residual=k3_expected(ni, ki),
                  stencil_matvec=per_cycle * (ni + ki))
    if launches != expect:
        fail(f"{mesh_name}: launches {launches}, expected {expect}")
    out.update(newton=ni, cg=ki, ms_per_step=elapsed / steps * 1e3,
               launches=launches, k2_launches_per_vcycle=per_cycle,
               max_memory_allocated_bytes=torch.cuda.max_memory_allocated(
                   dev), T=st.T)
    return out, prob


def cgdd_run(dev, port, mesh_name, steps, mesh_dev, degree=1,
             dtype=torch.float64, rtol=None, cap=None) -> dict:
    """A CGDDProblem over `mesh_dev`: `steps` steps from the initial state,
    counted and timed; T gathered (the global layout) on every rank. With
    `cap`, each step is one Newton iteration of `cap` CG iterations (not
    converged; the counts are held to that)."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.parallel.domain_cg import CGDDProblem

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dd = CGDDProblem(p13_meshes()[mesh_name](),
                     cgdd_config(tc, steps, degree, rtol, cap), mesh_dev,
                     dtype=dtype)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    st = dd.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(port)
    newton, cg = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        st, ok, ni, ki = dd.step(st)
        if cap is None and not ok:
            fail(f"{mesh_name}: CGDD step did not converge")
        if cap is not None and (ni, ki) != (1, cap):
            fail(f"{mesh_name}: a capped step took {ni} / {ki}")
        newton.append(ni)
        cg.append(ki)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(port)
    expect = dict(material_tspace=steps, dg_cell_residual=0,
                  stencil_matvec=0)
    if launches != expect:
        fail(f"{mesh_name}: launches {launches}, expected {expect}")
    peak = torch.cuda.max_memory_allocated(dev)
    return dict(setup_s=setup_s, newton=newton, cg=cg,
                ms_per_step=elapsed / steps * 1e3,
                ms_per_cg=elapsed / sum(cg) * 1e3, launches=launches,
                max_memory_allocated_bytes=peak, T=dd.gather_T(st),
                local_cells=dd.n_local_cells, local_dofs=dd.n_local_dofs)


def dd_run(dev, port, mesh_name, steps, mesh_dev, cap=None) -> dict:
    """A DDProblem over `mesh_dev`: `steps` steps from the initial state,
    counted and timed, K1 once a step and K3 on each residual and twice
    on each Jacobian action over the rank's cells; the gathered fields
    (DD_FIELDS; T alone with `cap`, where each step is one Newton
    iteration of `cap` CG iterations, not converged)."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.parallel.domain import DDProblem

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dd = DDProblem(p13_meshes()[mesh_name](), dd_config(tc, steps, cap),
                   mesh_dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    st = dd.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(port)
    newton, cg = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        st, ok, ni, ki = dd.step(st)
        if cap is None and not ok:
            fail(f"{mesh_name}: DD step did not converge")
        if cap is not None and (ni, ki) != (1, cap):
            fail(f"{mesh_name}: a capped step took {ni} / {ki}")
        newton.append(ni)
        cg.append(ki)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_counts(port)
    expect = dict(material_tspace=steps,
                  dg_cell_residual=k3_expected(sum(newton), sum(cg)),
                  stencil_matvec=0)
    if launches != expect:
        fail(f"{mesh_name}: launches {launches}, expected {expect}")
    peak = torch.cuda.max_memory_allocated(dev)
    g = dd.gather_state(st)
    fields = ("T",) if cap is not None else DD_FIELDS
    return dict(setup_s=setup_s, newton=newton, cg=cg,
                ms_per_step=elapsed / steps * 1e3,
                ms_per_cg=elapsed / sum(cg) * 1e3, launches=launches,
                max_memory_allocated_bytes=peak,
                local_cells=dd.n_local_cells, local_dofs=dd.n_local_dofs,
                k3_path=dd._cell_term.path,
                **{f: getattr(g, f) for f in fields})


def to_host(res: dict) -> dict:
    """A run's result with its fields on the host (what a rank sends
    back)."""
    return {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in res.items()}


def phase13_rank(mesh_dev) -> dict:
    """Phase 13 on one of the two gloo ranks: 13a's three configurations,
    13b's two plates, then 13c's slab and plate."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, port = mesh_dev.device, rank_port()
    t0 = time.perf_counter()
    out = {"shard_box": to_host(shard_run(dev, port, "shard_box", P13_STEPS,
                                          mesh_dev)[0]),
           "cgdd_plate": to_host(cgdd_run(dev, port, "cgdd_plate",
                                          P13_STEPS, mesh_dev)),
           "cgdd_q2": to_host(cgdd_run(dev, port, "cgdd_q2", P13_STEPS,
                                       mesh_dev, degree=2))}
    out["a_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    out["shard_plate"] = to_host(shard_run(dev, port, "shard_plate",
                                           P13_TIMED_STEPS, mesh_dev,
                                           warmup=True)[0])
    gc.collect()
    torch.cuda.empty_cache()
    out["cgdd_full"] = to_host(cgdd_run(
        dev, port, "cgdd_full", 1, mesh_dev, dtype=torch.float32,
        rtol=1e-5, cap=CGDD_FULL_CG))
    out["b_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    out["dd_slab"] = to_host(dd_run(dev, port, "dd_slab", DD_SLAB_STEPS,
                                    mesh_dev))
    out["dd_plate"] = to_host(dd_run(dev, port, "shard_plate", 1, mesh_dev,
                                     cap=CGDD_FULL_CG))
    out["s"] = time.perf_counter() - t0
    return out


def max_rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def distributed_phase(dev, port) -> dict:
    """Phase 13: shard_problem and CGDDProblem (parallel/) on the card.
    In this process: the unsharded runs and, over a process group of one
    rank (NCCL), the sharded ones; meanwhile the same over two gloo ranks
    in two new processes on this card (NCCL refuses two ranks on one
    device), started first."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.parallel.comm import (
        make_device_mesh,
        run_ranks,
    )

    t_phase = time.perf_counter()
    pool = ThreadPoolExecutor(1)
    job = pool.submit(run_ranks, phase13_rank, P13_RANKS, dev,
                      backend="gloo", timeout=900)
    mesh1 = make_device_mesh(dev)
    if (mesh1.size, mesh1.backend) != (1, "nccl"):
        fail(f"phase 13: a group of {mesh1.size} over {mesh1.backend}")
    one, plain = {}, {}
    try:
        # 13a's references: unsharded, and CGDD as one rank
        plain["shard_box"], _ = shard_run(dev, port, "shard_box", P13_STEPS)
        for name, degree in (("cgdd_plate", 1), ("cgdd_q2", 2)):
            prob = ThermoViscoProblem(mesh=p13_meshes()[name](),
                                      config=cgdd_config(tc, P13_STEPS,
                                                         degree),
                                      device=dev)
            prob.setup()
            plain[name] = dict(T=prob.solve().T)
            one[name] = cgdd_run(dev, port, name, P13_STEPS, mesh1,
                                 degree=degree)
        # 13b at world size 1: the plate unsharded, then the same problem
        # sharded in place (bit-equal), then CGDD
        drop_garbage("phase 13b")
        plain["shard_plate"], prob = shard_run(
            dev, port, "shard_plate", P13_TIMED_STEPS, warmup=True)
        one["shard_plate"], prob = shard_run(
            dev, port, "shard_plate", P13_TIMED_STEPS, mesh1, warmup=True,
            prob=prob)
        one["shard_plate"]["setup_s"] = plain["shard_plate"]["setup_s"]
        del prob
        drop_garbage("phase 13b CGDD")
        one["cgdd_full"] = cgdd_run(dev, port, "cgdd_full", 1, mesh1,
                                    dtype=torch.float32, rtol=1e-5,
                                    cap=CGDD_FULL_CG)
        # 13c: the slab unsharded (the two ranks' reference), the plate's
        # capped DD step as one rank
        drop_garbage("phase 13c")
        t_c = time.perf_counter()
        prob = ThermoViscoProblem(mesh=p13_meshes()["dd_slab"](),
                                  config=dd_config(tc, DD_SLAB_STEPS),
                                  device=dev)
        prob.setup()
        st = prob.solve()
        plain["dd_slab"] = {f: getattr(st, f) for f in DD_FIELDS}
        del prob, st
        one["dd_plate"] = dd_run(dev, port, "shard_plate", 1, mesh1,
                                 cap=CGDD_FULL_CG)
        world1_c_s = time.perf_counter() - t_c
    finally:
        mesh1.close()
    world1_s = time.perf_counter() - t_phase
    log(f"13 in this process ({world1_s:.1f} s): " + json.dumps(
        {f"{who}_{k}": {f: x for f, x in v.items() if f not in DD_FIELDS}
         for who, runs in (("unsharded", plain), ("one_rank", one))
         for k, v in runs.items()}))
    try:
        ranks = job.result()
    finally:
        pool.shutdown()
    ranks_s = time.perf_counter() - t_phase
    if len(ranks) != P13_RANKS:
        fail(f"phase 13: {len(ranks)} of {P13_RANKS} ranks reported")

    out = {"world_size_1_s": world1_s, "world_size_1_13c_s": world1_c_s,
           "ranks_s": ranks_s, "ranks_body_s": [r["s"] for r in ranks],
           "ranks_13a_s": [r["a_s"] for r in ranks],
           "ranks_13c_s": [r["s"] - r["b_s"] for r in ranks]}
    log("13 over two ranks, s: " + json.dumps(out) + " " + json.dumps(
        {name: [{k: v for k, v in r[name].items() if k not in DD_FIELDS}
                for r in ranks]
         for name in ("shard_plate", "cgdd_full", "dd_slab", "dd_plate")}))

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    def summary(res):
        return {k: v for k, v in res.items() if k != "T"}

    # ---- 13a: parity on small problems ----
    ref = plain["shard_box"]
    for r, rk in enumerate(ranks):
        got = rk["shard_box"]
        if got["newton"] != ref["newton"] or \
                abs(got["cg"] - ref["cg"]) > 0.01 * ref["cg"]:
            fail(f"13a shard_box rank {r}: {got['newton']} / {got['cg']} "
                 f"against unsharded {ref['newton']} / {ref['cg']}")
        if not np.allclose(got["T"], host(ref["T"]), rtol=1e-12,
                           atol=1e-10):
            fail(f"13a shard_box rank {r}: T off the unsharded run's")
    for name in ("cgdd_plate", "cgdd_q2"):
        for r, rk in enumerate(ranks):
            got, w1 = rk[name], one[name]
            if got["newton"] != w1["newton"] or abs(
                    sum(got["cg"]) - sum(w1["cg"])) > 0.01 * sum(w1["cg"]):
                fail(f"13a {name} rank {r}: {got['newton']} / {got['cg']} "
                     f"against one rank's {w1['newton']} / {w1['cg']}")
            if not np.allclose(got["T"], host(plain[name]["T"]), rtol=1e-10,
                               atol=1e-9):
                fail(f"13a {name} rank {r}: T off the unsharded run's")
    for name in ("shard_box", "cgdd_plate", "cgdd_q2"):
        # lockstep: both ranks take the same counts and hold the same T
        a, b = ranks[0][name], ranks[1][name]
        if (a["newton"], a["cg"]) != (b["newton"], b["cg"]) or \
                not np.array_equal(a["T"], b["T"]):
            fail(f"13a {name}: the ranks disagree")
    out["a"] = dict(
        shard_box=dict(unsharded=summary(ref),
                       ranks=[summary(r["shard_box"]) for r in ranks],
                       T_max_rel=max_rel(ranks[0]["shard_box"]["T"],
                                         host(ref["T"]))),
        **{name: dict(world_size_1=summary(one[name]),
                      ranks=[summary(r[name]) for r in ranks],
                      T_max_rel_unsharded=max_rel(ranks[0][name]["T"],
                                                  host(plain[name]["T"])))
           for name in ("cgdd_plate", "cgdd_q2")})

    # ---- 13b: the plates ----
    ref, w1 = plain["shard_plate"], one["shard_plate"]
    if not bits_equal(w1["T"], ref["T"]) or \
            (w1["newton"], w1["cg"]) != (ref["newton"], ref["cg"]):
        fail("13b shard_plate: one NCCL rank is not the unsharded run bit "
             "for bit")
    T_ref = host(ref["T"])
    rels = [max_rel(rk["shard_plate"]["T"], T_ref) for rk in ranks]
    for r, rk in enumerate(ranks):
        if rk["shard_plate"]["newton"] != ref["newton"] or \
                not rels[r] <= 1e-12:
            fail(f"13b shard_plate rank {r}: Newton "
                 f"{rk['shard_plate']['newton']} / {ref['newton']}, T "
                 f"max-rel {rels[r]:.3e}")
    c1 = one["cgdd_full"]
    T1 = host(c1["T"])
    # the capped step stops CG 100 iterations in, far from convergence:
    # the order of the sums over the ranks moves the f32 iterate, so the
    # two runs' T differ by what that rounding grows to (reported, not
    # held); the ranks hold the same bits
    if not np.isfinite(T1).all() or not all(
            np.isfinite(rk["cgdd_full"]["T"]).all() for rk in ranks):
        fail("13b cgdd_full: non-finite T")
    if not np.array_equal(ranks[0]["cgdd_full"]["T"],
                          ranks[1]["cgdd_full"]["T"]):
        fail("13b cgdd_full: the ranks disagree")
    diffs = [float(np.abs(rk["cgdd_full"]["T"] - T1).max()) for rk in ranks]
    out["b"] = dict(
        shard_plate=dict(unsharded=summary(ref), world_size_1=summary(w1),
                         ranks=[summary(r["shard_plate"]) for r in ranks],
                         T_max_rel=rels),
        cgdd_full=dict(world_size_1=summary(c1),
                       ranks=[summary(r["cgdd_full"]) for r in ranks],
                       T_max_abs_diff_K=diffs))

    # ---- 13c: DDProblem, the slab against the unsharded run ----
    ref = {f: host(v) for f, v in plain["dd_slab"].items()}
    for r, rk in enumerate(ranks):
        got = rk["dd_slab"]
        for k, (n, c) in enumerate(DD_SLAB_JAX):
            if got["newton"][k] != n or abs(got["cg"][k] - c) > 0.02 * c:
                fail(f"13c dd_slab rank {r}: {got['newton']} / {got['cg']} "
                     f"against JAX's {DD_SLAB_JAX}")
        # JAX's tolerances (tests/test_domain_decomposition.py)
        bad = [f for f, rtol, atol in (
            ("T", 1e-10, 1e-9), ("sigma", 1e-8, 1e-12),
            *((f, 1e-9, 1e-11) for f in DD_FIELDS))
            if not np.allclose(got[f], ref[f], rtol=rtol, atol=atol)]
        if bad:
            fail(f"13c dd_slab rank {r}: {bad} off the unsharded run's")
    a, b = ranks[0]["dd_slab"], ranks[1]["dd_slab"]
    if (a["newton"], a["cg"]) != (b["newton"], b["cg"]) or not all(
            np.array_equal(a[f], b[f]) for f in DD_FIELDS):
        fail("13c dd_slab: the ranks disagree")
    # ---- 13c: the plate's capped step, one rank and two ----
    c1 = one["dd_plate"]
    T1 = host(c1["T"])
    if not np.isfinite(T1).all():
        fail("13c dd_plate: non-finite T")
    if not np.array_equal(ranks[0]["dd_plate"]["T"],
                          ranks[1]["dd_plate"]["T"]):
        fail("13c dd_plate: the ranks disagree")
    # the capped step stops 100 CG iterations into a solve that takes
    # thousands; the iterate there carries the rounding of each run's own
    # sums (the dots' order over the ranks, the facet products' batch),
    # grown by CG: 1.5e-8 between one rank and two on an H100, where the
    # same comparison converged agrees to ~1e-15 (the 16x16x4 plate on the
    # CPU: 5.0e-10 capped, 1.1e-15 converged; 0.24 capped where the halo
    # drops the remote side's tangent)
    rel = max_rel(ranks[0]["dd_plate"]["T"], T1)
    if not rel <= 1e-7:
        fail(f"13c dd_plate: two ranks' T max-rel {rel:.3e} off one rank's")
    out["c"] = dict(
        dd_slab=dict(ranks=[{k: v for k, v in r["dd_slab"].items()
                             if k not in DD_FIELDS} for r in ranks],
                     T_max_rel=max_rel(a["T"], ref["T"]),
                     sigma_max_abs_diff=float(np.abs(a["sigma"]
                                                     - ref["sigma"]).max())),
        dd_plate=dict(world_size_1=summary(c1),
                      ranks=[summary(r["dd_plate"]) for r in ranks],
                      T_max_rel=rel))
    out["s"] = time.perf_counter() - t_phase
    log("distributed " + json.dumps(out))
    return out


# ----------------------------------------------------------------------
# phase 13d: the grid-sharded CG-1 step (parallel/grid_shard.py
# GridShardedProblem), K2's halo form on each rank's planes
GS_SMALL = (12, 6, 4, 1.0, 1.0, 0.01)
GS_SMALL_STEPS = 3
GS_DRYRUN_STEPS = 2
# the dry run's "gspmd-grid" counts (Newton, CG): JAX's at P = 4, which
# tests/test_torch_grid_shard.py holds the port's equal to on the CPU; its
# "gspmd-mechanics" strategy takes the same (the heat solve's)
GS_DRYRUN_COUNTS = (14, 14)
# the dry run's "gspmd-mechanics" |sigma| max on 8 TPU chips
# (MULTICHIP_r05.json): printed beside the port's, not held. f32 rounding
# sets it: the plate's stiffness has lambda_max / lambda_min ~ 8e9, so an
# f32 action rounds by ~1e3 times its smallest eigenvalue and the f32
# solve stops ~1e-4 from the f64 one (whose |sigma| max is ~10x smaller);
# whether its CG keeps p'Ap > 0 there is the rounding's luck
# (tests/test_torch_grid_shard_mech_dryrun.py, chip_ab.py dryrunmech).
# Its f64 twin ("dryrun_mech64") is what the two gloo ranks are held on
GS_DRYRUN_MECH_JAX_SIGMA = 4.390e-03
# dryrun_mech64's bands (T max-rel, |sigma - ref| over max|ref|, the
# elasticity CG's summed count within max(n, frac)): the two gloo ranks
# against the one NCCL rank (T bit-equal, sigma 1.0e-5 apart in my CPU
# run: each CG stops inside rtol 1e-8 of a system this ill-conditioned, a
# dot summed in another order apart; counts 105 / 104), the one rank
# against the unsharded run, whose heat V-cycle is GeometricMG (T 6.7e-8
# apart, sigma 1.4e-5, counts 104 / 103 in my CPU run, PR 16)
GS_DRYRUN64_BANDS = {"one": (1e-10, 1e-4, (2, 0.02)),
                     "unsharded": (1e-6, 1e-4, (3, 0.05))}
# 13d(c)'s bands (T max-rel; |sigma - ref| over max|ref| on the centre
# column; the relative 2-norm of sigma - ref: mech_plate_against): the one rank
# against 8b's unsharded state, whose heat V-cycle is GeometricMG where
# GridShardedProblem's is JAX's GridMG (two iterates inside the heat rtol
# 1e-5: T 6.8e-7 apart, f64 sigma 4.9e-6, on the card), and whose f32
# sigma is f32 rounding at the free corners (f32 against f64 1.7x the
# field's max there, two f32 runs 6% apart; off the side faces ~2e-4); the
# two ranks against the one, the elasticity CG's dots summed in another
# order (my chip runs, PR 16). The 2-norm limits sit 5x and 14x above the
# largest sound readings (8b 9.6e-4, one 7.1e-5; my chip run, PR 16)
GS_MECH_BANDS = {"8b": (1e-5, 1e-4, 5e-3), "one": (1e-6, 1e-4, 1e-3)}
GS_PLATE_STEPS = 2              # timed, after one warm-up step
GS_RANKS = 2
# 13d(b)'s output: solve() of 2 steps, a snapshot each, a checkpoint at 2
GS_IO_STEPS = 2


def gs_small_config(tc):
    """JAX's tests/test_grid_mg.py `_cfg()`: Chebyshev MG, f64, CG rtol
    1e-12, the increment forcing off."""
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="CG", T_degree=1),
        time=tc.TimeConfig(0.0, GS_SMALL_STEPS * 0.1, 0.1),
        solver=tc.SolverConfig(linear_operator="stencil",
                               preconditioner="mg", mg_smoother="chebyshev",
                               cg_rtol=1e-12, newton_inc_forcing=0.0),
        output=tc.OutputConfig(write_every=0, formats=()))


def gs_dryrun_config(tc):
    """The dry run's "gspmd-grid" strategy (__graft_entry__.py:146-166)."""
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="CG", T_degree=1, sigma_family="CG",
                       sigma_degree=1),
        time=tc.TimeConfig(0.0, 0.1, 0.1),
        solver=tc.SolverConfig(newton_rtol=1e-6, newton_atol=1e-6,
                               cg_rtol=1e-6, cg_max_it=500,
                               linear_operator="matrix_free",
                               preconditioner="mg", mg_smoother="chebyshev"),
        dtype="float32")


def gs_cases():
    """name -> (mesh maker, config, GridShardedProblem keywords)."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    small = lambda: box_mesh_3d(*GS_SMALL)  # noqa: E731
    q2_small = lambda: box_mesh_3d(*GSQ2_PLATE)  # noqa: E731
    return dict(
        small=(small, gs_small_config(tc), {}),
        dryrun=(small, gs_dryrun_config(tc), {}),
        dryrun_mech=(small, dataclasses.replace(
            gs_dryrun_config(tc), mechanics="equilibrium"), {}),
        dryrun_mech64=(small, dataclasses.replace(
            gs_dryrun_config(tc), mechanics="equilibrium",
            dtype="float64"), {}),
        plate=(lambda: box_mesh_3d(*N_FULL, 1.0, 1.0, 0.01),
               plate_config(tc, GS_PLATE_STEPS, True), {}),
        mech_plate=(coupled_plate_mesh, coupled_plate_config(tc),
                    dict(flux_marker=z_faces)),
        # phase 13f: DG-1 T (JAX's tests/test_grid_dg.py plates, the dry
        # run's "gspmd-dg" config, phase 7b's plate)
        dg_plate=(lambda: box_mesh_3d(8, 4, 4, 1.0, 1.0, 0.01),
                  gsdg_config(tc, 3), {}),
        dg_pad=(lambda: box_mesh_3d(9, 4, 3, 1.0, 1.0, 0.01),
                gsdg_config(tc, 2), {}),
        dg_mech=(lambda: box_mesh_3d(8, 4, 3, 1.0, 1.0, 0.01),
                 dataclasses.replace(
                     gsdg_config(tc, 2), mechanics="equilibrium",
                     physics_mode="corrected", xi_formula="trapezoid"), {}),
        dg_dryrun=(lambda: box_mesh_3d(16, 4, 4, 1.0, 1.0, 0.01),
                   gsdg_dryrun_config(tc, "same"), {}),
        dg_dryrun_mixed=(lambda: box_mesh_3d(16, 4, 4, 1.0, 1.0, 0.01),
                         gsdg_dryrun_config(tc, "float32"), {}),
        dg_full=(lambda: box_mesh_3d(*N_DG, 1.0, 1.0, 0.01),
                 dg_plate_config(tc, 1, **DG_AUTO), {}),
        dg_full_mixed=(lambda: box_mesh_3d(*N_DG, 1.0, 1.0, 0.01),
                       dg_plate_config(tc, 1, cg_dtype="float32",
                                       **DG_AUTO), {}),
        # phase 13g: CG-2 T (JAX's tests/test_grid2.py:237 plate in f64
        # and mixed, the dry run's "gspmd-q2" config, phase 9b's plate)
        q2_plate=(q2_small, gsq2_config(tc), {}),
        q2_mixed=(q2_small, gsq2_config(tc, cg_dtype="float32"), {}),
        q2_dryrun=(q2_small, gsq2_config(tc, rtol=1e-10), {}),
        q2_full=(lambda: box_mesh_3d(*N_CG2, 1.0, 1.0, 0.01),
                 cg2_config(tc, 1, True), {}))


def k2_forms_per_apply(gs) -> dict:
    """K2's launches by form in one Newton or CG iteration of a
    GridShardedProblem: the Jacobian action (halo form; under DG-1 and
    CG-2 the DG slab's and the lattice slab's, plain PyTorch) and one
    V-cycle of the CG-1 correction (under CG-2 Q2MG's coarse chain),
    whose sharded levels smooth with the halo form and whose replicated
    smoothed levels with the full-grid form (nu_pre + 1 + nu_post each,
    coarse_iters on a smoothed coarsest level)."""
    out = dict(halo=0 if gs.is_dg or gs.is_q2 else 1, full=0)
    mg, rmg = gs.grid_mg, gs.rank_mg
    if mg is None:
        return out
    for i, axes in enumerate(mg.axes):
        if axes is None and mg.coarse_inv is not None:
            continue
        n = (mg.nu_pre + 1 + mg.nu_post) if axes is not None \
            else mg.coarse_iters
        out["halo" if rmg.sharded[i] else "full"] += n
    return out


def grid_shard_run(dev, port, mesh_dev, name, steps, warmup=0,
                   keep=False, before=None, after=None, tag="13d") -> dict:
    """GridShardedProblem on case `name` over `mesh_dev`: set up, `warmup`
    steps from the initial state, then `steps` counted and timed from a
    fresh one (`before()` / `after()` called just outside the window);
    the state gathered to the global layout. Under DG-1 T also the
    collectives of the window by kind (halo exchanges of cell layers and
    of node planes, re-partitions between the two grids, other sums: the
    dots, the residual's mean, the replicated levels' all-gathers); under
    CG-2 T likewise, with the lattice windows (LatticeHalo) in place of
    the cell halos."""
    from fem_glass_tempering_tpu_torch.ops.grid2 import LatticeHalo
    from fem_glass_tempering_tpu_torch.parallel import comm
    from fem_glass_tempering_tpu_torch.parallel.comm import halo_exchange
    from fem_glass_tempering_tpu_torch.parallel.grid_shard import (
        GridShardedProblem,
    )
    make_mesh, cfg, kw = gs_cases()[name]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gs = GridShardedProblem(make_mesh(), cfg, mesh_dev, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if warmup:
        _, ok, _, _ = gs.run(gs.init_state(), warmup)
        if not ok:
            fail(f"13d {name}: the warm-up did not converge")
    state0 = gs.init_state()
    if before is not None:
        before()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(port)
    h0 = halo_exchange.count
    c0 = comm.all_reduce_sum.count + comm.all_reduce_max.count
    s0, r0 = comm.all_reduce_sum.count, comm.Repartition.count
    ch0 = getattr(gs, "cell_halos", 0)
    lh0 = LatticeHalo.count
    t0 = time.perf_counter()
    st, ok, ni, ki = gs.run(state0, steps)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    collectives = comm.all_reduce_sum.count + comm.all_reduce_max.count - c0
    by_kind = {}
    if gs.is_dg or gs.is_q2:
        halos = halo_exchange.count - h0
        reparts = comm.Repartition.count - r0
        its = max(ni + ki, 1)
        if gs.is_dg:
            cell = gs.cell_halos - ch0
            by_kind = dict(cell_halos=cell, node_halos=halos - cell,
                           repartitions=reparts)
        else:
            lat = LatticeHalo.count - lh0
            by_kind = dict(lattice_halos=lat, node_halos=halos,
                           repartitions=reparts - lat)
        by_kind["other_sums"] = (comm.all_reduce_sum.count - s0 - halos
                                 - reparts)
        by_kind = dict(collectives_by_kind=by_kind,
                       collectives_by_kind_per_iteration={
                           k: v / its for k, v in by_kind.items()})
    if after is not None:
        after()
    launches = dict(read_counts(port),
                    stencil_matvec_halo=port["stencil_matvec_halo"].launches)
    exchanges = halo_exchange.count - h0
    log(f"{tag} {name} rank {mesh_dev.rank} of {mesh_dev.size}: setup "
        f"{setup_s:.1f} s, {steps} steps in {elapsed:.1f} s")
    peak = torch.cuda.max_memory_allocated(dev)
    if not ok:
        fail(f"{tag} {name}: did not converge")
    per = k2_forms_per_apply(gs)
    # K1 computes the reference xi's chain (eq. 5 shift): the trapezoid
    # xi's is plain PyTorch, as in phase 8b; the elasticity solve has no
    # kernel
    k1 = steps if (cfg.xi_formula == "reference"
                   and cfg.shift_function == "eq5") else 0
    expect = dict(material_tspace=k1, dg_cell_residual=0,
                  stencil_matvec=per["full"] * (ni + ki),
                  stencil_matvec_halo=per["halo"] * (ni + ki))
    if launches != expect or (
            per["halo"] and launches["stencil_matvec_halo"] == 0) or (
            name in ("plate", "mech_plate", "dg_full", "dg_full_mixed",
                     "q2_full") and per["full"]):
        fail(f"{tag} {name} rank {mesh_dev.rank}: launches {launches}, "
             f"expected {expect} (K2 an iteration {per})")
    mech = {}
    if gs.mech is not None:
        mi, mc = list(gs.last_mech_iters), list(gs.last_mech_collectives)
        if len(mi) != steps or not all(gs.last_mech_converged):
            fail(f"{tag} {name} rank {mesh_dev.rank}: elasticity CG per step "
                 f"{mi}, converged {gs.last_mech_converged} (at most "
                 f"{gs.mech.cg_max_it})")
        mech = dict(elast_cg_each_step=mi, elast_cg_per_step=sum(mi) / steps,
                    elast_collectives_each_step=mc,
                    collectives_per_elast_iteration=sum(mc) / max(sum(mi), 1),
                    elast_sharded_levels=list(gs.mech.mg.sharded),
                    elast_levels=[op.dims for op in gs.mech.mg.mg.ops],
                    elast_smoothers=list(gs.mech.mg.mg._smoothers))
    flat = gs.gather_state(st)
    out = dict(newton=ni, cg=ki, newton_per_step=ni / steps,
               cg_per_step=ki / steps, ms_per_step=elapsed / steps * 1e3,
               ms_per_iteration=elapsed / max(ni + ki, 1) * 1e3,
               setup_s=setup_s, setup_parts_s=gs.setup_seconds,
               launches=launches, k2_per_apply=per,
               halo_exchanges=exchanges,
               halo_exchanges_per_iteration=exchanges / max(ni + ki, 1),
               collectives=collectives,
               max_memory_allocated_bytes=peak,
               sharded_levels=list(gs.rank_mg.sharded), rows=gs.rows,
               **by_kind, **mech,
               **{f: getattr(flat, f) for f in ("T", "Tf", "sigma")})
    if keep:
        out["problem"], out["state"] = gs, st
    return out


GS_FIELDS = ("T", "Tf", "sigma")


def grid_shard_rank(mesh_dev, go, io_root) -> dict:
    """Phase 13d on one of the two gloo ranks: (a) the 12x6x4 plate and the
    dry-run config, (b) the 160x160x40 plate and its output
    (grid_shard_io, in `io_root`/two), (c) the coupled plate; rank 0
    creates the file `go`/<case> when a plate's timed window (and (b)'s
    output) is over."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, port = mesh_dev.device, rank_port()
    t0 = time.perf_counter()
    out = {name: to_host(grid_shard_run(dev, port, mesh_dev, name, steps))
           for name, steps in (("small", GS_SMALL_STEPS),
                               ("dryrun", GS_DRYRUN_STEPS))}
    out["a_s"] = time.perf_counter() - t0

    def done(name):
        if mesh_dev.rank == 0:
            open(os.path.join(go, name), "w").close()
    for name, steps, ready in (("plate", GS_PLATE_STEPS, None),
                               ("mech_plate", MECH_TIMED_STEPS,
                                "mech_plate_ready")):
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        res = grid_shard_run(
            dev, port, mesh_dev, name, steps, warmup=1, keep=True,
            before=None if ready is None else lambda r=ready: wait_for(
                go, r, "the one rank's set-up"),
            after=None if name == "plate" else lambda n=name: done(n))
        gs, st = res.pop("problem"), res.pop("state")
        if name == "plate":
            # the output before the one rank's timed window
            res["io"] = grid_shard_io(gs, st, port,
                                      os.path.join(io_root, "two"))
            done(name)
        del gs, st
        out[name] = to_host(res)
        out[f"{name}_s"] = time.perf_counter() - t1
    out["s"] = time.perf_counter() - t0
    return out


def grid_shard_one(mesh_dev, go, io_root) -> dict:
    """Phase 13d over one NCCL rank, in a process of its own that sets up
    while the two gloo ranks do: (a) the dry run's mechanics config in f32
    (JAX's; its f64 twin, which the two gloo ranks run, is phase 13d64:
    the f32 elasticity solve is not certifiable on this plate,
    GS_DRYRUN_MECH_JAX_SIGMA), then (b) and (c), each timed window after theirs (the file
    `go`/<case>), so the two never share the card; in (c) the two ranks
    also wait to time until this rank is set up and warm (the file
    `go`/mech_plate_ready, written however this process ends). After (b),
    K2's halo form on the plate's tables and the plate's output
    (grid_shard_io, in `io_root`/one)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, port = mesh_dev.device, rank_port()
    ready = os.path.join(go, "mech_plate_ready")
    try:
        dryrun_mech = to_host(grid_shard_run(
            dev, port, mesh_dev, "dryrun_mech", GS_DRYRUN_STEPS))
        wait = lambda name: wait_for(  # noqa: E731
            go, name, "the two ranks' timed window")
        one = grid_shard_run(dev, port, mesh_dev, "plate", GS_PLATE_STEPS,
                             warmup=1, keep=True,
                             before=lambda: wait("plate"))
        gs, st = one.pop("problem"), one.pop("state")
        k2h = k2_halo_check(gs, st, port)
        one["io"] = grid_shard_io(gs, st, port, os.path.join(io_root, "one"))
        out = dict(plate=to_host(one), k2_halo=k2h, dryrun_mech=dryrun_mech)
        del one, gs, st
        gc.collect()
        torch.cuda.empty_cache()

        def before():
            open(ready, "w").close()
            wait("mech_plate")
        out["mech_plate"] = to_host(grid_shard_run(
            dev, port, mesh_dev, "mech_plate", MECH_TIMED_STEPS, warmup=1,
            before=before))
    finally:
        open(ready, "a").close()
    return out


def wait_for(go, name, what) -> None:
    """Wait until the file `go`/`name` exists (at most 500 s)."""
    t0 = time.perf_counter()
    while not os.path.exists(os.path.join(go, name)):
        if time.perf_counter() - t0 > 500:
            fail(f"13d {name}: {what} never ended")
        time.sleep(0.05)


def dir_mb(path: str, suffix: str = "") -> float:
    """MB (1e6 bytes) of the files in `path` whose names end with
    `suffix`."""
    return sum(os.path.getsize(os.path.join(path, n))
               for n in os.listdir(path) if n.endswith(suffix)) / 1e6


def grid_shard_io(gs, st, port, work, tag=None) -> dict:
    """13d(b)'s output on this rank's planes of the plate, after the timed
    window: solve() of GS_IO_STEPS steps from the initial state with a
    snapshot (npz_fields' default) every step and a checkpoint every 2
    steps into `work`, whose last snapshot must equal gather_state bit for
    bit; then save_checkpoint -> load_checkpoint -> run(1) must equal
    run(1) from the in-memory state, every field bit for bit. K1 and K2's
    launches are counted and held (one K1 a step; K2's halo form 31 a
    Newton or CG iteration) over the solve and over each run(1). Seconds
    and MB a rank of one more snapshot, of the save and of the load;
    `work` removed at the end (every rank's files: rank 0, after a
    sync)."""
    from fem_glass_tempering_tpu_torch.config import OutputConfig
    from fem_glass_tempering_tpu_torch.io.sharded import (
        ShardedSeriesWriter,
        read_sharded_series,
    )
    from fem_glass_tempering_tpu_torch.models.viscoelastic import ViscoState
    rank = gs.comm.rank
    tag = f"{tag or '13d(b)'} output, rank {rank}"
    per = k2_forms_per_apply(gs)
    oc = OutputConfig(output_dir=work, write_every=1, formats=("npz",),
                      checkpoint_every=2)
    gs.config = dataclasses.replace(gs.config, output=oc)

    def counted(fn, steps):
        torch.cuda.synchronize()
        reset_counts(port)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        got = dict(material_tspace=port["material_tspace"].launches,
                   stencil_matvec_halo=port["stencil_matvec_halo"].launches)
        ni, ki = ((gs.newton_iters, gs.krylov_iters)
                  if isinstance(res, ViscoState) else res[2:])
        want = dict(material_tspace=steps,
                    stencil_matvec_halo=per["halo"] * (ni + ki))
        if got != want or port["stencil_matvec"].launches:
            fail(f"{tag}: launches {got}, expected {want}")
        return res, s, got
    st_solve, solve_s, solve_launches = counted(
        lambda: gs.solve(gs.init_state(), n_steps=GS_IO_STEPS), GS_IO_STEPS)
    series = read_sharded_series(os.path.join(work, "sharded_series"))
    flat = gs.gather_state(st_solve)
    fields = [f for f in oc.npz_fields if f in ViscoState._fields]
    if series["T"].shape[0] != GS_IO_STEPS or not all(
            np.array_equal(series[f][-1], getattr(flat, f).numpy())
            for f in fields):
        fail(f"{tag}: the series' last snapshot is not gather_state's")
    ckpt2 = os.path.join(work, f"sharded_ckpt_{GS_IO_STEPS:06d}")
    if not os.path.exists(os.path.join(ckpt2, "meta.json")):
        fail(f"{tag}: solve() wrote no checkpoint at step {GS_IO_STEPS}")
    del series, flat, st_solve
    snap = os.path.join(work, "snapshot")
    w = ShardedSeriesWriter(snap, fields=tuple(fields), grid=gs.grid,
                            pad0=gs.pad0, rank=rank,
                            world_size=gs.n_devices, **gs._cell_layout())
    t0 = time.perf_counter()
    w.write(0.0, st)
    snapshot_s = time.perf_counter() - t0
    ck = os.path.join(work, "ckpt")
    t0 = time.perf_counter()
    gs.save_checkpoint(ck, st)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = gs.load_checkpoint(ck)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not all(bits_equal(getattr(loaded, f), getattr(st, f))
               for f in ViscoState._fields):
        fail(f"{tag}: the loaded state is not the saved one")
    (a, ok_a, ni_a, ki_a), _, resumed_launches = counted(
        lambda: gs.run(loaded, 1), 1)
    del loaded
    (b, ok_b, ni_b, ki_b), _, _ = counted(lambda: gs.run(st, 1), 1)
    if not (ok_a and ok_b and (ni_a, ki_a) == (ni_b, ki_b) and all(
            bits_equal(getattr(a, f), getattr(b, f))
            for f in ViscoState._fields)):
        fail(f"{tag}: run(1) from the loaded checkpoint is not run(1) from "
             f"the state ({ni_a} / {ki_a} against {ni_b} / {ki_b})")
    del a, b
    out = dict(solve_s=solve_s, solve_newton=gs.newton_iters,
               solve_cg=gs.krylov_iters,
               solve_newton_per_step=gs.newton_iters / GS_IO_STEPS,
               solve_cg_per_step=gs.krylov_iters / GS_IO_STEPS,
               solve_launches=solve_launches,
               resumed_launches=resumed_launches,
               resumed_newton_cg=[ni_a, ki_a],
               snapshot_fields=fields, snapshot_s=snapshot_s,
               ckpt_save_s=save_s, ckpt_load_s=load_s,
               series_bit_equal=True, resume_bit_equal=True)
    # this rank's pieces: at its node-plane offset, and (DG-1, CG-2) its
    # cell layer or lattice plane offset
    mine = {f"_o{gs.rows[rank][0]:06d}.npz"}
    if gs.is_dg or gs.is_q2:
        mine.add(f"_o{gs.t_rows[rank][0]:06d}.npz")
    gs._sync()          # every rank's files are written: count them
    out.update(snapshot_mb_rank=sum(dir_mb(snap, m) for m in mine),
               ckpt_mb_rank=sum(dir_mb(ck, m) for m in mine),
               ckpt_mb_all_ranks=dir_mb(ck))
    gs._sync()          # every rank has read the directories
    if rank == 0:
        shutil.rmtree(work, ignore_errors=True)
    log(f"{tag}: " + json.dumps(out))
    return out


def k2_halo_check(gs, st, port) -> dict:
    """K2's halo form on the plate's real tables, the two-rank layout's
    slabs of the fine level (planes [0, 81) and [81, 161)), against its
    plain twin and the full-grid kernel's rows (bit for bit), timed on the
    first against its bound, the twin and a CSR product."""
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
        stencil_matvec,
        stencil_matvec_halo,
        stencil_matvec_halo_reference,
    )
    op, dt = gs.grid_op, gs.dt
    G0 = op.grid[0]
    Tg = st.T.reshape(op.grid)
    x = torch.tensor(np.random.default_rng(13).standard_normal(
        Tg.shape), dtype=Tg.dtype, device=Tg.device)
    full = stencil_matvec(op.stencil_values_g(Tg, dt).reshape(27, G0, -1),
                          x.reshape(-1), op.grid).reshape(G0, -1)
    z = torch.zeros_like(x[:1])
    out = {}
    for lo, hi in ((0, (G0 + 1) // 2), ((G0 + 1) // 2, G0)):
        sl = op.slab(lo, hi)

        def ext(a):
            return torch.cat([z if lo == 0 else a[lo - 1:lo], a[lo:hi],
                              z if hi == G0 else a[hi:hi + 1]])
        vals2 = sl.stencil_values_r(ext(Tg), dt)
        xe = ext(x).reshape(-1)
        shape = sl.slab_grid
        y = stencil_matvec_halo(vals2, xe, shape)
        twin = stencil_matvec_halo_reference(vals2, xe, shape)
        if not bits_equal(y, twin) or not bits_equal(
                y.reshape(hi - lo, -1), full[lo:hi].contiguous()):
            fail(f"K2 halo form on planes [{lo}, {hi}): not its twin's or "
                 f"the full grid's bits")
        out.setdefault("max_abs_err", float((y - twin).abs().max()))
        if lo == 0:
            n, nx = vals2.shape[1] * vals2.shape[2], xe.numel()
            b, by = bound_ms((27 * n + nx + n) * 4, K2_OPS_PER_POINT * n,
                             torch.float32)
            lib_ms, y_lib = csr_library_ms(vals2, xe, shape, halo=True)
            mag = stencil_matvec_halo_reference(vals2.abs(), xe.abs(), shape)
            if bool(((y - y_lib).abs() > 1e-5 * mag).any()):
                fail("the CSR yardstick disagrees with K2's halo form")
            out.update(
                slab=list(shape), bound_ms=b, bound_by=by, library_ms=lib_ms,
                ms=time_ms(lambda: stencil_matvec_halo(vals2, xe, shape)),
                device_ms=device_ms(
                    lambda: stencil_matvec_halo(vals2, xe, shape)),
                plain_ms=time_ms(lambda: stencil_matvec_halo_reference(
                    vals2, xe, shape), reps=10))
    out["checked_slabs"] = [[0, (G0 + 1) // 2], [(G0 + 1) // 2, G0]]
    return out


def grid_shard_phase(dev, port, mech_ref, scratch_dir=None) -> dict:
    """Phase 13d: GridShardedProblem on the card. Three processes start at
    once: the 160x160x40 plate and then the coupled plate over one NCCL
    rank, and every case over two gloo ranks; they set up together, and
    each of the one rank's timed windows follows the two ranks'.
    Meanwhile this process runs the 12x6x4 plate and the dry-run
    mechanics config unsharded (the ranks' references). `mech_ref`: phase
    8b's reference (its out["reference"]), which 13d(c)'s one rank is
    held to. 13d(b)'s output goes to a new directory under `scratch_dir`
    (default build/chip_smoke/ of this checkout), removed at the end."""
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks
    t_phase = time.perf_counter()
    go = tempfile.mkdtemp(prefix="fgt_13d_")
    if scratch_dir is None:
        scratch_dir = os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "build", "chip_smoke")
    os.makedirs(scratch_dir, exist_ok=True)
    io_root = tempfile.mkdtemp(prefix="io_13d_", dir=scratch_dir)
    with ThreadPoolExecutor(2) as ex:
        job_two = ex.submit(run_ranks, grid_shard_rank, GS_RANKS, dev, go,
                            io_root, backend="gloo", timeout=600)
        job_one = ex.submit(run_ranks, grid_shard_one, 1, dev, go, io_root,
                            backend="nccl", timeout=600)
        unsharded = {}
        for name, steps in (("small", GS_SMALL_STEPS),
                            ("dryrun_mech", GS_DRYRUN_STEPS)):
            make_mesh, cfg, _ = gs_cases()[name]
            prob = ThermoViscoProblem(mesh=make_mesh(), config=cfg,
                                      device=dev)
            prob.setup()
            st, ok, ni, ki = prob.multi_step(prob.state, steps)
            if not ok:
                fail(f"13d {name}: the unsharded run did not converge")
            unsharded[name] = dict(
                newton=ni, cg=ki, mech=list(prob.last_mech_iters),
                **{f: getattr(st, f).cpu().numpy() for f in GS_FIELDS})
            del prob, st
        ref = unsharded["small"]
        ref_counts = (ref["newton"], ref["cg"])
        try:
            ranks = job_two.result()
        finally:
            # a failed pair must not leave the one rank waiting
            for name in ("plate", "mech_plate"):
                open(os.path.join(go, name), "a").close()
        res_one = job_one.result()[0]
    shutil.rmtree(go, ignore_errors=True)
    shutil.rmtree(io_root, ignore_errors=True)
    one, k2h = res_one["plate"], res_one["k2_halo"]
    processes_s = time.perf_counter() - t_phase

    def summary(res):
        return {k: v for k, v in res.items() if k not in GS_FIELDS}

    # ---- (a) the 12x6x4 plate against the unsharded run on the card ----
    for r, rk in enumerate(ranks):
        got = rk["small"]
        if got["newton"] != ref_counts[0] or abs(got["cg"] - ref_counts[1]) \
                > max(5, 0.02 * ref_counts[1]):
            fail(f"13d small rank {r}: {got['newton']} / {got['cg']} "
                 f"against unsharded {ref_counts}")
        for f in ("T", "Tf"):
            if not np.allclose(got[f], ref[f], rtol=1e-10, atol=0):
                fail(f"13d small rank {r}: {f} off the unsharded run's")
        scale = max(float(np.abs(ref["sigma"]).max()), 1e-30)
        if not float(np.abs(got["sigma"] - ref["sigma"]).max()) <= \
                1e-6 * scale:
            fail(f"13d small rank {r}: sigma off the unsharded run's")
        dr = rk["dryrun"]
        if (dr["newton"], dr["cg"]) != GS_DRYRUN_COUNTS or \
                not np.isfinite(dr["T"]).all():
            fail(f"13d dryrun rank {r}: {dr['newton']} / {dr['cg']}, "
                 f"JAX's {GS_DRYRUN_COUNTS}")
    # the dry run's mechanics config over the one NCCL rank, f32 (JAX's)
    # and f64: JAX's counts, its elasticity CG converged (grid_shard_run),
    # T as the unsharded run's on the card (whose matrix-free heat solve
    # under GeometricMG takes other counts), sigma finite (in f32 its size
    # is rounding: GS_DRYRUN_MECH_JAX_SIGMA, and so is its elasticity CG
    # count, reported beside the unsharded run's: 42 / 57 on the CPU, 52 /
    # 57 on the card)
    dm, um = res_one["dryrun_mech"], unsharded["dryrun_mech"]
    if (dm["newton"], dm["cg"]) != GS_DRYRUN_COUNTS or \
            not np.isfinite(dm["sigma"]).all() or \
            not all(max_rel(dm[f], um[f]) <= 1e-6 for f in ("T", "Tf")):
        fail(f"13d dryrun_mech: {dm['newton']} / {dm['cg']} (unsharded "
             f"{um['newton']} / {um['cg']}, JAX's {GS_DRYRUN_COUNTS}), T "
             f"max-rel {max_rel(dm['T'], um['T']):.3e}")
    sigma_max = dict(world_size_1=float(np.abs(dm["sigma"]).max()),
                     unsharded=float(np.abs(um["sigma"]).max()),
                     jax_8_tpu_chips=GS_DRYRUN_MECH_JAX_SIGMA)
    log("13d(a) gspmd-mechanics |sigma| max " + json.dumps(sigma_max))
    for name in ("small", "dryrun", "plate", "mech_plate"):
        a, b = ranks[0][name], ranks[1][name]
        if (a["newton"], a["cg"]) != (b["newton"], b["cg"]) or not all(
                np.array_equal(a[f], b[f]) for f in GS_FIELDS):
            fail(f"13d {name}: the ranks disagree")
    # ---- (b) the plate: one NCCL rank against two gloo ranks ----
    two = ranks[0]["plate"]
    rel = max_rel(two["T"], one["T"])
    if two["newton"] != one["newton"] or \
            abs(two["cg"] - one["cg"]) > 0.02 * one["cg"] or not rel <= 1e-6:
        fail(f"13d plate: two ranks {two['newton']} / {two['cg']} against "
             f"one's {one['newton']} / {one['cg']}, T max-rel {rel:.3e}")
    io_two = [r["plate"]["io"] for r in ranks]
    if [x["resumed_newton_cg"] for x in io_two] != [
            io_two[0]["resumed_newton_cg"]] * GS_RANKS or \
            io_two[0]["solve_newton"] != one["io"]["solve_newton"]:
        fail(f"13d(b) output: the runs disagree (one rank "
             f"{one['io']['solve_newton']} Newton, two ranks "
             f"{[x['solve_newton'] for x in io_two]})")
    from fem_glass_tempering_tpu_torch.config import ModelParams
    mp, T1 = ModelParams(), one["T"]
    if not (np.isfinite(T1).all() and mp.T_ambient - 1 < T1.min()
            and T1.max() < mp.T_0 + 1):
        fail(f"13d plate: T out of [T_ambient, T_0]: {T1.min()} .. "
             f"{T1.max()}")
    # ---- (c) the coupled plate: one NCCL rank against 8b's unsharded
    # state, two gloo ranks against the one ----
    one_c, two_c = res_one["mech_plate"], ranks[0]["mech_plate"]
    against_8b = mech_plate_against(one_c, mech_ref)
    e1, e8 = (sum(one_c["elast_cg_each_step"]), sum(mech_ref["mech"]))
    if one_c["newton"] != mech_ref["newton"] or \
            abs(one_c["cg"] - mech_ref["cg"]) > max(2, 0.1 * mech_ref["cg"]) \
            or abs(e1 - e8) > 0.02 * e8 or \
            not against_8b["T_max_rel"] <= GS_MECH_BANDS["8b"][0] or \
            not against_8b["sigma_centre"] <= GS_MECH_BANDS["8b"][1] or \
            not against_8b["sigma_l2"] <= GS_MECH_BANDS["8b"][2]:
        fail(f"13d mech_plate, one rank against 8b: "
             f"{json.dumps(against_8b)}")
    against_one = mech_plate_against(two_c, one_c)
    e2 = sum(two_c["elast_cg_each_step"])
    if (two_c["newton"], two_c["cg"]) != (one_c["newton"], one_c["cg"]) or \
            abs(e2 - e1) > 0.02 * e1 or \
            not against_one["T_max_rel"] <= GS_MECH_BANDS["one"][0] or \
            not against_one["sigma_centre"] <= GS_MECH_BANDS["one"][1] or \
            not against_one["sigma_l2"] <= GS_MECH_BANDS["one"][2]:
        fail(f"13d mech_plate, two ranks against one: "
             f"{json.dumps(against_one)}")
    out = dict(
        a=dict(unsharded_newton_cg=list(ref_counts),
               unsharded_dryrun_mech_newton_cg=[
                   unsharded["dryrun_mech"]["newton"],
                   unsharded["dryrun_mech"]["cg"]],
               unsharded_dryrun_mech_elast_cg=unsharded["dryrun_mech"][
                   "mech"],
               ranks=[dict(small=summary(r["small"]),
                           dryrun=summary(r["dryrun"])) for r in ranks],
               T_max_rel=max_rel(ranks[0]["small"]["T"], ref["T"]),
               dryrun_mech_world_size_1=summary(dm),
               dryrun_mech_T_max_rel=max_rel(dm["T"], um["T"]),
               dryrun_mech_sigma_max=sigma_max),
        b=dict(world_size_1=summary(one),
               ranks=[summary(r["plate"]) for r in ranks], T_max_rel=rel,
               io=dict(world_size_1=one["io"], ranks=io_two)),
        c=dict(world_size_1=summary(one_c),
               ranks=[summary(r["mech_plate"]) for r in ranks],
               against_8b=against_8b, two_against_one=against_one),
        k2_halo=k2h, processes_s=processes_s,
        ranks_body_s=[r["s"] for r in ranks],
        ranks_a_s=[r["a_s"] for r in ranks],
        ranks_b_s=[r["plate_s"] for r in ranks],
        ranks_c_s=[r["mech_plate_s"] for r in ranks])
    out["s"] = time.perf_counter() - t_phase
    log("grid sharded " + json.dumps(out))
    return out


def dryrun64_rank(mesh_dev) -> dict:
    """Phase 13d64 on one rank: the dry run's mechanics config in f64."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return to_host(grid_shard_run(mesh_dev.device, rank_port(), mesh_dev,
                                  "dryrun_mech64", GS_DRYRUN_STEPS))


def dryrun64_phase(dev, port) -> dict:
    """Phase 13d64, 13d(a)'s f64 twin of the dry run's mechanics config
    (a side phase: it times nothing). Over two gloo ranks and one NCCL
    rank, each in processes of its own started together, while this
    process runs it unsharded; the two ranks held to the one and the one
    to the unsharded run (dryrun64_against, GS_DRYRUN64_BANDS), the two
    ranks in lockstep."""
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        job_two = ex.submit(run_ranks, dryrun64_rank, GS_RANKS, dev,
                            backend="gloo", timeout=300)
        job_one = ex.submit(run_ranks, dryrun64_rank, 1, dev,
                            backend="nccl", timeout=300)
        make_mesh, cfg, _ = gs_cases()["dryrun_mech64"]
        prob = ThermoViscoProblem(mesh=make_mesh(), config=cfg, device=dev)
        prob.setup()
        st, ok, ni, ki = prob.multi_step(prob.state, GS_DRYRUN_STEPS)
        if not ok:
            fail("13d64: the unsharded run did not converge")
        unsharded = dict(newton=ni, cg=ki, mech=list(prob.last_mech_iters),
                         **{f: getattr(st, f).cpu().numpy()
                            for f in GS_FIELDS})
        del prob, st
        ranks, one = job_two.result(), job_one.result()[0]
    if not all(np.array_equal(ranks[0][f], ranks[1][f])
               for f in GS_FIELDS):
        fail("13d64: the ranks disagree")
    checks = dict(one_against_unsharded=dryrun64_against(
        one, unsharded, GS_DRYRUN64_BANDS["unsharded"], "unsharded"))
    for r, rk in enumerate(ranks):
        checks[f"rank{r}_against_one"] = dryrun64_against(
            rk, one, GS_DRYRUN64_BANDS["one"], f"rank {r} against one")

    def summary(res):
        return {k: v for k, v in res.items() if k not in GS_FIELDS}
    out = dict(unsharded=dict(newton=ni, cg=ki, mech=unsharded["mech"]),
               world_size_1=summary(one),
               ranks=[summary(r) for r in ranks], checks=checks,
               sigma_max=dict(world_size_1=float(np.abs(one["sigma"]).max()),
                              two_ranks=float(np.abs(
                                  ranks[0]["sigma"]).max()),
                              unsharded=float(np.abs(
                                  unsharded["sigma"]).max())),
               s=time.perf_counter() - t0)
    log("dryrun mechanics f64 " + json.dumps(out))
    return out


def dryrun64_against(got: dict, ref: dict, band, who) -> dict:
    """13d(a)'s f64 mechanics twin against a reference run of it: JAX's
    heat counts, T and sigma within `band`'s fractions of their max, the
    summed elasticity CG count within max(n, frac) of the reference's;
    fails outside them."""
    t_band, s_band, (n, frac) = band
    e, e_ref = (sum(x.get("elast_cg_each_step", x.get("mech")))
                for x in (got, ref))
    out = dict(newton_cg=(got["newton"], got["cg"]),
               elast_cg=(e, e_ref), T_max_rel=max_rel(got["T"], ref["T"]),
               sigma_max_rel=max_rel(got["sigma"], ref["sigma"]))
    if (got["newton"], got["cg"]) != GS_DRYRUN_COUNTS or \
            abs(e - e_ref) > max(n, frac * e_ref) or \
            not out["T_max_rel"] <= t_band or \
            not out["sigma_max_rel"] <= s_band:
        fail(f"13d64, {who}: {json.dumps(out)}")
    return out


def mech_plate_against(got: dict, ref: dict) -> dict:
    """13d(c)'s run against a reference run of the coupled plate: counts
    side by side, T max-rel, |sigma - ref| over max|ref| on the centre
    column (x = y = 25: 8b's membrane profile), off the four insulated
    side faces ("inner") and everywhere, and the field's relative 2-norm
    difference. Held: the centre column and the 2-norm (GS_MECH_BANDS);
    the max-norms are reported: in f32 the elasticity solve leaves its
    largest error at the free edges, where two f32 runs part by up to 6%
    of the field's max (f64 runs by 4.9e-6; my chip runs, PR 16)."""
    g = tuple(n + 1 for n in N_MECH)
    a, b = (x["sigma"].reshape(g + (3, 3)) for x in (got, ref))
    c0, c1 = g[0] // 2, g[1] // 2

    def off(sl):
        return float(np.abs(a[sl] - b[sl]).max()
                     / max(float(np.abs(b[sl]).max()), 1e-30))
    return dict(
        newton=(got["newton"], ref["newton"]), cg=(got["cg"], ref["cg"]),
        elast_cg=(got.get("elast_cg_each_step", got.get("mech")),
                  ref.get("elast_cg_each_step", ref.get("mech"))),
        T_max_rel=max_rel(got["T"], ref["T"]),
        sigma_centre=off((c0, c1)), sigma_inner=off(np.s_[1:-1, 1:-1]),
        sigma_all=off(np.s_[:]),
        sigma_l2=float(np.linalg.norm(a - b) / np.linalg.norm(b)),
        T_bit_equal=bool(np.array_equal(got["T"], ref["T"])),
        sigma_bit_equal=bool(np.array_equal(got["sigma"], ref["sigma"])))


# ----------------------------------------------------------------------
# phase 13f: the grid-sharded DG-1 step
GSDG_SMALL = (("dg_plate", 3), ("dg_pad", 2), ("dg_mech", 2),
              ("dg_dryrun", 2), ("dg_dryrun_mixed", 2))
# phase 7b's unsharded f64 run of the 64x64x16 plate (T after its timed
# step, its counts), which 13f(b) is held to: written by the main
# process into the scratch directory
PHASE7B_REF = "phase7b_f64.npz"


def gsdg_config(tc, steps):
    """JAX's tests/test_grid_dg.py `_run_cfg`: f64, Newton and CG rtol
    1e-12, Chebyshev MG."""
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="DG", T_degree=1, sigma_family="CG",
                       sigma_degree=1),
        time=tc.TimeConfig(0.0, steps * 0.1, 0.1),
        solver=tc.SolverConfig(newton_rtol=1e-12, newton_atol=1e-10,
                               cg_rtol=1e-12, cg_max_it=2000,
                               linear_operator="stencil",
                               preconditioner="mg", mg_smoother="chebyshev"),
        output=tc.OutputConfig(write_every=0, formats=()), dtype="float64")


def gsdg_dryrun_config(tc, cg_dtype):
    """The dry run's "gspmd-dg" strategy (__graft_entry__.py:192-205),
    f64 or with the f32 twins (cg_dtype="float32")."""
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="DG", T_degree=1, sigma_family="CG",
                       sigma_degree=1),
        time=tc.TimeConfig(0.0, 0.1, 0.1),
        solver=tc.SolverConfig(newton_rtol=1e-12, newton_atol=1e-10,
                               cg_rtol=1e-10, cg_max_it=500,
                               linear_operator="stencil",
                               preconditioner="mg", mg_smoother="chebyshev",
                               cg_dtype=cg_dtype),
        output=tc.OutputConfig(write_every=0, formats=()), dtype="float64")


def k2_halo_level_check(gs, st, port, tag="13f") -> dict:
    """K2's halo form on this rank's slab of the CG-1 correction's fine
    level (under CG-2 Q2MG's coarse chain), its tables baked at the run's
    state restricted (injected) to the node grid (the path's own), against
    its plain twin bit for bit."""
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
        stencil_matvec_halo,
        stencil_matvec_halo_reference,
    )
    if gs.is_dg:
        rdmg = gs.rank_dg_mg
        rmg = rdmg.rank_mg
        T = st.T.reshape(gs.cell_shape).to(gs.dg_mg.dtype)
        T0 = rmg.linearization_states(rdmg.tr.restrict_state(T))[0]
    else:
        rq = gs.rank_q2_mg
        rmg = rq.rank_mg
        T0 = rq.linearization_states(st.T.reshape(gs.t_shape).to(
            gs.q2_mg.fine.dtype))[1]
    slab = rmg.slabs[0]
    if slab is None:
        fail(f"{tag}: the CG-1 chain's fine level is not sharded")
    vals2 = slab.stencil_values_r(rmg._halo(T0), gs.dt)
    shape = slab.slab_grid
    rng = np.random.default_rng(31 + gs.comm.rank)
    xe = torch.tensor(rng.standard_normal((shape[0] + 2,) + shape[1:]),
                      dtype=vals2.dtype, device=vals2.device).reshape(-1)
    y = stencil_matvec_halo(vals2, xe, shape)
    twin = stencil_matvec_halo_reference(vals2, xe, shape)
    if not bits_equal(y, twin):
        fail(f"{tag} rank {gs.comm.rank}: K2's halo form is not its twin's "
             f"bits on the fine level's slab {list(shape)}")
    return dict(slab=list(shape), dtype=str(vals2.dtype),
                max_abs_err=float((y - twin).abs().max()))


def grid_shard_dg_rank(mesh_dev, go, io_root) -> dict:
    """Phase 13f on one of the two gloo ranks: (a) the small plates, (b)
    the 64x64x16 plate in f64 (1 + 1 steps), K2's halo form on its fine
    level's slab, and its output (grid_shard_io, in `io_root`/two); rank 0
    creates the file `go`/dg_full when (b) is over."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, port = mesh_dev.device, rank_port()
    t0 = time.perf_counter()
    out = {name: to_host(grid_shard_run(dev, port, mesh_dev, name, steps,
                                        tag="13f"))
           for name, steps in GSDG_SMALL}
    out["a_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    res = grid_shard_run(dev, port, mesh_dev, "dg_full", 1, warmup=1,
                         keep=True, tag="13f")
    gs, st = res.pop("problem"), res.pop("state")
    res["k2_halo"] = k2_halo_level_check(gs, st, port)
    res["io"] = grid_shard_io(gs, st, port, os.path.join(io_root, "two"),
                              tag="13f(b)")
    if mesh_dev.rank == 0:
        open(os.path.join(go, "dg_full"), "w").close()
    del gs, st
    out["dg_full"] = to_host(res)
    out["b_s"] = time.perf_counter() - t1
    out["s"] = time.perf_counter() - t0
    return out


def grid_shard_dg_one(mesh_dev, go, io_root) -> dict:
    """Phase 13f over one NCCL rank, in a process of its own that sets up
    while the two gloo ranks run: (a) the small plates, then (b) the
    64x64x16 plate in f64, its timed window after the two ranks' (the
    file `go`/dg_full), K2's halo form and its output (`io_root`/one),
    then in mixed precision (1 + 1 steps)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, port = mesh_dev.device, rank_port()
    out = {name: to_host(grid_shard_run(dev, port, mesh_dev, name, steps,
                                        tag="13f"))
           for name, steps in GSDG_SMALL}
    res = grid_shard_run(dev, port, mesh_dev, "dg_full", 1, warmup=1,
                         keep=True, tag="13f", before=lambda: wait_for(
                             go, "dg_full", "the two ranks' (b)"))
    gs, st = res.pop("problem"), res.pop("state")
    res["k2_halo"] = k2_halo_level_check(gs, st, port)
    res["io"] = grid_shard_io(gs, st, port, os.path.join(io_root, "one"),
                              tag="13f(b)")
    out["dg_full"] = to_host(res)
    del gs, st, res
    gc.collect()
    torch.cuda.empty_cache()
    out["dg_full_mixed"] = to_host(grid_shard_run(
        dev, port, mesh_dev, "dg_full_mixed", 1, warmup=1, tag="13f"))
    return out


def load_phase7b_ref(path: str, timeout: float = 600.0) -> dict:
    """Phase 7b's f64 reference, once the main process has written it."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout:
            fail(f"13f: phase 7b's reference {path} never appeared")
        time.sleep(0.5)
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def grid_shard_dg_phase(dev, port, scratch_dir) -> dict:
    """Phase 13f: GridShardedProblem with DG-1 T on the card. Three
    processes start at once: one NCCL rank and two gloo ranks, each
    running (a) the small plates and (b) phase 7b's 64x64x16 plate (the
    one rank's timed window after the two ranks'), while this process
    runs (a)'s plates unsharded. (a) is held to the unsharded runs at JAX's
    tolerances (tests/test_grid_dg.py: T 1e-9 and sigma 1e-8 of their max,
    1e-5 with mechanics; sharded CG at most 2x + 8) and the two ranks to
    the one (Newton equal, T max-rel 1e-12); (b) to phase 7b's f64 run
    (PHASE7B_REF in `scratch_dir`: T 1e-9 of its max, the mixed run's
    within 7b's 5e-3 K; Newton within one a step, CG at most 2x + 8), and
    the two ranks to the one."""
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks
    t_phase = time.perf_counter()
    go = tempfile.mkdtemp(prefix="fgt_13f_")
    io_root = tempfile.mkdtemp(prefix="io_13f_", dir=scratch_dir)
    try:
        with ThreadPoolExecutor(2) as ex:
            job_two = ex.submit(run_ranks, grid_shard_dg_rank, GS_RANKS, dev,
                                go, io_root, backend="gloo", timeout=900)
            job_one = ex.submit(run_ranks, grid_shard_dg_one, 1, dev, go,
                                io_root, backend="nccl", timeout=900)
            unsharded = {}
            for name, steps in GSDG_SMALL:
                make_mesh, cfg, _ = gs_cases()[name]
                prob = ThermoViscoProblem(mesh=make_mesh(), config=cfg,
                                          device=dev)
                prob.setup()
                st, ok, ni, ki = prob.multi_step(prob.state, steps)
                if not ok:
                    fail(f"13f {name}: the unsharded run did not converge")
                unsharded[name] = dict(
                    newton=ni, cg=ki,
                    **{f: getattr(st, f).cpu().numpy() for f in GS_FIELDS})
                del prob, st
            try:
                ranks = job_two.result()
            finally:
                # a failed pair must not leave the one rank waiting
                open(os.path.join(go, "dg_full"), "a").close()
            one = job_one.result()[0]
    finally:
        shutil.rmtree(go, ignore_errors=True)
        shutil.rmtree(io_root, ignore_errors=True)
    processes_s = time.perf_counter() - t_phase

    def rel_max(a, b):
        return float(np.abs(a - b).max() / max(float(np.abs(b).max()),
                                                1e-30))

    # ---- (a) the small plates ----
    a = {}
    for name, _ in GSDG_SMALL:
        un = unsharded[name]
        s_band = 1e-5 if name == "dg_mech" else 1e-8
        rows = []
        for who, got in [("one", one[name])] + [
                (f"rank {r}", rk[name]) for r, rk in enumerate(ranks)]:
            row = dict(newton=got["newton"], cg=got["cg"],
                       T=rel_max(got["T"], un["T"]),
                       sigma=rel_max(got["sigma"], un["sigma"]))
            if not (row["T"] <= 1e-9 and row["sigma"] <= s_band
                    and got["cg"] <= 2 * un["cg"] + 8):
                fail(f"13f {name} {who} against the unsharded run "
                     f"({un['newton']} / {un['cg']}): {json.dumps(row)}")
            rows.append(row)
        two_rel = max_rel(ranks[0][name]["T"], one[name]["T"])
        # under mixed precision the f32 CG's dots sum in another order on
        # two ranks, and a Newton test at rtol 1e-12 may take one more
        # iteration or one fewer (23 against 22 on a CPU at 32x32x8, 22
        # against 23 on an H100; JAX's on 2 devices 22): one apart there,
        # equal elsewhere
        slack = 1 if name == "dg_dryrun_mixed" else 0
        if any(abs(rk[name]["newton"] - one[name]["newton"]) > slack
               for rk in ranks) or not two_rel <= 1e-12:
            fail(f"13f {name}: two ranks against one, Newton "
                 f"{[rk[name]['newton'] for rk in ranks]} / "
                 f"{one[name]['newton']}, T max-rel {two_rel:.3e}")
        a[name] = dict(unsharded_newton_cg=[un["newton"], un["cg"]],
                       one_and_ranks=rows, two_vs_one_T_max_rel=two_rel)
    # ---- (b) the plate, against phase 7b ----
    ref = load_phase7b_ref(os.path.join(scratch_dir, PHASE7B_REF))
    n7, c7 = float(ref["newton_per_step"]), float(ref["cg_per_step"])
    b = {}
    for who, got in [("one", one["dg_full"]),
                     ("one_mixed", one["dg_full_mixed"])] + [
            (f"rank{r}", rk["dg_full"]) for r, rk in enumerate(ranks)]:
        dT = float(np.abs(got["T"] - ref["T"]).max())
        row = dict(newton_per_step=got["newton_per_step"],
                   cg_per_step=got["cg_per_step"], newton_cg_7b=[n7, c7],
                   T_max_abs_K=dT, T_rel_max=dT / float(
                       np.abs(ref["T"]).max()))
        band_ok = (dT <= 5e-3 if who == "one_mixed"
                   else row["T_rel_max"] <= 1e-9)
        if not (band_ok and abs(got["newton_per_step"] - n7) <= 1
                and got["cg_per_step"] <= 2 * c7 + 8):
            fail(f"13f(b) {who} against phase 7b: {json.dumps(row)}")
        b[who] = row
    two = ranks[0]["dg_full"]
    rel = max_rel(two["T"], one["dg_full"]["T"])
    if (two["newton"] != one["dg_full"]["newton"] or not rel <= 1e-12
            or ranks[1]["dg_full"]["newton"] != two["newton"]
            or not np.array_equal(ranks[1]["dg_full"]["T"], two["T"])):
        fail(f"13f(b): two ranks {two['newton']} / {two['cg']} against one "
             f"{one['dg_full']['newton']} / {one['dg_full']['cg']}, T "
             f"max-rel {rel:.3e}")
    io = [one["dg_full"]["io"]] + [r["dg_full"]["io"] for r in ranks]
    if len({x["solve_newton"] for x in io}) != 1:
        fail(f"13f(b) output: the runs disagree "
             f"({[x['solve_newton'] for x in io]} Newton)")

    def summary(res):
        return {k: v for k, v in res.items() if k not in GS_FIELDS}
    out = dict(
        a=dict(holds=a, ranks=[{n: summary(rk[n]) for n, _ in GSDG_SMALL}
                               for rk in ranks],
               world_size_1={n: summary(one[n]) for n, _ in GSDG_SMALL}),
        b=dict(holds=b, world_size_1=summary(one["dg_full"]),
               world_size_1_mixed=summary(one["dg_full_mixed"]),
               ranks=[summary(r["dg_full"]) for r in ranks],
               two_vs_one_T_max_rel=rel),
        processes_s=processes_s, ranks_a_s=[r["a_s"] for r in ranks],
        ranks_b_s=[r["b_s"] for r in ranks])
    out["s"] = time.perf_counter() - t_phase
    log("grid sharded DG " + json.dumps(out))
    return out


def grid_shard_dg_launches(gsdg: dict, name: str) -> dict:
    """A kernel's launches in phase 13f's counted windows, per rank."""
    out = {}
    for case, _ in GSDG_SMALL:
        out[f"{case}_world_size_1"] = gsdg["a"]["world_size_1"][case][
            "launches"][name]
        out[f"{case}_ranks"] = [r[case]["launches"][name]
                                for r in gsdg["a"]["ranks"]]
    b = gsdg["b"]
    out["dg_full_world_size_1"] = b["world_size_1"]["launches"][name]
    out["dg_full_mixed_world_size_1"] = b["world_size_1_mixed"][
        "launches"][name]
    out["dg_full_ranks"] = [r["launches"][name] for r in b["ranks"]]
    if name in ("material_tspace", "stencil_matvec_halo"):
        for run in ("solve", "resumed"):
            out[f"dg_full_io_{run}_world_size_1"] = b["world_size_1"]["io"][
                f"{run}_launches"][name]
            out[f"dg_full_io_{run}_ranks"] = [
                r["io"][f"{run}_launches"][name] for r in b["ranks"]]
    return out


# ----------------------------------------------------------------------
# phase 13g: the grid-sharded CG-2 step (a side phase in 13f's processes)
# JAX's tests/test_grid2.py:237 plate (6x4x3 of 1 x 0.7 x 0.01)
GSQ2_PLATE = (6, 4, 3, 1.0, 0.7, 0.01)
GSQ2_SMALL = (("q2_plate", 2), ("q2_mixed", 2), ("q2_dryrun", 2))
# 13g(b)'s T and counts after step 1 of phase 9b's plate, one file a rank
# count ("one", "two"), which phase 9b holds to its warm-up step
PHASE13G_REF = "phase13g_{}.npz"
# 13g(b)'s bands: T max-rel against 9b's warm-up step (its coarse chain
# is GeometricMG, the sharded step's JAX's GridMG over a padded node
# grid: the same cycle, f32 sums in another order) and the two gloo
# ranks against the one NCCL rank (13d's f32 precedent); CG within 2% of
# 9b's
GSQ2_BANDS = {"9b": 1e-5, "one": 1e-6}


def gsq2_config(tc, rtol=1e-12, cg_dtype="same"):
    """JAX's tests/test_grid2.py:237 config (f64, rtol 1e-12, Chebyshev
    coarse chain under the line-smoothed Q2MG; the dry run's "gspmd-q2"
    at rtol 1e-10), 2 steps, optionally with the f32 twins."""
    return tc.RunConfig(
        fe=tc.FEConfig(T_family="CG", T_degree=2, sigma_family="CG",
                       sigma_degree=1),
        time=tc.TimeConfig(0.0, 0.2, 0.1),
        solver=tc.SolverConfig(newton_rtol=rtol, newton_atol=1e-10,
                               cg_rtol=rtol, cg_max_it=300,
                               linear_operator="stencil",
                               preconditioner="mg", mg_smoother="chebyshev",
                               cg_dtype=cg_dtype),
        output=tc.OutputConfig(write_every=0, formats=()), dtype="float64")


def write_phase13g_ref(scratch_dir, who, res) -> None:
    """13g(b)'s T (the whole lattice) and counts after step 1."""
    path = os.path.join(scratch_dir, PHASE13G_REF.format(who))
    np.savez(path + ".tmp.npz", T=res["T"], newton=res["newton"],
             cg=res["cg"])
    os.replace(path + ".tmp.npz", path)


def grid_shard_q2_b(mesh_dev, port, io_root, who, scratch_dir,
                    before=None) -> dict:
    """13g(b) on this rank: phase 9b's plate, 1 + 1 steps, its T after
    step 1 written for 9b (rank 0), K2's halo form on its coarse chain's
    fine level, and the output (grid_shard_io, `io_root`/`who`)."""
    res = grid_shard_run(mesh_dev.device, port, mesh_dev, "q2_full", 1,
                         warmup=1, keep=True, before=before, tag="13g")
    gs, st = res.pop("problem"), res.pop("state")
    if mesh_dev.rank == 0:
        write_phase13g_ref(scratch_dir, who, to_host(res))
    res["k2_halo"] = k2_halo_level_check(gs, st, port, tag="13g")
    res["io"] = grid_shard_io(gs, st, port, os.path.join(io_root, who),
                              tag="13g(b)")
    del gs, st
    return to_host(res)


def grid_shard_q2_rank(mesh_dev, go, io_root, scratch_dir) -> dict:
    """Phase 13g on one of the two gloo ranks: (a) the small plates, (b)
    phase 9b's plate; rank 0 creates the file `go`/q2_full when (b) is
    over."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, port = mesh_dev.device, rank_port()
    t0 = time.perf_counter()
    out = {name: to_host(grid_shard_run(dev, port, mesh_dev, name, steps,
                                        tag="13g"))
           for name, steps in GSQ2_SMALL}
    out["a_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    try:
        out["q2_full"] = grid_shard_q2_b(mesh_dev, port, io_root, "two",
                                         scratch_dir)
    finally:
        if mesh_dev.rank == 0:
            open(os.path.join(go, "q2_full"), "a").close()
    out["b_s"] = time.perf_counter() - t1
    out["s"] = time.perf_counter() - t0
    return out


def grid_shard_q2_one(mesh_dev, go, io_root, scratch_dir) -> dict:
    """Phase 13g over one NCCL rank, in a process of its own that sets up
    while the two gloo ranks run: (a) the small plates, then (b) phase
    9b's plate, its timed window after the two ranks' (the file
    `go`/q2_full)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev, port = mesh_dev.device, rank_port()
    out = {name: to_host(grid_shard_run(dev, port, mesh_dev, name, steps,
                                        tag="13g"))
           for name, steps in GSQ2_SMALL}
    out["q2_full"] = grid_shard_q2_b(
        mesh_dev, port, io_root, "one", scratch_dir, before=lambda: wait_for(
            go, "q2_full", "the two ranks' (b)"))
    return out


def grid_shard_q2_phase(dev, port, scratch_dir) -> dict:
    """Phase 13g: GridShardedProblem with CG-2 T on the card. Three
    processes start at once: one NCCL rank and two gloo ranks, each
    running (a) the small plates and (b) phase 9b's 64x64x16 plate (the
    one rank's timed window after the two ranks'), while this process
    runs (a)'s plates unsharded. (a) is held to the unsharded runs at
    tests/test_grid2.py:237's tolerances (T 1e-9 and sigma 1e-8 of their
    max; sharded CG at most 2x + 8) and the two ranks to the one (Newton
    equal, one apart in mixed precision; T max-rel 1e-12); (b)'s two
    ranks to the one (GSQ2_BANDS; Newton equal); phase 9b holds (b)'s
    step 1 to its warm-up step (PHASE13G_REF in `scratch_dir`)."""
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks
    t_phase = time.perf_counter()
    go = tempfile.mkdtemp(prefix="fgt_13g_")
    io_root = tempfile.mkdtemp(prefix="io_13g_", dir=scratch_dir)
    try:
        with ThreadPoolExecutor(2) as ex:
            job_two = ex.submit(run_ranks, grid_shard_q2_rank, GS_RANKS, dev,
                                go, io_root, scratch_dir, backend="gloo",
                                timeout=900)
            job_one = ex.submit(run_ranks, grid_shard_q2_one, 1, dev, go,
                                io_root, scratch_dir, backend="nccl",
                                timeout=900)
            unsharded = {}
            for name, steps in GSQ2_SMALL:
                make_mesh, cfg, _ = gs_cases()[name]
                prob = ThermoViscoProblem(mesh=make_mesh(), config=cfg,
                                          device=dev)
                prob.setup()
                st, ok, ni, ki = prob.multi_step(prob.state, steps)
                if not ok:
                    fail(f"13g {name}: the unsharded run did not converge")
                unsharded[name] = dict(
                    newton=ni, cg=ki,
                    **{f: getattr(st, f).cpu().numpy() for f in GS_FIELDS})
                del prob, st
            try:
                ranks = job_two.result()
            finally:
                # a failed pair must not leave the one rank waiting
                open(os.path.join(go, "q2_full"), "a").close()
            one = job_one.result()[0]
    finally:
        shutil.rmtree(go, ignore_errors=True)
        shutil.rmtree(io_root, ignore_errors=True)
    processes_s = time.perf_counter() - t_phase

    def rel_max(a, b):
        return float(np.abs(a - b).max() / max(float(np.abs(b).max()),
                                                1e-30))

    # ---- (a) the small plates ----
    a = {}
    for name, _ in GSQ2_SMALL:
        un = unsharded[name]
        rows = []
        for who, got in [("one", one[name])] + [
                (f"rank {r}", rk[name]) for r, rk in enumerate(ranks)]:
            row = dict(newton=got["newton"], cg=got["cg"],
                       T=rel_max(got["T"], un["T"]),
                       sigma=rel_max(got["sigma"], un["sigma"]))
            if not (row["T"] <= 1e-9 and row["sigma"] <= 1e-8
                    and got["cg"] <= 2 * un["cg"] + 8):
                fail(f"13g {name} {who} against the unsharded run "
                     f"({un['newton']} / {un['cg']}): {json.dumps(row)}")
            rows.append(row)
        two_rel = max_rel(ranks[0][name]["T"], one[name]["T"])
        # as 13f: a mixed Newton test at rtol 1e-12 may take one more
        # iteration or one fewer on two ranks (the f32 CG's dots sum in
        # another order)
        slack = 1 if name == "q2_mixed" else 0
        if any(abs(rk[name]["newton"] - one[name]["newton"]) > slack
               for rk in ranks) or not two_rel <= 1e-12:
            fail(f"13g {name}: two ranks against one, Newton "
                 f"{[rk[name]['newton'] for rk in ranks]} / "
                 f"{one[name]['newton']}, T max-rel {two_rel:.3e}")
        a[name] = dict(unsharded_newton_cg=[un["newton"], un["cg"]],
                       one_and_ranks=rows, two_vs_one_T_max_rel=two_rel)
    # ---- (b) the plate: the two ranks against the one (9b holds both) ----
    two = ranks[0]["q2_full"]
    rel = max_rel(two["T"], one["q2_full"]["T"])
    if (two["newton"] != one["q2_full"]["newton"]
            or not rel <= GSQ2_BANDS["one"]
            or ranks[1]["q2_full"]["newton"] != two["newton"]
            or not np.array_equal(ranks[1]["q2_full"]["T"], two["T"])):
        fail(f"13g(b): two ranks {two['newton']} / {two['cg']} against one "
             f"{one['q2_full']['newton']} / {one['q2_full']['cg']}, T "
             f"max-rel {rel:.3e}")
    io = [one["q2_full"]["io"]] + [r["q2_full"]["io"] for r in ranks]
    if len({x["solve_newton"] for x in io}) != 1:
        fail(f"13g(b) output: the runs disagree "
             f"({[x['solve_newton'] for x in io]} Newton)")

    def summary(res):
        return {k: v for k, v in res.items() if k not in GS_FIELDS}
    out = dict(
        a=dict(holds=a, ranks=[{n: summary(rk[n]) for n, _ in GSQ2_SMALL}
                               for rk in ranks],
               world_size_1={n: summary(one[n]) for n, _ in GSQ2_SMALL}),
        b=dict(world_size_1=summary(one["q2_full"]),
               ranks=[summary(r["q2_full"]) for r in ranks],
               two_vs_one_T_max_rel=rel),
        processes_s=processes_s, ranks_a_s=[r["a_s"] for r in ranks],
        ranks_b_s=[r["b_s"] for r in ranks])
    out["s"] = time.perf_counter() - t_phase
    log("grid sharded CG-2 " + json.dumps(out))
    return out


def hold_phase13g(scratch_dir, T, newton, cg) -> dict:
    """Phase 9b's warm-up step (T, its counts) against 13g(b)'s step 1 on
    one NCCL rank and on two gloo ranks (PHASE13G_REF): T max-rel
    GSQ2_BANDS["9b"], Newton equal, CG within 2%."""
    out = {}
    for who in ("one", "two"):
        path = os.path.join(scratch_dir, PHASE13G_REF.format(who))
        if not os.path.exists(path):
            fail(f"9b: 13g(b)'s {who} file {path} is missing")
        with np.load(path) as z:
            got = {k: z[k] for k in z.files}
        row = dict(newton=int(got["newton"]), cg=int(got["cg"]),
                   newton_cg_9b=[newton, cg],
                   T_max_rel=max_rel(got["T"], T))
        if not (row["T_max_rel"] <= GSQ2_BANDS["9b"] and row["newton"] ==
                newton and abs(row["cg"] - cg) <= 0.02 * cg):
            fail(f"9b against 13g(b) {who}: {json.dumps(row)}")
        out[who] = row
    return out


def grid_shard_q2_launches(gsq2: dict, name: str) -> dict:
    """A kernel's launches in phase 13g's counted windows, per rank."""
    out = {}
    for case, _ in GSQ2_SMALL:
        out[f"{case}_world_size_1"] = gsq2["a"]["world_size_1"][case][
            "launches"][name]
        out[f"{case}_ranks"] = [r[case]["launches"][name]
                                for r in gsq2["a"]["ranks"]]
    b = gsq2["b"]
    out["q2_full_world_size_1"] = b["world_size_1"]["launches"][name]
    out["q2_full_ranks"] = [r["launches"][name] for r in b["ranks"]]
    if name in ("material_tspace", "stencil_matvec_halo"):
        for run in ("solve", "resumed"):
            out[f"q2_full_io_{run}_world_size_1"] = b["world_size_1"]["io"][
                f"{run}_launches"][name]
            out[f"q2_full_io_{run}_ranks"] = [
                r["io"][f"{run}_launches"][name] for r in b["ranks"]]
    return out


# ----------------------------------------------------------------------
# phase 13e: the multi-process entry (parallel/multihost.py) under
# torchrun, two gloo ranks on cuda:0 (NCCL refuses two ranks on one card)
MH_PLATE = (12, 6, 3, 1.0, 1.0, 0.01)
MH_STEPS = 2


def multihost_config(tc):
    """JAX's tests/test_multihost.py config: f64, the default solver on the
    stencil operator, no output."""
    return tc.RunConfig(fe=tc.FEConfig(T_family="CG", T_degree=1),
                        time=tc.TimeConfig(0.0, MH_STEPS * 0.1, 0.1),
                        solver=tc.SolverConfig(linear_operator="stencil"),
                        output=tc.OutputConfig(write_every=0, formats=()))


def multihost_rank(out_path: str) -> int:
    """Phase 13e's rank, started by torchrun: multihost.initialize (gloo,
    cuda:0), make_multihost_problem on the 12x6x3 plate, MH_STEPS steps
    with K1 and K2's launches counted, gather_to_host; rank 0 saves T
    (ghost planes dropped), the counts and the launches to `out_path`."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.parallel import multihost
    setup_device()
    port = rank_port()
    mesh_dev = multihost.initialize(backend="gloo", local_device_ids=[0])
    try:
        sp = multihost.make_multihost_problem(box_mesh_3d(*MH_PLATE),
                                              multihost_config(tc))
        state0 = sp.init_state()
        torch.cuda.synchronize()
        reset_counts(port)
        st, ok, ni, ki = sp.run(state0, MH_STEPS)
        torch.cuda.synchronize()
        launches = dict(read_counts(port), stencil_matvec_halo=port[
            "stencil_matvec_halo"].launches)
        g = multihost.gather_to_host(st)
        if mesh_dev.rank == 0:
            np.savez(out_path, T=g.T[:sp.fs_T.n_scalar_dofs], ok=ok,
                     newton=ni, cg=ki, world=mesh_dev.size,
                     device=str(mesh_dev.device), backend=mesh_dev.backend,
                     padded_rows=g.T.shape[0], launches=json.dumps(launches),
                     k2_per_apply=json.dumps(k2_forms_per_apply(sp)))
    finally:
        mesh_dev.close()
    return 0


def multihost_phase(dev) -> dict:
    """Phase 13e (a side phase: it times nothing): `python -m
    torch.distributed.run --standalone --nproc-per-node 2 chip_smoke.py
    --multihost-rank OUT` (multihost_rank) while this process runs the
    unsharded ThermoViscoProblem on the card; T of the two ranks within
    1e-11 of it (max |dT| / max |T|, JAX's tests/test_multihost.py
    bound), K1 once a step and K2's halo form 31 a Newton or CG iteration
    on rank 0, no full-grid K2."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="fgt_13e_")
    out_path = os.path.join(work, "rank0.npz")
    log_path = os.path.join(work, "torchrun.log")
    with open(log_path, "w") as log_fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(GS_RANKS), os.path.abspath(__file__),
             "--multihost-rank", out_path],
            stdout=log_fh, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            prob = ThermoViscoProblem(mesh=box_mesh_3d(*MH_PLATE),
                                      config=multihost_config(tc),
                                      device=dev)
            prob.setup()
            st, ok, ni, ki = prob.multi_step(prob.state, MH_STEPS)
            T_ref = st.T.cpu().numpy()
            del prob, st
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    with open(log_path) as fh:
        tail = fh.read()[-3000:]
    if not ok:
        fail("13e: the unsharded run did not converge")
    if rc != 0 or not os.path.exists(out_path):
        fail(f"13e: torchrun exited with code {rc}:\n{tail}")
    got = dict(np.load(out_path))
    shutil.rmtree(work, ignore_errors=True)
    launches = json.loads(str(got["launches"]))
    per = json.loads(str(got["k2_per_apply"]))
    n_it = int(got["newton"]) + int(got["cg"])
    rel = float(np.abs(got["T"] - T_ref).max() / np.abs(T_ref).max())
    want = dict(material_tspace=MH_STEPS, stencil_matvec=per["full"] * n_it,
                stencil_matvec_halo=per["halo"] * n_it, dg_cell_residual=0)
    out = dict(world=int(got["world"]), device=str(got["device"]),
               backend=str(got["backend"]),
               padded_rows=int(got["padded_rows"]),
               newton=int(got["newton"]), cg=int(got["cg"]),
               unsharded_newton_cg=[ni, ki], T_rel=rel,
               launches_rank0=launches, k2_per_apply=per,
               s=time.perf_counter() - t0)
    if not bool(got["ok"]) or out["world"] != GS_RANKS or \
            out["backend"] != "gloo" or not rel < 1e-11 or \
            launches != want:
        fail(f"13e: {json.dumps(out)} (launches expected {want})\n{tail}")
    log("multihost " + json.dumps(out))
    return out


def grid_shard_launches(gs: dict, dry64: dict, name: str) -> dict:
    """A kernel's launches in phase 13d's and 13d64's counted windows, per
    rank."""
    out = {f"{case}_ranks": [r[case]["launches"][name]
                             for r in gs["a"]["ranks"]]
           for case in ("small", "dryrun")}
    out["dryrun_mech_world_size_1"] = gs["a"]["dryrun_mech_world_size_1"][
        "launches"][name]
    out["dryrun_mech64_world_size_1"] = dry64["world_size_1"]["launches"][
        name]
    out["dryrun_mech64_ranks"] = [r["launches"][name]
                                  for r in dry64["ranks"]]
    for part, case in (("b", "plate"), ("c", "mech_plate")):
        out[f"{case}_world_size_1"] = gs[part]["world_size_1"]["launches"][
            name]
        out[f"{case}_ranks"] = [r["launches"][name]
                                for r in gs[part]["ranks"]]
    if name != "stencil_matvec":
        # 13d(b)'s output: the chunked solve and the resumed run(1)
        io = gs["b"]["io"]
        for run in ("solve", "resumed"):
            out[f"plate_io_{run}_world_size_1"] = io["world_size_1"][
                f"{run}_launches"][name]
            out[f"plate_io_{run}_ranks"] = [
                r[f"{run}_launches"][name] for r in io["ranks"]]
    return out


def distributed_launches(dist: dict, name: str) -> dict:
    """A kernel's launches in phase 13's counted windows, per rank."""
    out = {}
    for part in ("a", "b", "c"):
        for case, res in dist[part].items():
            for who in ("unsharded", "world_size_1"):
                if who in res:
                    out[f"{case}_{who}"] = res[who]["launches"][name]
            out[f"{case}_ranks"] = [r["launches"][name] for r in res["ranks"]]
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


def csr_library_ms(vals2, x, grid, halo=False):
    """One PyTorch call that computes K2's function: a CSR sparse matrix
    holding the same 27 entries per row, times x -> (ms, its y). `halo`:
    K2's halo form, x over the rows' planes and one more on each side."""
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
                r, c = i + dx - (0 if halo else 1), m + s
                ok = (c >= 0) & (c < M)
                if not halo:
                    ok &= (r >= 0) & (r < gx)
                rows.append(idx[ok])
                cols.append((r * M + c)[ok])
                vs.append(vals2[o].reshape(-1)[ok])
                o += 1
    A = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                             torch.cat(cols)]),
                                torch.cat(vs), (n, x.numel())).coalesce()
    A = A.to_sparse_csr()
    del rows, cols, vs
    y = (A @ x[:, None])[:, 0]
    torch.cuda.synchronize()
    return time_ms(lambda: A @ x[:, None], reps=20), y


def load_port() -> dict:
    """The kernels' wrappers and plain versions, by name."""
    from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
        PreparedDGCellResidual,
        dg_cell_residual,
        dg_cell_residual_reference,
    )
    from fem_glass_tempering_tpu_torch.ops.cuda_kernels import (
        material_tspace,
        material_tspace_reference,
    )
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
        stencil_matvec,
        stencil_matvec_halo,
        stencil_matvec_reference,
    )
    return dict(PreparedDGCellResidual=PreparedDGCellResidual,
                stencil_matvec_halo=stencil_matvec_halo,
                dg_cell_residual=dg_cell_residual,
                dg_cell_residual_reference=dg_cell_residual_reference,
                material_tspace=material_tspace,
                material_tspace_reference=material_tspace_reference,
                stencil_matvec=stencil_matvec,
                stencil_matvec_reference=stencil_matvec_reference)


def setup_device() -> torch.device:
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


# The side processes' phases, a group a process (see the docstring): each
# group's card work is small beside the main process's plates, and each
# group takes about as long as what the main process runs meanwhile
# (6a: phase 6's 8x8x4 parity runs; 7a: phase 7's; 13d64 fills the
# first group's slack, and 13e after it).
SIDE_GROUPS = (("5", "12b", "12c", "12d", "12e", "13d64", "13e"),
               ("6a", "7a", "8a"),
               ("13", "11", "9a", "10a"),
               ("13f", "13g"))


def side_phases(names, t0_epoch, scratch_dir, warmup, k2_per_apply) -> dict:
    """Run phases `names` in this process -> {"results": {name: phase
    result}, "ends": {name: seconds since the main process's kernel
    build began}}. The kernel library is the one phase 1 built; phase 11
    holds the command line to phase 4's warm-up chunk (`warmup`, and K2's
    launches an apply, `k2_per_apply`)."""
    global LOG_PREFIX
    LOG_PREFIX = f"[side {','.join(names)}] "
    from fem_glass_tempering_tpu_torch.ops import kernel_lib

    dev = setup_device()
    kernel_lib.library()
    port = load_port()
    phases = {
        "5": lambda: default_workload_phase(dev, port, scratch_dir),
        "6a": lambda: dg_parity_phase(dev),
        "7a": lambda: dg_auto_parity_phase(dev),
        "8a": lambda: mechanics_parity_phase(dev, port),
        "9a": lambda: cg2_parity_phase(dev, port),
        "10a": lambda: degree2_parity_phase(dev, port),
        "11": lambda: cli_phase(dev, port, warmup, k2_per_apply,
                                scratch_dir),
        "12b": lambda: bf16_parity_phase(dev, port),
        "12c": lambda: forms_phase(dev, port),
        "12d": lambda: solve_scan_phase(dev, port),
        "12e": lambda: native_phase(dev, scratch_dir),
        "13": lambda: distributed_phase(dev, port),
        "13d64": lambda: dryrun64_phase(dev, port),
        "13e": lambda: multihost_phase(dev),
        "13f": lambda: grid_shard_dg_phase(dev, port, scratch_dir),
        "13g": lambda: grid_shard_q2_phase(dev, port, scratch_dir),
    }
    out, ends = {}, {}
    for name in names:
        drop_garbage(f"phase {name}")
        out[name] = phases[name]()
        ends[name] = round(time.time() - t0_epoch, 1)
        log(f"phase {name} ends at {ends[name]} s")
    return dict(results=out, ends=ends)


def _side_main(results, args) -> None:
    # SIGTERM from the main process unwinds, so that phase 13's own rank
    # processes are stopped by run_ranks on the way out
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(1))
    try:
        results.put((True, side_phases(*args)))
    except BaseException:
        results.put((False, traceback.format_exc()))
        raise


class Side:
    """A side process (the spawn start method, no process group) running
    side_phases(*args); `result()` waits for its result and raises with
    its traceback if it failed, `stop()` ends it if it still runs. Not
    parallel.comm.run_ranks: a rank there holds a process group, which
    phase 13's own NCCL group of one cannot join, and is daemonic, so it
    cannot start phase 13's gloo ranks."""

    def __init__(self, *args):
        ctx = mp.get_context("spawn")
        self.names = args[0]
        self.results = ctx.Queue()
        self.proc = ctx.Process(target=_side_main, args=(self.results, args))
        # up to six processes share the host's cores while the sides run:
        # an idle OpenMP thread of a side (and of phase 13's ranks) sleeps
        # at once instead of spinning, which leaves the arithmetic as it is
        before = os.environ.get("OMP_WAIT_POLICY")
        os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
        try:
            self.proc.start()
        finally:
            if before is None:
                del os.environ["OMP_WAIT_POLICY"]
            else:
                os.environ["OMP_WAIT_POLICY"] = before

    def result(self, timeout: float = 900.0) -> dict:
        deadline = time.monotonic() + timeout
        while True:
            try:
                ok, payload = self.results.get(timeout=1.0)
                break
            except queue.Empty:
                if self.proc.exitcode is not None:
                    fail(f"side process {self.names} exited with code "
                         f"{self.proc.exitcode} and no result")
                if time.monotonic() > deadline:
                    fail(f"side process {self.names} still running after "
                         f"{timeout} s")
        if not ok:
            fail(f"side process {self.names} failed:\n{payload}")
        self.proc.join(timeout=60)
        return payload

    def stop(self) -> None:
        self.proc.join(timeout=5)        # a failed side is on its way out
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join(timeout=30)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="trace 5 full-size steps with torch.profiler and "
                         "write DIR/profile.txt")
    ap.add_argument("--multihost-rank", metavar="OUT",
                    help="run one rank of phase 13e (under torchrun) and "
                         "write rank 0's result to OUT")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.multihost_rank:
        return multihost_rank(args.multihost_rank)
    from fem_glass_tempering_tpu_torch.ops import kernel_lib
    port = load_port()
    stencil_matvec = port["stencil_matvec"]
    stencil_matvec_reference = port["stencil_matvec_reference"]
    if torch.cuda.device_count() < 1:
        fail("no CUDA device")
    dev = setup_device()
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    # seconds since the build started at the end of each phase: what a
    # later phase may spend within the script's time limit
    t0 = time.perf_counter()
    t0_epoch = time.time()
    ends = {}

    def phase_end(name):
        ends[name] = round(time.perf_counter() - t0, 1)
        log(f"phase {name} ends at {ends[name]} s")

    lib = kernel_lib.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {lib.build_seconds:.1f} s) -> {lib.path}")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  " + line.strip())
    phase_end("1")

    # ---- phase 2: kernels against their plain versions ----
    k1 = check_material_tspace(dev, port)
    k2_small = []
    for grid in ((9, 7, 5), (12, 6, 3), (10, 8)):
        v2, x = stencil_case(grid, torch.float64, dev)
        k2_small.append(check_stencil(v2, x, grid, 1e-12, port))
    log(f"K2 zero-at-missing-neighbour grids f64 max |diff| {k2_small}")
    k3 = check_dg_cell(dev, port)
    k3_d2 = check_dg_cell_degree2(dev, port)
    phase_end("2")

    # ---- phase 3: parity of the whole path, GPU vs CPU ----
    parity_phase(dev)
    phase_end("3")

    # ---- phase 4: the full-size main path ----
    drop_garbage("phase 4")
    full = full_size_phase(dev, port, args.profile)
    vals2, x, grid = full.pop("vals_fine"), full.pop("x_fine"), full.pop("grid")
    full.pop("state")
    warmup = full.pop("warmup")
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
    phase_end("4")

    # ---- the side processes (SIDE_GROUPS) ----
    scratch_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "build", "chip_smoke")
    os.makedirs(scratch_dir, exist_ok=True)
    drop_garbage("the side processes")
    sides = []
    try:
        for names in SIDE_GROUPS:
            sides.append(Side(names, t0_epoch, scratch_dir, warmup,
                              full["stencil_launches_per_apply"]))

        # ---- phase 6: the DG-1 plate on SA-AMG ----
        plate = dg_plate_phase(dev, port)
        phase_end("6")

        # ---- phase 7b: the DG-1 plate through "auto" (DG p-multigrid) ----
        drop_garbage("phase 7b")
        dg_auto = dg_auto_plate_phase(
            dev, port, os.path.join(scratch_dir, PHASE7B_REF))
        phase_end("7")

        # ---- phase 8b: equilibrium mechanics at full width ----
        drop_garbage("phase 8b")
        mech = mechanics_plate_phase(dev, port)
        mech_ref = mech.pop("reference")
        phase_end("8b")

        # ---- phase 10b, 10c: the gather path, the mixed twins ----
        drop_garbage("phase 10b")
        gather = gather_plate_phase(dev, port)
        phase_end("10b")
        drop_garbage("phase 10c")
        mixed = mixed_plate_phase(dev, port)
        phase_end("10c")

        side = {}
        for sp in sides:
            res = sp.result()
            side.update(res["results"])
            ends.update(res["ends"])
    finally:
        for sp in sides:
            sp.stop()
    phase_end("sides")
    default, dg_auto_parity = side["5"], side["7a"]
    mech_parity, cg2_parity = side["8a"], side["9a"]
    d2_parity, cli, dist = side["10a"], side["11"], side["13"]
    bf16_parity, forms, scan = side["12b"], side["12c"], side["12d"]
    native_rt, dry64, multihost = side["12e"], side["13d64"], side["13e"]
    gsdg, gsq2 = side["13f"], side["13g"]

    # ---- phase 9b: the CG-2 plate on the lattice path ----
    drop_garbage("phase 9b")
    cg2 = cg2_plate_phase(dev, port, scratch_dir)
    phase_end("9b")

    # ---- phase 12a: bf16 V-cycle tables ----
    drop_garbage("phase 12a")
    bf16 = bf16_plate_phase(dev, port)
    phase_end("12a")

    # ---- phase 13d: the grid-sharded CG-1 step ----
    drop_garbage("phase 13d")
    gshard = grid_shard_phase(dev, port, mech_ref, scratch_dir)
    phase_end("13d")

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
             device_ms=k1_32["device_ms"], f64=k1["float64"],
             launches_mechanics_plate_reference_xi=mech_parity[
                 "reference"]["launches"]["material_tspace"],
             launches_mechanics_plate_trapezoid_xi=mech["launches"][
                 "material_tspace"],
             launches_cg2_plate=cg2["launches"]["material_tspace"],
             launches_cg2_gather_plate=gather["launches"]["material_tspace"],
             launches_cg2_mixed_plate=mixed["launches"]["material_tspace"],
             launches_cli_plate=cli["plate"]["launches"]["material_tspace"],
             launches_cli_default_run=cli["default"]["launches"][
                 "material_tspace"],
             launches_bf16_plate=bf16["bf16"]["launches"]["material_tspace"],
             launches_solve_scan=scan["launches_solve_scan"][
                 "material_tspace"],
             launches_distributed=distributed_launches(
                 dist, "material_tspace"),
             launches_grid_sharded=grid_shard_launches(
                 gshard, dry64, "material_tspace"),
             launches_grid_sharded_dg=grid_shard_dg_launches(
                 gsdg, "material_tspace"),
             launches_grid_sharded_q2=grid_shard_q2_launches(
                 gsq2, "material_tspace"),
             launches_multihost_rank0=multihost["launches_rank0"][
                 "material_tspace"]),
        dict(name="stencil_matvec", route="cuda",
             source="fem_glass_tempering_tpu_torch/csrc/stencil_matvec.cu",
             replaces="fem_glass_tempering_tpu/ops/pallas_stencil.py:54",
             launches=full["launches"]["stencil_matvec"],
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain, bound_ms=b,
             bound_by=by, library_ms=lib_ms, device_ms=k2_device_ms,
             launches_dg_auto_f64=dg_auto["same"]["launches"][
                 "stencil_matvec"],
             launches_dg_auto_mixed=dg_auto["float32"]["launches"][
                 "stencil_matvec"],
             launches_mechanics_plate_trapezoid_xi=mech["launches"][
                 "stencil_matvec"],
             launches_cg2_plate=cg2["launches"]["stencil_matvec"],
             launches_cg2_gather_plate=gather["launches"]["stencil_matvec"],
             launches_cg2_mixed_plate=mixed["launches"]["stencil_matvec"],
             launches_cli_plate=cli["plate"]["launches"]["stencil_matvec"],
             launches_bf16_plate_same_arm=bf16["same"]["launches"][
                 "stencil_matvec"],
             cg2_coarse_levels=cg2["k2_levels"],
             launches_distributed=distributed_launches(
                 dist, "stencil_matvec"),
             launches_grid_sharded=grid_shard_launches(
                 gshard, dry64, "stencil_matvec"),
             launches_grid_sharded_dg=grid_shard_dg_launches(
                 gsdg, "stencil_matvec"),
             launches_grid_sharded_q2=grid_shard_q2_launches(
                 gsq2, "stencil_matvec")),
        # K2's halo form (a rank's planes of the grid-sharded step, f32 /
        # f64 tables): launches of phase 13d's plate over one NCCL rank,
        # timed on the two-rank layout's first slab of its fine level
        dict(name="stencil_matvec_halo", route="cuda",
             source="fem_glass_tempering_tpu_torch/csrc/stencil_matvec.cu",
             replaces="fem_glass_tempering_tpu/ops/pallas_stencil.py:54",
             launches=gshard["b"]["world_size_1"]["launches"][
                 "stencil_matvec_halo"],
             max_abs_err=gshard["k2_halo"]["max_abs_err"],
             ms=gshard["k2_halo"]["ms"],
             plain_ms=gshard["k2_halo"]["plain_ms"],
             bound_ms=gshard["k2_halo"]["bound_ms"],
             bound_by=gshard["k2_halo"]["bound_by"],
             library_ms=gshard["k2_halo"]["library_ms"],
             device_ms=gshard["k2_halo"]["device_ms"],
             slab=gshard["k2_halo"]["slab"],
             launches_grid_sharded=grid_shard_launches(
                 gshard, dry64, "stencil_matvec_halo"),
             launches_grid_sharded_dg=grid_shard_dg_launches(
                 gsdg, "stencil_matvec_halo"),
             grid_sharded_dg_check=gsdg["b"]["world_size_1"]["k2_halo"],
             launches_grid_sharded_q2=grid_shard_q2_launches(
                 gsq2, "stencil_matvec_halo"),
             grid_sharded_q2_check=gsq2["b"]["world_size_1"]["k2_halo"],
             launches_multihost_rank0=multihost["launches_rank0"][
                 "stencil_matvec_halo"]),
        # the bf16-table instantiation of K2 (f32 vector: the mixed
        # V-cycle's), timed on the fine level's tables of the 1M-dof plate
        dict(name="stencil_matvec_bf16_tables", route="cuda",
             source="fem_glass_tempering_tpu_torch/csrc/stencil_matvec.cu",
             replaces="fem_glass_tempering_tpu/ops/pallas_stencil.py:54",
             launches=bf16["bf16"]["k2_by_table"]["bfloat16"],
             max_abs_err=bf16["k2_bf16_timed"]["float32"]["max_abs_err"],
             ms=bf16["k2_bf16_timed"]["float32"]["ms"],
             plain_ms=bf16["k2_bf16_timed"]["float32"]["plain_ms"],
             bound_ms=bf16["k2_bf16_timed"]["float32"]["bound_ms"],
             bound_by=bf16["k2_bf16_timed"]["float32"]["bound_by"],
             library_ms=bf16["k2_bf16_timed"]["float32"]["library_ms"],
             device_ms=bf16["k2_bf16_timed"]["float32"]["device_ms"],
             device_cold_ms=bf16["k2_bf16_timed"]["float32"][
                 "device_cold_ms"],
             f64_vector=bf16["k2_bf16_timed"]["float64"],
             launches_bf16_parity_plate=bf16_parity["k2_by_table_gpu"][
                 "bfloat16"],
             vcycle_launches_per_apply=bf16["k2_launches_per_vcycle"]),
        # timed at the DG plate's shape (65,536 hex cells, uniform tables,
        # f64) in the heat operator's prepared call; the library call is
        # torch.addmm on the element matrices baked from these tables
        dict(name="dg_cell_residual", route="cuda",
             source="fem_glass_tempering_tpu_torch/csrc/dg_cell_residual.cu",
             replaces="fem_glass_tempering_tpu/ops/pallas_kernels.py:218",
             launches=plate["launches"]["dg_cell_residual"],
             max_abs_err=k3["uniform"]["max_abs_err"],
             ms=k3["uniform"]["ms"], plain_ms=k3["uniform"]["plain_ms"],
             bound_ms=k3["uniform"]["bound_ms"],
             bound_by=k3["uniform"]["bound_by"],
             library_ms=k3["uniform"]["library_ms"],
             library_device_ms=k3["uniform"]["library_device_ms"],
             bound_quadrature_form_ms=k3["uniform"][
                 "bound_quadrature_form_ms"],
             device_ms=k3["uniform"]["device_ms"],
             device_cold_ms=k3["uniform"]["device_cold_ms"],
             bound_unfused_ms=k3["uniform"]["bound_unfused_ms"],
             bound_unfused_by=k3["uniform"]["bound_unfused_by"],
             direct_call_ms=k3["uniform"]["direct_call_ms"],
             direct_call_device_ms=k3["uniform"]["direct_call_device_ms"],
             plain_device_ms=k3["uniform"]["plain_device_ms"],
             host_us=k3["host_us"],
             launches_default_run=default["launches"]["dg_cell_residual"],
             launches_dg_auto_f64=dg_auto["same"]["launches"][
                 "dg_cell_residual"],
             launches_dg_auto_mixed=dg_auto["float32"]["launches"][
                 "dg_cell_residual"],
             launches_mechanics_plate_trapezoid_xi=mech["launches"][
                 "dg_cell_residual"],
             launches_cg2_plate=cg2["launches"]["dg_cell_residual"],
             launches_cg2_operator_check=cg2_parity[
                 "k3_launches_operator_check"],
             launches_cg2_gather_plate=gather["launches"][
                 "dg_cell_residual"],
             launches_per_step_cg2_gather_plate=gather[
                 "k3_launches_per_step"],
             launches_cg2_mixed_plate=mixed["launches"]["dg_cell_residual"],
             launches_cli_default_run=cli["default"]["launches"][
                 "dg_cell_residual"],
             launches_solve_scan=scan["launches_solve_scan"][
                 "dg_cell_residual"],
             launches_newton_direct=forms["direct"]["k3_launches_gpu"],
             launches_newton_direct_uniform=forms["direct_uniform"][
                 "k3_launches_gpu"],
             launches_distributed=distributed_launches(
                 dist, "dg_cell_residual"),
             launches_grid_sharded_dg=grid_shard_dg_launches(
                 gsdg, "dg_cell_residual"),
             launches_grid_sharded_q2=grid_shard_q2_launches(
                 gsq2, "dg_cell_residual"),
             launches_degree2_parity={
                 label: case["k3_launches_gpu"]
                 for label, case in d2_parity.items()},
             per_cell_tables=k3["per_cell"],
             nloc27=dict(cg2["k3_nloc27"], max_abs_err_operator_check=(
                 cg2_parity["k3_nloc27_max_abs_err"])),
             degree2=dict(k3_d2, in_path_cg2_gather_plate=gather[
                 "k3_in_path"])),
    ]
    for k in kernels:
        log(json.dumps(k))
    log("summary " + json.dumps(dict(full, sigma_chain_ms=sigma_ms,
                                     k1_f64=k1["float64"])))
    log("summary default workload " + json.dumps(default))
    log("summary DG plate " + json.dumps(plate))
    log("summary DG auto parity " + json.dumps(dg_auto_parity))
    log("summary DG auto plate " + json.dumps(dg_auto))
    log("summary mechanics parity " + json.dumps(mech_parity))
    log("summary mechanics plate " + json.dumps(mech))
    log("summary CG-2 parity " + json.dumps(cg2_parity))
    log("summary CG-2 plate " + json.dumps(cg2))
    log("summary degree-2 parity " + json.dumps(d2_parity))
    log("summary CG-2 gather plate " + json.dumps(gather))
    log("summary CG-2 mixed plate " + json.dumps(mixed))
    log("summary command line " + json.dumps(cli))
    log("summary bf16 plate " + json.dumps(bf16))
    log("summary bf16 parity " + json.dumps(bf16_parity))
    log("summary forms " + json.dumps(forms))
    log("summary solve_scan " + json.dumps(scan))
    log("summary native runtime " + json.dumps(native_rt))
    log("summary distributed " + json.dumps(dist))
    log("summary grid sharded " + json.dumps(gshard))
    log("summary multihost " + json.dumps(multihost))
    log("summary grid sharded DG " + json.dumps(gsdg))
    log("summary grid sharded CG-2 " + json.dumps(gsq2))
    log("summary phase end times, s " + json.dumps(ends))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
