"""Hand-written CUDA kernel for the variable-coefficient 3^d-point stencil
matvec, beside its plain PyTorch twin (counterpart of
fem_glass_tempering_tpu/ops/pallas_stencil.py).

stencil_matvec — y_i = sum_o vals[o]_i * x_{i+offset_o} on the CG-1 node
grid flattened to (gx, M), M = prod(grid[1:]) (kernel source
csrc/stencil_matvec.cu). It replaces
fem_glass_tempering_tpu/ops/pallas_stencil.py:stencil_matvec_pallas and is
the Jacobian action of every CG iteration and of every smoother and
residual apply of the multigrid V-cycle. Bound by device-memory bytes:
the 27 value tables plus x and y, ~123 MB per fine-level apply in f32 at
1,062,761 dofs; one thread per output, loads coalesced along the flat
axis, x read through L1/L2. The value tables may stream in bfloat16 under
an f32 or f64 vector (the V-cycle's `table_dtype`): the kernel widens each
value exactly and sums in the vector's type, 62 bytes per point with an
f32 vector; each table type is its own instantiation of the kernel, and
`stencil_matvec.launches_by_table` counts the launches of each. The bf16
instantiation is a kernel of its own: a thread takes 4 consecutive
outputs and loads each table as one 8-byte vector, so bf16 tables must
start every table on 16 bytes: `pitched_tables` casts them into such a
layout, table o at o * pitch (pitch a multiple of 8 values), as a (3^d,
gx, M) view that the plain version reads as it reads any.

stencil_matvec_halo — the same matvec over one rank's slab of planes of
a grid split along axis 0 (parallel/grid_shard.py): the rank's tables
(3^d, L, M) and x over L + 2 planes, the first and the last its
neighbours' planes (zeros where there is none), give y over its L planes,
equal bit for bit to the whole grid's rows (the same kernel source, a
template flag; f32 and f64 tables only). It counts its launches in
`stencil_matvec_halo.launches`.

The wrappers take the plain version for tensors on the CPU and launch
the kernel for CUDA tensors; anything the kernel does not take raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fem_glass_tempering_tpu_torch.ops import kernel_lib


def flat_shifts(grid_shape) -> list:
    """(row_shift, flat_column_shift) per lattice offset, lexicographic to
    match StencilMatrix's value ordering."""
    d = len(grid_shape)
    out = []
    for off in np.ndindex(*([3] * d)):
        sft = 0
        for a in range(1, d):
            sft = sft * grid_shape[a] + (int(off[a]) - 1)
        out.append((int(off[0]), sft))
    return out


# bf16 tables: the pitch's multiple, in values (16 bytes)
BF16_PITCH = 8


def pitched_tables(vals2: torch.Tensor,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """vals2 (3^d, gx, M) cast to `dtype` (as `.to(dtype)` rounds) into a
    zeroed buffer whose tables start every `pitch` values, pitch = gx M
    rounded up to a multiple of BF16_PITCH: the (3^d, gx, M) view of
    strides (pitch, M, 1) that K2's bf16 instantiation takes."""
    no, gx, M = vals2.shape
    pitch = -(-(gx * M) // BF16_PITCH) * BF16_PITCH
    buf = torch.zeros(no * pitch, dtype=dtype, device=vals2.device)
    view = buf.as_strided((no, gx, M), (pitch, M, 1))
    view.copy_(vals2)
    return view


def stencil_matvec_reference(vals2: torch.Tensor, x: torch.Tensor,
                             grid_shape) -> torch.Tensor:
    """Plain PyTorch version: pad by one row and by the widest flat shift,
    then 3^d shifted slices summed in offset order (the form of
    StencilMatrix.matvec_flat). vals2 (3^d, gx, M), x (gx*M,) -> (gx*M,).
    bfloat16 tables under an f32 or f64 x take PyTorch's promotion: each
    product widens the table value to x's dtype (exactly) and rounds in
    that dtype, as the JAX version's `vals2_bf16 * x` does."""
    gx = grid_shape[0]
    M = vals2.shape[-1]
    shifts = flat_shifts(grid_shape)
    P = max(abs(s) for _, s in shifts) if len(grid_shape) > 1 else 1
    xp = F.pad(x.reshape(gx, M), (P, P, 1, 1))
    acc = torch.zeros((gx, M), dtype=x.dtype, device=x.device)
    for o, (dx, s) in enumerate(shifts):
        acc = acc + vals2[o] * xp[dx:dx + gx, P + s:P + s + M]
    return acc.reshape(-1)


def stencil_matvec(vals2: torch.Tensor, x: torch.Tensor,
                   grid_shape) -> torch.Tensor:
    """y = A x for stencil values vals2 (3^d, gx, M) and flat x (gx*M,).
    Kernel on CUDA tensors (d = 2 or 3), plain version on CPU tensors.
    vals2 has x's dtype (contiguous), or is bfloat16 under an f32 or f64
    x, laid out as `pitched_tables` lays it out."""
    grid_shape = tuple(int(g) for g in grid_shape)
    d = len(grid_shape)
    gx = grid_shape[0]
    M = int(np.prod(grid_shape[1:])) if d > 1 else 1
    if vals2.shape != (3 ** d, gx, M) or x.shape != (gx * M,):
        raise ValueError(f"stencil_matvec: grid {grid_shape} needs vals "
                         f"({3 ** d}, {gx}, {M}) and x ({gx * M},), got "
                         f"{tuple(vals2.shape)} and {tuple(x.shape)}")
    if vals2.device.type == "cpu" and x.device.type == "cpu":
        return stencil_matvec_reference(vals2, x, grid_shape)
    if vals2.device.type != "cuda" or vals2.device != x.device:
        raise ValueError("stencil_matvec: vals and x must lie on one CUDA "
                         f"device or both on the CPU, got {vals2.device} "
                         f"and {x.device}")
    if d not in (2, 3):
        raise ValueError(f"stencil_matvec: the kernel takes d = 2 or 3, "
                         f"got {d}")
    code = kernel_lib.dtype_code(x.dtype)
    if vals2.dtype != x.dtype and vals2.dtype != torch.bfloat16:
        raise TypeError(f"stencil_matvec: vals {vals2.dtype} vs x {x.dtype}")
    table_code = 2 if vals2.dtype == torch.bfloat16 else code
    pitch = gx * M
    if table_code == 2:
        pitch = vals2.stride(0)
        if (tuple(vals2.stride()[1:]) != (M, 1) or pitch % BF16_PITCH
                or pitch < gx * M or vals2.data_ptr() % 16):
            raise ValueError(
                "stencil_matvec: bf16 tables must start every table on 16 "
                "bytes, at a pitch that is a multiple of 8 values "
                f"(pitched_tables); got strides {tuple(vals2.stride())}")
    elif not vals2.is_contiguous():
        raise ValueError("stencil_matvec: inputs must be contiguous")
    if not x.is_contiguous():
        raise ValueError("stencil_matvec: inputs must be contiguous")
    y = torch.empty_like(x)
    lib = kernel_lib.library().cdll
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fgt_stencil_matvec(code, table_code, d, vals2.data_ptr(),
                                    x.data_ptr(), y.data_ptr(), gx, M,
                                    grid_shape[-1], pitch, stream)
    kernel_lib.check(rc, "stencil_matvec")
    stencil_matvec.launches += 1
    stencil_matvec.launches_by_table[str(vals2.dtype)[6:]] += 1
    return y


# all launches, and the launches of each table type's instantiation
stencil_matvec.launches = 0
stencil_matvec.launches_by_table = {"float32": 0, "float64": 0,
                                    "bfloat16": 0}


def stencil_matvec_halo_reference(vals2: torch.Tensor, x_ext: torch.Tensor,
                                  slab_shape) -> torch.Tensor:
    """Plain PyTorch version of the halo form: the whole-grid version with
    its one-row zero pad replaced by the halo rows of x_ext. vals2 (3^d,
    L, M), x_ext ((L + 2) M,), slab_shape (L, *grid[1:]) -> (L M,)."""
    L = slab_shape[0]
    M = vals2.shape[-1]
    shifts = flat_shifts(slab_shape)
    P = max(abs(s) for _, s in shifts) if len(slab_shape) > 1 else 1
    xp = F.pad(x_ext.reshape(L + 2, M), (P, P))
    acc = torch.zeros((L, M), dtype=x_ext.dtype, device=x_ext.device)
    for o, (dx, s) in enumerate(shifts):
        acc = acc + vals2[o] * xp[dx:dx + L, P + s:P + s + M]
    return acc.reshape(-1)


def stencil_matvec_halo(vals2: torch.Tensor, x_ext: torch.Tensor,
                        slab_shape) -> torch.Tensor:
    """y = A x over a rank's slab: vals2 (3^d, L, M) in x's dtype
    (contiguous), x_ext ((L + 2) M,) with the neighbours' planes first and
    last, slab_shape (L, *grid[1:]) -> (L M,). Kernel on CUDA tensors
    (d = 2 or 3), plain version on CPU tensors."""
    slab_shape = tuple(int(g) for g in slab_shape)
    d = len(slab_shape)
    L = slab_shape[0]
    M = int(np.prod(slab_shape[1:])) if d > 1 else 1
    if vals2.shape != (3 ** d, L, M) or x_ext.shape != ((L + 2) * M,):
        raise ValueError(f"stencil_matvec_halo: slab {slab_shape} needs vals "
                         f"({3 ** d}, {L}, {M}) and x ({(L + 2) * M},), got "
                         f"{tuple(vals2.shape)} and {tuple(x_ext.shape)}")
    if vals2.dtype != x_ext.dtype:
        raise TypeError(f"stencil_matvec_halo: vals {vals2.dtype} vs x "
                        f"{x_ext.dtype} (the halo form takes tables in the "
                        f"vector's dtype)")
    if vals2.device.type == "cpu" and x_ext.device.type == "cpu":
        return stencil_matvec_halo_reference(vals2, x_ext, slab_shape)
    if vals2.device.type != "cuda" or vals2.device != x_ext.device:
        raise ValueError("stencil_matvec_halo: vals and x must lie on one "
                         f"CUDA device or both on the CPU, got {vals2.device} "
                         f"and {x_ext.device}")
    if d not in (2, 3):
        raise ValueError(f"stencil_matvec_halo: the kernel takes d = 2 or 3, "
                         f"got {d}")
    if not (vals2.is_contiguous() and x_ext.is_contiguous()):
        raise ValueError("stencil_matvec_halo: inputs must be contiguous")
    code = kernel_lib.dtype_code(x_ext.dtype)
    y = torch.empty(L * M, dtype=x_ext.dtype, device=x_ext.device)
    lib = kernel_lib.library().cdll
    with torch.cuda.device(x_ext.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fgt_stencil_matvec_halo(code, d, vals2.data_ptr(),
                                         x_ext.data_ptr(), y.data_ptr(), L,
                                         M, slab_shape[-1], stream)
    kernel_lib.check(rc, "stencil_matvec_halo")
    stencil_matvec_halo.launches += 1
    return y


stencil_matvec_halo.launches = 0
