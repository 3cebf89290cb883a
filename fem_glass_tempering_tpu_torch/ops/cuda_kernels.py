"""Hand-written CUDA kernels for the per-point hot ops, each beside its
plain PyTorch twin (counterpart of fem_glass_tempering_tpu/ops/pallas_kernels.py).

material_tspace — the fused T-space Tool-Narayanaswamy chain (kernel
source csrc/material_tspace.cu). It replaces
fem_glass_tempering_tpu/ops/pallas_kernels.py:material_tspace_pallas.
Bound by device-memory bytes: 8 values read and 9 written per dof, which
is ~72 MB per call in f32 at 1,062,761 dofs. 12 of the 17 values lie in
the two (n, 6) Tf_partial arrays, where a thread walking its own row
spreads every load and store over six to twelve times the sectors it uses.
The kernel makes one pass: a block of 256 dofs moves its contiguous run of
256 x 6 values through a padded shared-memory tile with coalesced 16-byte
accesses and computes from the tile; the public (n, 6) layout is kept. A
ragged last block, and a Tf_partial whose base is not 16-byte aligned (a
view into a larger tensor), copy the tile element by element inside the
kernel, so the wrapper takes any contiguous input.

The wrapper takes the plain version for tensors on the CPU and launches
the kernel for CUDA tensors; anything the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.ops import kernel_lib

TABLEAU_SIZE = 6


def material_tspace_reference(T, T_prev, Tf_partial_prev, *, dt, H_over_Rg,
                              Tb, m_n, lambda_m_n):
    """Plain PyTorch version of the fused chain; returns
    (phi, Tf_partial, Tf, xi). `m_n`, `lambda_m_n`: 6 numbers each."""
    m = torch.as_tensor(np.asarray(m_n), dtype=T.dtype, device=T.device)
    lam = torch.as_tensor(np.asarray(lambda_m_n), dtype=T.dtype,
                          device=T.device)
    phi = torch.exp(H_over_Rg * (1.0 / Tb - 1.0 / T))
    Tf_partial = (
        lam[None, :] * Tf_partial_prev + (T * dt * phi)[:, None]
    ) / (lam[None, :] + (dt * phi)[:, None])
    Tf = Tf_partial @ m
    T_next = 2.0 * T - T_prev
    phi_next = torch.exp(H_over_Rg * (1.0 / Tb - 1.0 / T_next))
    xi = 0.5 * dt * (phi_next - phi)
    return phi, Tf_partial, Tf, xi


def material_tspace(T, T_prev, Tf_partial_prev, *, dt, H_over_Rg, Tb, m_n,
                    lambda_m_n):
    """Fused chain: T, T_prev (n,), Tf_partial_prev (n, 6) ->
    (phi (n,), Tf_partial (n, 6), Tf (n,), xi (n,)). Kernel on CUDA
    tensors, plain version on CPU tensors."""
    tensors = (T, T_prev, Tf_partial_prev)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return material_tspace_reference(
            T, T_prev, Tf_partial_prev, dt=dt, H_over_Rg=H_over_Rg, Tb=Tb,
            m_n=m_n, lambda_m_n=lambda_m_n)
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError("material_tspace: inputs must all lie on one CUDA "
                         f"device or all on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")
    code = kernel_lib.dtype_code(T.dtype)
    if T_prev.dtype != T.dtype or Tf_partial_prev.dtype != T.dtype:
        raise TypeError("material_tspace: mixed dtypes")
    n = T.shape[0]
    if (T.dim() != 1 or T_prev.shape != (n,)
            or Tf_partial_prev.shape != (n, TABLEAU_SIZE)):
        raise ValueError("material_tspace: expected T, T_prev (n,) and "
                         f"Tf_partial (n, 6), got {tuple(T.shape)}, "
                         f"{tuple(T_prev.shape)}, "
                         f"{tuple(Tf_partial_prev.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("material_tspace: inputs must be contiguous")
    m = np.asarray(m_n, dtype=np.float64).reshape(-1)
    lam = np.asarray(lambda_m_n, dtype=np.float64).reshape(-1)
    if m.shape != (TABLEAU_SIZE,) or lam.shape != (TABLEAU_SIZE,):
        raise ValueError("material_tspace: m_n and lambda_m_n take 6 terms")
    phi = torch.empty_like(T)
    Tf = torch.empty_like(T)
    xi = torch.empty_like(T)
    Tf_partial = torch.empty_like(Tf_partial_prev)
    lib = kernel_lib.library().cdll
    arr = ctypes.c_double * TABLEAU_SIZE
    rc = kernel_lib.launch_on(T.device, lambda stream: lib.fgt_material_tspace(
        code, T.data_ptr(), T_prev.data_ptr(), Tf_partial_prev.data_ptr(),
        phi.data_ptr(), Tf_partial.data_ptr(), Tf.data_ptr(), xi.data_ptr(),
        n, float(dt), float(H_over_Rg), 1.0 / float(Tb), 0.5 * float(dt),
        arr(*m), arr(*lam), stream))
    kernel_lib.check(rc, "material_tspace")
    material_tspace.launches += 1
    return phi, Tf_partial, Tf, xi


material_tspace.launches = 0
