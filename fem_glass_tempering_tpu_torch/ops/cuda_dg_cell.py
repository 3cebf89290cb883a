"""Hand-written CUDA kernel for the cell term of the heat residual, beside
its plain PyTorch twin (counterpart of the DG cell residual kernel in
fem_glass_tempering_tpu/ops/pallas_kernels.py).

dg_cell_residual — per cell, the mass + source + diffusion integrals

  r[c,l] = sum_q qw[c,q] (c_mass (Tq - Tpq) - dt (f + src[c,q])) phi[q,l]
         + dt c_diff sum_{q,g} qw[c,q] dT_g[c,q] gphi[c,q,l,g]

with Tq = Tc phi^T and dT_g = sum_l Tc[c,l] gphi[c,q,l,g] (kernel source
csrc/dg_cell_residual.cu). It replaces
fem_glass_tempering_tpu/ops/pallas_kernels.py:make_dg_cell_residual and is
the cell term of every heat residual and, through its forward-mode
derivative, of every matrix-free CG matvec, for DG and CG spaces alike.
Bound by device-memory bytes (224 values per hex DG-1 cell with per-cell
tables, 32 with the single-cell tables of a uniform box); one thread per
cell, the small tables in shared memory.

The map is linear in (Tc, Tpc), so the tangent is one more launch of the
same kernel on the tangents with the source terms zero. There is no
reverse-mode derivative: `backward` raises.

The wrapper takes the plain version for tensors on the CPU and launches
the kernel for CUDA tensors; anything the kernel does not take raises.
"""

from __future__ import annotations

import torch

from fem_glass_tempering_tpu_torch.ops import kernel_lib

MAX_NLOC = 32     # kMaxNloc / kMaxG of the kernel source
MAX_GDIM = 3


def dg_cell_residual_reference(Tc, Tpc, qw, gphi, phi, *, dt, c_diff, f_src,
                               c_mass=1.0, source_q=None):
    """Plain PyTorch version (the einsums of the heat operator's cell
    term). qw (c, q) with gphi (c, q, l, g), or the uniform-mesh tables
    qw (q,) with gphi (q, l, g)."""
    uniform = qw.dim() == 1
    Tq = Tc @ phi.T                                        # (c, q)
    Tpq = Tpc @ phi.T
    if uniform:
        gTq = torch.einsum("cl,qlg->cqg", Tc, gphi)        # (c, q, g)
    else:
        gTq = torch.einsum("cl,cqlg->cqg", Tc, gphi)
    f_q = f_src if source_q is None else f_src + source_q
    mass_src = qw * (c_mass * (Tq - Tpq) - dt * f_q)       # (c, q)
    r_cell = torch.einsum("cq,ql->cl", mass_src, phi)
    if uniform:
        return r_cell + dt * c_diff * torch.einsum(
            "cqg,qlg->cl", qw[None, :, None] * gTq, gphi)
    return r_cell + dt * c_diff * torch.einsum(
        "cqg,cqlg->cl", qw[..., None] * gTq, gphi)


def _check_shapes(Tc, Tpc, qw, gphi, phi, source_q):
    if Tc.dim() != 2 or Tpc.shape != Tc.shape:
        raise ValueError("dg_cell_residual: expected Tc, Tpc (cells, nloc), "
                         f"got {tuple(Tc.shape)} and {tuple(Tpc.shape)}")
    c, nloc = Tc.shape
    if phi.dim() != 2 or phi.shape[1] != nloc:
        raise ValueError(f"dg_cell_residual: phi must be (q, {nloc}), got "
                         f"{tuple(phi.shape)}")
    q = phi.shape[0]
    uniform = qw.dim() == 1
    lead = () if uniform else (c,)
    if (tuple(qw.shape) != lead + (q,) or gphi.dim() != len(lead) + 3
            or tuple(gphi.shape[:-1]) != lead + (q, nloc)):
        raise ValueError(
            "dg_cell_residual: expected qw (cells, q) with gphi (cells, q, "
            "nloc, g), or qw (q,) with gphi (q, nloc, g); got "
            f"{tuple(qw.shape)} and {tuple(gphi.shape)} for {c} cells, "
            f"q = {q}, nloc = {nloc}")
    if source_q is not None and tuple(source_q.shape) != (c, q):
        raise ValueError(f"dg_cell_residual: source_q must be ({c}, {q}), "
                         f"got {tuple(source_q.shape)}")
    return c, nloc, q, gphi.shape[-1], uniform


def _launch(Tc, Tpc, qw, gphi, phi, source_q, dt, c_mass, c_diff, f_src):
    """Check, then the plain version (CPU tensors) or one kernel launch
    (CUDA tensors)."""
    c, nloc, q, g, uniform = _check_shapes(Tc, Tpc, qw, gphi, phi, source_q)
    tensors = [Tc, Tpc, qw, gphi, phi]
    if source_q is not None:
        tensors.append(source_q)
    devices = {t.device.type for t in tensors}
    if devices == {"cpu"}:
        return dg_cell_residual_reference(
            Tc, Tpc, qw, gphi, phi, dt=dt, c_diff=c_diff, f_src=f_src,
            c_mass=c_mass, source_q=source_q)
    if devices != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError("dg_cell_residual: inputs must all lie on one CUDA "
                         "device or all on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")
    code = kernel_lib.dtype_code(Tc.dtype)
    if any(t.dtype != Tc.dtype for t in tensors):
        raise TypeError("dg_cell_residual: mixed dtypes "
                        f"{[str(t.dtype) for t in tensors]}")
    if nloc > MAX_NLOC or not 1 <= g <= MAX_GDIM:
        raise ValueError(f"dg_cell_residual: the kernel takes nloc <= "
                         f"{MAX_NLOC} and g <= {MAX_GDIM}, got nloc = {nloc}, "
                         f"g = {g}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dg_cell_residual: inputs must be contiguous")
    out = torch.empty_like(Tc)
    lib = kernel_lib.library().cdll
    with torch.cuda.device(Tc.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.fgt_dg_cell_residual(
            code, Tc.data_ptr(), Tpc.data_ptr(), qw.data_ptr(),
            gphi.data_ptr(), phi.data_ptr(),
            None if source_q is None else source_q.data_ptr(),
            out.data_ptr(), c, nloc, q, g, int(uniform), float(dt),
            float(c_mass), float(c_diff), float(f_src), stream)
    kernel_lib.check(rc, "dg_cell_residual")
    dg_cell_residual.launches += 1
    return out


class _DGCellResidual(torch.autograd.Function):
    """The launch under automatic differentiation (functorch form).
    Forward mode only: the residual is differentiated by
    `torch.func.jvp`, never by a backward pass."""

    @staticmethod
    def forward(Tc, Tpc, qw, gphi, phi, source_q, dt, c_mass, c_diff, f_src):
        return _launch(Tc, Tpc, qw, gphi, phi, source_q, dt, c_mass, c_diff,
                       f_src)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, _, qw, gphi, phi, _, dt, c_mass, c_diff, _ = inputs
        ctx.save_for_forward(qw, gphi, phi)
        # an input without a tangent reaches jvp as None, not as zeros
        ctx.set_materialize_grads(False)
        ctx.scalars = (dt, c_mass, c_diff)

    @staticmethod
    def jvp(ctx, dTc, dTpc, dqw, dgphi, dphi, dsource_q, *_):
        if any(t is not None for t in (dqw, dgphi, dphi, dsource_q)):
            raise NotImplementedError(
                "dg_cell_residual is differentiated in Tc and Tpc only")
        qw, gphi, phi = ctx.saved_tensors
        dt, c_mass, c_diff = ctx.scalars
        if dTc is None and dTpc is None:
            return None
        ref = dTc if dTc is not None else dTpc
        dTc = torch.zeros_like(ref) if dTc is None else dTc.contiguous()
        dTpc = torch.zeros_like(ref) if dTpc is None else dTpc.contiguous()
        # linear in (Tc, Tpc): the same map with the source terms zero.
        # Through apply, not _launch: under torch.func.jvp the tangents are
        # functorch wrappers without storage, and apply hands forward()
        # the tensors underneath
        return _DGCellResidual.apply(dTc, dTpc, qw, gphi, phi, None, dt,
                                     c_mass, c_diff, 0.0)

    @staticmethod
    def backward(ctx, *grad_outputs):
        raise NotImplementedError(
            "dg_cell_residual has no reverse-mode derivative: the heat "
            "solver differentiates it in forward mode (torch.func.jvp)")


def dg_cell_residual(Tc, Tpc, qw, gphi, phi, *, dt, c_diff, f_src,
                     c_mass=1.0, source_q=None):
    """Cell residual r (cells, nloc) from the gathered dof values Tc, Tpc
    (cells, nloc), the quadrature tables qw (cells, q) / gphi (cells, q,
    nloc, g) — or their uniform-mesh forms (q,) / (q, nloc, g) — and the
    basis table phi (q, nloc). `dt`, `c_mass`, `c_diff`, `f_src` are
    numbers; `source_q` (cells, q) is an optional per-point source.
    Kernel on CUDA tensors, plain version on CPU tensors; differentiable
    in forward mode with respect to Tc and Tpc."""
    return _DGCellResidual.apply(Tc, Tpc, qw, gphi, phi, source_q, float(dt),
                                 float(c_mass), float(c_diff), float(f_src))


dg_cell_residual.launches = 0
