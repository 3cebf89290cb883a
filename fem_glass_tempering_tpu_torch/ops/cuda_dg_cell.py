"""Hand-written CUDA kernels for the cell term of the heat residual, beside
their plain PyTorch twin (counterpart of the DG cell residual kernel in
fem_glass_tempering_tpu/ops/pallas_kernels.py).

dg_cell_residual — per cell, the mass + source + diffusion integrals

  r[c,l] = sum_q qw[c,q] (c_mass (Tq - Tpq) - dt (f + src[c,q])) phi[q,l]
         + dt c_diff sum_{q,g} qw[c,q] dT_g[c,q] gphi[c,q,l,g]

with Tq = Tc phi^T and dT_g = sum_l Tc[c,l] gphi[c,q,l,g] (kernel source
csrc/dg_cell_residual.cu). It replaces
fem_glass_tempering_tpu/ops/pallas_kernels.py:make_dg_cell_residual and is
the cell term of every heat residual and, through its forward-mode
derivative, of every matrix-free CG matvec, for DG and CG spaces alike.

What bounds it on the card, and the kernels that follow (the source's
head note has the detail). With per-cell tables it is bound by
device-memory bytes (224 values per hex DG-1 cell): the split kernel, one
thread per (cell, local dof), reads and writes contiguous runs. With the
single-cell tables of a uniform box a cell moves 24 values for 1,232
FP64 operations and waits for the FP64 units, not for bytes: the row kernel,
one thread per cell, takes the tables by value in its parameters, so that
they are constant-bank operands and its inner loops hold no load. The row
kernel needs the tables on the host; `PreparedDGCellResidual` packs them
once. Uniform tables that do not fit the parameters, or that arrive as
device tensors in a direct call, are staged in shared memory by the split
kernel. Both kernels sum in the plain version's order, so the result does
not depend on the path.

The degree-2 cells, (nloc, g) in ELEMENT_SHAPES, take the element form
instead ("element"): the cell term is linear with per-call scalar
coefficients, so r = c_mass M (Tc - Tpc) - dt (f b + s) + dt c_diff K Tc
with the element matrices M, K and the vectors b, s baked once from the
tables (`bake_element_tables`, in f64, rounded once to the working
dtype), and one thread per cell forms the two matrix-vector products.
`element_matrices_reference` is the bake as einsums and
`element_residual_reference` the element form's plain version; the CPU
path stays the quadrature twin `dg_cell_residual_reference`.

The host's share of a call is larger than the device's at the sizes the
solver uses, so the launch path is short: the static tables (`qw`, `gphi`,
`phi`, `source_q`) are validated once, when a `PreparedDGCellResidual` is
built (the heat operator builds one), and each call checks `Tc` and `Tpc`
alone. `dg_cell_residual(...)` takes the tables per call and checks them
per call.

The map is linear in (Tc, Tpc), so the tangent is one more launch of the
same kernel on the tangents with the source terms zero; the call unpacks
the tangents itself and reaches the launch through a dispatcher op, not
through `autograd.Function.apply` (see the note above `_evaluate`). There
is no reverse-mode derivative: a backward pass raises.

On CPU tensors the plain version runs; on CUDA tensors a kernel is
launched; anything the kernels do not take raises.
"""

from __future__ import annotations

import itertools
import time
import weakref

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from fem_glass_tempering_tpu_torch.ops import kernel_lib

MAX_NLOC = 32     # kMaxNloc / kMaxG of the kernel source
MAX_GDIM = 3
# uniform tables travel in the row kernel's parameters when they fit
# kParamTableBytes and the cell is one the kernel is instantiated for (the
# tensor-product cells of the uniform boxes)
PARAM_TABLE_BYTES = 3584
PARAM_SHAPES = ((2, 1), (4, 2), (8, 3))           # (nloc, g)
# the degree-2 cells (interval, triangle, quadrilateral, tetrahedron,
# hexahedron) take the element form
ELEMENT_SHAPES = ((3, 1), (6, 2), (9, 2), (10, 3), (27, 3))   # (nloc, g)
# cells of per-cell tables baked at once: the f64 copy of a chunk's gphi
# (10-node tetrahedra, q 64: 15 KB a cell) stays near 128 MB
BAKE_CHUNK_CELLS = 8192


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


def element_matrices_reference(qw, gphi, phi):
    """The element form's tables as einsums: the mass matrix M = sum_q qw
    phi_q phi_q^T, the stiffness matrix K = sum_q qw sum_g d_g phi_q d_g
    phi_q^T and b = sum_q qw phi_q, in the tables' dtype. Uniform tables
    give M, K (nloc, nloc) and b (nloc,); per-cell tables (cells, nloc,
    nloc) and (cells, nloc)."""
    if qw.dim() == 1:
        M = torch.einsum("q,ql,qm->lm", qw, phi, phi)
        K = torch.einsum("q,qlg,qmg->lm", qw, gphi, gphi)
    else:
        M = torch.einsum("cq,ql,qm->clm", qw, phi, phi)
        K = torch.einsum("cq,cqlg,cqmg->clm", qw, gphi, gphi)
    return M, K, qw @ phi


def element_source_reference(qw, phi, source_q):
    """The per-point source as element vectors: s (cells, nloc) = sum_q
    qw src_q phi_q, for qw (q,) or (cells, q)."""
    return (qw * source_q) @ phi


def element_residual_reference(Tc, Tpc, M, K, b, *, dt, c_diff, f_src,
                               c_mass=1.0, s=None, k1=None):
    """Plain version of the element form: c_mass M (Tc - Tpc) - dt (f b +
    s) + dt c_diff K Tc, per cell, with the tables of
    `element_matrices_reference` (and `element_source_reference`). K Tc
    is formed as the kernel forms it, K (Tc - t0) + t0 k1 with t0 =
    Tc[:, 0] and k1 = K 1 (by default from K; the bake's from K before
    rounding): K's rows sum to ~0, so K Tc cancels, and the shift keeps
    the cancellation's rounding out of the sum."""
    t0 = Tc[:, :1]
    if M.dim() == 2:
        mass, diff = (Tc - Tpc) @ M.T, (Tc - t0) @ K.T
    else:
        mass = torch.einsum("clm,cm->cl", M, Tc - Tpc)
        diff = torch.einsum("clm,cm->cl", K, Tc - t0)
    diff = diff + t0 * (K.sum(-1) if k1 is None else k1)
    src = f_src * b if s is None else f_src * b + s
    return (c_mass * mass - dt * src) + dt * c_diff * diff


def bake_element_tables(qw, gphi, phi, source_q, dtype) -> dict:
    """The element form's tables in the kernel's layout, formed in f64
    from the tables (promoted exactly) on their device and rounded once
    to `dtype`: uniform tables give M, K (nloc, nloc) and b (nloc,);
    per-cell tables the upper triangles of M and K entry-major, (nloc
    (nloc + 1) / 2, cells) in the row-major order of the pairs (l <= m),
    and b (nloc, cells), baked BAKE_CHUNK_CELLS cells at a time. "k1" is
    K 1, summed in f64 before K is rounded (the rows of K sum to ~0; those
    of the rounded K sum to its rounding), shaped as b. "s" is the source
    (nloc, cells), or None."""
    dev = qw.device
    f64 = lambda a: a.to(dtype=torch.float64)  # noqa: E731
    phi64 = f64(phi)
    nloc = phi.shape[1]
    chunk = BAKE_CHUNK_CELLS
    out = {}
    if qw.ndim == 1:
        M, K, b = element_matrices_reference(f64(qw), f64(gphi), phi64)
        out.update(M=M.to(dtype).contiguous(), K=K.to(dtype).contiguous(),
                   b=b.to(dtype).contiguous(),
                   k1=K.sum(-1).to(dtype).contiguous())
    else:
        cells = qw.shape[0]
        iu = torch.triu_indices(nloc, nloc, device=dev)
        npack = iu.shape[1]
        out.update(M=torch.empty((npack, cells), dtype=dtype, device=dev),
                   K=torch.empty((npack, cells), dtype=dtype, device=dev),
                   b=torch.empty((nloc, cells), dtype=dtype, device=dev),
                   k1=torch.empty((nloc, cells), dtype=dtype, device=dev))
        for c0 in range(0, cells, chunk):
            sl = slice(c0, c0 + chunk)
            M, K, b = element_matrices_reference(f64(qw[sl]), f64(gphi[sl]),
                                                 phi64)
            out["M"][:, sl] = M[:, iu[0], iu[1]].T
            out["K"][:, sl] = K[:, iu[0], iu[1]].T
            out["b"][:, sl] = b.T
            out["k1"][:, sl] = K.sum(-1).T
            del M, K, b
    out["s"] = None
    if source_q is not None:
        cells = source_q.shape[0]
        out["s"] = torch.empty((nloc, cells), dtype=dtype, device=dev)
        for c0 in range(0, cells, chunk):
            sl = slice(c0, c0 + chunk)
            w = f64(qw) if qw.ndim == 1 else f64(qw[sl])
            out["s"][:, sl] = element_source_reference(
                w, phi64, f64(source_q[sl])).T
    return out


# ----------------------------------------------------------------------
# uniform tables for the row kernel's parameter struct
def packed_table_bytes(nloc: int, q: int, g: int, itemsize: int) -> int:
    return q * (nloc * (1 + g) + 1) * itemsize


def table_path(nloc: int, q: int, g: int, itemsize: int,
               uniform: bool) -> str:
    """Which kernel a prepared call takes: "element" (the element form,
    every degree-2 cell), "param" (row kernel, tables by value) or
    "shared" (split kernel, tables in device memory)."""
    if (nloc, g) in ELEMENT_SHAPES:
        return "element"
    if (uniform and (nloc, g) in PARAM_SHAPES
            and packed_table_bytes(nloc, q, g, itemsize) <= PARAM_TABLE_BYTES):
        return "param"
    return "shared"


def pack_uniform_tables(qw, gphi, phi) -> np.ndarray:
    """Uniform tables qw (q,), gphi (q, nloc, g), phi (q, nloc) as one host
    array in the row kernel's order: for each point q the record
    [phi[q, :], qw[q], gphi[q, :, :]]."""
    qw, gphi, phi = (np.asarray(a) for a in (qw, gphi, phi))
    q = phi.shape[0]
    return np.ascontiguousarray(np.concatenate(
        [phi, qw[:, None], gphi.reshape(q, -1)], axis=1)).reshape(-1)


def unpack_uniform_tables(packed: np.ndarray, nloc: int, g: int):
    """Inverse of `pack_uniform_tables` -> (qw, gphi, phi)."""
    rec = np.asarray(packed).reshape(-1, nloc * (1 + g) + 1)
    return (rec[:, nloc].copy(),
            rec[:, nloc + 1:].reshape(-1, nloc, g).copy(),
            rec[:, :nloc].copy())


# ----------------------------------------------------------------------
def _check_rows(Tc, Tpc, nloc=None, cells=None):
    if (Tc.dim() != 2 or Tpc.shape != Tc.shape
            or (nloc is not None and Tc.shape[1] != nloc)
            or (cells is not None and Tc.shape[0] != cells)):
        want = (f"({'cells' if cells is None else cells}, "
                f"{'nloc' if nloc is None else nloc})")
        raise ValueError(f"dg_cell_residual: expected Tc, Tpc {want}, got "
                         f"{tuple(Tc.shape)} and {tuple(Tpc.shape)}")


class PreparedDGCellResidual:
    """The cell term for fixed tables: `qw`, `gphi`, `phi` and the optional
    per-point source `source_q` are checked here, once; a call
    `prepared(Tc, Tpc, dt=..., c_diff=..., f_src=..., c_mass=...)` checks
    `Tc` and `Tpc` (shape, dtype, device, contiguity) and runs the plain
    version (CPU tensors) or launches a kernel (CUDA tensors). With
    `pack=True` uniform CUDA tables that fit are copied to the host once
    and travel by value (`table_path`). CUDA tables of a degree-2 cell are
    baked here into the element form's matrices (`bake_element_tables`;
    `bake_bytes` says what they hold and, on a prepared call,
    `bake_seconds` what the bake took). Either way the tables must not
    change afterwards: a call reads the copy or the bake, not the
    tables."""

    def __init__(self, qw, gphi, phi, source_q=None, *, nloc=None,
                 cells=None, pack=True):
        if phi.dim() != 2 or (nloc is not None and phi.shape[1] != nloc):
            raise ValueError(
                f"dg_cell_residual: phi must be (q, "
                f"{'nloc' if nloc is None else nloc}), got "
                f"{tuple(phi.shape)}")
        q, nloc = phi.shape
        self.uniform = qw.dim() == 1
        if not self.uniform and qw.dim() == 2 and cells is None:
            cells = qw.shape[0]
        lead = () if self.uniform else (cells,)
        if (tuple(qw.shape) != lead + (q,) or gphi.dim() != len(lead) + 3
                or tuple(gphi.shape[:-1]) != lead + (q, nloc)):
            raise ValueError(
                "dg_cell_residual: expected qw (cells, q) with gphi (cells, q, "
                "nloc, g), or qw (q,) with gphi (q, nloc, g); got "
                f"{tuple(qw.shape)} and {tuple(gphi.shape)} for "
                f"{'any number of' if cells is None else cells} cells, "
                f"q = {q}, nloc = {nloc}")
        if source_q is not None:
            if cells is None and source_q.dim() == 2:
                cells = source_q.shape[0]
            if tuple(source_q.shape) != (cells, q):
                raise ValueError(
                    f"dg_cell_residual: source_q must be ({cells}, {q}), got "
                    f"{tuple(source_q.shape)}")
        self.cells, self.nloc, self.q, self.g = cells, nloc, q, gphi.shape[-1]
        self.qw, self.gphi, self.phi, self.source_q = qw, gphi, phi, source_q
        tables = [t for t in (qw, gphi, phi, source_q) if t is not None]
        self.device, self.dtype = qw.device, qw.dtype
        if any(t.device != self.device for t in tables) or \
                self.device.type not in ("cpu", "cuda"):
            raise ValueError("dg_cell_residual: inputs must all lie on one "
                             "CUDA device or all on the CPU, got "
                             f"{[str(t.device) for t in tables]}")
        if any(t.dtype != self.dtype for t in tables):
            raise TypeError("dg_cell_residual: mixed dtypes "
                            f"{[str(t.dtype) for t in tables]}")
        self.path = "plain"
        self._packed = None
        self._elem = None
        self.bake_seconds = self.bake_bytes = None
        self._id = next(_ids)        # how the dispatcher op finds this call
        _PREPARED[self._id] = self
        if self.device.type != "cuda":
            return
        self._code = kernel_lib.dtype_code(self.dtype)
        if nloc > MAX_NLOC or not 1 <= self.g <= MAX_GDIM:
            raise ValueError(f"dg_cell_residual: the kernel takes nloc <= "
                             f"{MAX_NLOC} and g <= {MAX_GDIM}, got nloc = "
                             f"{nloc}, g = {self.g}")
        if not all(t.is_contiguous() for t in tables):
            raise ValueError("dg_cell_residual: inputs must be contiguous")
        self.path = "shared"
        if table_path(nloc, q, self.g, qw.element_size(),
                      self.uniform) == "element":
            self.path = "element"
            t0 = time.perf_counter()
            self._elem = bake_element_tables(qw, gphi, phi, source_q,
                                             self.dtype)
            if pack:
                torch.cuda.synchronize(self.device)
                self.bake_seconds = time.perf_counter() - t0
            self.bake_bytes = sum(t.numel() * t.element_size()
                                  for t in self._elem.values()
                                  if t is not None)
        elif pack and table_path(nloc, q, self.g, qw.element_size(),
                                 self.uniform) == "param":
            held = kernel_lib.library().cdll.fgt_dg_cell_param_table_bytes()
            if held != PARAM_TABLE_BYTES:
                raise RuntimeError(
                    f"dg_cell_residual: the kernel's parameter struct holds "
                    f"{held} bytes of tables, this module expects "
                    f"{PARAM_TABLE_BYTES}")
            self.path = "param"
            self._packed = pack_uniform_tables(
                qw.cpu().numpy(), gphi.cpu().numpy(), phi.cpu().numpy())
            self._packed_ptr = self._packed.ctypes.data

    def __call__(self, Tc, Tpc, *, dt, c_diff, f_src, c_mass=1.0):
        return _evaluate(self, Tc, Tpc, float(dt), float(c_mass),
                         float(c_diff), float(f_src), _NO_TABLES)

    def run(self, Tc, Tpc, dt, c_mass, c_diff, f_src, with_src,
            any_cells=False):
        """Check Tc and Tpc, then the plain version or one launch, on
        tensors that own their storage (no automatic differentiation:
        `__call__` adds it). `any_cells`: uniform tables without the
        source take any number of rows (the batching rule's stacked
        batch)."""
        free = any_cells and self.uniform and not (
            with_src and self.source_q is not None)
        _check_rows(Tc, Tpc, self.nloc, None if free else self.cells)
        if Tc.dtype != self.dtype or Tpc.dtype != self.dtype:
            raise TypeError(
                f"dg_cell_residual: mixed dtypes: Tc {Tc.dtype}, Tpc "
                f"{Tpc.dtype}, tables {self.dtype}")
        if Tc.device != self.device or Tpc.device != self.device:
            raise ValueError(
                "dg_cell_residual: inputs must all lie on one CUDA device or "
                f"all on the CPU, got Tc on {Tc.device}, Tpc on {Tpc.device}, "
                f"tables on {self.device}")
        if not (Tc.is_contiguous() and Tpc.is_contiguous()):
            raise ValueError("dg_cell_residual: Tc and Tpc must be contiguous")
        src = self.source_q if with_src else None
        if self.path == "plain":
            return dg_cell_residual_reference(
                Tc, Tpc, self.qw, self.gphi, self.phi, dt=dt, c_diff=c_diff,
                f_src=f_src, c_mass=c_mass, source_q=src)
        out = torch.empty_like(Tc)
        lib = kernel_lib.library().cdll
        src_ptr = None if src is None else src.data_ptr()
        if self.path == "element":
            e = self._elem
            b_ptr = e["b"].data_ptr() if f_src != 0.0 else None
            s_ptr = None if src is None else e["s"].data_ptr()
            launch = lambda stream: lib.fgt_dg_cell_element(
                self._code, Tc.data_ptr(), Tpc.data_ptr(), e["M"].data_ptr(),
                e["K"].data_ptr(), b_ptr, e["k1"].data_ptr(), s_ptr,
                out.data_ptr(),
                Tc.shape[0], self.nloc, int(not self.uniform), dt, c_mass,
                c_diff, f_src, stream)
        elif self.path == "param":
            launch = lambda stream: lib.fgt_dg_cell_residual_param(
                self._code, Tc.data_ptr(), Tpc.data_ptr(), self._packed_ptr,
                src_ptr, out.data_ptr(), Tc.shape[0], self.nloc, self.q,
                self.g, dt, c_mass, c_diff, f_src, stream)
        else:
            launch = lambda stream: lib.fgt_dg_cell_residual(
                self._code, Tc.data_ptr(), Tpc.data_ptr(),
                self.qw.data_ptr(), self.gphi.data_ptr(),
                self.phi.data_ptr(), src_ptr, out.data_ptr(), Tc.shape[0],
                self.nloc, self.q, self.g, int(self.uniform), dt, c_mass,
                c_diff, f_src, stream)
        kernel_lib.check(kernel_lib.launch_on(self.device, launch),
                         "dg_cell_residual")
        dg_cell_residual.launches += 1
        return out


# ----------------------------------------------------------------------
# Automatic differentiation. The solver differentiates the residual in
# forward mode (torch.func.jvp), and the map is linear in (Tc, Tpc): the
# tangent is the same launch on the tangents with the source terms zero.
# So a call unpacks its inputs' tangents itself and launches twice. Under
# torch.func.jvp the primals and tangents are wrappers without storage; a
# dispatcher op hands its implementation the tensors underneath, as it does
# for every built-in operator, at a fraction of the host time that
# `autograd.Function.apply` takes under a transform (it generates a class
# per call there). Outside forward mode nothing can carry a tangent and the
# launch is called directly.
_NO_TABLES = (None, None, None, None)
_PREPARED = weakref.WeakValueDictionary()
_ids = itertools.count(1)
_OPS = torch.library.Library("fgt_torch", "FRAGMENT")
_OPS.define(
    "dg_cell_launch(Tensor Tc, Tensor Tpc, Tensor? qw, Tensor? gphi, "
    "Tensor? phi, Tensor? source_q, int call_id, float dt, float c_mass, "
    "float c_diff, float f_src, bool with_src) -> Tensor")


def _for_tables(Tc, Tpc, qw, gphi, phi, source_q):
    """A direct call's tables, checked against this call's rows."""
    _check_rows(Tc, Tpc)
    return PreparedDGCellResidual(qw, gphi, phi, source_q, nloc=Tc.shape[1],
                                  cells=Tc.shape[0], pack=False)


def _dg_cell_launch(Tc, Tpc, qw, gphi, phi, source_q, call_id, dt, c_mass,
                    c_diff, f_src, with_src):
    call = _PREPARED[call_id] if call_id else _for_tables(
        Tc, Tpc, qw, gphi, phi, source_q)
    return call.run(Tc, Tpc, dt, c_mass, c_diff, f_src, with_src)


_OPS.impl("dg_cell_launch", _dg_cell_launch, "CompositeExplicitAutograd")


def _dg_cell_launch_vmap(info, in_dims, Tc, Tpc, qw, gphi, phi, source_q,
                         call_id, dt, c_mass, c_diff, f_src, with_src):
    """Batching rule of the launch (torch.func.vmap, as
    solver/direct.py's materialize_jacobian maps the jvp over the columns
    of the identity). Uniform tables, on a launch without the per-point
    source (every tangent's): the batch is folded into the cell axis, one
    launch for the whole batched call. Per-cell tables, or the source:
    one launch per batch entry, since the kernels index their tables by
    cell and take no table period."""
    if any(d is not None for d in in_dims[2:6]):
        raise NotImplementedError(
            "dg_cell_residual is batched in Tc and Tpc only")
    n = info.batch_size
    Tc, Tpc = (t.movedim(d, 0) if d is not None else t.expand(n, *t.shape)
               for t, d in zip((Tc, Tpc), in_dims[:2]))
    call = _PREPARED[call_id] if call_id else None
    uniform = call.uniform if call is not None else qw.dim() == 1
    src = (call.source_q if call is not None else source_q) if with_src \
        else None
    if uniform and src is None:
        cells, nloc = Tc.shape[1:]
        if call is None:
            call = PreparedDGCellResidual(qw, gphi, phi, nloc=nloc,
                                          pack=False)
        out = call.run(Tc.reshape(-1, nloc).contiguous(),
                       Tpc.reshape(-1, nloc).contiguous(), dt, c_mass,
                       c_diff, f_src, False, any_cells=True)
        return out.reshape(n, cells, nloc), 0
    launch = torch.ops.fgt_torch.dg_cell_launch
    return torch.stack([
        launch(Tc[i].contiguous(), Tpc[i].contiguous(), qw, gphi, phi,
               source_q, call_id, dt, c_mass, c_diff, f_src, with_src)
        for i in range(n)]), 0


torch.library.register_vmap("fgt_torch::dg_cell_launch",
                            _dg_cell_launch_vmap, lib=_OPS)
_functorch_active = getattr(torch._C, "_are_functorch_transforms_active",
                            None)


def _forward_mode() -> bool:
    """Whether an input may carry a tangent or be a wrapper: under a
    functorch transform or inside a forward-mode dual level. Where this
    torch lacks the probes, say yes."""
    if _functorch_active is None or _functorch_active():
        return True
    return getattr(fwAD, "_current_level", 0) >= 0


class _NoBackward(torch.autograd.Function):
    """The launch for inputs that record for a backward pass: there is no
    reverse-mode derivative, and asking for one says so."""

    @staticmethod
    def forward(Tc, Tpc, call, dt, c_mass, c_diff, f_src, *tables):
        call = call or _for_tables(Tc, Tpc, *tables)
        return call.run(Tc, Tpc, dt, c_mass, c_diff, f_src, True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grad_outputs):
        raise NotImplementedError(
            "dg_cell_residual has no reverse-mode derivative: the heat "
            "solver differentiates it in forward mode (torch.func.jvp)")


def _evaluate(call, Tc, Tpc, dt, c_mass, c_diff, f_src, tables):
    """`call` is a PreparedDGCellResidual (then `tables` is _NO_TABLES) or
    None with the direct call's (qw, gphi, phi, source_q)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (Tc, Tpc, *tables)):
        return _NoBackward.apply(Tc, Tpc, call, dt, c_mass, c_diff, f_src,
                                 *tables)
    if not _forward_mode():
        call = call or _for_tables(Tc, Tpc, *tables)
        return call.run(Tc, Tpc, dt, c_mass, c_diff, f_src, True)
    if any(t is not None and fwAD.unpack_dual(t).tangent is not None
           for t in tables):
        raise NotImplementedError(
            "dg_cell_residual is differentiated in Tc and Tpc only")
    Tc, dTc = fwAD.unpack_dual(Tc)
    Tpc, dTpc = fwAD.unpack_dual(Tpc)
    launch = torch.ops.fgt_torch.dg_cell_launch
    call_id = call._id if call is not None else 0
    out = launch(Tc, Tpc, *tables, call_id, dt, c_mass, c_diff, f_src, True)
    if dTc is None and dTpc is None:
        return out
    ref = dTc if dTc is not None else dTpc
    dTc = torch.zeros_like(ref) if dTc is None else dTc.contiguous()
    dTpc = torch.zeros_like(ref) if dTpc is None else dTpc.contiguous()
    dout = launch(dTc, dTpc, *tables[:3], None, call_id, dt, c_mass, c_diff,
                  0.0, False)
    return fwAD.make_dual(out, dout)


def dg_cell_residual(Tc, Tpc, qw, gphi, phi, *, dt, c_diff, f_src,
                     c_mass=1.0, source_q=None):
    """Cell residual r (cells, nloc) from the gathered dof values Tc, Tpc
    (cells, nloc), the quadrature tables qw (cells, q) / gphi (cells, q,
    nloc, g) — or their uniform-mesh forms (q,) / (q, nloc, g) — and the
    basis table phi (q, nloc). `dt`, `c_mass`, `c_diff`, `f_src` are
    numbers; `source_q` (cells, q) is an optional per-point source.
    Kernel on CUDA tensors, plain version on CPU tensors; differentiable
    in forward mode with respect to Tc and Tpc. Every argument is checked
    on every call; `PreparedDGCellResidual` checks the tables once."""
    return _evaluate(None, Tc, Tpc, float(dt), float(c_mass), float(c_diff),
                     float(f_src), (qw, gphi, phi, source_q))


dg_cell_residual.launches = 0
