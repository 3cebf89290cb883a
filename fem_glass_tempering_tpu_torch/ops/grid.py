"""Gather-free heat operator for CG-1 on uniform box meshes.

Counterpart of fem_glass_tempering_tpu/ops/grid.py (GridHeatOperator). The
residual, the Jacobi diagonal and the per-Newton boundary-linearization
update of the stencil values are static slice / elementwise arithmetic on
the (nx+1, ny+1, nz+1) node grid:

- the linear part (consistent mass + alpha-stiffness) rides the
  StencilMatrix value tables;
- the nonlinear boundary flux (radiation + convection with the reference's
  0.001 scale) is evaluated per box face: every facet of a face has the
  same geometry, so one (q, nloc) basis table and one (q,) weight row
  cover the face, facet corner values are static slices of the node grid,
  and the scatter back is a static-slice add.

The Jacobian action (`make_matvec`) bakes the boundary linearization into
the 27 value tables once per frozen operator and applies them with the
hand-written CUDA stencil kernel (ops/cuda_stencil.py) on the GPU; with
`stream_dtype=torch.bfloat16` the tables stream in bf16 under the
operator's vector dtype (the V-cycle's `table_dtype`).

The constant-row form (`allow_const=True`): on a uniform box the value
tables are translation-invariant along grid axis 0 away from its two
boundary planes, so the residual, the diagonal and the Jacobian action
run from one (n_off, M) row plus the two boundary planes' rows, and the
boundary-flux linearisation rides per apply as face-local blocks. It is
plain PyTorch, taken only without a `stream_dtype`. The solver builds
the table form (the default), whose Jacobian action is K2.

Padded grids (`pad_axis0`, the grid-sharded step of
parallel/grid_shard.py): ghost node planes appended along axis 0 are
identity rows (residual T - T_0, unit diagonal, identity Jacobian
action), with zero coupling in the value tables; the flat (n,) API
refuses them. `slab(lo, hi)` is the operator restricted to planes
[lo, hi) of the (padded) grid, one rank's share: its tables are sliced
from the whole grid's, and its residual, diagonal and table bake take
the rank's planes with one halo plane on each side, computing on those
L + 2 planes as the whole grid does and keeping the L owned rows; its
Jacobian action is K2's halo form.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
    flat_shifts,
    pitched_tables,
    stencil_matvec,
    stencil_matvec_halo,
)
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.ops.stencil import StencilMatrix


class _Face:
    __slots__ = ("axis", "side", "qw", "phi", "np_phi")

    def __init__(self, axis, side, qw, phi, np_phi):
        self.axis = axis      # grid axis 0..d-1
        self.side = side      # 0 = low face, 1 = high face
        self.qw = qw          # (q,) facet quadrature weights * |detJ|
        self.phi = phi        # (q, nloc) cell basis on the facet
        self.np_phi = np_phi  # the same, numpy (setup-time consumers)


class GridHeatOperator:
    """Replacement for HeatOperator.residual / jacobian_diag plus
    StencilMatrix.make_matvec, valid for CG-1 spaces on uniform box meshes
    with whole-boundary or whole-face flux and no MMS source."""

    def __init__(self, op: HeatOperator, flux_marker=None,
                 allow_const: bool = False, pad_axis0: int = 0,
                 tables: bool = True):
        """`flux_marker(midpoints) -> bool mask` restricts the radiation +
        convection flux to whole box faces; a marker that cuts through a
        face is rejected (use HeatOperator's gather assembly instead).
        `allow_const` takes the constant-row form where the tables allow
        it (`const_ok`; never on a padded grid). `pad_axis0` appends that
        many ghost node planes along axis 0 (identity rows). `tables`
        False leaves the whole grid's device tables until a method needs
        them (`ensure_tables`): the grid-sharded step reads only its
        slabs'."""
        fs = op.fs
        mesh = fs.mesh
        if mesh.structured is None or fs.family != "CG" or fs.degree != 1:
            raise ValueError("GridHeatOperator needs a structured box mesh "
                             "with a CG-1 space")
        if op.source_q is not None:
            raise ValueError("GridHeatOperator does not support MMS sources")
        self.op = op
        self.params = op.params
        self.dtype = op.dtype
        self.device = op.device
        self.st = StencilMatrix(op, make_tables=False)
        self.pad0 = int(pad_axis0)
        g = self.st.grid
        self.grid = (g[0] + self.pad0,) + g[1:] if self.pad0 else g
        self.dims = tuple(mesh.structured["dims"])
        self.d = len(self.dims)
        self.n = fs.n_scalar_dofs
        nloc = fs.element.nloc
        self.nloc = nloc

        bg = op.take_boundary_geometry(5 * fs.degree)
        if len(bg.cell) != len(mesh.boundary_cell):
            raise ValueError("flux restricted to a facet subset — grid path "
                             "requires whole-boundary flux or a whole-face "
                             "flux_marker")
        if flux_marker is not None:
            mids = bg.qpoints_phys.mean(axis=1)
            keep = np.asarray(flux_marker(mids), dtype=bool)
        else:
            keep = np.ones(len(bg.cell), dtype=bool)

        # group facets by (axis, side) from the outward normal; verify the
        # uniform-grid invariant (identical tables across each face)
        normal = bg.normal[:, 0, :]                       # (f, g)
        axis = np.argmax(np.abs(normal), axis=1)
        side = (normal[np.arange(len(axis)), axis] > 0).astype(int)
        cells = bg.cell
        strides = np.array(
            [int(np.prod(self.dims[i + 1:])) for i in range(self.d)])
        f = lambda a: torch.as_tensor(np.array(a), dtype=self.dtype,
                                      device=self.device)

        self.faces: list[_Face] = []
        for a in range(self.d):
            for s in (0, 1):
                sel = (axis == a) & (side == s)
                if not sel.any():
                    continue
                k = keep[sel]
                if not k.any():
                    continue          # face fully insulated by the marker
                if not k.all():
                    raise ValueError(
                        "flux_marker cuts through a box face — the grid "
                        "path handles whole faces only")
                qw = bg.qweights[sel]
                phi = bg.phi[sel]
                if (np.abs(qw - qw[0]).max() > 1e-12 * max(qw.max(), 1e-30)
                        or np.abs(phi - phi[0]).max() > 1e-12):
                    raise ValueError("non-uniform face tables — mesh is not "
                                     "a uniform box")
                # the face layer must contain every cell exactly once
                layer = cells[sel]
                ca = (layer // strides[a]) % self.dims[a]
                expect = 0 if s == 0 else self.dims[a] - 1
                n_layer = int(np.prod(self.dims)) // self.dims[a]
                if not (len(layer) == n_layer and np.all(ca == expect)
                        and len(np.unique(layer)) == n_layer):
                    raise ValueError("face layer mismatch — mesh is not a "
                                     "uniform box")
                self.faces.append(_Face(a, s, f(qw[0]), f(phi[0]),
                                        np.asarray(phi[0])))

        # local node l <-> lattice offset bits (tensor-product vertex
        # order: l = ix + 2*iy + 4*iz)
        self.loffs = [tuple((l >> i) & 1 for i in range(self.d))
                      for l in range(nloc)]
        # significant basis columns per face (off-face corners are zero)
        self._face_cols = []
        for fc in self.faces:
            cols = [l for l in range(nloc)
                    if float(np.abs(fc.np_phi[:, l]).max()) > 1e-14]
            self._face_cols.append(cols)

        self._offsets = self.st.offsets

        # mass row sums M @ 1 (for the constant-source term), in numpy,
        # over the padded grid (ghost planes: zero coupling)
        m1 = np.zeros(self.grid)
        xp = np.pad(np.ones(self.grid), 1)
        for o, off in enumerate(self._offsets):
            sl = tuple(slice(int(v), int(v) + g)
                       for v, g in zip(off, self.grid))
            m1 += self._np_padded(self.st.np_mass[o]) * xp[sl]
        self.np_M1g = m1
        self.M1g = f(m1)

        # stencil-offset id for a (l, m) corner pair
        def off_id(lo, mo):
            o = 0
            for i in range(self.d):
                o = o * 3 + (mo[i] - lo[i] + 1)
            return o
        self._pair_off = [[off_id(self.loffs[l], self.loffs[m])
                           for m in range(nloc)] for l in range(nloc)]

        self.bc_mask = op.bc_mask
        self.bc_values = op.bc_values
        mask_g = op.bc_mask.reshape(self.st.grid)
        vals_g = op.bc_values.reshape(self.st.grid)
        if self.pad0:
            pc = (0, 0) * (self.d - 1) + (0, self.pad0)
            mask_g = F.pad(mask_g, pc, value=True)
            vals_g = F.pad(vals_g, pc, value=float(op.params.T_0))
        self.bc_mask_g = mask_g
        self.bc_values_g = vals_g
        self.has_bc = op.has_bc or self.pad0 > 0
        # the whole grid on axis 0: its cells [0, dims[0]) from row 0
        self._row0 = 0
        self._cells0 = (0, self.dims[0])

        # the constant-row decomposition: the interior planes' rows are
        # one (n_off, M) row; the two axis-0 boundary planes keep their
        # full rows, so every term multiplies the same value / neighbour
        # pair in the same offset order as the table form (equal bits)
        self.const_ok = False
        self.crow_mass = self.crow_stiff = None
        self.crow_dmass = self.crow_dstiff = None
        if (allow_const and self.pad0 == 0 and self.d >= 2
                and self.grid[0] >= 4):
            gx = self.grid[0]
            M = self.n // gx
            vm2 = self.st.np_mass.reshape(self.st.n_off, gx, M)
            vs2 = self.st.np_stiff.reshape(self.st.n_off, gx, M)
            ok = True
            for v2 in (vm2, vs2):
                ref = v2[:, 1:2, :]
                dev = float(np.abs(v2[:, 1:gx - 1, :] - ref).max())
                if dev > 1e-12 * max(float(np.abs(ref).max()), 1e-300):
                    ok = False
                    break
            if ok:
                self.crow_mass = f(vm2[:, 1, :])
                self.crow_stiff = f(vs2[:, 1, :])
                self.crow_dmass = f(np.stack([vm2[:, 0], vm2[:, -1]], axis=1))
                self.crow_dstiff = f(np.stack([vs2[:, 0], vs2[:, -1]],
                                              axis=1))
                self.const_ok = True
        # per-face (q, lc, lc) basis products of the linearised flux blocks
        self._face_phiphi = [
            f(np.einsum("ql,qm->qlm", fc.np_phi[:, cols],
                        fc.np_phi[:, cols]))
            for fc, cols in zip(self.faces, self._face_cols)]

        self.vals_mass = self.vals_stiff = None
        if tables:
            self.ensure_tables()
        self._slabs: dict = {}

    def _np_padded(self, a: np.ndarray) -> np.ndarray:
        """A numpy array over the physical grid with the ghost planes
        appended as zeros."""
        if not self.pad0:
            return a
        return np.pad(a, [(0, self.pad0)] + [(0, 0)] * (a.ndim - 1))

    def ensure_tables(self) -> None:
        """Materialise the whole grid's (n_off, *grid) device tables, the
        ghost planes' zero (idempotent)."""
        if self.vals_mass is None:
            self.st.ensure_tables()
            self.vals_mass, self.vals_stiff = self.st.st_mass, self.st.st_stiff
            if self.pad0:
                pc = (0, 0) * (self.d - 1) + (0, self.pad0)
                self.vals_mass = F.pad(self.vals_mass, pc)
                self.vals_stiff = F.pad(self.vals_stiff, pc)

    def _flat_api(self) -> None:
        if self.pad0:
            raise ValueError("GridHeatOperator: the flat (n,) API is "
                             "unavailable on a padded grid; use the "
                             "grid-shaped methods (*_g)")

    def slab(self, lo: int, hi: int) -> "GridSlab":
        """The operator restricted to planes [lo, hi) of the grid (one per
        range: the step and its V-cycle's fine level share it)."""
        if (lo, hi) not in self._slabs:
            self._slabs[(lo, hi)] = GridSlab(self, lo, hi)
        return self._slabs[(lo, hi)]

    # ------------------------------------------------------------------
    def _shifted(self, xp, off):
        return xp[tuple(slice(int(v), int(v) + g)
                        for v, g in zip(off, self.grid))]

    def matvec_vals(self, vals: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
        """Stencil matvec over the node grid."""
        xp = F.pad(xg, (1, 1) * self.d)
        acc = torch.zeros(self.grid, dtype=xg.dtype, device=xg.device)
        for o, off in enumerate(self._offsets):
            acc = acc + vals[o] * self._shifted(xp, off)
        return acc

    def matvec_diff(self, vals: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
        """Difference-form stencil matvec for zero-row-sum operators (pure
        stiffness): sum_o vals[o] * (x_{i+o} - x_i), skipping the center.
        Annihilates constant fields exactly in floating point."""
        xp = F.pad(xg, (1, 1) * self.d)
        center = (3 ** self.d - 1) // 2
        acc = torch.zeros(self.grid, dtype=xg.dtype, device=xg.device)
        for o, off in enumerate(self._offsets):
            if o == center:
                continue
            acc = acc + vals[o] * (self._shifted(xp, off) - xg)
        return acc

    # ---- constant-row apply -------------------------------------------
    def _crow_conv(self, rowvals, brow, xg, diff: bool = False):
        """Grid-shaped stencil apply from the constant-row decomposition:
        one flat (gx, M) pass with the (n_off, M) interior row, then the
        two axis-0 boundary rows recomputed with their full rows
        (n_off, 2, M) and written over the first pass's, so the result
        equals matvec_vals / matvec_diff bit for bit. `diff=True` is the
        difference form of matvec_diff (the center offset skipped)."""
        gx = self.grid[0]
        M = rowvals.shape[-1]
        shifts = flat_shifts(self.grid)
        P = max(abs(s) for _, s in shifts)
        center = (self.st.n_off - 1) // 2
        x2 = xg.reshape(gx, M)
        xp = F.pad(x2, (P, P, 1, 1))
        acc = torch.zeros((gx, M), dtype=x2.dtype, device=x2.device)
        for o, (dx, sft) in enumerate(shifts):
            if diff and o == center:
                continue
            win = xp[dx:dx + gx, P + sft:P + sft + M]
            acc = acc + rowvals[o][None, :] * (win - x2 if diff else win)
        rows = []
        for r_i, row in ((0, 0), (1, gx - 1)):
            w = torch.zeros((1, M), dtype=x2.dtype, device=x2.device)
            xr = x2[row:row + 1]
            for o, (dx, sft) in enumerate(shifts):
                if diff and o == center:
                    continue
                win = xp[row + dx:row + dx + 1, P + sft:P + sft + M]
                w = w + brow[o, r_i][None, :] * (win - xr if diff else win)
            rows.append(w)
        acc = torch.cat([rows[0], acc[1:gx - 1], rows[1]], dim=0)
        return acc.reshape(self.grid)

    def _flux_lin_tables(self, Tg, dt):
        """Per-face (..., lc, lc) linearised-flux blocks at the frozen T:
        W[..., l, m] = sum_q w_q phi_ql phi_qm, w = dflux/dT dt qw, the
        face-local form of the boundary blocks stencil_values_g adds into
        the tables."""
        p = self.params
        out = []
        for fc, cols, phiphi in zip(self.faces, self._face_cols,
                                    self._face_phiphi):
            phi = fc.phi[:, cols]
            corners = self._face_corners(Tg, fc, cols)
            Tb = torch.einsum("...l,ql->...q", corners, phi)
            w = (p.boundary_scale
                 * (4.0 * p.sigma * p.epsilon * Tb**3 + p.htc)
                 * (dt * fc.qw))                           # (..., q)
            out.append((w[..., :, None, None] * phiphi).sum(-3))
        return out

    def _apply_flux_lin(self, WW, xg, yg):
        for fc, cols, W in zip(self.faces, self._face_cols, WW):
            xc = self._face_corners(xg, fc, cols)          # (..., m)
            contrib = (W * xc[..., None, :]).sum(-1)       # (..., l)
            for j, l in enumerate(cols):
                yg[self._corner_slices(fc, l)] += contrib[..., j]
        return yg

    # ------------------------------------------------------------------
    def _corner_slices(self, face: _Face, l: int):
        """Static node-grid slices addressing corner l of every cell in the
        face's boundary layer."""
        off = self.loffs[l]
        idx = []
        for i in range(self.d):
            if i == face.axis:
                base = (0 if face.side == 0 else self.dims[i] - 1) + off[i]
                if i == 0:
                    base -= self._row0
                idx.append(slice(base, base + 1))
            elif i == 0:
                c0, c1 = self._cells0
                idx.append(slice(c0 + off[0] - self._row0,
                                 c1 + off[0] - self._row0))
            else:
                idx.append(slice(off[i], off[i] + self.dims[i]))
        return tuple(idx)

    def _face_corners(self, Tg, face: _Face, cols):
        return torch.stack(
            [Tg[self._corner_slices(face, l)] for l in cols], dim=-1)

    # ------------------------------------------------------------------
    def residual(self, T: torch.Tensor, T_prev: torch.Tensor,
                 dt=None) -> torch.Tensor:
        self._flat_api()
        return self.residual_g(T.reshape(self.grid),
                               T_prev.reshape(self.grid), dt).reshape(-1)

    def residual_g(self, Tg, Tpg, dt=None):
        """Grid-shaped residual (*grid) -> (*grid)."""
        dt = self.op.dt if dt is None else dt
        if not self.has_bc:
            return self._base_residual_g(Tg, Tpg, dt)
        T_eff = torch.where(self.bc_mask_g, self.bc_values_g, Tg)
        r = self._base_residual_g(T_eff, Tpg, dt)
        return torch.where(self.bc_mask_g, Tg - self.bc_values_g, r)

    def _base_residual_g(self, Tg, Tpg, dt):
        p = self.params
        # M (T - Tp) + dt (alpha K) T - dt f M 1: the mass acts on the
        # small per-step difference and the stiffness in difference form,
        # so constants are annihilated exactly (no ~800 K cancellation)
        if self.const_ok:
            rg = (self._crow_conv(self.crow_mass, self.crow_dmass, Tg - Tpg)
                  + dt * self._crow_conv(self.crow_stiff, self.crow_dstiff,
                                         Tg, diff=True)
                  - dt * p.f * self.M1g)
        else:
            self.ensure_tables()
            rg = (self.matvec_vals(self.vals_mass, Tg - Tpg)
                  + dt * self.matvec_diff(self.vals_stiff, Tg)
                  - dt * p.f * self.M1g)
        for fc, cols in zip(self.faces, self._face_cols):
            phi = fc.phi[:, cols]                          # (q, lc)
            corners = self._face_corners(Tg, fc, cols)     # (..., lc)
            Tb = torch.einsum("...l,ql->...q", corners, phi)
            gflux = p.boundary_scale * (
                (p.sigma * p.epsilon) * (Tb**4 - p.T_ambient**4)
                + p.htc * (Tb - p.T_ambient))
            contrib = torch.einsum("...q,q,ql->...l", gflux, dt * fc.qw, phi)
            for j, l in enumerate(cols):
                rg[self._corner_slices(fc, l)] += contrib[..., j]
        return rg

    # ------------------------------------------------------------------
    def jacobian_diag(self, T: torch.Tensor, dt=None) -> torch.Tensor:
        self._flat_api()
        return self.jacobian_diag_g(T.reshape(self.grid), dt).reshape(-1)

    def jacobian_diag_g(self, Tg, dt=None):
        p = self.params
        dt = self.op.dt if dt is None else dt
        center = (3 ** self.d - 1) // 2
        if self.const_ok:
            gx = self.grid[0]
            row = self.crow_mass[center] + dt * self.crow_stiff[center]
            br = self.crow_dmass[center] + dt * self.crow_dstiff[center]
            d = torch.cat([br[0:1], row[None, :].expand(gx - 2, -1),
                           br[1:2]], dim=0).reshape(self.grid)
        else:
            self.ensure_tables()
            d = self.vals_mass[center] + dt * self.vals_stiff[center]
        for fc, cols in zip(self.faces, self._face_cols):
            phi = fc.phi[:, cols]
            corners = self._face_corners(Tg, fc, cols)
            Tb = torch.einsum("...l,ql->...q", corners, phi)
            dflux = p.boundary_scale * (
                4.0 * p.sigma * p.epsilon * Tb**3 + p.htc)
            contrib = torch.einsum("...q,q,ql->...l", dflux, dt * fc.qw,
                                   phi * phi)
            for j, l in enumerate(cols):
                d[self._corner_slices(fc, l)] += contrib[..., j]
        if self.has_bc:
            d = torch.where(self.bc_mask_g, torch.ones_like(d), d)
        return d

    # ------------------------------------------------------------------
    def stencil_values(self, T: torch.Tensor, dt) -> torch.Tensor:
        self._flat_api()
        return self.stencil_values_g(T.reshape(self.grid), dt)

    def stencil_values_g(self, Tg, dt):
        """J(T) stencil values (n_off, *grid) with the boundary
        linearization added by static-slice writes (no scatter)."""
        p = self.params
        self.ensure_tables()
        vals = self.vals_mass + dt * self.vals_stiff       # (n_off, *grid)
        for fc, cols in zip(self.faces, self._face_cols):
            phi = fc.phi[:, cols]
            corners = self._face_corners(Tg, fc, cols)
            Tb = torch.einsum("...l,ql->...q", corners, phi)
            w = (p.boundary_scale
                 * (4.0 * p.sigma * p.epsilon * Tb**3 + p.htc)
                 * (dt * fc.qw))                           # (..., q)
            for jl, l in enumerate(cols):
                sl = self._corner_slices(fc, l)
                for jm, m in enumerate(cols):
                    blk = torch.einsum("...q,q,q->...", w, phi[:, jl],
                                       phi[:, jm])
                    o = self._pair_off[l][m]
                    vals[(o,) + sl] += blk
        return vals

    def _mv_flat(self, vals, stream_dtype=None):
        """Flat-vector matvec from materialised values: the CUDA stencil
        kernel on the GPU, its plain twin on the CPU. `stream_dtype`
        (torch.bfloat16) casts the value tables alone, once here (on the
        card into the pitched layout of K2's bf16 kernel); the vector and
        the sums keep the operator's dtype."""
        if self.d > 1:
            vals2 = vals.reshape(vals.shape[0], self.grid[0], -1)
            if stream_dtype is not None:
                vals2 = (pitched_tables(vals2, stream_dtype) if vals2.is_cuda
                         else vals2.to(stream_dtype))
            return lambda v: self.st.matvec_flat(vals2, v)
        if stream_dtype is not None:
            vals = vals.to(stream_dtype)
        return lambda v: self.matvec_vals(
            vals, v.reshape(self.grid)).reshape(-1)

    def make_matvec(self, T: torch.Tensor, dt, stream_dtype=None):
        self._flat_api()
        if self.const_ok and stream_dtype is None:
            # constant-row form: no value table; the flux linearisation
            # at the frozen T rides as face-local blocks
            rowvals = self.crow_mass + dt * self.crow_stiff
            drow = self.crow_dmass + dt * self.crow_dstiff
            WW = self._flux_lin_tables(T.reshape(self.grid), dt)

            def mv(v):
                yg = self._crow_conv(rowvals, drow, v)
                if WW:
                    yg = self._apply_flux_lin(WW, v.reshape(self.grid), yg)
                return yg.reshape(-1)
        else:
            vals = self.stencil_values(T, dt)
            mv = self._mv_flat(vals, stream_dtype=stream_dtype)
        if self.has_bc:
            mask = self.bc_mask
            return lambda v: torch.where(
                mask, v, mv(torch.where(mask, torch.zeros_like(v), v)))
        return mv

    def make_matvec_g(self, Tg, dt):
        """Grid-shaped Jacobian action: the tables baked at Tg, applied by
        K2 over the whole (padded) grid; identity on masked rows."""
        vals2 = self.stencil_values_g(Tg, dt).reshape(
            self.st.n_off, self.grid[0], -1)
        mv = lambda v: stencil_matvec(vals2, v.reshape(-1),  # noqa: E731
                                      self.grid).reshape(self.grid)
        if self.has_bc:
            mask = self.bc_mask_g
            return lambda v: torch.where(
                mask, v, mv(torch.where(mask, torch.zeros_like(v), v)))
        return mv


class GridSlab(GridHeatOperator):
    """A GridHeatOperator restricted to planes [lo, hi) of its (padded)
    grid: one rank's share of the grid-sharded step. It computes on the
    L + 2 planes [lo - 1, hi + 1) (the whole grid's methods, on that
    window: tables, masks and M 1 sliced from the whole grid's, zero
    outside it; the box faces that meet the window; the cells of the
    window) and keeps the L owned rows, each equal to the whole grid's
    row. Its inputs carry the halo: `T_ext` (L + 2, *grid[1:]), the
    neighbours' planes first and last, zeros where there is none
    (parallel/comm.py halo_exchange)."""

    def __init__(self, op: GridHeatOperator, lo: int, hi: int):
        self.__dict__.update(op.__dict__)
        self._slabs = {}
        G0 = op.grid[0]
        if not 0 <= lo < hi <= G0:
            raise ValueError(f"slab [{lo}, {hi}) outside the grid's {G0} "
                             f"planes")
        self.L = hi - lo
        self.slab_grid = (self.L,) + op.grid[1:]
        e0, E = lo - 1, self.L + 2
        self.grid = (E,) + op.grid[1:]
        self._row0 = e0
        self._cells0 = (max(0, e0), min(self.dims[0], e0 + E - 1))
        def window(arr: np.ndarray, axis: int = 0) -> np.ndarray:
            """The window's planes of an array over the grid (or over its
            physical planes: the ghost planes' tables are zero), zero
            outside it."""
            a, b = max(e0, 0), min(e0 + E, arr.shape[axis])
            sl = [slice(None)] * arr.ndim
            sl[axis] = slice(a, max(a, b))
            pads = [(0, 0)] * arr.ndim
            pads[axis] = (a - e0, e0 + E - max(a, b))
            return np.pad(arr[tuple(sl)], pads)

        f = lambda x, dt=self.dtype: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(x), dtype=dt, device=self.device)
        self.vals_mass = f(window(op.st.np_mass, 1))
        self.vals_stiff = f(window(op.st.np_stiff, 1))
        self.M1g = f(window(op.np_M1g))
        mask = op.bc_mask_g.cpu().numpy()
        self.bc_mask_g = f(window(mask), torch.bool)
        self.bc_values_g = f(window(op.bc_values_g.cpu().numpy()))
        # the Jacobian action masks where an owned row is masked (each
        # rank masks its own rows before the halo carries them)
        self.own_mask = (self.bc_mask_g[1:-1] if bool(mask[lo:hi].any())
                         else None)
        # the box faces that meet the window: a face normal to axis 0
        # where its plane lies in it, the others where it holds a cell
        keep = [k for k, fc in enumerate(op.faces)
                if (fc.axis == 0 and 0 <= (0 if fc.side == 0 else
                                           self.dims[0]) - e0 < E)
                or (fc.axis != 0 and self._cells0[1] > self._cells0[0])]
        self.faces = [op.faces[k] for k in keep]
        self._face_cols = [op._face_cols[k] for k in keep]
        self._face_phiphi = [op._face_phiphi[k] for k in keep]
        self.const_ok = False

    def residual_r(self, T_ext, Tp_ext, dt=None):
        """The owned rows of the residual (L, *grid[1:])."""
        return self.residual_g(T_ext, Tp_ext, dt)[1:-1]

    def jacobian_diag_r(self, T_ext, dt=None):
        return self.jacobian_diag_g(T_ext, dt)[1:-1]

    def stencil_values_r(self, T_ext, dt):
        """The owned rows' tables at T, (n_off, L, M), contiguous."""
        vals = self.stencil_values_g(T_ext, dt)[:, 1:-1]
        return vals.reshape(self.st.n_off, self.L, -1).contiguous()

    def make_matvec_r(self, T_ext, dt, halo):
        """v (L, *grid[1:]) -> J(T) v on the owned rows: the tables baked
        at T, applied by K2's halo form to v with its halo planes
        (`halo(v) -> (L + 2, ...)`, a collective: every rank applies
        together); identity on masked rows."""
        vals2 = self.stencil_values_r(T_ext, dt)
        shape = self.slab_grid

        def mv(v):
            xe = halo(v)
            return stencil_matvec_halo(vals2, xe.reshape(-1),
                                       shape).reshape(shape)
        mask = self.own_mask
        if mask is not None:
            return lambda v: torch.where(
                mask, v, mv(torch.where(mask, torch.zeros_like(v), v)))
        return mv
