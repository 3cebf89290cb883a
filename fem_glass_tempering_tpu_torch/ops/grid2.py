"""Gather-free heat operator for CG-2 (Q2) on uniform box meshes, and its
p-multigrid preconditioner.

Counterpart of fem_glass_tempering_tpu/ops/grid2.py (GridHeatOperator2,
Q2MG). On a uniform box the Q2 dof lattice is the 2x-refined CG-1 node
lattice, L = (2*n0+1, ..., 2*n_{d-1}+1) in C order, and the assembled mass
and stiffness are Kronecker products of 1D assembled 5-band matrices:

    M3 = M1x (x) M1y (x) M1z
    K3 = K1x (x) M1y (x) M1z + M1x (x) K1y (x) M1z + M1x (x) M1y (x) K1z

so every operator apply is a few sum-factorised 1D banded passes (5 static
shifted slices per pass with per-plane weights). The nonlinear boundary
flux is evaluated per box face from the 9 face-local basis columns read by
strided lattice slices; the per-cell face contributions go back onto the
face plane by pad + interleave and one contiguous plane add (no strided
scatter, no repeated-index add: the card repeats its bits).

`Q2MG` smooths on the Q2 lattice (Chebyshev over a point diagonal, or over
a batched pentadiagonal line solve along the strongly coupled axis of an
anisotropic plate), transfers to the embedded CG-1 node grid (even lattice
points) by the exact Q1 -> Q2 embedding, and takes one CG-1 V-cycle as
its coarse solve, whose smoothed levels apply the hand-written stencil
kernel (ops/cuda_stencil.py) on the GPU. The JAX version's coarse V-cycle
is its grid-shaped `GridMG` (solver/grid_mg.py) over a node grid whose
axis 0 may carry `coarse_pad0` ghost planes (the grid-sharded step's);
without that padding the two compute the same cycle, so the unsharded
default (`coarse_kind="geometric"`) takes `GeometricMG` (solver/
multigrid.py) on the flattened coarse residual, and `coarse_kind="grid"`
takes JAX's route.

For the Krylov loop a materialised (5^d, *L) value table is also
available (`matvec_form="table"` / `make_matvec(..., form="table")`), baked
from 1D band outer products and the linearised face-flux blocks, and
applied as 5^d shifted slices.

The grid-sharded CG-2 step (parallel/grid_shard.py) splits the lattice
along axis 0, padded with ghost planes to a multiple of the ranks:

- `GridQ2Slab` (`GridHeatOperator2.slab(lo, hi)`): the kron-form operator
  on lattice planes [lo, hi), computed on the window [lo - 2, hi + 2)
  (a 1D Q2 band couples planes two apart; the kron chain makes one axis-0
  pass a term, after its axis-1 and axis-2 passes, so a depth-2 halo
  serves a whole Jacobian action), its axis-0 bands and tables sliced from
  the whole lattice's, the face terms over the cells that touch the
  rank's planes. Its rows equal the whole lattice's; ghost rows are zero
  rows (the diagonal: one).
- `LatticeHalo`: that window, through one re-partition
  (parallel/comm.py Repartition) of the real planes.
- `LatticeNodeTransfers`: the maps between a rank's lattice rows and its
  rows of the padded CG-1 node grid (the restriction, the prolongation
  and the even-stride injection): the two splits drift apart along axis
  0, so each is one re-partition, then the whole grid's formula on the
  window.
- `RankQ2MG`: Q2MG's grid route on one rank: smoothing on the slab (lines
  along axis 1 or 2 factored on the rank's columns, lines along axis 0
  solved replicated after an all-gather), the power iteration's dots
  summed over the ranks, and the coarse V-cycle in GridMG's rank form
  (solver/grid_mg.py RankGridMG) through the transfers.

Everything here is plain PyTorch, as it is plain XLA in the JAX package,
in the JAX version's order of operations.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fem_glass_tempering_tpu_torch.fem.elements import lagrange_element
from fem_glass_tempering_tpu_torch.fem.quadrature import gauss_legendre_01
from fem_glass_tempering_tpu_torch.ops.assembly import build_boundary_geometry
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator


def _pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Zero-pad `x` by (lo, hi) along `axis`."""
    return F.pad(x, [0, 0] * (x.dim() - 1 - axis) + [lo, hi])


class _Face2:
    __slots__ = ("axis", "side", "qw", "phi", "np_qw", "np_phi", "cols",
                 "phi_c", "plane_pos")

    def __init__(self, axis, side, qw, phi):
        self.axis = axis
        self.side = side
        self.qw = qw          # (q,) facet weights * |detJ|
        self.phi = phi        # (q, nloc) cell basis on the facet


def _assemble_1d_bands(n_cells: int, h: float):
    """Assembled 1D Q2 mass/stiffness on n_cells uniform cells of size h,
    as (5, g) band arrays with band index b = column-row offset + 2 and
    g = 2*n_cells + 1 lattice points. Out-of-range couplings are exact
    zeros (the pad-slice matvec relies on that)."""
    e1 = lagrange_element("interval", 2)
    x, w = gauss_legendre_01(3)               # exact to degree 5 (>= phi*phi)
    phi = e1.tabulate(x.reshape(-1, 1))       # (q, 3)
    dphi = e1.tabulate_grad(x.reshape(-1, 1))[:, :, 0]
    m_el = h * np.einsum("q,ql,qm->lm", w, phi, phi)
    k_el = (1.0 / h) * np.einsum("q,ql,qm->lm", w, dphi, dphi)
    off1 = np.rint(e1.nodes[:, 0] * 2).astype(int)        # local -> lattice
    g = 2 * n_cells + 1
    M = np.zeros((5, g))
    K = np.zeros((5, g))
    for c in range(n_cells):
        base = 2 * c
        for l in range(3):
            row = base + off1[l]
            for m in range(3):
                delta = off1[m] - off1[l]
                M[delta + 2, row] += m_el[l, m]
                K[delta + 2, row] += k_el[l, m]
    return M, K


def _np_outer(vs):
    out = vs[0]
    for v in vs[1:]:
        out = np.multiply.outer(out, v)
    return out


class GridHeatOperator2:
    """Replacement for HeatOperator.residual / jacobian_diag / make_matvec
    for CG-2 spaces on uniform box meshes with whole-boundary (or
    whole-face) radiation + convection flux and no MMS source."""

    def __init__(self, op: HeatOperator, flux_marker=None,
                 matvec_form: str = "kron"):
        fs = op.fs
        mesh = fs.mesh
        if mesh.structured is None or fs.family != "CG" or fs.degree != 2:
            raise ValueError("GridHeatOperator2 needs a structured box mesh "
                             "with a CG-2 space")
        if op.source_q is not None:
            raise ValueError("GridHeatOperator2 does not support MMS sources")
        if matvec_form not in ("kron", "table"):
            raise ValueError(matvec_form)
        self.op = op
        self.params = op.params
        self.dtype = op.dtype
        self.device = op.device
        self.matvec_form = matvec_form
        self.dims = tuple(mesh.structured["dims"])
        self.d = d = len(self.dims)
        self.grid = tuple(2 * n + 1 for n in self.dims)
        # a slab's window along axis 0 (GridQ2Slab): its first lattice row
        # and the cells [c0, c1) whose face terms it computes
        self._row0, self._cells0 = 0, (0, self.dims[0])
        self._slabs: dict = {}
        self.n = fs.n_scalar_dofs
        assert int(np.prod(self.grid)) == self.n
        nloc = fs.element.nloc
        self.nloc = nloc
        # the table form's offsets, each in {0..4}^d (coupling delta + 2)
        self._offsets = list(np.ndindex(*([5] * d)))

        # local node l <-> lattice offset (in {0,1,2}^d): reference axis i
        # maps to grid axis i, the CG-1 vertex-bit convention
        self.loffs = [tuple(int(v) for v in np.rint(fs.element.nodes[l] * 2))
                      for l in range(nloc)]
        # the geometric-dedup dofmap must coincide with C-order lattice
        # numbering (fem/functionspace.py sorts quantized coordinates
        # lexicographically, which is exactly this layout on a box)
        strides = np.array([int(np.prod(self.grid[i + 1:]))
                            for i in range(d)])
        cidx = np.stack(np.meshgrid(*[np.arange(n) for n in self.dims],
                                    indexing="ij"), axis=-1).reshape(-1, d)
        loff_arr = np.array(self.loffs)                     # (nloc, d)
        expected = ((2 * cidx[:, None, :] + loff_arr[None, :, :])
                    @ strides).astype(np.int32)
        if not np.array_equal(expected, fs.dofmap):
            raise ValueError("CG-2 dofmap is not lattice-ordered")

        # 1D assembled band matrices per axis (numpy at setup)
        lengths = tuple(mesh.structured["lengths"])
        self.np_bands = []
        for a in range(d):
            h = lengths[a] / self.dims[a]
            self.np_bands.append(_assemble_1d_bands(self.dims[a], h))
        f = lambda arr: torch.as_tensor(np.array(arr), dtype=op.dtype,
                                        device=op.device)
        self.bands_m = [f(M) for M, _ in self.np_bands]
        self.bands_k = [f(K) for _, K in self.np_bands]

        # UNSCALED mass row sums M3 @ 1 for the constant source term (the
        # -dt*f*v*dx term carries no c_mass factor): Kron of 1D row sums
        self.M1g = f(_np_outer([M.sum(axis=0) for M, _ in self.np_bands]))

        # ---- boundary faces (radiation + convection flux) -------------
        bq = 5 * fs.degree
        bg = build_boundary_geometry(mesh, fs, bq, with_grad=False)
        if len(bg.cell) != len(mesh.boundary_cell):
            raise ValueError("flux restricted to a facet subset — grid path "
                             "requires whole-boundary flux or a whole-face "
                             "flux_marker")
        if flux_marker is not None:
            mids = bg.qpoints_phys.mean(axis=1)
            keep = np.asarray(flux_marker(mids), dtype=bool)
        else:
            keep = np.ones(len(bg.cell), dtype=bool)
        normal = bg.normal[:, 0, :]
        axis = np.argmax(np.abs(normal), axis=1)
        side = (normal[np.arange(len(axis)), axis] > 0).astype(int)
        cells = bg.cell
        cstrides = np.array([int(np.prod(self.dims[i + 1:]))
                             for i in range(d)])
        self.faces: list[_Face2] = []
        for a in range(d):
            for s in (0, 1):
                sel = (axis == a) & (side == s)
                if not sel.any():
                    continue
                k = keep[sel]
                if not k.any():
                    continue
                if not k.all():
                    raise ValueError("flux_marker cuts through a box face")
                qw = bg.qweights[sel]
                phi = bg.phi[sel]
                if (np.abs(qw - qw[0]).max() > 1e-12 * max(qw.max(), 1e-30)
                        or np.abs(phi - phi[0]).max() > 1e-12):
                    raise ValueError("non-uniform face tables — mesh is not "
                                     "a uniform box")
                layer = cells[sel]
                ca = (layer // cstrides[a]) % self.dims[a]
                expect = 0 if s == 0 else self.dims[a] - 1
                n_layer = int(np.prod(self.dims)) // self.dims[a]
                if not (len(layer) == n_layer and np.all(ca == expect)
                        and len(np.unique(layer)) == n_layer):
                    raise ValueError("face layer mismatch — mesh is not a "
                                     "uniform box")
                fc = _Face2(a, s, f(qw[0]), f(phi[0]))
                fc.np_qw = np.asarray(qw[0])
                fc.np_phi = np.asarray(phi[0])
                fc.cols = [l for l in range(nloc)
                           if float(np.abs(fc.np_phi[:, l]).max()) > 1e-14]
                fc.phi_c = f(fc.np_phi[:, fc.cols])          # (q, lc)
                # position of col j in the (3,)*len(plane axes) local box
                plane_axes = [i for i in range(d) if i != a]
                pos = np.zeros((3,) * len(plane_axes), dtype=np.int64)
                for j, l in enumerate(fc.cols):
                    pos[tuple(self.loffs[l][i] for i in plane_axes)] = j
                fc.plane_pos = torch.as_tensor(pos.reshape(-1),
                                               device=op.device)
                self.faces.append(fc)
        # per-face (q, lc, lc) basis products for the linearized flux
        self._face_phiphi = [
            f(np.einsum("ql,qm->qlm", fc.np_phi[:, fc.cols],
                        fc.np_phi[:, fc.cols]))
            for fc in self.faces]

        # ---- Dirichlet lifting ----------------------------------------
        self.bc_mask = op.bc_mask
        self.bc_values = op.bc_values
        self.bc_mask_g = op.bc_mask.reshape(self.grid)
        self.bc_values_g = op.bc_values.reshape(self.grid)
        self.has_bc = op.has_bc

        # host Gershgorin statistics for the smoother bounds (Q2MG):
        # |A| row sums <= sum_t outer(|band_t| row sums); diag exact
        p = op.params
        dabs_m, dabs_k, dg_m, dg_k = [], [], [], []
        for a in range(d):
            M, K = self.np_bands[a]
            dabs_m.append(np.abs(M).sum(axis=0))
            dabs_k.append(np.abs(K).sum(axis=0))
            dg_m.append(M[2])
            dg_k.append(K[2])
        mass_abs = _np_outer(dabs_m)
        stiff_abs = sum(_np_outer([dabs_k[t] if t == a else dabs_m[t]
                                   for t in range(d)]) for a in range(d))
        mass_diag = _np_outer(dg_m)
        stiff_diag = sum(_np_outer([dg_k[t] if t == a else dg_m[t]
                                    for t in range(d)]) for a in range(d))
        # boundary linearization at T_0 (abs-sum and diagonal per face)
        b_abs = np.zeros(self.grid)
        b_diag = np.zeros(self.grid)
        dflux0 = p.boundary_scale * (4.0 * p.sigma * p.epsilon
                                     * p.T_0 ** 3 + p.htc)
        for fc in self.faces:
            phi = fc.np_phi[:, fc.cols]
            blocks = dflux0 * np.einsum("q,ql,qm->lm", fc.np_qw, phi, phi)
            for jl, l in enumerate(fc.cols):
                sl = self._corner_slices(fc, l)
                b_abs[sl] += np.abs(blocks[jl]).sum()
                b_diag[sl] += blocks[jl, jl]
        self.gersh = {
            "mass_abs": op.c_mass * mass_abs,
            "mass_diag": op.c_mass * mass_diag,
            "stiff_abs": op.c_diff * stiff_abs,
            "stiff_diag": op.c_diff * stiff_diag,
            "b_abs": b_abs, "b_diag": b_diag,
        }

    # ------------------------------------------------------------------
    def _corner_slices(self, face: _Face2, l: int):
        """Static strided lattice slices addressing local node l of every
        cell in the face's boundary layer (stride 2: cell i -> lattice
        2*i + off); along axis 0 the cells [c0, c1), from lattice row
        `_row0` on (the whole lattice: all cells, from row 0)."""
        off = self.loffs[l]
        c0, c1 = self._cells0
        idx = []
        for i in range(self.d):
            r0 = self._row0 if i == 0 else 0
            if i == face.axis:
                base = (0 if face.side == 0
                        else 2 * (self.dims[i] - 1)) + off[i] - r0
                idx.append(slice(base, base + 1))
            elif i == 0:
                idx.append(slice(2 * c0 + off[0] - r0,
                                 2 * c1 - 1 + off[0] - r0, 2))
            else:
                idx.append(slice(off[i], off[i] + 2 * self.dims[i] - 1, 2))
        return tuple(idx)

    def _face_corners(self, Tg, face: _Face2):
        return torch.stack(
            [Tg[self._corner_slices(face, l)] for l in face.cols], dim=-1)

    # ---- gather-free face scatter ------------------------------------
    @staticmethod
    def _interleave_axis(even, odd, axis):
        """even (n+1) and odd (n) along `axis` -> interleaved (2n+1)."""
        n = odd.shape[axis]
        head = even.narrow(axis, 0, n)
        pairs = torch.stack([head, odd], dim=axis + 1)
        shp = list(even.shape)
        shp[axis] = 2 * n
        pairs = pairs.reshape(shp)
        last = even.narrow(axis, n, 1)
        return torch.cat([pairs, last], dim=axis)

    @classmethod
    def _assemble_cells_to_lattice(cls, arr, n_cell_axes):
        """(*cell_dims, 3, ..., 3) with one trailing local axis per cell
        axis -> lattice array (*[2n+1]): per axis, out[2i + o] += arr[i, o]
        via pad + interleave (no scatter)."""
        for a in range(n_cell_axes):
            la = arr.dim() - (n_cell_axes - a)
            c0 = arr.select(la, 0)
            c1 = arr.select(la, 1)
            c2 = arr.select(la, 2)
            even = _pad_axis(c0, a, 0, 1) + _pad_axis(c2, a, 1, 0)
            arr = cls._interleave_axis(even, c1, a)
        return arr

    def _face_plane_add(self, yg, face: _Face2, contrib):
        """Add per-cell face contributions (face-layer cells x len(cols))
        into the lattice array yg in place, gather-free: the columns are
        placed in a (3,)*(d-1) local box, assembled onto the face plane by
        pad + interleave, and added with one contiguous plane slice. yg
        must be a tensor the caller owns."""
        az = face.axis
        c = contrib.squeeze(az)                # (*plane_cells, lc)
        base = (0 if face.side == 0 else 2 * self.dims[az]) - (
            self._row0 if az == 0 else 0)
        if self.d == 1:                        # a single end point
            yg.narrow(0, base, 1).add_(c.reshape(1))
            return yg
        npa = self.d - 1
        c3 = c[..., face.plane_pos].reshape(c.shape[:-1] + (3,) * npa)
        plane = self._assemble_cells_to_lattice(c3, npa)
        dst = yg.narrow(az, base, 1)
        if az != 0:
            # the plane's rows along axis 0: those of the cells [c0, c1)
            c0, c1 = self._cells0
            dst = dst.narrow(0, 2 * c0 - self._row0, 2 * (c1 - c0) + 1)
        dst.add_(plane.unsqueeze(az))
        return yg

    # ---- 1D banded applies (sum factorization) -----------------------
    def _apply1d(self, band, xg, axis, diff: bool = False):
        """Apply a (5, g) banded 1D operator along `axis` of the lattice:
        5 static shifted slices with per-plane weights, in band order.
        `diff=True` is the difference form sum_{o != 2} band_o (x_{i+o} -
        x_i), which annihilates along-axis-constant fields exactly in
        floating point (zero-row-sum stiffness)."""
        g = xg.shape[axis]
        xp = _pad_axis(xg, axis, 2, 2)
        shape = [1] * xg.dim()
        shape[axis] = g
        acc = None
        for o in range(5):
            if diff and o == 2:
                continue
            sl = xp.narrow(axis, o, g)
            term = band[o].reshape(shape) * ((sl - xg) if diff else sl)
            acc = term if acc is None else acc + term
        return acc

    def _mass3(self, xg):
        for a in range(self.d):
            xg = self._apply1d(self.bands_m[a], xg, a)
        return xg

    def _stiff3(self, xg):
        """K3 x by sum factorization with difference-form 1D stiffness
        passes (7 banded applies in 3D instead of 9: the trailing-axis
        mass chain is shared)."""
        d = self.d
        if d == 1:
            return self._apply1d(self.bands_k[0], xg, 0, diff=True)
        # suffix[a] = M_{a+1} ... M_{d-1} x
        suffix = [xg]
        for a in range(d - 1, 0, -1):
            suffix.insert(0, self._apply1d(self.bands_m[a], suffix[0], a))
        # Horner over the shared prefix: R_a = K_a suffix[a] + M_a R_{a+1}
        acc = self._apply1d(self.bands_k[d - 1], suffix[d - 1], d - 1,
                            diff=True)
        for a in range(d - 2, -1, -1):
            acc = self._apply1d(self.bands_m[a], acc, a)
            acc = acc + self._apply1d(self.bands_k[a], suffix[a], a,
                                      diff=True)
        return acc

    def _face_Tb(self, Tg, fc: _Face2):
        """The temperature at the face's quadrature points, per cell."""
        return torch.einsum("...l,ql->...q", self._face_corners(Tg, fc),
                            fc.phi_c)

    # ------------------------------------------------------------------
    def residual(self, T: torch.Tensor, T_prev: torch.Tensor,
                 dt=None) -> torch.Tensor:
        return self.residual_g(T.reshape(self.grid),
                               T_prev.reshape(self.grid), dt).reshape(-1)

    def residual_g(self, Tg, Tpg, dt=None):
        dt = self.op.dt if dt is None else dt
        if not self.has_bc:
            return self._base_residual_g(Tg, Tpg, dt)
        T_eff = torch.where(self.bc_mask_g, self.bc_values_g, Tg)
        r = self._base_residual_g(T_eff, Tpg, dt)
        return torch.where(self.bc_mask_g, Tg - self.bc_values_g, r)

    def _base_residual_g(self, Tg, Tpg, dt):
        p = self.params
        # mass on the per-step DIFFERENCE + difference-form stiffness: no
        # ~800 K cancellation, constants annihilated exactly
        rg = (self.op.c_mass * self._mass3(Tg - Tpg)
              + (dt * self.op.c_diff) * self._stiff3(Tg)
              - (dt * p.f) * self.M1g)
        for fc in self.faces:
            Tb = self._face_Tb(Tg, fc)
            gflux = p.boundary_scale * (
                (p.sigma * p.epsilon) * (Tb**4 - p.T_ambient**4)
                + p.htc * (Tb - p.T_ambient))
            contrib = torch.einsum("...q,q,ql->...l", gflux, dt * fc.qw,
                                   fc.phi_c)
            rg = self._face_plane_add(rg, fc, contrib)
        return rg

    # ------------------------------------------------------------------
    def jacobian_diag(self, T: torch.Tensor, dt=None) -> torch.Tensor:
        return self.jacobian_diag_g(T.reshape(self.grid), dt).reshape(-1)

    def jacobian_diag_g(self, Tg, dt=None):
        p = self.params
        dt = self.op.dt if dt is None else dt
        d = self.d

        def outer(vs):
            out = vs[0]
            for v in vs[1:]:
                out = out[..., None] * v
            return out

        dm = [self.bands_m[a][2] for a in range(d)]
        dk = [self.bands_k[a][2] for a in range(d)]
        dg = self.op.c_mass * outer(dm)
        for a in range(d):
            dg = dg + (dt * self.op.c_diff) * outer(
                [dk[t] if t == a else dm[t] for t in range(d)])
        for fc in self.faces:
            Tb = self._face_Tb(Tg, fc)
            dflux = p.boundary_scale * (
                4.0 * p.sigma * p.epsilon * Tb**3 + p.htc)
            contrib = torch.einsum("...q,q,ql->...l", dflux, dt * fc.qw,
                                   fc.phi_c * fc.phi_c)
            dg = self._face_plane_add(dg, fc, contrib)
        if self.has_bc:
            dg = torch.where(self.bc_mask_g, torch.ones_like(dg), dg)
        return dg

    # ---- linearized boundary flux (frozen T) -------------------------
    def _flux_lin_tables(self, Tg, dt):
        p = self.params
        out = []
        for fc, phiphi in zip(self.faces, self._face_phiphi):
            Tb = self._face_Tb(Tg, fc)
            w = (p.boundary_scale
                 * (4.0 * p.sigma * p.epsilon * Tb**3 + p.htc)
                 * (dt * fc.qw))
            # multiply + reduce, as the JAX version
            out.append((w[..., :, None, None] * phiphi).sum(-3))
        return out

    def _apply_flux_lin(self, WW, xg, yg):
        for fc, W in zip(self.faces, WW):
            xc = self._face_corners(xg, fc)                  # (..., m)
            contrib = (W * xc[..., None, :]).sum(-1)         # (..., l)
            yg = self._face_plane_add(yg, fc, contrib)
        return yg

    # ---- Jacobian action ---------------------------------------------
    def _kron_jac_g(self, dt):
        """Linear-part Jacobian apply (sum-factorized): c_mass*M3 +
        dt*c_diff*K3, 2d+1 banded passes."""
        d = self.d
        cm = self.op.c_mass
        ck = self.op.c_diff

        def mv(xg):
            suffix = [xg]
            for a in range(d - 1, 0, -1):
                suffix.insert(0, self._apply1d(self.bands_m[a],
                                               suffix[0], a))
            if d == 1:
                acc = (dt * ck) * self._apply1d(self.bands_k[0], xg, 0,
                                                diff=True)
                return acc + cm * self._apply1d(self.bands_m[0], xg, 0)
            acc = (dt * ck) * self._apply1d(self.bands_k[d - 1],
                                            suffix[d - 1], d - 1, diff=True)
            for a in range(d - 2, -1, -1):
                acc = self._apply1d(self.bands_m[a], acc, a)
                acc = acc + (dt * ck) * self._apply1d(
                    self.bands_k[a], suffix[a], a, diff=True)
            # add cm * M3 x: reuse suffix[0] = M_{1..d-1} x
            return acc + cm * self._apply1d(self.bands_m[0], suffix[0], 0)
        return mv

    # ---- the materialised table form --------------------------------
    def stencil_values_g(self, Tg, dt):
        """Materialised (5^d, *L) Jacobian value table at the frozen
        linearisation Tg: per offset, c_mass * prod(M) + dt*c_diff * sum_a
        (K at axis a, M elsewhere) as outer products of band rows, then the
        linearised face-flux blocks baked plane-wise (face couplings have
        face-axis delta 0), grouped by coupling delta, by pad + interleave
        and one plane add each."""
        d = self.d
        cm = self.op.c_mass
        ck = dt * self.op.c_diff
        combos = [("m",) * d] + [tuple("k" if t == a else "m"
                                       for t in range(d)) for a in range(d)]
        coefs = [cm] + [ck] * d
        vals = []
        for off in self._offsets:
            acc = None
            for combo, coef in zip(combos, coefs):
                prod = None
                for t in range(d):
                    b = self.bands_m[t] if combo[t] == "m" else self.bands_k[t]
                    v = b[off[t]]
                    prod = v if prod is None else prod[..., None] * v
                prod = coef * prod
                acc = prod if acc is None else acc + prod
            vals.append(acc)
        vals = torch.stack(vals, dim=0)                     # (5^d, *L)
        p = self.params
        for fc in self.faces:
            az = fc.axis
            plane_axes = [i for i in range(d) if i != az]
            phi = fc.phi_c
            Tb = self._face_Tb(Tg, fc)
            w = (p.boundary_scale
                 * (4.0 * p.sigma * p.epsilon * Tb**3 + p.htc)
                 * (dt * fc.qw))                            # (..., q)
            blocks = torch.einsum("...q,ql,qm->...lm", w, phi, phi)
            blocks = blocks.squeeze(az)
            base = 0 if fc.side == 0 else self.grid[az] - 1
            npa = len(plane_axes)
            if not plane_axes:                              # 1D end point
                o = (5 ** d - 1) // 2
                vals[o, base] += blocks.reshape(())
                continue
            lc = len(fc.cols)
            flat = blocks.reshape(blocks.shape[:-2] + (lc * lc,))
            for delta in np.ndindex(*([5] * npa)):
                dvec = [int(v) - 2 for v in delta]
                # blk_{l, l+delta} gathered into the l-local (3,)^npa box
                sel = np.full((3,) * npa, -1, dtype=np.int64)
                for jl, l in enumerate(fc.cols):
                    lo = tuple(self.loffs[l][i] for i in plane_axes)
                    mo = tuple(lo[i] + dvec[i] for i in range(npa))
                    if any(v < 0 or v > 2 for v in mo):
                        continue
                    for jm, m in enumerate(fc.cols):
                        if tuple(self.loffs[m][i] for i in plane_axes) == mo:
                            sel[lo] = jl * lc + jm
                            break
                if not (sel >= 0).any():
                    continue
                safe = torch.as_tensor(np.where(sel < 0, 0, sel).reshape(-1),
                                       device=self.device)
                c3 = flat[..., safe].reshape(flat.shape[:-1] + (3,) * npa)
                c3 = c3 * torch.as_tensor((sel >= 0).astype(np.float64),
                                          dtype=flat.dtype, device=self.device)
                plane = self._assemble_cells_to_lattice(c3, npa)
                o, k = 0, 0
                for i in range(d):
                    if i == az:
                        o = o * 5 + 2
                    else:
                        o = o * 5 + (dvec[k] + 2)
                        k += 1
                vals[o].narrow(az, base, 1).add_(plane.unsqueeze(az))
        return vals

    def matvec_vals(self, vals, xg):
        """(5^d, *L) table matvec: static pad-2 + slice shifts."""
        xp = F.pad(xg, [2, 2] * self.d)
        acc = torch.zeros(self.grid, dtype=xg.dtype, device=xg.device)
        for o, off in enumerate(self._offsets):
            acc = acc + vals[o] * xp[tuple(slice(s, s + g) for s, g in
                                          zip(off, self.grid))]
        return acc

    def _flat_shifts(self):
        """(row shift, flattened trailing-axes shift) of each offset."""
        out = []
        for off in self._offsets:
            sft = 0
            for a in range(1, self.d):
                sft = sft * self.grid[a] + (int(off[a]) - 2)
            out.append((int(off[0]), sft))
        return out

    def matvec_flat(self, vals2, x):
        """2D-flattened table matvec: vals2 (5^d, gx, M), x flat; wrapped
        edge reads meet assembled zeros."""
        gx = self.grid[0]
        M = vals2.shape[-1]
        shifts = self._flat_shifts()
        P = max(abs(s) for _, s in shifts) if self.d > 1 else 1
        xp = F.pad(x.reshape(gx, M), [P, P, 2, 2])
        acc = torch.zeros((gx, M), dtype=x.dtype, device=x.device)
        for o, (dx, sft) in enumerate(shifts):
            acc = acc + vals2[o] * xp[dx:dx + gx, P + sft:P + sft + M]
        return acc.reshape(-1)

    # ------------------------------------------------------------------
    def make_matvec_g(self, Tg, dt, form: str | None = None):
        """Grid-shaped Jacobian action at the frozen linearization Tg."""
        if (form or self.matvec_form) == "table":
            vals = self.stencil_values_g(Tg, dt)
            mv0 = lambda v: self.matvec_vals(vals, v)
        else:
            lin = self._kron_jac_g(dt)
            WW = self._flux_lin_tables(Tg, dt)

            def mv0(v):
                y = lin(v)
                if WW:
                    y = self._apply_flux_lin(WW, v, y)
                return y
        if self.has_bc:
            mask = self.bc_mask_g
            return lambda v: torch.where(
                mask, v, mv0(torch.where(mask, torch.zeros_like(v), v)))
        return mv0

    def make_matvec(self, T: torch.Tensor, dt, form: str | None = None):
        """Flat-vector Jacobian action (the Krylov-loop operator)."""
        if (form or self.matvec_form) != "table":
            g_mv = self.make_matvec_g(T.reshape(self.grid), dt, form="kron")
            return lambda v: g_mv(v.reshape(self.grid)).reshape(-1)
        vals = self.stencil_values_g(T.reshape(self.grid), dt)
        if self.d > 1:
            vals2 = vals.reshape(vals.shape[0], self.grid[0], -1)
            mv0 = lambda v: self.matvec_flat(vals2, v)
        else:
            mv0 = lambda v: self.matvec_vals(
                vals, v.reshape(self.grid)).reshape(-1)
        if self.has_bc:
            mask = self.bc_mask
            return lambda v: torch.where(
                mask, v, mv0(torch.where(mask, torch.zeros_like(v), v)))
        return mv0

    def slab(self, lo: int, hi: int) -> "GridQ2Slab":
        """The operator on lattice planes [lo, hi) of axis 0 of the lattice
        padded with ghost planes past its physical grid[0] (one per range:
        the step and its preconditioner share it)."""
        if (lo, hi) not in self._slabs:
            self._slabs[(lo, hi)] = GridQ2Slab(self, lo, hi)
        return self._slabs[(lo, hi)]


def _window0(a: torch.Tensor, w0: int, n: int, axis: int = 0):
    """Rows [w0, w0 + n) along `axis` of a tensor over the physical
    lattice, zero (False) outside it."""
    shape = list(a.shape)
    shape[axis] = n
    out = torch.zeros(shape, dtype=a.dtype, device=a.device)
    lo, hi = max(w0, 0), min(w0 + n, a.shape[axis])
    if hi > lo:
        out.narrow(axis, lo - w0, hi - lo).copy_(a.narrow(axis, lo, hi - lo))
    return out


class GridQ2Slab(GridHeatOperator2):
    """The kron-form GridHeatOperator2 on lattice planes [lo, hi) of axis 0
    of its lattice padded with ghost planes past the physical g0 = grid[0]
    (module docstring). It computes on the window of E = L + 4 planes
    [lo - 2, hi + 2), the whole lattice's methods on it: the axis-0 bands,
    M 1 and the Dirichlet masks sliced from the whole lattice's (zero
    outside its physical planes), the x faces whose plane it owns, the y
    and z faces over the cells [c0, c1) that touch its real planes. It
    keeps the L owned rows, each equal to the whole lattice's row; ghost
    rows are zero (the diagonal: one). Inputs carry the halo: `T_ext`
    (E, *grid[1:]), zero outside the physical planes (LatticeHalo)."""

    def __init__(self, op: GridHeatOperator2, lo: int, hi: int):
        if op.matvec_form != "kron":
            raise ValueError("a lattice slab takes the kron form")
        if not 0 <= lo < hi:
            raise ValueError(f"lattice planes [{lo}, {hi})")
        self.__dict__.update(op.__dict__)
        self._slabs = {}
        g0 = op.grid[0]
        self.lo, self.hi, self.L = lo, hi, hi - lo
        self.n_real = max(0, min(hi, g0) - lo)       # owned real planes
        self.slab_grid = (self.L,) + op.grid[1:]
        w0, E = lo - 2, self.L + 4
        self.grid = (E,) + op.grid[1:]
        self._row0 = w0
        # the cells along axis 0 that touch the owned real planes (cell c
        # spans planes 2c .. 2c + 2)
        e = lo + self.n_real
        c0 = max(0, (lo - 1) // 2)
        c1 = min(self.dims[0], (e - 1) // 2 + 1) if self.n_real else c0
        self._cells0 = (c0, max(c1, c0))
        self.bands_m = [_window0(op.bands_m[0], w0, E, 1)] + op.bands_m[1:]
        self.bands_k = [_window0(op.bands_k[0], w0, E, 1)] + op.bands_k[1:]
        self.M1g = _window0(op.M1g, w0, E)
        self.bc_mask_g = _window0(op.bc_mask_g, w0, E)
        self.bc_values_g = _window0(op.bc_values_g, w0, E)
        keep = [k for k, fc in enumerate(op.faces)
                if (fc.axis == 0 and lo <= (0 if fc.side == 0 else g0 - 1)
                    < e)
                or (fc.axis != 0 and c1 > c0)]
        self.faces = [op.faces[k] for k in keep]
        self._face_phiphi = [op._face_phiphi[k] for k in keep]

    def _own(self, y, ghost: float):
        """The owned rows of a window result, `ghost` on ghost rows."""
        y = y[2:self.L + 2]
        if self.n_real < self.L:
            y = torch.cat([y[:self.n_real], torch.full_like(
                y[self.n_real:], ghost)])
        return y

    def residual_r(self, T_ext, Tp_ext, dt=None):
        """The owned rows of the residual (L, *grid[1:]), zero on ghost
        rows; both states with their halos."""
        return self._own(self.residual_g(T_ext, Tp_ext, dt), 0.0)

    def jacobian_diag_r(self, T_ext, dt=None):
        return self._own(self.jacobian_diag_g(T_ext, dt), 1.0)

    def make_matvec_r(self, T_ext, dt, halo):
        """v (L, *grid[1:]) -> J(T) v on the owned rows, zero on ghost
        rows: the kron chain on v's window `halo(v)` (a collective: every
        rank applies together)."""
        mv = self.make_matvec_g(T_ext, dt)
        return lambda v: self._own(mv(halo(v)), 0.0)


class LatticeHalo:
    """A rank's rows [lo, hi) of a lattice split along axis 0 in rank
    order (`rows`, every rank's) -> its window [lo - depth, hi + depth),
    the physical planes [0, g0) from their holders through one
    re-partition (none at world size 1 or where no rank needs another's
    planes), zeros elsewhere. Counted in `LatticeHalo.count` (and in
    `Repartition.count`); every rank must apply it together."""

    count = 0

    def __init__(self, rows, g0: int, device_mesh, depth: int = 2):
        from fem_glass_tempering_tpu_torch.parallel.comm import Repartition
        lo, hi = rows[device_mesh.rank]
        windows = [(max(a - depth, 0), min(b + depth, g0)) for a, b in rows]
        self._rep = Repartition(rows, windows, device_mesh)
        c, d = windows[device_mesh.rank]
        self._pad = (c - (lo - depth), hi + depth - max(c, d))

    def __call__(self, v):
        if self._rep.total:
            LatticeHalo.count += 1
        w = self._rep(v)
        return F.pad(w, [0, 0] * (w.dim() - 1) + list(self._pad))


class Q2MG:
    """p-multigrid preconditioner for GridHeatOperator2: smoothing on the
    Q2 lattice, exact-embedding transfers to the CG-1 node grid (even
    lattice points), and one CG-1 V-cycle as the coarse solve: GeometricMG
    (`coarse_kind="geometric"`, the unsharded driver's) or JAX's GridMG
    over a node grid whose axis 0 carries `coarse_pad0` ghost planes
    (`coarse_kind="grid"`, the grid-sharded step's; the restricted
    residual is zero on the ghost planes and the prolongation drops them).
    The interface mirrors GeometricMG's (models/problem.py):

        mg = Q2MG(grid2_op, make_heat_operator)
        mg.freeze_rhos(dt)
        precond = mg.preconditioner(mg.linearization_states(T), dt)

    Smoother: 'auto' resolves to a Chebyshev-accelerated pentadiagonal
    LINE smoother along the strongly coupled (small-h) axis on plates
    anisotropic by more than 3:1 (point smoothers cannot damp the
    through-thickness lattice modes), and to point Chebyshev-Jacobi on
    isotropic boxes. Each lattice line's restriction of the operator is
    alpha(line)*M1_az + beta(line)*K1_az with per-line scalars, factorised
    once per operator build by a batched banded LDL^T."""

    def __init__(self, fine: GridHeatOperator2, make_heat_operator, *,
                 nu_pre: int = 2, nu_post: int = 2, smoother: str = "auto",
                 mg_kwargs: dict | None = None, coarse_pad0: int = 0,
                 coarse_kind: str = "geometric"):
        from fem_glass_tempering_tpu_torch.ops.grid import GridHeatOperator
        from fem_glass_tempering_tpu_torch.solver.grid_mg import GridMG
        from fem_glass_tempering_tpu_torch.solver.multigrid import (
            GeometricMG,
        )
        if coarse_kind not in ("geometric", "grid"):
            raise ValueError(coarse_kind)
        if coarse_pad0 and coarse_kind != "grid":
            raise ValueError("a ghost-padded coarse chain (coarse_pad0) "
                             "needs coarse_kind='grid'")
        self.fine = fine
        self.coarse_kind = coarse_kind
        self.nu_pre, self.nu_post = nu_pre, nu_post
        mesh = fine.op.fs.mesh
        h = [ln / dd for ln, dd in zip(mesh.structured["lengths"],
                                       fine.dims)]
        if smoother == "auto":
            smoother = ("line" if (max(h) / min(h) > 3.0 and fine.d >= 2)
                        else "chebyshev")
        if smoother not in ("chebyshev", "jacobi", "line"):
            raise ValueError(smoother)
        self.smoother = smoother
        self.line_axis = None
        if smoother == "line":
            # lines along the strongly coupled axis: it goes last, so a
            # line is a contiguous run of the lattice
            self.line_axis = int(np.argmin(h))
            self._perm = tuple(j for j in range(fine.d)
                               if j != self.line_axis) + (self.line_axis,)
            self._inv_perm = tuple(int(j) for j in np.argsort(self._perm))
            f = lambda a: torch.as_tensor(a, dtype=fine.dtype,  # noqa: E731
                                          device=fine.device)
            alpha, beta = self._line_coeffs()
            self._alpha, self._beta = f(alpha), f(beta)
        if coarse_kind == "grid":
            heat1 = make_heat_operator(mesh)
            self._check_coarse(heat1)
            # the whole grid's device tables wait for a whole-grid method:
            # the sharded step reads its rank's slabs'
            self.g1 = GridHeatOperator(heat1, pad_axis0=coarse_pad0,
                                       allow_const=False, tables=False)
            self.gmg = GridMG(self.g1, make_heat_operator,
                              **(mg_kwargs or {}))
        else:
            # the coarse V-cycle's defaults are those of the JAX version's
            # GridMG: Chebyshev smoothing, a dense coarsest level
            self.gmg = GeometricMG(mesh, make_heat_operator,
                                   dtype=fine.dtype,
                                   **{"smoother": "chebyshev",
                                      **(mg_kwargs or {})})
            self._check_coarse(self.gmg.levels[0].op)
        self._rho2 = None

    @staticmethod
    def _check_coarse(heat1) -> None:
        if heat1.fs.degree != 1 or heat1.fs.family != "CG":
            raise ValueError("make_heat_operator must build the CG-1 "
                             "operator for the coarse chain")

    def freeze_rhos(self, dt: float) -> None:
        g = self.fine.gersh
        num = (g["mass_abs"] + dt * g["stiff_abs"] + dt * g["b_abs"])
        den = (g["mass_diag"] + dt * g["stiff_diag"] + dt * g["b_diag"])
        self._rho2 = float(np.max(num / den))
        if self.coarse_kind == "grid":
            self.gmg.freeze_rhos(dt)
        else:
            self.gmg.freeze_omegas(None, dt)

    # GeometricMG-compatible alias
    def freeze_omegas(self, T0, dt) -> None:
        self.freeze_rhos(dt)

    def _inject(self, Tg):
        """The CG-1 node values of a lattice grid: its even points."""
        T1 = Tg
        for a in range(self.fine.d):
            T1 = T1[(slice(None),) * a + (slice(0, None, 2),)]
        return T1

    def linearization_states_g(self, Tg: torch.Tensor):
        """Per-level frozen temperatures: the Q2 lattice grid, then the
        CG-1 chain by injection (even lattice points are the CG-1 nodal
        values; deeper levels by the coarse cycle's even-node injection):
        GeometricMG's flat states, or GridMG's grids from the node grid
        edge-padded to its ghost planes."""
        T1 = self._inject(Tg)
        if self.coarse_kind == "geometric":
            return [Tg] + self.gmg.linearization_states(T1.reshape(-1))
        if self.gmg.pad0:
            T1 = torch.cat([T1, T1[-1:].expand(
                (self.gmg.pad0,) + tuple(T1.shape[1:]))])
        return [Tg] + self.gmg.linearization_states_g(T1)

    def linearization_states(self, T: torch.Tensor):
        return self.linearization_states_g(T.reshape(self.fine.grid))

    def _restrict(self, rg):
        from fem_glass_tempering_tpu_torch.solver.multigrid import (
            GeometricMG,
        )
        for a in range(self.fine.d):
            rg = GeometricMG._restrict_axis(rg, a)
        return rg

    def _prolong(self, xc):
        from fem_glass_tempering_tpu_torch.solver.multigrid import (
            GeometricMG,
        )
        for a in range(self.fine.d):
            xc = GeometricMG._prolong_axis(xc, a)
        return xc

    # ---- batched pentadiagonal line solver ---------------------------
    def _line_coeffs(self):
        """The per-line scalars alpha, beta (numpy, over the off-line axes
        of the whole lattice): off the diagonal each line matrix along
        `line_axis` is alpha*M1_az + beta*K1_az (Kronecker separability).

        alpha is the JAX version's as it stands: the cross-axis stiffness
        enters it without the dt factor that the operator c_mass*M +
        dt*c_diff*K gives it (JAX ops/grid2.py:821-827; ROADMAP.md Queue 3
        records the gap)."""
        fine = self.fine
        az = self.line_axis
        d = fine.d
        cm = fine.op.c_mass
        ck = fine.op.c_diff
        dm = [np.asarray(fine.np_bands[t][0][2]) for t in range(d)]
        dk = [np.asarray(fine.np_bands[t][1][2]) for t in range(d)]

        def outer_except(vs):
            out = None
            for t in range(d):
                if t == az:
                    continue
                v = vs[t]
                out = v if out is None else np.multiply.outer(out, v)
            return out

        alpha = cm * outer_except(dm)
        for a in range(d):
            if a == az:
                continue
            alpha = alpha + ck * outer_except(
                [dk[t] if t == a else dm[t] for t in range(d)])
        return alpha, ck * outer_except(dm)

    def _line_bands(self, T_lin, dt):
        """The line matrices along `line_axis` of the operator frozen at
        the lattice grid T_lin as (a0, a1, a2) of shape (ncol, nz): the
        diagonal, and the couplings A[k+1, k] and A[k+2, k]. The diagonal
        is the exact operator diagonal (it folds in the linearized
        boundary flux and the Dirichlet identity rows), and the couplings
        at Dirichlet rows are severed."""
        fine = self.fine
        return self._line_bands_from(
            fine.jacobian_diag_g(T_lin, dt), self._alpha, self._beta,
            fine.bc_mask_g if fine.has_bc else None, dt)

    def _line_bands_from(self, diag_g, alpha, beta, mask_g, dt):
        """(a0, a1, a2) from a diagonal grid (the whole lattice's or a
        rank's rows of it), alpha / beta over its off-line axes and its
        Dirichlet mask (None: no Dirichlet rows)."""
        fine, az = self.fine, self.line_axis
        Mb, Kb = fine.bands_m[az], fine.bands_k[az]    # (5, Lz)
        a0 = self._to_lines(diag_g)
        ncol = a0.shape[0]
        ab = alpha.reshape(ncol, 1)
        bb = beta.reshape(ncol, 1)
        # the symmetric band layout stores band b of row r as the coupling
        # to column r + b - 2, so A[k+1, k] = band 3 at row k and
        # A[k+2, k] = band 4 at row k; the stiffness part carries dt
        a1 = ab * Mb[3] + (dt * bb) * Kb[3]            # (ncol, nz)
        a2 = ab * Mb[4] + (dt * bb) * Kb[4]
        if mask_g is not None:
            free = 1.0 - self._to_lines(mask_g.to(fine.dtype))
            free_n1 = torch.cat(
                [free[:, 1:], torch.zeros_like(free[:, :1])], dim=1)
            free_n2 = torch.cat(
                [free[:, 2:], torch.zeros_like(free[:, :2])], dim=1)
            a1 = a1 * free * free_n1
            a2 = a2 * free * free_n2
        return a0, a1, a2

    def _to_lines(self, x):
        return x.permute(self._perm).reshape(-1, x.shape[self.line_axis])

    def _from_lines(self, x2, shape):
        return x2.reshape(tuple(shape[j] for j in self._perm)).permute(
            self._inv_perm)

    @staticmethod
    def _ldl(a0, a1, a2):
        """Batched banded LDL^T (bandwidth 2) of the (ncol, nz) line
        matrices, a Python loop over the line -> (d0, l1, l2) lists of
        (ncol,) columns."""
        nz = a0.shape[1]
        d0 = [a0[:, 0]]
        l1 = [a1[:, 0] / d0[0]]
        l2 = [a2[:, 0] / d0[0]]
        for k in range(1, nz):
            dk_ = a0[:, k] - l1[k - 1] ** 2 * d0[k - 1]
            if k >= 2:
                dk_ = dk_ - l2[k - 2] ** 2 * d0[k - 2]
            d0.append(dk_)
            if k < nz - 1:
                lk = a1[:, k] - l2[k - 1] * l1[k - 1] * d0[k - 1]
                l1.append(lk / dk_)
            if k < nz - 2:
                l2.append(a2[:, k] / dk_)
        return d0, l1, l2

    def _line_solver(self, T_lin, dt):
        """Factorise every lattice line along `line_axis` of the frozen
        operator and return zsolve(r_grid) -> Z^{-1} r_grid."""
        return self._zsolve(self._ldl(*self._line_bands(T_lin, dt)))

    def _zsolve(self, factors):
        """The line solve over grids of any rows (the lines' order of
        `_to_lines`) from the factors of `_ldl`."""
        d0, l1, l2 = factors
        nz = len(d0)

        def zsolve(rg):
            r2 = self._to_lines(rg)
            y = [r2[:, 0]]
            for k in range(1, nz):
                yk = r2[:, k] - l1[k - 1] * y[k - 1]
                if k >= 2:
                    yk = yk - l2[k - 2] * y[k - 2]
                y.append(yk)
            z = [y[k] / d0[k] for k in range(nz)]
            x = [None] * nz
            x[-1] = z[-1]
            if nz >= 2:
                x[-2] = z[-2] - l1[nz - 2] * x[-1]
            for k in range(nz - 3, -1, -1):
                x[k] = z[k] - l1[k] * x[k + 1] - l2[k] * x[k + 2]
            return self._from_lines(torch.stack(x, dim=1), rg.shape)
        return zsolve

    @staticmethod
    def _power_rho(mv, zsolve, shape, dtype, device, iters: int = 8):
        """Power-iteration bound on rho(Z^{-1}A) from the fixed start
        sin(0.7 k) + 0.01 (the line coefficients move with dt and T, so the
        Chebyshev bound is computed per operator build), times 1.1."""
        n = int(np.prod(shape))
        v = (torch.sin(torch.arange(n, dtype=dtype, device=device) * 0.7)
             + 0.01).reshape(shape)
        rho = torch.ones((), dtype=dtype, device=device)
        for _ in range(iters):
            w = zsolve(mv(v))
            nw = torch.sqrt(torch.dot(w.reshape(-1), w.reshape(-1)))
            rho = nw / torch.sqrt(torch.dot(v.reshape(-1), v.reshape(-1)))
            v = w / nw
        return rho * 1.1

    def _cycle(self, mv, zapply, rho, restrict, coarse, prolong):
        """The apply r -> ~A^{-1} r over a lattice layout (the whole grid,
        or a rank's rows): Chebyshev (or Jacobi) smoothing by `zapply`
        over [rho/4, rho], and the coarse correction prolong(coarse(
        restrict(residual)))."""
        nu_pre, nu_post = self.nu_pre, self.nu_post

        def smooth_cheb(x, b, nu):
            lmax = rho
            lmin = lmax / 4.0
            theta = 0.5 * (lmax + lmin)
            delta = 0.5 * (lmax - lmin)
            sigma = theta / delta
            rho_k = 1.0 / sigma
            r = b - mv(x)
            p = zapply(r) / theta
            x = x + p
            for _ in range(max(nu - 1, 0)):
                r = b - mv(x)
                z = zapply(r)
                rho_next = 1.0 / (2.0 * sigma - rho_k)
                p = rho_next * rho_k * p + (2.0 * rho_next / delta) * z
                x = x + p
                rho_k = rho_next
            return x

        def smooth_jac(x, b, nu):
            omega = 4.0 / (3.0 * rho)
            for _ in range(nu):
                x = x + omega * zapply(b - mv(x))
            return x

        smooth = smooth_jac if self.smoother == "jacobi" else smooth_cheb

        def apply_g(rg):
            x = smooth(torch.zeros_like(rg), rg, nu_pre)
            res = rg - mv(x)
            x = x + prolong(coarse(restrict(res)))
            return smooth(x, rg, nu_post)
        return apply_g

    def preconditioner_g(self, T_levels, dt):
        """Grid-shaped V-cycle apply (r_lattice -> ~A^-1 r_lattice)."""
        assert self._rho2 is not None, "call freeze_rhos(dt) first"
        fine = self.fine
        mv = fine.make_matvec_g(T_levels[0], dt)
        if self.smoother == "line":
            zapply = self._line_solver(T_levels[0], dt)
            rho = self._power_rho(mv, zapply, fine.grid, fine.dtype,
                                  fine.device)
        else:
            diag = fine.jacobian_diag_g(T_levels[0], dt)
            zapply = lambda r: r / diag  # noqa: E731
            rho = self._rho2
        if self.coarse_kind == "geometric":
            inner = self.gmg.preconditioner(T_levels[1:], dt)

            def coarse(rc):
                return inner(rc.reshape(-1)).reshape(rc.shape)
        else:
            inner = self.gmg.preconditioner_g(T_levels[1:], dt)
            pad = self.gmg.pad0

            def coarse(rc):
                if not pad:
                    return inner(rc)
                # zero residual on the ghost planes; their correction goes
                xc = inner(F.pad(rc, [0, 0] * (rc.dim() - 1) + [0, pad]))
                return xc[:xc.shape[0] - pad]
        return self._cycle(mv, zapply, rho, self._restrict, coarse,
                           self._prolong)

    def preconditioner(self, T_levels, dt):
        """Flat-vector apply (the interface models/problem.py calls)."""
        apply_g = self.preconditioner_g(T_levels, dt)
        grid = self.fine.grid
        return lambda r: apply_g(r.reshape(grid)).reshape(-1)


# ----------------------------------------------------------------------
class LatticeNodeTransfers:
    """The maps between one rank's rows `lat_rows[rank]` of a Q2 lattice
    (2 n0 + 1 physical planes along axis 0, padded with ghost planes) and
    its rows `node_rows[rank]` of the CG-1 node grid (n0 + 1 physical
    planes, padded likewise): Q2MG's restriction and prolongation and the
    even-stride injection (the coarse chain's linearisation states and
    the sigma space's cross evaluation). Node plane i sits at lattice
    plane 2i, so the two splits drift apart along axis 0 (at P = 4 on a
    5-cell axis rank 2 holds lattice planes 6-8, nodes 3 and 4, and node
    rows [4, 6)): each map is one re-partition (parallel/comm.py
    Repartition) of the rows its window needs, then the whole grid's
    formula on that window, in its order of operations. Every rank must
    call each map together."""

    def __init__(self, dims, lat_rows, node_rows, device_mesh):
        from fem_glass_tempering_tpu_torch.parallel.comm import Repartition
        self.d = len(dims)
        self.g0 = g0 = 2 * dims[0] + 1
        self.gx = gx = dims[0] + 1
        r = device_mesh.rank
        self.lo, self.hi = lat_rows[r]
        self.n0, self.n1 = node_rows[r]
        # restriction: node i reads lattice planes 2i - 1 .. 2i + 1
        rwin, pwin, iwin = [], [], []
        for (lo, hi), (n0, n1) in zip(lat_rows, node_rows):
            k0, k1 = min(n0, gx), min(n1, gx)
            rwin.append((max(2 * k0 - 1, 0), min(2 * k1, g0))
                        if k1 > k0 else (0, 0))
            e = min(hi, g0)
            # prolongation: lattice plane j reads nodes j // 2 .. (j+1) // 2
            pwin.append((lo // 2, e // 2 + 1) if e > lo else (0, 0))
            # injection: node i takes lattice plane min(2i, g0 - 1) (the
            # ghost nodes the edge plane's)
            iwin.append((min(2 * n0, g0 - 1), min(2 * (n1 - 1), g0 - 1) + 1))
        self.k0, self.k1 = min(self.n0, gx), min(self.n1, gx)
        self.e = min(self.hi, g0)
        self._rwin, self._pwin, self._iwin = rwin[r], pwin[r], iwin[r]
        self._restrict_rep = Repartition(lat_rows, rwin, device_mesh)
        self._prolong_rep = Repartition(node_rows, pwin, device_mesh)
        self._inject_rep = Repartition(lat_rows, iwin, device_mesh)
        w0 = self._iwin[0]
        self._inject_idx = [min(2 * i, g0 - 1) - w0
                            for i in range(self.n0, self.n1)]

    @staticmethod
    def _pad0(x, lo: int, hi: int):
        return F.pad(x, [0, 0] * (x.dim() - 1) + [lo, hi])

    def restrict(self, r_rows):
        """Q2MG._restrict on this rank's lattice rows (zero on ghost rows)
        -> its node rows, zero on ghost planes."""
        from fem_glass_tempering_tpu_torch.solver.multigrid import (
            GeometricMG,
        )
        L, k = self.n1 - self.n0, self.k1 - self.k0
        w = self._restrict_rep(r_rows)
        if k == 0:
            return r_rows.new_zeros((L,) + tuple(
                (n + 1) // 2 for n in r_rows.shape[1:]))
        a, b = self._rwin
        # the window [2 k0 - 1, 2 k1), zero where it leaves the lattice
        w = self._pad0(w, a - (2 * self.k0 - 1), 2 * self.k1 - b)
        even, after, before = w[1::2], w[2::2], w[0:-1:2]
        rc = even + 0.5 * (after + before)
        for ax in range(1, self.d):
            rc = GeometricMG._restrict_axis(rc, ax)
        return self._pad0(rc, 0, L - k)

    def prolong(self, x_rows):
        """Q2MG._prolong from this rank's node rows (the real planes read)
        -> its lattice rows, zero on ghost rows."""
        from fem_glass_tempering_tpu_torch.solver.multigrid import (
            GeometricMG,
        )
        L = self.hi - self.lo
        w = self._prolong_rep(x_rows)
        n = self.e - self.lo
        if n <= 0:
            return x_rows.new_zeros((L,) + tuple(
                2 * m - 1 for m in x_rows.shape[1:]))
        a, _ = self._pwin
        x = GeometricMG._prolong_axis(w, 0)[self.lo - 2 * a:self.e - 2 * a]
        for ax in range(1, self.d):
            x = GeometricMG._prolong_axis(x, ax)
        return self._pad0(x, 0, L - n)

    def inject(self, a_rows):
        """The even lattice points of this rank's lattice rows (L, ...,
        trailing axes beyond the lattice's kept) -> its node rows, the
        ghost planes a copy of node plane n0 (JAX's injection and edge
        pad)."""
        w = self._inject_rep(a_rows)
        x = w[self._inject_idx]
        for ax in range(1, self.d):
            x = x[(slice(None),) * ax + (slice(0, None, 2),)]
        return x


class RankQ2MG:
    """Q2MG's grid route (coarse_kind="grid") on one rank of a lattice
    split along axis 0 (module docstring): `mg` a frozen Q2MG over the
    whole lattice, `lat_rows` / `node_rows` every rank's lattice rows and
    node rows in rank order. The smoother runs on the rank's slab of the
    fine operator (GridQ2Slab, its Jacobian action through LatticeHalo);
    point smoothing and lines along axis 1 or 2 give the whole cycle's
    rows bit for bit, lines along axis 0 are solved on the all-gathered
    lattice (one all-gather a line solve), and the power iteration's start
    vector is the rank's real rows of the whole lattice's with every
    norm's sum of squares summed over the ranks (the one place its bits
    part from the unsharded cycle's). The coarse V-cycle is GridMG's rank
    form over the node rows. Every rank must build and apply it
    together."""

    def __init__(self, mg: Q2MG, device_mesh, lat_rows, node_rows):
        from fem_glass_tempering_tpu_torch.parallel import comm
        from fem_glass_tempering_tpu_torch.solver.grid_mg import RankGridMG
        if mg.coarse_kind != "grid":
            raise ValueError("RankQ2MG needs coarse_kind='grid'")
        if mg._rho2 is None:
            raise ValueError("call Q2MG.freeze_rhos() first")
        self._comm = comm
        self.mg, self.comm = mg, device_mesh
        fine = mg.fine
        lo, hi = lat_rows[device_mesh.rank]
        self.slab = fine.slab(lo, hi)
        self.halo = LatticeHalo(lat_rows, fine.grid[0], device_mesh)
        self.tr = LatticeNodeTransfers(fine.dims, lat_rows, node_rows,
                                       device_mesh)
        self.rank_mg = RankGridMG(mg.gmg, device_mesh, node_rows)
        self.lines_local = mg.smoother == "line" and mg.line_axis != 0
        if self.lines_local:
            # the rank's rows of the per-line scalars (axis 0 leads the
            # off-line axes), zero on ghost rows
            n = self.slab.n_real
            self._alpha, self._beta = (self._own(a[lo:lo + n])
                                       for a in (mg._alpha, mg._beta))

    def _gather_lattice(self, x):
        """This rank's lattice rows -> the whole physical lattice, on
        every rank (one all-gather)."""
        return self._comm.all_gather(x.contiguous(), self.comm)[
            :self.mg.fine.grid[0]]

    def _own(self, x_real):
        """This rank's real rows -> all its rows, zero on ghost rows."""
        return F.pad(x_real, [0, 0] * (x_real.dim() - 1)
                     + [0, self.slab.L - x_real.shape[0]])

    def linearization_states(self, T_rows):
        """Per-level states from this rank's lattice rows T_rows (L, ...):
        the rows themselves, then GridMG's rank form's from the injected
        node rows (the ghost planes edge-padded)."""
        return [T_rows] + self.rank_mg.linearization_states(
            self.tr.inject(T_rows))

    def _line_solver(self, T_rows, T_ext, dt):
        mg, slab = self.mg, self.slab
        if self.lines_local:
            mask = slab.bc_mask_g[2:slab.L + 2] if slab.has_bc else None
            return mg._zsolve(mg._ldl(*mg._line_bands_from(
                slab.jacobian_diag_r(T_ext, dt), self._alpha, self._beta,
                mask, dt)))
        # lines along axis 0 cross the ranks: the whole lattice's, solved
        # on every rank
        whole = mg._line_solver(self._gather_lattice(T_rows), dt)
        lo, n = slab.lo, slab.n_real
        return lambda r: self._own(whole(self._gather_lattice(r))[lo:lo + n])

    def _power_rho(self, mv, zsolve, iters: int = 8):
        """Q2MG._power_rho on this rank's rows: the whole lattice's start
        vector, each iteration's two sums of squares summed over the ranks
        in one collective."""
        s = self.slab
        M = int(np.prod(s.slab_grid[1:]))
        fine = self.mg.fine
        k = torch.arange(s.lo * M, (s.lo + s.n_real) * M, dtype=fine.dtype,
                         device=fine.device)
        v = self._own((torch.sin(k * 0.7) + 0.01).reshape(
            (s.n_real,) + s.slab_grid[1:]))
        rho = torch.ones((), dtype=fine.dtype, device=fine.device)
        for _ in range(iters):
            w = zsolve(mv(v))
            sums = self._comm.all_reduce_sum(torch.stack([
                torch.dot(w.reshape(-1), w.reshape(-1)),
                torch.dot(v.reshape(-1), v.reshape(-1))]), self.comm)
            nw = torch.sqrt(sums[0])
            rho = nw / torch.sqrt(sums[1])
            v = w / nw
        return rho * 1.1

    def preconditioner(self, T_rows, dt):
        """The apply r -> ~A^{-1} r on this rank's lattice rows (L,
        *grid[1:]) for the Jacobian frozen at T_rows (the rank's lattice
        rows)."""
        mg, slab = self.mg, self.slab
        T_levels = self.linearization_states(T_rows)
        T_ext = self.halo(T_rows)
        mv = slab.make_matvec_r(T_ext, dt, self.halo)
        if mg.smoother == "line":
            zapply = self._line_solver(T_rows, T_ext, dt)
            rho = self._power_rho(mv, zapply)
        else:
            diag = slab.jacobian_diag_r(T_ext, dt)
            zapply = lambda r: r / diag  # noqa: E731
            rho = mg._rho2
        coarse = self.rank_mg.preconditioner(T_levels[1:], dt)
        return mg._cycle(mv, zapply, rho, self.tr.restrict, coarse,
                         self.tr.prolong)
