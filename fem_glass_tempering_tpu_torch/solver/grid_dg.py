"""The grid-shaped SIPG DG-1 operator of the grid-sharded step, its rank
form, and the maps between a DG-1 cell grid and its CG-1 node grid.

Counterpart of fem_glass_tempering_tpu/solver/grid_dg.py:

- `GridDGOperator`: the DG block stencil (ops/stencil.py DGStencilMatrix,
  its constant-block form) with grid-shaped entry points over
  (cx, cy, cz, nloc) arrays; the boundary radiation + convection terms,
  which DGStencilMatrix applies through per-facet gathers, are per-face
  slice updates of the boundary cell layers. Plain PyTorch, as it is
  plain XLA in the JAX package: no TPU kernel reaches it.
- `GridDGSlab` (`GridDGOperator.slab(lo, hi)`): the operator on cell
  layers [lo, hi) of axis 0 of a cell grid padded with ghost layers
  (parallel/grid_shard.py `cell_pad0`), one rank's share. Its inputs
  carry one halo cell layer a side (parallel/comm.py halo_exchange);
  the layers past the physical grid are zero in the halo and give zero
  rows (the diagonal: one), so a ghost cell never reaches a real one.
  The Jacobian action and the diagonal equal the whole grid's rows bit
  for bit; the residual's mean shift is a sum over the ranks' real cells
  (to ~1e-14 of the whole grid's).
- `dg_vertex_offsets` / `dg_to_nodes_g`: the lattice offsets of a cell's
  DG-1 vertices, and the DG-1 -> CG-1 map with dolfinx's last-cell-wins
  overwrite (the sigma space's cross evaluation).
- `CellNodeTransfers`: the four operations that cross between a rank's
  cell layers and its rows of the padded node grid (the p-multigrid's
  restriction, its linearisation state and prolongation, and the sigma
  cross evaluation). A rank's cells touch node planes that other ranks
  hold, and the two splits drift apart along axis 0, so each is one
  re-partition (comm.Repartition), then the whole grid's formula on the
  window, in its order of operations.
- `RankDGMultigrid`: DGMultigrid's grid route (coarse_kind="grid") on
  one rank: the Chebyshev smoother on the rank's cells through the slab's
  Jacobian action, the frozen smoother factors sliced to the rank's cells
  (a column solve along axis 0 crosses the ranks: it runs on all-gathered
  cell layers), and the CG-1 correction through GridMG's rank form
  (solver/grid_mg.py RankGridMG).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fem_glass_tempering_tpu_torch.ops.assembly import (
    _reference_outward_normals,
)
from fem_glass_tempering_tpu_torch.ops.stencil import DGStencilMatrix, _sl


class _DGFace:
    __slots__ = ("axis", "side", "layer", "qw", "phi")

    def __init__(self, axis, side, layer, qw, phi):
        self.axis = axis      # grid axis
        self.side = side      # 0 = low face, 1 = high face
        self.layer = layer    # cell-layer index along axis
        self.qw = qw          # (q,) physical facet quad weights
        self.phi = phi        # (q, nloc) cell basis at facet points


class GridDGOperator:
    """Gather-free grid-shaped DG heat operator.

    Every entry point takes and returns (cx, cy, cz, nloc) arrays (the
    cell lattice and the local DG dofs). No Dirichlet lifting (the
    tempering problem's boundary is the Robin radiation + convection flux):
    build it on a HeatOperator without boundary conditions."""

    def __init__(self, op):
        fs = op.fs
        mesh = fs.mesh
        if mesh.structured is None or fs.family != "DG" or fs.degree != 1:
            raise ValueError("GridDGOperator needs a structured box mesh "
                             "with a DG-1 space")
        if op.has_bc:
            raise ValueError("GridDGOperator does not support Dirichlet "
                             "lifting")
        self.op = op
        self.st = DGStencilMatrix(op, allow_const=True)
        if not self.st.self_const:
            raise ValueError("GridDGOperator needs the uniform-box "
                             "constant-block form")
        self.dims = self.st.cell_dims
        self.d = len(self.dims)
        self.nloc = self.st.nloc
        self.dtype = op.dtype
        self.device = op.device
        self._build_faces()
        self._slabs: dict = {}

    # ------------------------------------------------------------------
    def _build_faces(self) -> None:
        """Group the boundary facets by (axis, side) and check the
        uniform-box invariant (identical quadrature tables across a face,
        every cell of its layer covered once), so that the flux is a
        per-face slice update."""
        op = self.op
        mesh = op.fs.mesh
        nref = _reference_outward_normals(mesh)       # (n_local_facets, d)
        lf = mesh.boundary_local_facet
        cells = mesh.boundary_cell
        qw = op.np_b_qw                               # (f, q)
        phi = op.np_b_phi                             # (f, q, l)
        if len(cells) != len(qw):
            raise ValueError("grid DG path needs whole-boundary flux")
        n_f = nref[lf]                                # (f, d)
        axis = np.argmax(np.abs(n_f), axis=1)
        side = (n_f[np.arange(len(axis)), axis] > 0).astype(int)
        dims = self.dims
        strides = np.array([int(np.prod(dims[i + 1:]))
                            for i in range(self.d)])
        f = lambda a: torch.as_tensor(  # noqa: E731
            np.ascontiguousarray(a), dtype=self.dtype, device=self.device)
        self.faces: list[_DGFace] = []
        for a in range(self.d):
            for s in (0, 1):
                sel = (axis == a) & (side == s)
                if not sel.any():
                    continue
                qws, phis = qw[sel], phi[sel]
                if (np.abs(qws - qws[0]).max()
                        > 1e-12 * max(qws.max(), 1e-30)
                        or np.abs(phis - phis[0]).max() > 1e-12):
                    raise ValueError("non-uniform face tables: the mesh is "
                                     "not a uniform box")
                layer = 0 if s == 0 else dims[a] - 1
                ca = (cells[sel] // strides[a]) % dims[a]
                n_layer = int(np.prod(dims)) // dims[a]
                if not (len(ca) == n_layer and np.all(ca == layer)):
                    raise ValueError("a boundary face does not cover its "
                                     "cell layer exactly once")
                self.faces.append(_DGFace(a, s, layer, f(qws[0]),
                                          f(phis[0])))

    def slab(self, lo: int, hi: int) -> "GridDGSlab":
        """The operator on cell layers [lo, hi) of axis 0 (one per range:
        the step and its preconditioner share it)."""
        if (lo, hi) not in self._slabs:
            self._slabs[(lo, hi)] = GridDGSlab(self, lo, hi)
        return self._slabs[(lo, hi)]

    # ------------------------------------------------------------------
    @staticmethod
    def _face_map(y, xg, fn, faces):
        """y[layer] += fn(face, x_layer) for every face, in place, as
        slice reads and writes; `faces` holds (face, layer) pairs."""
        for face, layer in faces:
            s = _sl(face.axis, slice(layer, layer + 1))
            y[s] = y[s] + fn(face, xg[s])
        return y

    def _faces(self):
        return [(fc, fc.layer) for fc in self.faces]

    @staticmethod
    def _gflux(p, face, seg, dt):
        """The boundary flux's residual contribution on a face layer."""
        Tb = seg @ face.phi.T                         # (..., 1, q)
        g = p.boundary_scale * (
            (p.sigma * p.epsilon) * (Tb**4 - p.T_ambient**4)
            + p.htc * (Tb - p.T_ambient))
        return (dt * face.qw * g) @ face.phi          # (..., 1, nloc)

    @staticmethod
    def _dflux_w(p, face, seg, dt):
        """The frozen flux linearisation's quadrature-point weights."""
        Tb = seg @ face.phi.T
        dflux = p.boundary_scale * (4.0 * p.sigma * p.epsilon * Tb**3
                                    + p.htc)
        return dt * face.qw * dflux                   # (..., 1, q)

    def residual_g(self, Tg, Tg_prev, dt=None):
        """Grid-shaped DG residual: DGStencilMatrix._base_residual with the
        boundary flux as face slices."""
        st, p = self.st, self.op.params
        dt = self.op.dt if dt is None else dt
        # the mass on the per-step difference, the source
        r = ((Tg - Tg_prev) @ st.A_mass.T) - (dt * p.f) * st.f1_row
        # stiffness + SIPG on the mean-shifted field
        zg = Tg - torch.mean(Tg)
        y = st._cross_apply(st._self_const_mv(st.A_stiff, 1.0, zg), zg, 1.0)
        r = r + dt * y
        return self._face_map(
            r, Tg, lambda fc, seg: self._gflux(p, fc, seg, dt), self._faces())

    def make_matvec_g(self, Tg, dt=None):
        """The Jacobian action frozen at Tg, grid-shaped: the boundary
        flux's linearisation rides as per-face quadrature weights."""
        st, p = self.st, self.op.params
        dt = self.op.dt if dt is None else dt
        A0 = st.A_mass + dt * st.A_stiff
        faces = self._faces()
        wfaces = [self._dflux_w(p, fc, Tg[_sl(fc.axis, slice(l, l + 1))], dt)
                  for fc, l in faces]

        def mv(xg):
            y = st._cross_apply(st._self_const_mv(A0, dt, xg), xg, dt)
            for (fc, l), w in zip(faces, wfaces):
                s = _sl(fc.axis, slice(l, l + 1))
                y[s] = y[s] + (w * (xg[s] @ fc.phi.T)) @ fc.phi
            return y

        return mv

    def jacobian_diag_g(self, Tg, dt=None):
        st, p = self.st, self.op.params
        dt = self.op.dt if dt is None else dt
        drow = torch.diagonal(st.A_mass + dt * st.A_stiff)
        dg = drow.expand(self.dims + (self.nloc,)).clone()
        for a, layer, Jc in st._layer_corrections(dt):
            s = _sl(a, slice(layer, layer + 1))
            dg[s] = dg[s] - torch.diagonal(Jc)
        return self._face_map(
            dg, Tg, lambda fc, seg: self._dflux_w(p, fc, seg, dt)
            @ (fc.phi**2), self._faces())


class GridDGSlab:
    """A GridDGOperator on cell layers [lo, hi) of axis 0 of its cell
    grid padded with ghost layers past the physical `dims[0]` (module
    docstring). `T_ext` / halos: (L + 2, cy, cz, nloc), the neighbours'
    layers first and last (zeros where there is none)."""

    def __init__(self, op: GridDGOperator, lo: int, hi: int):
        if not 0 <= lo < hi:
            raise ValueError(f"cell layers [{lo}, {hi})")
        self.op, self.st = op, op.st
        self.lo, self.hi, self.L = lo, hi, hi - lo
        cx = op.dims[0]
        self.n_real = max(0, min(hi, cx) - lo)       # owned real layers
        self.slab_shape = (self.L,) + op.dims[1:] + (op.nloc,)
        # window rows [0, n_ext_real) of the halo-carrying input are cells
        # below cx (row 0 is cell lo - 1)
        self.n_ext_real = min(self.L + 2, max(cx - lo + 1, 0))
        # the layer corrections and faces of axis 0 that land on an owned
        # real layer, as owned rows; those of the other axes on every row
        own = lambda layer: lo <= layer < lo + self.n_real  # noqa: E731
        self._faces = [(fc, fc.layer - (lo if fc.axis == 0 else 0))
                       for fc in op.faces
                       if fc.axis != 0 or own(fc.layer)]
        self._own_layer = own

    def _corrections(self, cscale):
        return [(a, layer - (self.lo if a == 0 else 0), Jc)
                for a, layer, Jc in self.st._layer_corrections(cscale)
                if a != 0 or self._own_layer(layer)]

    def _real_ext(self, xe):
        """Zero the window rows past the physical cells."""
        k = self.n_ext_real
        if k >= xe.shape[0]:
            return xe
        return torch.cat([xe[:k], torch.zeros_like(xe[k:])])

    def _ghost_rows(self, y, value: float):
        if self.n_real < self.L:
            y[self.n_real:] = value
        return y

    def _self_mv(self, A0, cscale, x):
        """DGStencilMatrix._self_const_mv on the owned rows."""
        y = x @ A0.T
        for a, layer, Jc in self._corrections(cscale):
            s = _sl(a, slice(layer, layer + 1))
            y[s] = y[s] - x[s] @ Jc.T
        return y

    def _cross(self, y, xe, dt):
        """DGStencilMatrix._cross_apply on the owned rows of the
        halo-carrying xe, in its order of operations (a term of a missing
        neighbour adds an exact zero)."""
        st, x = self.st, xe[1:-1]
        for a in range(self.st.d):
            if a == 0:
                y = y + dt * (xe[2:] @ st.Bp[0].T)
                y = y + dt * (xe[:-2] @ st.Bm[0].T)
                continue
            hi, lo = _sl(a, slice(1, None)), _sl(a, slice(0, -1))
            y[lo] = y[lo] + dt * (x[hi] @ st.Bp[a].T)
            y[hi] = y[hi] + dt * (x[lo] @ st.Bm[a].T)
        return y

    def residual_r(self, T_ext, Tp, dt, total):
        """The owned rows of the residual (zero on ghost rows). `Tp`: the
        owned rows of the previous step's T; `total(s)`: the sum of a 0-d
        tensor over the ranks (the global mean's)."""
        op, st, p = self.op, self.st, self.op.op.params
        T = T_ext[1:-1]
        r = ((T - Tp) @ st.A_mass.T) - (dt * p.f) * st.f1_row
        n_all = int(np.prod(op.dims)) * op.nloc
        mean = total(torch.sum(T[:self.n_real])) / n_all
        ze = self._real_ext(T_ext - mean)
        if self.lo == 0:
            ze = torch.cat([torch.zeros_like(ze[:1]), ze[1:]])
        y = self._cross(self._self_mv(st.A_stiff, 1.0, ze[1:-1]), ze, 1.0)
        r = r + dt * y
        r = op._face_map(r, T, lambda fc, seg: op._gflux(p, fc, seg, dt),
                         self._faces)
        return self._ghost_rows(r, 0.0)

    def make_matvec_r(self, T, dt, halo):
        """v (owned rows) -> J(T) v on the owned rows, zero on ghost rows:
        `T` the owned rows of the frozen state, `halo(v) -> (L + 2, ...)`
        a collective (every rank applies together)."""
        op, st, p = self.op, self.st, self.op.op.params
        A0 = st.A_mass + dt * st.A_stiff
        faces = self._faces
        wfaces = [op._dflux_w(p, fc, T[_sl(fc.axis, slice(l, l + 1))], dt)
                  for fc, l in faces]

        def mv(v):
            xe = self._real_ext(halo(v))
            x = xe[1:-1]
            y = self._cross(self._self_mv(A0, dt, x), xe, dt)
            for (fc, l), w in zip(faces, wfaces):
                s = _sl(fc.axis, slice(l, l + 1))
                y[s] = y[s] + (w * (x[s] @ fc.phi.T)) @ fc.phi
            return self._ghost_rows(y, 0.0)

        return mv

    def jacobian_diag_r(self, T, dt):
        """The owned rows of the diagonal (one on ghost rows)."""
        op, st, p = self.op, self.st, self.op.op.params
        drow = torch.diagonal(st.A_mass + dt * st.A_stiff)
        dg = drow.expand(self.slab_shape).clone()
        for a, layer, Jc in self._corrections(dt):
            s = _sl(a, slice(layer, layer + 1))
            dg[s] = dg[s] - torch.diagonal(Jc)
        dg = op._face_map(dg, T, lambda fc, seg: op._dflux_w(p, fc, seg, dt)
                          @ (fc.phi**2), self._faces)
        return self._ghost_rows(dg, 1.0)


# ----------------------------------------------------------------------
def dg_vertex_offsets(mesh):
    """Per-local-vertex lattice offsets of a structured box mesh's DG-1
    dofs: cell (i, j, k)'s vertex l sits at node (i, j, k) + offs[l].
    Checks translation invariance; raises if the dofmap is not the
    lattice layout. -> (offs, node grid)."""
    dims = tuple(mesh.structured["dims"])
    node_grid = tuple(n + 1 for n in dims)
    nstr = [int(np.prod(node_grid[i + 1:])) for i in range(len(dims))]
    cells_np = mesh.cells
    offs = []
    for l in range(cells_np.shape[1]):
        nid = int(cells_np[0, l])
        o = []
        for s in nstr:
            o.append(nid // s)
            nid %= s
        offs.append(tuple(o))
    cc = np.stack(np.unravel_index(np.arange(mesh.n_cells), dims), axis=-1)
    rec = np.stack([
        sum((cc[:, i] + o[i]) * nstr[i] for i in range(len(dims)))
        for o in offs], axis=-1)
    if not np.array_equal(rec, cells_np):
        raise ValueError("mesh cells are not the translation-invariant "
                         "box lattice layout")
    return offs, node_grid


def dg_to_nodes_g(ag, vert_offs, node_grid):
    """DG-1 cell-grid field (cx, cy, cz, nloc) -> the CG-1 node grid with
    dolfinx's last-cell-wins overwrite (ops/interpolation.py's cross
    evaluation): the local vertices written in descending l leave each
    node its highest incident cell's value."""
    out = torch.zeros(node_grid, dtype=ag.dtype, device=ag.device)
    cdims = ag.shape[:-1]
    for l in reversed(range(ag.shape[-1])):
        o = vert_offs[l]
        out[tuple(slice(oi, oi + di) for oi, di in zip(o, cdims))] = \
            ag[..., l]
    return out


def _restrict_window(rg, vert_offs):
    """The transposed prolongation of a cell window (n, cy, cz, nloc) ->
    its n + 1 node planes: JAX's restrict_g, 2^d zero pads added in
    vertex order."""
    out = None
    for l, o in enumerate(vert_offs):
        pads = []
        for oi in reversed(o):
            pads += [oi, 1 - oi]
        t = F.pad(rg[..., l], pads)
        out = t if out is None else out + t
    return out


def _prolong_window(xg, vert_offs, cdims):
    """Node planes -> the cells `cdims` they carry: JAX's prolong_g."""
    parts = [xg[tuple(slice(oi, oi + di) for oi, di in zip(o, cdims))]
             for o in vert_offs]
    return torch.stack(parts, dim=-1)


class CellNodeTransfers:
    """The maps between one rank's cell layers `cell_rows[rank]` of a
    DG-1 cell grid (cx, cy, cz) padded with ghost layers, and its rows
    `node_rows[rank]` of the CG-1 node grid (cx + 1, ...) padded with
    ghost planes (module docstring). A node rank computes its physical
    planes, and node plane cx where it holds ghost planes, from the cells
    that touch them; a cell rank reads the node planes of its real
    cells. Every rank must call each map together."""

    def __init__(self, vert_offs, cell_dims, cell_rows, node_rows,
                 device_mesh, inv_counts=None):
        from fem_glass_tempering_tpu_torch.parallel.comm import Repartition
        self.vo = vert_offs
        self.cdims = tuple(cell_dims)
        self.rank = r = device_mesh.rank
        cx = self.cdims[0]
        gx = cx + 1
        self.gx = gx
        self.c0, c1 = cell_rows[r]
        self.e = max(min(c1, cx), self.c0)        # real cells [c0, e)
        self.L = c1 - self.c0
        self.n0, self.n1 = node_rows[r]
        cwin, nwin = [], []
        for (a, b), (n0, n1) in zip(cell_rows, node_rows):
            k0, k1 = min(n0, gx - 1), min(n1, gx)
            cwin.append((max(k0 - 1, 0), min(k1, cx)))
            e = max(min(b, cx), a)
            nwin.append((a, e + 1) if e > a else (a, a))
        self.k0 = min(self.n0, gx - 1)
        self.w0 = cwin[r][0]
        self._to_nodes = Repartition(cell_rows, cwin, device_mesh)
        self._to_cells = Repartition(node_rows, nwin, device_mesh)
        self.inv_counts = (None if inv_counts is None
                           else inv_counts[self.k0:min(self.n1, gx)])

    def _node_rows(self, planes, ghost: str):
        """Node planes [k0, min(n1, gx)) -> this rank's rows [n0, n1):
        the ghost planes zero or a copy of plane gx - 1."""
        own = planes[max(self.n0 - self.k0, 0):]
        g = self.n1 - max(self.n0, self.gx)
        if g <= 0:
            return own
        fill = (planes[-1:].expand((g,) + tuple(planes.shape[1:]))
                if ghost == "edge" else torch.zeros_like(planes[:1]).expand(
                    (g,) + tuple(planes.shape[1:])))
        return torch.cat([own, fill])

    def _node_planes(self, rg, fn):
        """The planes [k0, min(n1, gx)) of fn(cell window)."""
        k1 = min(self.n1, self.gx)
        return fn(self._to_nodes(rg))[self.k0 - self.w0:k1 - self.w0]

    def restrict(self, rg):
        """DGMultigrid.restrict_g on this rank's cells (ghost cells
        excluded) -> its node rows, zero on ghost planes."""
        planes = self._node_planes(rg, lambda w: _restrict_window(w, self.vo))
        return self._node_rows(planes, "zero")

    def restrict_state(self, rg):
        """DGMultigrid.restrict_state_g, the ghost planes edge-padded."""
        planes = self._node_planes(
            rg, lambda w: _restrict_window(w, self.vo)) * self.inv_counts
        return self._node_rows(planes, "edge")

    def to_nodes(self, rg):
        """dg_to_nodes_g on this rank's cells -> its node rows, the ghost
        planes edge-padded (the sigma space's cross evaluation)."""
        planes = self._node_planes(rg, lambda w: dg_to_nodes_g(
            w, self.vo, (w.shape[0] + 1,) + tuple(
                n + 1 for n in self.cdims[1:])))
        return self._node_rows(planes, "edge")

    def prolong(self, x_rows):
        """This rank's node rows -> DGMultigrid.prolong_g on its cells,
        zero on ghost cells."""
        w = self._to_cells(x_rows)
        n = self.e - self.c0
        shape = (self.L,) + self.cdims[1:] + (len(self.vo),)
        if n == 0:
            return torch.zeros(shape, dtype=x_rows.dtype,
                               device=x_rows.device)
        x = _prolong_window(w, self.vo, (n,) + self.cdims[1:])
        if n < self.L:
            x = torch.cat([x, x.new_zeros((self.L - n,) + shape[1:])])
        return x


class RankDGMultigrid:
    """DGMultigrid's grid route on one rank (module docstring): `mg` a
    frozen DGMultigrid(coarse_kind="grid") over the whole grid, `cell_rows`
    / `node_rows` every rank's cell layers and node rows in rank order."""

    def __init__(self, mg, device_mesh, cell_rows, node_rows):
        from fem_glass_tempering_tpu_torch.parallel import comm
        from fem_glass_tempering_tpu_torch.solver.grid_mg import RankGridMG
        if mg.coarse_kind != "grid":
            raise ValueError("RankDGMultigrid needs coarse_kind='grid'")
        data = mg._frozen_smoother_data
        if data is None or mg._frozen_rho is None:
            raise ValueError("call DGMultigrid.freeze() first")
        self._comm = comm
        self.mg = mg
        self.comm = device_mesh
        self.rank_mg = RankGridMG(mg.cg_mg, device_mesh, node_rows)
        self.tr = CellNodeTransfers(mg._vert_offs, mg.stencil.cell_dims,
                                    cell_rows, node_rows, device_mesh,
                                    inv_counts=mg.inv_counts.reshape(
                                        mg._node_grid))
        c0, e, L = self.tr.c0, self.tr.e, self.tr.L
        self.n_real, self.L = e - c0, L
        dims = mg.stencil.cell_dims
        nloc = mg.stencil.nloc
        self.cx = dims[0]
        self.gather_columns = mg.smoother == "column" and mg.col_axis == 0
        if "diag" in data:
            local = {"diag": data["diag"].reshape(dims + (nloc,))[c0:e]}
        elif "inv_self" in data:
            local = {"inv_self": data["inv_self"].reshape(
                dims + (nloc, nloc))[c0:e]}
        elif "colinv" not in data:
            raise ValueError("grid-shaped smoother needs the dense column "
                             "form (column_dense=True) or block/jacobi")
        elif self.gather_columns:
            local = data
        else:
            k = data["colmask"].shape[0] // self.cx   # columns a layer
            local = {"colinv": data["colinv"],
                     "colmask": data["colmask"][c0 * k:e * k]}
        self.data = local

    def _zsolve(self, r):
        """The smoother solve on this rank's cells (zero on ghost
        cells); along axis 0 on the all-gathered real cells."""
        mg, n = self.mg, self.n_real
        if self.gather_columns:
            whole = self._comm.all_gather(r.contiguous(), self.comm)
            x = mg._zsolve_apply_g(self.data, whole[:self.cx])
            x = x[self.tr.c0:self.tr.e]
        elif n:
            x = mg._zsolve_apply_g(self.data, r[:n])
        else:
            return torch.zeros_like(r)
        if n < self.L:
            x = torch.cat([x, torch.zeros_like(r[n:])])
        return x

    def preconditioner(self, T, dt, matvec):
        """The apply r -> ~A^{-1} r on this rank's cells (L, cy, cz, nloc)
        for the Jacobian frozen at T (the rank's cells), `matvec` its
        action (the slab's, GridDGSlab.make_matvec_r)."""
        rmg, tr = self.rank_mg, self.tr
        inner = rmg.preconditioner(rmg.linearization_states(
            tr.restrict_state(T)), dt)
        smooth = self.mg._make_smooth(matvec, self._zsolve,
                                      self.mg._frozen_rho)
        return self.mg._pmg_apply(smooth, matvec,
                                  lambda rr: inner(tr.restrict(rr)),
                                  tr.prolong)
