"""Grid-shaped geometric V-cycles: the heat V-cycle of the grid-sharded
step (GridMG, with its rank form RankGridMG) and the vector elasticity
V-cycle (GridElastMG, with its rank form RankGridElastMG).

GridMG is the counterpart of `GridMG` in
fem_glass_tempering_tpu/solver/grid_mg.py: the hierarchy of
GeometricMG (solver/multigrid.py) kept grid-shaped end to end, on a fine
level whose grid may carry ghost planes along axis 0 (GridHeatOperator's
`pad_axis0`): the cycle smooths on the padded grid, where the ghost rows
are identity rows, and the lattice transfers act on the physical planes
alone. Each level's Jacobian action is its tables baked at the level's
linearisation state and applied by K2; the coarsest level is a frozen
dense inverse ("auto", at most 4,096 nodes) or `coarse_iters` sweeps
("smooth").

RankGridMG runs that cycle on one rank of a grid split along axis 0
(parallel/grid_shard.py). Level 0 keeps the padded layout; a coarser
level's planes go to the rank that holds fine plane 2j (axis 0 halved) or
j (not). A level on which every rank holds two planes or more is sharded:
its slab operator (ops/grid.py GridSlab) smooths with K2's halo form, and
its transfers read one halo plane (the fine level's odd neighbours to
restrict, the coarse level's to prolong). From the first level where some
rank would hold fewer, and at the dense coarse solve, the cycle runs
replicated on every rank after one all-gather, as JAX replicates its small
coarse tables; its corrections come back as each rank's own rows. Every
sum of a sharded level is the whole cycle's, term for term.

GridElastMG, the vector elasticity V-cycle:

Counterpart of `GridElastMG` in fem_glass_tempering_tpu/solver/grid_mg.py,
the preconditioner of the equilibrium-mechanics solve (models/mechanics.py;
Jacobi-CG stalls on thin tempering plates). The V-cycle keeps the
displacement grid-shaped (*grid, d) end to end:

  - the levels are GridElasticityOperators on the semi-coarsened box
    meshes of the heat multigrid's rule (solver/multigrid.py), down to the
    first level of at most 4,096 components, whose operator at the frozen
    instantaneous moduli is inverted densely on the host (numpy);
  - the per-level coefficients are the fine G/K fields averaged down the
    hierarchy cell by cell;
  - each level smooths by Chebyshev acceleration of a line solve along the
    strongly coupled axis (a batched block-Thomas factorisation of every
    column, where the cells are more than 3x anisotropic) or of the point
    diagonal, over [rho/4, rho] with rho a power-iteration estimate
    (lines) or a Gershgorin bound (points) computed at every build;
  - the transfers are the strided-slice lattice ops of GeometricMG with
    the vector component riding along;
  - a fine grid with ghost planes along axis 0 (GridElasticityOperator's
    `pad_axis0`) is smoothed whole, the ghosts pinned; the transfers drop
    them (restriction) and give them a zero correction (prolongation),
    and a padded coarsest level smooths, where an unpadded one would be
    solved densely (JAX's rule).

RankGridElastMG runs that cycle on one rank of the grid-sharded step, in
RankGridMG's layout (the shared part is _RankLevels): a level's slab
(ops/grid_elasticity.py GridElasticitySlab) gives its owned rows of the
table, diagonal and line factors; its Gershgorin bound is a max over the
ranks (exact), its power iteration sums each norm's squares over the
ranks (the one place its bits part from the unsharded cycle's). A line
smoother along axis 0 would cross the ranks: such a level runs
replicated.

Everything is plain PyTorch, as it is plain XLA in the JAX package. The
small-block algebra is written as multiply + reduce and the 3x3 inverse as
the closed-form adjugate, in the JAX version's order of operations.

The CG-2 path's Q2MG (ops/grid2.py) runs GeometricMG, the flat form of
GridMG's cycle, on its flattened coarse residual; its grid route
(coarse_kind="grid", the grid-sharded CG-2 step's) runs GridMG over a
node grid padded with ghost planes, and RankQ2MG this module's RankGridMG.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fem_glass_tempering_tpu_torch.ops.grid import GridHeatOperator
from fem_glass_tempering_tpu_torch.solver.multigrid import (
    GeometricMG,
    _build_level_mesh,
    _next_dims,
    _sl,
)


class GridMG:
    """Usage: mg = GridMG(fine_grid_op, make_heat_operator);
    mg.freeze_rhos(dt); apply = mg.preconditioner_g(
    mg.linearization_states_g(Tg), dt)  # r_grid -> ~A^{-1} r_grid"""

    def __init__(self, fine: GridHeatOperator, make_heat_operator, *,
                 nu_pre: int = 2, nu_post: int = 2,
                 smoother: str = "chebyshev", coarse_iters: int = 24,
                 min_level_nodes: int = 27, coarse: str = "auto"):
        mesh = fine.op.fs.mesh
        if mesh.structured is None:
            raise ValueError("GridMG needs a structured box mesh")
        if smoother not in ("jacobi", "chebyshev"):
            raise ValueError(smoother)
        if coarse not in ("auto", "smooth"):
            raise ValueError(coarse)
        self.nu_pre, self.nu_post = nu_pre, nu_post
        self.smoother = smoother
        self.coarse_iters = coarse_iters
        self.pad0 = fine.pad0
        self.phys0 = fine.st.grid[0]      # physical node planes, axis 0
        meta = mesh.structured
        dims = tuple(meta["dims"])
        lengths = tuple(meta["lengths"])
        # 'auto': stop at the first level small enough for the frozen
        # dense direct solve (GeometricMG's rule)
        dense_stop = 4096 if coarse == "auto" else 0
        n_nodes = lambda dd: int(np.prod(tuple(n + 1 for n in dd)))  # noqa
        # level i: its operator, and the axes halved toward level i + 1
        self.ops: list[GridHeatOperator] = [fine]
        self.axes: list[tuple | None] = []
        while True:
            cdims = _next_dims(dims, lengths)
            if dense_stop and n_nodes(dims) <= dense_stop:
                cdims = None
            if cdims is None or n_nodes(cdims) < min_level_nodes:
                self.axes.append(None)
                break
            self.axes.append(tuple(a for a in range(len(dims))
                                   if cdims[a] != dims[a]))
            dims = cdims
            # the level's device tables are made where a whole-level
            # method first needs them (a sharded level reads its slab's)
            self.ops.append(GridHeatOperator(
                make_heat_operator(_build_level_mesh(meta, dims)),
                tables=False))
        self._frozen_rhos: list[float] | None = None
        # frozen dense inverse of the coarsest level's Jacobian at (T_0,
        # the level operator's dt), assembled and inverted on the host
        self.coarse_inv = None
        if dense_stop and n_nodes(dims) <= dense_stop:
            cop = self.ops[-1]
            A = cop.st.np_dense(cop.op.params.T_0, cop.op.dt)
            self.coarse_inv = torch.as_tensor(
                np.linalg.inv(A), dtype=cop.dtype, device=cop.device)

    def freeze_rhos(self, dt: float) -> None:
        """Per-level Gershgorin bound on rho(D^{-1}A) from the numpy row
        statistics of each level's StencilMatrix (boundary linearisation
        at T_0)."""
        vals = []
        for op in self.ops:
            g = op.st.gersh
            num = g["mass_abs"] + dt * (g["stiff_abs"] + g["b_abs"])
            den = g["mass_diag"] + dt * (g["stiff_diag"] + g["b_diag"])
            vals.append(float(np.max(num / den)))
        self._frozen_rhos = vals

    # ---- lattice transfers (whole grids; physical planes only) --------
    def _restrict(self, i: int, rg):
        if i == 0 and self.pad0:
            rg = rg[:self.phys0]
        for a in self.axes[i]:
            rg = GeometricMG._restrict_axis(rg, a)
        return rg

    def _prolong(self, i: int, xc):
        for a in self.axes[i]:
            xc = GeometricMG._prolong_axis(xc, a)
        if i == 0 and self.pad0:
            # zero correction on the ghost planes
            xc = F.pad(xc, (0, 0) * (xc.dim() - 1) + (0, self.pad0))
        return xc

    def _inject(self, i: int, xf):
        if i == 0 and self.pad0:
            xf = xf[:self.phys0]
        for a in self.axes[i]:
            xf = xf[_sl(a, slice(0, None, 2))]
        return xf

    def linearization_states_g(self, Tg):
        """Per-level temperature grids (even-node injection), at which
        each level's boundary linearisation is frozen."""
        states = [Tg]
        for i in range(len(self.ops) - 1):
            states.append(self._inject(i, states[-1]))
        return states

    # ---- apply ---------------------------------------------------------
    def preconditioner_g(self, T_levels, dt):
        """The V-cycle apply r_grid -> ~A^{-1} r_grid for the Jacobians
        frozen at the per-level states T_levels."""
        mv, dg = [], []
        for op, T in zip(self.ops, T_levels):
            mv.append(op.make_matvec_g(T, dt))
            dg.append(op.jacobian_diag_g(T, dt))
        down = [lambda r, i=i: self._restrict(i, r)
                for i in range(len(self.ops) - 1)]
        up = [lambda xc, i=i: self._prolong(i, xc)
              for i in range(len(self.ops) - 1)]
        return self._vcycle(mv, dg, down, up)

    def _vcycle(self, mv, dg, down, up):
        """The cycle over per-level Jacobian actions `mv`, diagonals `dg`
        and transfers `down[i]` (level i -> i + 1) / `up[i]` (level i + 1
        -> its correction on level i), in whatever layout each level's
        vectors take (whole grids, or a rank's rows)."""
        assert self._frozen_rhos is not None, "call freeze_rhos(dt) first"
        rhos = self._frozen_rhos

        def smooth_jacobi(i, x, b, nu):
            omega = 4.0 / (3.0 * rhos[i])
            for _ in range(nu):
                x = x + omega * (b - mv[i](x)) / dg[i]
            return x

        def smooth_cheb(i, x, b, nu):
            # Chebyshev over D^{-1}A on [rho/4, rho]
            lmax = rhos[i]
            lmin = lmax / 4.0
            theta = 0.5 * (lmax + lmin)
            delta = 0.5 * (lmax - lmin)
            sigma = theta / delta
            rho_k = 1.0 / sigma
            r = b - mv[i](x)
            p = (r / dg[i]) / theta
            x = x + p
            for _ in range(max(nu - 1, 0)):
                r = b - mv[i](x)
                z = r / dg[i]
                rho_next = 1.0 / (2.0 * sigma - rho_k)
                p = rho_next * rho_k * p + (2.0 * rho_next / delta) * z
                x = x + p
                rho_k = rho_next
            return x

        smooth = smooth_jacobi if self.smoother == "jacobi" else smooth_cheb
        inv = self.coarse_inv

        def coarse(i, b):
            if inv is None:
                return smooth(i, torch.zeros_like(b), b, self.coarse_iters)
            if i == 0 and self.pad0:
                # a one-level padded hierarchy: the physical planes solved
                # exactly, the ghost rows kept (x = b there)
                bp = b[:self.phys0]
                x = (inv @ bp.reshape(-1)).reshape(bp.shape)
                return torch.cat([x, b[self.phys0:]])
            return (inv @ b.reshape(-1)).reshape(b.shape)

        def apply(b):
            # down the levels and back up in a loop (a recursive closure
            # would hold itself, and each build's tables with it)
            bs, xs = [], []
            i = 0
            while self.axes[i] is not None:
                x = smooth(i, torch.zeros_like(b), b, self.nu_pre)
                r = b - mv[i](x)
                bs.append(b)
                xs.append(x)
                b = down[i](r)
                i += 1
            xc = coarse(i, b)
            for i in reversed(range(len(xs))):
                xc = smooth(i, xs[i] + up[i](xc), bs[i], self.nu_post)
            return xc

        return apply


class _RankLevels:
    """The layout of a grid-shaped V-cycle's levels over the ranks of a
    grid split along axis 0, and the transfers between two sharded levels
    (module docstring). `rows[i]` holds every rank's planes of level i,
    `sharded[i]` whether level i runs on the ranks' slabs; `mg` provides
    `ops` (each with `.grid`), `axes`, `coarse_inv` and `phys0`."""

    def __init__(self, mg, device_mesh, rows0):
        # imported here: the parallel package imports this module
        from fem_glass_tempering_tpu_torch.parallel import comm
        self._collectives = comm
        self.mg = mg
        self.comm = device_mesh
        self.rank = device_mesh.rank
        rows = [list(rows0)]
        for i, axes in enumerate(mg.axes[:-1]):
            phys = mg.phys0 if i == 0 else mg.ops[i].grid[0]
            nxt = []
            for lo, hi in rows[-1]:
                a, b = min(lo, phys), min(hi, phys)
                if 0 in axes:
                    a, b = (a + 1) // 2, (b + 1) // 2
                nxt.append((a, b))
            rows.append(nxt)
        self.rows = rows
        self.sharded = []
        on = True
        for i, rr in enumerate(rows):
            dense = mg.axes[i] is None and mg.coarse_inv is not None
            on = (on and not dense and self._shardable(i)
                  and all(hi - lo >= 2 for lo, hi in rr))
            self.sharded.append(on)

    def _shardable(self, i) -> bool:
        return True

    def _halo(self, x):
        return self._collectives.halo_exchange(x, self.comm)

    def _gather(self, i, x):
        """A sharded level's rows -> the whole level on every rank."""
        lo, hi = self.rows[i][self.rank]
        n = self.mg.ops[i].grid[0]
        return self._collectives.gather_rows(x, slice(lo, hi), n, self.comm)

    def _own(self, i, x):
        lo, hi = self.rows[i][self.rank]
        return x[lo:hi]

    def _phys(self, i):
        return self.mg.phys0 if i == 0 else self.mg.ops[i].grid[0]

    # ---- transfers between two sharded levels ---------------------------
    def _restrict_r(self, i, r):
        lo, hi = self.rows[i][self.rank]
        clo, chi = self.rows[i + 1][self.rank]
        axes = self.mg.axes[i]
        if 0 in axes:
            re = self._halo(r)                       # planes lo-1 .. hi
            ghost = self._phys(i) - (lo - 1)
            if ghost < re.shape[0]:
                re[max(ghost, 0):] = 0.0             # ghost planes: absent
            s, k = 2 * clo - (lo - 1), chi - clo
            rc = re[s:s + 2 * k:2] + 0.5 * (re[s + 1:s + 1 + 2 * k:2]
                                            + re[s - 1:s - 1 + 2 * k:2])
        else:
            rc = r[clo - lo:chi - lo]
        for a in axes:
            if a != 0:
                rc = GeometricMG._restrict_axis(rc, a)
        return rc

    def _prolong_r(self, i, xc):
        lo, hi = self.rows[i][self.rank]
        clo, _ = self.rows[i + 1][self.rank]
        b = min(hi, self._phys(i))
        axes = self.mg.axes[i]
        if 0 in axes:
            f = GeometricMG._prolong_axis(self._halo(xc), 0)
            x = f[lo - 2 * (clo - 1):b - 2 * (clo - 1)]
        else:
            x = xc
        for a in axes:
            if a != 0:
                x = GeometricMG._prolong_axis(x, a)
        if hi > b:
            x = F.pad(x, (0, 0) * (x.dim() - 1) + (0, hi - b))
        return x

    def _transfers(self):
        """Per level i: down[i] (level i -> i + 1) and up[i] (level i + 1
        -> its correction on level i) in the levels' layouts: a sharded
        level's rows, a replicated level whole."""
        mg = self.mg
        down, up = [], []
        for i in range(len(mg.ops) - 1):
            if self.sharded[i + 1]:
                down.append(lambda r, i=i: self._restrict_r(i, r))
                up.append(lambda xc, i=i: self._prolong_r(i, xc))
            elif self.sharded[i]:
                down.append(lambda r, i=i: mg._restrict(i, self._gather(i, r)))
                up.append(lambda xc, i=i: self._own(i, mg._prolong(i, xc)))
            else:
                down.append(lambda r, i=i: mg._restrict(i, r))
                up.append(lambda xc, i=i: mg._prolong(i, xc))
        return down, up

    def _on_rows(self, cycle, shape):
        """The cycle as an apply on this rank's level-0 rows (any shape of
        `shape`'s values)."""
        if self.sharded[0]:
            return lambda r: cycle(r.reshape(shape)).reshape(r.shape)
        return lambda r: self._own(0, cycle(self._gather(
            0, r.reshape(shape)))).reshape(r.shape)


class RankGridMG(_RankLevels):
    """GridMG's V-cycle on one rank of a grid split along axis 0 (module
    docstring), from `rows0`, the level-0 planes [lo, hi) of every rank in
    rank order. Every rank must apply it together."""

    def __init__(self, mg: GridMG, device_mesh, rows0):
        super().__init__(mg, device_mesh, rows0)
        self.slabs = []
        for i, op in enumerate(mg.ops):
            if self.sharded[i]:
                self.slabs.append(op.slab(*self.rows[i][self.rank]))
            else:
                op.ensure_tables()
                self.slabs.append(None)

    def _inject_r(self, i, x):
        lo, _ = self.rows[i][self.rank]
        clo, chi = self.rows[i + 1][self.rank]
        axes = self.mg.axes[i]
        if 0 in axes:
            x = x[2 * clo - lo:2 * chi - lo:2]
        else:
            x = x[clo - lo:chi - lo]
        for a in axes:
            if a != 0:
                x = x[_sl(a, slice(0, None, 2))]
        return x

    # ---- states and apply ---------------------------------------------
    def linearization_states(self, T0):
        """Per-level states from this rank's level-0 rows T0 (L, ...): a
        sharded level's as this rank's rows, a replicated level's whole."""
        mg = self.mg
        cur = T0 if self.sharded[0] else self._gather(0, T0)
        states = [cur]
        for i in range(len(mg.ops) - 1):
            if self.sharded[i + 1]:
                cur = self._inject_r(i, cur)
            elif self.sharded[i]:
                cur = mg._inject(i, self._gather(i, cur))
            else:
                cur = mg._inject(i, cur)
            states.append(cur)
        return states

    def preconditioner(self, T_levels, dt):
        """The apply r -> ~A^{-1} r on this rank's level-0 rows (any shape
        of L x prod(grid[1:]) values), for the Jacobians frozen at the
        states of `linearization_states`."""
        mg = self.mg
        mv, dg = [], []
        for i, T in enumerate(T_levels):
            slab = self.slabs[i]
            if slab is not None:
                Te = self._halo(T)
                mv.append(slab.make_matvec_r(Te, dt, self._halo))
                dg.append(slab.jacobian_diag_r(Te, dt))
            else:
                mv.append(mg.ops[i].make_matvec_g(T, dt))
                dg.append(mg.ops[i].jacobian_diag_g(T, dt))
        cycle = mg._vcycle(mv, dg, *self._transfers())
        lo, hi = self.rows[0][self.rank]
        return self._on_rows(cycle, (hi - lo,) + mg.ops[0].grid[1:])


class GridElastMG:
    """Usage: mg = GridElastMG(fine_op, make_level_op, frozen_moduli=(G0,
    K0)); apply = mg.preconditioner_g(G_q, K_q) -> r_grid -> ~A^{-1} r."""

    def __init__(self, fine, make_level_op, *, nu_pre: int = 2,
                 nu_post: int = 2, coarse_iters: int = 24,
                 min_level_nodes: int = 27,
                 frozen_moduli: tuple | None = None,
                 use_tables: bool = True):
        # materialized block-stencil tables for the cycle's matvecs
        # (ops/grid_elasticity.py stencil_table_g) or the cell recompute
        self.use_tables = use_tables
        meta = fine.fs.mesh.structured
        dims = tuple(meta["dims"])
        lengths = tuple(meta["lengths"])
        self.nu_pre, self.nu_post = nu_pre, nu_post
        self.coarse_iters = coarse_iters
        # a padded fine grid (GridElasticityOperator's pad_axis0): the
        # cycle smooths on it, the transfers act on the physical planes
        self.pad0 = fine.pad0
        self.phys0 = fine.base_grid[0]
        self.ops = [fine]
        self.axes: list[tuple | None] = []
        # with frozen moduli: stop at the first level whose component
        # count (nodes x d) fits the dense direct solve, which damps the
        # near-singular rigid-rotation modes of the free plate; without,
        # coarsen on and smooth the coarsest level
        dense_stop = 4096 if frozen_moduli is not None else 0

        def n_comp(dd):
            return fine.d * int(np.prod(tuple(n + 1 for n in dd)))

        while True:
            cdims = _next_dims(dims, lengths)
            if dense_stop and n_comp(dims) <= dense_stop:
                cdims = None
            if cdims is None or int(np.prod(
                    tuple(n + 1 for n in cdims))) < min_level_nodes:
                self.axes.append(None)
                break
            self.axes.append(tuple(a for a in range(len(dims))
                                   if cdims[a] != dims[a]))
            dims = cdims
            self.ops.append(make_level_op(_build_level_mesh(meta, dims)))
        # no dense solve over a padded level (a one-level hierarchy of the
        # sharded step's grid): it smooths there
        self._dense_coarse = bool(dense_stop and n_comp(dims) <= dense_stop
                                  and self.ops[-1].pad0 == 0)
        self._frozen_moduli = frozen_moduli
        # constant element tables per level (uniform cells):
        #   A[(l,a),(m,b)] = G*EG + K*EK with
        #   EG = sum_q w [d_ab grad(phi_l).grad(phi_m) + d_b phi_l d_a phi_m
        #                 - (2/d) d_a phi_l d_b phi_m]
        #   EK = sum_q w d_a phi_l d_b phi_m
        self._tables = []       # Gershgorin row stats (SG, SK, DG, DK)
        self._EGK = []          # full (l, a, m, b) element tensors
        self._np_EGK = []       # numpy sources (dense coarse assembly)
        self._smoothers = []    # 'column' | 'point' per level
        self._col_axis = []
        for op in self.ops:
            qw, gp = op.np_qw1, op.np_gphi1
            d = op.d
            gg = np.einsum("q,qlg,qmg->lm", qw, gp, gp)
            cross = np.einsum("q,qlb,qma->lamb", qw, gp, gp)
            EK = np.einsum("q,qla,qmb->lamb", qw, gp, gp)
            EG = (np.einsum("lm,ab->lamb", gg, np.eye(d))
                  + cross - (2.0 / d) * EK)
            SG = np.abs(EG).sum(axis=(2, 3))
            SK = np.abs(EK).sum(axis=(2, 3))
            DG = np.einsum("lala->la", EG)
            DK = np.einsum("lala->la", EK)
            f = (lambda o: lambda a: torch.as_tensor(
                a, dtype=o.dtype, device=o.device))(op)
            self._tables.append((f(SG), f(SK), f(DG), f(DK)))
            self._EGK.append((f(EG), f(EK)))
            self._np_EGK.append((EG, EK))
            # line smoothing along the strongly coupled (small-h) axis:
            # point smoothers cannot damp the through-thickness modes of a
            # thin plate
            h = [ln / dd for ln, dd in zip(
                op.fs.mesh.structured["lengths"], op.dims)]
            aniso = max(h) / min(h) > 3.0 and d >= 2
            ax = int(np.argmin(h))
            if aniso and op.dims[ax] >= 1:
                self._smoothers.append("column")
                self._col_axis.append(ax)
            else:
                self._smoothers.append("point")
                self._col_axis.append(None)
        # frozen dense inverse of the coarsest level at the instantaneous
        # moduli (xi = 0), assembled and inverted on the host in f64 and
        # cast to the level's dtype
        self.coarse_inv = None
        if self._dense_coarse:
            G0, K0 = self._frozen_moduli
            A = self._np_dense_coarse(float(G0), float(K0))
            last = self.ops[-1]
            self.coarse_inv = torch.as_tensor(
                np.linalg.inv(A), dtype=last.dtype, device=last.device)

    # ------------------------------------------------------------------
    def _np_dense_coarse(self, G0: float, K0: float) -> np.ndarray:
        """Host-assembled dense matrix of the coarsest level at constant
        moduli, pinned components as identity rows and columns."""
        op = self.ops[-1]
        EG, EK = self._np_EGK[-1]
        E = G0 * EG + K0 * EK                 # (l, a, m, b)
        base = op.base_grid
        d = op.d
        nn = int(np.prod(base))
        A = np.zeros((nn * d, nn * d))
        dims = op.dims
        cells = np.stack(np.meshgrid(
            *[np.arange(n) for n in dims], indexing="ij"),
            axis=-1).reshape(-1, len(dims))   # (C, ndim)
        strides = np.array([int(np.prod(base[i + 1:]))
                            for i in range(len(base))])
        node = {l: (cells + np.array(op.loffs[l])) @ strides
                for l in range(op.nloc)}
        for l in range(op.nloc):
            for m in range(op.nloc):
                for a in range(d):
                    for b in range(d):
                        np.add.at(A, (node[l] * d + a, node[m] * d + b),
                                  E[l, a, m, b])
        pin = op.np_pin_mask.reshape(-1) > 0
        A[pin, :] = 0.0
        A[:, pin] = 0.0
        A[pin, pin] = 1.0
        return A

    # ---- transfers (vector trailing dim; physical planes only) ---------
    def _restrict(self, i, rg):
        if i == 0 and self.pad0:
            rg = rg[:self.phys0]
        for a in self.axes[i]:
            rg = GeometricMG._restrict_axis(rg, a)
        return rg

    def _prolong(self, i, xc):
        for a in self.axes[i]:
            xc = GeometricMG._prolong_axis(xc, a)
        if i == 0 and self.pad0:
            # zero correction on the ghost planes
            xc = F.pad(xc, (0, 0) * (xc.dim() - 1) + (0, self.pad0))
        return xc

    @staticmethod
    def _coarsen_cells(arr, axes):
        """Cell coefficients one level down: the mean of the 2 children
        along each halved axis."""
        for a in axes:
            even = arr[_sl(a, slice(0, None, 2))]
            odd = arr[_sl(a, slice(1, None, 2))]
            arr = 0.5 * (even + odd)
        return arr

    def _rho_bound(self, op, tbl, Gc, Kc):
        """Gershgorin bound on rho(D^{-1}A) from per-cell scalar
        coefficients (the max over q)."""
        return torch.max(self._rho_ratio(op, tbl, Gc, Kc)) * 1.01

    @staticmethod
    def _rho_ratio(op, tbl, Gc, Kc):
        """The Gershgorin row ratios (*grid, d): scattered abs-row-sums
        over the scattered diagonal, 1 at the pinned components."""
        SG, SK, DG, DK = tbl
        num_cell = Gc[..., None, None] * SG + Kc[..., None, None] * SK
        den_cell = Gc[..., None, None] * DG + Kc[..., None, None] * DK
        num = op._scatter(num_cell, op.grid + (op.d,), Gc.dtype)
        den = op._scatter(den_cell, op.grid + (op.d,), Gc.dtype)
        return torch.where(
            op.pin_mask_g, torch.ones_like(num),
            num / torch.where(den == 0, torch.ones_like(den), den))

    # ---- block-tridiagonal column smoother ---------------------------
    def _column_blocks(self, i, Gc, Kc, op=None):
        """The line matrix along the strongly coupled axis: Dg (*grid, d, d)
        nodal diagonal blocks and Ug (*grid, d, d), Ug[n] coupling node n
        to n + e_ax (zero at the last plane), from per-cell scalar
        coefficients. Pinned components: identity rows, couplings cut.
        `op`: level i's operator or a slab of it (default the level's)."""
        op = self.ops[i] if op is None else op
        EG, EK = self._EGK[i]
        ax = self._col_axis[i]
        d = op.d
        Dg = torch.zeros(op.grid + (d, d), dtype=Gc.dtype, device=Gc.device)
        Ug = torch.zeros_like(Dg)
        for l in range(op.nloc):
            sl = op._corner_slice(l)
            Dg[sl] += (Gc[..., None, None] * EG[l, :, l, :]
                       + Kc[..., None, None] * EK[l, :, l, :])
            if op.loffs[l][ax] == 0:
                m = l + (1 << ax)
                Ug[sl] += (Gc[..., None, None] * EG[l, :, m, :]
                           + Kc[..., None, None] * EK[l, :, m, :])
        free = 1.0 - op.pin_mask_g.to(Gc.dtype)              # (*grid, d)
        pin = 1.0 - free
        Dg = (Dg * free[..., :, None] * free[..., None, :]
              + torch.eye(d, dtype=Gc.dtype, device=Gc.device)
              * pin[..., :, None])
        n_ax = free.shape[ax]
        free_next = torch.cat([free.narrow(ax, 1, n_ax - 1),
                               torch.zeros_like(free.narrow(ax, 0, 1))],
                              dim=ax)
        Ug = Ug * free[..., :, None] * free_next[..., None, :]
        return Dg, Ug

    @staticmethod
    def _bmv(M, v):
        """(..., a, b) x (..., b) -> (..., a), as multiply + reduce."""
        return (M * v[..., None, :]).sum(-1)

    @staticmethod
    def _bmm(A, B):
        """(..., a, b) x (..., b, e) -> (..., a, e), as multiply + reduce."""
        return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)

    @staticmethod
    def _inv_small(M):
        """Closed-form batched inverse of 1x1 / 2x2 / 3x3 blocks (the
        adjugate over the determinant)."""
        d = M.shape[-1]
        if d == 1:
            return 1.0 / M
        if d == 2:
            a, b = M[..., 0, 0], M[..., 0, 1]
            c, e = M[..., 1, 0], M[..., 1, 1]
            det = a * e - b * c
            return torch.stack([
                torch.stack([e, -b], dim=-1),
                torch.stack([-c, a], dim=-1)], dim=-2) / det[..., None, None]
        if d == 3:
            m = M
            c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
            c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
            c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
            c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
            c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
            c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
            c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
            c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
            c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
            det = (m[..., 0, 0] * c00 + m[..., 0, 1] * c01
                   + m[..., 0, 2] * c02)
            adj = torch.stack([
                torch.stack([c00, c10, c20], dim=-1),
                torch.stack([c01, c11, c21], dim=-1),
                torch.stack([c02, c12, c22], dim=-1)], dim=-2)
            return adj / det[..., None, None]
        return torch.linalg.inv(M)

    def _column_solver(self, i, Dg, Ug):
        """Batched block-Thomas factorisation of every line along the
        level's column axis -> zsolve(r) over (*grid, d) tensors (the grid
        of Dg: the level's, or a rank's rows of it)."""
        ax = self._col_axis[i]
        d = Dg.shape[-1]
        grid = tuple(Dg.shape[:-2])
        nsp = len(grid)
        nzc = grid[ax]
        ncol = int(np.prod(grid)) // nzc
        perm = tuple(j for j in range(nsp) if j != ax) + (ax,)
        inv_perm = tuple(int(j) for j in np.argsort(perm))

        def to_cols(a, trail):
            a = a.permute(perm + tuple(nsp + t for t in range(trail)))
            return a.reshape((ncol, nzc) + tuple(a.shape[nsp:]))

        D = to_cols(Dg, 2)
        U = to_cols(Ug, 2)
        invD = [self._inv_small(D[:, 0])]
        Ls = []
        for k in range(1, nzc):
            # the lower block at row k is U_{k-1}^T (symmetric operator)
            Lk = self._bmm(U[:, k - 1].transpose(-1, -2), invD[-1])
            Dk = D[:, k] - self._bmm(Lk, U[:, k - 1])
            invD.append(self._inv_small(Dk))
            Ls.append(Lk)
        shape_perm = tuple(grid[j] for j in perm) + (d,)

        def zsolve(r):
            rg = to_cols(r, 1)                              # (ncol, nzc, d)
            y = [rg[:, 0]]
            for k in range(1, nzc):
                y.append(rg[:, k] - self._bmv(Ls[k - 1], y[-1]))
            x = [None] * nzc
            x[-1] = self._bmv(invD[-1], y[-1])
            for k in range(nzc - 2, -1, -1):
                x[k] = self._bmv(
                    invD[k], y[k] - self._bmv(U[:, k], x[k + 1]))
            xg = torch.stack(x, dim=1).reshape(shape_perm)
            return xg.permute(inv_perm + (nsp,))
        return zsolve

    @staticmethod
    def _power_rho(mv, zsolve, shape, dtype, device, iters=8, first=0,
                   norm=None):
        """Power-iteration estimate of rho(Z^{-1}A) from the fixed start
        sin(0.7 k) + 0.01 (no random generator), times 1.1. `first`: the
        flat index of the vector's first entry in the level's (a rank's
        rows start past 0); `norm` the 2-norm (a rank's: its sum of
        squares summed over the ranks)."""
        if norm is None:
            norm = lambda w: torch.linalg.norm(w.reshape(-1))  # noqa: E731
        n = int(np.prod(shape))
        k = torch.arange(first, first + n, dtype=dtype, device=device)
        v = (torch.sin(k * 0.7) + 0.01).reshape(shape)
        rho = torch.ones((), dtype=dtype, device=device)
        for _ in range(iters):
            w = zsolve(mv(v))
            nw = norm(w)
            rho = nw / norm(v)
            v = w / nw
        return rho * 1.1

    def preconditioner_g(self, G_q, K_q, fine_table=None):
        """The V-cycle apply at the coefficient fields G_q / K_q ((*dims, q)
        of the fine level): r (*grid, d) -> ~A^{-1} r. `fine_table` shares
        the caller's fine-level stencil table (one build per solve)."""
        matvecs, diags, rhos, zsolves = [], [], [], []
        Gq, Kq = G_q, K_q
        n_levels = len(self.ops)
        for i, op in enumerate(self.ops):
            if self.use_tables:
                tbl = (fine_table if i == 0 and fine_table is not None
                       else op.stencil_table_g(Gq, Kq))
                mv = (lambda op, tbl: lambda v: op.matvec_table_g(tbl, v)
                      )(op, tbl)
            else:
                mv = op.make_matvec_g(Gq, Kq)
            matvecs.append(mv)
            Gcell = torch.mean(Gq, dim=-1)
            Kcell = torch.mean(Kq, dim=-1)
            if i == n_levels - 1 and self.coarse_inv is not None:
                # dense direct coarse solve: no smoother data
                zsolves.append(None)
                diags.append(None)
                rhos.append(None)
            elif self._smoothers[i] == "column":
                Dg, Ug = self._column_blocks(i, Gcell, Kcell)
                zs = self._column_solver(i, Dg, Ug)
                zsolves.append(zs)
                diags.append(None)
                rhos.append(self._power_rho(
                    mv, zs, op.grid + (op.d,), Gq.dtype, Gq.device))
            else:
                zsolves.append(None)
                diags.append(op.jacobian_diag_g(Gq, Kq))
                rhos.append(self._rho_bound(op, self._tables[i],
                                            torch.amax(Gq, dim=-1),
                                            torch.amax(Kq, dim=-1)))
            if self.axes[i] is not None:
                Gc = self._coarsen_cells(Gcell, self.axes[i])
                Kc = self._coarsen_cells(Kcell, self.axes[i])
                q = self.ops[i + 1].qw1.shape[0]
                Gq = Gc[..., None].expand(Gc.shape + (q,))
                Kq = Kc[..., None].expand(Kc.shape + (q,))

        down = [lambda r, i=i: self._restrict(i, r)
                for i in range(n_levels - 1)]
        up = [lambda xc, i=i: self._prolong(i, xc)
              for i in range(n_levels - 1)]
        return self._cycle(matvecs, zsolves, diags, rhos, down, up)

    def _cycle(self, matvecs, zsolves, diags, rhos, down, up):
        """The V-cycle apply over per-level actions, smoother data and
        transfers `down[i]` (level i -> i + 1) / `up[i]` (level i + 1 -> its
        correction on level i), in whatever layout each level's vectors
        take (whole grids, or a rank's rows)."""
        def smooth(i, x, b, nu):
            # Chebyshev acceleration of the level smoother Z^{-1} (line
            # solve or point diagonal) over [rho/4, rho]. x None is the
            # zero start, whose first residual b - A 0 is b exactly
            if zsolves[i] is not None:
                zsolve = zsolves[i]
            else:
                zsolve = (lambda di: lambda r: r / di)(diags[i])
            lmax = rhos[i]
            lmin = lmax / 4.0
            theta = 0.5 * (lmax + lmin)
            delta = 0.5 * (lmax - lmin)
            sigma = theta / delta
            rho_k = 1.0 / sigma
            r = b if x is None else b - matvecs[i](x)
            p = zsolve(r) / theta
            x = p if x is None else x + p
            for _ in range(max(nu - 1, 0)):
                r = b - matvecs[i](x)
                z = zsolve(r)
                rho_next = 1.0 / (2.0 * sigma - rho_k)
                p = rho_next * rho_k * p + (2.0 * rho_next / delta) * z
                x = x + p
                rho_k = rho_next
            return x

        def coarse_solve(i, b):
            if self.coarse_inv is None:
                return smooth(i, None, b, self.coarse_iters)
            return (self.coarse_inv @ b.reshape(-1)).reshape(b.shape)

        def cycle(b):
            # a loop down the levels and back up: a recursive closure would
            # hold itself, so each build's level tables would wait for the
            # cyclic collector
            bs, xs = [], []
            i = 0
            while self.axes[i] is not None:
                x = smooth(i, None, b, self.nu_pre)
                r = b - matvecs[i](x)
                bs.append(b)
                xs.append(x)
                b = down[i](r)
                i += 1
            xc = coarse_solve(i, b)
            for i in reversed(range(len(xs))):
                x = xs[i] + up[i](xc)
                xc = smooth(i, x, bs[i], self.nu_post)
            return xc

        return cycle


class RankGridElastMG(_RankLevels):
    """GridElastMG's V-cycle on one rank of a grid split along axis 0, from
    `rows0`, the fine level's planes [lo, hi) of every rank in rank order
    (the layout of RankGridMG). A level where every rank holds two planes
    or more runs on the ranks' slabs (ops/grid_elasticity.py
    GridElasticitySlab): its table, diagonal and line factors are the
    whole level's rows, its Gershgorin bound a max over the ranks, and its
    power iteration the whole level's start vector with each norm's sum of
    squares summed over the ranks. A level whose line smoother runs along
    axis 0, the levels below it and the dense solve run replicated, as in
    RankGridMG. The cell coefficients of the coarser levels are averaged
    down the whole hierarchy on every rank from the fine level's cell
    means, gathered once a build (one value a cell and modulus). Every
    level's action is its block table (the cycle's `use_tables`; the cell
    recompute has no rank form). Every rank must build and apply it
    together."""

    def __init__(self, mg: GridElastMG, device_mesh, rows0):
        if not mg.use_tables:
            raise ValueError("the rank form needs the block tables "
                             "(use_tables=True)")
        super().__init__(mg, device_mesh, rows0)
        self.slabs = [op.slab(*self.rows[i][self.rank]) if self.sharded[i]
                      else None for i, op in enumerate(mg.ops)]

    def _shardable(self, i) -> bool:
        # a line solve along axis 0 would run across the ranks
        return self.mg._col_axis[i] != 0

    def _cells(self, i):
        """Level i's cells along axis 0 on this rank: (window, owned), as
        ops/grid_elasticity.py slab_cells."""
        from fem_glass_tempering_tpu_torch.ops.grid_elasticity import (
            slab_cells,
        )
        lo, hi = self.rows[i][self.rank]
        return slab_cells(lo, hi, self.mg.ops[i].dims[0])

    def _gather_cells(self, i, x_window):
        """A cell field over this rank's window cells of level i -> the
        whole level's, on every rank (each cell from its one owner)."""
        (c0, _), (a, b) = self._cells(i)
        return self._collectives.gather_rows(
            x_window[a - c0:b - c0], slice(a, b), self.mg.ops[i].dims[0],
            self.comm)

    def _dot(self, u, v):
        return self._collectives.all_reduce_sum(
            torch.dot(u.reshape(-1), v.reshape(-1)), self.comm)

    def preconditioner(self, G_q, K_q, fine_table=None):
        """The apply r -> ~A^{-1} r on this rank's fine rows ((L, *grid[1:],
        d) values, any shape) at the coefficient fields G_q / K_q over the
        fine slab's window cells ((c1 - c0, *dims[1:], q), from the halo).
        `fine_table` shares the fine slab's table of the owned rows."""
        mg, comm = self.mg, self._collectives
        n_levels = len(mg.ops)
        # the whole fine level's cell coefficients: the means for the
        # hierarchy below, the quadrature values where it is replicated
        if self.sharded[0]:
            Gcw, Kcw = torch.mean(G_q, dim=-1), torch.mean(K_q, dim=-1)
            Gq = Kq = None
            if n_levels > 1:
                Gcell, Kcell = (self._gather_cells(0, Gcw),
                                self._gather_cells(0, Kcw))
        else:
            Gq, Kq = self._gather_cells(0, G_q), self._gather_cells(0, K_q)
            Gcell, Kcell = torch.mean(Gq, dim=-1), torch.mean(Kq, dim=-1)
        matvecs, diags, rhos, zsolves = [], [], [], []
        for i, op in enumerate(mg.ops):
            slab = self.slabs[i]
            dense = i == n_levels - 1 and mg.coarse_inv is not None
            if slab is None:
                # replicated: the unsharded cycle's level
                tbl = op.stencil_table_g(Gq, Kq)
                mv = (lambda op, tbl: lambda v: op.matvec_table_g(
                    tbl, v))(op, tbl)
                zs = dg = rho = None
                if dense:
                    pass
                elif mg._smoothers[i] == "column":
                    Dg, Ug = mg._column_blocks(i, Gcell, Kcell)
                    zs = mg._column_solver(i, Dg, Ug)
                    rho = mg._power_rho(mv, zs, op.grid + (op.d,),
                                        Gcell.dtype, Gcell.device)
                else:
                    dg = op.jacobian_diag_g(Gq, Kq)
                    rho = mg._rho_bound(op, mg._tables[i],
                                        torch.amax(Gq, dim=-1),
                                        torch.amax(Kq, dim=-1))
            else:
                (c0, c1), _ = self._cells(i)
                if i == 0:
                    Gw, Kw, Gcs, Kcs = G_q, K_q, Gcw, Kcw
                else:
                    Gw, Kw = Gq[c0:c1], Kq[c0:c1]
                    Gcs, Kcs = Gcell[c0:c1], Kcell[c0:c1]
                tbl = (fine_table if i == 0 and fine_table is not None
                       else slab.stencil_table_r(Gw, Kw))
                mv = (lambda slab, tbl: lambda v: slab.matvec_table_r(
                    tbl, self._halo(v)))(slab, tbl)
                zs = dg = rho = None
                if dense:
                    pass
                elif mg._smoothers[i] == "column":
                    Dg, Ug = mg._column_blocks(i, Gcs, Kcs, op=slab)
                    zs = mg._column_solver(i, Dg[1:-1], Ug[1:-1])
                    shape = slab.slab_grid + (op.d,)
                    lo = self.rows[i][self.rank][0]
                    rho = mg._power_rho(
                        mv, zs, shape, Gcs.dtype, Gcs.device,
                        first=lo * int(np.prod(shape[1:])),
                        norm=lambda w: torch.sqrt(self._dot(w, w)))
                else:
                    dg = slab.jacobian_diag_r(Gw, Kw)
                    ratio = mg._rho_ratio(slab, mg._tables[i],
                                          torch.amax(Gw, dim=-1),
                                          torch.amax(Kw, dim=-1))
                    rho = comm.all_reduce_max(
                        torch.max(ratio[1:-1]), self.comm) * 1.01
            matvecs.append(mv)
            zsolves.append(zs)
            diags.append(dg)
            rhos.append(rho)
            if mg.axes[i] is not None:
                Gc = mg._coarsen_cells(Gcell, mg.axes[i])
                Kc = mg._coarsen_cells(Kcell, mg.axes[i])
                q = mg.ops[i + 1].qw1.shape[0]
                Gq = Gc[..., None].expand(Gc.shape + (q,))
                Kq = Kc[..., None].expand(Kc.shape + (q,))
                Gcell, Kcell = torch.mean(Gq, dim=-1), torch.mean(Kq, dim=-1)
        cycle = mg._cycle(matvecs, zsolves, diags, rhos, *self._transfers())
        lo, hi = self.rows[0][self.rank]
        return self._on_rows(cycle, (hi - lo,) + mg.ops[0].grid[1:]
                             + (mg.ops[0].d,))
