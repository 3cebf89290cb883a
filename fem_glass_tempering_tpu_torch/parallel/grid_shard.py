"""The grid-sharded coupled step: every field split along node-grid axis 0.

Counterpart of fem_glass_tempering_tpu/parallel/grid_shard.py
(GridShardedProblem), the JAX package's flagship distributed path, whose
collectives are the ones XLA's SPMD partitioner inserts around arrays
sharded with a NamedSharding. Here each rank is one process of a
torch.distributed group (parallel/comm.py) and writes them out:

- layout (JAX's): the node grid's axis 0 is padded with `pad = (-gx) % P`
  ghost planes to a multiple of the ranks, and rank p holds planes
  [p L, (p + 1) L), L = (gx + pad) / P, of every state field, flat
  ((L M,) for a T-space field, M = prod(grid[1:]); the sigma space is the
  same CG-1 space). Ghost planes are identity rows of the heat solve,
  edge-padded copies in the state; a rank may hold only ghost planes and
  still joins every collective;
- the heat operator is the padded GridHeatOperator's slab of the rank's
  planes (ops/grid.py GridSlab): its residual, diagonal and table bake
  take one halo plane of each neighbour, and its Jacobian action is K2's
  halo form over the rank's tables;
- the halo is `comm.halo_exchange` (the summed all-gather of every
  rank's first and last plane; none at P = 1), each dot of Newton and CG
  the rank's partial sum through `comm.all_reduce_sum`, ghost rows
  included as in JAX's global `vdot` over the padded array;
- the preconditioner is GridMG's V-cycle in its rank form
  (solver/grid_mg.py RankGridMG);
- the material step is pointwise on the rank's rows (the CG-1 / CG-1
  cross evaluation is the identity), K1 in its T-space chain;
- equilibrium mechanics (`mechanics="equilibrium"`) is JAX's grid
  coupling over the padded grid in its rank form (models/mechanics.py
  RankMechanicsCoupling): the elasticity CG on the rank's slab of the
  vector operator, its dots summed over the ranks, preconditioned by
  GridElastMG's rank form; `du` rides in the state on the rank's rows.

- output (`solve`) and checkpoints are per rank (io/sharded.py, JAX's
  files): each rank writes its planes' pieces, and a checkpoint loads
  onto any rank count that pads the grid to as many planes.

DG-1 T (`_init_dg`, the reference's default element) keeps JAX's
cell-grid layout: the T-space fields (T, T_prev, Tf, Tf_prev,
Tf_partial, phi, xi) live on the cell grid (cx, cy, cz, nloc), axis 0
padded with `cell_pad0 = (-cx) % P` edge-replicated ghost cell layers,
rank p holding layers [p Lc, (p + 1) Lc); the sigma-space fields stay on
the node grid as above. The heat operator is GridDGOperator's slab of the
rank's layers (solver/grid_dg.py), the preconditioner DGMultigrid's grid
route in its rank form (RankDGMultigrid, its CG-1 correction RankGridMG
on the rank's node rows). JAX's solve never sees a ghost cell (it slices
the state to the physical cells first), so here the ghost rows are zero
rows of the residual and of every Jacobian action and preconditioner
apply, and every dot, norm, mean and finiteness test reads the real
cells alone; at step exit the ghost layers are edge-padded from cell
layer cx - 1, which may lie on another rank (one summed all-gather). The
sigma cross evaluation (dg_to_nodes_g) maps the rank's cells to its
node rows through one re-partition (CellNodeTransfers).

CG-2 T (`_init_q2`) keeps JAX's lattice layout: the T-space fields live
on the Q2 dof lattice (2 n0 + 1, 2 n1 + 1, 2 n2 + 1), axis 0 padded with
`lat_pad0 = (-(2 n0 + 1)) % P` edge-replicated ghost planes, rank p
holding lattice planes [p Ll, (p + 1) Ll); the sigma-space fields stay on
the node grid as above. The heat operator is GridHeatOperator2's slab of
the rank's planes (ops/grid2.py GridQ2Slab: the kron chain on a window of
two halo planes a side, one re-partition a Jacobian action), the
preconditioner Q2MG's grid route in its rank form (RankQ2MG, its CG-1
V-cycle RankGridMG on the rank's node rows). As under DG-1, ghost planes
are zero rows of the residual, Jacobian action and preconditioner apply,
every dot, norm and finiteness test reads the real planes alone, and
the ghost planes are edge-padded at step exit; the sigma cross
evaluation is the even-stride injection through one re-partition
(LatticeNodeTransfers). Equilibrium mechanics under CG-2 raises JAX's
ValueError.
"""

from __future__ import annotations

import dataclasses
import time as _time

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.config import RunConfig
from fem_glass_tempering_tpu_torch.device import resolve_dtype
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.fem.mesh import Mesh
from fem_glass_tempering_tpu_torch.io.sharded import (
    PlaneLayout,
    ShardedSeriesWriter,
    load_sharded_checkpoint,
    save_sharded_checkpoint,
)
from fem_glass_tempering_tpu_torch.models.mechanics import (
    GridMechanicsCoupling,
)
from fem_glass_tempering_tpu_torch.models.viscoelastic import (
    TABLEAU_SIZE,
    ViscoelasticEngine,
    ViscoState,
)
from fem_glass_tempering_tpu_torch.ops.grid import GridHeatOperator
from fem_glass_tempering_tpu_torch.ops.grid2 import (
    Q2MG,
    GridHeatOperator2,
    LatticeHalo,
    LatticeNodeTransfers,
    RankQ2MG,
)
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.parallel.comm import (
    DeviceMesh,
    all_gather,
    all_reduce_sum,
    halo_exchange,
    make_device_mesh,
)
from fem_glass_tempering_tpu_torch.solver.grid_dg import (
    CellNodeTransfers,
    GridDGOperator,
    RankDGMultigrid,
    dg_vertex_offsets,
)
from fem_glass_tempering_tpu_torch.solver.grid_mg import GridMG, RankGridMG
from fem_glass_tempering_tpu_torch.solver.multigrid import DGMultigrid
from fem_glass_tempering_tpu_torch.solver.newton import newton_solve



class GridShardedProblem:
    """Coupled thermo-viscoelastic tempering, this rank's share of a grid
    split along axis 0 over `device_mesh` (default: a group of one rank on
    the GPU). Needs a uniform box mesh, CG-1, CG-2 or DG-1 T and CG-1
    sigma.
    `flux_marker(midpoints) -> bool mask` restricts the radiation +
    convection flux to whole box faces, as `ThermoViscoProblem.setup`'s
    does (the V-cycle's coarse levels keep the whole boundary's, as
    there; CG-1 T only); JAX's class has no such option: it is here so
    that a sharded run can be held to an unsharded one with that flux
    (chip_smoke.py 13d(c), phase 8b's plate). Every rank must call `step` /
    `run` / `solve` / `save_checkpoint` / `gather_state` together. With
    mechanics, `last_mech_iters` holds the elasticity CG count of each
    step of the last `step` / `run` / `solve`, `last_mech_converged`
    whether each met its tolerance (a step's `converged` is its heat
    solve's, as in JAX), and `last_mech_collectives` the collectives of
    each step's elasticity solve. With DG-1 T, `cell_halos` counts the
    halo exchanges of cell layers this rank has made; with CG-2 T,
    ops/grid2.py `LatticeHalo.count` counts the windows of lattice
    planes."""

    _TSPACE_FIELDS = frozenset(
        {"T", "T_prev", "Tf", "Tf_prev", "Tf_partial", "phi", "xi"})
    is_dg = is_q2 = False

    def __init__(self, mesh: Mesh, config: RunConfig,
                 device_mesh: DeviceMesh | None = None, *,
                 flux_marker=None):
        fe = config.fe
        if fe.T_family == "DG" and fe.T_degree != 1:
            raise ValueError("GridShardedProblem supports DG degree 1")
        if fe.T_family == "CG" and fe.T_degree not in (1, 2):
            raise ValueError("GridShardedProblem supports CG degree 1-2")
        if fe.T_family not in ("CG", "DG"):
            raise ValueError("GridShardedProblem needs a CG or DG T space")
        if fe.sigma_family != "CG" or fe.sigma_degree != 1:
            raise ValueError("GridShardedProblem needs a CG-1 sigma space")
        if mesh.structured is None:
            raise ValueError("GridShardedProblem needs a structured box mesh")
        self.is_dg = fe.T_family == "DG"
        self.is_q2 = fe.T_family == "CG" and fe.T_degree == 2
        if (self.is_dg or self.is_q2) and flux_marker is not None:
            raise ValueError("GridShardedProblem: DG-1 and CG-2 T take the "
                             "flux of the whole boundary (no flux_marker)")
        if config.solver.preconditioner == "auto":
            # structured degree 1: 'auto' is the grid-native (p-)multigrid
            config = dataclasses.replace(config, solver=dataclasses.replace(
                config.solver, preconditioner="mg"))
        self.config = config
        self.mesh = mesh
        self.comm = (device_mesh if device_mesh is not None
                     else make_device_mesh())
        self.device = self.comm.device
        self.n_devices = self.comm.size
        self.dtype = resolve_dtype(config.dtype)
        # f32 products (the dense coarse inverse) at full f32 precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.setup_seconds: dict = {}
        t0 = _time.perf_counter()

        self.fs_T = FunctionSpace(mesh, fe.T_family, fe.T_degree)
        self.fs_sigma = FunctionSpace(mesh, "CG", 1,
                                      value_shape=(mesh.tdim, mesh.tdim))
        self.params = config.params
        self.dt = config.time.dt
        self.n_steps = config.time.n_steps
        self.engine = ViscoelasticEngine(
            self.fs_T, self.fs_sigma, self.params, self.dt,
            physics_mode=config.physics_mode,
            shift_function=config.shift_function,
            xi_formula=config.xi_formula, dtype=self.dtype,
            device=self.device)
        self._mixed = (config.solver.cg_dtype == "float32"
                       and self.dtype == torch.float64)
        self.last_mech_iters: list[int] = []
        self.last_mech_converged: list[bool] = []
        self.last_mech_collectives: list[int] = []
        if self.is_dg or self.is_q2:
            (self._init_dg if self.is_dg else self._init_q2)(mesh, config, t0)
            self._build_step()
            return
        assert self.engine.to_sigma.same_space("T"), \
            "CG-1/CG-1 must share the scalar dofmap"

        def heat_operator(dtype, fs=self.fs_T, marker=None):
            return self._heat_operator(dtype, fs, flux_marker=marker)

        # the padded grid: ghost planes up to a multiple of the ranks
        gx = mesh.structured["dims"][0] + 1
        P = self.n_devices
        self.pad0 = (-gx) % P
        self.heat = heat_operator(self.dtype, marker=flux_marker)
        self.grid_op = GridHeatOperator(self.heat, flux_marker=flux_marker,
                                        pad_axis0=self.pad0, tables=False)
        self.grid = self.grid_op.grid
        self._ngrid_base = self.grid_op.st.grid
        L = self.grid[0] // P
        self.rows = [(r * L, (r + 1) * L) for r in range(P)]
        self.slab = self.grid_op.slab(*self.rows[self.comm.rank])
        self.slab_shape = self.slab.slab_grid
        # mixed precision (f64 Newton / f32 Krylov): the f32 twins
        self.grid_op32 = self.slab32 = None
        if self._mixed:
            self.grid_op32 = GridHeatOperator(
                heat_operator(torch.float32, marker=flux_marker),
                flux_marker=flux_marker, pad_axis0=self.pad0, tables=False)
            self.slab32 = self.grid_op32.slab(*self.rows[self.comm.rank])
        self.setup_seconds["operator"] = _time.perf_counter() - t0
        t1 = _time.perf_counter()
        self.grid_mg = self.rank_mg = None
        sc = config.solver
        if sc.preconditioner == "mg":
            mg_dtype = torch.float32 if self._mixed else self.dtype
            self.grid_mg = GridMG(
                self.grid_op32 if self._mixed else self.grid_op,
                lambda level_mesh: heat_operator(
                    mg_dtype, FunctionSpace(level_mesh, "CG", 1)),
                **self._mg_kwargs())
            self.grid_mg.freeze_rhos(self.dt)
            self.rank_mg = RankGridMG(self.grid_mg, self.comm, self.rows)
        self.setup_seconds["mg"] = _time.perf_counter() - t1
        self._init_mech()
        self._build_step()

    def _heat_operator(self, dtype, fs, **kw):
        return HeatOperator(fs, self.params, self.dt, dtype=dtype,
                            device=self.device, form=self.config.heat_form,
                            **kw)

    def _mg_kwargs(self) -> dict:
        sc = self.config.solver
        # 'dense' maps to 'auto': GridMG's dense coarse level is always
        # the auto stopping rule
        return dict(smoother=sc.mg_smoother, nu_pre=sc.mg_nu_pre,
                    nu_post=sc.mg_nu_post,
                    coarse="smooth" if sc.mg_coarse == "smooth" else "auto")

    def _init_mech(self) -> None:
        """Equilibrium mechanics on the padded node grid's rank rows, at
        JAX's tolerances (models/problem.py's): the elasticity CG to
        min(cg_rtol, 1e-8), at least 2e-6 in f32, where its residual norms
        bottom out; mech_inc_rtol None -> 1e-2."""
        self.mech = None
        sc = self.config.solver
        if self.config.mechanics != "equilibrium":
            return
        t2 = _time.perf_counter()
        mech_rtol = min(sc.cg_rtol, 1e-8)
        if self.dtype == torch.float32:
            mech_rtol = max(mech_rtol, 2e-6)
        mech_inc = 1e-2 if sc.mech_inc_rtol is None else sc.mech_inc_rtol
        self.mech = GridMechanicsCoupling(
            self.fs_sigma, self.engine, dtype=self.dtype,
            cg_rtol=mech_rtol, inc_rtol=mech_inc, pad_axis0=self.pad0,
            grid_shaped=True).rank_form(self.comm, self.rows)
        self.setup_seconds["mechanics"] = _time.perf_counter() - t2

    def _init_dg(self, mesh: Mesh, config: RunConfig, t0: float) -> None:
        """DG-1 temperature (JAX's `_init_dg`): the cell-grid layout
        (module docstring), GridDGOperator's slab, DGMultigrid's grid
        route in its rank form; the sigma fields and the mechanics on the
        padded node grid as in the CG-1 route."""
        sc = config.solver
        P, rank = self.n_devices, self.comm.rank
        dims = tuple(mesh.structured["dims"])
        self.cell_dims = dims
        self.cell_pad0 = (-dims[0]) % P
        self._vert_offs, self._ngrid_base = dg_vertex_offsets(mesh)
        self.nloc = self.fs_T.element.nloc
        gx = self._ngrid_base[0]
        self.pad0 = (-gx) % P
        self.grid = (gx + self.pad0,) + self._ngrid_base[1:]
        L = self.grid[0] // P
        self.rows = [(r * L, (r + 1) * L) for r in range(P)]
        self.slab_shape = (L,) + self.grid[1:]
        Lc = (dims[0] + self.cell_pad0) // P
        self.cell_rows = [(r * Lc, (r + 1) * Lc) for r in range(P)]
        self.cell_shape = (Lc,) + dims[1:] + (self.nloc,)
        self._t_layout(dims[0], self.cell_pad0, self.cell_rows,
                       self.cell_shape)
        self.cell_halos = 0

        def heat_operator(dtype):
            return self._heat_operator(dtype, self.fs_T,
                                       interior_device_tables=False)

        self.heat = heat_operator(self.dtype)
        self.dg_op = GridDGOperator(self.heat)
        self.slab = self.dg_op.slab(*self.cell_rows[rank])
        self.dg_op32 = self.slab32 = heat32 = None
        if self._mixed:
            heat32 = heat_operator(torch.float32)
            self.dg_op32 = GridDGOperator(heat32)
            self.slab32 = self.dg_op32.slab(*self.cell_rows[rank])
        self.grid_op = self.grid_op32 = None
        # the sigma space's cross evaluation: the rank's cells -> its rows
        # of the node grid
        self.to_nodes = CellNodeTransfers(
            self._vert_offs, dims, self.cell_rows, self.rows, self.comm)
        self.setup_seconds["operator"] = _time.perf_counter() - t0
        t1 = _time.perf_counter()
        self.dg_mg = self.rank_dg_mg = None
        self.grid_mg = self.rank_mg = None
        if sc.preconditioner == "mg":
            mg_dtype = torch.float32 if self._mixed else self.dtype
            self.dg_mg = DGMultigrid(
                heat32 if self._mixed else self.heat,
                lambda level_mesh: self._heat_operator(
                    mg_dtype, FunctionSpace(level_mesh, "CG", 1)),
                dtype=mg_dtype, smoother=sc.dg_smoother, coarse_kind="grid",
                grid_pad0=self.pad0, mg_kwargs=self._mg_kwargs())
            self.dg_mg.freeze(float(self.params.T_0), self.dt)
            self.rank_dg_mg = RankDGMultigrid(self.dg_mg, self.comm,
                                              self.cell_rows, self.rows)
            # the CG-1 correction's V-cycle and its rank form
            self.grid_mg = self.dg_mg.cg_mg
            self.rank_mg = self.rank_dg_mg.rank_mg
        self.setup_seconds["mg"] = _time.perf_counter() - t1
        self._init_mech()

    def _init_q2(self, mesh: Mesh, config: RunConfig, t0: float) -> None:
        """CG-2 temperature (JAX's `_init_q2`): the lattice layout (module
        docstring), GridHeatOperator2's slab, Q2MG's grid route with JAX's
        keywords (nu_pre, nu_post, the coarse smoother alone, the node
        grid's ghost planes) in its rank form; the sigma fields on the
        padded node grid as in the CG-1 route."""
        if config.mechanics == "equilibrium":
            raise ValueError("equilibrium mechanics under sharded CG-2 "
                             "is not wired yet — use the CG-1 path")
        sc = config.solver
        P, rank = self.n_devices, self.comm.rank
        dims = tuple(mesh.structured["dims"])
        self.lat_base = tuple(2 * n + 1 for n in dims)
        self.lat_pad0 = (-self.lat_base[0]) % P
        self._ngrid_base = tuple(n + 1 for n in dims)
        self.pad0 = (-self._ngrid_base[0]) % P
        self.grid = (self._ngrid_base[0] + self.pad0,) + self._ngrid_base[1:]
        L = self.grid[0] // P
        self.rows = [(r * L, (r + 1) * L) for r in range(P)]
        self.slab_shape = (L,) + self.grid[1:]
        Ll = (self.lat_base[0] + self.lat_pad0) // P
        self.lat_rows = [(r * Ll, (r + 1) * Ll) for r in range(P)]
        self._t_layout(self.lat_base[0], self.lat_pad0, self.lat_rows,
                       (Ll,) + self.lat_base[1:])
        self.heat = self._heat_operator(self.dtype, self.fs_T)
        self.q2_op = GridHeatOperator2(self.heat)
        self.slab = self.q2_op.slab(*self.lat_rows[rank])
        self.q2_op32 = self.slab32 = None
        if self._mixed:
            self.q2_op32 = GridHeatOperator2(
                self._heat_operator(torch.float32, self.fs_T))
            self.slab32 = self.q2_op32.slab(*self.lat_rows[rank])
        self.grid_op = self.grid_op32 = None
        self.lattice_halo = LatticeHalo(self.lat_rows, self.lat_base[0],
                                        self.comm)
        # the sigma space's cross evaluation: the rank's lattice rows ->
        # its rows of the node grid
        self.to_nodes = LatticeNodeTransfers(dims, self.lat_rows, self.rows,
                                             self.comm)
        self.setup_seconds["operator"] = _time.perf_counter() - t0
        t1 = _time.perf_counter()
        self.q2_mg = self.rank_q2_mg = None
        self.grid_mg = self.rank_mg = None
        if sc.preconditioner == "mg":
            mg_dtype = torch.float32 if self._mixed else self.dtype
            self.q2_mg = Q2MG(
                self.q2_op32 if self._mixed else self.q2_op,
                lambda level_mesh: self._heat_operator(
                    mg_dtype, FunctionSpace(level_mesh, "CG", 1)),
                nu_pre=sc.mg_nu_pre, nu_post=sc.mg_nu_post,
                mg_kwargs={"smoother": sc.mg_smoother},
                coarse_pad0=self.pad0, coarse_kind="grid")
            self.q2_mg.freeze_rhos(self.dt)
            self.rank_q2_mg = RankQ2MG(self.q2_mg, self.comm, self.lat_rows,
                                       self.rows)
            # the CG-1 coarse chain's V-cycle and its rank form
            self.grid_mg = self.q2_mg.gmg
            self.rank_mg = self.rank_q2_mg.rank_mg
        self.setup_seconds["mg"] = _time.perf_counter() - t1
        self.mech = None

    def _t_layout(self, n0: int, pad: int, rows, shape) -> None:
        """The T-space grid of DG-1 / CG-2 T: `n0` physical planes along
        axis 0 and `pad` ghost planes, every rank's rows `rows`, this
        rank's rows of shape `shape`, of them `n_real_t` physical."""
        self.t_n0, self.t_pad0, self.t_rows, self.t_shape = (
            n0, pad, rows, tuple(shape))
        lo = rows[self.comm.rank][0]
        self.n_real_t = max(0, min(lo + shape[0], n0) - lo)

    # ---- layout ----------------------------------------------------------
    def _halo(self, x):
        return halo_exchange(x, self.comm)

    def _cell_halo(self, x):
        n0 = halo_exchange.count
        out = halo_exchange(x, self.comm)
        self.cell_halos += halo_exchange.count - n0
        return out

    def _real_t(self, x):
        """The rows of a T-space vector (DG-1 / CG-2 T) on this rank's
        physical planes, flattened."""
        return x.reshape(self.t_shape[0], -1)[:self.n_real_t].reshape(-1)

    def _dot(self, a, b):
        """The global dot: this rank's partial sum, summed over the ranks
        (of a T-space vector under DG-1 or CG-2, over its real planes)."""
        if self._tgrid and self.n_real_t < self.t_shape[0]:
            a, b = self._real_t(a), self._real_t(b)
        return all_reduce_sum(torch.dot(a.reshape(-1), b.reshape(-1)),
                              self.comm)

    @property
    def _tgrid(self) -> bool:
        """Whether the T space has its own grid (DG-1 cells, the CG-2
        lattice)."""
        return self.is_dg or self.is_q2

    def _is_cellgrid(self, name: str) -> bool:
        return self._tgrid and name in self._TSPACE_FIELDS

    def _field_rows(self, name: str) -> tuple:
        """(physical planes, ghost planes, this rank's [lo, hi)) of the
        grid that field `name` lives on."""
        if self._is_cellgrid(name):
            return self.t_n0, self.t_pad0, self.t_rows[self.comm.rank]
        return self._ngrid_base[0], self.pad0, self.rows[self.comm.rank]

    def shard_state(self, state: ViscoState) -> ViscoState:
        """A flat global state (any device) -> this rank's rows of the
        padded grids, the ghost planes edge-padded (JAX's `_to_grid`, then
        shard p)."""

        def f(name, a):
            if name == "t" or a is None:
                return a
            a = a.to(device=self.device, dtype=self.dtype)
            n0, pad, (lo, hi) = self._field_rows(name)
            g = a.reshape((n0, -1) + tuple(a.shape[1:]))
            if pad:
                g = torch.cat([g, g[-1:].expand(
                    (pad,) + tuple(g.shape[1:]))])
            return g[lo:hi].reshape((-1,) + tuple(a.shape[1:])).contiguous()
        return ViscoState(**{k: f(k, getattr(state, k))
                             for k in ViscoState._fields})

    def init_state(self) -> ViscoState:
        """This rank's initial state: T = Tf = Tf_partial = T_0, zero
        stresses (the engine's, on the rank's rows; ghost rows alike)."""
        p = self.params
        n, d = int(np.prod(self.slab_shape)), self.mesh.tdim
        nT = int(np.prod(self.t_shape)) if self._tgrid else n
        f = lambda shape, v=0.0: torch.full(  # noqa: E731
            shape, v, dtype=self.dtype, device=self.device)
        tens = lambda: f((n, d, d))  # noqa: E731
        tab = lambda: f((n, TABLEAU_SIZE, d, d))  # noqa: E731
        return ViscoState(
            t=f(()), T=f((nT,), p.T_0), T_prev=f((nT,), p.T_0),
            Tf=f((nT,), p.T_0), Tf_prev=f((nT,), p.T_0),
            Tf_partial=f((nT, TABLEAU_SIZE), p.T_0), phi=f((nT,)),
            xi=f((nT,)), thermal_strain=tens(), total_strain=tens(),
            deviatoric_strain=tens(), s_tilde=tab(), sigma_tilde=tab(),
            s_partial=tab(), sigma_partial=tab(), sigma=tens(),
            du=f((n, d)))

    def gather_state(self, state: ViscoState) -> ViscoState:
        """The flat global state on the host (CPU tensors, the ghost planes
        dropped: JAX's `gather_state`), on every rank."""

        def f(name, a):
            if name == "t" or a is None:
                return a if a is None else a.cpu()
            n0, _, (lo, hi) = self._field_rows(name)
            n = n0 * (a.shape[0] // (hi - lo))
            return all_gather(a.contiguous(), self.comm)[:n].cpu()
        return ViscoState(**{k: f(k, getattr(state, k))
                             for k in ViscoState._fields})

    def _edge_fill(self, state: ViscoState) -> ViscoState:
        """The ghost planes of the T-space fields (DG-1 cell layers, CG-2
        lattice planes), edge-padded from physical plane cx - 1 (JAX's
        `pad_cs`): one summed all-gather of that plane where a rank other
        than its holder holds ghost planes."""
        if not self.t_pad0:
            return state
        cx, rank = self.t_n0, self.comm.rank
        Lc = self.t_shape[0]
        src = (cx - 1) // Lc
        ghost_ranks = [q for q, (a, b) in enumerate(self.t_rows)
                       if b > cx]
        names = [k for k in sorted(self._TSPACE_FIELDS)
                 if getattr(state, k) is not None]
        rows = {k: getattr(state, k).reshape((Lc, -1) + tuple(
            getattr(state, k).shape[1:])) for k in names}
        if any(q != src for q in ghost_ranks):
            if rank == src:
                layer = torch.cat([rows[k][cx - 1 - src * Lc].reshape(-1)
                                   for k in names])
            else:
                layer = torch.full((sum(rows[k][0].numel() for k in names),),
                                   -0.0, dtype=self.dtype,
                                   device=self.device)
            layer = all_reduce_sum(layer, self.comm)
        elif rank == src:
            layer = torch.cat([rows[k][cx - 1 - src * Lc].reshape(-1)
                               for k in names])
        if rank not in ghost_ranks:
            return state
        g0 = max(cx - rank * Lc, 0)
        out, off = {}, 0
        for k in names:
            r = rows[k]
            n = r[0].numel()
            edge = layer[off:off + n].reshape((1,) + tuple(r.shape[1:]))
            off += n
            out[k] = torch.cat([r[:g0], edge.expand(
                (Lc - g0,) + tuple(r.shape[1:]))]).reshape(
                    getattr(state, k).shape)
        return state._replace(**out)

    # ---- the step ----------------------------------------------------------
    def _build_step(self) -> None:
        sc = self.config.solver
        engine = self.engine
        mixed = self._mixed
        f32 = torch.float32
        op_main = self.slab
        op_fast = self.slab32 if mixed else self.slab
        mech_fn = self.mech
        # f32 residual norms cannot certify tighter than ~1e-6
        cg_rtol = max(sc.cg_rtol, 1e-6) if mixed else sc.cg_rtol
        # the residual noise floor is JAX's for a TPU's emulated f64: auto
        # is off here
        noise_rel = sc.newton_noise_rel or 0.0
        inc_forcing = (0.05 if sc.newton_inc_forcing is None
                       else sc.newton_inc_forcing)
        cast = (lambda T: T.to(f32)) if mixed else (lambda T: T)
        if self.is_dg:
            # the slab's views: its state argument is the rank's cells
            # (the residual reads a halo of T), the halo of its vectors
            # one of cell layers
            shape, halo = self.cell_shape, self._cell_halo
            rdmg = self.rank_dg_mg
            lin = lambda T: T.reshape(shape)  # noqa: E731

            def total(s):
                return all_reduce_sum(s, self.comm)

            def residual_fn(state, dt):
                Tp = state.T.reshape(shape)
                return lambda T: op_main.residual_r(
                    halo(T.reshape(shape)), Tp, dt, total).reshape(-1)

            def precond(T, dt, mv):
                pc = rdmg.preconditioner(T, dt, mv)
                return lambda r: pc(r.reshape(shape)).reshape(-1)

            # the sigma space's cross evaluation, and the elasticity
            # coupling's node-grid scalars through it (JAX's _DGMech)
            def ident(name, arr):
                return self.to_nodes.to_nodes(arr.reshape(shape)).reshape(-1)
            if mech_fn is not None:
                mech_fn = _DGMech(mech_fn, ident)
        elif self.is_q2:
            # the slab's views: its inputs carry a window of two halo
            # lattice planes a side
            shape, halo = self.t_shape, self.lattice_halo
            rq = self.rank_q2_mg

            def lin(T):
                return halo(T.reshape(shape))

            def residual_fn(state, dt):
                Tp_ext = lin(state.T)
                return lambda T: op_main.residual_r(
                    lin(T), Tp_ext, dt).reshape(-1)

            def precond(T, dt, mv):
                pc = rq.preconditioner(T, dt)
                return lambda r: pc(r.reshape(shape)).reshape(-1)

            # the sigma space's cross evaluation: the even lattice points
            def ident(name, arr):
                return self.to_nodes.inject(arr.reshape(shape)).reshape(-1)
        else:
            shape, halo = self.slab_shape, self._halo
            rmg = self.rank_mg

            def lin(T):
                return halo(T.reshape(shape))

            def residual_fn(state, dt):
                Tp_ext = lin(state.T)
                return lambda T: op_main.residual_r(
                    lin(T), Tp_ext, dt).reshape(-1)

            def precond(T, dt, mv):
                return rmg.preconditioner(rmg.linearization_states(T), dt)

            # CG-1 / CG-1: the cross-space evaluation is the identity
            def ident(name, arr):
                return arr
        has_pc = self.rank_mg is not None

        def build_ops(lin_state, dt, lag_mech=False):
            """The operator bundle at the chunk-start state (frozen there
            with jac_lag="step"; rebuilt per Newton iterate with
            "newton"); under mixed precision the f32 twins'. `lag_mech`
            also freezes the elasticity V-cycle for a chunk of several
            steps (the CG system stays each step's own)."""
            T_lin = lin_state.T

            def slab_mv(T):
                return op_fast.make_matvec_r(lin(cast(T)), dt, halo)

            def matvec_fn(T):
                mv = slab_mv(T)
                return lambda v: mv(v.reshape(shape)).reshape(-1)
            precond_fn = diag_fn = None
            if has_pc:
                def precond_fn(T):
                    return precond(cast(T).reshape(shape), dt,
                                   slab_mv(T) if self.is_dg else None)
            else:
                def diag_fn(T):
                    return op_fast.jacobian_diag_r(lin(cast(T)),
                                                   dt).reshape(-1)
            if sc.jac_lag == "step":
                mv = slab_mv(T_lin)
                _mv = lambda v, _m=mv: _m(  # noqa: E731
                    v.reshape(shape)).reshape(-1)
                matvec_fn = lambda T, _m=_mv: _m  # noqa: E731
                if has_pc:
                    # under DG-1 the preconditioner's smoother applies
                    # the step's Jacobian action
                    _pc = precond(cast(T_lin).reshape(shape), dt, mv)
                    precond_fn = lambda T, _p=_pc: _p  # noqa: E731
                if diag_fn is not None:
                    _dg = diag_fn(T_lin)
                    diag_fn = lambda T, _d=_dg: _d  # noqa: E731
            noise_fn = None
            if noise_rel:
                def noise_fn(T):
                    d = op_main.jacobian_diag_r(lin(T), dt).reshape(-1) * T
                    return noise_rel * torch.sqrt(self._dot(d, d))
            inc_diag = None
            if inc_forcing:
                # the frozen magnitude scale: the f32 twin's when it
                # exists, else the production operator's
                inc_diag = op_fast.jacobian_diag_r(lin(cast(T_lin)),
                                                   dt).reshape(-1)
            mech_pre = (mech_fn.build_precond(lin_state)
                        if (lag_mech and mech_fn is not None) else None)
            return dict(precond_fn=precond_fn, matvec_fn=matvec_fn,
                        diag_fn=diag_fn, noise_fn=noise_fn,
                        inc_diag=inc_diag, mech_pre=mech_pre)

        def step(state: ViscoState, dt, ops=None):
            if ops is None:
                ops = build_ops(state, dt)
            res = newton_solve(
                residual_fn(state, dt), state.T, jac_diag_fn=ops["diag_fn"],
                precond_fn=ops["precond_fn"], matvec_fn=ops["matvec_fn"],
                noise_fn=ops["noise_fn"], rtol=sc.newton_rtol,
                atol=sc.newton_atol, max_it=sc.newton_max_it,
                cg_rtol=cg_rtol, cg_atol=sc.cg_atol, cg_max_it=sc.cg_max_it,
                cg_cast=f32 if mixed else None, inc_forcing=inc_forcing,
                inc_diag=ops["inc_diag"], dot=self._dot)
            mech_call = mech_fn
            if ops["mech_pre"] is not None:
                mech_call = (lambda st, xi, th, _p=ops["mech_pre"]:
                             mech_fn(st, xi, th, precond=_p))
            new_state = engine.material_step_with(state, res.x, ident, dt,
                                                  mech=mech_call)
            if self._tgrid:
                new_state = self._edge_fill(new_state)
            if self.mech is not None:
                self.last_mech_iters.append(int(self.mech.last_cg_iters))
                self.last_mech_converged.append(self.mech.last_converged)
                self.last_mech_collectives.append(
                    self.mech.last_collectives)
            # Newton's test reads global norms (the same on every rank);
            # finiteness is summed over the ranks (the real planes' alone)
            x = self._real_t(res.x) if self._tgrid else res.x
            bad = (~torch.isfinite(x)).any().to(self.dtype)
            finite = bool(all_reduce_sum(bad, self.comm) == 0)
            return new_state, res.converged and finite, res.iters, \
                res.krylov_iters

        jac_every = sc.resolved_jac_every()
        chunked = jac_every > 1 and sc.jac_lag == "step"

        def multi_step(state: ViscoState, n: int, dt):
            ok, ni, ki = True, 0, 0
            if not chunked:
                for _ in range(n):
                    state, conv, it, kit = step(state, dt)
                    ok, ni, ki = ok and conv, ni + it, ki + kit
                return state, ok, ni, ki
            for c0 in range(0, n, jac_every):
                ops = build_ops(state, dt, lag_mech=True)
                for _ in range(min(jac_every, n - c0)):
                    state, conv, it, kit = step(state, dt, ops)
                    ok, ni, ki = ok and conv, ni + it, ki + kit
            return state, ok, ni, ki

        self._step_fn = step
        self._multi_step_fn = multi_step


    # ------------------------------------------------------------------
    def step(self, state: ViscoState):
        """One coupled step -> (state, converged, newton, cg)."""
        self._clear_mech_counts()
        return self._step_fn(state, self.dt)

    def run(self, state: ViscoState, n_steps: int | None = None):
        """n steps (default config.time's), the operators rebuilt every
        jac_every steps -> (state, all converged, newton, cg)."""
        n = n_steps if n_steps is not None else self.n_steps
        self._clear_mech_counts()
        return self._multi_step_fn(state, n, self.dt)

    def _clear_mech_counts(self) -> None:
        self.last_mech_iters, self.last_mech_converged = [], []
        self.last_mech_collectives = []

    def solve(self, state: ViscoState | None = None, *,
              n_steps: int | None = None, progress: bool = False):
        """The time loop with per-rank output (JAX's `solve`): one `run`
        of `write_every` steps a chunk (the operators rebuilt at each
        chunk's start), this rank's pieces of the series written after
        each (`output_dir`/sharded_series) and a checkpoint every
        `checkpoint_every` steps (`output_dir`/sharded_ckpt_{done:06d}).
        The counts (and with mechanics `last_mech_*`) are the whole
        run's."""
        if state is None:
            state = self.init_state()
        n_total = n_steps if n_steps is not None else self.n_steps
        oc = self.config.output
        we = oc.write_every
        chunk = we if we and we > 0 else n_total
        writer = None
        if we and we > 0 and oc.formats:
            writer = ShardedSeriesWriter(
                f"{oc.output_dir}/sharded_series",
                fields=tuple(f for f in oc.npz_fields
                             if f in ViscoState._fields),
                grid=self.grid, pad0=self.pad0, rank=self.comm.rank,
                world_size=self.n_devices, **self._cell_layout())
        t0 = _time.perf_counter()
        done = ni_tot = ki_tot = 0
        mech_iters, mech_conv, mech_coll = [], [], []
        while done < n_total:
            n = min(chunk, n_total - done)
            state, ok, ni, ki = self.run(state, n)
            mech_iters += self.last_mech_iters
            mech_conv += self.last_mech_converged
            mech_coll += self.last_mech_collectives
            if not ok:
                raise RuntimeError(
                    f"Newton failed to converge in steps {done}..{done + n}")
            done += n
            t = done * self.dt
            ni_tot += ni
            ki_tot += ki
            if writer is not None:
                writer.write(t, state)
            ce = oc.checkpoint_every
            if ce and done % ce == 0:
                self.save_checkpoint(
                    f"{oc.output_dir}/sharded_ckpt_{done:06d}", state,
                    extra={"t": t, "done": done})
            if progress:
                print(f"t={t:.3f}")
        if writer is not None:
            writer.close()
            self._sync()
        self.last_mech_iters, self.last_mech_converged = mech_iters, mech_conv
        self.last_mech_collectives = mech_coll
        self.elapsed_seconds = _time.perf_counter() - t0
        self.newton_iters = ni_tot
        self.krylov_iters = ki_tot
        return state

    def _cell_layout(self) -> dict:
        """The writer's T-grid keywords (JAX's `solve`): DG-1 T-space
        fields on the padded cell grid with its local-dof axis, CG-2's on
        the padded lattice."""
        if not self._tgrid:
            return {}
        base = self.cell_dims if self.is_dg else self.lat_base
        return dict(cell_grid=(base[0] + self.t_pad0,) + base[1:],
                    cell_pad0=self.t_pad0,
                    cell_fields=tuple(sorted(self._TSPACE_FIELDS)),
                    cell_local_axis=self.is_dg)

    def _layout(self) -> PlaneLayout:
        kw = self._cell_layout()
        kw.pop("cell_pad0", None)
        if kw:
            kw["cell_fields"] = frozenset(kw["cell_fields"])
        return PlaneLayout(self.grid, self.comm.rank, self.n_devices, **kw)

    def _sync(self) -> None:
        """Return once every rank has come here (one collective): what a
        rank wrote is then there for the others to read."""
        float(all_reduce_sum(torch.zeros((), dtype=self.dtype,
                                         device=self.device), self.comm))

    def save_checkpoint(self, out_dir: str, state: ViscoState,
                        extra: dict | None = None) -> None:
        """This rank's pieces of every field (rank 0's also `t` and
        meta.json); returns once every rank's are written."""
        save_sharded_checkpoint(out_dir, state, self._layout(), extra=extra)
        self._sync()

    def load_checkpoint(self, out_dir: str) -> ViscoState:
        """This rank's rows of a sharded checkpoint (either package's), read
        from the pieces that cover its planes, on its device in the
        problem's dtype. ValueError where the checkpoint's padded grid is
        not this problem's."""
        state, _ = load_sharded_checkpoint(out_dir, self._layout(),
                                           device=self.device,
                                           dtype=self.dtype)
        return state


class _DGMech:
    """JAX's `_DGMech` shim: the elasticity coupling takes node-grid
    scalars, so the cell-grid xi and thermal-strain scalar pass through
    the sigma cross evaluation `ident` first."""

    def __init__(self, mech, ident):
        self.mech, self.ident = mech, ident

    def __call__(self, st, xi, th, precond=None):
        return self.mech(st, self.ident("T", xi), self.ident("T", th),
                         precond=precond)

    def build_precond(self, st):
        return self.mech.build_precond(st._replace(xi=self.ident("T", st.xi)))
