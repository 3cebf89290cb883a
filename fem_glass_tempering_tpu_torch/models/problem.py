"""Coupled thermo-viscoelastic problem driver.

Counterpart of fem_glass_tempering_tpu/models/problem.py (the reference's
orchestrator, ThermoViscoProblem.py:23-620). Each time step is an implicit
Newton-CG heat solve followed by the viscoelastic material chain; the time
loop runs in chunks between output snapshots, with the Krylov operator and
the preconditioner frozen once per step (or per `jac_every` steps).

API parity: the constructor accepts the reference driver's dict-style
arguments (mesh_path/config/time/dt/model_parameters, reference
main.py:57-59) as well as a typed RunConfig; `setup(dirichlet_bc=False)`
and `solve()` match the reference entry points (main.py:61-62).

Ported: CG and DG temperature spaces of degree 1 and 2; the matrix-free,
assembled (ELL) and, on boxes, stencil Krylov operators (the CG-1 nodal
stencil, the DG block stencil, the CG-2 lattice operator); the Jacobi,
multigrid (geometric MG for CG-1 boxes, the DG p-multigrid for DG-1 boxes,
Q2MG for CG-2 boxes), SA-AMG or no preconditioner; mixed precision
(cg_dtype='float32' under f64: an f32 inner CG with f32 twins of the
operator and the preconditioner); equilibrium mechanics
(mechanics='equilibrium': an elasticity solve inside every material step,
models/mechanics.py); checkpoints; gmsh input (mesh_path=) and the npz,
VTU and XDMF writers. On a structured box a CG-2 space takes
the lattice path unless grid_native='off': the sum-factorised operator
ops/grid2.py GridHeatOperator2 carries the residual and the diagonal, and
with linear_operator='stencil' the Jacobian action, and Q2MG (its coarse
solve the CG-1 GeometricMG V-cycle) preconditions 'mg' / 'auto'. Every
other degree-2 configuration runs the gather HeatOperator, as in the JAX
version. The default constructor is the reference's default workload
(DG-1 on the graded 1D slab, matrix-free CG, SA-AMG).
"""

from __future__ import annotations

import dataclasses
import time as _time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from fem_glass_tempering_tpu_torch.config import (
    FEConfig,
    ModelParams,
    RunConfig,
    TimeConfig,
)
from fem_glass_tempering_tpu_torch.device import resolve_device, resolve_dtype
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.fem.mesh import (
    Mesh,
    read_msh,
    reference_glass_mesh_1d,
)
from fem_glass_tempering_tpu_torch.models.viscoelastic import (
    ViscoelasticEngine,
    ViscoState,
)
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.solver.newton import newton_solve


@dataclass
class StepDiagnostics:
    """Per-solve diagnostics: Newton, CG and elasticity-CG totals,
    convergence flag, output seconds, dt halvings taken."""

    newton_iters: int = 0
    krylov_iters: int = 0
    # elasticity CG iterations (mechanics='equilibrium')
    mech_krylov_iters: int = 0
    converged: bool = True
    io_seconds: float = 0.0
    dt_halvings: int = 0


def _fe_config_from_dict(d: dict) -> FEConfig:
    """Reference-style fe_config dict (main.py:24-27) -> FEConfig."""
    return FEConfig(
        T_family=d["T"]["element"], T_degree=d["T"]["degree"],
        sigma_family=d["sigma"]["element"], sigma_degree=d["sigma"]["degree"],
    )


def _model_params_from_dict(d: dict) -> ModelParams:
    """Reference-style model_params dict (main.py:29-55) -> ModelParams."""
    known = {f.name for f in dataclasses.fields(ModelParams)}
    return ModelParams(**{k: v for k, v in d.items() if k in known})


class ThermoViscoProblem:
    def __init__(self, mesh: Mesh | None = None, *,
                 mesh_path: str | None = None,
                 config: RunConfig | dict | None = None,
                 time: tuple | None = None,
                 dt: float | None = None,
                 model_parameters: dict | ModelParams | None = None,
                 physics_mode: str | None = None,
                 dtype: Any = None,
                 device=None,
                 jit_options: dict | None = None):
        # ---- resolve configuration (typed or reference-dict style) ----
        if isinstance(config, dict):       # reference fe_config dict
            run_cfg = RunConfig(fe=_fe_config_from_dict(config))
        elif isinstance(config, RunConfig):
            run_cfg = config
        else:
            run_cfg = RunConfig()
        if time is not None or dt is not None:
            t0, t1 = time if time is not None else (run_cfg.time.t_start, run_cfg.time.t_end)
            run_cfg = dataclasses.replace(
                run_cfg, time=TimeConfig(t_start=t0, t_end=t1,
                                         dt=dt if dt is not None else run_cfg.time.dt))
        if isinstance(model_parameters, dict):
            run_cfg = dataclasses.replace(run_cfg, params=_model_params_from_dict(model_parameters))
        elif isinstance(model_parameters, ModelParams):
            run_cfg = dataclasses.replace(run_cfg, params=model_parameters)
        if physics_mode is not None:
            run_cfg = dataclasses.replace(run_cfg, physics_mode=physics_mode)
        self.config = run_cfg
        # jit_options accepted for constructor parity
        del jit_options

        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype or run_cfg.dtype)
        # f32 products (the 6-term Tf dot, the dense coarse inverse) run at
        # full f32 precision, never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        # ---- mesh ----
        if mesh is not None:
            self.mesh = mesh
        elif mesh_path is not None:
            self.mesh = read_msh(mesh_path)
        else:
            self.mesh = reference_glass_mesh_1d()
        self.dim = self.mesh.tdim

        fe = run_cfg.fe
        self.fs_T = FunctionSpace(self.mesh, fe.T_family, fe.T_degree)
        self.fs_sigma = FunctionSpace(self.mesh, fe.sigma_family, fe.sigma_degree,
                                      value_shape=(self.dim, self.dim))

        self.dt = run_cfg.time.dt
        self.time = (run_cfg.time.t_start, run_cfg.time.t_end)
        self.t = run_cfg.time.t_start
        self.n_steps = run_cfg.time.n_steps

        self.params = run_cfg.params
        self.engine = ViscoelasticEngine(
            self.fs_T, self.fs_sigma, self.params, self.dt,
            physics_mode=run_cfg.physics_mode,
            shift_function=run_cfg.shift_function,
            xi_formula=run_cfg.xi_formula, dtype=self.dtype,
            use_pallas=run_cfg.use_pallas, device=self.device,
        )
        self.heat: HeatOperator | None = None
        self.state: ViscoState | None = None
        # the elasticity CG count of each step of the last step() or
        # multi_step() call (mechanics='equilibrium'; else empty)
        self.last_mech_iters: list[int] = []
        self._writers: list = []
        self.diagnostics = StepDiagnostics()

    # ------------------------------------------------------------------
    def setup(self, dirichlet_bc: bool = False, output_dir: str | None = None,
              flux_marker=None, flux_tag=None, dirichlet_tag=None) -> None:
        """Initial conditions + solver + output writers (reference setup(),
        ThermoViscoProblem.py:176-184). The Dirichlet option clamps the
        boundary to T_ambient. `flux_marker(midpoints) -> bool mask`
        restricts the radiation + convection flux to selected boundary
        facets; `flux_tag` / `dirichlet_tag` select facets by physical
        group of a tagged mesh."""
        if flux_tag is not None:
            if flux_marker is not None:
                raise ValueError("pass flux_marker or flux_tag, not both")
            _fmask = self.mesh.boundary_facets_with_tag(flux_tag)
            flux_marker = lambda mids, _m=_fmask: _m  # noqa: E731
        sc = self.config.solver
        if sc.preconditioner == "auto":
            # the reference preconditions with GAMG unconditionally
            # (ThermoViscoProblem.py:344); resolve to the strongest
            # equivalent this mesh/space supports
            if (self.mesh.structured is not None
                    and ((self.fs_T.degree == 1
                          and self.fs_T.family in ("CG", "DG"))
                         or (self.fs_T.degree == 2
                             and self.fs_T.family == "CG"))):
                resolved = "mg"
            else:
                resolved = "amg"
            sc = dataclasses.replace(sc, preconditioner=resolved)
            self.config = dataclasses.replace(self.config, solver=sc)
        if sc.preconditioner not in ("mg", "amg", "jacobi", "none"):
            raise ValueError(f"unknown preconditioner {sc.preconditioner!r}")
        bc_dofs = bc_val = None
        if dirichlet_tag is not None:
            bc_dofs = self.fs_T.boundary_scalar_dofs(
                facet_mask=self.mesh.boundary_facets_with_tag(dirichlet_tag))
            bc_val = self.params.T_ambient
            dirichlet_bc = True
        elif dirichlet_bc:
            bc_dofs = self.fs_T.boundary_scalar_dofs()
            bc_val = self.params.T_ambient
        heat_form = self.config.heat_form
        # host seconds of the setup's parts: "heat", "grid" (the grid-native
        # operator: CG-1 grid or CG-2 lattice), "twins" (the f32
        # operators of mixed precision), "mg" (the multigrid hierarchy and
        # its frozen smoothers; of it "freeze", the DG multigrid's), and
        # "ell" / "amg" where an SA-AMG hierarchy is built
        self.setup_seconds: dict = {}
        # when the DG block stencil carries the whole outer loop, the SIPG
        # interior-facet tables are never read on the device: they stay
        # on the host (_build_step copies them where another path needs
        # them)
        dg_stencil = (self.fs_T.family == "DG"
                      and self.mesh.structured is not None
                      and sc.linear_operator == "stencil")

        def heat_operator(dtype):
            return HeatOperator(
                self.fs_T, self.params, self.dt, dtype=dtype,
                device=self.device, bc_dofs=bc_dofs, bc_value=bc_val,
                quad_degree=self.config.fe.quad_degree,
                flux_marker=flux_marker, form=heat_form,
                interior_device_tables=not dg_stencil)

        t_setup = _time.perf_counter()
        self.heat = heat_operator(self.dtype)
        self.setup_seconds["heat"] = _time.perf_counter() - t_setup
        # gather-free grid-native path when the mesh/space qualify
        t_grid = _time.perf_counter()
        self._grid = None
        if sc.grid_native != "off":
            from fem_glass_tempering_tpu_torch.ops.grid import GridHeatOperator
            try:
                self._grid = GridHeatOperator(self.heat,
                                              flux_marker=flux_marker)
            except ValueError:
                if sc.grid_native == "on":
                    raise
        # the CG-2 lattice path (ops/grid2.py): the sum-factorised operator
        # on the Q2 dof lattice of a uniform box; where it does not apply
        # the gather HeatOperator stays, as in the JAX version
        self._grid2 = None
        if self._grid is None and sc.grid_native != "off":
            from fem_glass_tempering_tpu_torch.ops.grid2 import (
                GridHeatOperator2,
            )
            try:
                self._grid2 = GridHeatOperator2(self.heat,
                                                flux_marker=flux_marker)
            except ValueError:
                pass
        self.setup_seconds["grid"] = _time.perf_counter() - t_grid
        # equilibrium mechanics: the grid coupling on CG-1 grids and DG
        # boxes (through the T -> sigma cross-eval), the flat one otherwise
        self._mech = None
        if self.config.mechanics == "equilibrium":
            t_mech = _time.perf_counter()
            self._mech = self._build_mechanics()
            self.setup_seconds["mechanics"] = _time.perf_counter() - t_mech
        # mixed precision: the inner CG runs in f32 under the f64 Newton
        # loop, on f32 twins of the operators; the multigrid hierarchy is
        # then built as its f32 twin alone
        self._mixed = (sc.cg_dtype == "float32"
                       and self.dtype == torch.float64)
        self._heat32 = self._grid32 = self._grid2_32 = None
        if self._mixed:
            t_twins = _time.perf_counter()
            self._heat32 = heat_operator(torch.float32)
            if self._grid is not None:
                from fem_glass_tempering_tpu_torch.ops.grid import (
                    GridHeatOperator,
                )
                self._grid32 = GridHeatOperator(self._heat32,
                                                flux_marker=flux_marker)
            if self._grid2 is not None:
                from fem_glass_tempering_tpu_torch.ops.grid2 import (
                    GridHeatOperator2,
                )
                self._grid2_32 = GridHeatOperator2(self._heat32,
                                                   flux_marker=flux_marker)
            self.setup_seconds["twins"] = _time.perf_counter() - t_twins
        self._mg = self._dg_mg = self._mg32 = self._dg_mg32 = None
        if sc.preconditioner == "mg":
            fs = self.fs_T
            if (self.mesh.structured is None or (fs.family, fs.degree)
                    not in (("CG", 1), ("DG", 1), ("CG", 2))):
                raise ValueError(
                    "preconditioner='mg' needs a structured box mesh with a "
                    "CG-1/CG-2 or DG-1 temperature space; use 'jacobi' "
                    "otherwise")
            if fs.degree == 2 and self._grid2 is None:
                raise ValueError(
                    "CG-2 'mg' needs the lattice-native operator "
                    "(grid_native must not be 'off')")
            t_mg = _time.perf_counter()
            if self._mixed:
                self._mg32, self._dg_mg32 = self._build_multigrid(
                    self._heat32, self._grid2_32, dirichlet_bc, bc_val)
            else:
                self._mg, self._dg_mg = self._build_multigrid(
                    self.heat, self._grid2, dirichlet_bc, bc_val)
            self.setup_seconds["mg"] = _time.perf_counter() - t_mg
        # smoothed-aggregation AMG (solver/amg.py): the mesh-agnostic GAMG
        # stand-in for unstructured meshes; hierarchy frozen at (T_0, dt),
        # built as its f32 twin alone under mixed precision
        self._amg = self._amg32 = None
        if sc.preconditioner == "amg":
            from fem_glass_tempering_tpu_torch.ops.spmv import EllMatrix
            from fem_glass_tempering_tpu_torch.solver.amg import (
                SmoothedAggregationMG,
            )
            heat = self._heat32 if self._mixed else self.heat
            T0v = torch.full((self.fs_T.n_scalar_dofs,), self.params.T_0,
                             dtype=heat.dtype, device=self.device)
            t_ell = _time.perf_counter()
            ell = EllMatrix(heat)
            t_amg = _time.perf_counter()
            amg = SmoothedAggregationMG(ell, T0v, self.dt, dtype=heat.dtype)
            if self._mixed:
                self._amg32 = amg
            else:
                self._amg = amg
            self.setup_seconds["ell"] = t_amg - t_ell
            self.setup_seconds["amg"] = _time.perf_counter() - t_amg
        self.state = self.engine.init_state()
        self._build_step()
        if output_dir is not None:
            self.config = dataclasses.replace(
                self.config,
                output=dataclasses.replace(self.config.output, output_dir=output_dir))
        self._setup_writers()

    def _build_mechanics(self):
        """The equilibrium coupling and its tolerances: the elasticity CG
        asks for min(cg_rtol, 1e-8) (at least 2e-6 in f32, where residual
        norms bottom out), mech_inc_rtol (None -> 1e-2) relative to a warm
        start, and at least 2000 iterations."""
        from fem_glass_tempering_tpu_torch.models.mechanics import (
            DGNodeMechAdapter,
            GridMechanicsCoupling,
            MechanicsCoupling,
        )
        sc = self.config.solver
        rtol = min(sc.cg_rtol, 1e-8)
        if self.dtype == torch.float32:
            rtol = max(rtol, 2e-6)
        inc = 1e-2 if sc.mech_inc_rtol is None else sc.mech_inc_rtol
        kw = dict(dtype=self.dtype, cg_rtol=rtol,
                  cg_max_it=max(sc.cg_max_it, 2000), inc_rtol=inc)
        dg_box = (self.fs_T.family == "DG"
                  and self.mesh.structured is not None)
        if self._grid is not None or dg_box:
            try:
                gm = GridMechanicsCoupling(self.fs_sigma, self.engine, **kw)
            except ValueError:
                pass
            else:
                if self.fs_T.family == "DG":
                    return DGNodeMechAdapter(gm, self.engine.to_sigma.eval)
                return gm
        return MechanicsCoupling(self.fs_T, self.fs_sigma, self.engine,
                                 **kw)

    def _build_multigrid(self, heat: HeatOperator, grid2, dirichlet_bc,
                         bc_val):
        """The frozen multigrid preconditioner of `heat`'s space in its
        dtype -> (GeometricMG, None) for CG-1, (Q2MG over `heat`'s lattice
        operator `grid2`, None) for CG-2, (None, DGMultigrid) for DG-1; the
        coarse levels are rediscretised CG-1 heat operators."""
        from fem_glass_tempering_tpu_torch.solver.multigrid import (
            DGMultigrid,
            GeometricMG,
        )
        sc = self.config.solver

        def make_operator(level_mesh):
            fs = FunctionSpace(level_mesh, "CG", 1)
            bd = fs.boundary_scalar_dofs() if dirichlet_bc else None
            return HeatOperator(fs, self.params, self.dt, dtype=heat.dtype,
                                device=self.device, bc_dofs=bd,
                                bc_value=bc_val, form=self.config.heat_form)

        if self.fs_T.degree == 2:
            # CG-2: p-multigrid over the embedded CG-1 lattice, whose
            # GeometricMG takes the smoother and keeps Q2MG's defaults
            from fem_glass_tempering_tpu_torch.ops.grid2 import Q2MG
            mg = Q2MG(grid2, make_operator, nu_pre=sc.mg_nu_pre,
                      nu_post=sc.mg_nu_post,
                      mg_kwargs={"smoother": sc.mg_smoother})
            mg.freeze_rhos(self.dt)
            return mg, None
        # the V-cycle's table stream dtype (SolverConfig.mg_table_dtype):
        # the CG-1 grid levels, also under the DG p-multigrid
        table_dtype = (torch.bfloat16 if sc.mg_table_dtype == "bfloat16"
                       else None)
        mg_kwargs = dict(smoother=sc.mg_smoother, nu_pre=sc.mg_nu_pre,
                         nu_post=sc.mg_nu_post, max_levels=sc.mg_max_levels,
                         coarse=sc.mg_coarse, table_dtype=table_dtype)
        if self.fs_T.family == "DG":
            dg_mg = DGMultigrid(heat, make_operator, dtype=heat.dtype,
                                smoother=sc.dg_smoother, mg_kwargs=mg_kwargs)
            t_freeze = _time.perf_counter()
            dg_mg.freeze(None, self.dt)
            self.setup_seconds["freeze"] = _time.perf_counter() - t_freeze
            return None, dg_mg
        mg = GeometricMG(self.mesh, make_operator, dtype=heat.dtype,
                         **mg_kwargs)
        mg.freeze_omegas(None, self.dt)
        return mg, None

    def _setup_writers(self) -> None:
        """Instantiate the configured output writers (the reference writes
        T, phi, Tf, xi and sigma, ThermoViscoProblem.py:246-276). Every
        writer copies the fields it writes to the host itself."""
        self._writers = []
        oc = self.config.output
        if oc.write_every <= 0 or not oc.formats:
            return
        out = oc.output_dir
        if "npz" in oc.formats:
            from fem_glass_tempering_tpu_torch.io.series import NPZSeriesWriter
            self._writers.append(
                NPZSeriesWriter(f"{out}/series.npz", fields=oc.npz_fields))
        if "vtu" in oc.formats:
            from fem_glass_tempering_tpu_torch.io.vtu import VTUSeriesWriter
            w = VTUSeriesWriter(out, "visco", self.mesh)
            w.write = self._wrap_vtu(w)  # type: ignore[method-assign]
            self._writers.append(w)
        if "xdmf" in oc.formats:
            from fem_glass_tempering_tpu_torch.io.xdmf import XDMFWriter
            w = XDMFWriter(f"{out}/sigma.xdmf", self.mesh)
            orig = w.write_function
            w.write = lambda t, state: orig(  # type: ignore[attr-defined]
                "Stress_tensor", self.fs_sigma, state.sigma, t)
            self._writers.append(w)

    def _wrap_vtu(self, w):
        orig_write = type(w).write

        def write(t, state):
            orig_write(w, t, {
                "Temperature": (self.fs_T, state.T),
                "Fictive_Temperature": (self.fs_T, state.Tf),
                "Shift_function": (self.fs_T, state.phi),
                "Shifted_time": (self.fs_T, state.xi),
                "Stress_tensor": (self.fs_sigma, state.sigma),
            })
        return write

    # ------------------------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        from fem_glass_tempering_tpu_torch.io.checkpoint import (
            save_checkpoint,
        )
        save_checkpoint(path, self.state, config=self.config,
                        extra={"t": self.t})

    def resume_from(self, path: str) -> None:
        """Restore state + time from a checkpoint (one written by this
        package or by the JAX package)."""
        from fem_glass_tempering_tpu_torch.io.checkpoint import (
            load_checkpoint,
        )
        state, meta = load_checkpoint(path, dtype=self.dtype,
                                      device=self.device)
        self.state = state
        self.t = float(meta.get("extra", {}).get("t", float(state.t)))

    def _krylov_operator(self, heat, grid, dg_mg):
        """The Jacobian action object of linear_operator for `heat` (its
        grid-native twin `grid` and DG multigrid `dg_mg` where they exist);
        None for 'matrix_free'."""
        lo = self.config.solver.linear_operator
        if lo == "assembled":
            from fem_glass_tempering_tpu_torch.ops.spmv import EllMatrix
            return EllMatrix(heat)
        if lo == "stencil":
            if grid is not None:
                return grid
            if dg_mg is not None:
                # share the DG multigrid's table-form block stencil
                return dg_mg.stencil
            from fem_glass_tempering_tpu_torch.ops.stencil import (
                make_stencil_operator,
            )
            return make_stencil_operator(heat)
        if lo != "matrix_free":
            raise ValueError(f"unknown linear_operator {lo!r}")
        return None

    @staticmethod
    def _residual_operator(heat, grid, ell):
        """What evaluates the Newton residual and the Jacobi diagonal: the
        grid-native operator, else the DG block stencil when it is the
        Krylov operator, else the heat operator itself (whose SIPG
        residual reads the interior-facet device tables)."""
        from fem_glass_tempering_tpu_torch.ops.stencil import DGStencilMatrix
        if grid is not None:
            return grid
        if isinstance(ell, DGStencilMatrix):
            return ell
        heat.ensure_interior_tables()
        return heat

    def _build_step(self) -> None:
        heat, engine, sc = self.heat, self.engine, self.config.solver
        mg, dg_mg, amg = self._mg, self._dg_mg, self._amg
        # the CG-1 grid operator or the CG-2 lattice operator: one surface
        # for the residual, the diagonal and the Jacobian action
        grid = self._grid if self._grid is not None else self._grid2
        # a sharded heat operator (parallel/sharding.py) assembles this
        # rank's cells; the Krylov operator is built whole, as the solver's
        # other operators are
        ell = self._krylov_operator(getattr(heat, "whole", heat), grid,
                                    dg_mg)
        self._ell = ell
        hres = self._residual_operator(heat, grid, ell)
        # mixed precision: f32 twins for the inner CG
        mixed = self._mixed
        f32 = torch.float32
        heat32 = self._heat32
        mg32, dg_mg32, amg32 = self._mg32, self._dg_mg32, self._amg32
        ell32 = hres32 = None
        if mixed:
            grid32 = (self._grid32 if self._grid32 is not None
                      else self._grid2_32)
            ell32 = self._krylov_operator(heat32, grid32, dg_mg32)
            hres32 = self._residual_operator(heat32, grid32, ell32)
        self._ell32 = ell32
        # the f32 inner tolerance: tighter than ~1e-6 is not representable
        # in f32 residual norms, and the SIPG operator's f32 floor is
        # higher still (~eps32 * kappa), so a DG solve asks for 1e-4 and
        # the f64 Newton loop refines (the JAX version's measurements)
        cg_rtol = (max(sc.cg_rtol, 1e-4 if heat.is_dg else 1e-6) if mixed
                   else sc.cg_rtol)

        # the residual noise floor is a TPU emulated-f64 device: off here
        noise_rel = sc.newton_noise_rel or 0.0
        inc_forcing = sc.newton_inc_forcing
        if inc_forcing is None:
            inc_forcing = 0.05

        mech_fn = self._mech

        def build_ops(lin_state, dt, lag_mech=False):
            """Operator bundle at the chunk-start state. With jac_lag="step"
            the Krylov operator, the preconditioner and the Jacobi diagonal
            are frozen there (one build per step, or per jac_every chunk);
            with "newton" they are rebuilt at every Newton iterate. Under
            mixed precision they are the f32 twins', at the f32 iterate.
            `lag_mech` also freezes the elasticity V-cycle for the chunk
            (only for chunks of several steps: per step it would repeat the
            fine table build that the coupling shares with its V-cycle)."""
            state_T = lin_state.T
            precond_fn = matvec_fn = diag_fn = None
            if mixed:
                cast = lambda T: T.to(f32)
                if mg32 is not None:
                    precond_fn = lambda T: mg32.preconditioner(
                        mg32.linearization_states(cast(T)), dt)
                elif dg_mg32 is not None:
                    precond_fn = lambda T: dg_mg32.preconditioner(cast(T), dt)
                elif amg32 is not None:
                    precond_fn = lambda T: amg32.preconditioner()
                if ell32 is not None:
                    matvec_fn = lambda T: ell32.make_matvec(cast(T), dt)
                else:
                    # matrix-free: jvp of the f32 residual at the f32 iterate
                    Tp32 = cast(state_T)

                    def matvec_fn(T):
                        T32 = cast(T)
                        return lambda v: torch.func.jvp(
                            lambda u: heat32.residual(u, Tp32, dt),
                            (T32,), (v,))[1]
                if sc.preconditioner == "jacobi":
                    diag_fn = lambda T: hres32.jacobian_diag(cast(T), dt)
            else:
                if mg is not None:
                    precond_fn = lambda T: mg.preconditioner(
                        mg.linearization_states(T), dt)
                elif dg_mg is not None:
                    precond_fn = lambda T: dg_mg.preconditioner(T, dt)
                elif amg is not None:
                    precond_fn = lambda T: amg.preconditioner()
                if ell is not None:
                    matvec_fn = lambda T: ell.make_matvec(T, dt)
                if sc.preconditioner == "jacobi":
                    diag_fn = lambda T: hres.jacobian_diag(T, dt)
            if sc.jac_lag == "step":
                if precond_fn is not None:
                    _pc = precond_fn(state_T)
                    precond_fn = lambda T, _p=_pc: _p
                if matvec_fn is not None:
                    _mv = matvec_fn(state_T)
                    matvec_fn = lambda T, _m=_mv: _m
                if diag_fn is not None:
                    _dg = diag_fn(state_T)
                    diag_fn = lambda T, _d=_dg: _d
            noise_fn = inc_diag = None
            if noise_rel or inc_forcing:
                # the per-step Jacobi diagonal (the f32 twin's under mixed
                # precision) scales the increment-relative forcing and the
                # noise floor, when on
                if mixed:
                    inc_diag = hres32.jacobian_diag(state_T.to(f32), dt)
                else:
                    inc_diag = hres.jacobian_diag(state_T, dt)
                if noise_rel:
                    dd = inc_diag.to(state_T.dtype) * state_T
                    floor = noise_rel * torch.sqrt(torch.dot(dd, dd))
                    noise_fn = lambda T: floor
            mech_pre = (mech_fn.build_precond(lin_state)
                         if (lag_mech and mech_fn is not None) else None)
            return dict(precond_fn=precond_fn, matvec_fn=matvec_fn,
                        diag_fn=diag_fn, noise_fn=noise_fn, inc_diag=inc_diag,
                        mech_pre=mech_pre)

        def step(state: ViscoState, dt, ops=None):
            """One coupled step -> (state, converged, newton, cg)."""
            if ops is None:
                ops = build_ops(state, dt)
            res = newton_solve(
                lambda T: hres.residual(T, state.T, dt),
                state.T,
                noise_fn=ops["noise_fn"],
                jac_diag_fn=ops["diag_fn"],
                precond_fn=ops["precond_fn"],
                matvec_fn=ops["matvec_fn"],
                rtol=sc.newton_rtol, atol=sc.newton_atol,
                max_it=sc.newton_max_it,
                cg_rtol=cg_rtol, cg_atol=sc.cg_atol, cg_max_it=sc.cg_max_it,
                cg_cast=f32 if mixed else None,
                # a preconditioned f32 solve that has not improved in 25
                # iterations is at its floor (Jacobi-CG plateaus for longer:
                # newton_solve's default window of 100 stays)
                cg_stall_window=(25 if (mixed and ops["precond_fn"]
                                        is not None) else None),
                inc_forcing=inc_forcing, inc_diag=ops["inc_diag"],
            )
            mech_call = mech_fn
            if ops["mech_pre"] is not None:
                mech_call = (lambda st, xi, th, _p=ops["mech_pre"]:
                             mech_fn(st, xi, th, precond=_p))
            new_state = engine.material_step(state, res.x, dt,
                                             mech=mech_call)
            if mech_fn is not None:
                self.last_mech_iters.append(int(mech_fn.last_cg_iters))
            finite = bool(torch.isfinite(res.x).all())
            return new_state, res.converged and finite, res.iters, res.krylov_iters

        # jac_every chunking applies to operators frozen per step
        jac_every = sc.resolved_jac_every() if sc.jac_lag == "step" else 1

        def multi_step(state: ViscoState, n: int, dt):
            ok, ni, ki = True, 0, 0
            for c0 in range(0, n, jac_every):
                # jac_every chunking: rebuild the frozen operator bundle
                # every jac_every steps (one step per chunk when 1)
                ops = build_ops(state, dt, lag_mech=jac_every > 1)
                for _ in range(min(jac_every, n - c0)):
                    state, conv, it, kit = step(state, dt, ops)
                    ok, ni, ki = ok and conv, ni + it, ki + kit
            return state, ok, ni, ki

        self._step_fn = step
        self._multi_step_fn = multi_step

    # ------------------------------------------------------------------
    def step(self, state: ViscoState, dt: float | None = None):
        """One coupled time step from `state` -> (state, converged,
        newton_iters, cg_iters). Does not touch self.state; the elasticity
        CG count lands in last_mech_iters."""
        self.last_mech_iters = []
        return self._step_fn(state, self.dt if dt is None else dt)

    def multi_step(self, state: ViscoState, n: int, dt: float | None = None):
        """n coupled steps from `state`, with the Krylov operator and the
        V-cycle rebuilt every `jac_every` steps -> (state, all converged,
        newton_iters, cg_iters). Does not touch self.state; the elasticity
        CG count of each step lands in last_mech_iters."""
        self.last_mech_iters = []
        return self._multi_step_fn(state, n, self.dt if dt is None else dt)

    def solve_timestep(self, check_convergence: bool = True) -> ViscoState:
        """Advance one step (heat solve + material update), reference
        solve_timestep parity (ThermoViscoProblem.py:367-381)."""
        state, converged, iters, kiters = self.step(self.state)
        if check_convergence and not converged:
            raise RuntimeError(f"Newton failed to converge at t={self.t + self.dt}")
        self.state = state
        self.t += self.dt
        self.diagnostics.newton_iters += int(iters)
        self.diagnostics.krylov_iters += int(kiters)
        self.diagnostics.mech_krylov_iters += sum(self.last_mech_iters)
        return state

    def solve(self, progress: bool = False,
              on_snapshot: Callable[[float, ViscoState], None] | None = None) -> ViscoState:
        """Run the full time loop (reference solve(),
        ThermoViscoProblem.py:598-611) in chunks between output snapshots,
        with the dt-halving retry when solver.on_failure='halve_dt'."""
        if self.state is None:
            raise RuntimeError("call setup() first")
        t_start = _time.time()
        we = self.config.output.write_every
        chunk = we if we and we > 0 else self.n_steps
        adaptive = self.config.solver.on_failure == "halve_dt"
        done = 0
        while done < self.n_steps:
            n = min(chunk, self.n_steps - done)
            # the step never updates a state in place, so the chunk-start
            # state doubles as the retry snapshot
            snapshot = self.state
            self.state, ok, ni, ki = self.multi_step(self.state, n)
            mi = sum(self.last_mech_iters)
            if not ok:
                if not adaptive:
                    raise RuntimeError(
                        f"Newton failed to converge in steps {done}..{done + n}")
                self.state, ni, ki, mi = self._retry_chunk(snapshot, n)
            done += n
            self.t = self.time[0] + done * self.dt
            self.diagnostics.newton_iters += int(ni)
            self.diagnostics.krylov_iters += int(ki)
            self.diagnostics.mech_krylov_iters += mi
            t_io = _time.time()
            for w in self._writers:
                w.write(self.t, self.state)
            ce = self.config.output.checkpoint_every
            if ce and done % ce == 0:
                self.save_checkpoint(
                    f"{self.config.output.output_dir}/checkpoint_{done:06d}.npz")
            self.diagnostics.io_seconds += _time.time() - t_io
            if on_snapshot is not None:
                on_snapshot(self.t, self.state)
            if progress:
                print(f"t={self.t:.3f}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed_seconds = _time.time() - t_start
        self._finalize()
        if progress:
            print(f"Solve finished in {self.elapsed_seconds} seconds.")
        return self.state

    def solve_scan(self, fields: tuple = ("T", "Tf", "sigma")):
        """The whole time loop with stacked field snapshots: `multi_step`
        chunks of `write_every` steps (the whole run when 0), a snapshot
        of `fields` after each, then the remainder steps unsnapshotted.
        The snapshots stay on the device until the end; beyond the
        Newton loop's own convergence reads nothing comes to the host per
        chunk. No writers, checkpoints or retries (use `solve` for those).

        Returns (final_state, {"times": (n_chunks,), field: (n_chunks,
        *shape)}), the stacks on the state's device; raises RuntimeError
        if a step did not converge."""
        if self.state is None:
            raise RuntimeError("call setup() first")
        t_start = _time.time()
        we = self.config.output.write_every
        chunk = we if we and we > 0 else self.n_steps
        n_chunks = self.n_steps // chunk
        rem = self.n_steps - n_chunks * chunk
        st, ok, ni, ki, mi = self.state, True, 0, 0, 0
        times, snaps = [], {f: [] for f in fields}
        for n in [chunk] * n_chunks + ([rem] if rem else []):
            st, ok_c, ni_c, ki_c = self.multi_step(st, n)
            ok, ni, ki = ok and ok_c, ni + ni_c, ki + ki_c
            mi += sum(self.last_mech_iters)
            if len(times) < n_chunks:
                times.append(st.t)
                for f in fields:
                    snaps[f].append(getattr(st, f))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if not ok:
            raise RuntimeError("Newton failed to converge during solve_scan")
        self.state = st
        self.t = self.time[0] + self.n_steps * self.dt
        self.diagnostics.newton_iters += int(ni)
        self.diagnostics.krylov_iters += int(ki)
        self.diagnostics.mech_krylov_iters += mi
        self.elapsed_seconds = _time.time() - t_start

        def stack(xs, like):
            if xs:
                return torch.stack(xs)
            return like.new_empty((0,) + tuple(like.shape))

        result = {"times": stack(times, st.t)}
        for f in fields:
            result[f] = stack(snaps[f], getattr(st, f))
        return st, result

    def _retry_chunk(self, snapshot: ViscoState, n: int):
        """Rerun a failed n-step chunk at successively halved dt (2^level
        sub-chunks of n steps each) -> (state, newton, cg, elasticity CG);
        raise after solver.max_dt_halvings."""
        sc = self.config.solver
        dt = self.dt
        for level in range(1, sc.max_dt_halvings + 1):
            dt = dt / 2.0
            state = snapshot
            ok_all = True
            ni_tot = ki_tot = mi_tot = 0
            for _ in range(2 ** level):
                state, ok, ni, ki = self.multi_step(state, n, dt)
                ni_tot += int(ni)
                ki_tot += int(ki)
                mi_tot += sum(self.last_mech_iters)
                if not ok:
                    ok_all = False
                    break
            if ok_all:
                self.diagnostics.dt_halvings += level
                return state, ni_tot, ki_tot, mi_tot
        raise RuntimeError(
            f"Newton failed even after {sc.max_dt_halvings} dt halvings")

    def _finalize(self) -> None:
        for w in self._writers:
            w.close()

