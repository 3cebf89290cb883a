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

Ported: CG-1 and DG-1 temperature spaces; the matrix-free, assembled (ELL)
and, for CG-1 boxes, stencil Krylov operators; the Jacobi, geometric-MG
(CG-1 boxes), SA-AMG or no preconditioner; checkpoints. The default
constructor is the reference's default workload (DG-1 on the graded 1D
slab, matrix-free CG, SA-AMG). Mixed precision, the DG block stencil and
DG multigrid, CG-2 and equilibrium mechanics raise NotImplementedError
naming the slice of the port that brings them (ROADMAP.md).
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
from fem_glass_tempering_tpu_torch.fem.mesh import Mesh, reference_glass_mesh_1d
from fem_glass_tempering_tpu_torch.models.viscoelastic import (
    ViscoelasticEngine,
    ViscoState,
)
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.solver.newton import newton_solve


@dataclass
class StepDiagnostics:
    """Per-solve diagnostics: Newton and CG totals, convergence flag,
    output seconds, dt halvings taken."""

    newton_iters: int = 0
    krylov_iters: int = 0
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


def _waits(what: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{what} waits for {where} of the PyTorch "
                               f"port (ROADMAP.md)")


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
            raise _waits("reading gmsh files (read_msh)",
                         "the Slice 1 deferrals")
        else:
            self.mesh = reference_glass_mesh_1d()
        self.dim = self.mesh.tdim

        fe = run_cfg.fe
        if fe.T_degree != 1:
            raise _waits("a degree-2 temperature space", "Slice 4")
        if run_cfg.mechanics != "none":
            raise _waits("mechanics='equilibrium'", "Slice 5")
        sc = run_cfg.solver
        if sc.cg_dtype == "float32" and self.dtype == torch.float64:
            raise _waits("mixed precision (cg_dtype='float32' under f64)",
                         "the Slice 1 deferrals")
        if fe.T_family == "DG" and sc.linear_operator == "stencil":
            raise _waits("linear_operator='stencil' with a DG temperature "
                         "space (the DG block stencil)", "Slice 3")
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
        if (sc.preconditioner == "mg" and self.fs_T.family == "DG"
                and self.mesh.structured is not None):
            raise _waits("preconditioner='mg' with a DG temperature space "
                         "(DGMultigrid; pass preconditioner='amg' or "
                         "'jacobi' meanwhile)", "Slice 3")
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
        # host seconds of the setup's parts: "heat", and "ell" / "amg"
        # where an SA-AMG hierarchy is built
        self.setup_seconds: dict = {}
        t_setup = _time.perf_counter()
        self.heat = HeatOperator(
            self.fs_T, self.params, self.dt, dtype=self.dtype,
            device=self.device, bc_dofs=bc_dofs, bc_value=bc_val,
            quad_degree=self.config.fe.quad_degree,
            flux_marker=flux_marker, form=heat_form)
        self.setup_seconds["heat"] = _time.perf_counter() - t_setup
        # gather-free grid-native path when the mesh/space qualify
        self._grid = None
        if sc.grid_native != "off":
            from fem_glass_tempering_tpu_torch.ops.grid import GridHeatOperator
            try:
                self._grid = GridHeatOperator(self.heat,
                                              flux_marker=flux_marker)
            except ValueError:
                if sc.grid_native == "on":
                    raise
        self._mg = None
        if sc.preconditioner == "mg":
            if self.mesh.structured is None:
                raise ValueError(
                    "preconditioner='mg' needs a structured box mesh with a "
                    "CG-1 temperature space; use 'jacobi' otherwise")
            if sc.mg_table_dtype != "same":
                raise _waits("mg_table_dtype='bfloat16'",
                             "the Slice 1 deferrals")
            from fem_glass_tempering_tpu_torch.solver.multigrid import (
                GeometricMG,
            )

            def make_operator(level_mesh):
                fs = FunctionSpace(level_mesh, "CG", 1)
                bd = fs.boundary_scalar_dofs() if dirichlet_bc else None
                return HeatOperator(fs, self.params, self.dt,
                                    dtype=self.dtype, device=self.device,
                                    bc_dofs=bd, bc_value=bc_val,
                                    form=heat_form)

            self._mg = GeometricMG(self.mesh, make_operator,
                                   dtype=self.dtype,
                                   smoother=sc.mg_smoother,
                                   nu_pre=sc.mg_nu_pre,
                                   nu_post=sc.mg_nu_post,
                                   max_levels=sc.mg_max_levels,
                                   coarse=sc.mg_coarse)
            self._mg.freeze_omegas(None, self.dt)
        # smoothed-aggregation AMG (solver/amg.py): the mesh-agnostic GAMG
        # stand-in for unstructured meshes; hierarchy frozen at (T_0, dt)
        self._amg = None
        if sc.preconditioner == "amg":
            from fem_glass_tempering_tpu_torch.ops.spmv import EllMatrix
            from fem_glass_tempering_tpu_torch.solver.amg import (
                SmoothedAggregationMG,
            )
            T0v = torch.full((self.fs_T.n_scalar_dofs,), self.params.T_0,
                             dtype=self.dtype, device=self.device)
            t_ell = _time.perf_counter()
            ell = EllMatrix(self.heat)
            t_amg = _time.perf_counter()
            self._amg = SmoothedAggregationMG(ell, T0v, self.dt,
                                              dtype=self.dtype)
            self.setup_seconds["ell"] = t_amg - t_ell
            self.setup_seconds["amg"] = _time.perf_counter() - t_amg
        self.state = self.engine.init_state()
        self._build_step()
        if output_dir is not None:
            self.config = dataclasses.replace(
                self.config,
                output=dataclasses.replace(self.config.output, output_dir=output_dir))
        self._setup_writers()

    def _setup_writers(self) -> None:
        """Instantiate the configured output writers (the reference writes
        T, phi, Tf, xi and sigma, ThermoViscoProblem.py:246-276)."""
        self._writers = []
        oc = self.config.output
        if oc.write_every <= 0 or not oc.formats:
            return
        unsupported = [f for f in oc.formats if f != "npz"]
        if unsupported:
            raise _waits(f"output formats {unsupported}", "Slice 6")
        from fem_glass_tempering_tpu_torch.io.series import NPZSeriesWriter
        self._writers.append(
            NPZSeriesWriter(f"{oc.output_dir}/series.npz",
                            fields=oc.npz_fields))

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

    def _build_step(self) -> None:
        heat, engine, sc = self.heat, self.engine, self.config.solver
        mg = self._mg
        amg = self._amg
        grid = self._grid
        # the grid-native operator subsumes HeatOperator for residual/diag
        # and StencilMatrix for the Jacobian action
        hres = grid if grid is not None else heat
        ell = None
        if sc.linear_operator == "assembled":
            from fem_glass_tempering_tpu_torch.ops.spmv import EllMatrix
            ell = EllMatrix(heat)
        elif sc.linear_operator == "stencil":
            if grid is not None:
                ell = grid
            else:
                from fem_glass_tempering_tpu_torch.ops.stencil import (
                    StencilMatrix,
                )
                ell = StencilMatrix(heat)
        elif sc.linear_operator != "matrix_free":
            raise ValueError(f"unknown linear_operator {sc.linear_operator!r}")
        self._ell = ell
        if hres is heat:
            # the SIPG residual reads the interior-facet device tables
            # (a no-op unless the operator was built without them)
            heat.ensure_interior_tables()

        # the residual noise floor is a TPU emulated-f64 device: off here
        noise_rel = sc.newton_noise_rel or 0.0
        inc_forcing = sc.newton_inc_forcing
        if inc_forcing is None:
            inc_forcing = 0.05

        def build_ops(lin_state, dt):
            """Operator bundle at the chunk-start state. With jac_lag="step"
            the Krylov operator, the V-cycle and the Jacobi diagonal are
            frozen there (one build per step, or per jac_every chunk); with
            "newton" they are rebuilt at every Newton iterate."""
            state_T = lin_state.T
            precond_fn = matvec_fn = diag_fn = None
            if mg is not None:
                precond_fn = lambda T: mg.preconditioner(
                    mg.linearization_states(T), dt)
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
                # the per-step Jacobi diagonal scales the increment-relative
                # forcing (and the noise floor, when on)
                inc_diag = hres.jacobian_diag(state_T, dt)
                if noise_rel:
                    dd = inc_diag * state_T
                    floor = noise_rel * torch.sqrt(torch.dot(dd, dd))
                    noise_fn = lambda T: floor
            return dict(precond_fn=precond_fn, matvec_fn=matvec_fn,
                        diag_fn=diag_fn, noise_fn=noise_fn, inc_diag=inc_diag)

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
                cg_rtol=sc.cg_rtol, cg_atol=sc.cg_atol, cg_max_it=sc.cg_max_it,
                inc_forcing=inc_forcing, inc_diag=ops["inc_diag"],
            )
            new_state = engine.material_step(state, res.x, dt)
            finite = bool(torch.isfinite(res.x).all())
            return new_state, res.converged and finite, res.iters, res.krylov_iters

        # jac_every chunking applies to operators frozen per step
        jac_every = sc.resolved_jac_every() if sc.jac_lag == "step" else 1

        def multi_step(state: ViscoState, n: int, dt):
            ok, ni, ki = True, 0, 0
            for c0 in range(0, n, jac_every):
                # jac_every chunking: rebuild the frozen operator bundle
                # every jac_every steps (one step per chunk when 1)
                ops = build_ops(state, dt)
                for _ in range(min(jac_every, n - c0)):
                    state, conv, it, kit = step(state, dt, ops)
                    ok, ni, ki = ok and conv, ni + it, ki + kit
            return state, ok, ni, ki

        self._step_fn = step
        self._multi_step_fn = multi_step

    # ------------------------------------------------------------------
    def step(self, state: ViscoState, dt: float | None = None):
        """One coupled time step from `state` -> (state, converged,
        newton_iters, cg_iters). Does not touch self.state."""
        return self._step_fn(state, self.dt if dt is None else dt)

    def multi_step(self, state: ViscoState, n: int, dt: float | None = None):
        """n coupled steps from `state`, with the Krylov operator and the
        V-cycle rebuilt every `jac_every` steps -> (state, all converged,
        newton_iters, cg_iters). Does not touch self.state."""
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
            if not ok:
                if not adaptive:
                    raise RuntimeError(
                        f"Newton failed to converge in steps {done}..{done + n}")
                self.state, ni, ki = self._retry_chunk(snapshot, n)
            done += n
            self.t = self.time[0] + done * self.dt
            self.diagnostics.newton_iters += int(ni)
            self.diagnostics.krylov_iters += int(ki)
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

    def _retry_chunk(self, snapshot: ViscoState, n: int):
        """Rerun a failed n-step chunk at successively halved dt (2^level
        sub-chunks of n steps each); raise after solver.max_dt_halvings."""
        sc = self.config.solver
        dt = self.dt
        for level in range(1, sc.max_dt_halvings + 1):
            dt = dt / 2.0
            state = snapshot
            ok_all = True
            ni_tot = ki_tot = 0
            for _ in range(2 ** level):
                state, ok, ni, ki = self.multi_step(state, n, dt)
                ni_tot += int(ni)
                ki_tot += int(ki)
                if not ok:
                    ok_all = False
                    break
            if ok_all:
                self.diagnostics.dt_halvings += level
                return state, ni_tot, ki_tot
        raise RuntimeError(
            f"Newton failed even after {sc.max_dt_halvings} dt halvings")

    def _finalize(self) -> None:
        for w in self._writers:
            w.close()

