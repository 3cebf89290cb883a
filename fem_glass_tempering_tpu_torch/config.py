"""Typed configuration for the tempering solver.

The same dataclasses, fields and defaults as the JAX package's
`fem_glass_tempering_tpu/config.py`, so a configuration serialised by one
package loads in the other. The reference driver's plain dicts
(reference main.py:6-55) map onto these in `models/problem.py`.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Any


_VALID_FAMILIES = ("CG", "DG")


@dataclass(frozen=True)
class FEConfig:
    """Finite-element choice per field (reference main.py:24-27).

    family: 'CG' (continuous Lagrange) or 'DG' (discontinuous Lagrange;
    the heat equation then gets SIPG interior-penalty facet terms,
    reference ThermoViscoProblem.py:308-326).
    """

    T_family: str = "DG"
    T_degree: int = 1
    sigma_family: str = "CG"
    sigma_degree: int = 1
    # override the automatic quadrature degree (cell: 2p+1, boundary: 5p
    # for the T^4 radiation integrand); None = automatic
    quad_degree: int | None = None

    def __post_init__(self) -> None:
        for fam in (self.T_family, self.sigma_family):
            if fam not in _VALID_FAMILIES:
                raise ValueError(
                    f"Only CG and DG elements are supported, got {fam!r}"
                )
        if self.T_degree < 1 or self.sigma_degree < 1:
            raise ValueError("element degree must be >= 1")


@dataclass(frozen=True)
class TimeConfig:
    """Time domain (reference main.py:11-16)."""

    t_start: float = 0.0
    t_end: float = 50.0
    dt: float = 0.1

    @property
    def n_steps(self) -> int:
        """ceil((t_end - t_start)/dt), with an epsilon so fp noise in
        t_end = n*dt round-trips to exactly n."""
        return math.ceil((self.t_end - self.t_start) / self.dt - 1e-9)


@dataclass(frozen=True)
class ModelParams:
    """Physical parameters (reference main.py:29-55).

    Names match the reference's model_params dict, quirks included: rho/cp/k
    are carried but unused by the 'reference' heat form, and the radiation/
    convection boundary terms carry a 0.001 scale factor.
    """

    f: float = 0.0            # volumetric heat source
    epsilon: float = 0.93     # radiative emissivity
    sigma: float = 5.670e-8   # Stefan-Boltzmann constant
    T_ambient: float = 600.0  # ambient temperature [K]
    T_0: float = 800.0        # initial temperature [K]
    alpha: float = 1.0        # diffusion coefficient in the weak form
    htc: float = 280.1        # convective heat transfer coefficient
    rho: float = 2500.0       # density (unused in the reference form)
    cp: float = 1433.0        # specific heat (unused in the reference form)
    k: float = 1.0            # conductivity (unused in the reference form)
    H: float = 627.8e3        # activation energy [J/mol]
    Tb: float = 869.0         # base temperature [K]
    Rg: float = 8.314         # universal gas constant
    alpha_solid: float = 9.10e-6
    alpha_liquid: float = 25.10e-6
    Tf_init: float = 873.0    # carried for parity; ICs use T_0
    chi: float = 0.5          # TN weighting (reference ViscoelasticModel.py:15)
    boundary_scale: float = 0.001  # reference ThermoViscoProblem.py:302-304
    dg_penalty: float = 5.0   # SIPG penalty (reference ThermoViscoProblem.py:313)


@dataclass(frozen=True)
class SolverConfig:
    """Newton-Krylov settings (reference ThermoViscoProblem.py:330-346).
    Each field is documented at length in the JAX package's config."""

    newton_rtol: float = 1e-12   # incremental criterion rtol
    newton_atol: float = 1e-10
    newton_max_it: int = 50
    cg_rtol: float = 1e-12
    cg_atol: float = 0.0
    cg_max_it: int = 10000
    # 'auto' resolves at setup: geometric MG on structured box meshes with
    # a degree-1 T space, SA-AMG elsewhere
    preconditioner: str = "auto"  # 'auto' | 'jacobi' | 'mg' | 'amg' | 'none'
    mg_smoother: str = "jacobi"     # 'jacobi' | 'chebyshev'
    mg_nu_pre: int = 2
    mg_nu_post: int = 2
    # cap on the geometric-MG hierarchy depth (0 = coarsen to the floor)
    mg_max_levels: int = 0
    # coarsest-level solve: 'auto' stops at the first level <= 4096 nodes
    # and solves it exactly with a frozen dense inverse; 'smooth' = fixed
    # sweeps at the full-depth floor; 'dense' = dense inverse at an
    # explicit mg_max_levels cap
    mg_coarse: str = "auto"
    # dtype the V-cycle's per-level value tables stream in
    mg_table_dtype: str = "same"    # 'same' | 'bfloat16'
    dg_smoother: str = "auto"
    # 'matrix_free' = jvp-of-residual matvec; 'assembled' = ELL SpMV;
    # 'stencil' = lattice stencil on structured box meshes
    linear_operator: str = "matrix_free"
    # grid-native residual/diagonal/Jacobian path for CG-1 on uniform box
    # meshes: 'auto' | 'on' (raise if the mesh does not qualify) | 'off'
    grid_native: str = "auto"
    # 'float32' with dtype='float64': inner CG in f32, Newton in f64
    cg_dtype: str = "same"          # 'same' | 'float32'
    # residual noise floor relative to ||diag(J) * T||; None = auto (on
    # only for mixed precision on a TPU, so off in this package)
    newton_noise_rel: float | None = None
    # increment-relative inexact-Newton forcing; None = auto (0.05), 0 = off
    newton_inc_forcing: float | None = None
    # "step": freeze the Krylov operator + V-cycle once per time step (or
    # per jac_every chunk); "newton": rebuild at every Newton iterate
    jac_lag: str = "step"
    # rebuild cadence of the frozen operator with jac_lag="step";
    # "auto" = 1 when newton_rtol <= 1e-10, else 5
    jac_every: int | str = "auto"

    def resolved_jac_every(self) -> int:
        """Resolve jac_every='auto' by Newton tolerance (see field doc)."""
        je = self.jac_every
        if je == "auto":
            je = 1 if self.newton_rtol <= 1e-10 else 5
        return max(int(je), 1)
    # equilibrium-mechanics increment-relative CG tolerance; None = auto
    mech_inc_rtol: float | None = None
    # failure handling: 'raise' | 'halve_dt' (retry the failed chunk at dt/2)
    on_failure: str = "raise"
    max_dt_halvings: int = 4


@dataclass(frozen=True)
class OutputConfig:
    """Output/checkpoint settings (the reference writes every step,
    ThermoViscoProblem.py:374)."""

    output_dir: str = "output"
    write_every: int = 1          # steps between field snapshots (0 = off)
    formats: tuple = ("npz",)     # subset of ('npz', 'vtu', 'xdmf')
    checkpoint_every: int = 0      # steps between checkpoints (0 = off)
    # fields recorded by the npz series writer (any ViscoState field name)
    npz_fields: tuple = ("T", "Tf", "phi", "xi", "sigma")


@dataclass(frozen=True)
class RunConfig:
    """Top-level bundle."""

    fe: FEConfig = field(default_factory=FEConfig)
    time: TimeConfig = field(default_factory=TimeConfig)
    params: ModelParams = field(default_factory=ModelParams)
    solver: SolverConfig = field(default_factory=SolverConfig)
    output: OutputConfig = field(default_factory=OutputConfig)
    # 'reference' reproduces the reference's runtime semantics, quirks
    # included (models/viscoelastic.py docstring); 'corrected' uses the
    # literature (Nielsen et al.) semantics
    physics_mode: str = "reference"
    # 'eq5' Arrhenius (the reference's live definition) | 'eq25' chi-weighted TN
    shift_function: str = "eq5"
    # 'none' reproduces the reference (total strain = -thermal strain);
    # 'equilibrium' solves quasi-static mechanical equilibrium each step
    mechanics: str = "none"
    # 'reference': xi = dt/2 (phi_next - phi) as the reference codes eq. 19;
    # 'trapezoid': the physical dt/2 (phi_next + phi)
    xi_formula: str = "reference"
    # 'reference': non-dimensionalised heat form (mass 1, diffusion alpha);
    # 'physical': the dimensional rho*cp / k equation
    heat_form: str = "reference"
    dtype: str = "float64"
    # kept for parity with the JAX package; in this package the hand
    # kernels are the CUDA path whatever its value
    use_pallas: bool | str = "auto"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "RunConfig":
        raw: dict[str, Any] = json.loads(text)
        return RunConfig(
            fe=FEConfig(**raw.get("fe", {})),
            time=TimeConfig(**raw.get("time", {})),
            params=ModelParams(**raw.get("params", {})),
            solver=SolverConfig(**raw.get("solver", {})),
            output=OutputConfig(
                **{
                    k: tuple(v) if k in ("formats", "npz_fields") else v
                    for k, v in raw.get("output", {}).items()
                }
            ),
            physics_mode=raw.get("physics_mode", "reference"),
            shift_function=raw.get("shift_function", "eq5"),
            mechanics=raw.get("mechanics", "none"),
            xi_formula=raw.get("xi_formula", "reference"),
            heat_form=raw.get("heat_form", "reference"),
            dtype=raw.get("dtype", "float64"),
            use_pallas=raw.get("use_pallas", "auto"),
        )


def default_model_params() -> ModelParams:
    """The reference's default parameter set (reference main.py:29-55)."""
    return ModelParams()
