"""Matrix-free Newton with the 'incremental' convergence criterion.

Counterpart of fem_glass_tempering_tpu/solver/newton.py (the reference's
dolfinx NewtonSolver, ThermoViscoProblem.py:334-337: criterion
"incremental"). Each iteration assembles the residual, solves J dx = -F
with preconditioned CG (J action by `torch.func.jvp` of the residual
unless the caller supplies one), applies a full step, and declares
convergence when ||dx|| <= rtol * ||x|| + atol. A Python loop with one
host read per iteration for the convergence flag.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from fem_glass_tempering_tpu_torch.solver.krylov import _vdot, pcg


class NewtonResult(NamedTuple):
    x: torch.Tensor
    iters: int
    converged: bool
    increment_norm: torch.Tensor
    krylov_iters: int  # total CG iterations across Newton steps


def newton_solve(residual_fn: Callable, x0: torch.Tensor, *,
                 jac_diag_fn: Callable | None = None,
                 rtol: float = 1e-12, atol: float = 1e-10, max_it: int = 50,
                 cg_rtol: float = 1e-12, cg_atol: float = 0.0,
                 cg_max_it: int = 1000,
                 dot: Callable | None = None,
                 precond_fn: Callable | None = None,
                 matvec_fn: Callable | None = None,
                 cg_cast=None,
                 cg_replace_every: int | None = None,
                 cg_accept_rtol: float | None = None,
                 cg_stall_window: int | None = None,
                 mp_floor_inc_rtol: float | None = None,
                 inc_forcing: float = 0.0,
                 inc_diag: torch.Tensor | None = None,
                 noise_fn: Callable | None = None) -> NewtonResult:
    """Solve residual_fn(x) = 0 from x0 (the previous step's solution).

    `precond_fn(x)` builds a preconditioner apply at the iterate (takes
    precedence over jac_diag_fn); `matvec_fn(x)` builds the Jacobian
    action (default: jvp of the residual). `cg_cast` (e.g. torch.float32)
    runs the inner CG in that dtype on a normalised right-hand side while
    the residual, update and test stay in x's dtype. `cg_accept_rtol`
    accepts an increment whose inner solve reached ||r|| <= that fraction
    of ||b|| (None = auto: 0.1 under cg_cast, else strict).
    `cg_replace_every` / `cg_stall_window` are pcg's options (None = auto:
    50 / 100 under cg_cast, else off). `mp_floor_inc_rtol` declares a
    stalled mixed-precision solve converged once the increment is below
    that fraction of ||x|| (None = auto: 1e-6 under cg_cast, else off).
    `inc_forcing` > 0 runs each inner solve at the loosest tolerance whose
    increment error stays below that fraction of the acceptance threshold,
    predicting the increment from the Jacobi diagonal `inc_diag` (or
    jac_diag_fn). `noise_fn(x)` is an absolute floor for ||F|| below which
    the iterate is declared converged with dx = 0. The JAX version's
    docstring gives the reasoning and measurements for each option."""
    if dot is None:
        # the dot product of the flattened tensors (jnp.vdot's semantics),
        # so a vector-valued residual (ops/forms.py) needs no reshape
        dot = _vdot
    if cg_replace_every is None:
        cg_replace_every = 50 if cg_cast is not None else 0
    if cg_accept_rtol is None:
        cg_accept_rtol = 0.1 if cg_cast is not None else 0.0
    if cg_stall_window is None:
        cg_stall_window = 100 if cg_cast is not None else 0
    if mp_floor_inc_rtol is None:
        mp_floor_inc_rtol = 1e-6 if cg_cast is not None else 0.0

    def norm(v):
        return torch.sqrt(dot(v, v))

    x = x0
    k = 0
    converged = False
    dxn = torch.tensor(float("inf"), dtype=x0.dtype, device=x0.device)
    cg_total = 0
    while not converged and k < max_it:
        F = residual_fn(x)
        Fn = norm(F)
        if noise_fn is not None:
            at_floor = Fn <= noise_fn(x)
            # zero the RHS at the floor: CG exits at iteration 0 with
            # dx = 0, so the iterate is left untouched
            F = torch.where(at_floor, torch.zeros_like(F), F)
        else:
            at_floor = torch.zeros((), dtype=torch.bool, device=x.device)

        if matvec_fn is not None:
            matvec = matvec_fn(x)
        else:
            def matvec(v, x=x):
                return torch.func.jvp(residual_fn, (x,), (v,))[1]

        diag = jac_diag_fn(x) if jac_diag_fn is not None else None
        precond = precond_fn(x) if precond_fn is not None else None
        cg_rtol_k = cg_rtol
        pred_diag = inc_diag if inc_diag is not None else diag
        if inc_forcing and pred_diag is not None:
            dxp = norm(F / pred_diag.to(F.dtype))
            thr = rtol * norm(x) + atol
            tiny = torch.finfo(F.dtype).tiny
            cg_rtol_k = torch.clamp(
                inc_forcing * thr / torch.clamp(dxp, min=tiny),
                min=cg_rtol, max=0.5)
        if cg_cast is not None:
            scale = torch.where((Fn == 0) | at_floor, torch.ones_like(Fn), Fn)
            b = (-F / scale).to(cg_cast)
            lin = pcg(matvec, b, diag=diag, rtol=cg_rtol_k, atol=cg_atol,
                      max_it=cg_max_it, dot=dot, precond=precond,
                      replace_every=cg_replace_every,
                      stall_window=cg_stall_window)
            dx = lin.x.to(x.dtype) * scale
            bn = norm(b)
        else:
            lin = pcg(matvec, -F, diag=diag, rtol=cg_rtol_k, atol=cg_atol,
                      max_it=cg_max_it, dot=dot, precond=precond,
                      replace_every=cg_replace_every,
                      stall_window=cg_stall_window)
            dx = lin.x
            bn = Fn
        x_new = x + dx
        dxn = norm(dx)
        # demand that the inner CG met its tolerance: a failed linear solve
        # inflates ||x_new|| and would fool the incremental test
        solve_ok = torch.tensor(lin.converged, device=x.device)
        if cg_accept_rtol:
            solve_ok = solve_ok | (lin.residual_norm <= cg_accept_rtol * bn)
        xn_new = norm(x_new)
        conv = at_floor | ((dxn <= rtol * xn_new + atol) & solve_ok)
        if mp_floor_inc_rtol and not lin.converged:
            stalled = lin.residual_norm >= 0.5 * bn
            conv = conv | (stalled & (dxn <= mp_floor_inc_rtol * xn_new))
        x = x_new
        k += 1
        cg_total += lin.iters
        converged = bool(conv)
    return NewtonResult(x=x, iters=k, converged=converged,
                        increment_norm=dxn, krylov_iters=cg_total)
