"""Matrix-free preconditioned conjugate gradients.

Counterpart of fem_glass_tempering_tpu/solver/krylov.py (the reference's
PETSc KSP CG, ThermoViscoProblem.py:339-346). The JAX version is a
lax.while_loop; here it is a Python loop that reads the residual norm
back to the host once per iteration for the convergence test. All other
arithmetic, comparisons included, stays in the vectors' dtype, so the
iteration counts follow the JAX version's. Convergence follows PETSc's
default test ||r||_2 < max(rtol*||b||, atol).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class PCGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    converged: bool
    residual_norm: torch.Tensor


def _vdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """jnp.vdot's semantics: the dot product of the flattened tensors."""
    return torch.dot(u.reshape(-1), v.reshape(-1))


def pcg(matvec: Callable, b: torch.Tensor, *, x0: torch.Tensor | None = None,
        diag: torch.Tensor | None = None, rtol=1e-12,
        atol: float = 0.0, max_it: int = 1000,
        dot: Callable | None = None,
        precond: Callable | None = None,
        replace_every: int = 0,
        stall_window: int = 0,
        rtol_r0: float = 0.0) -> PCGResult:
    """`dot` overrides the inner product (default: the dot product of the
    flattened tensors, so grid-shaped vectors need no reshape). `precond`
    is a general SPD preconditioner apply r -> M^{-1} r (e.g. a multigrid
    V-cycle) and takes precedence over `diag` (Jacobi). `rtol` may be a
    0-d tensor.

    `replace_every` > 0 recomputes the true residual b - A x every that
    many iterations (the search direction is kept). `stall_window` > 0
    tracks the best iterate and exits once the residual norm has not
    improved for that many iterations, returning the best iterate.
    `rtol_r0` > 0 is the increment-relative test: when the warm start is
    warm (||r0|| < 0.3 ||b||) the tolerance is at least rtol_r0 ||r0||.
    See the JAX version's docstring for the measurements behind each."""
    if dot is None:
        dot = _vdot

    def norm(v):
        return torch.sqrt(dot(v, v))

    x = torch.zeros_like(b) if x0 is None else x0
    inv_diag = None if diag is None else 1.0 / diag

    def apply_M(r):
        if precond is not None:
            return precond(r)
        return r if inv_diag is None else inv_diag * r

    r = b - matvec(x)
    z = apply_M(r)
    p = z
    rz = dot(r, z)
    bnorm = norm(b)
    rnorm = norm(r)
    tol = torch.clamp(rtol * bnorm, min=atol)
    if rtol_r0:
        warm = rnorm < 0.3 * bnorm
        tol = torch.maximum(tol, torch.where(warm, rtol_r0 * rnorm,
                                             torch.zeros_like(rnorm)))
    use_best = stall_window > 0
    bx, brn, kb = x, rnorm, 0
    k = 0
    while k < max_it and bool(rnorm > tol):
        if use_best and k - kb >= stall_window:
            break
        Ap = matvec(p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, torch.ones_like(pAp), pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        if replace_every and (k + 1) % replace_every == 0:
            r = b - matvec(x)
        z = apply_M(r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz == 0, torch.ones_like(rz), rz)
        p = z + beta * p
        rz = rz_new
        rnorm = norm(r)
        k += 1
        if use_best and bool(rnorm < brn):
            bx, brn, kb = x, rnorm, k
    if use_best:
        x, rnorm = bx, brn
    return PCGResult(x=x, iters=k, converged=bool(rnorm <= tol),
                     residual_norm=rnorm)
