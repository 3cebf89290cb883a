"""The custom-PDE surface of the port (ops/forms.py, solver/direct.py)
against the JAX package, on the CPU in f64.

Mirrors tests/test_forms.py case for case, and
tests/test_cli_and_misc.py::test_direct_newton_matches_krylov. Every case
asserts what the JAX test asserts, on the port; and holds the port's
residual to JAX's form on the same inputs within 1e-12 of its largest
entry, and its Newton count (and solution, within 1e-10 of max) to JAX's
where the case solves. The CG totals of the unpreconditioned solves at
rtol 1e-12 stop on their last bits and are held within 2%.
"""

import dataclasses

import jax  # noqa: F401  (JAX on the CPU, x64, via tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.config import ModelParams as JParams
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.ops import forms as jforms
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.solver.direct import newton_direct as j_direct
from fem_glass_tempering_tpu.solver.newton import newton_solve as j_newton
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.ops import forms as tforms
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.solver.direct import (
    materialize_jacobian,
    newton_direct,
)
from fem_glass_tempering_tpu_torch.solver.newton import newton_solve

P = ModelParams()
DT = 0.1


def _near(a, b, tol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), np.abs(a - b).max()


def _heat_callables(p, dt, flux=True):
    """The tempering heat integrands (tests/test_forms.py:32-40); they
    take torch tensors and JAX arrays alike."""
    kw = dict(
        cell_source=lambda u, gu, x, Tp=None: u - Tp - dt * p.f,
        cell_flux=lambda u, gu, x, Tp=None: dt * p.alpha * gu)
    if flux:
        kw["boundary_flux"] = lambda u, x, n, Tp=None: (
            dt * p.boundary_scale * (p.sigma * p.epsilon
                                     * (u**4 - p.T_ambient**4)
                                     + p.htc * (u - p.T_ambient)))
    return kw


def test_forms_reproduce_heat_operator():
    """The generic layer with the tempering integrands == HeatOperator
    (CG path; the boundary term at HeatOperator's quadrature degree 5)."""
    m = tmesh.box_mesh_2d(5, 4)
    fs = FunctionSpace(m, "CG", 1)
    rng = np.random.default_rng(0)
    T = torch.tensor(700 + 100 * rng.random(fs.n_scalar_dofs))
    T_prev = torch.tensor(700 + 100 * rng.random(fs.n_scalar_dofs))
    noflux = dataclasses.replace(P, epsilon=0.0, htc=0.0, sigma=0.0)
    op_noflux = HeatOperator(fs, noflux, dt=DT, device="cpu")
    form_noflux = tforms.ScalarResidualForm(
        fs, **_heat_callables(P, DT, flux=False), device="cpu")
    r1 = op_noflux.residual(T, T_prev)
    r2 = form_noflux.residual(T, Tp=T_prev[form_noflux.dofmap]
                              @ form_noflux.phi.T)
    np.testing.assert_allclose(r2.numpy(), r1.numpy(), rtol=1e-12)
    form_b = tforms.ScalarResidualForm(
        fs, **_heat_callables(P, DT), quad_degree=5, device="cpu")
    r3 = form_b.residual(T, Tp=T_prev[form_b.dofmap] @ form_b.phi.T)
    r_op = HeatOperator(fs, P, dt=DT, device="cpu").residual(T, T_prev)
    np.testing.assert_allclose(r3.numpy(), r_op.numpy(), rtol=1e-11)
    # against JAX's form on the same inputs
    jfs = JFS(jmesh.box_mesh_2d(5, 4), "CG", 1)
    jform = jforms.ScalarResidualForm(jfs, **_heat_callables(JParams(), DT),
                                      quad_degree=5)
    jT, jTp = jnp.asarray(T.numpy()), jnp.asarray(T_prev.numpy())
    _near(r3, jform.residual(jT, Tp=jTp[jform.dofmap] @ jform.phi.T))


def _elastic_case(xp, d, arrays):
    """The elastic-stress flux in the array module `xp` (torch or
    jax.numpy) and its keyword arrays."""
    _, sig_h, eps0, G, K = arrays

    def stress_flux(uq, guq, xq, *, sig_h, eps0, G, K):
        eps = 0.5 * (guq + xp.swapaxes(guq, -1, -2)) - eps0
        tr = eps.diagonal(0, -2, -1).sum(-1) if xp is torch else \
            jnp.trace(eps, axis1=-2, axis2=-1)
        eye = (torch.eye(d, dtype=uq.dtype) if xp is torch
               else jnp.eye(d, dtype=uq.dtype))
        dev = eps - (tr / d)[..., None, None] * eye
        return (sig_h + 2.0 * G[..., None, None] * dev
                + K[..., None, None] * tr[..., None, None] * eye)
    return stress_flux, dict(sig_h=sig_h, eps0=eps0, G=G, K=K)


def test_vector_form_reproduces_elasticity_operator():
    """The generic vector form with the elastic-stress integrand ==
    ops/elasticity.py's residual, and == JAX's vector form."""
    from fem_glass_tempering_tpu.ops.elasticity import (
        ElasticityOperator as JElast,
    )
    from fem_glass_tempering_tpu_torch.ops.elasticity import (
        ElasticityOperator,
    )

    m = tmesh.box_mesh_3d(4, 3, 2, 1.0, 1.0, 0.01)
    fs_sig = FunctionSpace(m, "CG", 1, value_shape=(3, 3))
    el = ElasticityOperator(fs_sig, device="cpu")
    d = el.d
    rng = np.random.default_rng(3)
    C, Q = el.qw.shape
    u = rng.standard_normal((el.n, d))
    u = np.where(el.pin_mask.numpy() > 0, 0.0, u)
    sh = rng.standard_normal((C, Q, d, d))
    sh = 0.5 * (sh + np.swapaxes(sh, -1, -2))
    eps0 = rng.standard_normal((C, Q))[..., None, None] * np.eye(d)
    G = 1.0 + rng.random((C, Q))
    K = 2.0 + rng.random((C, Q))
    arrs = [torch.tensor(a) for a in (u, sh, eps0, G, K)]
    flux, kw = _elastic_case(torch, d, arrs)
    form = tforms.VectorResidualForm(
        fs_sig, value_shape=(d,), cell_flux=flux,
        pin_mask=el.pin_mask.numpy(), pin_values=0.0, device="cpu")
    r_form = form.residual(arrs[0], **kw)
    r_op = el.residual(*arrs)
    np.testing.assert_allclose(r_form.numpy(), r_op.numpy(), rtol=1e-13,
                               atol=1e-14)
    jel = JElast(JFS(jmesh.box_mesh_3d(4, 3, 2, 1.0, 1.0, 0.01), "CG", 1,
                     value_shape=(3, 3)))
    jarrs = [jnp.asarray(a) for a in (u, sh, eps0, G, K)]
    jflux, jkw = _elastic_case(jnp, d, jarrs)
    jform = jforms.VectorResidualForm(
        jel.fs, value_shape=(d,), cell_flux=jflux,
        pin_mask=np.asarray(jel.pin_mask), pin_values=0.0)
    _near(r_form, jform.residual(jarrs[0], **jkw))


def _vector_poisson(xp, fs):
    bd = fs.boundary_scalar_dofs()
    pin = np.zeros((fs.n_scalar_dofs, 2))
    pin[np.asarray(bd)] = 1.0

    def source(uq, guq, xq):
        f0 = -2 * np.pi**2 * xp.sin(np.pi * xq[..., 0]) \
            * xp.sin(np.pi * xq[..., 1])
        f1 = -2 * (xq[..., 0] * (1 - xq[..., 0])
                   + xq[..., 1] * (1 - xq[..., 1]))
        return -xp.stack([f0, f1], -1)

    kw = dict(value_shape=(2,),
              cell_source=lambda uq, guq, xq: -source(uq, guq, xq),
              cell_flux=lambda uq, guq, xq: guq,
              pin_mask=pin, pin_values=0.0, quad_degree=6)
    if xp is torch:
        return tforms.VectorResidualForm(fs, **kw, device="cpu")
    return jforms.VectorResidualForm(fs, **kw)


def test_vector_form_solves_vector_poisson_mms():
    """Vector Laplace MMS through the generic layer: -Δu_a = f_a with
    u_exact = (sin(pi x) sin(pi y), x(1-x)y(1-y)), Dirichlet pins; the
    Newton and CG counts equal JAX's."""
    fs = FunctionSpace(tmesh.box_mesh_2d(16, 16), "CG", 2)
    x = fs.dof_coords
    u_ex = np.stack([
        np.sin(np.pi * x[:, 0]) * np.sin(np.pi * x[:, 1]),
        x[:, 0] * (1 - x[:, 0]) * x[:, 1] * (1 - x[:, 1])], axis=1)
    form = _vector_poisson(torch, fs)
    res = newton_solve(form.residual,
                       torch.zeros((fs.n_scalar_dofs, 2),
                                   dtype=torch.float64),
                       rtol=1e-12, cg_rtol=1e-12, cg_max_it=4000)
    assert res.converged
    err = np.abs(res.x.numpy() - u_ex).max()
    assert err < 5e-5, err
    jfs = JFS(jmesh.box_mesh_2d(16, 16), "CG", 2)
    jform = _vector_poisson(jnp, jfs)
    jres = j_newton(jform.residual, jnp.zeros((jfs.n_scalar_dofs, 2)),
                    rtol=1e-12, cg_rtol=1e-12, cg_max_it=4000)
    # unpreconditioned CG at rtol 1e-12 stops on its last bits: the CG
    # totals are held to 2% (174 against 172 on one x86 CPU)
    assert res.iters == int(jres.iters)
    assert abs(res.krylov_iters - int(jres.krylov_iters)) <= 0.02 * int(
        jres.krylov_iters)
    _near(res.x, jres.x, 1e-10)


def _reaction_diffusion(xp, fs):
    bd = fs.boundary_scalar_dofs()
    kw = dict(
        cell_source=lambda u, gu, xq: u**3 - (
            np.pi**2 * xp.sin(np.pi * xq[..., 0])
            + xp.sin(np.pi * xq[..., 0])**3),
        cell_flux=lambda u, gu, xq: gu,
        bc_dofs=bd, bc_values=0.0, quad_degree=8)
    if xp is torch:
        return tforms.ScalarResidualForm(fs, **kw, device="cpu")
    return jforms.ScalarResidualForm(fs, **kw)


def test_forms_nonlinear_reaction_diffusion_mms():
    """-Δu + u^3 = f with u_exact = sin(pi x) on [0, 1], Dirichlet,
    solved entirely through the generic layer; counts equal JAX's."""
    fs = FunctionSpace(tmesh.interval_mesh(64), "CG", 2)
    x = fs.dof_coords[:, 0]
    form = _reaction_diffusion(torch, fs)
    res = newton_solve(form.residual,
                       torch.zeros(fs.n_scalar_dofs, dtype=torch.float64),
                       rtol=1e-12, cg_rtol=1e-13, cg_max_it=2000)
    assert res.converged
    err = np.abs(res.x.numpy() - np.sin(np.pi * x)).max()
    assert err < 2e-5, err
    jform = _reaction_diffusion(jnp, JFS(jmesh.interval_mesh(64), "CG", 2))
    jres = j_newton(jform.residual, jnp.zeros(fs.n_scalar_dofs),
                    rtol=1e-12, cg_rtol=1e-13, cg_max_it=2000)
    assert res.iters == int(jres.iters)
    _near(res.x, jres.x, 1e-10)
    u = torch.tensor(np.random.default_rng(1).standard_normal(
        fs.n_scalar_dofs))
    _near(form.residual(u), jform.residual(jnp.asarray(u.numpy())))


def _sipg(p, coef, jump, avg):
    def sipg(up, um, dup, dum, x, n, h, **_):
        j = jump(up, um)
        ad = avg(dup, dum)
        ph = (p / h)[:, None]
        return (coef * (ph * j - ad), coef * (-ph * j + ad),
                -coef * 0.5 * j, -coef * 0.5 * j)
    return sipg


def test_forms_interior_flux_reproduces_heat_sipg():
    """The interior-facet surface (dS / jump / avg) reproduces the SIPG DG
    heat residual of ops/heat.py, and equals JAX's form."""
    fs = FunctionSpace(tmesh.box_mesh_2d(6, 5), "DG", 1)
    qd = 3
    op = HeatOperator(fs, P, dt=DT, quad_degree=qd, device="cpu")
    rng = np.random.default_rng(7)
    T = torch.tensor(700 + 100 * rng.random(fs.n_scalar_dofs))
    T_prev = torch.tensor(700 + 100 * rng.random(fs.n_scalar_dofs))
    coef = DT * P.alpha
    form = tforms.ScalarResidualForm(
        fs, **_heat_callables(P, DT),
        interior_flux=_sipg(P.dg_penalty, coef, tforms.jump, tforms.avg),
        quad_degree=qd, device="cpu")
    r_form = form.residual(T, Tp=T_prev[form.dofmap] @ form.phi.T)
    r_op = op.residual(T, T_prev)
    np.testing.assert_allclose(r_form.numpy(), r_op.numpy(), rtol=1e-11,
                               atol=1e-13)
    jfs = JFS(jmesh.box_mesh_2d(6, 5), "DG", 1)
    jform = jforms.ScalarResidualForm(
        jfs, **_heat_callables(JParams(), DT),
        interior_flux=_sipg(P.dg_penalty, coef, jforms.jump, jforms.avg),
        quad_degree=qd)
    jT, jTp = jnp.asarray(T.numpy()), jnp.asarray(T_prev.numpy())
    _near(r_form, jform.residual(jT, Tp=jTp[jform.dofmap] @ jform.phi.T))


def test_forms_dg_sipg_poisson_mms():
    """User-level SIPG: -u'' + u = f, natural BCs, u_exact = cos(pi x),
    DG-1 at n = 32 and 64: second-order convergence, counts equal JAX's."""
    errs = []
    for n in (32, 64):
        out = {}
        for xp, fmod, mmod, fsc, solve in (
                (torch, tforms, tmesh, FunctionSpace, newton_solve),
                (jnp, jforms, jmesh, JFS, j_newton)):
            fs = fsc(mmod.interval_mesh(n), "DG", 1)
            kw = dict(
                cell_source=lambda u, gu, xq, xp=xp: u - (
                    np.pi**2 + 1.0) * xp.cos(np.pi * xq[..., 0]),
                cell_flux=lambda u, gu, xq: gu,
                interior_flux=_sipg(10.0, 1.0, fmod.jump, fmod.avg),
                quad_degree=4)
            if xp is torch:
                form = fmod.ScalarResidualForm(fs, **kw, device="cpu")
                x0 = torch.zeros(fs.n_scalar_dofs, dtype=torch.float64)
            else:
                form = fmod.ScalarResidualForm(fs, **kw)
                x0 = jnp.zeros(fs.n_scalar_dofs)
            res = solve(form.residual, x0, rtol=1e-12, cg_rtol=1e-13,
                        cg_max_it=4000)
            assert bool(res.converged)
            out[xp.__name__] = (np.asarray(res.x), int(res.iters),
                                int(res.krylov_iters), fs)
        (x_t, it_t, k_t, fs), (x_j, it_j, k_j, _) = (out["torch"],
                                                     out["jax.numpy"])
        assert it_t == it_j and abs(k_t - k_j) <= 0.02 * k_j, (it_t, it_j,
                                                                k_t, k_j)
        _near(x_t, x_j, 1e-10)
        u_ex = np.cos(np.pi * fs.dof_coords[:, 0])
        errs.append(np.abs(x_t - u_ex).max())
    assert errs[1] < 2e-3, errs
    assert errs[0] / errs[1] > 3.0, errs


def test_direct_newton_matches_krylov():
    """Dense Newton == matrix-free Newton-CG on a real nonlinear tempering
    step (the 1D validation slab, DG-1), and == JAX's dense Newton."""
    fs = FunctionSpace(tmesh.reference_glass_mesh_1d(), "DG", 1)
    op = HeatOperator(fs, P, dt=DT, device="cpu")
    T_prev = torch.full((fs.n_scalar_dofs,), P.T_0, dtype=torch.float64)
    res_fn = lambda T: op.residual(T, T_prev)  # noqa: E731
    x_d, it_d, conv_d = newton_direct(res_fn, T_prev)
    res_k = newton_solve(res_fn, T_prev, jac_diag_fn=op.jacobian_diag)
    assert conv_d and res_k.converged
    np.testing.assert_allclose(x_d.numpy(), res_k.x.numpy(), rtol=1e-10)
    jfs = JFS(jmesh.reference_glass_mesh_1d(), "DG", 1)
    jop = JHeat(jfs, JParams(), dt=DT)
    jT_prev = jnp.full(jfs.n_scalar_dofs, P.T_0)
    xj, itj, convj = j_direct(lambda T: jop.residual(T, jT_prev), jT_prev)
    assert bool(convj) and it_d == int(itj)
    _near(x_d, xj, 1e-12)
    # the materialised Jacobian is the jvp columns of the residual
    J = materialize_jacobian(res_fn, T_prev)
    e3 = torch.zeros_like(T_prev)
    e3[3] = 1.0
    col = torch.func.jvp(res_fn, (T_prev,), (e3,))[1]
    assert torch.equal(J[:, 3], col)


def test_forms_default_to_the_card():
    """Like every entry point of the port, a form runs on the card unless
    the caller asks for the CPU."""
    fs = FunctionSpace(tmesh.interval_mesh(4), "CG", 1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tforms.ScalarResidualForm(fs, cell_flux=lambda u, gu, x: gu)
