"""The DG-1/SIPG heat operator of the PyTorch port against the JAX
package's HeatOperator, on the CPU in f64: residual, exact Jacobi diagonal
and forward-mode Jacobian action, on the 1D reference slab (per-cell
tables), a 2D quad box and a 3x3x2 hex box (uniform tables) and a 2D
triangle mesh (per-cell tables), in both heat forms, with a Dirichlet mask
and with a source field.

Tolerance: rtol 1e-12 of max|value| per array. Both sides run the same
formulas on numpy-identical tables; what differs is the order of a few
short sums (XLA's einsum vs ATen's) and of the scatter-adds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.config import ModelParams as JParams
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace as TFS
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator as THeat

MESHES = {
    "slab1d": lambda m: m.reference_glass_mesh_1d(),
    "quad2d": lambda m: m.box_mesh_2d(4, 3, 1.0, 0.5),
    "hex3d": lambda m: m.box_mesh_3d(3, 3, 2, 1.0, 1.0, 0.01),
    "tri2d": lambda m: m.box_mesh_2d(4, 3, cell_type="triangle"),
}


def _pair(name, fam="DG", dirichlet=False, source=False, **kw):
    jm, tm = MESHES[name](jmesh), MESHES[name](tmesh)
    jfs, tfs = JFS(jm, fam, 1), TFS(tm, fam, 1)
    np.testing.assert_array_equal(jfs.dofmap, tfs.dofmap)
    extra = {}
    if dirichlet:
        extra.update(bc_dofs=jfs.boundary_scalar_dofs(), bc_value=600.0)
    if source:
        extra["source"] = np.sin(3.0 * jfs.dof_coords[:, 0]) + 0.5
    jh = JHeat(jfs, JParams(), 0.1, **extra, **kw)
    th = THeat(tfs, ModelParams(), 0.1, device="cpu", **extra, **kw)
    return jh, th


def _close(a, b, what, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= rtol * np.abs(b).max(), (
        what, float(np.abs(a - b).max()), float(np.abs(b).max()))


def _fields(n, seed=0):
    rng = np.random.default_rng(seed)
    return (700 + 100 * rng.random(n), 700 + 100 * rng.random(n),
            rng.standard_normal(n))


def _check(jh, th, dt=None):
    T, Tp, v = _fields(jh.n_dofs)
    jT, jTp, jv = jnp.asarray(T), jnp.asarray(Tp), jnp.asarray(v)
    tT, tTp, tv = torch.tensor(T), torch.tensor(Tp), torch.tensor(v)
    _close(th.residual(tT, tTp, dt).numpy(), jh.residual(jT, jTp, dt),
           "residual")
    _close(th.jacobian_diag(tT, dt).numpy(), jh.jacobian_diag(jT, dt), "diag")
    jj = jax.jvp(lambda u: jh.residual(u, jTp, dt), (jT,), (jv,))[1]
    tj = torch.func.jvp(lambda u: th.residual(u, tTp, dt), (tT,), (tv,))[1]
    _close(tj.numpy(), jj, "jvp")
    return tT, tTp, tv, tj


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("form", ["reference", "physical"])
def test_dg_operator_matches_jax(name, form):
    jh, th = _pair(name, form=form)
    assert th.is_dg and th.uniform == (name in ("quad2d", "hex3d"))
    for k, a in jh.np_i.items():
        np.testing.assert_array_equal(th.np_i[k], a, err_msg=k)
    _check(jh, th)


@pytest.mark.parametrize("name", ["slab1d", "hex3d"])
def test_dg_operator_with_dirichlet_mask(name):
    _check(*_pair(name, dirichlet=True))


@pytest.mark.parametrize("name", ["slab1d", "quad2d", "tri2d"])
def test_dg_operator_with_source_field(name):
    jh, th = _pair(name, source=True)
    assert th.source_q is not None
    _check(jh, th)


def test_dg_operator_at_another_dt():
    """dt is a call argument (the dt-halving retry changes it)."""
    _check(*_pair("hex3d"), dt=0.025)


@pytest.mark.parametrize("name", ["slab1d", "tri2d"])
def test_cg_gather_path_goes_through_the_same_cell_term(name):
    jh, th = _pair(name, fam="CG", source=(name == "tri2d"))
    assert not th.is_dg
    _check(jh, th)


def test_jacobian_diag_is_the_diagonal_of_the_jvp():
    """Mirror of tests/test_heat_assembly.py::test_jacobian_diag_matches_jvp:
    diag(J) from unit-vector Jacobian actions."""
    _, th = _pair("slab1d")
    T, Tp, _ = _fields(th.n_dofs, seed=3)
    tT, tTp = torch.tensor(T), torch.tensor(Tp)
    eye = torch.eye(th.n_dofs, dtype=torch.float64)
    diag = torch.stack([
        torch.func.jvp(lambda u: th.residual(u, tTp), (tT,), (e,))[1][i]
        for i, e in enumerate(eye)])
    np.testing.assert_allclose(th.jacobian_diag(tT).numpy(), diag.numpy(),
                               rtol=1e-10)


def test_radiative_equilibrium_is_exact_zero():
    """Mirror of tests/test_heat_assembly.py: T = T_prev = T_ambient with
    no source is a fixed point of the DG operator."""
    p = ModelParams()
    th = THeat(TFS(tmesh.reference_glass_mesh_1d(), "DG", 1), p, 0.1,
               device="cpu")
    T = torch.full((th.n_dofs,), p.T_ambient, dtype=torch.float64)
    assert float(th.residual(T, T).abs().max()) < 1e-12


def test_interior_tables_can_wait():
    """interior_device_tables=False keeps the numpy tables only;
    ensure_interior_tables() uploads them once."""
    tm = tmesh.box_mesh_2d(3, 2)
    th = THeat(TFS(tm, "DG", 1), ModelParams(), 0.1, device="cpu",
               interior_device_tables=False)
    assert th.i_qw is None and th.np_i["qw"].shape[0] > 0
    th.ensure_interior_tables()
    first = th.i_qw
    th.ensure_interior_tables()
    assert th.i_qw is first and first.shape == th.np_i["qw"].shape
    T, Tp, _ = _fields(th.n_dofs)
    assert torch.isfinite(th.residual(torch.tensor(T), torch.tensor(Tp))).all()
