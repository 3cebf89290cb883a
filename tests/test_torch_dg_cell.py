"""The cell-residual function of the PyTorch port (the plain version of
the CUDA kernel K3, csrc/dg_cell_residual.cu) against the JAX package's
Pallas kernel in interpret mode and against the einsum form, on the CPU
in f64. Inputs come from a numpy seed and go through both.

Tolerance: rtol 1e-10 against a scale of max|r| (the Pallas body sums in
another order; the diffusion and mass terms cancel to ~1e-3 of their
size on smooth data, so a per-entry rtol would test cancellation, not
the function). The forward-mode derivative goes through the same
`torch.autograd.Function` that launches the kernel on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.ops.assembly import build_cell_geometry as jcg
from fem_glass_tempering_tpu.ops.pallas_kernels import make_dg_cell_residual
from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
    dg_cell_residual,
    dg_cell_residual_reference,
)

MESHES = {
    "slab1d": lambda: jmesh.reference_glass_mesh_1d(),
    "tri2d": lambda: jmesh.box_mesh_2d(4, 3, cell_type="triangle"),
    "hex3d": lambda: jmesh.box_mesh_3d(3, 3, 2, 1.0, 1.0, 0.01),
}


def _case(name, seed=1, fam="DG"):
    mesh = MESHES[name]()
    fs = JFS(mesh, fam, 1)
    cg = jcg(mesh, fs)
    rng = np.random.default_rng(seed)
    shape = fs.dofmap.shape
    return dict(Tc=700 + 100 * rng.random(shape),
                Tpc=700 + 100 * rng.random(shape),
                dTc=rng.standard_normal(shape),
                qw=np.asarray(cg.qweights), gphi=np.asarray(cg.grad_phys),
                phi=np.asarray(cg.phi),
                src=rng.standard_normal(np.asarray(cg.qweights).shape))


def _close(a, b, rtol=1e-10):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= rtol * np.abs(b).max()


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("name", list(MESHES))
def test_plain_version_matches_pallas_interpret(name):
    c = _case(name)
    dt, alpha, f_src = 0.1, 1.3, 0.7
    res = make_dg_cell_residual(c["phi"], dt, alpha, f_src, block_cells=16,
                                interpret=True)
    want = res(*(jnp.asarray(c[k]) for k in ("Tc", "Tpc", "qw", "gphi")))
    got = dg_cell_residual(_t(c["Tc"]), _t(c["Tpc"]), _t(c["qw"]),
                           _t(c["gphi"]), _t(c["phi"]), dt=dt, c_diff=alpha,
                           f_src=f_src)
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("c_mass,with_src", [(1.0, False), (3.5e6, True)])
def test_plain_version_matches_einsum(name, c_mass, with_src):
    """Against the einsums of the JAX heat operator's cell term, with the
    mass coefficient and the per-point source the Pallas kernel lacks."""
    c = _case(name, seed=2)
    dt, c_diff, f = 0.05, 0.9, 0.4
    Tc, Tpc, qw, gphi, phi = (jnp.asarray(c[k]) for k in
                              ("Tc", "Tpc", "qw", "gphi", "phi"))
    f_q = f + jnp.asarray(c["src"]) if with_src else f
    gTq = jnp.einsum("cl,cqlg->cqg", Tc, gphi)
    mass_src = qw * (c_mass * (Tc @ phi.T - Tpc @ phi.T) - dt * f_q)
    want = jnp.einsum("cq,ql->cl", mass_src, phi) + dt * c_diff * jnp.einsum(
        "cqg,cqlg->cl", qw[..., None] * gTq, gphi)
    got = dg_cell_residual(
        _t(c["Tc"]), _t(c["Tpc"]), _t(c["qw"]), _t(c["gphi"]), _t(c["phi"]),
        dt=dt, c_diff=c_diff, f_src=f, c_mass=c_mass,
        source_q=_t(c["src"]) if with_src else None)
    _close(got.numpy(), want, rtol=1e-12)


def test_uniform_tables_equal_expanded_tables():
    c = _case("hex3d", seed=3)
    kw = dict(dt=0.1, c_diff=1.1, f_src=0.2, c_mass=2.0,
              source_q=_t(c["src"]))
    full = dg_cell_residual(_t(c["Tc"]), _t(c["Tpc"]), _t(c["qw"]),
                            _t(c["gphi"]), _t(c["phi"]), **kw)
    uni = dg_cell_residual(_t(c["Tc"]), _t(c["Tpc"]), _t(c["qw"][0]),
                           _t(c["gphi"][0]), _t(c["phi"]), **kw)
    _close(uni.numpy(), full.numpy(), rtol=1e-13)


@pytest.mark.parametrize("name", list(MESHES))
def test_jvp_through_the_autograd_function(name):
    """torch.func.jvp through the Function against jax.jvp of the Pallas
    kernel, and the linearity identity J dT = r(T + dT) - r(T)."""
    c = _case(name, seed=4)
    dt, alpha, f_src = 0.1, 1.0, 0.3
    qw, gphi, phi = _t(c["qw"]), _t(c["gphi"]), _t(c["phi"])
    Tpc = _t(c["Tpc"])
    fn = lambda t: dg_cell_residual(t, Tpc, qw, gphi, phi, dt=dt,  # noqa: E731
                                    c_diff=alpha, f_src=f_src)
    y, dy = torch.func.jvp(fn, (_t(c["Tc"]),), (_t(c["dTc"]),))
    res = make_dg_cell_residual(c["phi"], dt, alpha, f_src, block_cells=16,
                                interpret=True)
    jq, jg, jTpc = (jnp.asarray(c[k]) for k in ("qw", "gphi", "Tpc"))
    yj, dyj = jax.jvp(lambda t: res(t, jTpc, jq, jg),
                      (jnp.asarray(c["Tc"]),), (jnp.asarray(c["dTc"]),))
    _close(y.numpy(), yj)
    _close(dy.numpy(), dyj)
    y2 = fn(_t(c["Tc"]) + _t(c["dTc"]))
    np.testing.assert_allclose(dy.numpy(), (y2 - y).numpy(), rtol=1e-8,
                               atol=1e-12 * float(y.abs().max()))


def test_jvp_in_both_arguments_and_source_has_no_tangent():
    c = _case("tri2d", seed=5)
    qw, gphi, phi = _t(c["qw"]), _t(c["gphi"]), _t(c["phi"])
    kw = dict(dt=0.2, c_diff=0.7, f_src=0.9, c_mass=4.0,
              source_q=_t(c["src"]))
    fn = lambda a, b: dg_cell_residual(a, b, qw, gphi, phi, **kw)  # noqa: E731
    dTpc = torch.ones_like(_t(c["Tpc"]))
    _, dy = torch.func.jvp(fn, (_t(c["Tc"]), _t(c["Tpc"])),
                           (_t(c["dTc"]), dTpc))
    # the tangent is the map itself with the source terms zero
    want = dg_cell_residual_reference(
        _t(c["dTc"]), dTpc, qw, gphi, phi, dt=0.2, c_diff=0.7, f_src=0.0,
        c_mass=4.0)
    assert torch.equal(dy, want)
    # only T_prev dual: Tc's tangent is absent
    _, dy_p = torch.func.jvp(lambda b: fn(_t(c["Tc"]), b), (_t(c["Tpc"]),),
                             (dTpc,))
    want_p = dg_cell_residual_reference(
        torch.zeros_like(dTpc), dTpc, qw, gphi, phi, dt=0.2, c_diff=0.7,
        f_src=0.0, c_mass=4.0)
    assert torch.equal(dy_p, want_p)


def test_backward_raises_and_tables_are_not_differentiated():
    c = _case("slab1d")
    qw, gphi, phi = _t(c["qw"]), _t(c["gphi"]), _t(c["phi"])
    Tc = _t(c["Tc"]).requires_grad_(True)
    r = dg_cell_residual(Tc, _t(c["Tpc"]), qw, gphi, phi, dt=0.1, c_diff=1.0,
                         f_src=0.0)
    with pytest.raises(NotImplementedError, match="reverse-mode"):
        r.sum().backward()
    with pytest.raises(NotImplementedError, match="Tc and Tpc only"):
        torch.func.jvp(
            lambda w: dg_cell_residual(_t(c["Tc"]), _t(c["Tpc"]), w, gphi,
                                       phi, dt=0.1, c_diff=1.0, f_src=0.0),
            (qw,), (torch.ones_like(qw),))


@pytest.mark.parametrize("bad,match", [
    (dict(Tpc=np.zeros((3, 2))), "Tc, Tpc"),
    (dict(phi=np.zeros((2, 3))), "phi must be"),
    (dict(qw=np.zeros((5, 2))), "expected qw"),
    (dict(gphi=np.zeros((2, 2))), "expected qw"),
    (dict(src=np.zeros((1, 2))), "source_q must be"),
])
def test_wrapper_rejects_wrong_shapes(bad, match):
    c = _case("slab1d")
    c.update(bad)
    with pytest.raises(ValueError, match=match):
        dg_cell_residual(_t(c["Tc"]), _t(c["Tpc"]), _t(c["qw"]),
                         _t(c["gphi"]), _t(c["phi"]), dt=0.1, c_diff=1.0,
                         f_src=0.0, source_q=_t(c["src"]))
