"""The elasticity operators of the PyTorch port (ops/elasticity.py, flat
gather assembly; ops/grid_elasticity.py, on the node grid) against the JAX
package, on the CPU in f64.

- `_rigid_body_pins` is host numpy: equal to JAX's.
- Every operator method on seeded inputs at rtol 1e-12 (of max|value|)
  against JAX's: residual, linear action, diagonal, strains, the block
  stencil table and its matvec, the nodal-to-quadrature maps.
- Inside the port, the grid operator against the flat one (the JAX test
  tests/test_grid_elasticity.py:14-72) and the table matvec against the
  cell recompute (:216-250).
- The Jacobi-CG solve against JAX's: du at 1e-9, equal iteration counts
  on a cube (on a 20:1 box within 1%, see the test); and the
  free-expansion and patch tests of tests/test_mechanics.py:23-58.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.ops.elasticity import (
    ElasticityOperator as JEl,
    _rigid_body_pins as j_pins,
)
from fem_glass_tempering_tpu.ops.grid_elasticity import (
    GridElasticityOperator as JGEl,
)
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace as TFS
from fem_glass_tempering_tpu_torch.ops.elasticity import (
    ElasticityOperator,
    _rigid_body_pins,
)
from fem_glass_tempering_tpu_torch.ops.grid_elasticity import (
    GridElasticityOperator,
)

F64 = torch.float64
MESHES = {
    "quad2d": lambda m: m.box_mesh_2d(5, 4, 1.0, 0.5),
    "plate3d": lambda m: m.box_mesh_3d(4, 3, 2, 1.0, 1.0, 0.01),
    "box3d": lambda m: m.box_mesh_3d(5, 4, 3, 1.0, 0.8, 0.05),
}


def _close(a, b, what, rtol=1e-12):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_allclose(
        a, b, rtol=rtol, atol=rtol * max(float(np.abs(b).max()), 1e-300),
        err_msg=what)


def _spaces(name):
    tm, jm = MESHES[name](tmesh), MESHES[name](jmesh)
    d = tm.tdim
    return (TFS(tm, "CG", 1, value_shape=(d, d)),
            JFS(jm, "CG", 1, value_shape=(d, d)), d)


def _inputs(n, C, Q, d, seed=0):
    """Seeded displacement, symmetric history stress, isotropic imposed
    strain and positive moduli at the quadrature points."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((n, d))
    sig = rng.standard_normal((C, Q, d, d))
    sig = 0.5 * (sig + np.swapaxes(sig, -1, -2))
    eps0 = rng.standard_normal((C, Q))[..., None, None] * np.eye(d)
    G = 1.0 + rng.random((C, Q))
    K = 2.0 + rng.random((C, Q))
    v = rng.standard_normal((n, d))
    return u, sig, eps0, G, K, v


T = lambda a: torch.tensor(np.asarray(a), dtype=F64)  # noqa: E731
J = jnp.asarray


@pytest.mark.parametrize("name", sorted(MESHES))
def test_rigid_body_pins_equal_jax(name):
    ts, js, _ = _spaces(name)
    np.testing.assert_array_equal(
        _rigid_body_pins(TFS(ts.mesh, "CG", 1)),
        j_pins(JFS(js.mesh, "CG", 1)))


@pytest.mark.parametrize("name", sorted(MESHES))
def test_flat_operator_matches_jax(name):
    ts, js, d = _spaces(name)
    te = ElasticityOperator(ts, dtype=F64, device="cpu")
    je = JEl(js, dtype=jnp.float64)
    C, Q = te.qw.shape
    u, sig, eps0, G, K, v = _inputs(te.n, C, Q, d)
    np.testing.assert_array_equal(te.pin_mask.numpy(),
                                  np.asarray(je.pin_mask) > 0)
    _close(te.residual(T(u), T(sig), T(eps0), T(G), T(K)),
           je.residual(J(u), J(sig), J(eps0), J(G), J(K)), "residual")
    zq = np.zeros_like(sig)
    _close(te.residual(T(v), T(zq), T(zq), T(G), T(K)),
           je.residual(J(v), J(zq), J(zq), J(G), J(K)), "linear action")
    _close(te.jacobian_diag(T(G), T(K)), je.jacobian_diag(J(G), J(K)),
           "diagonal")
    _close(te._strain_at_q(T(u)), je._strain_at_q(J(u)), "strain at q")
    _close(te.strain_at_sigma_dofs(T(u)), je.strain_at_sigma_dofs(J(u)),
           "strain at the sigma dofs")


@pytest.mark.parametrize("name", sorted(MESHES))
def test_grid_operator_matches_jax(name):
    ts, js, d = _spaces(name)
    tg = GridElasticityOperator(ts, dtype=F64, device="cpu")
    jg = JGEl(js, dtype=jnp.float64)
    assert (tg.dims, tg.grid, tg.loffs) == (jg.dims, jg.grid, jg.loffs)
    np.testing.assert_array_equal(tg.np_pin_mask, jg.np_pin_mask)
    C, Q = int(np.prod(tg.dims)), tg.qw1.shape[0]
    u, sig, eps0, G, K, v = _inputs(tg.n, C, Q, d, seed=1)
    cg = lambda a: a.reshape(tg.dims + a.shape[1:])  # noqa: E731
    ng = lambda a: a.reshape(tg.grid + a.shape[1:])  # noqa: E731
    ug, vg = ng(u), ng(v)
    args = [cg(a) for a in (sig, eps0, G, K)]
    _close(tg.residual_g(T(ug), *map(T, args)),
           jg.residual_g(J(ug), *map(J, args)), "residual_g")
    Gq, Kq = cg(G), cg(K)
    _close(tg.make_matvec_g(T(Gq), T(Kq))(T(vg)),
           jg.make_matvec_g(J(Gq), J(Kq))(J(vg)), "cell matvec")
    tb, jb = tg.stencil_table_g(T(Gq), T(Kq)), jg.stencil_table_g(J(Gq),
                                                                 J(Kq))
    _close(tb, jb, "block stencil table")
    _close(tg.matvec_table_g(tb, T(vg)), jg.matvec_table_g(jb, J(vg)),
           "table matvec")
    _close(tg.jacobian_diag_g(T(Gq), T(Kq)), jg.jacobian_diag_g(J(Gq), J(Kq)),
           "diagonal")
    _close(tg.strain_at_q(T(ug)), jg.strain_at_q(J(ug)), "strain at q")
    _close(tg.strain_at_nodes(T(ug)), jg.strain_at_nodes(J(ug)),
           "strain at the nodes")
    xg = ng(u[:, 0])
    _close(tg.cell_avg_from_nodes(T(xg)), jg.cell_avg_from_nodes(J(xg)),
           "nodes -> quadrature points")
    sg = ng(np.repeat(u[:, :, None], d, axis=2))
    _close(tg.tensor_at_q(T(sg)), jg.tensor_at_q(J(sg)),
           "nodal tensor -> quadrature points")


@pytest.mark.parametrize("name", ["quad2d", "plate3d"])
def test_grid_operator_matches_flat_operator(name):
    """The JAX test tests/test_grid_elasticity.py:14-72 on the port: the
    grid operator is the flat one on the node grid (pinned rows differ by
    design: the flat matvec zeroes them, the grid one keeps identity)."""
    ts, _, d = _spaces(name)
    el = ElasticityOperator(ts, dtype=F64, device="cpu")
    g = GridElasticityOperator(ts, dtype=F64, device="cpu")
    C, Q = el.qw.shape
    u, sig, eps0, G, K, v = _inputs(el.n, C, Q, d)
    u[el.pin_mask.numpy()] = 0.0
    cg = lambda a: T(a.reshape(g.dims + a.shape[1:]))  # noqa: E731
    ug = T(u.reshape(g.grid + (d,)))
    _close(g.residual_g(ug, cg(sig), cg(eps0), cg(G), cg(K)).reshape(-1, d),
           el.residual(T(u), T(sig), T(eps0), T(G), T(K)), "residual")
    out_g = g.make_matvec_g(cg(G), cg(K))(T(v.reshape(g.grid + (d,))))
    zq = T(np.zeros_like(sig))
    out_f = el.residual(T(v), zq, zq, T(G), T(K))
    free = ~el.pin_mask
    _close(out_g.reshape(-1, d)[free], out_f[free], "linear action")
    _close(g.jacobian_diag_g(cg(G), cg(K)).reshape(-1, d),
           el.jacobian_diag(T(G), T(K)), "diagonal")
    _close(g.strain_at_nodes(ug).reshape(-1, d, d),
           el.strain_at_sigma_dofs(T(u)), "nodal strain")


@pytest.mark.parametrize("name", ["quad2d", "box3d"])
def test_stencil_table_matvec_matches_cell_form(name):
    """The block-stencil table's matvec is the cell recompute, with
    per-quadrature-point coefficients and pinned components."""
    ts, _, d = _spaces(name)
    op = GridElasticityOperator(ts, dtype=F64, device="cpu")
    rng = np.random.default_rng(0)
    q = op.qw1.shape[0]
    Gq = T(1.0 + rng.random(op.dims + (q,)))
    Kq = T(2.0 + rng.random(op.dims + (q,)))
    v = T(rng.standard_normal(op.grid + (d,)))
    r_cell = op.make_matvec_g(Gq, Kq)(v)
    r_tbl = op.matvec_table_g(op.stencil_table_g(Gq, Kq), v)
    torch.testing.assert_close(r_tbl, r_cell, rtol=0.0, atol=1e-12)


@pytest.mark.parametrize("name", ["quad2d", "box3d"])
def test_table_matvec_is_the_term_by_term_sum(name):
    """The unfolded one-pass form of matvec_table_g equals, bit for bit,
    the JAX version's loop: one shifted multiply-reduce per offset, summed
    in the offsets' order."""
    ts, _, d = _spaces(name)
    op = GridElasticityOperator(ts, dtype=F64, device="cpu")
    rng = np.random.default_rng(3)
    q = op.qw1.shape[0]
    B = op.stencil_table_g(T(1.0 + rng.random(op.dims + (q,))),
                           T(2.0 + rng.random(op.dims + (q,))))
    v = T(rng.standard_normal(op.grid + (d,)))
    vp = torch.nn.functional.pad(torch.where(op.pin_mask_g, 0.0, v),
                                 (0, 0) + (1, 1) * d)
    r = None
    for off in op._offsets:
        sl = tuple(slice(1 + off[i], 1 + off[i] + op.grid[i])
                   for i in range(d))
        term = (B[..., op._offset_index[off], :, :]
                * vp[sl][..., None, :]).sum(-1)
        r = term if r is None else r + term
    assert torch.equal(op.matvec_table_g(B, v),
                       torch.where(op.pin_mask_g, v, r))


@pytest.mark.parametrize("name,same_count", [("cube", True),
                                             ("box3d", False)])
def test_flat_solve_matches_jax(name, same_count):
    """Jacobi-CG cold and from a warm start, with the increment test: du
    at 1e-9. On the cube (108 iterations) the counts are equal. On the
    20:1 box Jacobi-CG takes ~890 iterations, and the last bits of the two
    libraries' sums move its count by a few (888 against 884 measured):
    the count there is held to 1%, the solution to 1e-9 all the same."""
    mk = (lambda m: m.box_mesh_3d(4, 4, 4)) if name == "cube" else \
        MESHES[name]
    tm, jm = mk(tmesh), mk(jmesh)
    te = ElasticityOperator(TFS(tm, "CG", 1, value_shape=(3, 3)), dtype=F64,
                            device="cpu")
    je = JEl(JFS(jm, "CG", 1, value_shape=(3, 3)), dtype=jnp.float64)
    C, Q = te.qw.shape
    _, sig, eps0, G, K, _ = _inputs(te.n, C, Q, 3, seed=2)
    sig, eps0 = 1e-2 * sig, 1e-3 * eps0
    for x0 in (None, 1e-4 * np.random.default_rng(5).standard_normal(
            (te.n, 3))):
        du_t, it_t = te.solve_increment(
            T(sig), T(eps0), T(G), T(K), rtol=1e-10, rtol_r0=1e-2,
            x0=None if x0 is None else T(x0))
        du_j, it_j = je.solve_increment(
            J(sig), J(eps0), J(G), J(K), rtol=1e-10, rtol_r0=1e-2,
            x0=None if x0 is None else J(x0))
        assert it_t > 50 and it_t < 2000
        if same_count:
            assert it_t == int(it_j)
        else:
            assert abs(it_t - int(it_j)) <= 0.01 * int(it_j)
        _close(du_t, du_j, "du", rtol=1e-9)


def test_free_expansion_is_stress_free():
    """tests/test_mechanics.py:23-39 on the port: a uniform imposed strain
    on a traction-free body expands freely, eps(du) = eps0."""
    mesh = tmesh.box_mesh_2d(6, 6)
    el = ElasticityOperator(TFS(mesh, "CG", 1, value_shape=(2, 2)),
                            device="cpu")
    c, q = el.qw.shape
    eps0 = (0.01 * torch.eye(2, dtype=F64)).expand(c, q, 2, 2)
    G = torch.full((c, q), 5.0, dtype=F64)
    K = torch.full((c, q), 8.0, dtype=F64)
    du, _ = el.solve_increment(torch.zeros(c, q, 2, 2, dtype=F64), eps0, G,
                               K, rtol=1e-12)
    eps = el.strain_at_sigma_dofs(du).numpy()
    np.testing.assert_allclose(eps, np.broadcast_to(0.01 * np.eye(2),
                                                    eps.shape), atol=1e-8)


def test_patch_linear_displacement():
    """tests/test_mechanics.py:42-58 on the port: a uniform traceless
    shear + axial strain is reproduced exactly."""
    mesh = tmesh.box_mesh_3d(3, 3, 2)
    el = ElasticityOperator(TFS(mesh, "CG", 1, value_shape=(3, 3)),
                            device="cpu")
    c, q = el.qw.shape
    e = np.zeros((3, 3))
    e[0, 1] = e[1, 0] = 0.005
    e[2, 2] = -0.002
    du, _ = el.solve_increment(
        torch.zeros(c, q, 3, 3, dtype=F64), T(e).expand(c, q, 3, 3),
        torch.full((c, q), 3.0, dtype=F64),
        torch.full((c, q), 7.0, dtype=F64), rtol=1e-12)
    eps = el.strain_at_sigma_dofs(du).numpy()
    np.testing.assert_allclose(eps, np.broadcast_to(e, eps.shape), atol=1e-8)


def test_grid_operator_refuses_what_it_cannot_take():
    mesh = tmesh.box_mesh_3d(2, 2, 2)
    with pytest.raises(ValueError, match="CG-1"):
        GridElasticityOperator(TFS(mesh, "DG", 1, value_shape=(3, 3)),
                               device="cpu")
