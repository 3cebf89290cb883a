"""Degree 2 off the CG-2 lattice operator in the PyTorch port: the gather
paths (the DG-2 and CG-2 HeatOperator, its ELL Jacobian, SA-AMG, the DG
block stencil at degree 2) and the assembled Krylov operator under the
lattice residual, against the JAX package on the CPU in f64.

Inputs come from np.random.default_rng(seed) or from the configuration
alone, and go to both packages. Held:
- ThermoViscoProblem on every gather configuration of degree 2, 2 steps
  of dt 0.1 at the default SolverConfig (rtol 1e-12): equal Newton and CG
  counts in every step, T, Tf and sigma within 1e-10 of their max;
- the CG-2 plate with grid_native="off" and SA-AMG: Newton equal in every
  step, CG within 2% in every step (its solves stop on their last bits:
  the port takes 336 + 275 CG, JAX 340 + 275, and JAX started one ulp
  above T_0 takes 340 + 276: the witness, ROADMAP.md Queue 3), fields
  within 1e-10 of max; its ELL values and SA-AMG hierarchy equal JAX's;
- the mirrors of tests/test_spmv.py:29-33 (the ELL Jacobian against the
  jvp, triangles CG-2), tests/test_spmv.py:133-135 (the DG block stencil
  at degree 2 against the jvp) and tests/test_heat_assembly.py:100-103 (the
  Dirichlet harmonic on triangles and tetrahedra, CG-2), each also against
  JAX's arrays (the harmonic's Jacobi-CG at rtol 1e-13 within 2% of JAX's
  count: it stops on its last bits, 52 against 51 on the triangles);
- the cell term (the plain version of K3) at every degree-2 cell shape
  (nloc 3, 6, 9, 10, 27) against JAX's Pallas kernel in interpret mode and
  against the einsums of JAX's heat operator, on the port's own tables.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.models.problem import ThermoViscoProblem as JP
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.ops.pallas_kernels import make_dg_cell_residual
from fem_glass_tempering_tpu.ops.spmv import EllMatrix as JEll
from fem_glass_tempering_tpu.ops.stencil import DGStencilMatrix as JDGS
from fem_glass_tempering_tpu.solver.newton import newton_solve as jnewton
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP
from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import dg_cell_residual
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.ops.spmv import EllMatrix
from fem_glass_tempering_tpu_torch.ops.stencil import DGStencilMatrix
from fem_glass_tempering_tpu_torch.solver.amg import SmoothedAggregationMG
from fem_glass_tempering_tpu_torch.solver.newton import newton_solve

F64 = torch.float64
STEPS = 2
CG2 = dict(T_family="CG", T_degree=2)
DG2 = dict(T_family="DG", T_degree=2)
PLATE = lambda m: m.box_mesh_3d(3, 3, 2, 1, 1, 0.01)  # noqa: E731
BOX = lambda m: m.box_mesh_3d(3, 3, 2)                # noqa: E731
# name: (mesh, FE choice, solver settings, the port's operator and
# preconditioner after setup)
CASES = {
    "dg2_slab": (lambda m: m.reference_glass_mesh_1d(), DG2, {},
                 ("matrix_free", "amg")),
    "cg2_tet_plate": (lambda m: m.box_mesh_3d(2, 2, 2, cell_type="tet"),
                      CG2, {}, ("matrix_free", "amg")),
    "dg2_box": (BOX, DG2, {}, ("matrix_free", "amg")),
    "dg2_box_stencil": (BOX, DG2, dict(linear_operator="stencil"),
                        ("DGStencilMatrix", "amg")),
    "cg2_plate_assembled": (PLATE, CG2, dict(linear_operator="assembled"),
                            ("EllMatrix", "mg")),
}
AMG_PLATE = (PLATE, CG2, dict(grid_native="off", preconditioner="amg"))


def _cfg(m, fe, solver, T_0=None):
    cfg = m.RunConfig(fe=m.FEConfig(**fe),
                      time=m.TimeConfig(0.0, STEPS * 0.1, 0.1),
                      solver=m.SolverConfig(**solver),
                      output=m.OutputConfig(write_every=0, formats=()),
                      dtype="float64")
    if T_0 is not None:
        cfg = dataclasses.replace(
            cfg, params=dataclasses.replace(cfg.params, T_0=T_0))
    return cfg


def _run(port, mk, fe, solver, T_0=None):
    """STEPS steps of one configuration -> (problem, state, per-step
    (Newton, CG) counts)."""
    if port:
        p = TP(mesh=mk(tmesh), config=_cfg(tc, fe, solver, T_0),
               device="cpu")
    else:
        p = JP(mesh=mk(jmesh), config=_cfg(jc, fe, solver, T_0))
    p.setup()
    counts = []
    for _ in range(STEPS):
        n0, k0 = p.diagnostics.newton_iters, p.diagnostics.krylov_iters
        st = p.solve_timestep()
        counts.append((p.diagnostics.newton_iters - n0,
                       p.diagnostics.krylov_iters - k0))
    return p, st, counts


def _fields_close(st, sj, rel=1e-10):
    for f in ("T", "Tf", "sigma"):
        a, b = getattr(st, f).numpy(), np.asarray(getattr(sj, f))
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= rel * np.abs(b).max(), f


@pytest.mark.parametrize("name", sorted(CASES))
def test_configuration_matches_jax(name):
    mk, fe, solver, (operator, pc) = CASES[name]
    pt, st, ct = _run(True, mk, fe, solver)
    assert pt._grid2 is None or fe["T_family"] == "CG"
    assert pt.config.solver.preconditioner == pc
    assert (type(pt._ell).__name__ if pt._ell is not None
            else "matrix_free") == operator
    _, sj, cj = _run(False, mk, fe, solver)
    assert ct == cj
    _fields_close(st, sj)


def test_amg_plate_within_its_band_of_jax():
    """The CG-2 plate with the lattice operator off: the gather residual,
    the matrix-free jvp and SA-AMG. The hierarchy is JAX's bit for bit;
    the CG counts of a solve that stops on its last bits part by up to 4
    in a step, and JAX's own move when it starts one ulp higher."""
    mk, fe, solver = AMG_PLATE
    pt, st, ct = _run(True, mk, fe, solver)
    assert pt._grid2 is None and pt._ell is None
    assert isinstance(pt._amg, SmoothedAggregationMG)
    pj, sj, cj = _run(False, mk, fe, solver)
    for a, b in zip(pt._amg.levels, pj._amg.levels):
        assert np.array_equal(a["vals"].numpy(), np.asarray(b["vals"]))
        assert a["rho"] == b["rho"]
    assert [c[0] for c in ct] == [c[0] for c in cj]
    for (_, kt), (_, kj) in zip(ct, cj):
        assert abs(kt - kj) <= 0.02 * kj, (ct, cj)
    _fields_close(st, sj)
    # the witness: JAX from T_0 one ulp up
    T_up = float(np.nextafter(pj.params.T_0, np.inf))
    _, _, cj_up = _run(False, mk, fe, solver, T_0=T_up)
    assert [c[0] for c in cj_up] == [c[0] for c in cj]
    assert cj_up != cj, (cj, cj_up)


def _pair(mk, fam, seed, **kw):
    """The port's and JAX's degree-2 heat operators of one mesh, and
    numpy inputs T, T_prev, v from `seed`."""
    tfs, jfs = FunctionSpace(mk(tmesh), fam, 2), JFS(mk(jmesh), fam, 2)
    th = HeatOperator(tfs, tc.ModelParams(), 0.1, dtype=F64, device="cpu",
                      **kw)
    jh = JHeat(jfs, jc.ModelParams(), 0.1, dtype=jnp.float64, **kw)
    rng = np.random.default_rng(seed)
    n = tfs.n_scalar_dofs
    return (th, jh, 700 + 100 * rng.random(n), 700 + 100 * rng.random(n),
            rng.standard_normal(n))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


def test_ell_matches_jvp_on_cg2_triangles():
    """tests/test_spmv.py:29-33, triangles CG-2."""
    th, jh, T, Tp, v = _pair(
        lambda m: m.box_mesh_2d(4, 3, cell_type="triangle"), "CG", 0)
    ell = EllMatrix(th)
    assert ell.K == JEll(jh).K
    jv = torch.func.jvp(lambda u: th.residual(u, _t(Tp), 0.1), (_t(T),),
                        (_t(v),))[1]
    sv = ell.make_matvec(_t(T), 0.1)(_t(v))
    np.testing.assert_allclose(sv.numpy(), jv.numpy(), rtol=1e-10,
                               atol=1e-12)
    jsv = JEll(jh).make_matvec(jnp.asarray(T), 0.1)(jnp.asarray(v))
    np.testing.assert_allclose(sv.numpy(), np.asarray(jsv), rtol=1e-12,
                               atol=1e-13)


def test_dg_block_stencil_at_degree_two():
    """tests/test_spmv.py:133-135: the DG-2 block stencil of a uniform 2D
    box against the jvp of the gather residual, and against JAX's."""
    th, jh, T, Tp, v = _pair(lambda m: m.box_mesh_2d(5, 4, 1.0, 0.5), "DG",
                             3)
    st, jst = DGStencilMatrix(th), JDGS(jh)
    assert st.cross_const
    jv = torch.func.jvp(lambda u: th.residual(u, _t(Tp), 0.1), (_t(T),),
                        (_t(v),))[1]
    sv = st.make_matvec(_t(T), 0.1)(_t(v))
    np.testing.assert_allclose(sv.numpy(), jv.numpy(), rtol=1e-10,
                               atol=1e-12)
    jsv = jst.make_matvec(jnp.asarray(T), 0.1)(jnp.asarray(v))
    np.testing.assert_allclose(sv.numpy(), np.asarray(jsv), rtol=1e-12,
                               atol=1e-12)
    r = st.residual(_t(T), _t(Tp), 0.1).numpy()
    np.testing.assert_allclose(
        r, np.asarray(jst.residual(jnp.asarray(T), jnp.asarray(Tp), 0.1)),
        rtol=1e-12, atol=1e-12 * np.abs(r).max())


@pytest.mark.parametrize("mk", [
    lambda m: m.box_mesh_2d(4, 4, cell_type="triangle"),
    lambda m: m.box_mesh_3d(2, 2, 2, cell_type="tet"),
], ids=["triangles", "tetrahedra"])
def test_dirichlet_harmonic_exact(mk):
    """tests/test_heat_assembly.py:100-103 at degree 2: steady diffusion
    with T = 1 + 2x on the boundary reproduces the linear field, in the
    port's and JAX's Jacobi-CG with equal counts."""
    tfs, jfs = FunctionSpace(mk(tmesh), "CG", 2), JFS(mk(jmesh), "CG", 2)
    bd = tfs.boundary_scalar_dofs()
    assert np.array_equal(bd, jfs.boundary_scalar_dofs())
    bvals = 1.0 + 2.0 * tfs.dof_coords[bd, 0]
    p = dict(epsilon=0.0, htc=0.0, sigma=0.0, alpha=1.0)
    th = HeatOperator(tfs, dataclasses.replace(tc.ModelParams(), **p), 1e8,
                      dtype=F64, device="cpu", bc_dofs=bd, bc_value=bvals)
    jh = JHeat(jfs, dataclasses.replace(jc.ModelParams(), **p), 1e8,
               bc_dofs=bd, bc_value=bvals)
    kw = dict(rtol=1e-12, cg_rtol=1e-13, cg_max_it=2000)
    T0 = np.zeros(tfs.n_scalar_dofs)
    res = newton_solve(lambda T: th.residual(T, _t(T0)), _t(T0),
                       jac_diag_fn=th.jacobian_diag, **kw)
    jres = jnewton(lambda T: jh.residual(T, jnp.asarray(T0)),
                   jnp.asarray(T0), jac_diag_fn=jh.jacobian_diag, **kw)
    assert res.converged and bool(jres.converged)
    exact = 1.0 + 2.0 * tfs.dof_coords[:, 0]
    np.testing.assert_allclose(res.x.numpy(), exact, atol=2e-6)
    # the Jacobi-CG at rtol 1e-13 stops on its last bits (52 against 51 on
    # the triangles)
    assert res.iters == int(jres.iters)
    assert abs(res.krylov_iters - int(jres.krylov_iters)) <= \
        0.02 * int(jres.krylov_iters)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               atol=1e-10)


# every degree-2 cell shape: nloc 3, 6, 9, 10, 27
CELLS = {
    "interval": (lambda m: m.reference_glass_mesh_1d(), "DG"),
    "triangle": (lambda m: m.box_mesh_2d(4, 3, cell_type="triangle"), "CG"),
    "quadrilateral": (lambda m: m.box_mesh_2d(6, 3, 2.0, 1.0), "CG"),
    "tetrahedron": (lambda m: m.box_mesh_3d(2, 2, 1, cell_type="tet"), "CG"),
    "hexahedron": (lambda m: m.box_mesh_3d(3, 3, 2, 1, 1, 0.01), "CG"),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_term_at_degree_two_matches_jax(cell):
    """The plain version of K3 on the port's HeatOperator tables (uniform on
    the boxes, per cell elsewhere) against JAX's Pallas cell kernel in
    interpret mode (per-cell tables, c_mass 1) and against the einsums of
    JAX's heat operator (c_mass and a per-point source), at rtol 1e-10 of
    max|r| (the sums run in other orders; the terms cancel to ~1e-3 of
    their size)."""
    mk, fam = CELLS[cell]
    th, jh, _, _, _ = _pair(mk, fam, 0)
    nloc = {"interval": 3, "triangle": 6, "quadrilateral": 9,
            "tetrahedron": 10, "hexahedron": 27}[cell]
    shape = tuple(th.dofmap.shape)
    assert shape[1] == nloc
    assert th.qw.dim() == (1 if th.fs.mesh.structured is not None else 2)
    np.testing.assert_allclose(th.np_phi, np.asarray(jh.phi), rtol=1e-15)
    qw_c = np.broadcast_to(th.np_qw, (shape[0],) + th.np_qw.shape[-1:])
    gphi_c = np.broadcast_to(th.np_gphi, (shape[0],) + th.np_gphi.shape[-3:])
    np.testing.assert_allclose(th.np_qw, np.asarray(jh.qw), rtol=1e-14)
    np.testing.assert_allclose(th.np_gphi, np.asarray(jh.gphi), rtol=1e-12,
                               atol=1e-12 * np.abs(th.np_gphi).max())
    rng = np.random.default_rng(1)
    Tc = 700 + 100 * rng.random(shape)
    Tpc = 700 + 100 * rng.random(shape)
    dt, c_diff, f = 0.1, 1.3, 0.7

    def close(a, b):
        assert np.abs(a - b).max() <= 1e-10 * np.abs(b).max()

    got = dg_cell_residual(_t(Tc), _t(Tpc), th.qw, th.gphi, th.phi, dt=dt,
                           c_diff=c_diff, f_src=f)
    pallas = make_dg_cell_residual(th.np_phi, dt, c_diff, f, block_cells=16,
                                   interpret=True)
    close(got.numpy(), np.asarray(pallas(
        jnp.asarray(Tc), jnp.asarray(Tpc), jnp.asarray(qw_c),
        jnp.asarray(gphi_c))))
    src = rng.standard_normal((shape[0], th.phi.shape[0]))
    c_mass = 3.5e6
    Tcj, Tpcj, qwj, gj, phj = (jnp.asarray(a) for a in (Tc, Tpc, qw_c,
                                                         gphi_c, th.np_phi))
    gTq = jnp.einsum("cl,cqlg->cqg", Tcj, gj)
    mass_src = qwj * (c_mass * (Tcj @ phj.T - Tpcj @ phj.T)
                      - dt * (f + jnp.asarray(src)))
    want = jnp.einsum("cq,ql->cl", mass_src, phj) + dt * c_diff * jnp.einsum(
        "cqg,cqlg->cl", qwj[..., None] * gTq, gj)
    got = dg_cell_residual(_t(Tc), _t(Tpc), th.qw, th.gphi, th.phi, dt=dt,
                           c_diff=c_diff, f_src=f, c_mass=c_mass,
                           source_q=_t(src))
    close(got.numpy(), np.asarray(want))
    # and through torch.func.jvp, against jax.jvp of the Pallas kernel
    dTc = rng.standard_normal(shape)
    _, dy = torch.func.jvp(
        lambda u: dg_cell_residual(u, _t(Tpc), th.qw, th.gphi, th.phi, dt=dt,
                                   c_diff=c_diff, f_src=f), (_t(Tc),),
        (_t(dTc),))
    _, dyj = jax.jvp(lambda u: pallas(u, Tpcj, qwj, gj), (Tcj,),
                     (jnp.asarray(dTc),))
    close(dy.numpy(), np.asarray(dyj))
