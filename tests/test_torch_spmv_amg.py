"""The assembled ELL Jacobian and the smoothed-aggregation AMG of the
PyTorch port against the JAX package's, on the CPU in f64.

The host-side arrays (ELL columns, pre-assembled values, boundary scatter
indices, AMG level tables and prolongators) are held EQUAL: the port's
vectorised setup must reproduce the JAX package's per-pair loops. Device
results (values_at, matvec, V-cycle) agree at rtol 1e-12 of max|value|:
only short row sums differ in order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.fem.functionspace import FunctionSpace as JFS
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.ops.spmv import EllMatrix as JEll
from fem_glass_tempering_tpu.solver import amg as jamg
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace as TFS
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator as THeat
from fem_glass_tempering_tpu_torch.ops.spmv import EllMatrix as TEll
from fem_glass_tempering_tpu_torch.solver import amg as tamg

CASES = {
    "slab1d-DG": (lambda m: m.reference_glass_mesh_1d(), "DG"),
    "tri2d-CG": (lambda m: m.box_mesh_2d(5, 4, cell_type="triangle"), "CG"),
    "hex3d-DG": (lambda m: m.box_mesh_3d(3, 3, 2, 1.0, 1.0, 0.01), "DG"),
    "quad2d-DG": (lambda m: m.box_mesh_2d(4, 4), "DG"),
    "hex3d-CG": (lambda m: m.box_mesh_3d(3, 3, 2), "CG"),
}


def _ops(case, dirichlet=False, form="reference"):
    mesher, fam = CASES[case]
    jfs, tfs = JFS(mesher(jmesh), fam, 1), TFS(mesher(tmesh), fam, 1)
    extra = {}
    if dirichlet:
        extra.update(bc_dofs=jfs.boundary_scalar_dofs(), bc_value=600.0)
    return (JHeat(jfs, jc.ModelParams(), 0.1, form=form, **extra),
            THeat(tfs, tc.ModelParams(), 0.1, device="cpu", form=form,
                  **extra))


def _close(a, b, what="", rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert np.abs(a - b).max() <= rtol * np.abs(b).max(), (
        what, float(np.abs(a - b).max()))


def _fields(n, seed=0):
    rng = np.random.default_rng(seed)
    return (700 + 100 * rng.random(n), 700 + 100 * rng.random(n),
            rng.standard_normal(n))


@pytest.mark.parametrize("case", list(CASES))
def test_ell_arrays_equal_jax(case):
    jh, th = _ops(case, form="physical" if case == "quad2d-DG" else
                  "reference")
    je, te = JEll(jh), TEll(th)
    assert te.K == je.K and te.n == je.n
    np.testing.assert_array_equal(te.np_cols, np.asarray(je.cols))
    assert te.np_cols.dtype == np.int32
    np.testing.assert_array_equal(te.vals_mass.numpy(),
                                  np.asarray(je.vals_mass))
    np.testing.assert_array_equal(te.vals_stiff.numpy(),
                                  np.asarray(je.vals_stiff))
    np.testing.assert_array_equal(te.np_b_flat_idx,
                                  np.asarray(je.b_flat_idx))
    T, _, v = _fields(je.n)
    _close(te.values_at(torch.tensor(T), 0.1).numpy(),
           je.values_at(jnp.asarray(T), 0.1), "values_at")
    _close(te.make_matvec(torch.tensor(T), 0.05)(torch.tensor(v)).numpy(),
           je.make_matvec(jnp.asarray(T), 0.05)(jnp.asarray(v)), "matvec")


@pytest.mark.parametrize("case,dirichlet", [
    ("slab1d-DG", False), ("tri2d-CG", False), ("hex3d-DG", False),
    ("quad2d-DG", False), ("hex3d-CG", False), ("tri2d-CG", True),
    ("hex3d-DG", True),
])
def test_spmv_matches_jvp(case, dirichlet):
    """Mirror of tests/test_spmv.py: the assembled matvec is the Jacobian
    action of the residual (with and without a Dirichlet mask)."""
    _, th = _ops(case, dirichlet=dirichlet)
    ell = TEll(th)
    T, Tp, v = (torch.tensor(a) for a in _fields(th.n_dofs, seed=1))
    jv = torch.func.jvp(lambda u: th.residual(u, Tp, 0.1), (T,), (v,))[1]
    sv = ell.make_matvec(T, 0.1)(v)
    np.testing.assert_allclose(sv.numpy(), jv.numpy(), rtol=1e-10,
                               atol=1e-12 * float(jv.abs().max()))


def test_boundary_blocks_are_added_not_assigned():
    """Facets that share a dof pair repeat an index of b_flat_idx; the
    values must sum (scatter-add), as the dense Jacobian shows."""
    _, th = _ops("hex3d-CG")
    ell = TEll(th)
    idx = ell.np_b_flat_idx
    assert len(np.unique(idx)) < len(idx)
    T, Tp, _ = (torch.tensor(a) for a in _fields(th.n_dofs, seed=2))
    eye = torch.eye(th.n_dofs, dtype=torch.float64)
    mv = ell.make_matvec(T, 0.1)
    A = torch.stack([mv(e) for e in eye], dim=1)
    J = torch.stack([torch.func.jvp(lambda u: th.residual(u, Tp, 0.1), (T,),
                                    (e,))[1] for e in eye], dim=1)
    np.testing.assert_allclose(A.numpy(), J.numpy(), rtol=1e-10,
                               atol=1e-13 * float(J.abs().max()))


def test_csr_to_ell_and_aggregate_equal_jax():
    rng = np.random.default_rng(5)
    A = sp.random(60, 60, density=0.08, random_state=7, format="csr")
    A = (A + A.T + sp.diags(rng.random(60) + 2.0)).tocsr()
    A.sum_duplicates()
    for got, want in zip(tamg._csr_to_ell(A), jamg._csr_to_ell(A)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tamg._aggregate(A, 0.08),
                                  jamg._aggregate(A, 0.08))
    # an empty row keeps K >= 1
    Z = sp.csr_matrix((3, 3))
    for got, want in zip(tamg._csr_to_ell(Z), jamg._csr_to_ell(Z)):
        np.testing.assert_array_equal(got, want)


AMG_CASES = {
    "slab1d-DG": (lambda m: m.reference_glass_mesh_1d(), "DG"),
    "tri2d-CG": (lambda m: m.box_mesh_2d(16, 16, 1.0, 0.02,
                                         cell_type="triangle"), "CG"),
    "hex3d-DG": (lambda m: m.box_mesh_3d(4, 4, 3, 1.0, 1.0, 0.01), "DG"),
}


@pytest.mark.parametrize("case", list(AMG_CASES))
def test_amg_hierarchy_and_vcycle_match_jax(case):
    mesher, fam = AMG_CASES[case]
    jh = JHeat(JFS(mesher(jmesh), fam, 1), jc.ModelParams(), 0.1)
    th = THeat(TFS(mesher(tmesh), fam, 1), tc.ModelParams(), 0.1,
               device="cpu")
    n = jh.n_dofs
    T0 = np.full(n, jc.ModelParams().T_0)
    ja = jamg.SmoothedAggregationMG(JEll(jh), jnp.asarray(T0), 0.1)
    ta = tamg.SmoothedAggregationMG(TEll(th), torch.tensor(T0), 0.1)
    assert len(ta.levels) == len(ja.levels)
    assert len(ta.transfers) == len(ja.transfers)
    if case != "slab1d-DG":
        assert len(ta.levels) >= 2        # a real hierarchy, not one level
    for lt, lj in zip(ta.levels, ja.levels):
        np.testing.assert_array_equal(lt["np_cols"], np.asarray(lj["cols"]))
        _close(lt["vals"].numpy(), lj["vals"], "level vals", rtol=1e-13)
        _close(lt["diag"].numpy(), lj["diag"], "diag", rtol=1e-13)
        assert lt["rho"] == pytest.approx(lj["rho"], rel=1e-12)
    for tt, tj in zip(ta.transfers, ja.transfers):
        # equal prolongator columns <=> equal aggregates
        np.testing.assert_array_equal(tt["np_Pc"], np.asarray(tj["Pc"]))
        _close(tt["Pv"].numpy(), tj["Pv"], "P", rtol=1e-12)
        _close(tt["Rv"].numpy(), tj["Rv"], "R", rtol=1e-12)
        np.testing.assert_array_equal(tt["Rc"].numpy(), np.asarray(tj["Rc"]))
    r = np.random.default_rng(9).standard_normal(n)
    _close(ta.preconditioner()(torch.tensor(r)).numpy(),
           ja.preconditioner()(jnp.asarray(r)), "V-cycle", rtol=1e-12)


def test_amg_unstructured_iteration_cut():
    """Mirror of tests/test_multigrid.py::test_amg_unstructured_iteration_cut
    against the port: SA-AMG on an unstructured triangle mesh cuts the
    Jacobi CG count more than 4x, reproduces its solution, and stays
    within 3x of geometric MG on the quad mesh of equal size."""
    def run(mesh, pc, **extra):
        cfg = tc.RunConfig(
            fe=tc.FEConfig(T_family="CG", T_degree=1),
            time=tc.TimeConfig(0.0, 0.2, 0.1),
            solver=tc.SolverConfig(preconditioner=pc, newton_rtol=1e-12,
                                   newton_atol=1e-12, cg_rtol=1e-12,
                                   cg_max_it=50000, mg_smoother="chebyshev",
                                   **extra),
            output=tc.OutputConfig(write_every=0, formats=()))
        prob = TP(mesh=mesh, config=cfg, device="cpu")
        prob.setup()
        st = prob.solve()
        return st.T.numpy(), prob.diagnostics.krylov_iters

    mt = tmesh.box_mesh_2d(16, 16, 1.0, 0.02, cell_type="triangle")
    Tj, kj = run(mt, "jacobi")
    Ta, ka = run(mt, "amg")
    np.testing.assert_allclose(Ta, Tj, rtol=1e-11)
    assert kj / max(ka, 1) > 4.0, f"AMG cut only {kj / max(ka, 1):.1f}x"
    mq = tmesh.box_mesh_2d(16, 16, 1.0, 0.02, cell_type="quad")
    _, kg = run(mq, "mg", linear_operator="stencil", mg_coarse="smooth")
    assert ka <= 3.0 * kg, f"AMG {ka} iters vs geometric MG {kg}"
