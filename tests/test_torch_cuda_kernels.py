"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. Marked `gpu`: they skip where no CUDA device is visible, and run on
the GPU machine with `python -m pytest tests/test_torch_cuda_kernels.py`.

K1 and K2 round every operation as the plain versions do (their sources
are built with -fmad=false), so K2 is held to equality and K1 to the
rounding of exp and of the plain 6-term dot product (rtol 1e-12 in f64,
2e-6 in f32). K3's plain version sums through matrix products in an order
of their own, and K3 is built with multiply-add contraction, so K3 is held
to rtol 1e-12 (f64) / 1e-5 (f32) of the sum of
the absolute values of its terms. K3 runs through both of its kernels:
the direct call (tables in device memory, the split kernel) and the
prepared call (uniform tables that fit travel by value, the row kernel),
which must agree bit for bit, and at every degree-2 cell shape on the
heat operator's own tables and on random ones, where both calls take the
element form (the baked element matrices), uniform and per cell, on cell
counts that fill no whole block. K2's bf16 kernel takes tables pitched
to 16 bytes (`pitched_tables`) and equals its twin bit for bit on odd
grids, the 161x161x41 fine level among them; K2's halo form (a rank's
planes of a split grid) equals its twin and the full-grid kernel's rows
bit for bit. The grouped scatter-adds of the gather path
(ops/scatter.py) must repeat their bits on the card, and equal the CPU's.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n,view", [(100_003, False), (100_003, True),
                                    (1000, False), (256, False), (7, True)])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-6)])
def test_material_tspace_kernel(cuda, dtype, rtol, n, view):
    """Sizes around the 256-dof tile, and a Tf_partial one element into a
    larger buffer (not 16-byte aligned: the element-wise tile copy)."""
    from fem_glass_tempering_tpu_torch.models.viscoelastic import (
        LAMBDA_M_N,
        M_N,
    )
    from fem_glass_tempering_tpu_torch.ops.cuda_kernels import (
        material_tspace,
        material_tspace_reference,
    )

    rng = np.random.default_rng(0)
    T = torch.tensor(700.0 + 100 * rng.random(n), dtype=dtype, device=cuda)
    Tp = T + torch.tensor(rng.normal(0, 5, n), dtype=dtype, device=cuda)
    flat = torch.tensor(750.0 + 50 * rng.random(6 * n + 1), dtype=dtype,
                        device=cuda)
    Tfp = flat[1:].view(n, 6) if view else flat[1:].view(n, 6).clone()
    assert (Tfp.data_ptr() % 16 != 0) == view
    kw = dict(dt=0.1, H_over_Rg=627.8e3 / 8.314, Tb=869.0, m_n=M_N,
              lambda_m_n=LAMBDA_M_N)
    before = material_tspace.launches
    out = material_tspace(T, Tp, Tfp, **kw)
    assert material_tspace.launches == before + 1
    ref = material_tspace_reference(T, Tp, Tfp, **kw)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        scale = r.abs().max()
        assert o.shape == r.shape
        assert ((o - r).abs() <= rtol * r.abs() + rtol * 1e-3 * scale).all()


@pytest.mark.parametrize("grid", [(9, 7, 5), (12, 6, 3), (10, 8),
                                  (41, 21, 6)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stencil_matvec_kernel(cuda, grid, dtype):
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
        stencil_matvec,
        stencil_matvec_reference,
    )

    rng = np.random.default_rng(1)
    d = len(grid)
    vals = torch.tensor(rng.standard_normal((3 ** d,) + grid), dtype=dtype,
                        device=cuda).reshape(3 ** d, grid[0], -1)
    x = torch.tensor(rng.standard_normal(int(np.prod(grid))), dtype=dtype,
                     device=cuda)
    before = stencil_matvec.launches
    y = stencil_matvec(vals, x, grid)
    assert stencil_matvec.launches == before + 1
    y_ref = stencil_matvec_reference(vals, x, grid)
    torch.cuda.synchronize()
    assert torch.equal(y, y_ref)


@pytest.mark.parametrize("grid,rows", [
    ((13, 7, 5), ((0, 4), (4, 7), (7, 10), (10, 13))),
    ((161, 161, 41), ((0, 81), (81, 161))),
    ((10, 8), ((0, 1), (1, 6), (6, 10))),
    ((41, 21, 6), ((0, 41),))], ids=str)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stencil_matvec_halo_kernel(cuda, grid, rows, dtype):
    """K2's halo form on each rank's planes (those with the grid's first
    and last among them; one rank holding the whole grid), its halo cut
    from the whole vector (zeros past the ends): bit-equal to its plain
    twin and to the full-grid kernel's rows."""
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
        stencil_matvec,
        stencil_matvec_halo,
        stencil_matvec_halo_reference,
    )

    rng = np.random.default_rng(5)
    d = len(grid)
    gx, M = grid[0], int(np.prod(grid[1:]))
    vals = torch.tensor(rng.standard_normal((3 ** d, gx, M)), dtype=dtype,
                        device=cuda)
    x = torch.tensor(rng.standard_normal((gx, M)), dtype=dtype, device=cuda)
    full = stencil_matvec(vals, x.reshape(-1), grid).reshape(gx, M)
    z = torch.zeros_like(x[:1])
    for lo, hi in rows:
        xe = torch.cat([z if lo == 0 else x[lo - 1:lo], x[lo:hi],
                        z if hi == gx else x[hi:hi + 1]]).reshape(-1)
        v = vals[:, lo:hi].contiguous()
        shape = (hi - lo,) + tuple(grid[1:])
        before = stencil_matvec_halo.launches
        y = stencil_matvec_halo(v, xe, shape)
        assert stencil_matvec_halo.launches == before + 1
        twin = stencil_matvec_halo_reference(v, xe, shape)
        torch.cuda.synchronize()
        assert torch.equal(y, twin)
        assert torch.equal(y.reshape(hi - lo, M), full[lo:hi])


@pytest.mark.parametrize("grid", [(9, 7, 5), (10, 8), (41, 21, 6),
                                  (161, 161, 41), (81, 81, 21), (6, 6, 2),
                                  (3, 2, 2), (11, 7)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stencil_matvec_kernel_bf16_tables(cuda, grid, dtype):
    """K2's bf16-table instantiation under an f32 / f64 vector equals its
    plain twin bit for bit (both widen the tables exactly and round in
    the vector's dtype) on the pitched tables of odd grids, x at an
    offset too, and counts as a bf16 launch; other table / vector pairs
    raise."""
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
        pitched_tables,
        stencil_matvec,
        stencil_matvec_reference,
    )

    rng = np.random.default_rng(4)
    d = len(grid)
    vals = pitched_tables(torch.tensor(
        rng.standard_normal((3 ** d,) + grid),
        device=cuda).reshape(3 ** d, grid[0], -1))
    x = torch.tensor(rng.standard_normal(int(np.prod(grid))), dtype=dtype,
                     device=cuda)
    before = dict(stencil_matvec.launches_by_table)
    y = stencil_matvec(vals, x, grid)
    assert y.dtype == dtype
    assert stencil_matvec.launches_by_table["bfloat16"] == (
        before["bfloat16"] + 1)
    y_ref = stencil_matvec_reference(vals, x, grid)
    torch.cuda.synchronize()
    assert torch.equal(y, y_ref)
    # x off 16 bytes: the kernel reads its windows point by point
    x_off = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)[1:]
    x_off.copy_(x)
    assert torch.equal(stencil_matvec(vals, x_off, grid), y_ref)
    other = torch.float32 if dtype == torch.float64 else torch.float64
    with pytest.raises(TypeError):
        stencil_matvec(vals.to(other), x, grid)
    with pytest.raises(TypeError):
        stencil_matvec(vals, x.to(torch.bfloat16), grid)


@pytest.mark.parametrize("shape,q,g,uniform", [
    ((48, 2), 2, 1, False),        # the 1D reference slab
    ((50, 12), 11, 3, True),       # the runtime-shape split kernel
    ((50, 12), 11, 3, False),
    ((1000, 8), 8, 3, False),      # hex DG-1, per-cell tables
    ((1000, 8), 8, 3, True),       # hex DG-1, uniform box
    ((77, 3), 3, 2, False),        # triangles
    ((50, 10), 11, 3, True),       # degree-2 shapes: the element form
    ((50, 10), 11, 3, False),
    ((1029, 27), 27, 3, True),     # no whole block of cells
    ((1029, 27), 27, 3, False),
    ((333, 10), 64, 3, False),
    ((129, 9), 9, 2, True),
    ((129, 6), 16, 2, False),
    ((5, 3), 3, 1, False),
    ((1029, 8), 8, 3, True),       # no whole warp or block of cells
    ((1029, 8), 8, 3, False),
    ((5, 8), 8, 3, True),
    ((77, 3), 9, 2, False),        # more points than local dofs
    ((64, 4), 4, 2, True),         # quads of a uniform box
    ((50, 8), 13, 3, True),        # the most points that travel by value
    ((50, 8), 14, 3, True),        # one more: shared memory
])
@pytest.mark.parametrize("prepared", [False, True])
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
@pytest.mark.parametrize("c_mass,with_src", [(1.0, False), (3.5e6, True)])
def test_dg_cell_residual_kernel(cuda, shape, q, g, uniform, dtype, rtol,
                                 c_mass, with_src, prepared):
    from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
        PreparedDGCellResidual,
        dg_cell_residual,
        dg_cell_residual_reference,
        table_path,
    )

    rng = np.random.default_rng(2)
    c, nloc = shape
    t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)  # noqa: E731
    lead = () if uniform else (c,)
    Tc = t(700 + 100 * rng.random(shape))
    Tpc = t(700 + 100 * rng.random(shape))
    dTc = t(rng.standard_normal(shape))
    qw = t(0.1 + rng.random(lead + (q,)))
    gphi = t(rng.standard_normal(lead + (q, nloc, g)))
    phi = t(rng.random((q, nloc)))
    src = t(rng.standard_normal((c, q))) if with_src else None
    kw = dict(dt=0.1, c_diff=0.8, f_src=0.3, c_mass=c_mass)
    before = dg_cell_residual.launches
    direct = lambda u: dg_cell_residual(u, Tpc, qw, gphi, phi,  # noqa: E731
                                        source_q=src, **kw)
    fn = direct
    if prepared:
        call = PreparedDGCellResidual(qw, gphi, phi, src)
        assert call.path == table_path(nloc, q, g, qw.element_size(), uniform)
        fn = lambda u: call(u, Tpc, **kw)  # noqa: E731
        assert torch.equal(fn(Tc), direct(Tc))     # either kernel, same bits
        before = dg_cell_residual.launches
    y, dy = torch.func.jvp(fn, (Tc,), (dTc,))
    assert dg_cell_residual.launches == before + 2   # primal + tangent
    ref = dg_cell_residual_reference
    want = ref(Tc, Tpc, qw, gphi, phi, source_q=src, **kw)
    mag = ref(Tc.abs(), -Tpc.abs(), qw, gphi.abs(), phi,
              source_q=None if src is None else -src.abs(),
              **dict(kw, f_src=-0.3))
    zero = torch.zeros_like(Tc)
    dwant = ref(dTc, zero, qw, gphi, phi, **dict(kw, f_src=0.0))
    dmag = ref(dTc.abs(), zero, qw, gphi.abs(), phi, **dict(kw, f_src=0.0))
    torch.cuda.synchronize()
    assert ((y - want).abs() <= rtol * mag).all()
    assert ((dy - dwant).abs() <= rtol * dmag).all()
    assert ((fn(Tc) - want).abs() <= rtol * mag).all()   # outside jvp too


# every degree-2 cell shape on the tables of the port's HeatOperator:
# nloc 3 (the DG-2 slab, per cell), 6 (triangles, per cell, q 16), 9
# (quads, uniform), 10 (tetrahedra, per cell, q 64: 62 KB of shared memory
# a block in f64) and 27 (hexes, uniform, q 27)
DEGREE2 = {
    "interval": (lambda m: m.reference_glass_mesh_1d(), "DG"),
    "triangle": (lambda m: m.box_mesh_2d(9, 7, cell_type="triangle"), "CG"),
    "quadrilateral": (lambda m: m.box_mesh_2d(40, 33, 2.0, 1.0), "CG"),
    "tetrahedron": (lambda m: m.box_mesh_3d(4, 4, 3, cell_type="tet"), "CG"),
    "hexahedron": (lambda m: m.box_mesh_3d(16, 16, 4, 1.0, 1.0, 0.01), "CG"),
}


@pytest.mark.parametrize("cell", sorted(DEGREE2))
@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
def test_dg_cell_residual_kernel_at_degree_two(cuda, cell, dtype, rtol):
    from fem_glass_tempering_tpu_torch.config import ModelParams
    from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
        dg_cell_residual,
        dg_cell_residual_reference,
    )
    from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator

    mk, fam = DEGREE2[cell]
    heat = HeatOperator(FunctionSpace(mk(tmesh), fam, 2), ModelParams(), 0.1,
                        dtype=dtype, device=cuda)
    qw, gphi, phi = heat.qw, heat.gphi, heat.phi
    shape = tuple(heat.dofmap.shape)
    rng = np.random.default_rng(4)
    t = lambda a: torch.tensor(a, dtype=dtype, device=cuda)  # noqa: E731
    Tc = t(700 + 100 * rng.random(shape))
    Tpc = t(700 + 100 * rng.random(shape))
    dTc = t(rng.standard_normal(shape))
    kw = dict(dt=0.1, c_diff=heat.c_diff, f_src=0.3, c_mass=heat.c_mass)
    call = heat._cell_term
    assert call.path == "element"
    fn = lambda u: call(u, Tpc, **kw)  # noqa: E731
    direct = dg_cell_residual(Tc, Tpc, qw, gphi, phi, **kw)
    assert torch.equal(fn(Tc), direct)          # either call, same bits
    before = dg_cell_residual.launches
    y, dy = torch.func.jvp(fn, (Tc,), (dTc,))
    assert dg_cell_residual.launches == before + 2
    ref = dg_cell_residual_reference
    want = ref(Tc, Tpc, qw, gphi, phi, **kw)
    mag = ref(Tc.abs(), -Tpc.abs(), qw, gphi.abs(), phi.abs(),
              **dict(kw, f_src=-0.3))
    zero = torch.zeros_like(Tc)
    dwant = ref(dTc, zero, qw, gphi, phi, **dict(kw, f_src=0.0))
    dmag = ref(dTc.abs(), zero, qw, gphi.abs(), phi.abs(),
               **dict(kw, f_src=0.0))
    torch.cuda.synchronize()
    assert ((y - want).abs() <= rtol * mag).all()
    assert ((dy - dwant).abs() <= rtol * dmag).all()


def test_dg_cell_residual_paths(cuda):
    """The degree-2 shapes take the element form, uniform or per cell, in
    the prepared and the direct call; the degree-1 shapes keep the row
    kernel ("param") and the split kernel ("shared")."""
    from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
        ELEMENT_SHAPES,
        PreparedDGCellResidual,
    )

    rng = np.random.default_rng(8)
    t = lambda *s: torch.tensor(rng.random(s), device=cuda)  # noqa: E731
    for nloc, g in ELEMENT_SHAPES:
        for lead in ((), (7,)):
            call = PreparedDGCellResidual(t(*lead, 5), t(*lead, 5, nloc, g),
                                          t(5, nloc))
            assert call.path == "element"
            assert call.bake_bytes > 0 and call.bake_seconds >= 0.0
    for nloc, g, lead, path in ((8, 3, (), "param"), (4, 2, (), "param"),
                                (2, 1, (), "param"), (8, 3, (7,), "shared"),
                                (3, 2, (7,), "shared"), (4, 3, (), "shared")):
        call = PreparedDGCellResidual(t(*lead, 4), t(*lead, 4, nloc, g),
                                      t(4, nloc))
        assert call.path == path and call.bake_bytes is None


def test_batching_rule_launches_once_over_uniform_tables(cuda):
    """solver/direct.py's dense Jacobian vmaps the jvp: over uniform
    tables K3 launches once for all the columns' tangents; the Jacobian
    equals the CPU's."""
    from fem_glass_tempering_tpu_torch.config import ModelParams
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.fem.mesh import interval_mesh
    from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
        dg_cell_residual,
    )
    from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
    from fem_glass_tempering_tpu_torch.solver.direct import (
        materialize_jacobian,
    )

    fs = FunctionSpace(interval_mesh(24), "DG", 1)
    J = {}
    for where in ("cpu", cuda):
        op = HeatOperator(fs, ModelParams(), 0.1, device=where)
        T = torch.linspace(800.0, 830.0, fs.n_scalar_dofs,
                           dtype=torch.float64, device=op.device)
        before = dg_cell_residual.launches
        J[str(where)] = materialize_jacobian(
            lambda u: op.residual(u, T - 1.0), T).cpu()
        if where == cuda:
            assert dg_cell_residual.launches == before + 2
    a, b = J["cpu"], J[str(cuda)]
    assert ((a - b).abs() <= 1e-12 * a.abs().max()).all()


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import stencil_matvec

    v = torch.zeros((27, 4, 6), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        stencil_matvec(v, torch.zeros(24, device=cuda, dtype=torch.float16),
                       (4, 3, 2))
    v = torch.zeros((27, 6, 4), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        stencil_matvec(v, torch.zeros(24, device=cuda), (4, 3, 2))
    # bf16 tables off the 16-byte pitch (n = 30: contiguous tables start
    # every 60 bytes) or off 16 bytes themselves
    v = torch.zeros((27, 5, 6), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16"):
        stencil_matvec(v, torch.zeros(30, device=cuda), (5, 3, 2))
    v = torch.zeros(27 * 32 + 1, device=cuda,
                    dtype=torch.bfloat16)[1:].as_strided((27, 4, 6),
                                                         (32, 6, 1))
    with pytest.raises(ValueError, match="16"):
        stencil_matvec(v, torch.zeros(24, device=cuda), (4, 3, 2))

    from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
        dg_cell_residual,
    )
    z = lambda *s, **k: torch.zeros(s, device=cuda, **k)  # noqa: E731
    kw = dict(dt=0.1, c_diff=1.0, f_src=0.0)
    with pytest.raises(TypeError):
        dg_cell_residual(z(4, 2, dtype=torch.float16),
                         z(4, 2, dtype=torch.float16),
                         z(4, 2, dtype=torch.float16),
                         z(4, 2, 2, 1, dtype=torch.float16),
                         z(2, 2, dtype=torch.float16), **kw)
    with pytest.raises(TypeError, match="mixed"):
        dg_cell_residual(z(4, 2), z(4, 2), z(4, 2), z(4, 2, 2, 1),
                         z(2, 2, dtype=torch.float64), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        dg_cell_residual(z(2, 4).T, z(4, 2), z(4, 2), z(4, 2, 2, 1),
                         z(2, 2), **kw)
    with pytest.raises(ValueError, match="one CUDA device"):
        dg_cell_residual(z(4, 2), z(4, 2).cpu(), z(4, 2), z(4, 2, 2, 1),
                         z(2, 2), **kw)
    with pytest.raises(ValueError, match="nloc <="):
        dg_cell_residual(z(4, 40), z(4, 40), z(4, 2), z(4, 2, 40, 1),
                         z(2, 40), **kw)


def test_problem_on_cuda_matches_cpu(cuda):
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem

    cfg = tc.RunConfig(
        fe=tc.FEConfig(T_family="CG", T_degree=1),
        time=tc.TimeConfig(0.0, 0.4, 0.1),
        solver=tc.SolverConfig(newton_rtol=1e-10, newton_atol=1e-9,
                               cg_rtol=1e-10, cg_max_it=2000,
                               linear_operator="stencil",
                               preconditioner="mg"),
        output=tc.OutputConfig(write_every=0, formats=()))
    out = []
    for dev in ("cpu", "cuda"):
        p = ThermoViscoProblem(mesh=box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01),
                               config=cfg, device=dev)
        p.setup()
        out.append(p.multi_step(p.state, 4))
    (sc, okc, nc, _), (sg, okg, ng, _) = out
    assert okc and okg and nc == ng
    T_c, T_g = sc.T.numpy(), sg.T.cpu().numpy()
    assert np.abs(T_c - T_g).max() / np.abs(T_c).max() < 1e-9


def test_default_workload_on_cuda_matches_cpu(cuda):
    """The default configuration (DG-1 slab, SA-AMG, matrix-free CG), 10
    steps: equal iteration counts (in 1D every scatter target receives at
    most two addends, so the atomics' order cannot change a sum)."""
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.ops.cuda_dg_cell import (
        dg_cell_residual,
    )

    cfg = tc.RunConfig(time=tc.TimeConfig(0.0, 1.0, 0.1),
                       output=tc.OutputConfig(write_every=0, formats=()))
    out = {}
    for dev in ("cpu", "cuda"):
        p = ThermoViscoProblem(config=cfg, device=dev)
        p.setup()
        before = dg_cell_residual.launches
        st = p.solve()
        out[dev] = (st, p.diagnostics, dg_cell_residual.launches - before)
    (sc, dc, lc), (sg, dg, lg) = out["cpu"], out["cuda"]
    assert lc == 0 and lg == dg.newton_iters + 2 * (
        dg.newton_iters + dg.krylov_iters)
    assert (dc.newton_iters, dc.krylov_iters) == (dg.newton_iters,
                                                  dg.krylov_iters)
    T_c, T_g = sc.T.numpy(), sg.T.cpu().numpy()
    assert np.abs(T_c - T_g).max() / np.abs(T_c).max() < 1e-12


def test_grouped_scatter_repeats_its_bits(cuda):
    """The gather path's scatter-adds (ops/scatter.py) on the card: the
    same bits on every run, and those of the CPU's sequential index_add,
    for a CG-1 hex dofmap (8 addends per interior node)."""
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.ops.scatter import GroupedScatter

    fs = FunctionSpace(box_mesh_3d(40, 40, 10), "CG", 1)
    flat = torch.as_tensor(fs.dofmap.reshape(-1).astype(np.int64))
    rng = np.random.default_rng(0)
    src = torch.tensor(rng.standard_normal((len(flat), 3)) * 10.0
                       ** rng.integers(-8, 8, (len(flat), 3)))
    sc = GroupedScatter(fs.dofmap, fs.n_scalar_dofs, cuda)
    x = src.to(cuda)
    first, second = sc(x, (3,)), sc(x, (3,))
    want = torch.zeros(fs.n_scalar_dofs, 3, dtype=src.dtype).index_add_(
        0, flat, src)
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), want)


def test_dg_residual_repeats_its_bits(cuda):
    """The SIPG gather residual and its jvp on the card, twice: equal bits
    (the cell, boundary and facet sums are grouped scatter-adds)."""
    from fem_glass_tempering_tpu_torch.config import ModelParams
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator

    op = HeatOperator(FunctionSpace(box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01),
                                    "DG", 1), ModelParams(), 0.1,
                      device=cuda)
    rng = np.random.default_rng(1)
    T = torch.tensor(700.0 + 50.0 * rng.random(op.n_dofs), device=cuda)
    Tp = T + 1.0
    v = torch.tensor(rng.standard_normal(op.n_dofs), device=cuda)
    runs = [torch.func.jvp(lambda u: op.residual(u, Tp), (T,), (v,))
            for _ in range(2)]
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_q2mg_coarse_levels_launch_k2(cuda, dtype):
    """Every smoothed level of the CG-2 path's coarse V-cycle (the CG-1
    GeometricMG that Q2MG builds) applies its Jacobian through K2 on the
    card (one launch a call), equal bit for bit to its plain twin on the
    same tables (K2 is built without contraction)."""
    from fem_glass_tempering_tpu_torch.config import ModelParams
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
        stencil_matvec,
        stencil_matvec_reference,
    )
    from fem_glass_tempering_tpu_torch.ops.grid2 import GridHeatOperator2, Q2MG
    from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator

    def heat(m, degree=1):
        return HeatOperator(FunctionSpace(m, "CG", degree), ModelParams(),
                            0.1, dtype=dtype, device=cuda)

    mesh = box_mesh_3d(32, 32, 8, 1.0, 1.0, 0.01)
    mg = Q2MG(GridHeatOperator2(heat(mesh, 2)), heat).gmg
    smoothed = [lv for lv in mg.levels if lv.coarse_dims is not None]
    assert len(smoothed) >= 2
    rng = np.random.default_rng(2)
    n0 = int(np.prod([n + 1 for n in mg.levels[0].fine_dims]))
    T0 = torch.tensor(700.0 + 100.0 * rng.random(n0), dtype=dtype,
                      device=cuda)
    for lvl, Tl in zip(mg.levels, mg.linearization_states(T0)):
        if lvl.coarse_dims is None:
            continue
        op = mg._grid_for(lvl)
        vals = op.stencil_values(Tl, 0.1)
        x = torch.tensor(rng.standard_normal(op.n), dtype=dtype,
                         device=cuda)
        mv = op.make_matvec(Tl, 0.1)
        before = stencil_matvec.launches
        y = mv(x)
        assert stencil_matvec.launches == before + 1
        want = stencil_matvec_reference(vals.reshape(27, op.grid[0], -1),
                                        x, op.grid)
        torch.cuda.synchronize()
        assert torch.equal(y, want)


def test_grid2_jacobian_action_repeats_its_bits(cuda):
    """GridHeatOperator2's residual, diagonal and Jacobian action on the
    card, twice: equal bits (the face adds are plane adds, no atomics),
    and within 1e-12 of the CPU's."""
    from fem_glass_tempering_tpu_torch.config import ModelParams
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.ops.grid2 import GridHeatOperator2
    from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator

    fs = FunctionSpace(box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01), "CG", 2)
    rng = np.random.default_rng(3)
    T = 700.0 + 100.0 * rng.random(fs.n_scalar_dofs)
    Tp = T + rng.normal(0.0, 2.0, fs.n_scalar_dofs)
    v = rng.standard_normal(fs.n_scalar_dofs)
    out = {}
    for dev in ("cpu", cuda):
        g = GridHeatOperator2(HeatOperator(fs, ModelParams(), 0.1,
                                           device=dev))
        t = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)
        runs = [(g.residual(t(T), t(Tp)), g.jacobian_diag(t(T)),
                 g.make_matvec(t(T), 0.1)(t(v))) for _ in range(2)]
        for a, b in zip(*runs):
            assert torch.equal(a, b)
        out[str(dev)] = [a.cpu().numpy() for a in runs[0]]
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()


def test_two_gloo_ranks_on_one_card(cuda):
    """Two ranks on one card over gloo (NCCL refuses two ranks on one
    device): all_reduce_sum's tangent and the summed all-gather on CUDA
    tensors, shard_problem on the DG box and the graded slab (K3 on each
    rank's cells) and the CGDD hex box, every rank in lockstep and each
    run held to the unsharded run on the card at the CPU tests' bounds
    (tests/test_torch_parallel.py)."""
    import torch_parallel_ranks as R
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )
    from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks

    res = run_ranks(R.card_body, 2, "cuda:0", backend="gloo", timeout=600)
    col = [r["collectives"] for r in res]
    t = sum(2 * c["x"] * c["v"] for c in col)
    for c in col:
        np.testing.assert_allclose(c["t"], t, rtol=1e-15)
        assert np.array_equal(c["gathered"].view(np.int64),
                              c["all_gather"].view(np.int64))
    for name in ("dg1_2d", "slab"):
        ref = R.solve_problem(name, device=cuda)
        for r in res:
            got = r["shard"][name]
            assert (got["newton"], got["cg"]) == (ref["newton"], ref["cg"])
            np.testing.assert_array_equal(got["T"], res[0]["shard"][name]["T"])
            np.testing.assert_allclose(got["T"], ref["T"], rtol=1e-12,
                                       atol=1e-10)
    prob = ThermoViscoProblem(mesh=R.CGDD_CASES["hex"][0](),
                              config=R.cgdd_config("hex"), device=cuda)
    prob.setup()
    T_ref = prob.solve().T.cpu().numpy()
    for r in res:
        got = r["cgdd"]["hex"]
        assert all(got["ok"]) and got["newton"] == res[0]["cgdd"]["hex"][
            "newton"]
        np.testing.assert_allclose(got["T"], T_ref, rtol=1e-10, atol=1e-9)


def test_dd_two_gloo_ranks_on_one_card(cuda):
    """DDProblem on the graded slab over two gloo ranks on one card (K3
    on each rank's cells, K1 in its material step, the halo through the
    host), every rank in lockstep and held to the unsharded run on the
    card at JAX's tolerances (tests/test_domain_decomposition.py); the
    jvp of each rank's residual equal to its rows of the unsharded heat
    operator's."""
    import torch_dd_ranks as R
    from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks

    res = run_ranks(R.card_body, 2, "cuda:0", backend="gloo", timeout=600)
    ref = R.unsharded("slab", device=cuda)
    for r in res:
        assert all(r["ok"])
        assert (r["newton"], r["cg"]) == (res[0]["newton"], res[0]["cg"])
        np.testing.assert_array_equal(r["T"], res[0]["T"])
        t = r["tangent"]
        np.testing.assert_allclose(t["local"], t["unsharded"], rtol=0,
                                   atol=1e-12 * np.abs(t["unsharded"]).max())
    np.testing.assert_allclose(res[0]["T"], ref["end"]["T"], rtol=1e-10,
                               atol=1e-9)
    np.testing.assert_allclose(res[0]["sigma"], ref["end"]["sigma"],
                               rtol=1e-8, atol=1e-12)
    for f in R.STATE_FIELDS:
        np.testing.assert_allclose(res[0]["gathered"][f],
                                   ref["at_gather"][f], rtol=1e-9,
                                   atol=1e-11, err_msg=f)


def test_grid_shard_mechanics_two_gloo_ranks_on_one_card(cuda):
    """GridShardedProblem with equilibrium mechanics over two gloo ranks
    on one card: the 8x6x4 plate of tests/test_grid_elasticity.py:75-111
    (2 steps) held to the unsharded ThermoViscoProblem on the card (T, Tf
    rtol 1e-10; sigma, total strain and du within 1e-6 of their max; heat
    counts equal), the ranks in lockstep; GridElastMG's rank form with
    the point smoother bit-equal to the unsharded cycle on the card."""
    import torch_grid_shard_mech_ranks as M
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )
    from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks

    res = run_ranks(M.card_body, 2, "cuda:0", backend="gloo", timeout=600)
    dims, cfg, _ = M.CASES["plate"]
    prob = ThermoViscoProblem(mesh=M.R.plate(dims), config=cfg(),
                              device=cuda)
    prob.setup()
    st = prob.solve()
    for r in res:
        got = r["plate"]
        assert got["ok"] and (got["newton"], got["cg"]) == (
            prob.diagnostics.newton_iters, prob.diagnostics.krylov_iters)
        for f in M.STEP_FIELDS:
            assert np.array_equal(got[f], res[0]["plate"][f])
            ref = getattr(st, f).cpu().numpy()
            if f in ("T", "Tf"):
                np.testing.assert_allclose(got[f], ref, rtol=1e-10, atol=0)
            else:
                assert np.abs(got[f] - ref).max() <= 1e-6 * np.abs(ref).max()
        assert np.array_equal(r["mg_point"]["x"],
                              res[0]["mg_point"]["unsharded"])


def test_grid_shard_dg_two_gloo_ranks_on_one_card(cuda):
    """GridShardedProblem with DG-1 T over two gloo ranks on one card:
    tests/test_grid_dg.py's `_run_cfg` on a 9x4x3 plate (one ghost cell
    layer), 2 steps, held to the unsharded ThermoViscoProblem on the card
    at that test's tolerances (T 1e-9 and sigma 1e-8 of their max, CG at
    most 2x + 8), the ranks in lockstep."""
    import torch_grid_shard_dg_ranks as R
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )
    from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks

    res = run_ranks(R.card_body, 2, "cuda:0", backend="gloo", timeout=600)
    dims, cfg, steps = R.CASES["pad1"]
    prob = ThermoViscoProblem(mesh=box_mesh_3d(*dims), config=cfg(tc),
                              device=cuda)
    prob.setup()
    st, ok, ni, ki = prob.multi_step(prob.state, steps)
    assert ok
    for r in res:
        got = r["pad1"]
        assert got["ok"] and got["cell_pad0"] == 1
        assert got["cg"] <= 2 * ki + 8
        for f, tol in (("T", 1e-9), ("sigma", 1e-8)):
            ref = getattr(st, f).cpu().numpy()
            assert np.array_equal(got[f], res[0]["pad1"][f])
            assert np.abs(got[f] - ref).max() <= tol * np.abs(ref).max()


def test_grid_shard_q2_two_gloo_ranks_on_one_card(cuda):
    """GridShardedProblem with CG-2 T over two gloo ranks on one card:
    tests/test_grid2.py:237's config on a 5x4x3 plate (11 lattice planes
    and one ghost plane, 6 node planes), 1 step, held to the unsharded
    ThermoViscoProblem on the card at that test's tolerances (T 1e-9 and
    sigma 1e-8 of their max), Newton equal, CG within max(5, 2%), the
    ranks in lockstep."""
    import torch_grid_shard_q2_ranks as R
    from fem_glass_tempering_tpu_torch import config as tc
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )
    from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks

    res = run_ranks(R.card_body, 2, "cuda:0", backend="gloo", timeout=600)
    dims, cfg, steps = R.CASES["drift"]
    prob = ThermoViscoProblem(mesh=box_mesh_3d(*dims), config=cfg(tc),
                              device=cuda)
    prob.setup()
    st, ok, ni, ki = prob.multi_step(prob.state, steps)
    assert ok
    for r in res:
        got = r["drift"]
        assert got["ok"] and got["lat_pad0"] == 1 and got["newton"] == ni
        assert abs(got["cg"] - ki) <= max(5, 0.02 * ki)
        for f, tol in (("T", 1e-9), ("sigma", 1e-8)):
            ref = getattr(st, f).cpu().numpy()
            assert np.array_equal(got[f], res[0]["drift"][f])
            assert np.abs(got[f] - ref).max() <= tol * np.abs(ref).max()


def test_grid_shard_two_gloo_ranks_on_one_card(cuda):
    """GridShardedProblem over two gloo ranks on one card: the 12x6x4
    plate of tests/test_grid_mg.py (3 steps) held to the unsharded
    ThermoViscoProblem on the card (T, Tf rtol 1e-10, sigma 1e-6 of its
    max), the ranks in lockstep; GridMG's 'smooth' rank form, every level
    sharded, bit-equal to the unsharded cycle on the card, its matvecs all
    K2's halo form."""
    import torch_grid_shard_ranks as R
    from fem_glass_tempering_tpu_torch.models.problem import (
        ThermoViscoProblem,
    )
    from fem_glass_tempering_tpu_torch.parallel.comm import run_ranks

    res = run_ranks(R.card_body, 2, "cuda:0", backend="gloo", timeout=600)
    dims, cfg, _ = R.CASES["grid_mg"]
    prob = ThermoViscoProblem(mesh=R.plate(dims), config=cfg(), device=cuda)
    prob.setup()
    st = prob.solve()
    ref = {f: getattr(st, f).cpu().numpy() for f in R.STEP_FIELDS}
    for r in res:
        got = r["grid_mg"]
        assert got["ok"] and got["newton"] == prob.diagnostics.newton_iters
        for f in R.STEP_FIELDS:
            assert np.array_equal(got[f], res[0]["grid_mg"][f])
        for f in ("T", "Tf"):
            np.testing.assert_allclose(got[f], ref[f], rtol=1e-10, atol=0)
        scale = np.abs(ref["sigma"]).max()
        np.testing.assert_allclose(got["sigma"] / scale,
                                   ref["sigma"] / scale, atol=1e-6)
    x = R.mg_apply("smooth", res[0]["mg_smooth"]["pad0"], device=cuda)
    for r in res:
        assert all(r["mg_smooth"]["sharded"])
        assert np.array_equal(r["mg_smooth"]["x"], x)
        assert r["k2"]["full"] == 0 and r["k2"]["halo"] > 0
