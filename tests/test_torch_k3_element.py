"""The element form of the cell term (K3 at the degree-2 cells), K2's
pitched bf16 tables and K3's batching rule, on the CPU.

On the card every degree-2 cell shape takes the element form: the cell
term is linear with per-call scalar coefficients, so r = c_mass M (Tc -
Tpc) - dt (f b + s) + dt c_diff K Tc with the element matrices baked once
from the quadrature tables. Its plain version (the bake as einsums,
`element_matrices_reference`, applied by `element_residual_reference`) is
held here to the quadrature twin `dg_cell_residual_reference` on the
port's HeatOperator tables at each degree-2 shape, and to JAX's Pallas
cell kernel in interpret mode, at 1e-12 (f64) / 1e-5 (f32) of the sum of
the terms' magnitudes, the kernels' tolerance on the card: primal and
tangent, with and without a per-point source. The bake in the kernel's
own layout (`bake_element_tables`: f64, rounded once, per-cell matrices
as packed upper triangles, entry-major, K 1 summed before rounding) is
unpacked and held to the same bars, and in f32 on a thin plate's tables
it is held to its tables' cell term in f64 at 1e-6, where the form
without the shift and the quadrature twin miss by ~5e-4. K2's bf16
tables in the pitched layout (`pitched_tables`) give the plain twin the
same bits as contiguous ones. K3's dispatcher op has a
vmap rule: one call for a batch over uniform tables, the loop over the
batch for per-cell ones, the same values as the loop either way.
"""

import jax  # noqa: F401  (JAX on the CPU, x64, via tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.ops.pallas_kernels import make_dg_cell_residual
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.ops import cuda_dg_cell as dgc
from fem_glass_tempering_tpu_torch.ops.cuda_stencil import (
    pitched_tables,
    stencil_matvec,
    stencil_matvec_reference,
)
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator
from fem_glass_tempering_tpu_torch.solver.direct import materialize_jacobian

# every degree-2 cell shape: nloc 3, 6, 9, 10, 27 (uniform tables on the
# boxes, per cell elsewhere)
CELLS = {
    "interval": (lambda: tmesh.reference_glass_mesh_1d(), "DG", (3, 1)),
    "triangle": (lambda: tmesh.box_mesh_2d(4, 3, cell_type="triangle"), "CG",
                 (6, 2)),
    "quadrilateral": (lambda: tmesh.box_mesh_2d(6, 3, 2.0, 1.0), "CG",
                      (9, 2)),
    "tetrahedron": (lambda: tmesh.box_mesh_3d(2, 2, 1, cell_type="tet"),
                    "CG", (10, 3)),
    "hexahedron": (lambda: tmesh.box_mesh_3d(3, 3, 2, 1, 1, 0.01), "CG",
                   (27, 3)),
}
KW = dict(dt=0.1, c_diff=1.3, f_src=0.7)
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _heat(cell, dtype=torch.float64):
    mk, fam, (nloc, g) = CELLS[cell]
    heat = HeatOperator(FunctionSpace(mk(), fam, 2), ModelParams(), 0.1,
                        dtype=dtype, device="cpu")
    assert tuple(heat.dofmap.shape)[1] == nloc and heat.gphi.shape[-1] == g
    assert dgc.table_path(nloc, heat.phi.shape[0], g, 8,
                          heat.qw.dim() == 1) == "element"
    return heat


def _inputs(shape, q, dtype, seed=1):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    Tc = t(700 + 100 * rng.random(shape))
    return (Tc, Tc + t(rng.normal(0.0, 3.0, shape)),
            t(rng.standard_normal(shape)),
            t(rng.standard_normal((shape[0], q))))


def _magnitude(Tc, Tpc, qw, gphi, phi, src, kw):
    """The sum of the absolute values of every term of the quadrature
    form, entry by entry: the bar's scale (the terms cancel)."""
    return dgc.dg_cell_residual_reference(
        Tc.abs(), -Tpc.abs(), qw, gphi.abs(), phi.abs(),
        source_q=None if src is None else -src.abs(),
        **dict(kw, f_src=-abs(kw["f_src"])))


def _unpack(baked, nloc, uniform):
    """The kernel's layout back to full M, K, b, k1 (and s as (cells,
    nloc))."""
    s = None if baked["s"] is None else baked["s"].T
    if uniform:
        return baked["M"], baked["K"], baked["b"], baked["k1"], s
    cells = baked["M"].shape[1]
    iu = torch.triu_indices(nloc, nloc)
    full = []
    for key in ("M", "K"):
        A = torch.zeros((cells, nloc, nloc), dtype=baked[key].dtype)
        A[:, iu[0], iu[1]] = baked[key].T
        A[:, iu[1], iu[0]] = baked[key].T
        full.append(A)
    return full[0], full[1], baked["b"].T, baked["k1"].T, s


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("with_src,c_mass", [(False, 1.0), (True, 3.5e6)])
def test_element_form_equals_the_quadrature_twin(cell, with_src, c_mass):
    """f64: the einsum bake applied to (Tc, Tpc), primal and tangent,
    against the quadrature twin at 1e-12 of the terms' magnitudes."""
    heat = _heat(cell)
    qw, gphi, phi = heat.qw, heat.gphi, heat.phi
    shape = tuple(heat.dofmap.shape)
    Tc, Tpc, dTc, src = _inputs(shape, phi.shape[0], torch.float64)
    src = src if with_src else None
    kw = dict(KW, c_mass=c_mass)
    M, K, b = dgc.element_matrices_reference(qw, gphi, phi)
    nloc = shape[1]
    assert M.shape[-2:] == K.shape[-2:] == (nloc, nloc)
    s = None if src is None else dgc.element_source_reference(qw, phi, src)
    got = dgc.element_residual_reference(Tc, Tpc, M, K, b, s=s, **kw)
    want = dgc.dg_cell_residual_reference(Tc, Tpc, qw, gphi, phi,
                                          source_q=src, **kw)
    mag = _magnitude(Tc, Tpc, qw, gphi, phi, src, kw)
    assert ((got - want).abs() <= 1e-12 * mag).all()
    zero = torch.zeros_like(Tc)
    tkw = dict(kw, f_src=0.0)
    dgot = dgc.element_residual_reference(dTc, zero, M, K, b, **tkw)
    dwant = dgc.dg_cell_residual_reference(dTc, zero, qw, gphi, phi, **tkw)
    dmag = _magnitude(dTc, zero, qw, gphi, phi, None, tkw)
    assert ((dgot - dwant).abs() <= 1e-12 * dmag).all()
    # M and K are symmetric (the per-cell bake keeps one triangle)
    assert torch.allclose(M, M.transpose(-1, -2), rtol=1e-14, atol=0)
    assert torch.allclose(K, K.transpose(-1, -2), rtol=1e-13,
                          atol=1e-13 * float(K.abs().max()))


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_baked_tables_in_the_kernel_layout(monkeypatch, cell, dtype):
    """The bake as the card keeps it (f64, rounded once to the working
    dtype; per-cell matrices as packed upper triangles), unpacked, with
    the source, primal and tangent, against the quadrature twin in that
    dtype at 1e-12 / 1e-5 of the terms' magnitudes."""
    heat = _heat(cell, dtype)
    qw, gphi, phi = heat.qw, heat.gphi, heat.phi
    shape = tuple(heat.dofmap.shape)
    nloc, uniform = shape[1], qw.dim() == 1
    Tc, Tpc, dTc, src = _inputs(shape, phi.shape[0], dtype, seed=2)
    monkeypatch.setattr(dgc, "BAKE_CHUNK_CELLS", 7)     # several chunks
    baked = dgc.bake_element_tables(qw, gphi, phi, src, dtype)
    assert all(t.dtype == dtype for t in baked.values())
    npack = nloc * (nloc + 1) // 2
    assert baked["M"].shape == ((nloc, nloc) if uniform else
                                (npack, shape[0]))
    assert baked["s"].shape == (nloc, shape[0])
    M, K, b, k1, s = _unpack(baked, nloc, uniform)
    kw = dict(KW, c_mass=3.5e6)
    for args, f_src, srcq in (((Tc, Tpc), kw["f_src"], src),
                              ((dTc, torch.zeros_like(Tc)), 0.0, None)):
        k = dict(kw, f_src=f_src)
        got = dgc.element_residual_reference(
            *args, M, K, b, s=None if srcq is None else s, k1=k1, **k)
        want = dgc.dg_cell_residual_reference(*args, qw, gphi, phi,
                                              source_q=srcq, **k)
        mag = _magnitude(*args, qw, gphi, phi, srcq, k)
        assert got.dtype == dtype
        assert ((got - want).abs() <= TOL[dtype] * mag).all()


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_element_form_equals_jax_pallas_interpret(cell, dtype):
    """The baked element form against JAX's Pallas cell kernel in
    interpret mode (per-cell tables, c_mass 1, no source), primal and
    jax.jvp's tangent, in the dtype, at 1e-12 / 1e-5 of the terms'
    magnitudes."""
    heat = _heat(cell, dtype)
    qw, gphi, phi = heat.qw, heat.gphi, heat.phi
    shape = tuple(heat.dofmap.shape)
    Tc, Tpc, dTc, _ = _inputs(shape, phi.shape[0], dtype, seed=3)
    M, K, b, k1, _ = _unpack(
        dgc.bake_element_tables(qw, gphi, phi, None, dtype), shape[1],
        qw.dim() == 1)
    kw = dict(KW, c_mass=1.0)
    qw_c = np.broadcast_to(qw.numpy(), (shape[0], phi.shape[0]))
    gphi_c = np.broadcast_to(gphi.numpy(), (shape[0],) + gphi.shape[-3:])
    pallas = make_dg_cell_residual(phi.numpy(), kw["dt"], kw["c_diff"],
                                   kw["f_src"], block_cells=16,
                                   interpret=True)
    jargs = (jnp.asarray(qw_c), jnp.asarray(gphi_c))
    y, dy = jax.jvp(lambda u: pallas(u, jnp.asarray(Tpc.numpy()), *jargs),
                    (jnp.asarray(Tc.numpy()),), (jnp.asarray(dTc.numpy()),))
    assert y.dtype == dy.dtype == np.dtype(str(dtype).split(".")[-1])
    zero = torch.zeros_like(Tc)
    tkw = dict(kw, f_src=0.0)
    for got, want, mag in (
            (dgc.element_residual_reference(Tc, Tpc, M, K, b, k1=k1, **kw), y,
             _magnitude(Tc, Tpc, qw, gphi, phi, None, kw)),
            (dgc.element_residual_reference(dTc, zero, M, K, b, k1=k1, **tkw),
             dy,
             _magnitude(dTc, zero, qw, gphi, phi, None, tkw))):
        assert (np.abs(got.numpy() - np.asarray(want))
                <= TOL[dtype] * mag.numpy()).all()


@pytest.mark.parametrize("grid", [(161, 11, 5), (9, 7, 5), (10, 8),
                                  (6, 2, 2)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pitched_bf16_tables_give_the_twin_its_bits(grid, dtype):
    """bf16 tables in the pitched layout (every table on a multiple of 8
    values; these grids' sizes are not) hold the bits of `.to(bf16)` and
    give the plain twin the same y bit for bit; the wrapper takes the
    view on the CPU as it takes any."""
    rng = np.random.default_rng(6)
    d = len(grid)
    n = int(np.prod(grid))
    vals = torch.tensor(rng.standard_normal((3 ** d,) + grid),
                        dtype=dtype).reshape(3 ** d, grid[0], -1)
    x = torch.tensor(rng.standard_normal(n), dtype=dtype)
    pitched = pitched_tables(vals)
    pitch = pitched.stride(0)
    assert pitch % 8 == 0 and n <= pitch < n + 8
    assert pitched.stride()[1:] == (vals.shape[2], 1)
    flat = vals.to(torch.bfloat16)
    assert torch.equal(pitched, flat)
    want = stencil_matvec_reference(flat, x, grid)
    assert torch.equal(stencil_matvec_reference(pitched, x, grid), want)
    assert torch.equal(stencil_matvec(pitched, x, grid), want)


def _slab(uniform, source):
    mesh = (tmesh.interval_mesh(24) if uniform
            else tmesh.reference_glass_mesh_1d())
    fs = FunctionSpace(mesh, "DG", 1)
    src = (np.random.default_rng(4).standard_normal(fs.n_scalar_dofs)
           if source else None)
    op = HeatOperator(fs, ModelParams(), 0.1, device="cpu", source=src)
    assert (op.qw.dim() == 1) == uniform
    return op, fs.n_scalar_dofs


@pytest.mark.parametrize("uniform,source", [(True, False), (False, False),
                                            (True, True)])
def test_batching_rule_folds_uniform_batches(monkeypatch, uniform, source):
    """torch.func.vmap over the jvp (solver/direct.py's dense Jacobian):
    equal to the column-by-column loop; over uniform tables the launch on
    the tangents (which carry no source) runs once for all columns, over
    per-cell tables once per column."""
    op, n = _slab(uniform, source)
    T_prev = torch.full((n,), ModelParams().T_0, dtype=torch.float64)
    T = T_prev - torch.linspace(0.0, 30.0, n, dtype=torch.float64)
    runs = []
    run = dgc.PreparedDGCellResidual.run

    def counted(self, Tc, *a, **k):
        runs.append(Tc.shape[0])
        return run(self, Tc, *a, **k)
    monkeypatch.setattr(dgc.PreparedDGCellResidual, "run", counted)
    fn = lambda u: op.residual(u, T_prev)  # noqa: E731
    J = materialize_jacobian(fn, T)
    cells = op.dofmap.shape[0]
    if uniform:
        # the residual's primal launch, then one for all n tangents
        assert runs == [cells, n * cells]
    else:
        assert runs == [cells] + [cells] * n
    runs.clear()
    eye = torch.eye(n, dtype=torch.float64)
    loop = torch.stack([torch.func.jvp(fn, (T,), (eye[i],))[1]
                        for i in range(n)]).T
    assert torch.equal(J, loop)


def test_element_form_keeps_the_cancellation_out_in_f32():
    """K Tc cancels (K's rows sum to ~0, Tc ~ 600 K). On the thin plate's
    f32 tables (12x12x4 hexes, 1 x 1 x 0.01, as phase 10b's plate) and a
    smooth T near 600 K, the baked f32 element form, K (Tc - t0) + t0 K 1
    with K 1 summed before K is rounded, computes the function of its
    tables (their cell term in f64) to 1e-6 of its largest entry, as the
    operator's prepared call bakes it; with K 1 of the rounded K it misses
    by ~4e-4, and the f32 quadrature twin by ~5e-4. Against the f64
    tables' cell term all carry the f32 tables' own ~1e-4."""
    mesh = tmesh.box_mesh_3d(12, 12, 4, 1.0, 1.0, 0.01)
    h = {d: HeatOperator(FunctionSpace(mesh, "CG", 2), ModelParams(), 0.1,
                         dtype=d, device="cpu")
         for d in (torch.float64, torch.float32)}
    x = h[torch.float64].fs.dof_coords
    T = (600.3 + 0.2 * np.cos(np.pi * x[:, 2] / 0.01)
         + 0.01 * np.sin(3.0 * x[:, 0]))
    cells = h[torch.float64].dofmap
    Tc = torch.tensor(T, dtype=torch.float32)[cells]
    Tpc = Tc + 0.05
    kw = dict(dt=0.1, c_mass=1.0, c_diff=1.0, f_src=0.0)
    h32 = h[torch.float32]
    tables = (h32.qw, h32.gphi, h32.phi)
    want = dgc.dg_cell_residual_reference(
        Tc.double(), Tpc.double(), *(t.double() for t in tables), **kw)
    scale = want.abs().max()
    err = lambda r: float((r.double() - want).abs().max() / scale)  # noqa
    e = dgc.bake_element_tables(*tables, None, torch.float32)
    assert err(dgc.element_residual_reference(
        Tc, Tpc, e["M"], e["K"], e["b"], k1=e["k1"], **kw)) <= 1e-6
    # the forms it replaces: K 1 of the rounded K, the f32 quadrature twin
    assert err(dgc.element_residual_reference(Tc, Tpc, e["M"], e["K"],
                                              e["b"], **kw)) > 1e-4
    assert err(dgc.dg_cell_residual_reference(Tc, Tpc, *tables, **kw)) > 1e-4
    # the f32 tables' own distance from the f64 tables' function
    h64 = h[torch.float64]
    want64 = dgc.dg_cell_residual_reference(Tc.double(), Tpc.double(),
                                            h64.qw, h64.gphi, h64.phi, **kw)
    assert 1e-5 < float((want - want64).abs().max() / scale) < 1e-3
