"""The launch path of the cell-residual kernel (K3) and the tile decisions
of the material kernel (K1), as far as the CPU reaches them.

`PreparedDGCellResidual` checks the static tables once and each call's
`Tc`, `Tpc` alone; on the CPU it runs the plain version, so every
comparison here is exact (`torch.equal`): the same function on the same
inputs, whichever way the call is made. The packing of uniform tables for
the row kernel's parameter struct and the choice between the parameter
path and the shared-memory path are plain Python and are tested at their
boundary.
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
from fem_glass_tempering_tpu_torch.models.viscoelastic import LAMBDA_M_N, M_N
from fem_glass_tempering_tpu_torch.ops import cuda_dg_cell as dgc
from fem_glass_tempering_tpu_torch.ops.assembly import build_cell_geometry
from fem_glass_tempering_tpu_torch.ops.cuda_kernels import (
    material_tspace,
    material_tspace_reference,
)
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator

MESHES = {
    "slab1d": lambda: tmesh.reference_glass_mesh_1d(),
    "tri2d": lambda: tmesh.box_mesh_2d(4, 3, cell_type="triangle"),
    "hex3d": lambda: tmesh.box_mesh_3d(3, 3, 2, 1.0, 1.0, 0.01),
}
KW = dict(dt=0.1, c_diff=0.9, f_src=0.4, c_mass=3.5e6)


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _case(name, fam, uniform, seed=7):
    mesh = MESHES[name]()
    fs = FunctionSpace(mesh, fam, 1)
    cg = build_cell_geometry(mesh, fs)
    rng = np.random.default_rng(seed)
    shape = fs.dofmap.shape
    qw, gphi = np.asarray(cg.qweights), np.asarray(cg.grad_phys)
    if uniform:
        qw, gphi = qw[0], gphi[0]
    return dict(Tc=_t(700 + 100 * rng.random(shape)),
                Tpc=_t(700 + 100 * rng.random(shape)),
                dTc=_t(rng.standard_normal(shape)), qw=_t(qw), gphi=_t(gphi),
                phi=_t(cg.phi),
                src=_t(rng.standard_normal((shape[0], cg.phi.shape[0]))))


CASES = [(n, f, False) for n in MESHES for f in ("DG", "CG")] + [
    ("hex3d", "DG", True), ("hex3d", "CG", True)]


@pytest.mark.parametrize("name,fam,uniform", CASES)
@pytest.mark.parametrize("with_src", [False, True])
def test_prepared_call_equals_direct_call(name, fam, uniform, with_src):
    c = _case(name, fam, uniform)
    src = c["src"] if with_src else None
    call = dgc.PreparedDGCellResidual(c["qw"], c["gphi"], c["phi"], src)
    assert call.path == "plain" and call.uniform == uniform
    want = dgc.dg_cell_residual(c["Tc"], c["Tpc"], c["qw"], c["gphi"],
                                c["phi"], source_q=src, **KW)
    assert torch.equal(call(c["Tc"], c["Tpc"], **KW), want)
    # forward mode: primal and tangent through torch.func.jvp
    y, dy = torch.func.jvp(lambda u: call(u, c["Tpc"], **KW), (c["Tc"],),
                           (c["dTc"],))
    yd, dyd = torch.func.jvp(
        lambda u: dgc.dg_cell_residual(u, c["Tpc"], c["qw"], c["gphi"],
                                       c["phi"], source_q=src, **KW),
        (c["Tc"],), (c["dTc"],))
    assert torch.equal(y, want) and torch.equal(yd, want)
    assert torch.equal(dy, dyd)
    # the tangent is the map on the tangents with the source terms zero
    lin = dgc.dg_cell_residual_reference(
        c["dTc"], torch.zeros_like(c["dTc"]), c["qw"], c["gphi"], c["phi"],
        **dict(KW, f_src=0.0))
    assert torch.equal(dy, lin)


def test_prepared_call_in_both_arguments_and_plain_forward_ad():
    c = _case("tri2d", "DG", False)
    call = dgc.PreparedDGCellResidual(c["qw"], c["gphi"], c["phi"], c["src"])
    ones = torch.ones_like(c["Tpc"])
    _, dy = torch.func.jvp(lambda a, b: call(a, b, **KW),
                           (c["Tc"], c["Tpc"]), (c["dTc"], ones))
    want = dgc.dg_cell_residual_reference(
        c["dTc"], ones, c["qw"], c["gphi"], c["phi"], **dict(KW, f_src=0.0))
    assert torch.equal(dy, want)
    # torch.autograd.forward_ad duals (no functorch) carry their tangent too
    with fwAD.dual_level():
        out = call(fwAD.make_dual(c["Tc"], c["dTc"]), c["Tpc"], **KW)
        tangent = fwAD.unpack_dual(out).tangent
    want = dgc.dg_cell_residual_reference(
        c["dTc"], torch.zeros_like(ones), c["qw"], c["gphi"], c["phi"],
        **dict(KW, f_src=0.0))
    assert torch.equal(tangent, want)


def test_routes_of_a_call(monkeypatch):
    """Outside forward mode nothing can carry a tangent: the call goes
    straight to one launch, past the dispatcher and past autograd. Under
    torch.func.jvp or a dual level it launches twice through the dispatcher
    op, which hands the launch tensors that own their storage; an input
    that records for a backward pass goes through the Function."""
    c = _case("slab1d", "DG", False)
    call = dgc.PreparedDGCellResidual(c["qw"], c["gphi"], c["phi"])
    want = call(c["Tc"], c["Tpc"], **KW)
    assert not dgc._forward_mode()
    seen = []
    torch.func.jvp(lambda u: seen.append(dgc._forward_mode()) or u,
                   (c["Tc"],), (c["dTc"],))
    with fwAD.dual_level():
        seen.append(dgc._forward_mode())
    assert seen == [True, True]

    runs = []
    run = dgc.PreparedDGCellResidual.run

    def counted(self, Tc, Tpc, *a):
        runs.append((type(Tc) is torch.Tensor, Tc.data_ptr() != 0, a[-1]))
        return run(self, Tc, Tpc, *a)

    monkeypatch.setattr(dgc.PreparedDGCellResidual, "run", counted)
    direct = lambda u: dgc.dg_cell_residual(  # noqa: E731
        u, c["Tpc"], c["qw"], c["gphi"], c["phi"], **KW)
    for fn in (lambda u: call(u, c["Tpc"], **KW), direct):
        del runs[:]
        y, dy = torch.func.jvp(fn, (c["Tc"],), (c["dTc"],))
        # primal with the source terms, tangent without
        assert runs == [(True, True, True), (True, True, False)]
        assert torch.equal(y, want)
        del runs[:]
        y2, dy2 = torch.func.jvp(lambda u: fn(2.0 * u), (c["Tc"],),
                                 (c["dTc"],))
        assert len(runs) == 2 and torch.equal(dy2, 2.0 * dy)

    def refuse(*a, **k):
        raise AssertionError("a plain call left the short path")

    monkeypatch.setattr(dgc, "_forward_mode", lambda: False)
    monkeypatch.setattr(dgc._NoBackward, "apply", refuse)
    monkeypatch.setattr(dgc.fwAD, "unpack_dual", refuse)
    del runs[:]
    assert torch.equal(call(c["Tc"], c["Tpc"], **KW), want)
    assert torch.equal(direct(c["Tc"]), want)
    assert len(runs) == 2
    with pytest.raises(AssertionError, match="short path"):
        call(c["Tc"].clone().requires_grad_(True), c["Tpc"], **KW)
    with torch.no_grad():
        assert torch.equal(
            call(c["Tc"].clone().requires_grad_(True), c["Tpc"], **KW), want)


def test_prepared_calls_are_found_by_id_and_forgotten_with_the_object():
    c = _case("slab1d", "DG", False)
    call = dgc.PreparedDGCellResidual(c["qw"], c["gphi"], c["phi"])
    other = dgc.PreparedDGCellResidual(c["qw"], c["gphi"], c["phi"])
    assert call._id != other._id and dgc._PREPARED[call._id] is call
    key = other._id
    del other
    assert key not in dgc._PREPARED


def test_prepared_call_backward_raises():
    c = _case("slab1d", "DG", False)
    call = dgc.PreparedDGCellResidual(c["qw"], c["gphi"], c["phi"])
    r = call(c["Tc"].clone().requires_grad_(True), c["Tpc"], **KW)
    with pytest.raises(NotImplementedError, match="reverse-mode"):
        r.sum().backward()


@pytest.mark.parametrize("bad,exc,match", [
    (dict(Tc=torch.zeros(48, 3, dtype=torch.float64)), ValueError, "Tc, Tpc"),
    (dict(Tpc=torch.zeros(47, 2, dtype=torch.float64)), ValueError,
     "Tc, Tpc"),
    (dict(Tc=torch.zeros(47, 2, dtype=torch.float64),
          Tpc=torch.zeros(47, 2, dtype=torch.float64)), ValueError,
     r"\(48, 2\)"),
    (dict(Tc=torch.zeros(96, dtype=torch.float64)), ValueError, "Tc, Tpc"),
    (dict(Tc=torch.zeros(48, 2, dtype=torch.float32)), TypeError, "mixed"),
    (dict(Tpc=torch.zeros(48, 2, dtype=torch.float32)), TypeError, "mixed"),
    (dict(Tc=torch.zeros(2, 48, dtype=torch.float64).T), ValueError,
     "contiguous"),
    (dict(Tpc=torch.zeros(48, 4, dtype=torch.float64)[:, ::2]), ValueError,
     "contiguous"),
])
def test_prepared_call_rejects_wrong_rows(bad, exc, match):
    c = _case("slab1d", "DG", False)
    call = dgc.PreparedDGCellResidual(c["qw"], c["gphi"], c["phi"], c["src"])
    c.update(bad)
    with pytest.raises(exc, match=match):
        call(c["Tc"], c["Tpc"], **KW)
    # under forward-mode AD the same checks guard both launches
    if c["Tc"].shape == c["dTc"].shape and c["Tc"].dtype == torch.float64:
        with pytest.raises(exc, match=match):
            torch.func.jvp(lambda u: call(u, c["Tpc"], **KW),
                           (c["Tc"],), (c["dTc"],))


@pytest.mark.parametrize("bad,exc,match", [
    (dict(phi=np.zeros(4)), ValueError, "phi must be"),
    (dict(qw=np.zeros((48, 3))), ValueError, "expected qw"),
    (dict(gphi=np.zeros((48, 2, 3, 1))), ValueError, "expected qw"),
    (dict(gphi=np.zeros((2, 2, 1))), ValueError, "expected qw"),
    (dict(src=np.zeros((48, 3))), ValueError, "source_q must be"),
    (dict(src=np.zeros((47, 2))), ValueError, "source_q must be"),
    (dict(phi=np.zeros((2, 2), dtype=np.float32)), TypeError, "mixed"),
])
def test_prepared_call_rejects_wrong_tables_when_built(bad, exc, match):
    c = {k: v.numpy() for k, v in _case("slab1d", "DG", False).items()}
    c.update(bad)
    t = lambda a: torch.tensor(a)  # noqa: E731  keeps the array's dtype
    with pytest.raises(exc, match=match):
        dgc.PreparedDGCellResidual(t(c["qw"]), t(c["gphi"]), t(c["phi"]),
                                   t(c["src"]))


def test_uniform_prepared_call_takes_any_cell_count_unless_a_source_fixes_it():
    c = _case("hex3d", "DG", True)
    call = dgc.PreparedDGCellResidual(c["qw"], c["gphi"], c["phi"])
    assert call.cells is None
    for n in (1, 5, 18):
        got = call(c["Tc"][:n].contiguous(), c["Tpc"][:n].contiguous(), **KW)
        assert torch.equal(got, dgc.dg_cell_residual_reference(
            c["Tc"][:n], c["Tpc"][:n], c["qw"], c["gphi"], c["phi"], **KW))
    with_src = dgc.PreparedDGCellResidual(c["qw"], c["gphi"], c["phi"],
                                          c["src"])
    assert with_src.cells == 18
    with pytest.raises(ValueError, match="Tc, Tpc"):
        with_src(c["Tc"][:5].contiguous(), c["Tpc"][:5].contiguous(), **KW)


# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", ["slab1d", "hex3d"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_uniform_table_packing_round_trips(name, dtype):
    c = _case(name, "DG", True)
    qw, gphi, phi = (c[k].numpy().astype(dtype) for k in ("qw", "gphi",
                                                            "phi"))
    q, nloc, g = gphi.shape
    packed = dgc.pack_uniform_tables(qw, gphi, phi)
    assert packed.dtype == dtype and packed.flags["C_CONTIGUOUS"]
    assert packed.nbytes == dgc.packed_table_bytes(nloc, q, g,
                                                   packed.itemsize)
    # the record of point q: phi[q, :], qw[q], gphi[q, :, :]
    rec = packed.reshape(q, -1)
    assert np.array_equal(rec[1, :nloc], phi[1])
    assert rec[1, nloc] == qw[1]
    assert np.array_equal(rec[1, nloc + 1:], gphi[1].reshape(-1))
    for got, want in zip(dgc.unpack_uniform_tables(packed, nloc, g),
                         (qw, gphi, phi)):
        assert got.dtype == dtype and np.array_equal(got, want)


@pytest.mark.parametrize("nloc,g,itemsize", [(8, 3, 8), (8, 3, 4), (4, 2, 8),
                                             (2, 1, 4)])
def test_table_path_is_chosen_by_size_at_the_boundary(nloc, g, itemsize):
    rec = (nloc * (1 + g) + 1) * itemsize
    q_fit = dgc.PARAM_TABLE_BYTES // rec
    assert dgc.packed_table_bytes(nloc, q_fit, g, itemsize) \
        <= dgc.PARAM_TABLE_BYTES < dgc.packed_table_bytes(
            nloc, q_fit + 1, g, itemsize)
    assert dgc.table_path(nloc, q_fit, g, itemsize, True) == "param"
    assert dgc.table_path(nloc, q_fit + 1, g, itemsize, True) == "shared"
    assert dgc.table_path(nloc, 1, g, itemsize, True) == "param"
    # per-cell tables never travel by value
    assert dgc.table_path(nloc, 1, g, itemsize, False) == "shared"


def test_table_path_of_the_shapes_on_the_main_paths():
    # the hex DG-1 plate (f64, 8 points) fits the parameters with room
    assert dgc.packed_table_bytes(8, 8, 3, 8) == 2112
    assert dgc.table_path(8, 8, 3, 8, True) == "param"
    # cells the row kernel has no instantiation for stay in device memory
    assert dgc.table_path(3, 9, 2, 8, True) == "shared"
    # the degree-2 cells take the element form, uniform or per cell
    for nloc, g in dgc.ELEMENT_SHAPES:
        for uniform in (True, False):
            assert dgc.table_path(nloc, 27, g, 8, uniform) == "element"
    assert dgc.table_path(27, 27, 3, 4, True) == "element"
    # the struct and the other arguments fit a kernel's 4 KB of parameters
    assert dgc.PARAM_TABLE_BYTES + 128 <= 4096


# ----------------------------------------------------------------------
def _heat(name, fam, source):
    mesh = MESHES[name]()
    fs = FunctionSpace(mesh, fam, 1)
    rng = np.random.default_rng(3)
    src = rng.standard_normal(fs.n_scalar_dofs) if source else None
    op = HeatOperator(fs, ModelParams(), 0.1, device="cpu", source=src)
    T = _t(800 + 50 * rng.random(fs.n_scalar_dofs))
    return op, T, T - _t(rng.random(fs.n_scalar_dofs)), _t(
        rng.standard_normal(fs.n_scalar_dofs))


@pytest.mark.parametrize("name,fam", [("slab1d", "DG"), ("hex3d", "DG"),
                                      ("hex3d", "CG"), ("tri2d", "CG")])
@pytest.mark.parametrize("source", [False, True])
def test_heat_operator_is_unchanged_by_the_prepared_call(name, fam, source):
    """Residual and Jacobian action through the operator's prepared call
    against the same operator calling `dg_cell_residual` with its tables
    on every evaluation: bit for bit."""
    op, T, T_prev, v = _heat(name, fam, source)
    assert isinstance(op._cell_term, dgc.PreparedDGCellResidual)
    assert op._cell_term.uniform == (name == "hex3d")
    r = op.residual(T, T_prev)
    _, Jv = torch.func.jvp(lambda u: op.residual(u, T_prev), (T,), (v,))
    r_half = op.residual(T, T_prev, dt=0.05)
    op._cell_term = lambda Tc, Tpc, **kw: dgc.dg_cell_residual(
        Tc, Tpc, op.qw, op.gphi, op.phi, source_q=op.source_q, **kw)
    assert torch.equal(op.residual(T, T_prev), r)
    assert torch.equal(op.residual(T, T_prev, dt=0.05), r_half)
    _, Jv_direct = torch.func.jvp(lambda u: op.residual(u, T_prev), (T,),
                                  (v,))
    assert torch.equal(Jv_direct, Jv)
    assert bool(torch.isfinite(r).all()) and float(Jv.abs().max()) > 0


# ----------------------------------------------------------------------
@pytest.mark.parametrize("n", [7, 255, 256, 257, 1000])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_material_tspace_wrapper_on_ragged_sizes_and_views(n, dtype):
    """The wrapper on the CPU at sizes around the kernel's 256-dof tile
    and on a Tf_partial that is a view one element into a larger buffer:
    the plain version, whatever the size or the alignment."""
    rng = np.random.default_rng(n)
    T = torch.tensor(700 + 100 * rng.random(n), dtype=dtype)
    Tp = T + torch.tensor(rng.normal(0, 3, n), dtype=dtype)
    flat = torch.tensor(750 + 50 * rng.random(6 * n + 1), dtype=dtype)
    view = flat[1:].view(n, 6)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    kw = dict(dt=0.1, H_over_Rg=627.8e3 / 8.314, Tb=869.0, m_n=M_N,
              lambda_m_n=LAMBDA_M_N)
    got = material_tspace(T, Tp, view, **kw)
    want = material_tspace_reference(T, Tp, view.clone(), **kw)
    assert [tuple(g.shape) for g in got] == [(n,), (n, 6), (n,), (n,)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
