"""The hand-written CUDA kernels against their plain PyTorch twins, on the
card. Marked `gpu`: they skip where no CUDA device is visible, and run on
the GPU machine with `python -m pytest tests/test_torch_cuda_kernels.py`.

The kernels round every operation as the plain versions do (the library
is built with -fmad=false), so K2 is held to equality and K1 to the
rounding of exp and of the plain 6-term dot product (rtol 1e-12 in f64,
2e-6 in f32).
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


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-6)])
def test_material_tspace_kernel(cuda, dtype, rtol):
    from fem_glass_tempering_tpu_torch.models.viscoelastic import (
        LAMBDA_M_N,
        M_N,
    )
    from fem_glass_tempering_tpu_torch.ops.cuda_kernels import (
        material_tspace,
        material_tspace_reference,
    )

    rng = np.random.default_rng(0)
    n = 100_003
    T = torch.tensor(700.0 + 100 * rng.random(n), dtype=dtype, device=cuda)
    Tp = T + torch.tensor(rng.normal(0, 5, n), dtype=dtype, device=cuda)
    Tfp = torch.tensor(750.0 + 50 * rng.random((n, 6)), dtype=dtype,
                       device=cuda)
    kw = dict(dt=0.1, H_over_Rg=627.8e3 / 8.314, Tb=869.0, m_n=M_N,
              lambda_m_n=LAMBDA_M_N)
    before = material_tspace.launches
    out = material_tspace(T, Tp, Tfp, **kw)
    assert material_tspace.launches == before + 1
    ref = material_tspace_reference(T, Tp, Tfp, **kw)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        scale = r.abs().max()
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


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from fem_glass_tempering_tpu_torch.ops.cuda_stencil import stencil_matvec

    v = torch.zeros((27, 4, 6), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        stencil_matvec(v, torch.zeros(24, device=cuda, dtype=torch.float16),
                       (4, 3, 2))
    v = torch.zeros((27, 6, 4), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        stencil_matvec(v, torch.zeros(24, device=cuda), (4, 3, 2))


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
