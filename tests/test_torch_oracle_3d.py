"""The port against the independent 3D numpy / scipy oracle.

Mirror of tests/test_differential_oracle.py::test_framework_matches_3d_oracle
(`fem_glass_tempering_tpu/validation/oracle_3d.py`: Kronecker closed-form
CG assembly, explicit sparse SIPG, assembled-Jacobian Newton with direct
solves, the literal material chain), for CG-1 and DG-1 on the 4x3x2 box,
10 steps, with the JAX test's bounds: T and Tf to 1e-12, phi to 1e-10, xi
and sigma to 3e-9 (their comparison carries the xi cancellation, a small
difference of near-equal exponentials).
"""

import numpy as np
import pytest

from fem_glass_tempering_tpu.validation.oracle_3d import run_oracle_3d
from fem_glass_tempering_tpu_torch.config import (
    FEConfig,
    OutputConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
)
from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("family", ["CG", "DG"])
def test_port_matches_3d_oracle(family):
    dims, lengths = (4, 3, 2), (1.0, 0.8, 0.05)
    steps = 10
    cfg = RunConfig(
        fe=FEConfig(T_family=family, T_degree=1,
                    sigma_family="CG", sigma_degree=1),
        time=TimeConfig(0.0, steps * 0.1, 0.1),
        solver=SolverConfig(newton_rtol=1e-13, newton_atol=1e-14,
                            cg_rtol=1e-13, cg_max_it=3000,
                            jac_lag="newton"),
        output=OutputConfig(write_every=0, formats=()),
        dtype="float64")
    prob = ThermoViscoProblem(mesh=box_mesh_3d(*dims, *lengths), config=cfg,
                              device="cpu")
    prob.setup()
    st = prob.solve()
    o = run_oracle_3d(dims, lengths, steps, 0.1, T_family=family)
    assert _rel(st.T.numpy(), o["T"]) < 1e-12
    assert _rel(st.Tf.numpy(), o["Tf"]) < 1e-12
    assert _rel(st.phi.numpy(), o["phi"]) < 1e-10
    assert _rel(st.xi.numpy(), o["xi"]) < 3e-9
    assert _rel(st.sigma.numpy(), o["sigma"]) < 3e-9
