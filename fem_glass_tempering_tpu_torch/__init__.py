"""fem_glass_tempering_tpu_torch — the PyTorch + CUDA port of
fem_glass_tempering_tpu, the coupled thermo-viscoelastic glass-tempering
FEM framework.

The JAX package beside it is the reference this package is tested
against. Layout mirrors it, so each module's counterpart sits at the same
path:
  - fem/      mesh, element tabulation, function spaces (numpy)
  - ops/      heat operator, stencil and grid operators, elasticity
              operators, generic weak forms (forms.py), interpolation,
              grouped scatter-adds, and the hand-written CUDA kernels
              (cuda_kernels.py, cuda_stencil.py, cuda_dg_cell.py; sources
              under csrc/, beside the native host runtime runtime.cpp)
  - solver/   Newton, preconditioned CG, dense-LU Newton (direct.py),
              geometric multigrid (heat and the vector elasticity
              V-cycle), SA-AMG
  - models/   thermal + viscoelastic physics, equilibrium mechanics, the
              problem driver, the temper analysis
  - io/       npz, VTU and XDMF time series, checkpoints
  - parallel/ distribution over torch.distributed: the collectives, cell-
              axis sharding of a problem, the partition, the CG domain
              decomposition
  - utils/    logging helpers, phase timers, the torch.profiler trace,
              the native runtime's bindings (native.py)
  - main.py   the command line (python -m fem_glass_tempering_tpu_torch.main)

Entry points run on the GPU (`device="cuda"`, the default) and raise when
no GPU is visible, unless the caller asks for `device="cpu"`, where every
kernel runs as its plain PyTorch twin.
"""

__version__ = "0.1.0"

from fem_glass_tempering_tpu_torch.config import (  # noqa: F401
    FEConfig,
    ModelParams,
    OutputConfig,
    RunConfig,
    SolverConfig,
    TimeConfig,
    default_model_params,
)
