"""Distribution over torch.distributed ranks (counterpart of
fem_glass_tempering_tpu/parallel): the collectives (comm.py), cell-axis
sharding of a ThermoViscoProblem (sharding.py), the partition
(partition.py) and the CG domain decomposition (domain_cg.py)."""

from fem_glass_tempering_tpu_torch.parallel.comm import (  # noqa: F401
    make_device_mesh,
)
from fem_glass_tempering_tpu_torch.parallel.domain_cg import (  # noqa: F401
    CGDDProblem,
)
from fem_glass_tempering_tpu_torch.parallel.partition import (  # noqa: F401
    build_dd_layout,
    partition_cells,
)
from fem_glass_tempering_tpu_torch.parallel.sharding import (  # noqa: F401
    shard_problem,
)
