"""Distribution over torch.distributed ranks (counterpart of
fem_glass_tempering_tpu/parallel): the collectives (comm.py), cell-axis
sharding of a ThermoViscoProblem (sharding.py), the partition
(partition.py), the DG and CG domain decompositions (domain.py,
domain_cg.py), the grid-sharded step (grid_shard.py; the rank forms of
its CG-2 lattice route, RankQ2MG and its transfers, live beside the
lattice operator in ops/grid2.py) and its multi-process entry
(multihost.py)."""

from fem_glass_tempering_tpu_torch.ops.grid2 import (  # noqa: F401
    LatticeHalo,
    LatticeNodeTransfers,
    RankQ2MG,
)
from fem_glass_tempering_tpu_torch.parallel.comm import (  # noqa: F401
    make_device_mesh,
)
from fem_glass_tempering_tpu_torch.parallel.domain import (  # noqa: F401
    DDProblem,
)
from fem_glass_tempering_tpu_torch.parallel.domain_cg import (  # noqa: F401
    CGDDProblem,
)
from fem_glass_tempering_tpu_torch.parallel.grid_shard import (  # noqa: F401
    GridShardedProblem,
)
from fem_glass_tempering_tpu_torch.parallel.multihost import (  # noqa: F401
    gather_to_host,
    global_device_mesh,
    initialize,
    make_multihost_problem,
)
from fem_glass_tempering_tpu_torch.parallel.partition import (  # noqa: F401
    build_dd_layout,
    partition_cells,
)
from fem_glass_tempering_tpu_torch.parallel.sharding import (  # noqa: F401
    shard_problem,
)
