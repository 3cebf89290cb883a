"""Multi-process entry of the grid-sharded step.

Counterpart of fem_glass_tempering_tpu/parallel/multihost.py, where every
host process calls `jax.distributed.initialize` and then runs the same
GSPMD program. Here every process is one rank of a torch.distributed
group (parallel/comm.py) on one device: `initialize` starts the group,
from an explicit coordinator or from torchrun's environment
(`python -m torch.distributed.run --nproc-per-node N script.py`), and
`make_multihost_problem` builds the GridShardedProblem over it. Ranks
are ordered as the group numbers them, so rank r's slab of planes lies
beside those of ranks r - 1 and r + 1, and torchrun's contiguous ranks on
a host keep most halos on that host.
"""

from __future__ import annotations

import os

from fem_glass_tempering_tpu_torch.parallel.comm import (
    DeviceMesh,
    all_gather,
    make_device_mesh,
)
from fem_glass_tempering_tpu_torch.parallel.grid_shard import (
    GridShardedProblem,
)

_MESH: DeviceMesh | None = None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, local_device_ids=None, *,
               backend: str | None = None, device=None) -> DeviceMesh:
    """Join the process group (JAX's `initialize`); call once per process.
    `coordinator_address` "host:port" (rank 0 listens there) with
    `num_processes` and `process_id`; without it the group starts from
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT),
    or as a group of one. The process computes on CUDA device
    `local_device_ids` (one id), else on cuda:LOCAL_RANK; `device` names
    another ("cpu"). `backend` defaults to the device's (NCCL for CUDA):
    gloo lets several ranks share one card, which NCCL refuses."""
    global _MESH
    if device is None:
        if local_device_ids is not None:
            ids = ([local_device_ids] if isinstance(local_device_ids, int)
                   else list(local_device_ids))
            if len(ids) != 1:
                raise ValueError(f"one CUDA device a process, not {ids}")
            device = f"cuda:{ids[0]}"
        else:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    init_method = where = None
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id")
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
        where = dict(rank=int(process_id), world_size=int(num_processes))
    _MESH = make_device_mesh(device, backend=backend,
                             init_method=init_method, **(where or {}))
    return _MESH


def global_device_mesh() -> DeviceMesh:
    """This process's DeviceMesh over every rank (the one `initialize`
    made; without it, `make_device_mesh()`'s)."""
    global _MESH
    if _MESH is None:
        _MESH = make_device_mesh()
    return _MESH


def make_multihost_problem(mesh, config, **kwargs):
    """GridShardedProblem over every rank of the group. Every process must
    call this with identical arguments."""
    return GridShardedProblem(mesh, config, global_device_mesh(), **kwargs)


def gather_to_host(state, device_mesh: DeviceMesh | None = None):
    """Every field of a rank-sharded state, all-gathered to numpy on every
    process: the padded layout's rows in rank order, ghost planes
    included (JAX's `gather_to_host`; GridShardedProblem.gather_state
    drops the ghosts). Every rank must call it."""
    dm = device_mesh if device_mesh is not None else global_device_mesh()

    def f(a):
        if a is None:
            return None
        if a.dim():
            a = all_gather(a.contiguous(), dm)
        return a.cpu().numpy()
    return type(state)(*(f(a) for a in state))

