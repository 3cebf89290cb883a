"""io layer of the PyTorch port (counterpart of fem_glass_tempering_tpu/io);
the per-rank series and checkpoints of a grid-sharded run are in
sharded.py."""

from fem_glass_tempering_tpu_torch.io.sharded import (  # noqa: F401
    PlaneLayout,
    ShardedSeriesWriter,
    load_sharded_checkpoint,
    read_sharded_series,
    save_sharded_checkpoint,
)
