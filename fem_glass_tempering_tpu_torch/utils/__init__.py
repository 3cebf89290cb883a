"""utils layer of the PyTorch port (counterpart of fem_glass_tempering_tpu/utils)."""
