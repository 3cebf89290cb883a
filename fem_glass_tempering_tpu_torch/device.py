"""Device and dtype resolution shared by every entry point."""

from __future__ import annotations

import torch

_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """`None` means the GPU. Asking for CUDA where none is visible raises:
    nothing in this package quietly falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def resolve_dtype(dtype) -> torch.dtype:
    """'float64' / 'float32' / a torch dtype -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None
