"""Checkpoint / resume of the full simulation state.

Counterpart of fem_glass_tempering_tpu/io/checkpoint.py, and the same file
format: every history field of the ViscoState, the time and a snapshot of
the configuration in one npz, so a checkpoint written by either package
resumes in the other. `load_checkpoint` restores a ViscoState ready to
continue stepping.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.device import resolve_device, resolve_dtype
from fem_glass_tempering_tpu_torch.models.viscoelastic import ViscoState


def save_checkpoint(path: str, state: ViscoState, config=None,
                    extra: dict | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f: getattr(state, f).detach().cpu().numpy()
              for f in ViscoState._fields if getattr(state, f) is not None}
    meta = {"fields": list(arrays)}
    if config is not None:
        meta["config"] = json.loads(config.to_json())
    if extra:
        meta["extra"] = extra
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrays)


def load_checkpoint(path: str, dtype=None, device=None):
    """Returns (state, meta) with the state's tensors on `device` (None =
    the GPU), cast to `dtype` if given."""
    dev = resolve_device(device)
    dt = None if dtype is None else resolve_dtype(dtype)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        kwargs = {f: torch.as_tensor(z[f], dtype=dt, device=dev)
                  for f in ViscoState._fields if f in z.files}
    return ViscoState(**kwargs), meta
