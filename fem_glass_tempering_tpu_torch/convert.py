"""Carry a viscoelastic state between the JAX package and this one.

`state_from_numpy` takes the field arrays of a state as numpy (what
`jax.device_get(state)._asdict()` gives for a JAX ViscoState) and returns
this package's ViscoState on the requested device; `state_to_numpy` is the
inverse. Neither imports JAX. Operator tables are not carried: both
packages build them from the same numpy code.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from fem_glass_tempering_tpu_torch.device import resolve_device, resolve_dtype
from fem_glass_tempering_tpu_torch.models.viscoelastic import ViscoState


def state_from_numpy(arrays: Mapping[str, np.ndarray], device=None,
                     dtype=torch.float64) -> ViscoState:
    """ViscoState from a mapping of field name -> array (missing or None
    `du` stays None)."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    missing = [f for f in ViscoState._fields
               if f != "du" and arrays.get(f) is None]
    if missing:
        raise KeyError(f"state arrays lack {missing}")
    return ViscoState(**{
        f: None if arrays.get(f) is None else torch.as_tensor(
            np.array(arrays[f]), dtype=dt, device=dev)
        for f in ViscoState._fields})


def state_to_numpy(state: ViscoState) -> dict:
    """Field name -> numpy array (host copies)."""
    return {f: None if v is None else v.detach().cpu().numpy()
            for f, v in state._asdict().items()}
