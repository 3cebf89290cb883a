"""Compact npz time-series recorder: stacked snapshots of selected fields.

Counterpart of fem_glass_tempering_tpu/io/series.py, the default output
path (OutputConfig.formats): device->host copies at snapshot cadence only,
one compressed .npz at the end with the times and stacked field arrays.
"""

from __future__ import annotations

import os

import numpy as np


class NPZSeriesWriter:
    def __init__(self, path: str, fields: tuple = ("T", "Tf", "phi", "xi", "sigma")):
        self.path = path
        self.fields = fields
        self.times: list[float] = []
        self.data: dict[str, list] = {f: [] for f in fields}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, t: float, state) -> None:
        self.times.append(float(t))
        for f in self.fields:
            self.data[f].append(getattr(state, f).detach().cpu().numpy())

    def close(self, **extra_arrays) -> None:
        arrays = {f: np.stack(v) for f, v in self.data.items() if v}
        np.savez_compressed(self.path, times=np.asarray(self.times),
                            **arrays, **extra_arrays)
