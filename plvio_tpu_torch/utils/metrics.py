"""Per-stage timing and counters (port of plvio_tpu/utils/metrics.py): an
always-on stage profiler that `System`, its tracker and its mapper share,
queryable at any time (`summary`) and written out with `dump`.  Stages
time the host's wall clock; a stage that launches kernels returns before
they finish unless it reads a result back.  For device time use
`python3 -m plvio_tpu_torch.profile_frames system`."""
from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from typing import Dict

import numpy as np


class Metrics:
    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self.values = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def add(self, name: str, value: float) -> None:
        self.values[name].append(float(value))

    def bump(self, name: str, n: int = 1) -> None:
        self.counts[name] += n

    def summary(self) -> Dict[str, dict]:
        out = {}
        for name, total in self.times.items():
            n = max(self.counts[name], 1)
            out[name] = {"total_s": round(total, 4),
                         "mean_ms": round(total / n * 1e3, 3),
                         "calls": self.counts[name]}
        for name, vals in self.values.items():
            if vals:
                out[name] = {"mean": float(np.mean(vals)),
                             "last": vals[-1], "n": len(vals)}
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=1)
