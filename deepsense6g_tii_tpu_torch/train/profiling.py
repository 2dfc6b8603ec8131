"""Step timing (``deepsense6g_tii_tpu/train/profiling.py::StepTimer``).

``StepTimer`` keeps host wall-clock times between ticks: p50/p90/max per
optimizer step and samples/s.  It is cheap enough to leave on.  On the
card a tick measures the host's issue time of a step, which is the step's
time while the host is the bottleneck; ``chip_smoke.py`` and
``tools/timing.py`` time the device itself with CUDA events.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np


class StepTimer:
    def __init__(self, capacity: int = 10000):
        self._times: List[float] = []
        self._steps: List[int] = []
        self._capacity = capacity
        self._last: Optional[float] = None

    def tick(self, n_steps: int = 1) -> None:
        """Call once per dispatch; ``n_steps`` is the optimizer steps it
        covered."""
        now = time.perf_counter()
        if self._last is not None and len(self._times) < self._capacity:
            self._times.append(now - self._last)
            self._steps.append(n_steps)
        self._last = now

    def reset(self) -> None:
        self._times.clear()
        self._steps.clear()
        self._last = None

    def stats(self, batch_size: Optional[int] = None) -> Dict[str, float]:
        if not self._times:
            return {}
        t = np.asarray(self._times)
        k = np.asarray(self._steps)
        per_step = t / k                       # per optimizer step
        out = {
            "steps": float(k.sum()),
            "step_ms_p50": float(np.percentile(per_step, 50) * 1e3),
            "step_ms_p90": float(np.percentile(per_step, 90) * 1e3),
            "step_ms_max": float(per_step.max() * 1e3),
        }
        if batch_size:
            out["samples_per_sec"] = float(batch_size * k.sum() / t.sum())
        return out
