"""Device traces by torch.profiler, reduced to plain tuples.

A frozen copy of the program's trace helpers (``tools/trace.py``): a trace
that holds no device event is taken again, since the profiler on the card
now and then returns one; a kernel event is a device event that is not a
user annotation; busy time is the union of kernel intervals.  The
categories are those of ``tools/profile_step.py``, by kernel name.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import List, Tuple

# name patterns of the categories, tried in this order
CATEGORIES = (
    ("attention kernels", ("flash_",)),
    ("scan kernels", ("scan_",)),
    ("collectives", ("nccl",)),
    ("optimizer", ("multi_tensor_apply", "_foreach_", "adam")),
    ("memcpy/memset", ("memcpy", "memset")),
    ("elementwise and reduction", ("bn_", "batch_norm", "batchnorm")),
    ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                     "winograd")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "cublas", "xmma", "s16816")),
    ("elementwise and reduction", ("at::native", "elementwise", "reduce")),
)


@dataclass
class Trace:
    """Kernels (name, start us, end us), host ops (name, start us, end us)
    and the traced window (start us, end us) on the same clock, with the
    units of work (steps or requests) it covers."""

    kernels: List[Tuple[str, float, float]]
    host_ops: List[Tuple[str, float, float]]
    window: Tuple[float, float]
    units: int
    extra: dict = field(default_factory=dict)

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces, template arguments
    and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("<")[0].split("(")[0].split("::")[-1].strip()
    return name.split()[-1] if name else name


def category(name: str) -> str:
    low = name.lower()
    for label, patterns in CATEGORIES:
        if any(p in low for p in patterns):
            return label
    return "other"


def busy_us(kernels) -> float:
    """The time at least one kernel ran, overlaps counted once."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted((k[1], k[2]) for k in kernels):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


def idle_gaps(kernels, window):
    """The intervals of the window in which no kernel ran."""
    gaps, end = [], window[0]
    for s, e in sorted((k[1], k[2]) for k in kernels):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if window[1] > end:
        gaps.append((end, window[1]))
    return gaps


def traced(fn, units: int, device="cuda", tries: int = 3) -> Trace:
    """Runs ``fn`` under torch.profiler with CPU and CUDA activities and
    returns its trace; one without device events is taken again, up to
    ``tries`` times (``fn`` runs again each time).  On the CPU (the
    benchmark's own tests) the host's ``aten::`` ops stand in for kernels,
    so that the readers run; no device number comes from such a trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    for _ in range(tries):
        if on_card:
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            with torch.profiler.record_function("bench_window"):
                fn()
                if on_card:
                    torch.cuda.synchronize()
        kernels, host, window = [], [], None
        for e in prof.events():
            tr = e.time_range
            if e.name == "bench_window" and e.device_type == DeviceType.CPU:
                window = (tr.start, tr.end)
            elif e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    kernels.append((e.name, tr.start, tr.end))
            else:
                host.append((e.name, tr.start, tr.end))
                if not on_card and e.name.startswith("aten::"):
                    kernels.append((e.name, tr.start, tr.end))
        if kernels and window is not None:
            return Trace(kernels, host, window, units)
        time.sleep(0.1)
    raise RuntimeError(f"the profiler recorded no device event in {tries} "
                       f"traces")


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device categories that took the most time, and the longest idle
    time by the innermost host op running at each gap's middle."""
    by_cat = defaultdict(float)
    for name, s, e in trace.kernels:
        by_cat[category(name)] += (e - s) / 1e6
    ops = sorted(trace.host_ops, key=lambda o: o[1])
    starts = [o[1] for o in ops]
    by_host = defaultdict(float)
    for g0, g1 in idle_gaps(trace.kernels, trace.window):
        mid = 0.5 * (g0 + g1)
        label = "(no host op)"
        # nested ops start later than what holds them: the latest-starting
        # op that covers the middle is the innermost
        i = bisect.bisect_right(starts, mid)
        for name, s, e in reversed(ops[max(0, i - 5000):i]):
            if e >= mid:
                label = name
                break
        by_host[label] += (g1 - g0) / 1e6
    rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(by_cat), "idle_gaps": rank(by_host)}
