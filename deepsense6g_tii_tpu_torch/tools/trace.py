"""Device traces on the card by torch.profiler, shared by ``chip_smoke.py``
and ``tools/profile_step.py``.

On the card's machine the profiler now and then returns a trace with no
device events at all, or one that lacks some launches.  So a trace that
holds no device event is taken again (up to ``tries`` times); a trace of
several calls reports the events it dropped, counted as the launches
missing from the kernel names whose count is not a whole multiple of the
calls traced; and ``device_ms`` falls back to CUDA events
(``tools/timing.py::time_ms``), saying so, where the trace cannot be
trusted.

A kernel event is a device event that is not a user annotation: ranges
opened by ``record_function`` (the optimizer's step, ``profile_step``'s
site ranges) also appear on the device's timeline, spanning the kernels
inside them, and are no kernels.
"""

from __future__ import annotations

import json
import math
import time
from collections import Counter, defaultdict


def traced(fn, tries: int = 3, device="cuda"):
    """Runs ``fn`` under torch.profiler (CPU and, on the card, CUDA
    activities) and returns (every event, the device kernel events, host
    wall time in us).  A trace on the card without device events is taken
    again, up to ``tries`` times; if none has any the kernels are []."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    for _ in range(tries if on_card else 1):
        if on_card:
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            if on_card:
                torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = list(prof.events())
        kernels = kernel_events(events)
        if kernels or not on_card:
            return events, kernels, wall_us
    print(f"traced: the profiler recorded no device time in {tries} "
          f"traces")
    return events, [], wall_us


def kernel_events(events):
    """The device kernels among a trace's events: its device events but
    the user annotations (a ``record_function`` range, such as the
    optimizer's ``Optimizer.step#AdamW.step``, spans the kernels inside it
    on the device's timeline too)."""
    import torch
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("<")[0].split("(")[0].split("::")[-1].strip()
    return name.split()[-1] if name else name


def dropped_events(kernels, calls: int) -> int:
    """The launches a trace of ``calls`` calls lacks, as far as it shows:
    for every kernel name whose count is not a whole multiple of
    ``calls``, the events that would make it one (0 for one call)."""
    counts = Counter(e.name for e in kernels)
    return sum(math.ceil(n / calls) * calls - n for n in counts.values())


def device_ms(fn, iters: int = 20, warmup: int = 3, tries: int = 3) -> float:
    """Device time of one call of ``fn``: the summed time of the kernels it
    launches, from torch.profiler, averaged over ``iters`` calls.  Unlike
    ``timing.time_ms``, it excludes the gaps while the host enqueues.
    Every kernel name must occur a multiple of ``iters`` times in the
    trace; a trace where one does not (the profiler on the card's machine
    now and then drops device events, at times in every trace of a run) is
    taken again, up to ``tries`` times.  If the last trace still lacks
    events, a call's time is each kernel's mean time times its launches a
    call (its count over ``iters``, rounded), provided that the events
    missing are at most 5% of those expected; else (seen on some of the
    card's machines: 5-10% missing in every trace) it is timed by CUDA
    events (``timing.time_ms``).  The line printed says which, and how
    many events the last trace dropped."""
    from . import timing
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()

    for _ in range(tries):
        _, kernels, _ = traced(run)
        counts = Counter(e.name for e in kernels)
        if counts and all(n % iters == 0 for n in counts.values()):
            return sum(e.time_range.elapsed_us() for e in kernels) / iters / 1e3
    if not counts:
        ms = timing.time_ms(fn, "cuda", iters=iters, warmup=0)
        print(f"device_ms: the profiler recorded no device time: timed by "
              f"CUDA events, {ms:.6g} ms")
        return ms
    per_call = {name: round(n / iters) for name, n in counts.items()}
    missing = sum(abs(per_call[name] * iters - n)
                  for name, n in counts.items())
    expected = iters * sum(per_call.values())
    if min(per_call.values()) == 0 or missing > 0.05 * expected:
        ms = timing.time_ms(fn, "cuda", iters=iters, warmup=0)
        print(f"device_ms: {tries} traces dropped device events; the last "
              f"lacks {missing} of {expected}: timed by CUDA events, "
              f"{ms:.6g} ms")
        return ms
    us = defaultdict(float)
    for e in kernels:
        us[e.name] += e.time_range.elapsed_us()
    print(f"device_ms: {tries} traces dropped device events; the last "
          f"lacks {missing} of {expected}, timed by each kernel's mean")
    return sum(us[name] / counts[name] * per_call[name]
               for name in counts) / 1e3


def busy_us(kernels) -> float:
    """The time at least one kernel of the trace ran, overlaps counted
    once."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted((k.time_range.start, k.time_range.end)
                       for k in kernels):
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    return busy


def profile_call(fn, label, top: int = 8):
    """Traces one call of ``fn`` and prints its device busy share of the
    host wall time and the kernels that take the most device time (None
    where the profiler recorded no device time).  A trace of one call
    cannot show dropped events; the traces of several calls
    (``device_ms``, ``profile_step``) count them."""
    _, kernels, wall_us = traced(fn)
    if not kernels:
        out = {"wall_ms": wall_us / 1e3, "device_busy_ms": None,
               "idle_share": None, "kernel_launches": None}
        print(f"{label}: " + json.dumps(out))
        return out
    busy = busy_us(kernels)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / wall_us if wall_us else None,
           "kernel_launches": len(kernels),
           "top_kernels": [{"name": n[:80], "count": c, "ms": t / 1e3}
                           for n, (c, t) in ranked]}
    print(f"{label}: " + json.dumps(out))
    return out
