"""The timing helper the port's kernel tools share (bench_scan, bench_flash,
scan_roofline): per-call time of a function on the card by CUDA events,
and the card's name, power limit and data-sheet rates from nvidia-smi.

On a CUDA device a time is ``torch.cuda.Event`` pairs around ``iters``
calls after a warm-up, the least of ``reps`` samples divided by ``iters``.
The calls are queued behind a spin kernel (``torch.cuda._sleep``) that
keeps the card busy while the host enqueues them, so the events measure
the card's time back to back, not the host's gaps between launches (unless
the host takes longer than the spin: a loop of thousands of small
launches, as the plain versions are, stays host-bound).  On the CPU
(tests only) it is the host clock around the same loop; a tool's ``main``
refuses to run without CUDA, so no CPU time is printed as a device time.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import os
import subprocess
import sys
import time

FP32_LANES_PER_SM = 128      # Hopper: FP32 units per SM, one FMUL a clock
SFU_PER_SM_CLOCK = 16        # exp2 a clock per SM (compute capability 9.0)
SPIN_CYCLES = 20_000_000     # ~10 ms of the card's time ahead of the host


def require_cuda(what: str) -> None:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} times kernels on the card and needs CUDA "
                           f"(torch.cuda.is_available() is False)")


def time_ms(fn, device="cuda", iters: int = 20, warmup: int = 3,
            reps: int = 3) -> float:
    """Milliseconds per call of ``fn``: the least of ``reps`` samples of
    ``iters`` calls, after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        if torch.device(device).type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SPIN_CYCLES)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ms = 1e3 * (time.perf_counter() - t0)
        best = min(best, ms / iters)
    return best


_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_checkout(root, module: str):
    """``deepsense6g_tii_tpu_torch.<module>`` of the checkout at ``root``
    (None: this one).  Another checkout's package is imported under a name
    of its own, so that its kernels load beside this one's; they build
    under its root.  The kernel tools' ``--root`` rests on it."""
    if root is None:
        return importlib.import_module(f"deepsense6g_tii_tpu_torch.{module}")
    pkg = os.path.join(os.path.abspath(root), "deepsense6g_tii_tpu_torch")
    if os.path.samefile(pkg, _PACKAGE):
        return importlib.import_module(f"deepsense6g_tii_tpu_torch.{module}")
    name = "_root_" + hashlib.sha1(pkg.encode()).hexdigest()[:12]
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(pkg, "__init__.py"),
            submodule_search_locations=[pkg])
        package = importlib.util.module_from_spec(spec)
        sys.modules[name] = package
        spec.loader.exec_module(package)
    return importlib.import_module(f"{name}.{module}")


def _smi(query: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return _smi("name,power.limit").strip().splitlines()[0]


def datasheet_rates() -> dict:
    """FMULs and exponentials a second that the card's SMs can issue at
    its largest SM clock: SMs x 128 FP32 lanes x clock, and SMs x 16
    special-function results x clock."""
    import torch
    clock_hz = 1e6 * float(_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return {"sm_clock_mhz": clock_hz / 1e6, "sms": n_sm,
            "fmul_per_s": n_sm * FP32_LANES_PER_SM * clock_hz,
            "exp_per_s": n_sm * SFU_PER_SM_CLOCK * clock_hz}
