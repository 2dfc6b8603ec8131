"""Device time of the selective-scan forward kernel at the MambaFuser's
serving shapes, through the package of the checkout at ``--root``, so that
two checkouts can be timed in turn on one card:

    python3 deepsense6g_tii_tpu_torch/tools/time_scan_fwd.py --root PATH

PATH defaults to the checkout that holds this file.  The shapes are those
of a serving forward at batch 8: bf16 u, B and C (B and C contiguous), f32
dt and A, L = 962 at d = 128, 256, 512, 1024 and L = 5 at d = 1024, both
directions, no autograd (so no ``h_in``).  Each is the kernel's device
time per call from torch.profiler over ``--iters`` calls, every pass it
runs included (``PASSES``: a call that splits L into groups runs a state,
a carry and an output pass); ``per_forward``
weights them as a serving forward launches them (16 at each stage's
d_inner, 3 at L = 5, forward direction).  Prints the card's name and power
limit, then one JSON line.  Imports only torch and the timed package.
"""

import argparse
import json
import os
import subprocess
import sys

SHAPES = ((962, 128), (962, 256), (962, 512), (962, 1024), (5, 1024))
LAUNCHES = {(962, 128): 16, (962, 256): 16, (962, 512): 16, (962, 1024): 16,
            (5, 1024): 3}
BATCH, D_STATE = 8, 16
# the names of the forward's device kernels, in this checkout and before
# it (one kernel, scan_fwd_kernel, a call)
PASSES = ("scan_fwd_kernel", "scan_carry_kernel")


def kernel_ms(fn, iters, tries=3):
    """Per-call device time of the kernels named by PASSES that ``fn``
    launches, from a trace of ``iters`` calls; a trace whose launches are
    not a multiple of the calls (the profiler dropped some) is taken again,
    up to ``tries`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and any(tag in e.name for tag in PASSES)]
        if times and len(times) % iters == 0:
            return sum(times) / iters / 1e3
    raise RuntimeError(f"{tries} traces held {len(times)} launches of "
                       f"{PASSES} for {iters} calls")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    if not os.path.abspath(ss.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {ss.__file__}, not from {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = {}
    for L, d in SHAPES:
        rnd = lambda *s: torch.randn(*s, device="cuda", generator=gen)  # noqa: E731
        u = rnd(BATCH, L, d).to(torch.bfloat16)
        dt = F.softplus(rnd(BATCH, L, d))
        A = -torch.arange(1, D_STATE + 1, dtype=torch.float32,
                          device="cuda").expand(d, D_STATE).contiguous()
        B, C = (rnd(BATCH, L, D_STATE).to(torch.bfloat16) for _ in range(2))
        for reverse in (False, True):
            rows[f"L={L} d={d} reverse={reverse}"] = kernel_ms(
                lambda: ss.selective_scan_fwd(u, dt, A, B, C,
                                              reverse=reverse), args.iters)
    per_forward = sum(n * rows[f"L={L} d={d} reverse=False"]
                      for (L, d), n in LAUNCHES.items())
    print(json.dumps({"root": root, "card": card, "ms": rows,
                      "per_forward_ms": per_forward}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
