"""Per-op device-time breakdown of the full-width train step (the JAX
package's ``tools/profile_step.py``, torch.profiler in place of xprof).

Builds the step the way the JAX tool does, from the ``DEEPSENSE_BENCH_*``
knobs, runs a warm-up step, then traces a few more on the card and prints:

- the device's total ms a step and its busy and idle shares of the wall
  time;
- ms a step by category: the port's own kernels by their ``KERNEL`` names
  in ``ops/`` (with the wrapper's launches a step), GEMM (cuBLAS,
  CUTLASS), convolution (cuDNN), elementwise and reduction (PyTorch's own
  kernels), the optimizer (``multi_tensor_apply``), memcpy/memset, other;
- the top kernels by time;
- the convolutions by site (``image|lidar|radar_encoder`` x ``stem``,
  ``stage1-4``, the fusion stages' depthwise conv1d) and direction: the
  forward ones through ``record_function`` ranges that forward hooks open
  on those modules (named by their flax scope names), the backward ones
  through autograd's link from each backward node to the forward op that
  made it (``sequence_nr``);
- the launches the trace dropped (kernel names whose count is not a whole
  multiple of the steps), so that no sum silently shrinks.

    python -m deepsense6g_tii_tpu_torch.tools.profile_step [B] [--device cuda]

Knobs: ``DEEPSENSE_BENCH_ARCH`` (gpt, the default, or mamba), ``_B``
(default 8 on the card), ``_K`` (steps a dispatch; the port runs them one
after another), ``_GRAD_ACCUM`` (default 1), ``_FLASH`` (0 turns the
flash kernel off), ``_FLASH_DROPOUT`` (``hash`` only), ``_REVERSE_SCAN``
(1 runs the reverse scan kernels).  ``_REMAT`` is taken and ignored, as the
port's config ignores it; ``_MERGE_LR``, ``_MERGE_LR_S1``, ``_PADDED`` and
``_MU_DTYPE`` are TPU knobs the port does not take and raise when set.
The defaults (B=8, K=1, GA=1 on the card) are the shapes ``PERF.md``
reports for the train step, so the breakdown explains those numbers; the
JAX tool's B=16, K=8 wait for the port's first benchmark, which aligns the
two.  ``--device`` defaults to ``cuda`` and raises without it; ``--device
cpu`` (f32, the plain paths, B=1) summarizes the host ops' self time,
labelled as host time.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

import torch

from ..config import GlobalConfig
from ..models.fuser import BeamFuser
from ..ops import _build
from ..ops import flash_attention as fa
from ..ops import selective_scan as ss
from ..train.state import create_train_state
from ..train.steps import make_train_step
from ..utils.device import resolve_device
from ..utils.synth import make_synth_batch
from . import scan_roofline, timing, trace

LR = 1e-4
SITE = "site:"          # the prefix of the site ranges' names
TOP = 25
# TPU knobs the port does not take: set, they raise
REFUSED_KNOBS = ("MERGE_LR", "MERGE_LR_S1", "PADDED", "MU_DTYPE")

# The port's device kernels -> the KERNEL names of the wrappers that launch
# them, as the wrappers' modules export them (DEVICE_KERNELS): a kernel
# with a flag goes by that template argument, a shared pass to those of
# its wrappers that launched in the trace (a row of its own named by all
# of them), or to its first where none did.
PORT_KERNELS, KERNEL_FLAGS = {}, {}
for _mod in (fa, ss, scan_roofline):
    PORT_KERNELS.update(_mod.DEVICE_KERNELS)
    KERNEL_FLAGS.update(_mod.DEVICE_KERNEL_FLAGS)
# name patterns of the other categories, tried in this order
CATEGORIES = (
    ("optimizer", ("multi_tensor_apply", "_foreach_", "optimizer.",
                   "adam")),
    ("memcpy/memset", ("memcpy", "memset")),
    ("elementwise and reduction", ("bn_", "batch_norm", "batchnorm")),
    ("convolution", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                     "winograd")),
    ("GEMM", ("gemm", "nvjet", "cutlass", "cublas", "xmma", "s16816",
              "aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
              "aten::matmul", "aten::linear")),
    ("elementwise and reduction", ("at::native", "elementwise", "reduce",
                                   "aten::")),
)


def _template_arg(name: str, pos: int) -> str:
    """A demangled kernel name's template argument at ``pos`` ('' where it
    has none there)."""
    args = name.split("<", 1)[1].split(">", 1)[0].split(",") \
        if "<" in name else []
    return args[pos].strip() if pos < len(args) else ""


def category(name: str, launched=()) -> str:
    """The category of a device kernel or host op ``name``; a kernel of the
    port's goes by its wrapper's KERNEL name (``launched``: the wrappers
    that launched in the trace, for the shared passes)."""
    short = trace.short_name(name)
    wrappers = PORT_KERNELS.get(short)
    if wrappers and short in KERNEL_FLAGS:
        flag = _template_arg(name, KERNEL_FLAGS[short][0]) == "true"
        return "port: " + wrappers[flag]
    if wrappers:
        names = [n for n in wrappers if n in launched]
        return "port: " + (" + ".join(names) if names else wrappers[0])
    low = name.lower()
    for label, patterns in CATEGORIES:
        if any(p in low for p in patterns):
            return label
    return "other"


# -- the site ranges ----------------------------------------------------------

def site_modules(model: BeamFuser):
    """(site name, module) of every convolution site: each backbone's stem
    and stages, the fusion stages (the MambaBlocks' depthwise conv1d) and
    the TimeMamba head."""
    enc = model.encoder
    sites = []
    for mod in ("image", "lidar", "radar"):
        backbone = getattr(enc, f"{mod}_encoder")
        for part in ("stem", "stage1", "stage2", "stage3", "stage4"):
            sites.append((f"{mod}_encoder/{part}", getattr(backbone, part)))
    for i in range(1, 5):
        sites.append((f"fusion{i}", getattr(enc, f"fusion{i}")))
    if hasattr(enc, "time_mamba"):
        sites.append(("time_mamba", enc.time_mamba))
    return sites


def add_site_ranges(model: BeamFuser):
    """Forward hooks that open a ``record_function`` range named
    ``site:<scope>`` around each site's forward; returns their handles."""
    from torch.autograd.profiler import record_function
    handles = []
    for name, module in site_modules(model):
        stack = []

        def pre(_m, _args, name=name, stack=stack):
            rf = record_function(SITE + name)
            rf.__enter__()
            stack.append(rf)

        def post(_m, _args, _out, stack=stack):
            stack.pop().__exit__(None, None, None)

        handles += [module.register_forward_pre_hook(pre),
                    module.register_forward_hook(post)]
    return handles


def _ancestor(event, match):
    """The innermost of a host event and its parents for which ``match``
    holds, or None."""
    while event is not None and not match(event):
        event = event.cpu_parent
    return event


def _site_of(event):
    """The innermost site range around a host event, or None."""
    site = _ancestor(event, lambda e: e.name.startswith(SITE))
    return site.name[len(SITE):] if site else None


def _is_node(event) -> bool:
    """An autograd node's event: it carries its forward op's
    ``sequence_nr``."""
    return "Backward" in event.name and event.sequence_nr >= 0


def conv_attribution(events, on_card: bool, n_steps: int) -> dict:
    """The convolutions' ms a step by (site, direction).  On the card the
    time of a convolution kernel goes to the host op that launched it (the
    profiler's own link); on the host it is the conv ops' self time.  A
    forward op goes to the site range around it; a backward op to the site
    of the forward op that made its autograd node (same ``sequence_nr``).
    What no link reaches is ``unattributed``."""
    host = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CPU]
    fwd_site = {}
    for e in host:
        if e.sequence_nr >= 0 and not _is_node(e):
            site = _site_of(e)
            if site is not None:
                fwd_site.setdefault(e.sequence_nr, site)
    agg = defaultdict(float)
    for e in host:
        if on_card:
            us = sum(k.duration for k in e.kernels
                     if category(k.name) == "convolution")
        else:
            us = (e.self_cpu_time_total
                  if category(e.name) == "convolution" else 0.0)
        if not us:
            continue
        site = _site_of(e)
        node = None if site else _ancestor(e, _is_node)
        if site:
            agg[(site, "fwd")] += us
        elif node:
            agg[(fwd_site.get(node.sequence_nr, "unattributed"), "bwd")] += us
        else:
            agg[("unattributed", "?")] += us
    return {f"{site} {d}": us / n_steps / 1e3
            for (site, d), us in sorted(agg.items(), key=lambda kv: -kv[1])}


def summarize(events, kernels, wall_us, n_steps, launches, on_card
              ) -> dict:
    """The trace's summary: on the card its device kernels, the wrappers'
    ``launches`` beside the port's; on the host the ops' self time."""
    if on_card:
        items = [(k.name, k.time_range.elapsed_us(), None) for k in kernels]
    else:
        items = [(e.name, e.self_cpu_time_total, e) for e in events
                 if e.device_type == torch.autograd.DeviceType.CPU
                 and not e.name.startswith(SITE)
                 and e.self_cpu_time_total > 0]
    total = sum(us for _, us, _ in items)
    cats, names = defaultdict(float), defaultdict(lambda: [0, 0.0])
    for name, us, event in items:
        # on the host, an op inside the optimizer's step is the optimizer's
        in_step = _ancestor(event, lambda e: e.name.startswith(
            "Optimizer."))
        cats["optimizer" if in_step else category(name, launches)] += us
        names[name][0] += 1
        names[name][1] += us
    for name in launches:           # a launched kernel shows, even at 0 ms
        cats.setdefault("port: " + name, 0.0)
    out = {"time": "device" if on_card else "host", "steps": n_steps,
           "trace_empty": on_card and not kernels,
           "wall_ms_per_step": wall_us / n_steps / 1e3,
           "total_ms_per_step": total / n_steps / 1e3}
    if on_card:
        busy = trace.busy_us(kernels)
        out.update(busy_share=busy / wall_us if wall_us else None,
                   idle_share=1.0 - busy / wall_us if wall_us else None,
                   kernel_launches_per_step=len(kernels) / n_steps,
                   dropped_events=trace.dropped_events(kernels, n_steps))
    out["categories"] = [
        {"category": c, "ms_per_step": us / n_steps / 1e3,
         "share": us / total if total else None,
         **({"launches_per_step": launches.get(c[6:], 0) / n_steps}
            if c.startswith("port: ") else {})}
        for c, us in sorted(cats.items(), key=lambda kv: -kv[1])]
    ranked = sorted(names.items(), key=lambda kv: -kv[1][1])[:TOP]
    out["top"] = [{"name": n[:100], "count_per_step": c / n_steps,
                   "ms_per_step": us / n_steps / 1e3}
                  for n, (c, us) in ranked]
    if on_card and not kernels:
        out["conv_sites"] = None       # an empty trace: no zeros
    else:
        out["conv_sites"] = conv_attribution(events, on_card, n_steps)
    return out


def print_summary(s: dict, label: str = "") -> None:
    what = "device" if s["time"] == "device" else "host (CPU self time)"
    print(f"{label}{what} total: {s['total_ms_per_step']:.3f} ms/step of "
          f"{s['wall_ms_per_step']:.3f} ms wall"
          + (f"; busy share {s['busy_share']:.3f}, idle share "
             f"{s['idle_share']:.3f}, {s['kernel_launches_per_step']:.0f} "
             f"kernels a step, {s['dropped_events']} dropped events"
             if s["time"] == "device" and s["busy_share"] is not None
             else ""))
    print("by category:")
    for c in s["categories"]:
        n = (f"  {c['launches_per_step']:.0f} launches/step"
             if "launches_per_step" in c else "")
        share = 100 * c["share"] if c["share"] is not None else 0.0
        print(f"  {c['category']:34s} {c['ms_per_step']:9.3f} ms/step "
              f"{share:5.1f}%{n}")
    print("top:")
    for t in s["top"]:
        print(f"  {t['name'][:80]:80s} {t['ms_per_step']:9.3f} "
              f"x{t['count_per_step']:g}")
    if s["conv_sites"] is None:
        print("convolutions by site: the trace holds no device events")
    else:
        print("convolutions by site (ms/step):")
        for site, ms in s["conv_sites"].items():
            print(f"  {site:34s} {ms:9.3f}")


# -- the step -----------------------------------------------------------------

def step_config(env, on_card: bool):
    """(config, B, K, grad_accum) from the ``DEEPSENSE_BENCH_*`` knobs in
    ``env``, as the JAX tool reads them."""
    for knob in REFUSED_KNOBS:
        value = env.get(f"DEEPSENSE_BENCH_{knob}", "")
        if value not in ("", "0"):
            raise NotImplementedError(
                f"DEEPSENSE_BENCH_{knob}={value}: a TPU knob the PyTorch "
                f"port does not take (ROADMAP.md, Out of scope)")
    arch = env.get("DEEPSENSE_BENCH_ARCH", "gpt")
    if arch not in ("gpt", "mamba"):
        raise SystemExit(f"DEEPSENSE_BENCH_ARCH={arch!r}: gpt or mamba")
    dropout = env.get("DEEPSENSE_BENCH_FLASH_DROPOUT") or None
    if dropout not in (None, "hash"):
        raise NotImplementedError(
            f"DEEPSENSE_BENCH_FLASH_DROPOUT={dropout}: the PyTorch port's "
            f"flash dropout is the hash stream (ROADMAP.md, Out of scope)")
    fused = int(arch == "mamba")
    cfg = GlobalConfig(
        FFM=fused, TFM=fused, use_pallas_scan=on_card,
        compute_dtype="bfloat16" if on_card else "float32",
        remat=env.get("DEEPSENSE_BENCH_REMAT", "none"),
        use_flash_attention=(on_card and arch == "gpt" and env.get(
            "DEEPSENSE_BENCH_FLASH", "1") != "0"),
        flash_dropout_impl=dropout,
        reverse_scan_kernel=env.get("DEEPSENSE_BENCH_REVERSE_SCAN",
                                    "0") == "1")
    B = int(env.get("DEEPSENSE_BENCH_B", 8 if on_card else 1))
    K = int(env.get("DEEPSENSE_BENCH_K", 1))
    GA = int(env.get("DEEPSENSE_BENCH_GRAD_ACCUM", 1))
    return cfg, B, K, GA


def run(cfg: GlobalConfig, B: int, K: int = 1, grad_accum: int = 1,
        dispatches=None, device="cuda") -> dict:
    """Traces ``dispatches`` x ``K`` train steps of ``cfg``'s model (seed-0
    weights, one synthetic batch of ``B``, AdamW with EMA) after a warm-up
    step, 3 dispatches by default at K = 1 and 1 above, as the JAX tool
    does; returns :func:`summarize`'s dict with the wrapper launches a step
    of the traced steps."""
    if dispatches is None:
        dispatches = 3 if K == 1 else 1
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    model = BeamFuser(cfg, device=dev,
                      generator=torch.Generator().manual_seed(0))
    state = create_train_state(model)
    step = make_train_step(model, cfg, state, use_ema=True,
                           grad_accum=grad_accum, device=dev)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in make_synth_batch(cfg, B, seed=0).items()}
    step(batch, LR)["loss"].item()                 # warm-up
    n_steps = dispatches * K

    def steps():
        _build.reset_launch_counts()       # a retried trace counts anew
        for _ in range(dispatches):
            for _ in range(K):
                out = step(batch, LR)
            out["loss"].item()

    handles = add_site_ranges(model)
    try:
        events, kernels, wall_us = trace.traced(steps, device=dev)
    finally:
        for h in handles:
            h.remove()
    launches = dict(_build.KERNEL_LAUNCHES)
    out = summarize(events, kernels, wall_us, n_steps, launches, on_card)
    out["launches_per_step"] = {k: v / n_steps for k, v in launches.items()}
    out["annotations_on_device"] = sum(
        1 for e in events if e.device_type == torch.autograd.DeviceType.CUDA
        and getattr(e, "is_user_annotation", False))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=None,
                    help="batch (default DEEPSENSE_BENCH_B, else 8 on the "
                         "card, 1 on the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    on_card = dev.type == "cuda"
    cfg, B, K, GA = step_config(os.environ, on_card)
    B = a.B or B
    card = timing.card() if on_card else None
    if card:
        print(f"card: {card}", file=sys.stderr)
    s = run(cfg, B, K, GA, device=dev)
    print_summary(s)
    print(json.dumps({"arch": "mamba" if cfg.FFM else "gpt", "B": B, "K": K,
                      "grad_accum": GA, "card": card,
                      "device": (torch.cuda.get_device_name(dev) if on_card
                                 else "cpu"), **s}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
