#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepsense6g_tii_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port builds, is right and serves.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure exits non-zero and prints no result:

1. device   CUDA must be present; prints the card's name and power limit.
2. build    compiles every CUDA kernel of the port from csrc/ with nvcc
            (one process per source, all started together).
3. kernels  holds each kernel against its plain PyTorch version at the
            shapes of the serving path, in f32 and bf16, and times the
            kernel, the plain version, the one PyTorch call that computes
            the same function (timed here only, never called by the port)
            and the card's bound for the work.
4. slice    serves the full-width GPT TransFuser (random weights from a
            seed, bf16) through Predictor with buckets (1, 8); checks the
            outputs, that padding leaves rows unchanged, that every forward
            launched the flash kernel 32 times, and that f32 logits with
            the kernel equal those of the plain attention path; prints
            p50/p90 latency at batch 1 and 8, and one profiled request at
            each (device busy share and the kernels taking most time).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  TF32 is switched off for
matmuls and convolutions, so the f32 comparisons are exact f32 on both
sides; the bf16 serving path is unaffected by it.
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

BATCH = 8            # serving bucket
HEADS = 4
TOKENS = 962         # 3 modalities x 5 frames x 8x8 anchors + 2 GPS
HEAD_DIMS = (16, 32, 64, 128)   # n_embd 64..512 over 4 heads
N_LAYER = 8
TOL = {"float32": (1e-5, 1e-5),     # (O, lse) max abs error vs plain
       # bf16: the kernel rounds P to bf16 before P.V (as the TPU kernel
       # does), the plain version does not: 2 bf16 ulps of O at the
       # largest |O| (ulp 1.95e-3 for |O| in [0.25, 0.5))
       "bfloat16": (4e-3, 1e-4)}
LOGIT_TOL = 1e-3     # f32 logits, kernel vs plain attention, TF32 off


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not os.path.isdir(os.path.join(REPO, "deepsense6g_tii_tpu_torch")):
        fail("deepsense6g_tii_tpu_torch not found beside chip_smoke.py: "
             "run from the root of a checkout")
    import torch
    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from deepsense6g_tii_tpu_torch.ops import _build, flash_attention
    kernels = [flash_attention.KERNEL]
    t0 = time.perf_counter()
    logs = _build.build(kernels)
    print(f"build: {kernels} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        spills = sorted({ln.strip() for ln in log.splitlines()
                         if "spill" in ln})
        print(f"  {name} ptxas: {regs}; {spills}")
    for name in kernels:
        _build.load(name)


def phase_kernels():
    import torch
    import torch.nn.functional as F
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for d in HEAD_DIMS:
            q, k, v = (torch.randn(BATCH, HEADS, TOKENS, d, device="cuda",
                                   generator=gen).to(dtype)
                       for _ in range(3))
            sm = d ** -0.5
            o, lse = fa.flash_mha_fwd(q, k, v, sm_scale=sm)
            torch.cuda.synchronize()
            ro, rlse = fa.flash_mha_reference(q, k, v, sm)
            err_o = (o.float() - ro.float()).abs().max().item()
            err_l = (lse - rlse).abs().max().item()
            tol_o, tol_l = TOL[dname]
            check(err_o <= tol_o and err_l <= tol_l,
                  f"flash kernel {dname} d={d}: max |O err| {err_o:.3g} "
                  f"(tol {tol_o}), max |lse err| {err_l:.3g} (tol {tol_l})")
            bh = BATCH * HEADS
            flops = 4.0 * bh * TOKENS * TOKENS * d
            nbytes = 4 * bh * TOKENS * d * q.element_size() + bh * TOKENS * 4
            bound_ms = 1e3 * max(flops / PEAK_FLOPS[dname],
                                 nbytes / PEAK_BYTES)
            row = dict(
                dtype=dname, d=d, max_abs_err=err_o, lse_err=err_l,
                ms=time_ms(lambda: fa.flash_mha_fwd(q, k, v, sm_scale=sm)),
                plain_ms=time_ms(lambda: fa.flash_mha_reference(q, k, v, sm)),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, scale=sm)),
                bound_ms=bound_ms, bound_us=1e3 * bound_ms,
                bound_by="operations" if flops / PEAK_FLOPS[dname]
                >= nbytes / PEAK_BYTES else "bytes")
            rows.append(row)
            print("kernel flash_attention_fwd " + json.dumps(row))
    return rows


def phase_slice(card):
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import _build, flash_attention as fa
    from deepsense6g_tii_tpu_torch.serve import Predictor, gpt_transfuser_config
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch

    cfg = gpt_transfuser_config()
    check(cfg.n_tokens == TOKENS and cfg.n_layer == N_LAYER,
          f"unexpected served geometry {cfg}")
    model = BeamFuser(cfg, generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, cfg, batch_buckets=(1, BATCH))
    pred.warmup()
    b = make_synth_batch(cfg, BATCH, seed=1, with_labels=False)
    arrs = [b[k] for k in ("image", "lidar", "radar", "gps")]

    # the main path: counts at 0 just before each request, read just after
    launches, results = [], {}
    for name, n in (("full", BATCH), ("ragged", 3), ("single", 1)):
        _build.reset_launch_counts()
        results[name] = pred.predict(*(a[:n] for a in arrs))
        torch.cuda.synchronize()
        launches.append(dict(_build.KERNEL_LAUNCHES))
    per_forward = 4 * N_LAYER
    for counts in launches:
        check(counts == {fa.KERNEL: per_forward},
              f"expected {per_forward} flash launches per forward, got "
              f"{counts}")
    for name, n in (("full", BATCH), ("ragged", 3), ("single", 1)):
        idx, conf = results[name]
        check(idx.shape == (n, 3) and conf.shape == (n,),
              f"{name}: shapes {idx.shape}, {conf.shape}")
        check(idx.min() >= 1 and idx.max() <= cfg.num_beams,
              f"{name}: beams outside 1..{cfg.num_beams}")
        check(np.isfinite(conf).all() and (conf > 0).all()
              and (conf <= 1).all(), f"{name}: conf outside (0, 1]")
    (fi, fc), (ri, rc) = results["full"], results["ragged"]
    check(np.abs(rc - fc[:3]).max() <= 1e-3 and (ri[:, 0] == fi[:3, 0]).all(),
          f"ragged rows differ from the full batch: {rc} vs {fc[:3]}")
    print(f"slice: top-1 beams {fi[:, 0].tolist()}, conf "
          f"{np.round(fc, 4).tolist()}; flash launches per forward "
          f"{[c[fa.KERNEL] for c in launches]}")

    # f32: the kernel against the plain attention path on the same weights
    cfg32 = cfg.replace(compute_dtype="float32")
    logits = {}
    sd = model.state_dict()
    for flash in (True, False):
        m = BeamFuser(cfg32.replace(use_flash_attention=flash))
        m.load_state_dict(sd, strict=True)
        x = [torch.from_numpy(a).cuda() for a in arrs]
        with torch.inference_mode():
            logits[flash] = m(*x).float()
        del m
    err = (logits[True] - logits[False]).abs().max().item()
    check(torch.isfinite(logits[True]).all().item()
          and logits[True].shape == (BATCH, cfg.num_beams),
          "f32 logits not finite or of the wrong shape")
    check(err <= LOGIT_TOL, f"f32 logits, kernel vs plain attention: max "
          f"|err| {err:.3g} (tol {LOGIT_TOL})")
    print(f"slice f32 logits kernel vs plain: max |err| {err:.3g}, max "
          f"|logit| {logits[False].abs().max().item():.3g}")

    lat = {bs: pred.latency_benchmark(bs, iters=20) for bs in (1, BATCH)}
    print(f"serving latency on {card}: " + json.dumps(lat))
    for bs in (1, BATCH):
        profile_request(pred, [a[:bs] for a in arrs], card)
    return launches[0][fa.KERNEL]


def profile_request(pred, arrs, card, top=8):
    """One traced request: device busy share of the host wall time and the
    kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pred.predict(*arrs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pred.predict(*arrs)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    print(f"profile batch {arrs[0].shape[0]} on {card}: " + json.dumps({
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / wall_us if wall_us else None,
        "kernel_launches": len(kernels),
        "top_kernels": [{"name": n[:80], "count": c, "ms": t / 1e3}
                        for n, (c, t) in ranked]}))


def main():
    card = phase_device()
    phase_build()
    rows = phase_kernels()
    launches = phase_slice(card)

    import torch
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    # one entry per kernel: the bf16 rows (the serving dtype) at batch 8;
    # times are per forward, i.e. N_LAYER launches at each of the four
    # stage shapes, the `launches` the forward made
    main_rows = [r for r in rows if r["dtype"] == "bfloat16"]
    total = lambda key: N_LAYER * sum(r[key] for r in main_rows)  # noqa: E731
    print(json.dumps({"kernels": [{
        "name": fa.KERNEL, "route": "cuda",
        "source": "deepsense6g_tii_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "deepsense6g_tii_tpu/ops/flash_attention.py:160",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in main_rows),
        "ms": total("ms"), "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": main_rows[-1]["bound_by"],
        "library_ms": total("library_ms")}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
