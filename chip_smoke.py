#!/usr/bin/env python3
"""Smoke run of the PyTorch port (deepsense6g_tii_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port builds, is right and serves.

    python3 chip_smoke.py          # from the root of a checkout

Phases, in order; any failure exits non-zero and prints no result:

1. device   CUDA must be present; prints the card's name and power limit.
2. build    compiles every CUDA kernel of the port from csrc/ with nvcc
            (one process per source, all started together).
3. kernels  holds each kernel against its plain PyTorch version at the
            shapes of the serving and training paths, in f32 and bf16, and
            times the kernel, the plain version and the one PyTorch call
            that computes the same function where there is one (timed here
            only, never called by the port) by their device time in
            torch.profiler, beside the card's bound for the work:
            - flash forward, dropout 0 and 0.1 (the hash stream);
            - the dropout mask export, equal element for element to the
              plain stream for four seeds;
            - flash backward, merged and split, dropout 0 and 0.1, against
              the plain backward and against each other;
            - the selective scan in both directions.
4. gpt      serves the full-width GPT TransFuser (random weights from a
            seed, bf16) through Predictor with buckets (1, 8); checks the
            outputs, that padding leaves rows unchanged, that every forward
            launched the flash kernel 32 times and the scan kernel never,
            and that f32 logits with the kernel equal those of the plain
            attention path within 1e-3; prints p50/p90 latency at batch 1
            and 8, and one profiled request at each (device busy share and
            the kernels taking most time).
5. mamba    the same for the full-width MambaFuser (FFM=1, TFM=1): 67 scan
            launches (4 stages x 8 MambaBlocks x 2 directions + 3 TimeMamba
            scans) and no flash launch per forward; f32 logits with the
            scan kernel against the plain-scan path, with reverse_scan_kernel
            off and on, each within the larger of 1e-3 and twice the model's
            f32 noise floor (the plain path's own shift between the two
            settings, measured in the same run; see PERF.md).
6. train    trains the full-width GPT TransFuser (bf16, dropouts 0.1, seed-0
            weights) with make_train_step(use_ema=True) at batch 8 on one
            fixed synthetic batch for 20 steps at lr 1e-4: every step
            launches exactly 32 flash forwards and 32 merged backwards and
            nothing else; the loss is finite and falls; prints step-time
            p50/p90, samples/s, peak memory and one profiled step.  Then the
            same weights in f32 take one step through the kernels and one
            through the plain attention path, at dropouts 0.1 and 0, and the
            losses, gradients and new BatchNorm statistics must agree.  A
            MambaFuser train step with the scan kernel must raise (the scan
            has no backward yet).

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  TF32 is switched off for
matmuls and convolutions, so the f32 comparisons are exact f32 on both
sides; the bf16 serving path is unaffected by it.
"""

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# H100 SXM special-function units: 16 exponentials a clock per SM (CUDA C
# programming guide, throughput of exp2 at compute capability 9.0)
SFU_PER_SM_CLOCK = 16

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
LOGIT_TOL = 1e-3     # f32 logits, kernel vs plain path, TF32 off
# the full-depth MambaFuser's f32 logits, kernel vs plain path, as a share
# of the largest logit: 4x the largest shift measured between two roundings
# of the plain path itself (3.5e-3 on 142, NVIDIA H100 80GB HBM3; PERF.md)
MAMBA_LOGIT_RTOL = 1e-4

# selective scan: the fusion stages' d_inner at L = 962 tokens, and the
# TimeMamba head's d_inner at L = 5 frames
SCAN_SHAPES = tuple((TOKENS, d) for d in (128, 256, 512, 1024)) + ((5, 1024),)
D_STATE = 16
SCAN_LAUNCHES = {(TOKENS, d): 2 * N_LAYER for d in (128, 256, 512, 1024)}
SCAN_LAUNCHES[(5, 1024)] = 3
# y and h_out, max abs error over max |plain|: kernel and plain version read
# the same inputs widened to f32 and compute in f32; only the order of the
# sums differs (a sequential recurrence and a 16-term dot in the kernel, a
# 10-level doubling tree and einsum in the plain version), and the kernel's
# ex2.approx decay is within ~1e-6 relative of torch.exp's where it is not
# ~0.  Measured ~1e-7 at every shape (NVIDIA H100 80GB HBM3; PERF.md)
SCAN_RTOL = 1e-5


# flash backward: largest error over the largest |plain| of dq, dk, dv.
# f32: the kernels and the plain version read the same inputs and sum in f32
# in other orders (and the merged kernel adds dq with atomics, in an order
# that changes from run to run); measured ~1.5e-6 (PERF.md).  bf16: P and dS
# are rounded to bf16 before their products on both sides, and a last-bit
# difference in f32 moves a rounding by one bf16 ulp (2^-8 relative), then
# the output is rounded to bf16 itself: 2 ulps of the largest value.
BWD_RTOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
DROP_P = 0.1
MASK_SEEDS = (0, 1, -7, 2 ** 31 - 1)
TRAIN_STEPS, TRAIN_LR = 20, 1e-4
# f32 training step, flash kernels against the plain attention path on the
# same weights, generators and masks; they differ only in rounding
# (phase_train_f32 says what each bound covers; measured values in PERF.md)
TRAIN_LOSS_RTOL = 1e-6
TRAIN_STATS_RTOL = 1e-5     # per statistic tensor, of its largest value
TRAIN_GRAD_RTOL = 1e-2      # all gradients, of their norm
TRAIN_GRAD_TENSOR_RTOL = 0.1    # per tensor, of its largest |g|
TRAIN_SPLIT_RTOL = 1e-4     # merged against split backward, of the norm
ATTN_F64_RTOL = 1e-5        # attention kernels against f64, of max |ref|


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


def traced_kernels(fn, tries=3):
    """Runs ``fn`` under torch.profiler and returns (its device events, host
    wall time in us).  On the card's machine a trace now and then comes back
    with no device events at all; such a trace is taken again, up to
    ``tries`` times, and the run fails if none has any."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            return kernels, wall_us
    fail(f"the profiler recorded no device time in {tries} traces")


def device_ms(fn, iters=20, warmup=3):
    """Device time of one call of ``fn``: the summed time of the kernels it
    launches, from torch.profiler, averaged over ``iters`` calls.  Unlike
    :func:`time_ms`, it excludes the gaps while the host enqueues."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()

    kernels, _ = traced_kernels(run)
    return sum(e.time_range.elapsed_us() for e in kernels) / iters / 1e3


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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    sm_clock_hz = 1e6 * float(smi.stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return card, n_sm * SFU_PER_SM_CLOCK * sm_clock_hz


def phase_build():
    from deepsense6g_tii_tpu_torch.ops import (_build, flash_attention,
                                               selective_scan)
    kernels = [*flash_attention.LIBRARIES, selective_scan.KERNEL]
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


def phase_flash_kernel():
    import torch
    import torch.nn.functional as F
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for d in HEAD_DIMS:
            q, k, v = (torch.randn(BATCH, HEADS, TOKENS, d, device=DEVICE,
                                   generator=gen).to(dtype)
                       for _ in range(3))
            sm = d ** -0.5
            for p in (0.0, DROP_P):
                seed = 12345 if p else None
                o, lse = fa.flash_mha_fwd(q, k, v, sm_scale=sm, dropout_p=p,
                                          seed=seed)
                torch.cuda.synchronize()
                ro, rlse = fa.flash_mha_reference(q, k, v, sm, p, seed or 0)
                err_o = (o.float() - ro.float()).abs().max().item()
                err_l = (lse - rlse).abs().max().item()
                tol_o, tol_l = TOL[dname]
                if dname == "bfloat16":
                    # 2 bf16 ulps at the largest |O| (dropout scales O up)
                    tol_o = max(tol_o, 2 * bf16_ulp(ro.float().abs().max()))
                check(err_o <= tol_o and err_l <= tol_l,
                      f"flash kernel {dname} d={d} p={p}: max |O err| "
                      f"{err_o:.3g} (tol {tol_o:.3g}), max |lse err| "
                      f"{err_l:.3g} (tol {tol_l})")
                if not p:
                    # a seed without dropout leaves the stream untouched
                    o2, _ = fa.flash_mha_fwd(q, k, v, sm_scale=sm, seed=99)
                    check(torch.equal(o, o2), f"flash kernel {dname} d={d}: "
                          f"p = 0 output depends on the seed")
                bh = BATCH * HEADS
                flops = 4.0 * bh * TOKENS * TOKENS * d
                nbytes = (4 * bh * TOKENS * d * q.element_size()
                          + bh * TOKENS * 4)
                bound_ms = 1e3 * max(flops / PEAK_FLOPS[dname],
                                     nbytes / PEAK_BYTES)
                kernel = lambda: fa.flash_mha_fwd(  # noqa: E731
                    q, k, v, sm_scale=sm, dropout_p=p, seed=seed)
                row = dict(
                    dtype=dname, d=d, p=p, max_abs_err=err_o, lse_err=err_l,
                    ms=device_ms(kernel), event_ms=time_ms(kernel),
                    plain_ms=device_ms(lambda: fa.flash_mha_reference(
                        q, k, v, sm, p, seed or 0)),
                    # SDPA without dropout: no PyTorch call draws this
                    # stream, and its own dropout costs the same
                    library_ms=device_ms(
                        lambda: F.scaled_dot_product_attention(q, k, v,
                                                               scale=sm)),
                    bound_ms=bound_ms, bound_us=1e3 * bound_ms,
                    bound_by="operations" if flops / PEAK_FLOPS[dname]
                    >= nbytes / PEAK_BYTES else "bytes")
                rows.append(row)
                print("kernel flash_attention_fwd " + json.dumps(row))
    return rows


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(float(x))) - 7)


def phase_mask():
    """The mask export equals the plain stream bit for bit; its keep rate
    and time against its bound (it writes 4·bh·T² bytes)."""
    import torch
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa

    bh = BATCH * HEADS
    for seed in MASK_SEEDS:
        m = fa.dropout_mask(seed, bh, TOKENS, DROP_P, device=DEVICE)
        torch.cuda.synchronize()
        ref = fa.dropout_scale_reference(seed, bh, TOKENS, DROP_P,
                                         device=DEVICE)
        diff = int((m != ref).sum().item())
        keep = (m > 0).float().mean().item()
        check(diff == 0, f"mask kernel, seed {seed}: {diff} elements differ "
              f"from the plain stream")
        print(f"mask seed {seed}: equal to the plain stream over "
              f"{m.numel()} elements; keep rate {keep:.6f} (1 - p = "
              f"{1 - DROP_P})")
    nbytes = 4.0 * bh * TOKENS * TOKENS
    # murmur3-fmix32 and the id: ~15 integer operations an element
    int_ops = 15.0 * bh * TOKENS * TOKENS
    row = dict(
        bh=bh, t=TOKENS, p=DROP_P, max_abs_err=0.0,
        ms=device_ms(lambda: fa.dropout_mask(0, bh, TOKENS, DROP_P,
                                             device=DEVICE)),
        plain_ms=device_ms(lambda: fa.dropout_scale_reference(
            0, bh, TOKENS, DROP_P, device=DEVICE), iters=5, warmup=1),
        bound_ms=1e3 * nbytes / PEAK_BYTES, bound_by="bytes", bytes=nbytes,
        int_ops=int_ops, library_ms=None)
    print("kernel flash_dropout_mask " + json.dumps(row))
    return row


def phase_flash_bwd():
    """Merged and split backward against the plain backward and each other,
    at the training path's shapes, dropout 0 and 0.1; timed with the plain
    version and SDPA's backward (dropout 0) beside the bound."""
    import torch
    import torch.nn.functional as F
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    bh = BATCH * HEADS
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for d in HEAD_DIMS:
            q, k, v, do = (torch.randn(BATCH, HEADS, TOKENS, d, device=DEVICE,
                                       generator=gen).to(dtype)
                           for _ in range(4))
            sm = d ** -0.5
            for p in (0.0, DROP_P):
                seed = -7 if p else None
                o, lse = fa.flash_mha_fwd(q, k, v, sm_scale=sm, dropout_p=p,
                                          seed=seed)
                kw = dict(sm_scale=sm, dropout_p=p, seed=seed)
                got = {mode: fa.flash_mha_bwd(q, k, v, o, lse, do, mode=mode,
                                              **kw)
                       for mode in ("merged", "split")}
                torch.cuda.synchronize()
                ref = fa.flash_mha_bwd_reference(q, k, v, o, lse, do, sm, p,
                                                 (seed or 0) & 0xFFFFFFFF)
                scale = [r.float().abs().max().item() for r in ref]
                err = {mode: [(g.float() - r.float()).abs().max().item()
                              for g, r in zip(got[mode], ref)]
                       for mode in got}
                err["merged_vs_split"] = [
                    (a.float() - b.float()).abs().max().item()
                    for a, b in zip(got["merged"], got["split"])]
                for what, errs in err.items():
                    check(all(e <= BWD_RTOL[dname] * s
                              for e, s in zip(errs, scale)),
                          f"flash backward {dname} d={d} p={p} {what}: max "
                          f"|d(q,k,v) err| {errs} of max |plain| {scale} "
                          f"(rtol {BWD_RTOL[dname]})")
                esize = q.element_size()
                n_el = bh * TOKENS * d
                # q, k, v, o, dO, lse, dvec in; dq, dk, dv out
                nbytes = 8 * n_el * esize + 2 * bh * TOKENS * 4
                flops = 10.0 * bh * TOKENS * TOKENS * d
                bounds = {}
                for name, fl, nb in (
                        ("merged", flops, nbytes),
                        # S, dP, dq / S, dP, dv, dk, each 2·bh·T²·d
                        ("dq", 6.0 * flops / 10, nbytes - 2 * n_el * esize),
                        ("dkv", 8.0 * flops / 10, nbytes - n_el * esize)):
                    t_ops = fl / PEAK_FLOPS[dname]
                    t_bytes = nb / PEAK_BYTES
                    bounds[name] = (1e3 * max(t_ops, t_bytes),
                                    "operations" if t_ops >= t_bytes
                                    else "bytes")
                row = dict(
                    dtype=dname, d=d, p=p, err=err, max_abs=scale,
                    max_abs_err=max(err["merged"]),
                    ms=device_ms(lambda: fa.flash_mha_bwd(
                        q, k, v, o, lse, do, mode="merged", **kw)),
                    split_ms=device_ms(lambda: fa.flash_mha_bwd(
                        q, k, v, o, lse, do, mode="split", **kw)),
                    plain_ms=device_ms(lambda: fa.flash_mha_bwd_reference(
                        q, k, v, o, lse, do, sm, p, (seed or 0) & 0xFFFFFFFF),
                        iters=5, warmup=1),
                    bound_ms=bounds["merged"][0],
                    bound_by=bounds["merged"][1],
                    split_flops_ms=1e3 * 1.4 * flops / PEAK_FLOPS[dname],
                    dq_bound_ms=bounds["dq"][0], dq_bound_by=bounds["dq"][1],
                    dkv_bound_ms=bounds["dkv"][0],
                    dkv_bound_by=bounds["dkv"][1])
                row.update(split_kernel_ms(fa, q, k, v, o, lse, do, kw))
                if not p:
                    row["library_ms"] = sdpa_backward_ms(F, q, k, v, do, sm)
                rows.append(row)
                print("kernel flash_attention_bwd " + json.dumps(row))
            del q, k, v, do, o, lse, got, ref
            torch.cuda.empty_cache()
    return rows


def split_kernel_ms(fa, q, k, v, o, lse, do, kw):
    """Device time of the dq and the dkv kernel alone, by their names in a
    trace of the split backward."""
    import torch
    fa.flash_mha_bwd(q, k, v, o, lse, do, mode="split", **kw)
    iters = 10
    kernels, _ = traced_kernels(lambda: [fa.flash_mha_bwd(
        q, k, v, o, lse, do, mode="split", **kw) for _ in range(iters)])
    torch.cuda.synchronize()
    out = {}
    for key, tag in (("dq_ms", "flash_bwd_dq_kernel"),
                     ("dkv_ms", "flash_bwd_dkv_kernel")):
        times = [e.time_range.elapsed_us() for e in kernels if tag in e.name]
        check(len(times) == iters, f"trace holds {len(times)} {tag} "
              f"launches, expected {iters}")
        out[key] = sum(times) / iters / 1e3
    return out


def sdpa_backward_ms(F, q, k, v, do, sm):
    """Device time of the backward of one scaled_dot_product_attention call
    (no dropout): timed only, never called by the port."""
    import torch
    qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, scale=sm)
    ms = device_ms(lambda: torch.autograd.grad(out, (qg, kg, vg), do,
                                               retain_graph=True))
    del out
    return ms


def phase_scan_kernel(sfu_rate):
    import torch
    import torch.nn.functional as F
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for L, d in SCAN_SHAPES:
            # model-like inputs: dt = softplus(N(0, 1)), A = -(1..16)
            rnd = lambda *s: torch.randn(*s, device=DEVICE, generator=gen)  # noqa: E731
            u = rnd(BATCH, L, d).to(dtype)
            dt = F.softplus(rnd(BATCH, L, d))
            A = -torch.arange(1, D_STATE + 1, dtype=torch.float32,
                              device=DEVICE).expand(d, D_STATE).contiguous()
            B, C = (rnd(BATCH, L, D_STATE).to(dtype) for _ in range(2))
            for reverse in (False, True):
                y, h = ss.selective_scan_fwd(u, dt, A, B, C, reverse=reverse)
                torch.cuda.synchronize()
                ry, rh = ss.selective_scan_reference(u, dt, A, B, C, reverse)
                err_y = (y - ry).abs().max().item()
                err_h = (h - rh).abs().max().item()
                scale_y = ry.abs().max().item()
                scale_h = rh.abs().max().item()
                check(err_y <= SCAN_RTOL * scale_y
                      and err_h <= SCAN_RTOL * scale_h,
                      f"scan kernel {dname} L={L} d={d} reverse={reverse}: "
                      f"max |y err| {err_y:.3g} of max |y| {scale_y:.3g}, "
                      f"max |h_out err| {err_h:.3g} of {scale_h:.3g} "
                      f"(rtol {SCAN_RTOL})")
                esize = u.element_size()
                nbytes = (BATCH * L * d * (esize + 4 + 4)
                          + 2 * BATCH * L * D_STATE * esize
                          + d * D_STATE * 4 + BATCH * D_STATE * d * 4)
                flops = BATCH * L * d * (7 * D_STATE + 1)
                exps = BATCH * L * d * D_STATE
                t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[
                    "float32"]
                kernel = lambda: ss.selective_scan_fwd(  # noqa: E731
                    u, dt, A, B, C, reverse=reverse)
                plain = lambda: ss.selective_scan_reference(  # noqa: E731
                    u, dt, A, B, C, reverse)
                row = dict(
                    dtype=dname, L=L, d=d, reverse=reverse, max_abs_err=err_y,
                    h_err=err_h, max_abs_y=scale_y, ms=device_ms(kernel),
                    event_ms=time_ms(kernel),
                    plain_ms=device_ms(plain, iters=5, warmup=1),
                    bytes=nbytes, flops=flops, bytes_ms=1e3 * t_bytes,
                    ops_ms=1e3 * t_ops, bound_ms=1e3 * max(t_bytes, t_ops),
                    bound_by="bytes" if t_bytes >= t_ops else "operations",
                    exps=exps, exp_sfu_ms=1e3 * exps / sfu_rate)
                rows.append(row)
                print("kernel selective_scan_fwd " + json.dumps(row))
            del u, dt, A, B, C, y, h, ry, rh
            torch.cuda.empty_cache()
    return rows


def phase_slice(card, name, cfg, expect, f32_runs, f32_checks):
    """Serves ``cfg`` at full width through Predictor; ``expect`` maps each
    kernel to its launches per forward (0: never launched).  Then runs the
    same weights in f32 under each of ``f32_runs`` (label: config
    overrides; a run with a smaller ``n_layer`` keeps the first blocks of
    each stage) and holds each (a, b, tol) of ``f32_checks`` to
    max |logits a - logits b| <= tol, where a callable tol takes the dict of
    logits.  Returns the launches per forward of the main path."""
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.serve import Predictor
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch

    check(cfg.n_tokens == TOKENS and cfg.n_layer == N_LAYER,
          f"{name}: unexpected served geometry {cfg}")
    model = BeamFuser(cfg, device=DEVICE,
                      generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, cfg, batch_buckets=(1, BATCH), device=DEVICE)
    pred.warmup()
    b = make_synth_batch(cfg, BATCH, seed=1, with_labels=False)
    arrs = [b[k] for k in ("image", "lidar", "radar", "gps")]

    # the main path: counts at 0 just before each request, read just after
    launches, results = [], {}
    for case, n in (("full", BATCH), ("ragged", 3), ("single", 1)):
        _build.reset_launch_counts()
        results[case] = pred.predict(*(a[:n] for a in arrs))
        torch.cuda.synchronize()
        launches.append(dict(_build.KERNEL_LAUNCHES))
    for counts in launches:
        check(set(counts) <= set(expect) and all(
            counts.get(k, 0) == v for k, v in expect.items()),
            f"{name}: expected launches per forward {expect}, got {counts}")
    for case, n in (("full", BATCH), ("ragged", 3), ("single", 1)):
        idx, conf = results[case]
        check(idx.shape == (n, 3) and conf.shape == (n,),
              f"{name} {case}: shapes {idx.shape}, {conf.shape}")
        check(idx.min() >= 1 and idx.max() <= cfg.num_beams,
              f"{name} {case}: beams outside 1..{cfg.num_beams}")
        check(np.isfinite(conf).all() and (conf > 0).all()
              and (conf <= 1).all(), f"{name} {case}: conf outside (0, 1]")
    (fi, fc), (ri, rc) = results["full"], results["ragged"]
    check(np.abs(rc - fc[:3]).max() <= 1e-3 and (ri[:, 0] == fi[:3, 0]).all(),
          f"{name}: ragged rows differ from the full batch: {rc} vs {fc[:3]}")
    print(f"{name}: top-1 beams {fi[:, 0].tolist()}, conf "
          f"{np.round(fc, 4).tolist()}; launches per forward {launches}")

    # f32: the kernels against the plain path on the same weights
    cfg32 = cfg.replace(compute_dtype="float32")
    sd = model.state_dict()
    x = [torch.from_numpy(a).to(DEVICE) for a in arrs]
    logits = {}
    for label, knobs in f32_runs.items():
        m = BeamFuser(cfg32.replace(**knobs), device=DEVICE)
        own = m.state_dict()
        m.load_state_dict({k: v for k, v in sd.items() if k in own},
                          strict=True)
        _build.reset_launch_counts()
        with torch.inference_mode():
            logits[label] = m(*x).float()
        torch.cuda.synchronize()
        check(torch.isfinite(logits[label]).all().item()
              and logits[label].shape == (BATCH, cfg.num_beams),
              f"{name}: f32 logits ({label}) not finite or of the wrong "
              f"shape")
        print(f"{name} f32 {label}: launches {dict(_build.KERNEL_LAUNCHES)}, "
              f"max |logit| {logits[label].abs().max().item():.6g}")
        del m
    diff = lambda a, b: (logits[a] - logits[b]).abs().max().item()  # noqa: E731
    for a, b, tol in f32_checks:
        tol = tol(logits) if callable(tol) else tol
        err = diff(a, b)
        check(err <= tol, f"{name} f32 logits, {a} vs {b}: max |err| "
              f"{err:.3g} (tol {tol:.3g})")
        print(f"{name} f32 logits {a} vs {b}: max |err| {err:.6g} (tol "
              f"{tol:.6g})")
    del x

    lat = {bs: pred.latency_benchmark(bs, iters=20) for bs in (1, BATCH)}
    print(f"{name} serving latency on {card}: " + json.dumps(lat))
    for bs in (1, BATCH):
        profile_request(pred, [a[:bs] for a in arrs], card, name)
    del pred, model
    torch.cuda.empty_cache()
    return launches[0]


def profile_request(pred, arrs, card, name, top=8):
    """One traced request: device busy share of the host wall time and the
    kernels that take the most device time."""
    pred.predict(*arrs)
    profile_call(lambda: pred.predict(*arrs),
                 f"{name} profile batch {arrs[0].shape[0]} on {card}", top)


def profile_call(fn, label, top=8):
    """Traces one call of ``fn`` and prints its device busy share of the
    host wall time and the kernels that take the most device time."""
    kernels, wall_us = traced_kernels(fn)
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
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
           "idle_share": 1.0 - busy / wall_us if wall_us else None,
           "kernel_launches": len(kernels),
           "top_kernels": [{"name": n[:80], "count": c, "ms": t / 1e3}
                           for n, (c, t) in ranked]}
    print(f"{label}: " + json.dumps(out))
    return out


def phase_train(card):
    """The main path of this slice: full-width GPT TransFuser training steps
    through make_train_step.  Returns the launches of each step, the step's
    numbers and the initial weights and batch (for phase_train_f32)."""
    import numpy as np
    import torch
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.serve import gpt_transfuser_config
    from deepsense6g_tii_tpu_torch.train.state import create_train_state
    from deepsense6g_tii_tpu_torch.train.steps import make_train_step
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch

    cfg = gpt_transfuser_config()
    check(cfg.n_tokens == TOKENS and cfg.n_layer == N_LAYER and min(
        cfg.embd_pdrop, cfg.attn_pdrop, cfg.resid_pdrop) == DROP_P,
        f"train: unexpected geometry {cfg}")
    model = BeamFuser(cfg, device=DEVICE,
                      generator=torch.Generator().manual_seed(0))
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(model)
    step = make_train_step(model, cfg, state, use_ema=True, device=DEVICE)
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in make_synth_batch(cfg, BATCH, seed=1).items()}
    expect = {fa.KERNEL: 4 * N_LAYER, fa.KERNEL_MERGED: 4 * N_LAYER}
    losses, times, launches = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        # the main path: counts at 0 just before each step, read just after
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        out = step(batch, TRAIN_LR)
        losses.append(out["loss"].item())        # waits for the step
        times.append(1e3 * (time.perf_counter() - t0))
        launches.append(dict(_build.KERNEL_LAUNCHES))
    peak = torch.cuda.max_memory_allocated()
    for i, counts in enumerate(launches):
        check(counts == expect, f"train step {i}: launches {counts}, "
              f"expected exactly {expect}")
    check(all(np.isfinite(losses)), f"train: loss not finite: {losses}")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]) and losses[-1]
          < losses[0], f"train: loss does not fall over {TRAIN_STEPS} "
          f"steps: {losses}")
    check(out["ranks"].shape == (BATCH, cfg.num_beams), "train: ranks shape")
    t = np.asarray(times[1:])
    p50 = float(np.percentile(t, 50))
    result = {"batch": BATCH, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
              "loss": losses, "first_step_ms": times[0],
              "step_ms_p50": p50, "step_ms_p90": float(np.percentile(t, 90)),
              "samples_per_s": 1e3 * BATCH / p50,
              "peak_memory_gib": peak / 2 ** 30,
              "launches_per_step": launches[0]}
    print(f"train on {card}: " + json.dumps(result))
    result["profile"] = profile_call(
        lambda: step(batch, TRAIN_LR)["loss"].item(),
        f"train profile step batch {BATCH} on {card}", top=10)
    del step, state, model
    torch.cuda.empty_cache()
    return result, init, batch


def phase_train_f32(init, batch):
    """One f32 training step through the flash kernels, one through the
    plain attention path and one through the split backward, from the same
    weights with the same generators, at dropouts 0.1 and 0.  All three
    draw the same attention masks from the same seeds and the same
    elementwise masks, so they differ by rounding alone.

    - Kernels against plain: the forwards agree to rounding (the loss to
      TRAIN_LOSS_RTOL, the new BatchNorm statistics to TRAIN_STATS_RTOL of
      each tensor's largest value).  The gradients of this random-weight
      model amplify those last-bit differences of the forward (train-mode
      BatchNorm's backward and the ReLU kinks), so they are held as a whole
      to TRAIN_GRAD_RTOL of their norm and each tensor to
      TRAIN_GRAD_TENSOR_RTOL of its largest |g|.  Beside that, each
      stage's first attention call is taken at its own inputs (q, k, v,
      dO, the seed) and the kernels' O, dq, dk and dv are held to
      ATTN_F64_RTOL of an f64 autograd reference, as accurate as the plain
      f32 path (printed beside).
    - Merged against split backward: the forward is the same computation,
      only dq's sum runs in another order, so the gradients are held to
      TRAIN_SPLIT_RTOL of their norm.
    - The key biases' gradient is 0 in exact arithmetic (softmax ignores a
      shift shared by all keys): it is held to 1e-6 of the largest |g|."""
    import os
    import torch
    from deepsense6g_tii_tpu_torch.models import fusion
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.ops import _build
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.serve import gpt_transfuser_config
    from deepsense6g_tii_tpu_torch.train.state import create_train_state
    from deepsense6g_tii_tpu_torch.train.steps import make_train_step

    n = 4 * N_LAYER
    runs = {"flash": ({fa.KERNEL: n, fa.KERNEL_MERGED: n}, "merged"),
            "plain": ({}, "merged"),
            "split": ({fa.KERNEL: n, fa.KERNEL_DQ: n, fa.KERNEL_DKV: n},
                      "split")}
    for p in (DROP_P, 0.0):
        res, calls = {}, []
        for path, (want, mode) in runs.items():
            cfg = gpt_transfuser_config(
                compute_dtype="float32", use_flash_attention=path != "plain",
                embd_pdrop=p, attn_pdrop=p, resid_pdrop=p)
            model = BeamFuser(cfg, device=DEVICE)
            model.load_state_dict(init, strict=True)
            step = make_train_step(model, cfg, create_train_state(model),
                                   rng_seed=7, device=DEVICE)
            os.environ["DEEPSENSE_FLASH_BWD"] = mode
            if path == "flash":
                fusion.flash_mha = recording(fa.flash_mha, calls)
            _build.reset_launch_counts()
            try:
                loss = step(batch, TRAIN_LR)["loss"].item()
            finally:
                del os.environ["DEEPSENSE_FLASH_BWD"]
                fusion.flash_mha = fa.flash_mha
            counts = dict(_build.KERNEL_LAUNCHES)
            check(counts == want, f"f32 train {path} p={p}: launches "
                  f"{counts}, expected {want}")
            res[path] = (loss,
                         {k: q.grad.detach().clone()
                          for k, q in model.named_parameters()},
                         {k: b.clone() for k, b in model.named_buffers()})
            del model, step
            torch.cuda.empty_cache()
        gap, split = (f32_gaps(res["flash"], res[other])
                      for other in ("plain", "split"))
        attn = [attention_vs_f64(fa, c) for c in calls[::N_LAYER]]
        calls.clear()
        print(f"f32 train step, dropout {p}: " + json.dumps(
            {"flash_vs_plain": gap, "merged_vs_split": split,
             "attention_vs_f64": attn}))
        check(gap["loss_rel"] <= TRAIN_LOSS_RTOL, f"f32 train p={p}: loss "
              f"{gap['loss']} (flash, plain)")
        check(gap["stats_worst"] <= TRAIN_STATS_RTOL, f"f32 train p={p}: "
              f"BatchNorm statistics off by {gap['stats_worst']:.3g}")
        check(gap["grad_global_rel"] <= TRAIN_GRAD_RTOL
              and gap["grad_worst"] <= TRAIN_GRAD_TENSOR_RTOL,
              f"f32 train p={p}: gradients off by {gap['grad_global_rel']:.3g}"
              f" of their norm, {gap['grad_worst_name']} by "
              f"{gap['grad_worst']:.3g} of its largest |g|")
        check(split["grad_global_rel"] <= TRAIN_SPLIT_RTOL
              and split["loss_rel"] <= TRAIN_LOSS_RTOL, f"f32 train p={p}: "
              f"merged and "
              f"split backward differ by {split['grad_global_rel']:.3g}")
        check(max(gap["key_bias"], split["key_bias"]) <= 1e-6,
              f"f32 train p={p}: key-bias gradient {gap['key_bias']:.3g} "
              f"of the largest |g|")
        for a in attn:
            check(max(a["kernels"]) <= ATTN_F64_RTOL, f"f32 train p={p}: "
                  f"attention kernels at the model's inputs against f64: "
                  f"{a}")


def recording(flash_mha, calls):
    """``flash_mha`` that keeps each call's q, k, v, arguments and output
    gradient, for attention_vs_f64."""
    def record(q, k, v, **kw):
        o = flash_mha(q, k, v, **kw)
        call = dict(q=q.detach(), k=k.detach(), v=v.detach(), kw=kw)
        o.register_hook(lambda g: call.__setitem__("do", g.detach()))
        calls.append(call)
        return o
    return record


def attention_vs_f64(fa, call):
    """The kernels' O, dq, dk, dv and the plain f32 version's at one call's
    own inputs, each as max |err| over max |ref| against f64 autograd
    through the plain forward with the same dropout mask."""
    import torch
    q, k, v, do, kw = (call[x] for x in ("q", "k", "v", "do", "kw"))
    do = do.contiguous()
    sm, p, seed = kw["sm_scale"], kw["dropout_p"], kw["seed"] or 0

    def plain(dtype):
        x = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        o, _ = fa.flash_mha_reference(*x, sm, p, seed)
        return [o.detach()] + list(torch.autograd.grad(o, x, do.to(dtype)))

    ref = plain(torch.float64)
    o, lse = fa.flash_mha_fwd(q, k, v, sm_scale=sm, dropout_p=p, seed=seed)
    kern = [o] + list(fa.flash_mha_bwd(q, k, v, o, lse, do, sm_scale=sm,
                                       dropout_p=p, seed=seed))

    def rel(xs):
        return [(a.double() - r).abs().max().item() / r.abs().max().item()
                for a, r in zip(xs, ref)]
    return {"d": q.shape[-1], "kernels": rel(kern),
            "plain_f32": rel(plain(torch.float32))}


def f32_gaps(a, b):
    """Loss, gradients and BatchNorm statistics of two f32 training steps:
    relative loss gap, each gradient tensor's max |gap| over its max |g|
    (the worst and its name, and the median), the key biases' max |gap|
    over the model's max |g|, the gradients' global relative gap, and each
    statistic tensor's max |gap| over its max value (the worst)."""
    import numpy as np
    import torch
    (la, ga, sa), (lb, gb, sb) = a, b
    top = max(g.abs().max().item() for g in gb.values())
    rel, key_bias = {}, 0.0
    for name, g in gb.items():
        err = (ga[name] - g).abs().max().item()
        if name.endswith("attn.key.bias"):
            key_bias = max(key_bias, err / top)
        else:
            rel[name] = err / g.abs().max().item()
    worst = max(rel, key=rel.get)
    num = torch.sqrt(sum(((ga[k] - g).double() ** 2).sum()
                         for k, g in gb.items())).item()
    den = torch.sqrt(sum((g.double() ** 2).sum() for g in gb.values())).item()
    return {"loss": [la, lb], "loss_rel": abs(la - lb) / abs(lb),
            "grad_worst": rel[worst], "grad_worst_name": worst,
            "grad_median": float(np.median(list(rel.values()))),
            "grad_global_rel": num / den, "key_bias": key_bias,
            "stats_worst": max((sa[k] - s).abs().max().item()
                               / s.abs().max().item()
                               for k, s in sb.items())}


def phase_scan_guard():
    """The scan kernel has no backward yet: a MambaFuser train step that
    would run it under autograd must raise, not train wrong."""
    import torch
    from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
    from deepsense6g_tii_tpu_torch.serve import mambafuser_config
    from deepsense6g_tii_tpu_torch.train.state import create_train_state
    from deepsense6g_tii_tpu_torch.train.steps import make_train_step
    from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch

    cfg = mambafuser_config(n_layer=1)
    model = BeamFuser(cfg, device=DEVICE,
                      generator=torch.Generator().manual_seed(0))
    step = make_train_step(model, cfg, create_train_state(model),
                           device=DEVICE)
    try:
        step(make_synth_batch(cfg, 2, seed=3), TRAIN_LR)
    except NotImplementedError as e:
        print(f"scan guard: a MambaFuser train step raises: {e}")
    else:
        fail("a MambaFuser train step through the scan kernel did not raise")
    del model, step
    torch.cuda.empty_cache()


def per_forward(rows, launches, key):
    """Sum of ``key`` over the rows, each row weighted by its launches per
    forward."""
    return sum(launches[shape] * r[key] for shape, r in rows.items())


def summed(rows, key):
    """Sum of ``key`` over the rows (one per head dim), each taken N_LAYER
    times: per training step or per forward, 8 launches at each stage."""
    return sum(N_LAYER * r[key] for r in rows)


def bound_by(rows, key="bound_by"):
    return ("operations" if all(r[key] == "operations" for r in rows)
            else "bytes")


def main():
    card, sfu_rate = phase_device()
    phase_build()
    flash_rows = phase_flash_kernel()
    mask_row = phase_mask()
    bwd_rows = phase_flash_bwd()
    scan_rows = phase_scan_kernel(sfu_rate)

    import torch
    from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
    from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
    from deepsense6g_tii_tpu_torch.serve import (gpt_transfuser_config,
                                                 mambafuser_config)
    gpt = phase_slice(card, "gpt", gpt_transfuser_config(),
                      {fa.KERNEL: 4 * N_LAYER, ss.KERNEL: 0},
                      {"flash": dict(use_flash_attention=True),
                       "plain": dict(use_flash_attention=False)},
                      [("flash", "plain", LOGIT_TOL)])
    # Full depth, the random-weight MambaFuser is ill-conditioned in f32:
    # its blocks multiply two branches and have no residual path, so a
    # last-bit change in any layer grows to 1e-3..4e-3 on logits of ~140.
    # The run measures that floor as the plain path's own shift between
    # reverse_scan_kernel off and on (the same math, rounded otherwise) and
    # holds the kernel to MAMBA_LOGIT_RTOL of the largest logit there; cut
    # to one MambaBlock per stage, the model is well conditioned and the
    # kernel is held to LOGIT_TOL.
    runs, checks = {}, []
    for depth in (N_LAYER, 1):
        for rev in ("", " reverse"):
            for path in ("scan", "plain"):
                runs[f"{path}{rev} x{depth}"] = dict(
                    use_pallas_scan=path == "scan", n_layer=depth,
                    reverse_scan_kernel=bool(rev))
            checks.append((f"scan{rev} x{depth}", f"plain{rev} x{depth}",
                           LOGIT_TOL if depth == 1 else
                           lambda lg: MAMBA_LOGIT_RTOL * lg[
                               f"plain x{N_LAYER}"].abs().max().item()))
    checks.insert(0, (f"plain reverse x{N_LAYER}", f"plain x{N_LAYER}",
                      float("inf")))
    mamba = phase_slice(card, "mamba", mambafuser_config(),
                        {ss.KERNEL: sum(SCAN_LAUNCHES.values()), fa.KERNEL: 0},
                        runs, checks)
    train, init, batch = phase_train(card)
    phase_train_f32(init, batch)
    del init, batch
    phase_scan_guard()

    # Per forward of the serving path at batch 8 in bf16: the flash kernel's
    # 8 launches at each of the four stage shapes (dropout 0); the scan's 16
    # launches at each stage's d_inner (L = 962) and 3 in the TimeMamba head
    # (L = 5), forward direction (reverse_scan_kernel off).
    serve_fwd = [r for r in flash_rows
                 if r["dtype"] == "bfloat16" and r["p"] == 0.0]
    print("flash forward per serving forward (dropout 0): " + json.dumps(
        {"launches": gpt[fa.KERNEL],
         **{k: summed(serve_fwd, k)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms")}}))
    scan_main = {(r["L"], r["d"]): r for r in scan_rows
                 if r["dtype"] == "bfloat16" and not r["reverse"]}
    scan_bytes_ms = per_forward(scan_main, SCAN_LAUNCHES, "bytes_ms")
    scan_ops_ms = per_forward(scan_main, SCAN_LAUNCHES, "ops_ms")
    print(f"scan per forward: bound by bytes {scan_bytes_ms:.6g} ms, by "
          f"operations {scan_ops_ms:.6g} ms, exponentials "
          f"{per_forward(scan_main, SCAN_LAUNCHES, 'exps')} "
          f"({per_forward(scan_main, SCAN_LAUNCHES, 'exp_sfu_ms'):.6g} ms "
          f"at the SFU rate)")
    # with reverse_scan_kernel on, the 8 backward branches of each stage
    # run the reverse direction instead
    scan_rev = {(r["L"], r["d"]): r for r in scan_rows
                if r["dtype"] == "bfloat16" and r["reverse"]
                and r["L"] == TOKENS}
    rev_n = {shape: N_LAYER for shape in scan_rev}
    print("scan reverse per forward (reverse_scan_kernel=True): " + json.dumps(
        {"launches": sum(rev_n.values()),
         **{k: per_forward(scan_rev, rev_n, k)
            for k in ("ms", "plain_ms", "bound_ms", "exp_sfu_ms")}}))

    # Per training step at batch 8 in bf16, dropout 0.1: 8 launches at each
    # stage shape.  The split pair (dq + dkv) is not on the path (the
    # backward runs merged), so its launches are 0 and its times are what
    # it would take in the merged kernel's place; the plain backward and
    # SDPA's backward (dropout 0) compute dq, dk and dv together.
    fwd = [r for r in flash_rows
           if r["dtype"] == "bfloat16" and r["p"] == DROP_P]
    bwd = [r for r in bwd_rows
           if r["dtype"] == "bfloat16" and r["p"] == DROP_P]
    sdpa_bwd = summed([r for r in bwd_rows if r["dtype"] == "bfloat16"
                       and r["p"] == 0.0], "library_ms")
    steps = train["launches_per_step"]
    print("flash backward per training step: " + json.dumps(
        {"merged_ms": summed(bwd, "ms"), "split_ms": summed(bwd, "split_ms"),
         "plain_ms": summed(bwd, "plain_ms"), "sdpa_bwd_ms": sdpa_bwd,
         "bound_ms": summed(bwd, "bound_ms"),
         "split_flops_ms": summed(bwd, "split_flops_ms")}))

    def entry(name, source, replaces, ms, bound, by, plain, library, err):
        return {"name": name, "route": "cuda",
                "source": f"deepsense6g_tii_tpu_torch/csrc/{source}",
                "replaces": f"deepsense6g_tii_tpu/ops/{replaces}",
                "launches": steps.get(name, 0),
                "max_abs_err": err, "ms": ms, "plain_ms": plain,
                "bound_ms": bound, "bound_by": by, "library_ms": library}

    kernels = [
        entry(fa.KERNEL, "flash_attention_fwd.cu", "flash_attention.py:160",
              summed(fwd, "ms"), summed(fwd, "bound_ms"), bound_by(fwd),
              summed(fwd, "plain_ms"), summed(fwd, "library_ms"),
              max(r["max_abs_err"] for r in fwd)),
        entry(fa.KERNEL_MASK, "flash_dropout_mask.cu",
              "flash_attention.py:615", mask_row["ms"],
              mask_row["bound_ms"], "bytes", mask_row["plain_ms"], None, 0.0),
        entry(fa.KERNEL_MERGED, "flash_attention_bwd.cu",
              "flash_attention.py:344", summed(bwd, "ms"),
              summed(bwd, "bound_ms"), bound_by(bwd), summed(bwd, "plain_ms"),
              sdpa_bwd, max(r["max_abs_err"] for r in bwd)),
        entry(fa.KERNEL_DQ, "flash_attention_bwd.cu",
              "flash_attention.py:265", summed(bwd, "dq_ms"),
              summed(bwd, "dq_bound_ms"), bound_by(bwd, "dq_bound_by"),
              summed(bwd, "plain_ms"), None,
              max(r["err"]["split"][0] for r in bwd)),
        entry(fa.KERNEL_DKV, "flash_attention_bwd.cu",
              "flash_attention.py:297", summed(bwd, "dkv_ms"),
              summed(bwd, "dkv_bound_ms"), bound_by(bwd, "dkv_bound_by"),
              summed(bwd, "plain_ms"), None,
              max(max(r["err"]["split"][1:]) for r in bwd)),
        {"name": ss.KERNEL, "route": "cuda",
         "source": "deepsense6g_tii_tpu_torch/csrc/selective_scan_fwd.cu",
         "replaces": "deepsense6g_tii_tpu/ops/selective_scan.py:206",
         "launches": mamba[ss.KERNEL],
         "max_abs_err": max(r["max_abs_err"] for r in scan_main.values()),
         "ms": per_forward(scan_main, SCAN_LAUNCHES, "ms"),
         "plain_ms": per_forward(scan_main, SCAN_LAUNCHES, "plain_ms"),
         "bound_ms": per_forward(scan_main, SCAN_LAUNCHES, "bound_ms"),
         "bound_by": "bytes" if scan_bytes_ms >= scan_ops_ms
         else "operations",
         "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
