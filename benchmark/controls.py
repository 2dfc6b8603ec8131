"""Readings that set the limits of the check of ``correct``: the control
and the planted faults, at a cell's own size, with the reference in the
program's place.

    python benchmark/controls.py --workload <cell> --seeds <n> [<n> ...]

For each seed it prints one JSON line with the numbers the check compares
(benchmark/core/compare.py) for:

- ``control``: the reference computed on float8 operands (the precision
  below the configuration's bfloat16) against the float32 reference;
- training cells: ``half_batch``, the reference whose loss is the mean
  over half of each batch, the rest left out; a state left unchanged reads
  1 by the change's measure and needs no run;
- serving cells: ``altered``, every served top beam moved to the next
  beam index.

Training takes the rows and dropout draws of a run's first three steps
with that seed, serving the rows of a sample of its requests.  None of
this runs the program; the benchmark's runs never run this.

``--float64`` adds, for training cells, ``float64``: the first step of
the reference in float64 against the float32 reference, which shows how
far float32 rounding alone moves each number.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def train_readings(cell, seed, device, float64=False):
    from benchmark.core import compare, data, weights
    from benchmark.drivers.train import CHECK_STEPS, first_rows, run_seeds
    from benchmark.reference.train import run_steps
    cfg, p = cell.config, cell.traffic
    rng_seed, shuffle_seed = run_seeds(seed)
    rows = [data.rows(cfg, p["data_seed"], r)
            for r in first_rows(p, shuffle_seed, CHECK_STEPS)]

    def ref(**kw):
        return run_steps(cfg, weights.make_weights(cfg, seed, device), rows,
                         rng_seed, p["lr"], device, **kw)

    base = ref()
    out = {"readings": {"reference": base}}
    for name, kw in (("control", {"quant": "fp8"}),
                     ("half_batch", {"half_batch": True})):
        other = ref(**kw)
        out["readings"][name] = other
        out[name] = compare.train_numbers(other, base)
        out[name]["worst_grad_leaves"] = compare.worst_leaves(
            other["grad_norms"], base["grad_norms"], base["grad_norms"])
    if float64:
        import torch
        one = rows[:1]
        f32 = run_steps(cfg, weights.make_weights(cfg, seed, device), one,
                        rng_seed, p["lr"], device)
        f64 = run_steps(cfg, weights.make_weights(cfg, seed, device), one,
                        rng_seed, p["lr"], device, dtype=torch.float64)
        out["readings"].update(float32_1=f32, float64_1=f64)
        out["float64"] = compare.train_numbers(f32, f64)
        out["float64"]["worst_grad_leaves"] = compare.worst_leaves(
            f32["grad_norms"], f64["grad_norms"], f64["grad_norms"])
    out["reference_losses"] = base["losses"]
    return out


def serve_readings(cell, seed, device):
    import numpy as np
    import torch

    from benchmark.core import compare, data, weights
    from benchmark.reference.model import BeamFuserReference
    cfg, p = cell.config, cell.traffic
    pool = data.host_pool(cfg, seed, p["pool_rows"])
    w = weights.calibrate_bn(cfg, weights.make_weights(cfg, seed, device),
                             {k: v[:p["calib_rows"]] for k, v in pool.items()},
                             device)
    rng = np.random.default_rng([seed, 5])
    index = rng.integers(0, p["pool_rows"], p["check_rows"])
    keys = ("image", "lidar", "radar", "gps")
    logits = {}
    for quant in (None, "fp8"):
        model = BeamFuserReference(cfg, quant=quant).to(device).eval()
        model.load_state_dict(w)
        outs = []
        with torch.no_grad():
            for s in range(0, len(index), 16):
                x = [torch.as_tensor(pool[k][index[s:s + 16]]).to(device)
                     for k in keys]
                outs.append(model(*x).double().cpu().numpy())
        logits[quant] = np.concatenate(outs)
        del model
    ref = logits[None]

    def reading(top1):
        p_sel = np.exp(ref - ref.max(1, keepdims=True))
        p_sel = p_sel / p_sel.sum(1, keepdims=True)
        conf = p_sel[np.arange(len(top1)), top1]
        return compare.serve_numbers(top1, conf, ref)

    low = logits["fp8"]
    top_low = low.argmax(1)
    p_low = np.exp(low - low.max(1, keepdims=True))
    p_low /= p_low.sum(1, keepdims=True)
    control = compare.serve_numbers(
        top_low, p_low[np.arange(len(top_low)), top_low], ref)
    altered = reading((ref.argmax(1) + 1) % ref.shape[1])
    srt = np.sort(ref, 1)
    return {"control": control, "altered": altered,
            "readings": {"reference_logits": ref.tolist(),
                         "control_logits": low.tolist()},
            "logit_std_median": float(np.median(ref.std(1))),
            "top_margin_min": float(((srt[:, -1] - srt[:, -2])
                                     / ref.std(1)).min())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--readings", default=None,
                    help="a directory for each seed's readings (JSON)")
    a = ap.parse_args(argv)
    import torch

    from benchmark.core import spec
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(a.workload)
    train = cell.traffic["driver"] == "train"
    for seed in a.seeds:
        t0 = time.perf_counter()
        dev = torch.device(a.device)
        out = (train_readings(cell, seed % 2 ** 63, dev, a.float64) if train
               else serve_readings(cell, seed % 2 ** 63, dev))
        readings = out.pop("readings")
        if a.readings:
            os.makedirs(a.readings, exist_ok=True)
            with open(os.path.join(a.readings, f"{a.workload}-{seed}.json"),
                      "w") as f:
                json.dump(readings, f)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
