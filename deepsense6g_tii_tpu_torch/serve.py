"""Inference / serving front-end (``deepsense6g_tii_tpu/serve.py:27-145``).

A ``Predictor`` holds a ``BeamFuser`` on the GPU and serves top-k beams and
confidences, padding ragged request batches up to the nearest batch bucket
so that the model sees a few fixed shapes.  A latency self-benchmark
reports p50/p90/mean.

    model = BeamFuser(cfg, generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, cfg)
    idx, conf = pred.predict(image, lidar, radar, gps)  # (B, 3), (B,)

Run as a script, it serves synthetic requests through the full-width GPT
TransFuser with random seeded weights on the GPU and prints the latency:

    python -m deepsense6g_tii_tpu_torch.serve --batch 8
"""

from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .config import GlobalConfig
from .models.fuser import BeamFuser
from .utils.device import resolve_device


class Predictor:
    def __init__(self, model: BeamFuser, config: GlobalConfig,
                 batch_buckets: Sequence[int] = (1, 8), top_k: int = 3,
                 device="cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.model = model.to(self.device).eval()
        self.buckets = tuple(sorted(batch_buckets))
        self.top_k = top_k

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        top = self.buckets[-1]
        return -(-n // top) * top

    def _input_shapes(self, b: int):
        cfg = self.config
        T, H = cfg.seq_len, cfg.crop
        rc = 2 if cfg.add_velocity else 1
        return ((b, T, H, H, 3), (b, T, H, H, 1), (b, T, H, H, rc),
                (b, cfg.gps_len, 2))

    @torch.inference_mode()
    def predict(self, image, lidar, radar, gps
                ) -> Tuple[np.ndarray, np.ndarray]:
        """NHWC sensor arrays -> (top-k 1-indexed beams (B, k), top-1
        confidences (B,)).  Pads ragged batches up to a bucket size."""
        n = image.shape[0]
        b = self._bucket(n)
        arrs = []
        for a in (image, lidar, radar, gps):
            a = np.asarray(a, dtype=np.float32)
            if b != n:
                a = np.pad(a, ((0, b - n),) + ((0, 0),) * (a.ndim - 1))
            arrs.append(torch.from_numpy(a).to(self.device))
        logits = self.model(*arrs)
        probs = torch.softmax(logits.float(), dim=-1)
        conf, idx = torch.topk(probs, self.top_k, dim=-1)
        return (idx[:n].cpu().numpy() + 1,        # 1-indexed, beam_pred.csv
                conf[:n, 0].cpu().numpy())

    def warmup(self) -> None:
        """One request at each bucket size."""
        for b in self.buckets:
            self.predict(*(np.zeros(s, np.float32)
                           for s in self._input_shapes(b)))

    def latency_benchmark(self, batch: int = 1, iters: int = 30
                          ) -> Dict[str, float]:
        """p50/p90/mean latency of one ``predict`` call in ms, host to
        host, the device synchronised before each clock read."""
        shapes = self._input_shapes(batch)
        rng = np.random.default_rng(0)
        args = (rng.uniform(0, 255, shapes[0]).astype(np.float32),
                *(np.zeros(s, np.float32) for s in shapes[1:]))
        self.predict(*args)
        times = []
        for _ in range(iters):
            self._sync()
            t0 = time.perf_counter()
            self.predict(*args)
            self._sync()
            times.append((time.perf_counter() - t0) * 1e3)
        t = np.asarray(times)
        return {"p50_ms": float(np.percentile(t, 50)),
                "p90_ms": float(np.percentile(t, 90)),
                "mean_ms": float(t.mean()), "batch": batch}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def gpt_transfuser_config(**overrides) -> GlobalConfig:
    """The served model: the GPT TransFuser at full width (5 frames,
    256 px, 8x8 anchors, 8 layers, 4 heads, 962 tokens), bf16 compute and
    the flash-attention kernel."""
    return GlobalConfig(FFM=0, TFM=0, use_flash_attention=True,
                        compute_dtype="bfloat16", **overrides)


def main(argv=None) -> int:
    import argparse
    import json

    from .utils.synth import make_synth_batch

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=30)
    a = p.parse_args(argv)
    cfg = gpt_transfuser_config()
    model = BeamFuser(cfg, generator=torch.Generator().manual_seed(0))
    pred = Predictor(model, cfg)
    pred.warmup()
    batch = make_synth_batch(cfg, a.batch, seed=0, with_labels=False)
    idx, conf = pred.predict(batch["image"], batch["lidar"], batch["radar"],
                             batch["gps"])
    out = pred.latency_benchmark(a.batch, a.iters)
    out.update(device=torch.cuda.get_device_name(pred.device),
               top1=idx[:, 0].tolist(), conf=conf.tolist())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
