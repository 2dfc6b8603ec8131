"""Inference / serving front-end (``deepsense6g_tii_tpu/serve.py:27-145,
218-238``).

A ``Predictor`` holds a ``BeamFuser`` on the GPU and serves top-k beams and
confidences, padding ragged request batches up to the nearest batch bucket
so that the model sees a few fixed shapes.  A latency self-benchmark
reports p50/p90/mean.  Its constructors load a trained checkpoint into a
model of ``config`` (strictly: every leaf present, no leaf left over):

    pred = Predictor.from_checkpoint("log/run/best_model.pt", cfg)  # port
    pred = Predictor.from_msgpack("best_model.msgpack", cfg)   # JAX package
    pred = Predictor.from_torch("best_model.pth", cfg)         # reference
    idx, conf = pred.predict(image, lidar, radar, gps)  # (B, 3), (B,)

Run as a script, it serves a checkpoint, chosen by its suffix (``.pt``,
``.msgpack`` or ``.pth``), on synthetic requests and prints one JSON line
of latency.  The flags and defaults are the JAX serve CLI's: ``--FFM 1
--TFM 1`` the MambaFuser, ``--FFM 0 --TFM 0`` the GPT TransFuser, at full
width.  ``--device`` defaults to ``cuda`` (bf16 through the hand-written
kernels) and raises without CUDA; ``--device cpu`` serves in f32 on the
plain paths, as the JAX CLI does off the TPU:

    python -m deepsense6g_tii_tpu_torch.serve log/run/best_model.pt --batch 8
    python -m deepsense6g_tii_tpu_torch.serve model.pth --FFM 0 --TFM 0
"""

from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .config import GlobalConfig
from .models.checkpoint_import import load_reference_checkpoint
from .models.fuser import BeamFuser
from .models.msgpack import read_flax_msgpack
from .models.weights import from_jax_variables
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

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_state_dict(cls, state_dict, config: GlobalConfig,
                        device="cuda", **kw) -> "Predictor":
        """A port state_dict, loaded strictly into ``BeamFuser(config)``."""
        model = BeamFuser(config, device=device)
        model.load_state_dict(state_dict, strict=True)
        return cls(model, config, device=device, **kw)

    @classmethod
    def from_checkpoint(cls, path: str, config: GlobalConfig, **kw
                        ) -> "Predictor":
        """The port's own ``.pt`` (``train/checkpoints.py::save_model``)."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        return cls.from_state_dict(sd, config, **kw)

    @classmethod
    def from_msgpack(cls, path: str, config: GlobalConfig, **kw
                     ) -> "Predictor":
        """A JAX package checkpoint (``flax.serialization.to_bytes`` of
        ``{"params", "batch_stats"}``), read without flax or msgpack."""
        return cls.from_state_dict(
            from_jax_variables(read_flax_msgpack(path)), config, **kw)

    @classmethod
    def from_torch(cls, path: str, config: GlobalConfig, **kw
                   ) -> "Predictor":
        """A reference ``.pth`` (DataParallel naming); keys the model does
        not use are ignored, as the JAX package does."""
        params, stats, _ = load_reference_checkpoint(path, config)
        return cls.from_state_dict(
            from_jax_variables({"params": params, "batch_stats": stats}),
            config, **kw)

    # -- inference ---------------------------------------------------------

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
        confidences (B,)).  Pads ragged batches up to a bucket size.  With
        ``pred_len > 1`` the beams are (B, pred_len, k) and the confidences
        the first step's top k, (B, k), as the JAX package returns them."""
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
    """The GPT TransFuser at full width (5 frames, 256 px, 8x8 anchors, 8
    layers, 4 heads, 962 tokens), bf16 compute and the flash-attention
    kernel."""
    return GlobalConfig(**{**dict(FFM=0, TFM=0, use_flash_attention=True,
                                  compute_dtype="bfloat16"), **overrides})


def mambafuser_config(**overrides) -> GlobalConfig:
    """The MambaFuser at full width (5 frames, 256 px, 8x8 anchors, 8
    MambaBlocks per stage with the channel swap, d_state 16, 962 tokens,
    TimeMamba head), bf16 compute and the selective-scan kernel."""
    return GlobalConfig(**{**dict(FFM=1, TFM=1, use_pallas_scan=True,
                                  compute_dtype="bfloat16"), **overrides})


def serving_config(FFM: int, TFM: int, add_velocity: int,
                   on_card: bool) -> GlobalConfig:
    """The serve CLI's model at full width: on the card, bf16 through the
    kernels (:func:`mambafuser_config` or :func:`gpt_transfuser_config` by
    ``FFM``); elsewhere f32 on the plain paths (the JAX CLI's
    ``on_tpu``)."""
    if on_card:
        make = mambafuser_config if FFM else gpt_transfuser_config
        return make(FFM=FFM, TFM=TFM, add_velocity=add_velocity)
    return GlobalConfig(FFM=FFM, TFM=TFM, add_velocity=add_velocity,
                        use_pallas_scan=False, use_flash_attention=False,
                        compute_dtype="float32")


def load_predictor(path: str, config: GlobalConfig, **kw) -> Predictor:
    """A ``Predictor`` for a checkpoint file, chosen by its suffix."""
    for suffix, make in ((".pt", Predictor.from_checkpoint),
                         (".msgpack", Predictor.from_msgpack),
                         (".pth", Predictor.from_torch)):
        if path.endswith(suffix):
            return make(path, config, **kw)
    raise ValueError(f"{path}: expected a .pt, .msgpack or .pth checkpoint")


def main(argv=None) -> int:
    import argparse
    import json

    from .utils.synth import make_synth_batch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint",
                   help=".pt (the port's), .msgpack (the JAX package's) or "
                        "a reference .pth")
    p.add_argument("--FFM", type=int, default=1)
    p.add_argument("--TFM", type=int, default=1)
    p.add_argument("--add_velocity", type=int, default=1)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    cfg = serving_config(a.FFM, a.TFM, a.add_velocity, dev.type == "cuda")
    pred = load_predictor(a.checkpoint, cfg, device=dev)
    pred.warmup()
    batch = make_synth_batch(cfg, a.batch, seed=0, with_labels=False)
    idx, conf = pred.predict(batch["image"], batch["lidar"], batch["radar"],
                             batch["gps"])
    out = pred.latency_benchmark(a.batch, a.iters)
    out.update(device=(torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
               top1=idx[:, 0].tolist(), conf=conf.tolist())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
