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

The serving artifact (``serve.py:148-215`` of the JAX package): the
forward, softmax and top-k traced by ``torch.export`` at a fixed batch with
the weights inside one ``.pt2`` file, which :class:`ExportedPredictor`
serves without the checkpoint or the model's code.  The hand-written
kernels are ``torch.library`` custom ops (``torch.ops.deepsense6g``), so
the artifact calls them by name; loading it needs them registered, which
importing this module (or the port's ``ops.flash_attention`` and
``ops.selective_scan``) does:

    pred.export_artifact("build/serve/gpt_b8.pt2")            # batch 8
    idx, conf = ExportedPredictor("build/serve/gpt_b8.pt2").predict(...)

``use_mesh=True`` (``serve.py:27-41`` of the JAX package) serves over all
local GPUs: one replica of the model a device, each bucket's rows split
evenly across them, every replica's forward queued before any result is
read back, and the logits gathered on the first device.  The host still
issues each replica's launches in turn, so a host-bound model serves
slower over a mesh than on one device (PERF.md); the option keeps the JAX
package's API, and letting the replicas overlap is a speed-up that
ROADMAP.md Queue 1 item 7's remainder keeps (a ``perf_opt``; the rest of
item 7, the rebuild trainer's data parallelism included, is ported).
Buckets then count per mesh: a request pads to a bucket times the device
count, and so does an artifact's default batch.  A
:class:`~deepsense6g_tii_tpu_torch.parallel.mesh.Mesh` in its place names
the devices (two replicas on one card, or two CPU devices in a test).

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

import copy
import time
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.export.graph_signature import InputKind, OutputKind

from .config import GlobalConfig
from .models.checkpoint_import import load_reference_checkpoint
from .models.fuser import BeamFuser
from .models.msgpack import read_flax_msgpack
from .models.weights import from_jax_variables
# registered custom ops, which an artifact calls by name
from .ops import _build, flash_attention, selective_scan
from .parallel.mesh import Mesh, make_mesh
from .utils.device import resolve_device

# the serving kernels' launch-count names -> their custom ops' names in an
# exported graph (graph_ops)
KERNEL_OPS = {m.KERNEL: f"{_build.OP_NAMESPACE}.{m.OP_NAME}.default"
              for m in (flash_attention, selective_scan)}


class Predictor:
    """``use_mesh``: ``True`` serves over :func:`make_mesh`'s local
    devices, a ``Mesh`` over its devices; the first holds ``model`` and
    must be ``device`` (``"cuda"`` names any card); ``False`` serves on
    ``device`` alone."""

    def __init__(self, model: BeamFuser, config: GlobalConfig,
                 batch_buckets: Sequence[int] = (1, 8), top_k: int = 3,
                 device="cuda", use_mesh: Union[bool, Mesh] = False):
        self.device = resolve_device(device)
        self.mesh = None
        if use_mesh:
            self.mesh = use_mesh if isinstance(use_mesh, Mesh) else (
                make_mesh())
            first = self.mesh.device
            if first.type != self.device.type or self.device.index not in (
                    None, first.index):
                raise ValueError(f"the mesh's first device {first} is not "
                                 f"{self.device}")
            self.device = first
        self.config = config
        self.model = model.to(self.device).eval()
        self.buckets = tuple(sorted(batch_buckets))
        self.top_k = top_k
        # one replica a device, its weights copied there once
        self.replicas = [self.model] + ([] if self.mesh is None else [
            copy.deepcopy(self.model).to(d) for d in self.mesh.devices[1:]])

    @property
    def n_devices(self) -> int:
        """The devices a request's rows split over."""
        return len(self.replicas)

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_state_dict(cls, state_dict, config: GlobalConfig,
                        device="cuda", **kw) -> "Predictor":
        """A port state_dict, loaded strictly into ``BeamFuser(config)``."""
        model = BeamFuser(config, device=device)
        model.load_state_dict(state_dict, strict=True)
        return cls(model, config, device=device, **kw)

    @classmethod
    def from_file(cls, path: str, config: GlobalConfig, **kw
                  ) -> "Predictor":
        """A checkpoint file, read by its suffix (:func:`read_state_dict`):
        the port's ``.pt`` (``train/checkpoints.py::save_model``), a JAX
        ``.msgpack`` (read without flax or msgpack) or a reference ``.pth``
        (DataParallel naming; keys the model does not use are ignored, as
        the JAX package does)."""
        return cls.from_state_dict(read_state_dict(path, config), config,
                                   **kw)

    # the JAX package's constructor names, one for each format
    from_checkpoint = from_msgpack = from_torch = from_file

    # -- inference ---------------------------------------------------------

    def _bucket(self, n: int) -> int:
        m = self.n_devices
        for b in self.buckets:
            if n <= b * m:
                return b * m
        top = self.buckets[-1] * m
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
            arrs.append(torch.from_numpy(a))
        if self.mesh is None:
            logits = self.model(*(a.to(self.device) for a in arrs))
        else:
            # every replica's inputs copied and its forward queued before
            # any result is read back
            per = b // self.n_devices
            inputs = [[a[i * per:(i + 1) * per].to(d) for a in arrs]
                      for i, d in enumerate(self.mesh.devices)]
            outs = [model(*x) for model, x in zip(self.replicas, inputs)]
            logits = torch.cat([o.to(self.device) for o in outs])
        probs = torch.softmax(logits.float(), dim=-1)
        conf, idx = torch.topk(probs, self.top_k, dim=-1)
        return (idx[:n].cpu().numpy() + 1,        # 1-indexed, beam_pred.csv
                conf[:n, 0].cpu().numpy())

    def warmup(self) -> None:
        """One request at each bucket size (times the mesh's devices)."""
        for b in (bk * self.n_devices for bk in self.buckets):
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
        for d in set(self.mesh.devices if self.mesh else (self.device,)):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    # -- the serving artifact (torch.export) --------------------------------

    def export_program(self, batch_size: Optional[int] = None
                       ) -> "torch.export.ExportedProgram":
        """The serving forward (:class:`ServingForward`) traced by
        ``torch.export`` at a fixed batch (default: the largest bucket
        times the mesh's devices), f32 inputs of :meth:`predict`'s shapes
        on this predictor's device.

        The trace runs under ``torch.no_grad()``: the kernel wrappers then
        call their custom ops (with grad they would take their autograd
        Functions, which ``torch.export`` cannot trace), and the model's
        parameters are left as they are."""
        b = batch_size or self.buckets[-1] * self.n_devices
        args = tuple(torch.zeros(s, device=self.device)
                     for s in self._input_shapes(b))
        with torch.no_grad():
            return torch.export.export(ServingForward(self.model, self.top_k),
                                       args, strict=False)

    def export_artifact(self, path: str,
                        batch_size: Optional[int] = None
                        ) -> "torch.export.ExportedProgram":
        """Writes :meth:`export_program` to ``path`` with
        ``torch.export.save``: one ``.pt2`` file that holds the graph and
        the weights, which :class:`ExportedPredictor` serves without the
        checkpoint or the model's code, with the same torch, on the device
        type it was exported on.  Returns the program."""
        program = self.export_program(batch_size)
        torch.export.save(program, path)
        return program


class ServingForward(torch.nn.Module):
    """The forward that an artifact holds: the model, softmax in f32 and
    top-k.  Returns the plain tuple (indices, confidences):
    ``torch.export.save`` cannot write ``torch.return_types.topk``."""

    def __init__(self, model: BeamFuser, top_k: int):
        super().__init__()
        self.model, self.top_k = model, top_k

    def forward(self, image, lidar, radar, gps):
        probs = torch.softmax(self.model(image, lidar, radar, gps).float(),
                              dim=-1)
        conf, idx = torch.topk(probs, self.top_k, dim=-1)
        return idx, conf


class ExportedPredictor:
    """Serves a :meth:`Predictor.export_artifact` file: loads it with
    ``torch.export.load`` and runs its graph (:meth:`forward`) under
    ``torch.inference_mode()``, padding ragged requests up to the
    artifact's fixed batch and returning :meth:`Predictor.predict`'s
    contract (1-indexed top-k beams, top-1 confidences).  It needs no
    checkpoint and builds no ``BeamFuser``; the port's custom ops must be
    registered, which importing this module does (a bare
    ``torch.export.load`` fails to resolve ``torch.ops.deepsense6g``
    without them).

    ``device`` (default ``cuda``, which raises without CUDA) must be the
    device type the artifact was exported on; nothing moves it."""

    def __init__(self, path: str, device="cuda"):
        self.device = resolve_device(device)
        self.program = torch.export.load(path)
        sig = self.program.graph_signature
        if any(s.kind != OutputKind.USER_OUTPUT for s in sig.output_specs):
            raise ValueError(f"{path}: the serving graph mutates its state")
        # the graph's inputs in order: its weights, buffers and constants,
        # None where a request's tensor goes
        state = {**self.program.state_dict, **self.program.constants}
        self._inputs = [None if s.kind == InputKind.USER_INPUT
                        else state[s.target] for s in sig.input_specs]
        first = sig.user_inputs[0]
        spec = next(n.meta["val"] for n in self.program.graph.nodes
                    if n.op == "placeholder" and n.name == first)
        if spec.device.type != self.device.type:
            raise ValueError(f"{path} was exported on {spec.device.type}, "
                             f"not {self.device.type}: export it again "
                             f"there")
        self.batch = int(spec.shape[0])

    def forward(self, image, lidar, radar, gps):
        """The artifact's graph on a full batch of device tensors:
        (top-k indices, confidences).  It runs the graph module on the
        lifted weights itself: ``ExportedProgram.module()`` writes each
        weight's name as Python, and the 30-to-5 decoder's ``in`` is a
        keyword."""
        request = iter((image, lidar, radar, gps))
        with torch.inference_mode():
            return tuple(self.program.graph_module(
                *(next(request) if x is None else x for x in self._inputs)))

    def predict(self, image, lidar, radar, gps
                ) -> Tuple[np.ndarray, np.ndarray]:
        n, b = image.shape[0], self.batch
        if n > b:
            raise ValueError(
                f"request batch {n} exceeds the artifact's fixed batch {b}; "
                "re-export with a larger batch_size or split the request")
        arrs = []
        for a in (image, lidar, radar, gps):
            a = np.asarray(a, dtype=np.float32)
            if n < b:
                a = np.pad(a, ((0, b - n),) + ((0, 0),) * (a.ndim - 1))
            arrs.append(torch.from_numpy(a).to(self.device))
        idx, conf = self.forward(*arrs)
        return idx[:n].cpu().numpy() + 1, conf[:n, 0].cpu().numpy()


def graph_ops(program) -> Dict[str, int]:
    """How many nodes of an exported program's graph call each op, by the
    op's name (``deepsense6g.flash_mha_fwd.default``,
    ``aten.matmul.default``, ...)."""
    return dict(Counter(str(n.target) for n in program.graph.nodes
                        if n.op == "call_function"))


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


def read_state_dict(path: str, config: GlobalConfig
                    ) -> Dict[str, torch.Tensor]:
    """A ``BeamFuser`` checkpoint file as the port's state_dict (CPU), by
    its suffix: the port's ``.pt``, a JAX ``.msgpack`` or a reference
    ``.pth`` (read for ``config``'s model)."""
    if path.endswith(".pt"):
        return torch.load(path, map_location="cpu", weights_only=True)
    if path.endswith(".msgpack"):
        return from_jax_variables(read_flax_msgpack(path))
    if path.endswith(".pth"):
        params, stats, _ = load_reference_checkpoint(path, config)
        return from_jax_variables({"params": params, "batch_stats": stats})
    raise ValueError(f"{path}: expected a .pt, .msgpack or .pth checkpoint")


def load_predictor(path: str, config: GlobalConfig, **kw) -> Predictor:
    """A ``Predictor`` for a checkpoint file, chosen by its suffix."""
    return Predictor.from_file(path, config, **kw)


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
