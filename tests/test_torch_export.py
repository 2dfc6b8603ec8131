"""The port's serving artifact on the CPU: the flash and scan forward
kernels as ``torch.library`` custom ops (``torch.library.opcheck`` on their
CPU kernels, and their fake implementations against what the CUDA wrappers
allocate, under ``FakeTensorMode`` with CUDA tensors), and
``Predictor.export_artifact`` / ``ExportedPredictor`` at the small geometry
of tests/test_torch_slice.py:38-40.

The GPT TransFuser (``use_flash_attention``) and the MambaFuser
(``use_pallas_scan``, with and without ``reverse_scan_kernel``) are
exported here; their graphs hold one custom-op node for each attention or
Mamba layer and none of the ops that the plain versions trace to; the
artifacts are reloaded in a fresh process that builds no model and reads no
checkpoint, and serve what the live ``Predictor`` serves (indices equal,
confidences to rtol 1e-5, atol 1e-6, as in the JAX package's
tests/test_serve.py:67-94).  The GPT artifact is made from the weights of
a JAX model (``from_jax_variables``) and agrees with the JAX package's own
artifact of them: equal top-1 beams where the two best probabilities lie
more than 2e-3 apart, and confidences within 2e-3, the bound of
tests/test_torch_serve.py.
"""

import collections
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
from deepsense6g_tii_tpu.serve import ExportedPredictor as JaxExported
from deepsense6g_tii_tpu.serve import Predictor as JaxPredictor
from deepsense6g_tii_tpu_torch import config, serve
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
from deepsense6g_tii_tpu_torch.ops import flash_attention as fa
from deepsense6g_tii_tpu_torch.ops import selective_scan as ss
from deepsense6g_tii_tpu_torch.serve import ExportedPredictor, Predictor
from deepsense6g_tii_tpu_torch.tools import bench_serve
from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch
from synthetic_data import jinit
from test_torch_modules import randomized
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the small geometry of tests/test_torch_slice.py:38-40
SMALL = dict(seq_len=2, n_layer=2, vert_anchors=2, horz_anchors=2,
             input_resolution=64, crop=64, backbone_blocks=(1, 1, 1, 1),
             compute_dtype="float32")
MODELS = {"gpt": dict(FFM=0, TFM=0, use_flash_attention=True),
          "mamba": dict(FFM=1, TFM=1, use_pallas_scan=True),
          "mamba_reverse": dict(FFM=1, TFM=1, use_pallas_scan=True,
                                reverse_scan_kernel=True)}
# served from artifacts: the three models and the 30-to-5 GPT TransFuser
SERVED = [*MODELS, "gpt_30to5"]
BATCH = 4               # the artifacts' batch: 3 rows pad, 5 exceed it
INPUTS = ("image", "lidar", "radar", "gps")
RTOL, ATOL = 1e-5, 1e-6
JAX_TOL = 2e-3


# -- the custom ops -----------------------------------------------------------

def _maker(seed, device):
    """Seeded normal tensors on the CPU; on another device (under
    ``FakeTensorMode``) empty ones, whose values nothing reads."""
    if device == "cpu":
        g = torch.Generator().manual_seed(seed)
        return lambda *s: torch.randn(*s, generator=g)
    return lambda *s: torch.empty(*s, device=device)


def _qkv(seed, d, t=37, dtype=torch.float32, device="cpu"):
    new = _maker(seed, device)
    return [new(2, 3, t, d).to(dtype) for _ in range(3)]


def _scan_args(seed, reverse, grouped, slices, dtype=torch.float32,
               device="cpu"):
    """u, dt, A, B, C, reverse as the Mamba layer gives them: A (d, n) or
    grouped (2, d, n), B and C whole or column slices of one x_dbl."""
    new = _maker(seed, device)
    b, L, d, n = 4, 70, 24, ss.D_STATE
    u = new(b, L, d).to(dtype)
    dt = new(b, L, d).abs() * 0.5
    A = -new(*((2,) if grouped else ()), d, n).abs() - 0.5
    x_dbl = new(b, L, 3 + 2 * n).to(dtype)
    if not slices:
        B, C = (x_dbl[..., 3:3 + n].contiguous(),
                x_dbl[..., 3 + n:].contiguous())
    elif device == "cpu":
        B, C = x_dbl[..., 3:3 + n], x_dbl[..., 3 + n:]
    else:       # a fake CUDA tensor takes no view here: the slices' strides
        B, C = (torch.empty_strided((b, L, n), x_dbl.stride(), dtype=dtype,
                                    device=device) for _ in range(2))
    return u, dt, A, B, C, reverse


@pytest.mark.parametrize("d,p", [(16, 0.0), (32, 0.0), (64, 0.0),
                                 (128, 0.1)])
def test_flash_op_passes_opcheck(d, p):
    q, k, v = _qkv(d, d)
    torch.library.opcheck(fa.flash_fwd_op, (q, k, v, d ** -0.5, p, 1234,
                                            fa.DEFAULT_BLOCK))
    o, lse = fa.flash_fwd_op(q, k, v, d ** -0.5, p, 1234, fa.DEFAULT_BLOCK)
    want = fa.flash_mha_reference(q, k, v, d ** -0.5, p, 1234)
    assert torch.equal(o, want[0]) and torch.equal(lse, want[1])


@pytest.mark.parametrize("reverse,grouped,slices", [
    (False, False, False), (True, False, False), (False, True, True),
    (True, True, True)])
def test_scan_op_passes_opcheck(reverse, grouped, slices):
    args = _scan_args(5, reverse, grouped, slices)
    torch.library.opcheck(ss.scan_fwd_op, args)
    for got, want in zip(ss.scan_fwd_op(*args),
                         ss.selective_scan_reference(*args)):
        assert torch.equal(got, want)


def _cuda_allocation(monkeypatch, which, dtype):
    """The op's outputs and the CUDA wrapper's allocation for the same
    fake CUDA inputs (the wrapper's launch and, for flash, its pointer
    checks stubbed out: a fake tensor has no memory)."""
    if which == "flash":
        monkeypatch.setattr(fa, "_fwd_kernel", lambda *a: None)
        monkeypatch.setattr(fa, "_check_kernel_inputs", lambda *a: None)
        make = lambda: (*_qkv(1, 64, dtype=dtype, device="cuda"),  # noqa
                        0.125, 0.0, 0, fa.DEFAULT_BLOCK)
        op, wrapper = fa.flash_fwd_op, fa._fwd_cuda
    else:
        monkeypatch.setattr(ss, "_fwd_kernel", lambda *a: None)
        make = lambda: _scan_args(2, True, True, True, dtype,  # noqa: E731
                                  device="cuda")
        op, wrapper = ss.scan_fwd_op, ss._scan_fwd_cuda
    with FakeTensorMode():
        args = make()
        return op(*args), wrapper(*args)


@pytest.mark.parametrize("which", ["flash", "scan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_implementation_allocates_as_the_cuda_wrapper(monkeypatch,
                                                           which, dtype):
    got, want = _cuda_allocation(monkeypatch, which, dtype)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert (g.shape, g.dtype, g.stride(), g.device) == (
            w.shape, w.dtype, w.stride(), w.device)
        assert g.device.type == "cuda"
    assert got[1].dtype == torch.float32


# -- the artifacts ------------------------------------------------------------

CHILD = r"""
import json, sys
import numpy as np
import torch
from deepsense6g_tii_tpu_torch.models import fuser
from deepsense6g_tii_tpu_torch.serve import ExportedPredictor

def no_model(*a, **k):
    raise AssertionError("the artifact's process built a BeamFuser")

fuser.BeamFuser.__init__ = no_model
torch.set_num_threads(2)
folder, name = sys.argv[1:]
req = np.load(f"{folder}/{name}.npz")
inputs = [req[k] for k in ("image", "lidar", "radar", "gps")]
pred = ExportedPredictor(f"{folder}/{name}.pt2", device="cpu")
arrays, notes = {}, {"batch": pred.batch, "oversize": None}
for n in (3, 4):
    arrays[f"idx{n}"], arrays[f"conf{n}"] = pred.predict(
        *(x[:n] for x in inputs))
try:
    pred.predict(*inputs)
except ValueError as e:
    notes["oversize"] = str(e)
np.savez(f"{folder}/{name}.served.npz", **arrays)
with open(f"{folder}/{name}.served.json", "w") as f:
    json.dump(notes, f)
"""


class CountOps(TorchDispatchMode):
    """Counts the ops that run under it, by name."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


class Artifacts:
    """The artifacts (batch 4) of the three models and of the 30-to-5 GPT
    TransFuser, exported from live Predictors, with the live predictions,
    the graphs' op counts and the ops that an eager forward calls; and for
    each, once its model is gone, a fresh process that serves it, left
    running while the next is exported and other tests run
    (:meth:`served` waits for it)."""

    def __init__(self, folder, jax_variables):
        self.folder, self.live, self.children = folder, {}, {}
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            x for x in (REPO, os.environ.get("PYTHONPATH")) if x))
        for name in SERVED:
            cfg, model = _model(name, jax_variables)
            b = make_synth_batch(cfg, BATCH + 1, seed=31, with_labels=False)
            req = [b[k] for k in INPUTS]
            np.savez(folder / f"{name}.npz", **dict(zip(INPUTS, req)))
            pred = Predictor(model, cfg, batch_buckets=(1, BATCH),
                             device="cpu")
            program = pred.export_artifact(str(folder / f"{name}.pt2"))
            with CountOps() as eager:
                rows3 = pred.predict(*(x[:3] for x in req))
            self.live[name] = {
                "ops": serve.graph_ops(program), "eager": eager.counts,
                3: rows3, 4: pred.predict(*(x[:4] for x in req))}
            del pred, model, program
            self.children[name] = subprocess.Popen(
                [sys.executable, "-c", CHILD, str(folder), name],
                cwd=str(folder), env=env)

    def served(self, name):
        """(arrays, notes) that ``name``'s process served and wrote."""
        assert self.children[name].wait(timeout=300) == 0
        return (dict(np.load(self.folder / f"{name}.served.npz")),
                json.loads((self.folder / f"{name}.served.json")
                           .read_text()))


@pytest.fixture(scope="module")
def jax_variables():
    """tests/test_torch_slice.py's weights: its model, its input shapes (3
    rows: the compile cache has its init) and its perturbation."""
    b = make_synth_batch(GlobalConfig(**SMALL), 3, seed=11,
                         with_labels=False)
    model = JaxBeamFuser(JaxConfig(**SMALL, FFM=0, TFM=0))
    return randomized(jinit(model, *(jnp.asarray(b[k]) for k in INPUTS)),
                      12)


def _model(name, jax_variables):
    if name == "gpt_30to5":
        small = {k: v for k, v in SMALL.items()
                 if k not in ("seq_len", "n_layer")}
        cfg = config.config_30to5(**small, n_layer=1, **MODELS["gpt"])
    else:
        cfg = GlobalConfig(**SMALL, **MODELS[name])
    if name == "gpt":
        model = BeamFuser(cfg, device="cpu")
        model.load_state_dict(from_jax_variables(jax_variables), strict=True)
    else:
        model = BeamFuser(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(3))
    return cfg, model


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, jax_variables):
    art = Artifacts(tmp_path_factory.mktemp("artifacts"), jax_variables)
    yield art
    for child in art.children.values():
        if child.poll() is None:
            child.kill()
            child.wait()


def _plain_ops():
    """The ops that the plain attention and the plain scan trace to, from
    exports of the two functions alone."""
    class Plain(torch.nn.Module):
        def forward(self, q, u, dt, A, B, C):
            return (fa.flash_mha_reference(q, q, q, 0.25)[0],
                    ss.selective_scan_reference(u, dt, A, B, C)[0])

    args = (_qkv(0, 16)[0], *_scan_args(0, False, False, False)[:5])
    with torch.no_grad():
        return serve.graph_ops(torch.export.export(Plain(), args))


@pytest.mark.parametrize("name", list(MODELS))
def test_graph_runs_each_layer_through_its_custom_op(artifacts, name):
    """One custom-op node for each call of the eager forward (4 stages x 2
    layers of attention; 19 scans in the MambaFuser), none of the other
    kernel's, and none of the ops that the plain versions trace to: the
    attention's products and softmax (the serving softmax alone stays),
    the doubling scan's step."""
    live = artifacts.live[name]
    ops, kernel = live["ops"], MODELS[name].get("use_flash_attention")
    op = serve.KERNEL_OPS[fa.KERNEL if kernel else ss.KERNEL]
    other = serve.KERNEL_OPS[ss.KERNEL if kernel else fa.KERNEL]
    assert ops.get(op) == live["eager"][op] == (8 if kernel else 19)
    assert other not in ops
    plain = _plain_ops()
    assert plain.get("aten.matmul.default") and plain.get(
        "aten.addcmul.default")
    if kernel:
        assert "aten.matmul.default" not in ops
        assert ops["aten.softmax.int"] == 1
    else:
        assert "aten.addcmul.default" not in ops


def test_bench_serve_exported(monkeypatch, tmp_path, capsys):
    tiny = dict(seq_len=2, input_resolution=32, crop=32, vert_anchors=1,
                horz_anchors=1, n_layer=1, backbone_blocks=(1, 1, 1, 1),
                compute_dtype="float32", use_flash_attention=True)
    monkeypatch.setattr(bench_serve, "serving_config",
                        lambda FFM, TFM, **_: GlobalConfig(**tiny, FFM=FFM,
                                                           TFM=TFM))
    monkeypatch.setattr(bench_serve, "ARTIFACT_DIR", tmp_path)
    monkeypatch.setattr(bench_serve, "PIPELINED_CALLS", 4)
    assert bench_serve.main(["--arch", "gpt", "--batches", "1,2", "--iters",
                             "2", "--device", "cpu", "--exported"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    x = out["exported"]
    assert set(x) == {"path", "batch", "artifact_mb", "export_s", "load_s",
                      "top1_match", "conf_max_abs_err", "p50_ms", "p90_ms",
                      "samples_per_sec"}
    assert x["path"] == str(tmp_path / "gpt_b2.pt2") and x["batch"] == 2
    assert os.path.getsize(x["path"]) / 1e6 == x["artifact_mb"]
    assert x["top1_match"] is True and x["conf_max_abs_err"] <= RTOL
    assert 0 < x["p50_ms"] <= x["p90_ms"] and x["samples_per_sec"] > 0
    assert x["export_s"] > 0 and x["load_s"] > 0


def test_exported_predictor_defaults_to_cuda(artifacts, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExportedPredictor(str(artifacts.folder / "gpt.pt2"))


def test_artifact_matches_the_jax_packages(artifacts, jax_variables,
                                           tmp_path):
    """The JAX package's artifact of the same weights (plain attention,
    jax.export on the CPU) against the port's flash artifact, served in
    the fresh process."""
    req = np.load(artifacts.folder / "gpt.npz")
    requests = [req[k] for k in INPUTS]
    path = str(tmp_path / "gpt.stablehlo")
    JaxPredictor(jax_variables, JaxConfig(**SMALL, FFM=0, TFM=0),
                 batch_buckets=(1, BATCH)).export_artifact(path)
    want_idx, want_conf = JaxExported(path).predict(*(x[:3]
                                                      for x in requests))
    out, _ = artifacts.served("gpt")
    np.testing.assert_allclose(out["conf3"], want_conf, rtol=0,
                               atol=JAX_TOL)
    _, model = _model("gpt", jax_variables)
    with torch.no_grad():
        probs = torch.softmax(model.eval()(
            *(torch.from_numpy(x[:3]) for x in requests)), -1).numpy()
    top2 = np.sort(probs, -1)[:, ::-1][:, :2]
    separated = top2[:, 0] - top2[:, 1] > JAX_TOL
    assert separated.any()
    np.testing.assert_array_equal(out["idx3"][separated, 0],
                                  want_idx[separated, 0])


@pytest.mark.parametrize("name", SERVED)
def test_reloaded_artifact_serves_as_the_live_predictor(artifacts, name):
    """Indices equal and confidences close, for 3 rows (padded up to the
    batch of 4) and 4; with pred_len 5 (gpt_30to5) beams (B, 5, k) and the
    first step's top k, as ``Predictor.predict`` returns them."""
    out, notes = artifacts.served(name)
    assert notes["batch"] == BATCH
    steps = (5,) if name == "gpt_30to5" else ()
    for n in (3, 4):
        idx, conf = artifacts.live[name][n]
        assert out[f"idx{n}"].shape == idx.shape == (n, *steps, 3)
        assert out[f"conf{n}"].shape == conf.shape == (
            (n, 3) if steps else (n,))
        np.testing.assert_array_equal(out[f"idx{n}"], idx)
        np.testing.assert_allclose(out[f"conf{n}"], conf, rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("name", SERVED)
def test_oversize_request_raises(artifacts, name):
    _, notes = artifacts.served(name)
    assert notes["oversize"] is not None and "exceeds" in notes["oversize"]
