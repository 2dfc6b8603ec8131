"""Serving trained checkpoints with the port: the flax msgpack reader
(deepsense6g_tii_tpu_torch/models/msgpack.py) against flax's own, bit for
bit; ``Predictor.from_msgpack``, ``from_torch`` and ``from_checkpoint``
against the JAX package's ``Predictor.from_msgpack`` and ``from_torch`` on
the same checkpoint; and ``serve.main`` on each suffix, on the CPU.

The checkpoints are written here: a JAX GPT TransFuser's variables (small
geometry with the reference's ResNet34/18 backbones, which the reference
importer needs) by ``flax.serialization.to_bytes`` and, in the reference
naming, by the JAX package's ``export_reference_checkpoint`` and
``torch.save``; the port's ``.pt`` is ``torch.save`` of its state_dict.
Tolerances: f32 logits 1e-4 of the largest logit (the two frameworks sum
in other orders), confidences 2e-3 as in tests/test_torch_slice.py.
"""

import json

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu.models import checkpoint_import as jax_ci
from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
from deepsense6g_tii_tpu.serve import Predictor as JaxPredictor
from deepsense6g_tii_tpu_torch import serve
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.models.msgpack import (loads_flax_msgpack,
                                                      read_flax_msgpack)
from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
from deepsense6g_tii_tpu_torch.serve import Predictor
from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch
from synthetic_data import jinit
from test_torch_modules import randomized
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

GEOMETRY = dict(seq_len=2, n_layer=1, vert_anchors=2, horz_anchors=2,
                input_resolution=64, crop=64)
CFG = dict(**GEOMETRY, compute_dtype="float32", FFM=0, TFM=0)
LOGIT_RTOL = 1e-4
TOL = 2e-3
INPUTS = ("image", "lidar", "radar", "gps")


# -- the msgpack reader -------------------------------------------------------

def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


LEAVES = {
    "f32": lambda r: r.standard_normal((3, 5), np.float32),
    "bf16": lambda r: _bf16(r.standard_normal((4, 6))),
    "int32": lambda r: r.integers(-2 ** 31, 2 ** 31, (7,), np.int32),
    "int64_uint8": lambda r: {"a": r.integers(-2 ** 62, 2 ** 62, (2, 2)),
                              "b": r.integers(0, 256, (300,), np.uint8)},
    "scalars": lambda r: {"f": np.float32(2.5), "i": np.int16(-3),
                          "b": _bf16(1.5)[()], "py": (-5, 2 ** 40, 0.25,
                                                      True, None, 1 + 2j)},
    "tuple": lambda r: (r.standard_normal((2,), np.float32),
                        {"nested": (np.int8(1), "text" * 10)}),
    "empty": lambda r: np.zeros((0, 3), np.float32),
}


def _assert_same(got, want, path="tree"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            _assert_same(got[key], want[key], f"{path}/{key}")
    elif isinstance(want, np.ndarray) and want.dtype.name == "bfloat16" or (
            isinstance(want, np.generic) and want.dtype.name == "bfloat16"):
        assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
        assert tuple(got.shape) == np.shape(want), path
        np.testing.assert_array_equal(
            got.view(torch.uint16).numpy(), np.asarray(want).view(np.uint16),
            err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("leaf", sorted(LEAVES))
def test_read_flax_msgpack_matches_flax(leaf, tmp_path):
    tree = {"params": {"x": LEAVES[leaf](np.random.default_rng(1))}}
    path = tmp_path / "t.msgpack"
    path.write_bytes(flax.serialization.to_bytes(tree))
    want = flax.serialization.msgpack_restore(path.read_bytes())
    _assert_same(read_flax_msgpack(str(path)), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_read_flax_msgpack_joins_chunked_arrays(dtype, monkeypatch):
    """Leaves over flax's chunk size come as chunk dicts: joined again."""
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 64)
    x = np.arange(100, dtype=np.float32).reshape(4, 25)
    tree = {"w": x if dtype == "float32" else _bf16(x), "b": np.ones(3)}
    data = flax.serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    got = loads_flax_msgpack(data)
    _assert_same(got, flax.serialization.msgpack_restore(data))
    assert tuple(got["w"].shape) == (4, 25)


def test_read_flax_msgpack_refuses_other_bytes():
    with pytest.raises(ValueError, match="after the msgpack object"):
        loads_flax_msgpack(flax.serialization.to_bytes({"a": 1}) + b"\x00")
    with pytest.raises(ValueError, match="not in the subset"):
        loads_flax_msgpack(b"\xc1")


# -- Predictor from each checkpoint format ------------------------------------

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A randomised JAX GPT TransFuser written in the three formats, its f32
    logits on a batch of 3, and the JAX Predictors' outputs."""
    jcfg = JaxConfig(**CFG)
    b = make_synth_batch(GlobalConfig(**CFG), 3, seed=5, with_labels=False)
    inputs = tuple(b[k] for k in INPUTS)
    jmodel = JaxBeamFuser(jcfg)
    variables = jax.device_get(randomized(
        jinit(jmodel, *map(jnp.asarray, inputs)), 21))
    logits = np.asarray(jax.jit(lambda v, *a: jmodel.apply(
        v, *a, train=False))(variables, *map(jnp.asarray, inputs)))
    d = tmp_path_factory.mktemp("ckpt")
    paths = {s: str(d / f"best_model{s}") for s in (".msgpack", ".pth",
                                                    ".pt")}
    with open(paths[".msgpack"], "wb") as f:
        f.write(flax.serialization.to_bytes(variables))
    sd = jax_ci.export_reference_checkpoint(
        variables["params"], variables["batch_stats"], jcfg)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, paths[".pth"])
    torch.save(from_jax_variables(variables), paths[".pt"])
    jax_out = {
        ".msgpack": JaxPredictor.from_msgpack(paths[".msgpack"], jcfg,
                                              batch_buckets=(1, 4)),
        ".pth": JaxPredictor.from_torch(paths[".pth"], jcfg,
                                        batch_buckets=(1, 4))}
    jax_out = {s: p.predict(*inputs) for s, p in jax_out.items()}
    return paths, inputs, logits, jax_out


CONSTRUCTORS = {".msgpack": "from_msgpack", ".pth": "from_torch",
                ".pt": "from_checkpoint"}


@pytest.mark.parametrize("suffix", sorted(CONSTRUCTORS))
def test_predictor_from_checkpoint_matches_jax(checkpoints, suffix):
    paths, inputs, want_logits, jax_out = checkpoints
    pred = getattr(Predictor, CONSTRUCTORS[suffix])(
        paths[suffix], GlobalConfig(**CFG), batch_buckets=(1, 4),
        device="cpu")
    with torch.no_grad():
        logits = pred.model(*map(torch.from_numpy, inputs)).numpy()
    scale = float(np.abs(want_logits).max())
    np.testing.assert_allclose(logits, want_logits, rtol=LOGIT_RTOL,
                               atol=LOGIT_RTOL * scale)
    idx, conf = pred.predict(*inputs)            # 3 rows -> bucket 4
    probs = torch.softmax(torch.from_numpy(logits), -1).numpy()
    for want_idx, want_conf in jax_out.values():
        assert idx.shape == want_idx.shape == (3, 3)
        np.testing.assert_allclose(conf, want_conf, rtol=TOL, atol=TOL)
        for row in range(3):
            # equal ranks wherever the probabilities are separated by
            # more than the tolerance
            p = np.sort(probs[row])[::-1]
            for j in range(3):
                if p[j] - p[j + 1] > TOL and (j == 0
                                              or p[j - 1] - p[j] > TOL):
                    assert idx[row, j] == want_idx[row, j]


def test_from_checkpoint_is_strict(checkpoints, tmp_path):
    paths = checkpoints[0]
    sd = torch.load(paths[".pt"], weights_only=True)
    sd.pop("join_fc3.bias")
    torch.save(sd, tmp_path / "m.pt")
    with pytest.raises(RuntimeError, match="join_fc3.bias"):
        Predictor.from_checkpoint(str(tmp_path / "m.pt"),
                                  GlobalConfig(**CFG), device="cpu")
    with pytest.raises(ValueError, match=".pt, .msgpack or .pth"):
        serve.load_predictor(str(tmp_path / "m.ckpt"), GlobalConfig(**CFG),
                             device="cpu")


@pytest.fixture
def small_serving(monkeypatch):
    """serve.main's model at the test geometry (its flags and the device
    switch stay as they are)."""
    real = serve.serving_config
    monkeypatch.setattr(serve, "serving_config",
                        lambda *a: real(*a).replace(**GEOMETRY))
    return real


@pytest.mark.parametrize("suffix", sorted(CONSTRUCTORS))
def test_serve_main_serves_each_suffix(checkpoints, suffix, small_serving,
                                       capsys):
    paths = checkpoints[0]
    assert serve.main([paths[suffix], "--FFM", "0", "--TFM", "0",
                       "--batch", "2", "--iters", "2", "--device",
                       "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["batch"] == 2
    assert 0 < out["p50_ms"] <= out["p90_ms"]
    # the served weights are the checkpoint's: the port's Predictor on the
    # same synthetic request
    cfg = small_serving(0, 0, 1, False).replace(**GEOMETRY)
    assert cfg.compute_dtype == "float32" and not cfg.use_flash_attention
    pred = Predictor.from_checkpoint(paths[".pt"], cfg, device="cpu")
    b = make_synth_batch(cfg, 2, seed=0, with_labels=False)
    idx, conf = pred.predict(*(b[k] for k in INPUTS))
    assert out["top1"] == idx[:, 0].tolist()
    np.testing.assert_allclose(out["conf"], conf, rtol=1e-5, atol=1e-6)


def test_serving_config_follows_the_device():
    card = serve.serving_config(1, 1, 1, True)
    gpt = serve.serving_config(0, 0, 1, True)
    host = serve.serving_config(0, 0, 0, False)
    assert (card.FFM, card.TFM, card.add_velocity) == (1, 1, 1)
    assert card == serve.mambafuser_config()
    assert gpt == serve.gpt_transfuser_config() and gpt.use_flash_attention
    assert card.compute_dtype == "bfloat16" and card.use_pallas_scan
    assert card.n_tokens == 962
    assert (host.FFM, host.TFM, host.add_velocity) == (0, 0, 0)
    assert host.compute_dtype == "float32"
    assert not host.use_pallas_scan and not host.use_flash_attention
