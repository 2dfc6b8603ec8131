"""The port's first serving slice — the GPT TransFuser (FFM=0, TFM=0)
behind ``Predictor`` — against the JAX package on the same weights, on the
CPU at the small test geometry; plus the options the port does not take,
and the port's import rules and device rules.  The MambaFuser slice is
tests/test_torch_mambafuser.py.
"""

import ast
import inspect
import os
import pkgutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
from deepsense6g_tii_tpu.serve import Predictor as JaxPredictor
import deepsense6g_tii_tpu_torch
from deepsense6g_tii_tpu_torch import serve
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
from deepsense6g_tii_tpu_torch.serve import Predictor
from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch
from synthetic_data import jinit
from test_torch_modules import randomized
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "deepsense6g_tii_tpu_torch")

# the small geometry of tests/test_models.py:388-389
SMALL = dict(seq_len=2, n_layer=2, vert_anchors=2, horz_anchors=2,
             input_resolution=64, crop=64, backbone_blocks=(1, 1, 1, 1),
             compute_dtype="float32", FFM=0, TFM=0)
# whole-model bound of tests/test_encoder_oracle.py:307
TOL = 2e-3


@pytest.fixture(scope="module")
def inputs():
    b = make_synth_batch(GlobalConfig(**SMALL), 3, seed=11,
                         with_labels=False)
    return tuple(b[k] for k in ("image", "lidar", "radar", "gps"))


@pytest.fixture(scope="module")
def jax_variables(inputs):
    model = JaxBeamFuser(JaxConfig(**SMALL))
    variables = jinit(model, *map(jnp.asarray, inputs))
    return randomized(variables, 12)


def port_model(jax_variables, use_flash):
    model = BeamFuser(GlobalConfig(**SMALL, use_flash_attention=use_flash),
                      device="cpu")
    model.load_state_dict(from_jax_variables(jax_variables), strict=True)
    return model


@pytest.mark.parametrize("use_flash", [True, False])
def test_eval_logits_match_jax(jax_variables, inputs, use_flash):
    jax_model = JaxBeamFuser(JaxConfig(**SMALL,
                                       use_flash_attention=use_flash))
    want = np.asarray(jax.jit(lambda v, *a: jax_model.apply(
        v, *a, train=False))(jax_variables, *map(jnp.asarray, inputs)))
    with torch.no_grad():
        got = port_model(jax_variables, use_flash)(
            *map(torch.from_numpy, inputs)).numpy()
    assert got.shape == want.shape == (3, 64)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_predictor_matches_jax_on_ragged_batch(jax_variables, inputs):
    cfg = GlobalConfig(**SMALL, use_flash_attention=True)
    jax_pred = JaxPredictor(jax_variables, JaxConfig(**SMALL),
                            batch_buckets=(1, 4))
    pred = Predictor(port_model(jax_variables, True), cfg,
                     batch_buckets=(1, 4), device="cpu")
    assert pred._bucket(3) == 4 and pred._bucket(9) == 12
    want_idx, want_conf = jax_pred.predict(*inputs)       # 3 rows -> bucket 4
    idx, conf = pred.predict(*inputs)
    assert idx.shape == (3, 3) and conf.shape == (3,)
    assert idx.min() >= 1 and idx.max() <= 64
    np.testing.assert_allclose(conf, want_conf, rtol=TOL, atol=TOL)
    # top-k indices agree wherever the probabilities are separated by more
    # than the tolerance
    with torch.no_grad():
        logits = pred.model(*map(torch.from_numpy, inputs))
    probs = torch.softmax(logits, -1).numpy()
    for row in range(3):
        p = np.sort(probs[row])[::-1]
        for j in range(3):
            if j + 1 < len(p) and p[j] - p[j + 1] > TOL and (
                    j == 0 or p[j - 1] - p[j] > TOL):
                assert idx[row, j] == want_idx[row, j]


def test_predict_pads_without_changing_rows(jax_variables, inputs):
    pred = Predictor(port_model(jax_variables, True),
                     GlobalConfig(**SMALL), batch_buckets=(1, 8),
                     device="cpu")
    idx3, conf3 = pred.predict(*inputs)
    idx1, conf1 = pred.predict(*(x[1:2] for x in inputs))
    np.testing.assert_array_equal(idx1[0], idx3[1])
    np.testing.assert_allclose(conf1[0], conf3[1], rtol=1e-5, atol=1e-6)


def test_from_jax_variables_loads_strict(jax_variables):
    sd = from_jax_variables(jax_variables)
    model = BeamFuser(GlobalConfig(**SMALL), device="cpu")
    assert set(sd) == set(model.state_dict())
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    w = jax_variables["params"]["encoder"]["image_encoder"]["stem"]["conv1"]
    np.testing.assert_array_equal(
        model.encoder.image_encoder.stem.conv1.weight.detach().numpy(),
        np.asarray(w["kernel"]).transpose(3, 2, 0, 1))


def test_seeded_init_is_reproducible():
    cfg = GlobalConfig(**SMALL)
    a = BeamFuser(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(3)).state_dict()
    b = BeamFuser(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(3)).state_dict()
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


@pytest.mark.parametrize("knob", [dict(merge_lr_stage1=True),
                                  dict(FFM=1, padded_token_stream=True),
                                  dict(rebuild_feats=True),
                                  dict(merge_lidar_radar=True),
                                  dict(pred_len=5)])
def test_unported_options_raise(knob, inputs):
    knob = dict(knob)
    if knob.get("pred_len", 1) > 1:
        # ported: the 30-to-5 GRU decoder (tests/test_torch_30to5.py)
        model = BeamFuser(GlobalConfig(**{**SMALL, **knob}), device="cpu")
        with torch.no_grad():
            logits = model(*map(torch.from_numpy, inputs))
        assert logits.shape == (3, knob["pred_len"], 64)
        return
    if knob.get("rebuild_feats"):
        # ported: the modality-rebuild hook (tests/test_torch_rebuild.py)
        model = BeamFuser(GlobalConfig(**{**SMALL, "modality_missing":
                                          "image"}), device="cpu")
        rebuild = torch.zeros(6, 16, 16, 64)
        with torch.no_grad():
            _, maps = model.encoder(*map(torch.from_numpy, inputs),
                                    rebuild_feats=rebuild,
                                    return_stage1=True)
        assert torch.equal(maps[0], rebuild)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BeamFuser(GlobalConfig(**{**SMALL, **knob}), device="cpu")


# -- import and device rules ---------------------------------------------------

def _port_sources():
    for root, _, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _is_forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "msgpack", "deepsense6g_tii_tpu")


def test_port_sources_import_no_jax():
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {n}" for n in names
                    if _is_forbidden(n)]
    assert not bad, bad


def test_package_imports_with_jax_blocked():
    modules = [m.name for m in pkgutil.walk_packages(
        deepsense6g_tii_tpu_torch.__path__, "deepsense6g_tii_tpu_torch.")]
    assert {"deepsense6g_tii_tpu_torch.ops.flash_attention",
            "deepsense6g_tii_tpu_torch.ops.selective_scan",
            "deepsense6g_tii_tpu_torch.ops.mamba",
            "deepsense6g_tii_tpu_torch.ops.dropout",
            "deepsense6g_tii_tpu_torch.train.losses",
            "deepsense6g_tii_tpu_torch.train.metrics",
            "deepsense6g_tii_tpu_torch.train.scheduler",
            "deepsense6g_tii_tpu_torch.train.state",
            "deepsense6g_tii_tpu_torch.train.steps",
            "deepsense6g_tii_tpu_torch.tools.timing",
            "deepsense6g_tii_tpu_torch.tools.scan_roofline",
            "deepsense6g_tii_tpu_torch.tools.bench_scan",
            "deepsense6g_tii_tpu_torch.tools.bench_flash",
            "deepsense6g_tii_tpu_torch.utils.utm",
            "deepsense6g_tii_tpu_torch.utils.ply",
            "deepsense6g_tii_tpu_torch.utils.image",
            "deepsense6g_tii_tpu_torch.utils.demo_data",
            "deepsense6g_tii_tpu_torch.utils.tb_events",
            "deepsense6g_tii_tpu_torch.data.features",
            "deepsense6g_tii_tpu_torch.data.dataset",
            "deepsense6g_tii_tpu_torch.data.loader",
            "deepsense6g_tii_tpu_torch.train.checkpoints",
            "deepsense6g_tii_tpu_torch.train.profiling",
            "deepsense6g_tii_tpu_torch.train.engine",
            "deepsense6g_tii_tpu_torch.cli.train",
            "deepsense6g_tii_tpu_torch.models.checkpoint_import",
            "deepsense6g_tii_tpu_torch.models.torch_port",
            "deepsense6g_tii_tpu_torch.models.msgpack",
            "deepsense6g_tii_tpu_torch.serve",
            "deepsense6g_tii_tpu_torch.data.preprocess.radar",
            "deepsense6g_tii_tpu_torch.data.preprocess.lidar_filter",
            "deepsense6g_tii_tpu_torch.data.preprocess.augment",
            "deepsense6g_tii_tpu_torch.data.preprocess.csv_builder",
            "deepsense6g_tii_tpu_torch.examples.quickstart",
            "deepsense6g_tii_tpu_torch.tools.trace",
            "deepsense6g_tii_tpu_torch.tools.bench_serve",
            "deepsense6g_tii_tpu_torch.tools.profile_step",
            "deepsense6g_tii_tpu_torch.tools.bench_matrix"} <= set(modules)
    code = ("import sys, importlib\n"
            "for m in ('jax', 'jaxlib', 'flax', 'msgpack',\n"
            "          'deepsense6g_tii_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n")
    pythonpath = os.pathsep.join(
        x for x in (REPO, os.environ.get("PYTHONPATH")) if x)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   env=dict(os.environ, PYTHONPATH=pythonpath))


def test_entry_points_default_to_cuda():
    for fn in (BeamFuser.__init__, Predictor.__init__,
               Predictor.from_state_dict):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GlobalConfig(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BeamFuser(cfg)
    model = BeamFuser(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["best_model.pt", "--batch", "1"])
    assert next(model.parameters()).device.type == "cpu"
