"""The 30-to-5 multi-step variant in the port (10 input frames, 5 predicted
beams through a GRU decoder; ``config.config_30to5``) against the JAX
package, on the CPU at the small test geometry with ``seq_len`` 10 (122
tokens): the GRU cell and its init, whole-model logits and ``Predictor``
of both fusion models, the flattened loss, two train steps, and the train
CLI with ``--pred_len 5`` and ``--load_torch_checkpoint``.

Tolerances: the cell 1e-6 (the same f32 products); whole-model logits and
the train steps as tests/test_torch_slice.py, tests/test_torch_mambafuser.py
and tests/test_torch_train.py hold them.
"""

import csv
import dataclasses
import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu import config as jax_config
from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
from deepsense6g_tii_tpu.serve import Predictor as JaxPredictor
from deepsense6g_tii_tpu.train import state as jax_state
from deepsense6g_tii_tpu.train import steps as jax_steps
from deepsense6g_tii_tpu_torch import config
from deepsense6g_tii_tpu_torch.cli import train as cli
from deepsense6g_tii_tpu_torch.data.dataset import BeamDataset
from deepsense6g_tii_tpu_torch.data.loader import DataLoader
from deepsense6g_tii_tpu_torch.models.checkpoint_import import (
    save_reference_checkpoint)
from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser, GRUCell
from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
from deepsense6g_tii_tpu_torch.serve import Predictor
from deepsense6g_tii_tpu_torch.train import steps
from deepsense6g_tii_tpu_torch.train.state import create_train_state
from deepsense6g_tii_tpu_torch.utils.demo_data import make_demo_root
from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch
from synthetic_data import jinit
from test_torch_mambafuser import perturbed
from test_torch_modules import randomized
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)
from test_torch_train import (_assert_envelope, _copy, _jax_snapshot,
                              _leafmax, _params_envelope, _snapshot,
                              _stats_tol)

GEOMETRY = dict(n_layer=1, vert_anchors=2, horz_anchors=2,
                input_resolution=64, crop=64, backbone_blocks=(1, 1, 1, 1),
                compute_dtype="float32")
MODELS = {"gpt": dict(FFM=0, TFM=0), "mamba": dict(FFM=1, TFM=1)}
INPUTS = ("image", "lidar", "radar", "gps")
TOL = 2e-3
P = 5


def _cfg(kind, module=config, **kw):
    return module.config_30to5(**GEOMETRY, **MODELS[kind], **kw)


def test_config_30to5_matches_jax():
    got, want = config.config_30to5(), jax_config.config_30to5()
    assert (got.seq_len, got.pred_len, got.n_tokens) == (10, 5, 1922)
    ours = dataclasses.asdict(got)
    for key, val in dataclasses.asdict(want).items():
        if key in ours:
            assert ours[key] == val, key


# -- the GRU decoder ----------------------------------------------------------

def test_gru_cell_matches_flax():
    rng = np.random.default_rng(0)
    h, x = (rng.standard_normal((4, 64), np.float32) for _ in range(2))
    cell = nn.GRUCell(features=64)
    variables = randomized(cell.init(jax.random.PRNGKey(0), jnp.asarray(h),
                                     jnp.asarray(x)), 1)
    want, _ = cell.apply(variables, jnp.asarray(h), jnp.asarray(x))
    port = GRUCell(64)
    port.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_decoder_init_follows_flax():
    """Input kernels lecun-normal, recurrent kernels orthogonal, biases 0
    (flax's GRUCell); seeded, so two models of one seed are equal."""
    model = BeamFuser(_cfg("gpt"), device="cpu")
    dec = model.decoder
    for name in ("hr", "hz", "hn"):
        w = getattr(dec, name).weight.detach()
        torch.testing.assert_close(w @ w.T, torch.eye(64), rtol=0,
                                   atol=1e-5)
    for name in ("ir", "iz", "in"):
        w = getattr(dec, name).weight.detach()
        assert 0.8 < float(w.std()) * 8 < 1.2          # std 1/sqrt(64)
        assert not getattr(dec, name).bias.any()
    assert dec.hr.bias is None and dec.hz.bias is None
    assert not dec.hn.bias.any() and not model.output.bias.any()
    again = BeamFuser(_cfg("gpt"), device="cpu")
    for key, val in model.state_dict().items():
        torch.testing.assert_close(again.state_dict()[key], val, rtol=0,
                                   atol=0)


# -- whole model and Predictor ------------------------------------------------

@pytest.fixture(scope="module", params=sorted(MODELS))
def model_pair(request):
    kind = request.param
    jcfg = _cfg(kind, jax_config)
    b = make_synth_batch(_cfg(kind), 3, seed=9, with_labels=False)
    inputs = tuple(b[k] for k in INPUTS)
    jmodel = JaxBeamFuser(jcfg)
    init = jinit(jmodel, *map(jnp.asarray, inputs))
    # the small MambaFuser's logits stay O(1) only under the init-scale
    # perturbation (tests/test_torch_mambafuser.py::perturbed)
    variables = jax.device_get(perturbed(init, 9) if kind == "mamba"
                               else randomized(init, 9))
    logits = np.asarray(jax.jit(lambda v, *a: jmodel.apply(
        v, *a, train=False))(variables, *map(jnp.asarray, inputs)))
    model = BeamFuser(_cfg(kind), device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return kind, jcfg, variables, inputs, logits, model


def test_eval_logits_match_jax(model_pair):
    _, _, _, inputs, want, model = model_pair
    with torch.no_grad():
        got = model(*map(torch.from_numpy, inputs)).numpy()
    assert got.shape == want.shape == (3, P, 64)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def test_predictor_multistep_matches_jax(model_pair):
    """(B, 5, 3) beams and the first step's top-3 confidences (B, 3), as
    the JAX Predictor returns them, on a ragged batch of 3."""
    kind, jcfg, variables, inputs, _, model = model_pair
    want_idx, want_conf = JaxPredictor(variables, jcfg,
                                       batch_buckets=(1, 4)).predict(*inputs)
    idx, conf = Predictor(model, _cfg(kind), batch_buckets=(1, 4),
                          device="cpu").predict(*inputs)
    assert idx.shape == want_idx.shape == (3, P, 3)
    assert conf.shape == want_conf.shape == (3, 3)
    assert idx.min() >= 1 and idx.max() <= 64
    np.testing.assert_allclose(conf, want_conf, rtol=TOL, atol=TOL)
    with torch.no_grad():
        logits = model(*map(torch.from_numpy, inputs))
    probs = torch.softmax(logits, -1).numpy()
    for row in range(3):
        for step in range(P):
            p = np.sort(probs[row, step])[::-1]
            for j in range(3):
                if p[j] - p[j + 1] > TOL and (j == 0
                                              or p[j - 1] - p[j] > TOL):
                    assert idx[row, step, j] == want_idx[row, step, j]


# -- the flattened loss -------------------------------------------------------

@pytest.mark.parametrize("loss", ["focal", "ce"])
@pytest.mark.parametrize("temp_coef", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_multistep_loss_matches_jax(loss, temp_coef, weighted):
    cfg = _cfg("gpt")
    batch = make_synth_batch(cfg, 4, seed=3)
    if weighted:
        batch["valid"] = np.asarray([1, 0, 1, 1], np.float32)
    logits = (np.random.default_rng(4).standard_normal((4, P, 64)) * 3
              ).astype(np.float32)
    want = jax_steps._compute_loss(
        _cfg("gpt", jax_config), loss, temp_coef, jnp.asarray(logits),
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = steps.compute_loss(cfg, loss, temp_coef, torch.from_numpy(logits),
                             {k: torch.from_numpy(v)
                              for k, v in batch.items()})
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# -- two train steps against JAX make_train_step ------------------------------

B, LR, CLIP = 2, 1e-4, 3.0      # the 30-to-5 recipe's --grad_clip 3.0
NO_DROPOUT = dict(embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0,
                  use_flash_attention=True)


@pytest.fixture(scope="module")
def trajectory():
    """Two GPT 30-to-5 steps of each package (focal loss on soft targets,
    clip 3.0, EMA, dropout 0) from the same weights and batches."""
    jcfg = _cfg("gpt", jax_config, **NO_DROPOUT)
    cfg = _cfg("gpt", **NO_DROPOUT)
    batches = [make_synth_batch(cfg, B, seed=30 + i) for i in range(2)]
    jmodel = JaxBeamFuser(jcfg)
    variables = jax.device_get(randomized(jinit(
        jmodel, *(jnp.asarray(batches[0][k]) for k in INPUTS)), 31))
    tx = jax_state.make_optimizer()
    jstep = jax_steps.make_train_step(jmodel, jcfg, tx, use_ema=True,
                                      clip_grad_norm=CLIP)
    jstate = jax_state.create_train_state(_copy(variables), tx)
    model = BeamFuser(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    state = create_train_state(model)
    step = steps.make_train_step(model, cfg, state, use_ema=True,
                                 clip_grad_norm=CLIP, device="cpu")
    out = []
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           LR)
        m = step(b, LR)
        out.append(dict(port=_snapshot(state), jax=_jax_snapshot(jstate),
                        loss=(float(m["loss"]), float(jm["loss"])),
                        ranks=(m["ranks"].numpy(), np.asarray(jm["ranks"]))))
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_train_step_loss_and_ranks_match(trajectory, i):
    loss, jloss = trajectory[i]["loss"]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=(1e-5, 1e-3)[i])
    ranks, jranks = trajectory[i]["ranks"]
    assert ranks.shape == jranks.shape == (B, P, 64)
    np.testing.assert_array_equal(ranks[..., :3], jranks[..., :3])


@pytest.mark.parametrize("i", [0, 1])
def test_train_step_params_and_stats_match(trajectory, i):
    rec = trajectory[i]
    _assert_envelope(rec["port"]["params"], rec["jax"]["params"],
                     _params_envelope(i + 1), "params")
    _assert_envelope(rec["port"]["stats"], rec["jax"]["stats"],
                     _stats_tol((1e-4, 2e-3)[i]), "batch_stats")
    assert {n for n in rec["port"]["params"] if n.startswith("decoder.")} \
        == {f"decoder.{g}.{w}" for g in ("ir", "iz", "in", "hr", "hz", "hn")
            for w in ("weight", "bias") if (g, w) not in (("hr", "bias"),
                                                          ("hz", "bias"))}
    moved = rec["port"]["params"]["decoder.hn.weight"]
    assert _leafmax(moved) > 0


# -- the train CLI ------------------------------------------------------------

FLAGS = ["--seq_len", "10", "--pred_len", str(P), "--grad_clip", "3.0",
         "--compute_dtype", "float32", "--input_resolution", "64",
         "--vert_anchors", "2", "--horz_anchors", "2", "--n_layer", "1",
         "--FFM", "0", "--TFM", "0", "--num_workers", "2",
         "--batch_size", "4", "--augmentation", "0"]


@pytest.fixture(scope="module")
def demo30(tmp_path_factory):
    """A demo tree of 10-frame samples whose label column holds 5 beams a
    sample ("b1_b2_b3_b4_b5")."""
    root = make_demo_root(str(tmp_path_factory.mktemp("demo30")), n_train=3,
                          n_adapt=2, n_test=2, seq_len=10)
    rng = np.random.default_rng(5)
    for sub, name in (("Multi_Modal", "ml_challenge_dev_multi_modal.csv"),
                      ("Adaptation_dataset_multi_modal",
                       "ml_challenge_data_adaptation_multi_modal.csv")):
        path = os.path.join(root, sub, name)
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        col = rows[0].index("unit1_beam")
        for row in rows[1:]:
            row[col] = "_".join(str(b) for b in rng.integers(1, 65, P))
        with open(path, "w", newline="") as f:
            csv.writer(f).writerows(rows)
    return root


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def test_cli_trains_and_tests_30to5(demo30, tmp_path, monkeypatch):
    logdir = str(tmp_path / "r")
    base = ["--device", "cpu", "--data_root", demo30,
            "--backbone_blocks", "1,1,1,1", *FLAGS]
    assert cli.main(base + ["--logdir", logdir, "--epochs", "1"]) == 0
    with open(os.path.join(logdir, "recent.log")) as f:
        rec = json.load(f)
    assert rec["epoch"] == 1 and np.isfinite(rec["train_loss"]).all()
    assert np.isfinite(rec["val_loss"]).all()
    monkeypatch.chdir(tmp_path)
    assert cli.main(base + ["--logdir", str(tmp_path / "t"), "--Test", "1",
                            "--load_model_path",
                            os.path.join(logdir, "final_model")]) == 0
    rows = _csv_rows(tmp_path / "beam_pred.csv")
    assert len(rows) == 1 + 4 * P            # 4 test samples, 5 steps each
    assert all(1 <= int(b) <= 64 for r in rows[1:] for b in r[1:])
    assert len(_csv_rows(tmp_path / "beam_pred_confidence_seq.csv")) == \
        1 + 4 * P


def test_cli_imports_a_reference_checkpoint(demo30, tmp_path, monkeypatch,
                                            capsys):
    """--Test 1 --load_torch_checkpoint: the test CSV is the imported
    model's prediction (Predictor.from_torch on the test split).  The
    reference importer tells the backbones apart by depth, so this model
    has the reference's ResNet34/18."""
    argv = ["--device", "cpu", "--data_root", demo30, *FLAGS]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    source = BeamFuser(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    pth = str(tmp_path / "reference.pth")
    save_reference_checkpoint(source, pth)
    monkeypatch.chdir(tmp_path)
    assert cli.main(argv + ["--logdir", str(tmp_path / "t"), "--Test", "1",
                            "--load_torch_checkpoint", pth]) == 0
    out = capsys.readouterr().out
    assert "imported torch checkpoint" in out and "WARNING" not in out
    rows = _csv_rows(tmp_path / "beam_pred.csv")[1:]
    test_set = BeamDataset(demo30 + "/Multi_Modal_Test/",
                           "ml_challenge_test_multi_modal.csv", cfg,
                           test=True)
    batch = next(iter(DataLoader(test_set, 4)))
    pred = Predictor.from_torch(pth, cfg, batch_buckets=(4,), device="cpu")
    idx, _ = pred.predict(*(batch[k] for k in INPUTS))
    assert idx.shape == (4, P, 3)
    assert [[int(b) for b in r[1:]] for r in rows] == \
        idx.reshape(-1, 3).tolist()
