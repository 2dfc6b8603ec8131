"""The port's training step (deepsense6g_tii_tpu_torch/train/) against the
JAX package's: train-mode BatchNorm, the losses, the scheduler and the
metrics, and two whole GPT TransFuser train steps (forward in train mode,
focal loss, backward through the flash kernels' plain versions, clip, AdamW,
EMA) on the same weights and batches at the small test geometry, in f32 on
the CPU.  The JAX step runs the Pallas flash kernels in interpret mode.
Dropout is 0 where the two packages are compared: their random streams
differ (the attention hash stream itself is held bit for bit in
tests/test_torch_flash_backward.py); dropout on is tested in the port alone.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu.models import resnet as jax_resnet
from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
from deepsense6g_tii_tpu.train import losses as jax_losses
from deepsense6g_tii_tpu.train import metrics as jax_metrics
from deepsense6g_tii_tpu.train import scheduler as jax_scheduler
from deepsense6g_tii_tpu.train import state as jax_state
from deepsense6g_tii_tpu.train import steps as jax_steps
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.models import resnet
from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
from deepsense6g_tii_tpu_torch.train import losses, metrics, scheduler, steps
from deepsense6g_tii_tpu_torch.train.state import (create_train_state,
                                                   make_optimizer)
from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch
from synthetic_data import jinit
from test_torch_modules import randomized

# the small geometry of tests/test_torch_slice.py, GPT fusion through the
# flash kernels, dropout off
SMALL = dict(seq_len=2, n_layer=2, vert_anchors=2, horz_anchors=2,
             input_resolution=64, crop=64, backbone_blocks=(1, 1, 1, 1),
             compute_dtype="float32", FFM=0, TFM=0, use_flash_attention=True,
             embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
INPUTS = ("image", "lidar", "radar", "gps")
B, LR, CLIP = 2, 1e-4, 1.0


def _copy(tree):
    return jax.tree_util.tree_map(lambda x: jnp.array(x), tree)


def _np(t):
    return t.detach().cpu().numpy()


# -- train-mode BatchNorm -----------------------------------------------------

def test_batchnorm_train_matches_flax():
    import flax.linen as nn
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6, 5, 4, 8)) * 3 + 1).astype(np.float32)
    mean = rng.uniform(-0.5, 0.5, 8).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    scale, bias = (rng.normal(size=8).astype(np.float32) for _ in range(2))
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                          "batch_stats": {"mean": mean, "var": var}},
                         jnp.asarray(x), mutable=["batch_stats"])
    port = resnet.BatchNorm(8).train()
    port.load_state_dict({"weight": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean),
                          "running_var": torch.from_numpy(var)})
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(_np(getattr(port, name)),
                                   np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-4, atol=1e-6)
    assert not port.running_var.requires_grad
    # bf16 input: statistics in f32, output back in bf16
    assert port(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


@pytest.fixture(scope="module")
def backbone_train():
    model = jax_resnet.ResNetBackbone((1, 1, 1, 1))
    x = np.random.default_rng(3).normal(size=(4, 64, 64, 2)).astype(
        np.float32)
    variables = randomized(jax.jit(model.init)(jax.random.PRNGKey(0),
                                               jnp.asarray(x)), 3)
    want, upd = jax.jit(lambda v, a: model.apply(
        v, a, train=True, mutable=["batch_stats"]))(variables, jnp.asarray(x))
    port = resnet.ResNetBackbone(2, (1, 1, 1, 1))
    port.load_state_dict(from_jax_variables(variables), strict=True)
    got = port.train()(torch.from_numpy(x))
    new_stats = from_jax_variables({"params": {}, "batch_stats":
                                    upd["batch_stats"]})
    return got, want, port, new_stats


def test_backbone_train_output_matches(backbone_train):
    got, want, _, _ = backbone_train
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_backbone_train_stats_match(backbone_train):
    _, _, port, new_stats = backbone_train
    buffers = dict(port.named_buffers())
    assert set(buffers) == set(new_stats) and len(buffers) == 2 * 12
    for name, want in new_stats.items():
        np.testing.assert_allclose(_np(buffers[name]), want.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


# -- losses, scheduler, metrics ----------------------------------------------

@pytest.mark.parametrize("loss", ["focal", "cross_entropy"])
@pytest.mark.parametrize("target", ["soft", "hard"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match(loss, target, weighted):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(6, 64)) * 3).astype(np.float32)
    tgt = (rng.uniform(size=(6, 64)).astype(np.float32) if target == "soft"
           else rng.integers(0, 64, 6).astype(np.int32))
    w = np.asarray([1, 1, 0, 1, 0, 1], np.float32) if weighted else None
    kw = dict(num_classes=64) if loss == "focal" else {}
    fn = f"{loss}_loss"
    want = getattr(jax_losses, fn)(
        jnp.asarray(logits), jnp.asarray(tgt), **kw,
        sample_weight=None if w is None else jnp.asarray(w))
    got = getattr(losses, fn)(
        torch.from_numpy(logits), torch.from_numpy(tgt), **kw,
        sample_weight=None if w is None else torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_scheduler_matches():
    got = [scheduler.reference_recipe_lr(e) for e in range(61)]
    want = [jax_scheduler.reference_recipe_lr(e) for e in range(61)]
    np.testing.assert_allclose(got, want, rtol=1e-12)
    kw = dict(base_lr=1e-3, init_decay_epochs=5, min_decay_lr=1e-5,
              restart_interval=3, restart_interval_multiplier=2.0)
    np.testing.assert_allclose(
        [scheduler.cyclic_cosine_decay_lr(e, **kw) for e in range(40)],
        [jax_scheduler.cyclic_cosine_decay_lr(e, **kw) for e in range(40)],
        rtol=1e-12)
    with pytest.raises(ValueError, match="warmup_start_lr"):
        scheduler.cyclic_cosine_decay_lr(0, 1e-3, 5, 1e-5, warmup_epochs=2)


def test_metrics_match():
    rng = np.random.default_rng(2)
    y_pred = np.argsort(-rng.normal(size=(50, 64)), axis=1)
    y_true = rng.integers(0, 64, 50)
    y_true[:10] = y_pred[:10, 0]
    np.testing.assert_array_equal(metrics.compute_acc(y_pred, y_true),
                                  jax_metrics.compute_acc(y_pred, y_true))
    assert metrics.compute_dba_score(y_pred, y_true) == pytest.approx(
        jax_metrics.compute_dba_score(y_pred, y_true), rel=1e-12)
    flat = metrics.flatten_multistep(y_pred.reshape(25, 2, 64),
                                     y_true.reshape(25, 2))
    for a, b in zip(flat, jax_metrics.flatten_multistep(
            y_pred.reshape(25, 2, 64), y_true.reshape(25, 2))):
        np.testing.assert_array_equal(a, b)


# -- whole train steps against JAX make_train_step --------------------------

def _batches(n, seed=20):
    return [make_synth_batch(GlobalConfig(**SMALL), B, seed=seed + i)
            for i in range(n)]


def _port_model(variables, **overrides):
    model = BeamFuser(GlobalConfig(**{**SMALL, **overrides}), device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _snapshot(state):
    return dict(
        params={n: p.detach().clone()
                for n, p in state.model.named_parameters()},
        ema={n: e.clone() for n, e in state.ema.items()},
        stats={n: b.clone() for n, b in state.model.named_buffers()})


def _jax_snapshot(jstate):
    return dict(
        params=from_jax_variables({"params": jstate.params}),
        ema=from_jax_variables({"params": jstate.ema_params}),
        stats=from_jax_variables({"params": {},
                                  "batch_stats": jstate.batch_stats}))


@pytest.fixture(scope="module")
def setup():
    jcfg = JaxConfig(**SMALL)
    jmodel = JaxBeamFuser(jcfg)
    batches = _batches(2)
    variables = randomized(jinit(jmodel, *(jnp.asarray(batches[0][k])
                                           for k in INPUTS)), 13)
    return jcfg, jmodel, batches, jax.device_get(variables)


@pytest.fixture(scope="module")
def trajectory(setup):
    """Two steps of each package from the same weights and batches, and the
    JAX gradient of the first step's loss."""
    jcfg, jmodel, batches, variables = setup
    tx = jax_state.make_optimizer()
    jstep = jax_steps.make_train_step(jmodel, jcfg, tx, use_ema=True,
                                      clip_grad_norm=CLIP)
    jstate = jax_state.create_train_state(_copy(variables), tx)

    def jloss(params, b):
        logits, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            *(b[k] for k in INPUTS), train=True, mutable=["batch_stats"])
        return jax_steps._compute_loss(jcfg, "focal", True, logits, b)

    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jgrads = jax.jit(jax.grad(jloss))(_copy(variables["params"]), jb)

    model = _port_model(variables)
    state = create_train_state(model)
    step = steps.make_train_step(model, GlobalConfig(**SMALL), state,
                                 use_ema=True, clip_grad_norm=CLIP,
                                 device="cpu")
    out = []
    for i, b in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           LR)
        m = step(b, LR)
        grads = ({n: p.grad.clone() for n, p in model.named_parameters()}
                 if i == 0 else None)
        out.append(dict(port=_snapshot(state), jax=_jax_snapshot(jstate),
                        loss=(float(m["loss"]), float(jm["loss"])),
                        ranks=(_np(m["ranks"]), np.asarray(jm["ranks"])),
                        grads=grads))
    out[0]["jax_grads"] = from_jax_variables(
        {"params": jax.device_get(jgrads)})
    return out, jstate, state, model


def _leafmax(x):
    return float(x.abs().max())


def _assert_envelope(got, want, tol, what):
    """Every element of every leaf within ``tol(name, want_leaf)``."""
    assert set(got) == set(want), what
    for name, w in want.items():
        err = (got[name] - w).abs()
        bound = tol(name, w)
        assert bool((err <= bound).all()), (
            f"{what} {name}: max err {float(err.max()):.3g} > {bound:.3g}")


# Tolerances of the comparison with JAX, and why.  The two packages agree
# to f32 rounding module by module (tests/test_torch_modules.py), but
# through the whole model their train-mode forwards differ by ~1e-5
# relative: BatchNorm's batch variance mean(x²) − mean(x)² cancels where
# |mean| > std, and the two frameworks sum in other orders.  Where a ReLU's
# input lies that close to 0 the two take different sides of the kink, and
# that token's whole contribution to a weight's gradient changes: measured
# 2.8e-3 of the gradient's norm over the model, 6e-3 of a leaf's at most.
GRAD_RTOL_MODEL, GRAD_RTOL_LEAF = 1e-2, 2e-2
# AdamW's first step moves an element by lr·g/(|g| + eps) ≈ lr·sign(g): an
# element whose gradient the two packages see with opposite signs moves 2·lr
# apart per step (the "envelope").  In the first step such elements are rare
# (measured 0.34% beyond 1% of lr), and the rest agree to rounding.
FLIP_SHARE = 0.01


def _params_envelope(n_steps):
    return lambda name, w: 2.02 * LR * n_steps + 1e-6 * _leafmax(w)


def _ema_envelope(n_steps):
    # ema_k = decay·ema_(k-1) + (1 − decay)·p_k, decay 0.999
    return lambda name, w: (1e-3 * 2.02 * LR * n_steps * (n_steps + 1) / 2
                            + 4e-7 * _leafmax(w))


def _stats_tol(rtol):
    return lambda name, w: rtol * _leafmax(w) + 1e-7


@pytest.mark.parametrize("i", [0, 1])
def test_step_loss_and_ranks_match(trajectory, i):
    """Step 0 starts from equal weights (loss measured 4.4e-6 apart); step 1
    from weights moved apart by step 0's sign flips (1.1e-4)."""
    rec = trajectory[0][i]
    loss, jloss = rec["loss"]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=(1e-5, 1e-3)[i])
    ranks, jranks = rec["ranks"]
    assert ranks.shape == (B, 64)
    np.testing.assert_array_equal(ranks[:, :3], jranks[:, :3])


def test_step_grads_match(trajectory):
    """The port's clipped gradients against the JAX gradient of the same
    loss, clipped the same way (min(1, c / (|g| + 1e-6))).  Leaves whose
    gradient is zero in exact arithmetic (the key biases: softmax ignores a
    shift shared by all keys) hold rounding noise in both packages and are
    held to 1e-6 of the largest gradient element."""
    rec = trajectory[0][0]
    jg = rec["jax_grads"]
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in jg.values())))
    scale = min(1.0, CLIP / (norm + 1e-6))
    assert scale < 1.0                    # the clip is exercised
    jg = {n: g * scale for n, g in jg.items()}
    got = rec["grads"]
    assert set(got) == set(jg)
    top = max(_leafmax(g) for g in jg.values())
    diff = float(torch.sqrt(sum(((got[n] - jg[n]).double() ** 2).sum()
                                for n in jg)))
    assert diff <= GRAD_RTOL_MODEL * norm * scale
    for n, g in jg.items():
        if _leafmax(g) <= 1e-6 * top:
            assert _leafmax(got[n]) <= 1e-6 * top, n
        else:
            assert float((got[n] - g).norm()) <= GRAD_RTOL_LEAF * float(
                g.norm()), n


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("what", ["params", "ema"])
def test_step_params_and_ema_match(trajectory, i, what):
    rec = trajectory[0][i]
    got, want = rec["port"][what], rec["jax"][what]
    envelope = (_params_envelope if what == "params" else _ema_envelope)(i + 1)
    _assert_envelope(got, want, envelope, what)
    if what == "params" and i == 0:
        off = sum(int(((got[n] - w).abs() > 0.01 * LR + 1e-6 * _leafmax(w))
                      .sum()) for n, w in want.items())
        assert off <= FLIP_SHARE * sum(w.numel() for w in want.values())


@pytest.mark.parametrize("i", [0, 1])
def test_step_batch_stats_match(trajectory, i):
    """Step 0 measured 1.5e-5 of a leaf's largest statistic; step 1 runs on
    the weights step 0 moved apart (2.1e-4)."""
    rec = trajectory[0][i]
    _assert_envelope(rec["port"]["stats"], rec["jax"]["stats"],
                     _stats_tol((1e-4, 2e-3)[i]), "batch_stats")


def test_eval_step_with_ema_matches(trajectory, setup):
    jcfg, jmodel, _, _ = setup
    _, jstate, state, model = trajectory
    b = make_synth_batch(GlobalConfig(**SMALL), B, seed=40)
    want = jax_steps.make_eval_step(jmodel, jcfg, use_ema=True)(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = steps.make_eval_step(model, GlobalConfig(**SMALL), state,
                               use_ema=True, device="cpu")(b)
    np.testing.assert_allclose(_np(got["confidence"]),
                               np.asarray(want["confidence"]), rtol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(_np(got["ranks"])[:, :3],
                                  np.asarray(want["ranks"])[:, :3])
    # the EMA weights were applied for the call only
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n])
    assert not model.training


def test_grad_accum_step_matches(setup):
    jcfg, jmodel, batches, variables = setup
    tx = jax_state.make_optimizer()
    jstep = jax_steps.make_train_step(jmodel, jcfg, tx, use_ema=True,
                                      grad_accum=2)
    jstate, jm = jstep(jax_state.create_train_state(_copy(variables), tx),
                       {k: jnp.asarray(v) for k, v in batches[0].items()},
                       LR)
    model = _port_model(variables)
    state = create_train_state(model)
    m = steps.make_train_step(model, GlobalConfig(**SMALL), state,
                              use_ema=True, grad_accum=2, device="cpu")(
        batches[0], LR)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(_np(m["ranks"])[:, :3],
                                  np.asarray(jm["ranks"])[:, :3])
    want, got = _jax_snapshot(jstate), _snapshot(state)
    _assert_envelope(got["params"], want["params"], _params_envelope(1),
                     "params")
    _assert_envelope(got["stats"], want["stats"], _stats_tol(1e-4),
                     "batch_stats")


# -- dropout on, the port alone ----------------------------------------------

def _dropout_run(variables, batch, rng_seed, use_flash=True):
    model = _port_model(variables, embd_pdrop=0.1, attn_pdrop=0.1,
                        resid_pdrop=0.1, use_flash_attention=use_flash)
    state = create_train_state(model)
    step = steps.make_train_step(model, model.config, state,
                                 rng_seed=rng_seed, device="cpu")
    loss = float(step(batch, LR)["loss"])
    return loss, {n: p.grad.clone() for n, p in model.named_parameters()}


def test_dropout_step_is_reproducible(setup):
    _, _, batches, variables = setup
    a, ga = _dropout_run(variables, batches[0], 5)
    b, gb = _dropout_run(variables, batches[0], 5)
    c, _ = _dropout_run(variables, batches[0], 6)
    assert np.isfinite(a) and a == b and a != c
    assert all(torch.equal(ga[n], gb[n]) for n in ga)


def test_dropout_flash_and_plain_paths_agree(setup):
    """Both attention paths draw the same hash mask from the same seed, and
    the elementwise dropout draws the same generator stream: they differ
    only in rounding."""
    _, _, batches, variables = setup
    a, ga = _dropout_run(variables, batches[0], 5, use_flash=True)
    b, gb = _dropout_run(variables, batches[0], 5, use_flash=False)
    assert a == pytest.approx(b, rel=1e-5)
    top = max(float(g.abs().max()) for g in gb.values())
    for n in ga:
        torch.testing.assert_close(ga[n], gb[n], rtol=0, atol=1e-4 * float(
            gb[n].abs().max()) + 1e-6 * top, msg=n)


def test_train_mode_needs_the_generators(setup):
    _, _, batches, variables = setup
    model = _port_model(variables, attn_pdrop=0.1).train()
    x = [torch.from_numpy(batches[0][k]) for k in INPUTS]
    with pytest.raises(ValueError, match="seed_generator"):
        model(*x, dropout_generator=torch.Generator())
    model.eval()(*x)                              # eval draws nothing


# -- what the step does not take, and the device rules ------------------------

def test_step_refuses_what_it_does_not_take(setup):
    _, _, batches, variables = setup
    model = _port_model(variables)
    state = create_train_state(model)
    with pytest.raises(ValueError, match="state"):
        steps.make_train_step(_port_model(variables), model.config, state,
                              device="cpu")
    with pytest.raises(NotImplementedError, match="TPU"):
        steps.make_train_step(model, model.config.replace(
            opt_mu_dtype="bfloat16"), state, device="cpu")
    with pytest.raises(NotImplementedError, match="TPU"):
        make_optimizer(model, flatten=True)
    step = steps.make_train_step(model, model.config, state, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        step({**batches[0], "valid": np.ones(B, np.float32)}, LR)
    with pytest.raises(ValueError, match="split evenly"):
        steps.make_train_step(model, model.config, state, grad_accum=3,
                              device="cpu")(batches[0], LR)


def test_entry_points_default_to_cuda():
    for fn in (steps.make_train_step, steps.make_eval_step):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_entry_points_raise_without_cuda(monkeypatch, setup):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, variables = setup
    model = _port_model(variables)
    state = create_train_state(model)
    for fn in (steps.make_train_step, steps.make_eval_step):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(model, model.config, state)
    with pytest.raises(RuntimeError, match="CUDA"):
        steps.main(["--batch", "1", "--steps", "1"])
