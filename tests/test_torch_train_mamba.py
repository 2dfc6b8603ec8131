"""Two whole MambaFuser (FFM=1, TFM=1) train steps of the port
(deepsense6g_tii_tpu_torch/train/steps.py) against the JAX package's
``make_train_step`` on the same perturbed weights and batches, at the small
test geometry in f32 on the CPU, dropout 0: forward in train mode, focal
loss, backward through the selective scan's plain forward and backward
(the kernels' plain versions), clip, AdamW, EMA.  On the CPU the JAX step
takes ``selective_scan_ref``; the Pallas backward kernels are held at the
op level (tests/test_torch_selective_scan.py).

The weights are the port's seeded init carried into the JAX variable tree
(the inverse of ``from_jax_variables``, leaf by leaf, on the shapes of
``jax.eval_shape`` of the JAX init), then perturbed as in
tests/test_torch_mambafuser.py; the JAX step's clipped gradient is read
from AdamW's first moment after its first step (mu = (1 - b1)·g, b1 =
0.9).  So the JAX side compiles two programs: its train state, and its
train step once for both steps, with XLA's backend optimisation off (the
compile dominates these tests' time; the step's numbers move by ~1e-7).
Tolerances are the GPT step's (tests/test_torch_train.py), and ranks are
held where the logits are apart by more than LOGIT_GAP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
from deepsense6g_tii_tpu.train import state as jax_state
from deepsense6g_tii_tpu.train import steps as jax_steps
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
from deepsense6g_tii_tpu_torch.train import steps
from deepsense6g_tii_tpu_torch.train.state import create_train_state
from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch
from test_torch_mambafuser import SMALL as MAMBA_SMALL
from test_torch_mambafuser import perturbed
from test_torch_train import (FLIP_SHARE, GRAD_RTOL_LEAF,
                              GRAD_RTOL_MODEL, LR, B, _assert_envelope,
                              _copy, _ema_envelope, _jax_snapshot, _leafmax,
                              _np, _params_envelope, _snapshot, _stats_tol)
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

SMALL = dict(MAMBA_SMALL, embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
INPUTS = ("image", "lidar", "radar", "gps")
ADAM_B1 = 0.9
# the small MambaFuser's gradient norm is ~0.3: a clip at 0.1 is exercised
CLIP = 0.1
# ranks are compared where neighbouring logits are further apart than this
# share of the largest |logit|: the loss agrees to 1e-5 in step 0 and 1e-3
# in step 1, after step 0's AdamW sign flips moved the weights apart
LOGIT_GAP = (1e-4, 1e-2)


def _to_jax_leaf(key, arr):
    """The inverse of models/weights.py::_leaf for a parameter."""
    if key == "kernel":
        return arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
    if key == "conv1d_weight":
        return arr.transpose(2, 1, 0)
    return arr


def _port_init_as_jax(jmodel, inputs, seed):
    """The port's seeded init as a JAX variable tree of numpy arrays."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                *inputs))
    sd = BeamFuser(GlobalConfig(**SMALL), device="cpu",
                   generator=torch.Generator().manual_seed(seed)).state_dict()
    stats = {"mean": "running_mean", "var": "running_var"}

    def leaf(path, shape):
        keys = [p.key for p in path]
        coll, prefix, key = keys[0], ".".join(keys[1:-1]), keys[-1]
        name = (stats[key] if coll == "batch_stats"
                else "weight" if key in ("kernel", "scale") else key)
        arr = sd[f"{prefix}.{name}"].numpy()
        arr = arr if coll == "batch_stats" else _to_jax_leaf(key, arr)
        assert arr.shape == shape.shape, (keys, arr.shape, shape.shape)
        return np.ascontiguousarray(arr)

    return jax.tree_util.tree_map_with_path(leaf, dict(shapes))


def _port_model(variables, **overrides):
    model = BeamFuser(GlobalConfig(**{**SMALL, **overrides}), device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def _adam_mu(opt_state):
    """AdamW's first moment in an optax state tree."""
    found = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(x, "mu")]
    assert len(found) == 1
    return found[0].mu


@pytest.fixture(scope="module")
def setup():
    batches = [make_synth_batch(GlobalConfig(**SMALL), B, seed=30 + i)
               for i in range(2)]
    jmodel = JaxBeamFuser(JaxConfig(**SMALL))
    variables = perturbed(_port_init_as_jax(
        jmodel, [jnp.asarray(batches[0][k]) for k in INPUTS], 30), 31)
    return jmodel, batches, variables


@pytest.fixture(scope="module")
def trajectory(setup):
    """Two steps of each package from the same weights and batches, and
    the JAX step's first clipped gradient."""
    jmodel, batches, variables = setup
    jcfg = JaxConfig(**SMALL)
    tx = jax_state.make_optimizer()
    jstate = jax.jit(lambda v: jax_state.create_train_state(v, tx))(
        _copy(variables))
    jbatches = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    jstep = jax_steps.make_train_step(
        jmodel, jcfg, tx, use_ema=True, clip_grad_norm=CLIP).lower(
        jstate, jbatches[0], LR).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    model = _port_model(variables)
    logits = []
    model.register_forward_hook(lambda mod, a, out: logits.append(
        out.detach()))
    state = create_train_state(model)
    step = steps.make_train_step(model, GlobalConfig(**SMALL), state,
                                 use_ema=True, clip_grad_norm=CLIP,
                                 device="cpu")
    out = []
    for i, (b, jb) in enumerate(zip(batches, jbatches)):
        jstate, jm = jstep(jstate, jb, LR)
        m = step(b, LR)
        rec = dict(port=_snapshot(state), jax=_jax_snapshot(jstate),
                   loss=(float(m["loss"]), float(jm["loss"])),
                   ranks=(_np(m["ranks"]), np.asarray(jm["ranks"])),
                   logits=_np(logits[-1]))
        if i == 0:
            rec["grads"] = {n: p.grad.clone()
                            for n, p in model.named_parameters()}
            mu = jax.device_get(_adam_mu(jstate.opt_state))
            rec["jax_grads"] = from_jax_variables({
                "params": jax.tree_util.tree_map(
                    lambda x: np.asarray(x) / (1 - ADAM_B1), mu)})
        out.append(rec)
    return out


@pytest.mark.parametrize("i", [0, 1])
def test_step_loss_and_ranks_match(trajectory, i):
    rec = trajectory[i]
    loss, jloss = rec["loss"]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jloss, rtol=(1e-5, 1e-3)[i])
    ranks, jranks = rec["ranks"]
    assert ranks.shape == (B, 64)
    logits = rec["logits"]
    gap = LOGIT_GAP[i] * np.abs(logits).max()
    checked = 0
    for row in range(B):
        top = np.sort(logits[row])[::-1]
        for j in range(3):
            if top[j] - top[j + 1] > gap and (j == 0
                                              or top[j - 1] - top[j] > gap):
                assert ranks[row, j] == jranks[row, j], (row, j)
                checked += 1
    assert checked >= B          # the top-1 of every row at least


def test_step_grads_match(trajectory):
    """The port's clipped gradients against the JAX step's, held as a whole
    to GRAD_RTOL_MODEL of their norm and leaf by leaf to GRAD_RTOL_LEAF of
    the leaf's norm (a leaf that is zero in JAX to 1e-6 of the largest
    gradient element)."""
    got, jg = trajectory[0]["grads"], trajectory[0]["jax_grads"]
    assert set(got) == set(jg)
    norm = float(torch.sqrt(sum((g.double() ** 2).sum() for g in jg.values())))
    assert norm == pytest.approx(CLIP, rel=1e-4)      # clipped
    top = max(_leafmax(g) for g in jg.values())
    diff = float(torch.sqrt(sum(((got[n] - jg[n]).double() ** 2).sum()
                                for n in jg)))
    assert diff <= GRAD_RTOL_MODEL * norm
    for n, g in jg.items():
        if _leafmax(g) <= 1e-6 * top:
            assert _leafmax(got[n]) <= 1e-6 * top, n
        else:
            assert float((got[n] - g).norm()) <= GRAD_RTOL_LEAF * float(
                g.norm()), n


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("what", ["params", "ema"])
def test_step_params_and_ema_match(trajectory, i, what):
    rec = trajectory[i]
    got, want = rec["port"][what], rec["jax"][what]
    envelope = (_params_envelope if what == "params" else _ema_envelope)(i + 1)
    _assert_envelope(got, want, envelope, what)
    if what == "params" and i == 0:
        off = sum(int(((got[n] - w).abs() > 0.01 * LR + 1e-6 * _leafmax(w))
                      .sum()) for n, w in want.items())
        assert off <= FLIP_SHARE * sum(w.numel() for w in want.values())


@pytest.mark.parametrize("i", [0, 1])
def test_step_batch_stats_match(trajectory, i):
    rec = trajectory[i]
    _assert_envelope(rec["port"]["stats"], rec["jax"]["stats"],
                     _stats_tol((1e-4, 2e-3)[i]), "batch_stats")


def test_reverse_scan_kernel_step_equals_flip_path(setup, trajectory):
    """reverse_scan_kernel runs each MambaBlock's backward branch as a
    reverse scan over the natural-order stream: the same parameters and
    math as the flip path, so one port step gives the same loss, gradients
    and new statistics as the trajectory's first step (the port's
    counterpart of tests/test_ops.py:200-214; bounds of that test)."""
    _, batches, variables = setup
    model = _port_model(variables, reverse_scan_kernel=True)
    state = create_train_state(model)
    step = steps.make_train_step(model, model.config, state, use_ema=True,
                                 clip_grad_norm=CLIP, device="cpu")
    loss = float(step(batches[0], LR)["loss"])
    flip = trajectory[0]
    assert loss == pytest.approx(flip["loss"][0], rel=1e-5)
    for n, g in flip["grads"].items():
        scale = max(_leafmax(g), 1e-6)
        torch.testing.assert_close(model.get_parameter(n).grad / scale,
                                   g / scale, rtol=1e-4, atol=1e-5, msg=n)
    for n, s in flip["port"]["stats"].items():
        torch.testing.assert_close(model.get_buffer(n), s, rtol=1e-5,
                                   atol=1e-6, msg=n)
