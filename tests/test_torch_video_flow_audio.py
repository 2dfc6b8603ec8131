"""The port's video/flow/audio SimMMDG trainer
(deepsense6g_tii_tpu_torch/rebuild/video_flow_audio.py) against the JAX
package's, at tiny widths in f32 on the CPU: the three losses, and one
Adam step (losses, logits, parameters) and the eval step from the same
weights."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.rebuild import video_flow_audio as jvfa
from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
from deepsense6g_tii_tpu_torch.rebuild import video_flow_audio as vfa
from test_torch_modules import randomized
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

TINY = dict(emd_dims=(32, 24, 16), hidden_dim=16, trans_hidden=16,
            proj_dim=8, n_classes=4)
FEAT_DIMS = (10, 12, 6)
MODALITIES = ("video", "flow", "audio")
B, LR = 8, 1e-3


def _inputs(seed):
    rng = np.random.default_rng(seed)
    feats = {m: rng.normal(size=(B, d)).astype(np.float32)
             for m, d in zip(MODALITIES, FEAT_DIMS)}
    return feats, rng.integers(0, 4, size=(B,)).astype(np.int32)


def test_supcon_matches_jax():
    rng = np.random.default_rng(1)
    f = rng.normal(size=(6, 3, 8)).astype(np.float32)
    lab = rng.integers(0, 3, size=(6,))
    want = float(jvfa.supcon_loss(jnp.asarray(f), jnp.asarray(lab), 0.1))
    got = vfa.supcon_loss(torch.from_numpy(f), torch.from_numpy(lab), 0.1)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize("name", ["normalized_translation", "feature_split"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=(5, 10)).astype(np.float32) for _ in range(2))
    args = (a, b) if name == "normalized_translation" else (a,)
    fn = f"{name}_loss"
    want = float(getattr(jvfa, fn)(*map(jnp.asarray, args)))
    got = float(getattr(vfa, fn)(*map(torch.from_numpy, args)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.fixture(scope="module")
def stepped():
    """One train step of each package from the same (perturbed) weights."""
    feats, labels = _inputs(3)
    jt = jvfa.VFATrainer(jvfa.VFAOptions(lr=LR, **TINY))
    jf = {m: jnp.asarray(x) for m, x in feats.items()}
    jstate = jax.jit(jt.init_state)(jf)
    params = randomized({"params": jstate.params}, 4)["params"]
    jstate = jstate.replace(params=params, opt_state=jt.tx.init(params))
    jlabels = jnp.asarray(labels)
    jstate2, jaux = jt.train_step.lower(jstate, jf, jlabels).compile(
        compiler_options={"xla_backend_optimization_level": 0})(
        jstate, jf, jlabels)
    trainer = vfa.VFATrainer(vfa.VFAOptions(lr=LR, **TINY), device="cpu")
    heads = trainer.init_state(feats)
    heads.load_state_dict(from_jax_variables({"params": params}),
                          strict=True)
    aux = trainer.train_step(feats, labels)
    return dict(jt=jt, jstate=jstate2, jaux=jaux, trainer=trainer, aux=aux,
                feats=feats, labels=labels)


def test_train_step_matches_jax(stepped):
    aux, jaux = stepped["aux"], stepped["jaux"]
    for k in ("loss", "ce", "trans", "contrast", "split"):
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(aux["logits"].numpy(),
                               np.asarray(jaux["logits"]), rtol=1e-5,
                               atol=1e-6)
    want = from_jax_variables({"params": jax.device_get(
        stepped["jstate"].params)})
    got = dict(stepped["trainer"].heads.named_parameters())
    assert set(got) == set(want)
    # Adam's first step moves each element by ~lr·sign(g + 1e-4·p): where
    # the gradient and the L2 term cancel to rounding level the two
    # packages may see opposite signs, 2·lr apart (measured: 2 elements of
    # ~50k beyond 1e-6); the rest agree to f32 rounding
    off = 0
    for n, w in want.items():
        err = (got[n].detach() - w).abs()
        assert float(err.max()) <= 2.02 * LR, n
        off += int((err > 1e-6).sum())
    assert off <= 1e-4 * sum(w.numel() for w in want.values())
    assert stepped["trainer"].step == 1


def test_eval_step_matches_jax(stepped):
    feats = stepped["feats"]
    want = np.asarray(stepped["jt"].eval_step(
        stepped["jstate"], {m: jnp.asarray(x) for m, x in feats.items()}))
    got = stepped["trainer"].eval_step(feats).numpy()
    np.testing.assert_array_equal(got, want)


def test_modality_pair_trains():
    """Two of the three modalities (--use_video/--use_flow/--use_audio)."""
    feats, labels = _inputs(5)
    trainer = vfa.VFATrainer(vfa.VFAOptions(
        modalities=("video", "audio"), emd_dims=(32, 16), hidden_dim=16,
        trans_hidden=16, proj_dim=8, n_classes=4), device="cpu")
    heads = trainer.init_state({m: feats[m] for m in ("video", "audio")})
    assert {n.split(".")[0] for n, _ in heads.named_parameters()} == {
        "video_emd", "audio_emd", "video_proj", "audio_proj", "mlp_cls",
        "mlp_video2audio", "mlp_audio2video"}
    aux = trainer.train_step({m: feats[m] for m in ("video", "audio")},
                             labels)
    assert np.isfinite(float(aux["loss"]))


def test_defaults_to_cuda_and_raises_without_it(monkeypatch):
    assert inspect.signature(vfa.VFATrainer).parameters[
        "device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vfa.VFATrainer()
