"""The port's MambaFuser (FFM=1, TFM=1) against the JAX package on the same
weights, on the CPU: each Mamba module, then the whole model and Predictor
at the small geometry; plus the port's seeded init, the weight bridge for
the Mamba leaves and the full-width parameter count.

Weights cross with models/weights.py::from_jax_variables; inputs are numpy
arrays from a seed given to both packages.  Tolerances: rtol 1e-4 per
module with an atol of 1e-4 times the output's scale (the frameworks sum
matmuls, convolutions and the scan in other orders); whole-model logits
2e-3, the bound of tests/test_encoder_oracle.py:562.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu.models import fusion as jax_fusion
from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
from deepsense6g_tii_tpu.ops import mamba as jax_mamba
from deepsense6g_tii_tpu.serve import Predictor as JaxPredictor
from deepsense6g_tii_tpu_torch import serve
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.models import fusion
from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
from deepsense6g_tii_tpu_torch.ops import mamba
from deepsense6g_tii_tpu_torch.serve import Predictor, mambafuser_config
from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch
from synthetic_data import jinit
from test_torch_modules import assert_close, port_module, randomized
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

# the small geometry of tests/test_torch_slice.py:36-38, Mamba fusion and
# the TimeMamba head: 26 tokens, channel thirds 21/21/22 at C = 64
SMALL = dict(seq_len=2, n_layer=2, vert_anchors=2, horz_anchors=2,
             input_resolution=64, crop=64, backbone_blocks=(1, 1, 1, 1),
             compute_dtype="float32", FFM=1, TFM=1)
TOL = 2e-3


def perturbed(variables, seed, rel=0.3):
    """Init-scale perturbation of a whole model's variables: each leaf
    moves by noise of ``rel`` times its own spread (0.05 for a constant
    leaf), with BN statistics as in ``randomized``.  The MambaBlock has no
    residual path and TimeMamba sees unnormalised tracks, so the absolute
    noise of ``randomized`` drives the small MambaFuser's logits to ~1e9,
    where a 2e-3 bound says nothing; here they stay O(1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
        spread = float(x.std()) if x.size > 1 else 0.0
        scale = rel * spread if spread > 0 else 0.05
        return x + rng.normal(scale=scale, size=x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(variables))


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _init(model, seed, *inputs):
    variables = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                    *map(jnp.asarray, inputs))
    return randomized(variables, seed)


# -- Mamba layer ----------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
def test_causal_depthwise_conv1d_matches(reverse):
    x, w, bias = _normal(1, 2, 30, 16), _normal(2, 4, 1, 16), _normal(3, 16)
    want = jax_mamba.causal_depthwise_conv1d(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), reverse=reverse)
    got = mamba.causal_depthwise_conv1d(
        torch.from_numpy(x), torch.from_numpy(w.transpose(2, 1, 0).copy()),
        torch.from_numpy(bias), reverse=reverse)
    assert got.is_contiguous() and got.shape == (2, 30, 16)
    assert_close(got, want)


@pytest.mark.parametrize("init_style,reverse", [
    ("mamba_ssm", False), ("gpt2", False), ("mamba_ssm", True),
    ("gpt2", True)])
def test_mamba_matches(init_style, reverse):
    x = _normal(4, 2, 26, 32)
    model = jax_mamba.Mamba(d_model=32, init_style=init_style,
                            reverse=reverse)
    variables = _init(model, 4, x)
    want = model.apply(variables, jnp.asarray(x))
    port = port_module(mamba.Mamba(32, init_style=init_style,
                                   reverse=reverse), variables)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_close(got, want)


@pytest.mark.parametrize("init_style", ["mamba_ssm", "gpt2"])
def test_mamba_seeded_init_follows_jax(init_style):
    d_model, d_state = 48, 16
    jax_params = jax_mamba.Mamba(d_model=d_model, init_style=init_style).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, d_model)))["params"]
    port = mamba.Mamba(d_model, init_style=init_style)
    port.init_ssm(torch.Generator().manual_seed(0))
    p = {k: v.detach().numpy() for k, v in port.named_parameters()}
    for key in ("A_log", "D", "conv1d_bias"):
        np.testing.assert_allclose(p[key], np.asarray(jax_params[key]),
                                   rtol=1e-6, atol=0)
    rank = math.ceil(d_model / 16)
    w, b = p["dt_proj_weight"], p["dt_proj_bias"]
    assert w.shape == jax_params["dt_proj_weight"].shape == (rank, 96)
    if init_style == "gpt2":
        assert not b.any() and 0.01 < w.std() < 0.03
    else:
        assert np.abs(w).max() <= rank ** -0.5
        dt = np.log1p(np.exp(b))                      # softplus(bias)
        assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)
        want_dt = np.log1p(np.exp(np.asarray(jax_params["dt_proj_bias"])))
        assert want_dt.min() >= 1e-3 * (1 - 1e-5)
    # conv weight N(0, 1/d_conv), the fan-in of flax's (K, 1, d) kernel
    assert 0.4 < p["conv1d_weight"].std() < 0.6


# -- MambaBlock, TokenFusion(mamba), TimeMamba ---------------------------------

@pytest.mark.parametrize("reverse_kernel", [False, True])
def test_mamba_block_matches(reverse_kernel):
    x = _normal(5, 2, 26, 32)
    model = jax_fusion.MambaBlock(32, 26, reverse_kernel=reverse_kernel)
    variables = _init(model, 5, x)
    want = model.apply(variables, jnp.asarray(x))
    port = port_module(fusion.MambaBlock(32, 26,
                                         reverse_kernel=reverse_kernel),
                       variables)
    with torch.no_grad():
        assert_close(port(torch.from_numpy(x)), want)


@pytest.fixture(scope="module")
def mamba_token_fusion():
    C, T, A = 64, 2, 2
    model = jax_fusion.TokenFusion(
        n_embd=C, n_layer=2, seq_len=T, n_views=1, anchors=A * A,
        gps_tokens=2, embd_pdrop=0.0, fusion_type="mamba", channel_swap=True)
    inputs = [_normal(6 + i, 2, T, A, A, C) for i in range(3)]
    inputs.append(_normal(9, 2, 2, C))
    variables = _init(model, 6, *inputs)
    want = model.apply(variables, *map(jnp.asarray, inputs))
    port = port_module(fusion.TokenFusion(C, 2, model.n_tokens,
                                          fusion_type="mamba",
                                          channel_swap=True), variables)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, inputs))
    return got, want


@pytest.mark.parametrize("stream", ["image", "lidar", "radar", "gps"])
def test_token_fusion_mamba_matches(mamba_token_fusion, stream):
    got, want = mamba_token_fusion
    i = ("image", "lidar", "radar", "gps").index(stream)
    assert tuple(got[i].shape) == want[i].shape
    assert_close(got[i], want[i])


def test_time_mamba_matches():
    tracks = [_normal(10 + i, 2, 3, 64) for i in range(3)]
    gps = _normal(13, 2, 2, 64)
    model = jax_fusion.TimeMamba(d_model=64, seq_len=3, gps_tokens=2)
    variables = _init(model, 7, *tracks, gps)
    want = model.apply(variables, *map(jnp.asarray, tracks + [gps]))
    port = port_module(fusion.TimeMamba(64, 3, 2), variables)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, tracks + [gps]))
    assert got.shape == (2, 64)
    assert_close(got, want)


# -- the whole MambaFuser --------------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    b = make_synth_batch(GlobalConfig(**SMALL), 3, seed=21,
                         with_labels=False)
    return tuple(b[k] for k in ("image", "lidar", "radar", "gps"))


@pytest.fixture(scope="module")
def jax_variables(inputs):
    model = JaxBeamFuser(JaxConfig(**SMALL))
    return perturbed(jinit(model, *map(jnp.asarray, inputs)), 22)


def port_model(jax_variables, **knobs):
    model = BeamFuser(GlobalConfig(**{**SMALL, **knobs}), device="cpu")
    model.load_state_dict(from_jax_variables(jax_variables), strict=True)
    return model


def jax_logits(variables, inputs, **knobs):
    model = JaxBeamFuser(JaxConfig(**{**SMALL, **knobs}))
    return np.asarray(jax.jit(lambda v, *a: model.apply(v, *a, train=False))(
        variables, *map(jnp.asarray, inputs)))


@pytest.fixture(scope="module")
def port_logits(jax_variables, inputs):
    with torch.no_grad():
        return port_model(jax_variables)(
            *map(torch.from_numpy, inputs)).numpy()


def test_eval_logits_match_jax(jax_variables, inputs, port_logits):
    want = jax_logits(jax_variables, inputs)
    assert port_logits.shape == want.shape == (3, 64)
    assert 0.5 < np.abs(want).max() < 100
    np.testing.assert_allclose(port_logits, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("knob", [dict(reverse_scan_kernel=True),
                                  dict(use_pallas_scan=False)])
def test_scan_switches_keep_the_logits(jax_variables, inputs, port_logits,
                                       knob):
    """The reverse-direction backward branch and the plain-scan switch are
    the same math as the default path (the kernel switch only matters for
    CUDA tensors)."""
    with torch.no_grad():
        got = port_model(jax_variables, **knob)(
            *map(torch.from_numpy, inputs)).numpy()
    np.testing.assert_allclose(got, port_logits, rtol=1e-5, atol=1e-5)


def test_predictor_matches_jax_on_ragged_batch(jax_variables, inputs,
                                               port_logits):
    jax_pred = JaxPredictor(jax_variables, JaxConfig(**SMALL),
                            batch_buckets=(1, 4))
    pred = Predictor(port_model(jax_variables), GlobalConfig(**SMALL),
                     batch_buckets=(1, 4), device="cpu")
    want_idx, want_conf = jax_pred.predict(*inputs)       # 3 rows -> bucket 4
    idx, conf = pred.predict(*inputs)
    assert idx.shape == (3, 3) and conf.shape == (3,)
    assert idx.min() >= 1 and idx.max() <= 64
    np.testing.assert_allclose(conf, want_conf, rtol=TOL, atol=TOL)
    # top-k indices agree wherever the probabilities are separated by more
    # than the tolerance
    probs = torch.softmax(torch.from_numpy(port_logits), -1).numpy()
    for row in range(3):
        p = np.sort(probs[row])[::-1]
        for j in range(3):
            if p[j] - p[j + 1] > TOL and (j == 0 or p[j - 1] - p[j] > TOL):
                assert idx[row, j] == want_idx[row, j]
    # padding to the bucket leaves the rows as they are
    idx1, conf1 = pred.predict(*(x[1:2] for x in inputs))
    np.testing.assert_array_equal(idx1[0], idx[1])
    np.testing.assert_allclose(conf1[0], conf[1], rtol=1e-5, atol=1e-6)


def test_missing_image_zerolike_matches_jax(jax_variables, inputs):
    knobs = dict(modality_missing="image", modality_missing_type="zerolike")
    want = jax_logits(jax_variables, inputs, **knobs)
    with torch.no_grad():
        got = port_model(jax_variables, **knobs)(
            *map(torch.from_numpy, inputs)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_missing_randlike_draws_from_the_callers_generator(jax_variables,
                                                           inputs):
    model = port_model(jax_variables, modality_missing="lidar_radar",
                       modality_missing_type="randlike")
    x = tuple(map(torch.from_numpy, inputs))
    with pytest.raises(ValueError, match="generator"):
        model(*x)
    with torch.no_grad():
        a, b, c = (model(*x, generator=torch.Generator().manual_seed(s))
                   for s in (1, 1, 2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


# -- weights, init, width, serving entry point -----------------------------------

def test_from_jax_variables_loads_strict(jax_variables):
    sd = from_jax_variables(jax_variables)
    model = BeamFuser(GlobalConfig(**SMALL), device="cpu")
    assert set(sd) == set(model.state_dict())
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    blk = jax_variables["params"]["encoder"]["fusion1"]["block0"]
    np.testing.assert_array_equal(
        model.encoder.fusion1.block0.forward_mamba.conv1d_weight.detach()
        .numpy(),
        np.asarray(blk["forward_mamba"]["conv1d_weight"]).transpose(2, 1, 0))
    assert model.encoder.fusion1.block0.ln1.weight.shape == (26, 64)


def test_from_jax_variables_rejects_unknown_leaf(jax_variables):
    enc = dict(jax_variables["params"]["encoder"])
    enc["time_mamba"] = {**enc["time_mamba"], "dt_scale": np.ones(3)}
    params = {**jax_variables["params"], "encoder": enc}
    with pytest.raises(KeyError, match="dt_scale"):
        from_jax_variables({**jax_variables, "params": params})


def test_seeded_init_is_reproducible():
    cfg = GlobalConfig(**SMALL)
    a, b = (BeamFuser(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(3)).state_dict()
            for _ in range(2))
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    fm = "encoder.fusion1.block0.forward_mamba."
    assert not a[fm + "dt_proj_bias"].any()                  # gpt2 style
    assert a["encoder.time_mamba.mamba.dt_proj_bias"].min() < -2  # mamba_ssm
    assert abs(a[fm + "in_proj.weight"].std().item() - 0.02) < 0.002


def test_full_width_parameter_count():
    """MambaFuser I+L+R+G = 103,461,924 parameters (README_mine.md Table I;
    tests/test_models.py:220-228)."""
    model = BeamFuser(mambafuser_config(), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 103_461_924


def test_serve_main_defaults_to_mambafuser(monkeypatch):
    built = []

    class Stop(Exception):
        pass

    def fake_load_predictor(path, cfg, **kw):
        assert path == "best_model.pt" and kw["device"].type == "cuda"
        built.append(cfg)
        raise Stop

    # main serves a checkpoint on the card: the model's config as main
    # builds it there, before any file is read
    monkeypatch.setattr(serve, "resolve_device", torch.device)
    monkeypatch.setattr(serve, "load_predictor", fake_load_predictor)
    for argv in (["best_model.pt"],
                 ["best_model.pt", "--FFM", "0", "--TFM", "0"]):
        with pytest.raises(Stop):
            serve.main(argv)
    mf, gpt = built
    assert (mf.FFM, mf.TFM, gpt.FFM, gpt.TFM) == (1, 1, 0, 0)
    assert mf == mambafuser_config() and mf.use_pallas_scan
    assert mf.compute_dtype == gpt.compute_dtype == "bfloat16"
    assert gpt.use_flash_attention and mf.n_tokens == 962
