"""Each module of the PyTorch port against its JAX counterpart, on the same
weights (carried across with models/weights.py::from_jax_variables) and the
same numpy inputs, in f32 on the CPU.  Where the JAX module reaches the
Pallas flash kernel, it runs in interpret mode, as the JAX package's own
tests run it.

Tolerances: rtol 1e-4 per module, with an atol of 1e-4 times the output's
scale — the two frameworks sum convolutions and matmuls in other orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu import config as jax_config
from deepsense6g_tii_tpu.data.features import \
    normalize_imagenet as jax_normalize
from deepsense6g_tii_tpu.models import fusion as jax_fusion
from deepsense6g_tii_tpu.models import resnet as jax_resnet
from deepsense6g_tii_tpu.ops import pooling as jax_pooling
from deepsense6g_tii_tpu.ops import resize as jax_resize
from deepsense6g_tii_tpu.utils.synth import \
    make_synth_batch as jax_make_synth_batch
from deepsense6g_tii_tpu_torch import config as port_config
from deepsense6g_tii_tpu_torch.data.features import normalize_imagenet
from deepsense6g_tii_tpu_torch.models import fusion, resnet
from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
from deepsense6g_tii_tpu_torch.ops import pooling, resize
from deepsense6g_tii_tpu_torch.utils.synth import make_synth_batch


def randomized(variables, seed):
    """Perturbed params and non-trivial BN statistics: init values (ones,
    zeros, zero pos_emb) would hide mapping and layout bugs."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "mean":
            return rng.uniform(-0.5, 0.5, x.shape).astype(np.float32)
        return x + rng.normal(scale=0.05, size=x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(variables))


def assert_close(got, want, rtol=1e-4):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=1e-4 * scale)


def port_module(module, variables):
    module.load_state_dict(from_jax_variables(variables), strict=True)
    return module.eval()


# -- config, synthetic data, normalisation ---------------------------------

def test_config_fields_and_defaults_match():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(port_config.GlobalConfig) == fields(
        jax_config.GlobalConfig)
    cfg = port_config.GlobalConfig()
    assert cfg.n_tokens == jax_config.GlobalConfig().n_tokens == 962
    assert cfg.replace(seq_len=10).n_tokens == 1922


def test_synth_batch_matches():
    cfg = port_config.GlobalConfig(seq_len=2, input_resolution=16)
    got = make_synth_batch(cfg, 3, seed=5)
    want = jax_make_synth_batch(cfg, 3, seed=5)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_normalize_imagenet_matches():
    x = np.random.default_rng(0).uniform(0, 255, (2, 4, 4, 3)).astype(
        np.float32)
    np.testing.assert_allclose(normalize_imagenet(torch.from_numpy(x)),
                               jax_normalize(jnp.asarray(x)), rtol=1e-6,
                               atol=1e-6)


# -- pooling and resize ------------------------------------------------------

def test_adaptive_and_global_avg_pool_match():
    x = np.random.default_rng(1).normal(size=(2, 16, 8, 5)).astype(
        np.float32)
    xt = torch.from_numpy(x)
    assert_close(pooling.adaptive_avg_pool(xt, 4, 2),
                 jax_pooling.adaptive_avg_pool(jnp.asarray(x), 4, 2), 1e-6)
    assert_close(pooling.global_avg_pool(xt),
                 jax_pooling.global_avg_pool(jnp.asarray(x)), 1e-6)
    with pytest.raises(ValueError, match="divisible"):
        pooling.adaptive_avg_pool(xt, 3, 2)


def test_max_pool_pads_with_minus_infinity():
    # all-negative input: zero padding would leak 0 into the edge windows
    x = -np.random.default_rng(2).uniform(1, 2, (2, 9, 8, 3)).astype(
        np.float32)
    got = pooling.max_pool_3x3s2(torch.from_numpy(x))
    want = jax_pooling.max_pool_3x3s2(jnp.asarray(x))
    assert got.shape == want.shape == (2, 5, 4, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", [8, 4, 2])
def test_interpolate_bilinear_matches(scale):
    x = np.random.default_rng(scale).normal(size=(3, 2, 3, 4)).astype(
        np.float32)
    got = resize.interpolate_bilinear(torch.from_numpy(x), scale)
    want = jax_resize.interpolate_bilinear(jnp.asarray(x), scale)
    assert got.shape == (3, 2 * scale, 3 * scale, 4)
    assert_close(got, want, 1e-5)


def test_interpolate_bilinear_is_torch_bilinear():
    x = torch.randn(2, 3, 3, 4, generator=torch.Generator().manual_seed(0))
    want = torch.nn.functional.interpolate(
        x.permute(0, 3, 1, 2), scale_factor=4, mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    torch.testing.assert_close(resize.interpolate_bilinear(x, 4), want,
                               rtol=1e-5, atol=1e-6)


# -- ResNet backbone ----------------------------------------------------------

PARTS = ("stem", "stage1", "stage2", "stage3", "stage4")


@pytest.fixture(scope="module")
def backbone():
    """JAX ResNetBackbone (1 block per stage, 2 input channels) with
    randomised variables, the port's counterpart, and each part's input and
    JAX output."""
    model = jax_resnet.ResNetBackbone((1, 1, 1, 1))
    x = np.random.default_rng(3).normal(size=(2, 64, 64, 2)).astype(
        np.float32)
    variables = randomized(jax.jit(model.init)(jax.random.PRNGKey(0),
                                               jnp.asarray(x)), 3)
    port = port_module(resnet.ResNetBackbone(2, (1, 1, 1, 1)), variables)
    ios, h = {}, jnp.asarray(x)
    for part in PARTS:
        out = model.apply(variables, h,
                          method=lambda m, a, p=part: getattr(m, p)(a))
        ios[part] = (np.array(h), out)
        h = out
    ios["full"] = (x, model.apply(variables, jnp.asarray(x)))
    return port, ios


@pytest.mark.parametrize("part", PARTS + ("full",))
def test_resnet_backbone_matches(backbone, part):
    port, ios = backbone
    x, want = ios[part]
    fn = port if part == "full" else getattr(port, part)
    with torch.no_grad():
        assert_close(fn(torch.from_numpy(x)), want)


# -- GPT block and token fusion -----------------------------------------------

@pytest.mark.parametrize("use_flash", [True, False])
def test_gpt_block_matches(use_flash):
    C = 32
    model = jax_fusion.GPTBlock(C, 4, 4, 0.0, 0.0, use_flash=use_flash)
    x = np.random.default_rng(4).normal(size=(2, 50, C)).astype(np.float32)
    variables = randomized(model.init(jax.random.PRNGKey(1),
                                      jnp.asarray(x)), 4)
    want = model.apply(variables, jnp.asarray(x))
    port = port_module(fusion.GPTBlock(C, 4, 4, use_flash=use_flash),
                       variables)
    with torch.no_grad():
        assert_close(port(torch.from_numpy(x)), want)


@pytest.fixture(scope="module")
def token_fusion():
    C, T, A = 32, 2, 2
    model = jax_fusion.TokenFusion(
        n_embd=C, n_layer=2, seq_len=T, n_views=1, anchors=A * A,
        gps_tokens=2, embd_pdrop=0.0, fusion_type="gpt", channel_swap=False,
        n_head=4, attn_pdrop=0.0, resid_pdrop=0.0, use_flash=True)
    rng = np.random.default_rng(5)
    inputs = [rng.normal(size=(2, T, A, A, C)).astype(np.float32)
              for _ in range(3)]
    inputs.append(rng.normal(size=(2, 2, C)).astype(np.float32))
    variables = randomized(
        model.init(jax.random.PRNGKey(2), *map(jnp.asarray, inputs)), 5)
    want = model.apply(variables, *map(jnp.asarray, inputs))
    port = port_module(fusion.TokenFusion(C, 2, model.n_tokens, 4, 4,
                                          "gpt", use_flash=True), variables)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, inputs))
    return got, want


@pytest.mark.parametrize("stream", ["image", "lidar", "radar", "gps"])
def test_token_fusion_matches(token_fusion, stream):
    got, want = token_fusion
    i = ("image", "lidar", "radar", "gps").index(stream)
    assert tuple(got[i].shape) == want[i].shape
    assert_close(got[i], want[i])


def test_token_fusion_mamba_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fusion.TokenFusion(32, 1, 26, fusion_type="mamba")
