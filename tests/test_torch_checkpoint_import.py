"""The port's reference-checkpoint import and export
(deepsense6g_tii_tpu_torch/models/checkpoint_import.py, torch_port.py and
weights.py::to_jax_variables) against the JAX package's, leaf for leaf, on
the GPT TransFuser, the MambaFuser and the 30-to-5 model with its GRU
decoder, at the small test geometry.  The reference-layout state dicts are
written by the JAX package's ``export_reference_checkpoint`` from random
leaves and saved as ``.pth`` files with ``torch.save``.  Every comparison
is exact: the maps only transpose, split and add.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu.models import checkpoint_import as jax_ci
from deepsense6g_tii_tpu.models import torch_port as jax_tp
from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.models import checkpoint_import as ci
from deepsense6g_tii_tpu_torch.models import torch_port as tp
from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
from deepsense6g_tii_tpu_torch.models.weights import (from_jax_variables,
                                                      to_jax_variables)
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

# the small test geometry, but with the reference's backbones (ResNet34
# camera, ResNet18 LiDAR and radar): the importer tells them apart by depth
GEOMETRY = dict(n_layer=2, vert_anchors=2, horz_anchors=2,
                input_resolution=64, crop=64, compute_dtype="float32")
KINDS = {"gpt": dict(seq_len=2, FFM=0, TFM=0),
         "mamba": dict(seq_len=2, FFM=1, TFM=1),
         "30to5": dict(seq_len=10, pred_len=5, FFM=0, TFM=0)}
# reference keys the model does not read: BatchNorm counters (never
# reported), torchvision's fc head and a stray module
EXTRA = ("module.encoder.image_encoder.features.bn1.num_batches_tracked",
         "module.encoder.lidar_encoder._model.fc.weight",
         "module.encoder.radar_encoder._model.fc.bias",
         "module.stray.weight")


def _configs(kind):
    kw = {**GEOMETRY, **KINDS[kind]}
    return JaxConfig(**kw), GlobalConfig(**kw)


def _leaves(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}/")
        else:
            yield prefix + key, val


def assert_tree_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    for key, w in want.items():
        g = got[key]
        assert isinstance(g, np.ndarray), key
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=key)


_VARIABLES = {}


def random_variables(name):
    """A model's variables with random leaves (distinct values, so that any
    mis-mapping shows), from its shapes alone; the last kind asked for is
    kept (~200 MB a kind)."""
    if name not in _VARIABLES:
        _VARIABLES.clear()
        jcfg, _ = _configs(name)
        T, H = jcfg.seq_len, jcfg.crop
        shapes = jax.eval_shape(
            JaxBeamFuser(jcfg).init, jax.random.PRNGKey(0),
            jnp.zeros((1, T, H, H, 3)), jnp.zeros((1, T, H, H, 1)),
            jnp.zeros((1, T, H, H, 2)), jnp.zeros((1, jcfg.gps_len, 2)))
        rng = np.random.default_rng(len(name))
        _VARIABLES[name] = jax.tree_util.tree_map(
            lambda s: rng.standard_normal(s.shape, np.float32), shapes)
    return _VARIABLES[name]


@pytest.fixture(scope="module", params=sorted(KINDS))
def kind(request, tmp_path_factory):
    """(kind, JAX config, port config, variables with random leaves, the
    reference state dict of numpy arrays, and its .pth file)."""
    jcfg, cfg = _configs(request.param)
    variables = random_variables(request.param)
    sd = jax_ci.export_reference_checkpoint(
        variables["params"], variables["batch_stats"], jcfg)
    for i, key in enumerate(EXTRA):
        sd[key] = np.full((3,), i, np.float32)
    path = tmp_path_factory.mktemp("ref") / (request.param + ".pth")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    return request.param, jcfg, cfg, variables, sd, str(path)


def test_import_matches_jax(kind):
    _, jcfg, cfg, variables, sd, path = kind
    want_p, want_s, want_unused = jax_ci.import_reference_checkpoint(sd, jcfg)
    params, stats, unused = ci.load_reference_checkpoint(path, cfg)
    assert_tree_equal(params, want_p)
    assert_tree_equal(stats, want_s)
    assert unused == want_unused == {k[len("module."):] for k in EXTRA[1:]}
    # the import is the exporter's inverse
    assert_tree_equal(params, variables["params"])
    assert_tree_equal(stats, variables["batch_stats"])


def test_export_matches_jax(kind):
    _, jcfg, cfg, variables, _, _ = kind
    want = jax_ci.export_reference_checkpoint(
        variables["params"], variables["batch_stats"], jcfg)
    got = ci.export_reference_checkpoint(
        variables["params"], variables["batch_stats"], cfg)
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_to_jax_variables_inverts_from_jax_variables(kind):
    _, _, cfg, variables, _, _ = kind
    sd = from_jax_variables(variables)
    model = BeamFuser(cfg, device="cpu")
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    back = to_jax_variables(sd)
    assert set(back) == {"params", "batch_stats"}
    assert_tree_equal(back["params"], variables["params"])
    assert_tree_equal(back["batch_stats"], variables["batch_stats"])


def test_port_written_pth_reads_in_jax(kind, tmp_path):
    """A port model saved as a reference .pth: the JAX importer reads back
    the model's own leaves, with no key left over; the port's from_torch
    path rebuilds the state_dict bit for bit."""
    _, jcfg, cfg, variables, _, _ = kind
    model = BeamFuser(cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    path = str(tmp_path / "model.pth")
    ci.save_reference_checkpoint(model, path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    assert all(k.startswith("module.") and v.dtype == torch.float32
               for k, v in sd.items())
    params, stats, unused = jax_ci.import_reference_checkpoint(sd, jcfg)
    assert unused == set()
    assert_tree_equal(jax.device_get(params), variables["params"])
    assert_tree_equal(jax.device_get(stats), variables["batch_stats"])
    p2, s2, _ = ci.load_reference_checkpoint(path, cfg)
    again = from_jax_variables({"params": p2, "batch_stats": s2})
    for key, val in model.state_dict().items():
        torch.testing.assert_close(again[key], val, rtol=0, atol=0)


def _torchvision_sd(backbone):
    """A torchvision-format state dict of one backbone (the reference's
    naming without its prefix), with its fc head."""
    variables = random_variables("gpt")
    prefix = {"image_encoder": "encoder.image_encoder.features.",
              "lidar_encoder": "encoder.lidar_encoder._model."}[backbone]
    sd = jax_ci.export_reference_checkpoint(
        variables["params"], variables["batch_stats"],
        JaxConfig(**GEOMETRY, FFM=0, TFM=0))
    out = {k[len("module.") + len(prefix):]: v for k, v in sd.items()
           if k.startswith("module." + prefix)}
    out["fc.weight"] = np.zeros((10, 512), np.float32)
    return out


@pytest.mark.parametrize("port_conv1", [True, False])
def test_convert_resnet_matches_jax(port_conv1):
    sd = _torchvision_sd("image_encoder")
    want = jax_tp.convert_resnet_state_dict(sd, blocks=(3, 4, 6, 3),
                                            port_conv1=port_conv1)
    got = tp.convert_resnet_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
        blocks=(3, 4, 6, 3), port_conv1=port_conv1)
    for g, w in zip(got, want):
        assert_tree_equal(g, w)
    assert ("conv1" in got[0]["stem"]) == port_conv1


def test_graft_backbone_keeps_the_stem(tmp_path):
    """A torchvision checkpoint grafted into the LiDAR backbone with
    port_conv1=False: every leaf but the 1-channel conv1 comes from the
    checkpoint, the rest of the model is untouched."""
    _, cfg = _configs("gpt")
    sd = _torchvision_sd("lidar_encoder")
    path = tmp_path / "resnet18.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in sd.items()}, path)
    params, stats = tp.load_torchvision_checkpoint(
        str(path), blocks=(2, 2, 2, 2), port_conv1=False)
    model = BeamFuser(cfg, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tp.graft_backbone(model, "lidar_encoder", params, stats)
    after = model.state_dict()
    want = from_jax_variables(
        {"params": {"encoder": {"lidar_encoder": params}},
         "batch_stats": {"encoder": {"lidar_encoder": stats}}})
    stem = "encoder.lidar_encoder.stem.conv1.weight"
    assert stem not in want
    for key, val in after.items():
        ref = want.get(key, before[key])
        torch.testing.assert_close(val, ref, rtol=0, atol=0, msg=key)
    assert not torch.equal(after["encoder.lidar_encoder.stem.bn1.weight"],
                           before["encoder.lidar_encoder.stem.bn1.weight"])
    with pytest.raises(KeyError, match="no such leaves"):
        tp.graft_backbone(model, "sonar_encoder", params, stats)
