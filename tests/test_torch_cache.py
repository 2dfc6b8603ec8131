"""The port's memmap cache (deepsense6g_tii_tpu_torch/data/cache.py,
utils/synth.py::build_synth_cache) against the JAX package's: the files
byte for byte for the same dataset, every storage-dtype rule, the readers'
samples and batches; and compact batches through the port's train and
eval steps (upcast on the device) against the same rows upcast on the host
and against JAX ``make_train_step`` on the compact batch.  The JAX
dataset reads its clouds through its Python PLY path (its native loader is
held to that path by tests/test_native.py); the port's dataset through its
native loader where it builds.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu.data import cache as jcache
from deepsense6g_tii_tpu.data import dataset as jds
from deepsense6g_tii_tpu.models.fuser import BeamFuser as JaxBeamFuser
from deepsense6g_tii_tpu.runtime import native as jnative
from deepsense6g_tii_tpu.train import state as jax_state
from deepsense6g_tii_tpu.train import steps as jax_steps
from deepsense6g_tii_tpu.utils import synth as jsynth
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.data import cache
from deepsense6g_tii_tpu_torch.data import dataset as pds
from deepsense6g_tii_tpu_torch.data.loader import DataLoader, collate
from deepsense6g_tii_tpu_torch.models.fuser import BeamFuser
from deepsense6g_tii_tpu_torch.models.weights import from_jax_variables
from deepsense6g_tii_tpu_torch.train import steps
from deepsense6g_tii_tpu_torch.train.state import create_train_state
from deepsense6g_tii_tpu_torch.utils import synth
from deepsense6g_tii_tpu_torch.utils.demo_data import make_demo_root
from synthetic_data import jinit
from test_torch_modules import randomized
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

SEQ = 2
CSV = "ml_challenge_dev_multi_modal.csv"
# the small geometry of tests/test_torch_train.py, dropout off
SMALL = dict(seq_len=2, n_layer=2, vert_anchors=2, horz_anchors=2,
             input_resolution=64, crop=64, backbone_blocks=(1, 1, 1, 1),
             compute_dtype="float32", FFM=0, TFM=0, use_flash_attention=True,
             embd_pdrop=0.0, attn_pdrop=0.0, resid_pdrop=0.0)
INPUTS = ("image", "lidar", "radar", "gps")


@pytest.fixture(autouse=True)
def python_ply_path(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _assert_same_files(got_dir, want_dir):
    got, want = _files(got_dir), _files(want_dir)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    return make_demo_root(str(tmp_path_factory.mktemp("demo")), n_train=3,
                          n_adapt=1, n_test=1, seq_len=SEQ) + "/Multi_Modal/"


def _datasets(root, res):
    return (pds.BeamDataset(root, CSV, GlobalConfig(seq_len=SEQ,
                                                    input_resolution=res)),
            jds.BeamDataset(root, CSV, JaxConfig(seq_len=SEQ,
                                                 input_resolution=res)))


# -- the files ------------------------------------------------------------------

@pytest.mark.parametrize("res,radar_dtype,dtypes", [
    (256, None, ("uint8", "uint8", "float16")),
    (256, "uint8", ("uint8", "uint8", "uint8")),
    # the block-mean shrink takes lidar off the six-level grid: float16
    (64, None, ("uint8", "float16", "float16")),
])
def test_build_cache_files_equal_jax(demo, tmp_path, res, radar_dtype,
                                     dtypes):
    pds_, jds_ = _datasets(demo, res)
    got = cache.build_cache(pds_, str(tmp_path / "p"), num_workers=4,
                            radar_dtype=radar_dtype)
    want = jcache.build_cache(jds_, str(tmp_path / "j"), num_workers=4,
                              radar_dtype=radar_dtype)
    _assert_same_files(got, want)
    specs = json.load(open(os.path.join(got, "manifest.json")))["specs"]
    assert tuple(specs[k]["dtype"] for k in ("image", "lidar",
                                             "radar")) == dtypes


@pytest.mark.parametrize("radar_dtype", ["float16", "uint8"])
def test_build_synth_cache_files_equal_jax(tmp_path, radar_dtype):
    kw = dict(seq_len=2, input_resolution=16)
    got = synth.build_synth_cache(GlobalConfig(**kw), 5, str(tmp_path / "p"),
                                  seed=3, chunk=2, radar_dtype=radar_dtype)
    want = jsynth.build_synth_cache(JaxConfig(**kw), 5, str(tmp_path / "j"),
                                    seed=3, chunk=2, radar_dtype=radar_dtype)
    _assert_same_files(got, want)


class _Samples:
    """A list of sample dicts as a map-style dataset."""

    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def _samples(n, image_off=None, lidar_off=None, seed=0):
    """Samples on the uint8 image and six-level lidar grids, but for the
    image of sample ``image_off`` (fractional) and the lidar of sample
    ``lidar_off`` (off the grid)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        image = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.float32)
        lidar = rng.integers(0, 6, (2, 8, 8, 1)).astype(np.float32) / 5
        if i == image_off:
            image[0, 0, 0, 0] += 0.5
        if i == lidar_off:
            lidar[0, 0, 0, 0] = 0.3
        out.append({"image": image, "lidar": lidar,
                    "radar": rng.uniform(0, 1, (2, 8, 8, 2)).astype(
                        np.float32),
                    "gps": rng.normal(size=(2, 2)).astype(np.float32),
                    "beam": rng.uniform(0, 1, 64).astype(np.float32),
                    "beamidx": np.int32(i), "scenario": f"scenario3{i % 4}"})
    return _Samples(out)


@pytest.mark.parametrize("off,dtypes", [
    ({}, ("uint8", "uint8")),
    ({"image_off": 3}, ("float16", "uint8")),
    ({"lidar_off": 2}, ("uint8", "float16")),
    ({"image_off": 1, "lidar_off": 4}, ("float16", "float16")),
])
def test_quantize_mismatch_restarts_in_float16(tmp_path, off, dtypes):
    ds = _samples(6, **off)
    got = cache.build_cache(ds, str(tmp_path / "p"), num_workers=3)
    want = jcache.build_cache(ds, str(tmp_path / "j"), num_workers=3)
    _assert_same_files(got, want)
    specs = json.load(open(os.path.join(got, "manifest.json")))["specs"]
    assert (specs["image"]["dtype"], specs["lidar"]["dtype"]) == dtypes
    # uint8 storage serves the samples' values, float16 storage them
    # rounded to float16
    i = off.get("lidar_off", 0)
    want = ds[i]["lidar"]
    if dtypes[1] == "float16":
        want = want.astype(np.float16).astype(np.float32)
    np.testing.assert_array_equal(cache.CachedDataset(got)[i]["lidar"], want)


def test_radar_dtype_mismatch_raises(tmp_path):
    ds = _samples(3)
    for mod in (cache, jcache):
        d = str(tmp_path / mod.__name__)
        mod.build_cache(ds, d)
        with pytest.raises(ValueError, match="radar dtype 'float16'"):
            mod.build_cache(ds, d, radar_dtype="uint8")


@pytest.mark.parametrize("kw", [{"image_dtype": "uint8"},
                                {"lidar_dtype": "uint8"},
                                {"radar_dtype": "int8"}])
def test_unsupported_dtype_requests_raise(tmp_path, kw):
    with pytest.raises(ValueError, match="unsupported"):
        cache.build_cache(_samples(2), str(tmp_path / "c"), **kw)


def test_stale_version_rebuilds_and_build_is_idempotent(tmp_path):
    ds = _samples(4)
    d = str(tmp_path / "c")
    os.makedirs(d)
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump({"n": 4, "specs": {}, "has_labels": True,
                   "format_version": cache.CACHE_FORMAT_VERSION - 1}, f)
    np.save(os.path.join(d, "stale.npy"), np.zeros(3))
    cache.build_cache(ds, d)
    _assert_same_files(d, jcache.build_cache(ds, str(tmp_path / "j")))
    mtimes = {n: os.stat(os.path.join(d, n)).st_mtime_ns
              for n in os.listdir(d)}
    assert cache.build_cache(ds, d) == d          # found: nothing written
    assert mtimes == {n: os.stat(os.path.join(d, n)).st_mtime_ns
                      for n in os.listdir(d)}


# -- the readers --------------------------------------------------------------

@pytest.fixture(scope="module")
def built(demo, tmp_path_factory):
    pds_, _ = _datasets(demo, 256)
    root = tmp_path_factory.mktemp("built")
    return {r: cache.build_cache(pds_, str(root / str(r)),
                                 radar_dtype=r, num_workers=4)
            for r in (None, "uint8")}


@pytest.mark.parametrize("radar", [None, "uint8"])
def test_cached_dataset_items_equal_jax(built, radar):
    got, want = cache.CachedDataset(built[radar]), jcache.CachedDataset(
        built[radar])
    assert len(got) == len(want) == 6
    for i in range(len(want)):
        g, w = got[i], want[i]
        assert sorted(g) == sorted(w)
        for k in w:
            assert type(g[k]) is type(w[k]), k
            if isinstance(w[k], np.ndarray) or isinstance(w[k], np.generic):
                assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("radar", [None, "uint8"])
@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, True)])
def test_cached_batch_loader_equals_jax(built, radar, shuffle, drop_last):
    """Batches of 4 over 6 samples, 2 epochs: the same order, dtypes and
    values, and the order of DataLoader(CachedDataset) with the seed."""
    got = cache.CachedBatchLoader(built[radar], 4, shuffle=shuffle,
                                  drop_last=drop_last)
    want = jcache.CachedBatchLoader(built[radar], 4, shuffle=shuffle,
                                    drop_last=drop_last)
    classic = DataLoader(cache.CachedDataset(built[radar]), 4,
                         shuffle=shuffle, drop_last=drop_last, num_workers=2)
    assert len(got) == len(want) == (1 if drop_last else 2)
    for _ in range(2):
        for g, w, c in zip(got, want, classic, strict=True):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(g["beamidx"], c["beamidx"])
            np.testing.assert_array_equal(g["scenario"], c["scenario"])
    assert got.epoch == want.epoch == 2
    assert got.arrays["image"].dtype == np.uint8
    assert got.arrays["lidar"].dtype == np.uint8
    assert got.arrays["radar"].dtype == (np.uint8 if radar else np.float16)


# -- compact batches through the steps -----------------------------------------

@pytest.fixture(scope="module")
def compact(tmp_path_factory):
    """A CachedBatchLoader batch at the small geometry (uint8 image and
    lidar, radar float16 or uint8) and the same rows as CachedDataset
    upcasts them on the host, by radar storage."""
    out = {}
    for radar in ("float16", "uint8"):
        d = synth.build_synth_cache(
            GlobalConfig(**SMALL), 4,
            str(tmp_path_factory.mktemp("synth") / radar), seed=5,
            radar_dtype=radar)
        ds = cache.CachedDataset(d)
        out[radar] = (next(iter(cache.CachedBatchLoader(d, 2))),
                      collate([ds[0], ds[1]]))
    return out


@pytest.fixture(scope="module")
def variables():
    jcfg = JaxConfig(**SMALL)
    b = synth.make_synth_batch(GlobalConfig(**SMALL), 2, seed=20)
    v = randomized(jinit(JaxBeamFuser(jcfg), *(jnp.asarray(b[k])
                                              for k in INPUTS)), 13)
    return jax.device_get(v)


def _port(variables):
    model = BeamFuser(GlobalConfig(**SMALL), device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model, create_train_state(model)


def test_upcast_divides_exactly_on_the_device_side():
    q = np.arange(256, dtype=np.uint8)
    for key, scale in (("lidar", 5.0), ("radar", 255.0)):
        got = steps.upcast(key, torch.from_numpy(q))
        np.testing.assert_array_equal(
            got.numpy(), q.astype(np.float32) / np.float32(scale))
    assert steps.upcast("image", torch.from_numpy(q)).dtype == torch.float32
    half = torch.tensor([0.1, 0.7], dtype=torch.float16)
    assert torch.equal(steps.upcast("radar", half), half.float())
    idx = torch.tensor([3, 1], dtype=torch.int32)
    assert steps.upcast("beamidx", idx) is idx


@pytest.mark.parametrize("radar", ["float16", "uint8"])
def test_compact_steps_bit_equal_host_upcast(compact, variables, radar):
    """The train step's loss, ranks and gradients, and the eval step's
    logits, on the compact batch equal the host-upcast batch's bit for
    bit."""
    small, host = compact[radar]
    assert small["image"].dtype == np.uint8
    assert small["lidar"].dtype == np.uint8
    assert small["radar"].dtype == np.dtype(radar)
    assert all(host[k].dtype == np.float32 for k in INPUTS)
    out = []
    for batch in (small, host):
        model, state = _port(variables)
        logits = []
        model.register_forward_hook(lambda m, a, r: logits.append(r))
        steps.make_eval_step(model, GlobalConfig(**SMALL), state,
                             device="cpu")(batch)
        m = steps.make_train_step(model, GlobalConfig(**SMALL), state,
                                  use_ema=True, device="cpu")(batch, 1e-4)
        out.append((logits[0], m["loss"], m["ranks"],
                    [p.grad for p in model.parameters()]))
    (lg, loss, ranks, grads), (lg2, loss2, ranks2, grads2) = out
    assert torch.equal(lg, lg2)
    assert torch.equal(loss, loss2) and torch.equal(ranks, ranks2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


def test_compact_train_step_matches_jax(compact, variables):
    """JAX make_train_step on the same compact batch (upcast on its device
    by ``_upcast_f16``): tests/test_torch_train.py's bounds for a first
    step, the loss within 1e-5 and the top-3 beams equal."""
    small, _ = compact["uint8"]
    jcfg = JaxConfig(**SMALL)
    tx = jax_state.make_optimizer()
    jstep = jax_steps.make_train_step(JaxBeamFuser(jcfg), jcfg, tx,
                                      use_ema=True)
    jstate = jax_state.create_train_state(
        jax.tree_util.tree_map(jnp.array, variables), tx)
    _, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in small.items()
                           if k != "scenario"}, 1e-4)
    model, state = _port(variables)
    m = steps.make_train_step(model, GlobalConfig(**SMALL), state,
                              use_ema=True, device="cpu")(small, 1e-4)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(m["ranks"].numpy()[:, :3],
                                  np.asarray(jm["ranks"])[:, :3])
