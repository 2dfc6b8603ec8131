"""The port's data path (deepsense6g_tii_tpu_torch/data/, utils/) against
the JAX package's: the numpy feature functions, BeamDataset's sample dicts
on a DeepSense-layout tree (every path choice), the demo tree, the train and
validation split, the loader's batch order, PLY files and the TensorBoard
event bytes.  Numpy only on both sides; the comparisons are exact unless a
test states a tolerance.  The JAX dataset's LiDAR clouds go through its
Python PLY path (its native loader is held bit-identical to that path by
tests/test_native.py, and building it here would race that file's build).
"""

import os
import shutil

import numpy as np
import pytest

from deepsense6g_tii_tpu.config import GlobalConfig as JaxConfig
from deepsense6g_tii_tpu.data import dataset as jds
from deepsense6g_tii_tpu.data import features as jF
from deepsense6g_tii_tpu.data import loader as jloader
from deepsense6g_tii_tpu.runtime import native as jnative
from deepsense6g_tii_tpu.utils import demo_data as jdemo
from deepsense6g_tii_tpu.utils import ply as jply
from deepsense6g_tii_tpu.utils import tb_events as jtb
from deepsense6g_tii_tpu.utils import utm as jutm
from deepsense6g_tii_tpu_torch.config import GlobalConfig
from deepsense6g_tii_tpu_torch.data import dataset as pds
from deepsense6g_tii_tpu_torch.data import features as pF
from deepsense6g_tii_tpu_torch.data import loader as ploader
from deepsense6g_tii_tpu_torch.utils import demo_data as pdemo
from deepsense6g_tii_tpu_torch.utils import image as pimage
from deepsense6g_tii_tpu_torch.utils import ply as pply
from deepsense6g_tii_tpu_torch.utils import tb_events as ptb
from deepsense6g_tii_tpu_torch.utils import utm as putm

SCENARIOS = ("scenario31", "scenario32", "scenario33", "scenario34")
SEQ = 2


@pytest.fixture(autouse=True)
def python_ply_path(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


# -- feature functions ----------------------------------------------------------

@pytest.mark.parametrize("custom", [0, 1])
def test_fov_for_address(custom):
    for name in SCENARIOS + ("scenario99", ""):
        path = f"./{name}/unit1/lidar_data/3.ply"
        assert (pF.fov_for_address(path, bool(custom))
                == jF.fov_for_address(path, bool(custom)))


@pytest.mark.parametrize("scenario", SCENARIOS + ("default",))
def test_lidar_to_bev(scenario):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-75, 20, size=(4000, 3))
    pts[:8, :2] = [[0.0, 0.0], [-50, -50], [-70, 14], [0, 5.5]] * 2  # edges
    fov = jF.fov_for_address(scenario, True)
    got = pF.lidar_to_bev_np(pts, fov)
    want = jF.lidar_to_bev_np(pts, fov)
    assert got.dtype == want.dtype and got.shape == want.shape == (1, 256, 256)
    np.testing.assert_array_equal(got, want)


def test_radar_maps_and_minmax():
    rng = np.random.default_rng(2)
    cube = (rng.normal(size=(4, 256, 128))
            + 1j * rng.normal(size=(4, 256, 128)))
    for fn in ("range_angle_map_np", "range_velocity_map_np"):
        got, want = getattr(pF, fn)(cube), getattr(jF, fn)(cube)
        assert got.shape == want.shape == (256, 256)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(pF.minmax_np(got), jF.minmax_np(want))


@pytest.mark.parametrize("angle_norm", [0, 1])
def test_normalize_loc(angle_norm):
    rng = np.random.default_rng(3)
    n = 10
    pos_ue = np.stack([33.42 + rng.normal(scale=1e-3, size=(n, 2)),
                       -111.93 + rng.normal(scale=1e-3, size=(n, 2))], -1)
    pos_bs = np.stack([33.42 + rng.normal(scale=1e-5, size=n),
                       np.full(n, -111.93)], -1)
    scen = [f"./{SCENARIOS[i % 4]}/unit1/GPS_data/gps_loc.txt"
            for i in range(n - 1)] + ["./other/gps.txt"]
    got = pF.normalize_loc_np(pos_ue, pos_bs, scen, bool(angle_norm))
    want = jF.normalize_loc_np(pos_ue, pos_bs, scen, bool(angle_norm))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.stack(putm.from_latlon(pos_ue[:, 0, 0], pos_ue[:, 0, 1])[:3]),
        np.stack(jutm.from_latlon(pos_ue[:, 0, 0], pos_ue[:, 0, 1])[:3]))


def test_soft_beam_target():
    for b in range(64):
        np.testing.assert_array_equal(pF.soft_beam_target_np(b),
                                      jF.soft_beam_target_np(b))


# -- BeamDataset -------------------------------------------------------------------

def _variant(src_dir, dst_dir, suffix="", seed=0):
    """Writes a differing copy of every file of ``src_dir`` into ``dst_dir``
    (a ``suffix`` before the extension), so a wrong path choice shows."""
    rng = np.random.default_rng(seed)
    os.makedirs(dst_dir, exist_ok=True)
    for name in sorted(os.listdir(src_dir)):
        stem, ext = os.path.splitext(name)
        dst = os.path.join(dst_dir, stem + suffix + ext)
        if ext == ".jpg":
            pimage.write_jpeg(dst, rng.integers(0, 255, (40, 56, 3),
                                                dtype=np.uint8))
        elif ext == ".ply":
            pply.write_points(dst, rng.uniform(-60, 10, size=(300, 3)))
        else:
            np.save(dst, rng.uniform(0, 1, (256, 256)).astype(np.float32))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """All four scenarios, 2 samples each, with every path variant."""
    root = str(tmp_path_factory.mktemp("tree")) + "/"
    csv = jdemo.make_fake_dataset_tree(root, scenarios=SCENARIOS,
                                       n_samples=2, seq_len=SEQ)
    for k, s in enumerate(SCENARIOS):
        u = os.path.join(root, s, "unit1")
        for tag in ("_mask", "_seg", "_raw"):
            _variant(os.path.join(u, "camera_data"),
                     os.path.join(u, "camera_data" + tag), seed=10 * k)
        _variant(os.path.join(u, "camera_data"),
                 os.path.join(u, "camera_data_aug"), "_3", seed=10 * k + 1)
        _variant(os.path.join(u, "lidar_data"),
                 os.path.join(u, "lidar_data_filtered"), seed=10 * k + 2)
        _variant(os.path.join(u, "lidar_data"),
                 os.path.join(u, "lidar_data_aug"), "_2", seed=10 * k + 3)
        for kind in ("ang", "vel"):
            _variant(os.path.join(u, f"radar_data_{kind}"),
                     os.path.join(u, f"radar_data_{kind}_aug"),
                     seed=10 * k + 4)
    return root, csv


def _assert_samples_equal(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray) or isinstance(w, np.generic):
            assert type(g) is type(w), key
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert type(g) is type(w) and g == w, key


SMALL_DATA = dict(seq_len=SEQ, input_resolution=64, crop=64)
CASES = {
    "default": ({}, {}),
    "flip": ({}, dict(flip=True)),
    "no_velocity": (dict(add_velocity=0), {}),
    "flip_no_velocity": (dict(add_velocity=0), dict(flip=True)),
    "test": ({}, dict(test=True)),
    "raw_fov0_angle0": (dict(enhanced=0, custom_FoV_lidar=0, angle_norm=0),
                        {}),
    "filtered": (dict(filtered=1), {}),
    "mask": (dict(add_mask=1, enhanced=0), {}),
    "seg": (dict(add_seg=1), {}),
    "augment": ({}, dict(augment={"camera": 3, "lidar": 2, "radar": 1})),
    "native_256": (dict(input_resolution=256, crop=256), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_dataset_samples_match(tree, case):
    root, csv = tree
    cfg_kw, ds_kw = CASES[case]
    kw = {**SMALL_DATA, **cfg_kw}
    want_ds = jds.BeamDataset(root, csv, JaxConfig(**kw), **ds_kw)
    got_ds = pds.BeamDataset(root, csv, GlobalConfig(**kw), **ds_kw)
    assert len(got_ds) == len(want_ds) == 8
    np.testing.assert_array_equal(got_ds.pos_input_normalized,
                                  want_ds.pos_input_normalized)
    rows = range(8) if case == "default" else (0, 3, 5, 6)   # 31 32 33 34
    for i in rows:
        _assert_samples_equal(got_ds[i], want_ds[i])


def test_mask_and_enhanced_refused(tree):
    root, csv = tree
    cfg = GlobalConfig(**SMALL_DATA, add_mask=1, enhanced=1)
    with pytest.raises(ValueError, match="mask or enhance"):
        pds.BeamDataset(root, csv, cfg)[4]        # a scenario33 row


def test_camera_reader_matches_pil_at_full_size(tmp_path):
    """A 960x540 frame, resized to 256 (bicubic) by both readers."""
    rng = np.random.default_rng(4)
    path = str(tmp_path / "f.jpg")
    pimage.write_jpeg(path, rng.integers(0, 255, (540, 960, 3),
                                         dtype=np.uint8))
    ds = object.__new__(jds.BeamDataset)
    ds.root, ds.config = "", JaxConfig()
    ds.augment = {"camera": 0, "lidar": 0, "radar": 0}
    want = ds._load_image(path, 0)
    got = pimage.read_frame(path, 256)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# -- demo tree, splits, loader -------------------------------------------------------

def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def test_demo_root_matches_jax(tmp_path):
    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    jdemo.make_demo_root(a, n_train=2, n_adapt=1, n_test=1, seed=5)
    pdemo.make_demo_root(b, n_train=2, n_adapt=1, n_test=1, seed=5)
    files = _files(a)
    # 3 CSVs, 6 base-station GPS files, and per sample 4 files a frame
    # and 2 GPS files
    assert files == _files(b) and len(files) == 3 + 6 + 8 * (SEQ * 4 + 2)
    for rel in files:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".jpg"):
            np.testing.assert_array_equal(pimage.read_frame(pa, 32),
                                          pimage.read_frame(pb, 32))
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.fixture(scope="module")
def demo_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("demo"))
    jdemo.make_demo_root(root, n_train=3, n_adapt=3, n_test=2, seq_len=SEQ)
    mm = os.path.join(root, "Multi_Modal")
    ad = os.path.join(root, "Adaptation_dataset_multi_modal")
    # the per-scenario CSVs of the augmentation and finetune sets
    for i in (1, 2, 3):
        shutil.copy(os.path.join(ad, "ml_challenge_data_adaptation_multi_"
                                 "modal.csv"),
                    os.path.join(ad, f"scenario3{i}.csv"))
    with open(os.path.join(mm, "ml_challenge_dev_multi_modal.csv")) as f:
        head, *rows = f.read().splitlines()
    with open(os.path.join(mm, "scenario34.csv"), "w") as f:
        f.write("\n".join([head] + rows * 5) + "\n")         # 30 rows
    return root


def _describe(ds, i):
    """Where index i of a (nested) dataset lands: the BeamDataset's root,
    flip, augment and its row's first camera path."""
    while not hasattr(ds, "augment"):
        if hasattr(ds, "indices"):
            ds, i = ds.dataset, int(ds.indices[i])
        else:
            di = int(np.searchsorted(ds._offsets, i, side="right") - 1)
            ds, i = ds.datasets[di], i - int(ds._offsets[di])
    col = (ds.columns["unit1_rgb_1"] if hasattr(ds, "columns")
           else list(ds.dataframe["unit1_rgb_1"]))
    return ds.root, ds.flip, sorted(ds.augment.items()), col[i]


SPLITS = {
    "together": dict(train_adapt_together=True, augmentation=False),
    "together_aug_flip": dict(train_adapt_together=True, augmentation=True,
                              flip=True),
    "dev_only": dict(train_adapt_together=False, augmentation=False),
    "finetune": dict(train_adapt_together=False, finetune=True),
}


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_build_train_val_sets_match(demo_root, split):
    kw = dict(trainval_root=demo_root + "/Multi_Modal/",
              train_root_csv="ml_challenge_dev_multi_modal.csv",
              adaptation_root=demo_root + "/Adaptation_dataset_multi_modal/",
              adaptation_csv="ml_challenge_data_adaptation_multi_modal.csv",
              **SPLITS[split])
    want = jds.build_train_val_sets(JaxConfig(seq_len=SEQ), **kw)
    got = pds.build_train_val_sets(GlobalConfig(seq_len=SEQ), **kw)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert len(g) == len(w) > 0
        assert ([_describe(g, i) for i in range(len(g))]
                == [_describe(w, i) for i in range(len(w))])


@pytest.mark.parametrize("use_processes", [False, True])
def test_loader_batch_order_matches(use_processes):
    """11 rows in batches of 4 (the last ragged), shuffled, over 2 epochs."""
    rows = [{"image": np.full((2, 3), i, np.float32),
             "beamidx": np.int32(i), "scenario": SCENARIOS[i % 4]}
            for i in range(11)]
    want = jloader.DataLoader(rows, 4, shuffle=True, num_workers=2)
    got = ploader.DataLoader(pds.Subset(rows, np.arange(11)), 4,
                             shuffle=True, num_workers=2,
                             use_processes=use_processes)
    assert len(got) == len(want) == 3
    for _ in range(2):
        batches = list(got)
        ref = list(want)
        assert [len(b["beamidx"]) for b in batches] == [4, 4, 3]
        for g, w in zip(batches, ref):
            assert set(g) == set(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k])
    assert got.epoch == 2


# -- PLY and TensorBoard events ---------------------------------------------------------

@pytest.mark.parametrize("ascii_", [True, False])
def test_ply_round_trips_between_packages(tmp_path, ascii_):
    pts = np.random.default_rng(6).uniform(-50, 10, size=(57, 3))
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    jply.write_points(a, pts, ascii=ascii_)
    pply.write_points(b, pts, ascii=ascii_)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_array_equal(pply.read_points(a), jply.read_points(a))
    if not ascii_:
        np.testing.assert_array_equal(pply.read_points(a), pts)


def test_tb_event_bytes_match(tmp_path, monkeypatch):
    files = {}
    for name, mod in (("jax", jtb), ("port", ptb)):
        clock = iter(np.arange(1.7e9, 1.7e9 + 10, 0.25).tolist())
        monkeypatch.setattr(mod.time, "time", lambda: next(clock))
        monkeypatch.setattr(mod.socket, "gethostname", lambda: "host")
        d = str(tmp_path / name)
        w = mod.EventFileWriter(d)
        w.scalars([("DBA_score_train", 0.25, 1), ("curr_loss_val", 1.5, 2),
                   ("perf/samples_per_sec", 123.456, 300)])
        w.close()
        (fname,) = os.listdir(d)
        files[name] = (fname, open(os.path.join(d, fname), "rb").read())
    assert files["port"] == files["jax"]
