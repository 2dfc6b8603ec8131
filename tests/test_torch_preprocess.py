"""The port's offline preprocessing (deepsense6g_tii_tpu_torch/data/
preprocess/) against the JAX package's on the same numpy inputs, on the
CPU: the radar FFT maps (within 2e-5; per-cube min-max), the LiDAR filter's
nearest-neighbour search and both passes by point for every backend, the
written clouds byte for byte, and the augmentation and CSV writers byte for
byte at one seed.  The ``cuda`` backend and the radar maps run their CPU
path here (``device="cpu"``); on the card they are the same torch code.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from deepsense6g_tii_tpu.data import features as JF
from deepsense6g_tii_tpu.data.preprocess import augment as jaug
from deepsense6g_tii_tpu.data.preprocess import csv_builder as jcsv
from deepsense6g_tii_tpu.data.preprocess import lidar_filter as JLF
from deepsense6g_tii_tpu.data.preprocess import radar as jradar
from deepsense6g_tii_tpu_torch.data import features as F
from deepsense6g_tii_tpu_torch.data.preprocess import augment, csv_builder
from deepsense6g_tii_tpu_torch.data.preprocess import lidar_filter as LF
from deepsense6g_tii_tpu_torch.data.preprocess import radar
from deepsense6g_tii_tpu_torch.utils import ply
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

RADAR_TOL = 2e-5
# the port's backend -> the JAX package's backend that oracles it.  The
# port's native k-d tree finds the exact nearest neighbour, as the JAX
# package's kdtree does (same bytes); the JAX package's own native backend
# needs its C library, which a test worker may find unbuilt.
JAX_BACKEND = {"cuda": "tpu", "native": "kdtree", "kdtree": "kdtree"}


def cubes(rng, n, shape=(4, 64, 50), complex_=True, scales=None):
    c = rng.normal(size=(n, *shape))
    if complex_:
        c = c + 1j * rng.normal(size=(n, *shape))
    if scales is not None:
        c = c * np.asarray(scales).reshape(-1, 1, 1, 1)
    return c.astype(np.complex64 if complex_ else np.float32)


# -- radar --------------------------------------------------------------------

@pytest.mark.parametrize("complex_", [True, False])
def test_radar_batch_matches_jax(complex_):
    c = cubes(np.random.default_rng(1), 3, complex_=complex_)
    ra, rv = radar.process_batch(c, device="cpu")
    jra, jrv = jradar.process_batch(c)
    assert ra.shape == rv.shape == (3, 64, 256) and ra.dtype == np.float32
    np.testing.assert_allclose(ra, jra, rtol=0, atol=RADAR_TOL)
    np.testing.assert_allclose(rv, jrv, rtol=0, atol=RADAR_TOL)


@pytest.mark.parametrize("complex_", [True, False])
def test_radar_single_matches_jax(complex_):
    c = cubes(np.random.default_rng(2), 1, complex_=complex_)[0]
    ra, rv = radar.process_file(c, device="cpu")
    jra, jrv = jradar.process_file(c)
    assert ra.shape == (64, 256)
    np.testing.assert_allclose(ra, jra, rtol=0, atol=RADAR_TOL)
    np.testing.assert_allclose(rv, jrv, rtol=0, atol=RADAR_TOL)


@pytest.mark.parametrize("shape,fft_size", [((4, 32, 20), 16),
                                            ((3, 16, 40), 8)])
def test_radar_fft_size_pads_and_truncates_as_jax(shape, fft_size):
    """n = fft_size zero-pads the antennas (4 -> 16) or truncates the chirps
    (40 -> 8) as jnp.fft.fft does."""
    c = cubes(np.random.default_rng(3), 2, shape)
    ra, rv = F.radar_maps(torch.from_numpy(c), fft_size)
    jra, jrv = jax.vmap(JF.radar_maps, in_axes=(0, None))(jnp.asarray(c),
                                                          fft_size)
    assert ra.shape == (2, shape[1], fft_size)
    np.testing.assert_allclose(ra.numpy(), np.asarray(jra), rtol=0,
                               atol=RADAR_TOL)
    np.testing.assert_allclose(rv.numpy(), np.asarray(jrv), rtol=0,
                               atol=RADAR_TOL)


@pytest.mark.parametrize("complex_", [True, False])
@pytest.mark.parametrize("fn", ["range_angle_map", "range_velocity_map"])
def test_unscaled_radar_map_matches_jax(fn, complex_):
    """The maps before min-max, within RADAR_TOL of the map's largest
    value: one cube, and a batch against JAX's map of each cube."""
    c = cubes(np.random.default_rng(5), 2, complex_=complex_)
    jfn = getattr(JF, fn)
    want = np.stack([np.asarray(jfn(jnp.asarray(x))) for x in c])
    got = getattr(F, fn)(torch.from_numpy(c)).numpy()
    single = getattr(F, fn)(torch.from_numpy(c[0])).numpy()
    assert got.shape == want.shape == (2, 64, 256)
    atol = RADAR_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    np.testing.assert_allclose(single, want[0], rtol=0, atol=atol)


def test_radar_minmax_is_per_cube():
    """Two cubes 1000x apart: each map spans [0, 1] on its own and equals
    the cube's map alone; a min-max over the batch would squash the first."""
    c = cubes(np.random.default_rng(4), 2, scales=(1.0, 1000.0))
    ra, rv = radar.process_batch(c, device="cpu")
    jra, jrv = jradar.process_batch(c)
    for i in range(2):
        for got, want in ((ra[i], jra[i]), (rv[i], jrv[i])):
            assert got.min() == 0.0
            assert got.max() == pytest.approx(1.0, abs=1e-6)
            np.testing.assert_allclose(got, want, rtol=0, atol=RADAR_TOL)
        single = radar.process_file(c[i], device="cpu")
        np.testing.assert_allclose(ra[i], single[0], rtol=0, atol=RADAR_TOL)
        np.testing.assert_allclose(rv[i], single[1], rtol=0, atol=RADAR_TOL)


def test_radar_process_scenario_matches_jax(tmp_path):
    raw_cubes = cubes(np.random.default_rng(5), 3)
    for name in ("jax", "port"):
        raw = tmp_path / name / "unit1" / "radar_data"
        raw.mkdir(parents=True)
        for i, c in enumerate(raw_cubes):
            np.save(raw / f"radar_{i}.npy", c)
    want = jradar.process_scenario(str(tmp_path / "jax/unit1/radar_data"),
                                   batch_size=2)
    got = radar.process_scenario(str(tmp_path / "port/unit1/radar_data"),
                                 batch_size=2, device="cpu")
    assert got == want == [f"radar_{i}.npy" for i in range(3)]
    for kind in ("ang", "vel"):
        for f in got:
            a = np.load(tmp_path / "port/unit1" / f"radar_data_{kind}" / f)
            b = np.load(tmp_path / "jax/unit1" / f"radar_data_{kind}" / f)
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=RADAR_TOL)


# -- LiDAR --------------------------------------------------------------------

def scene(rng, n=300, offset=(0.0, 0.0, 0.0)):
    return rng.uniform(-20, 20, size=(n, 3)) + np.asarray(offset)


@pytest.mark.parametrize("block", [32, 2048])
def test_nearest_neighbors_cuda_matches_jax_and_kdtree(block):
    rng = np.random.default_rng(6)
    q, pts = rng.normal(size=(100, 3)), rng.normal(size=(300, 3))
    got = LF.nearest_neighbors_cuda(q, pts, block=block, device="cpu")
    want = JLF.nearest_neighbors_tpu(q, pts, block=block)
    kd = LF.nearest_neighbors_kdtree(q, pts)
    assert got.shape == (100,)
    np.testing.assert_array_equal(pts[got], pts[want])
    np.testing.assert_array_equal(pts[got], pts[kd])


def test_nearest_neighbors_cuda_at_50_m_matches_kdtree():
    """Jittered copies of a cloud ~50 m from the origin: the difference-
    square form finds the k-d tree's neighbours (the |q|² + |p|² - 2 q·p
    form errs by the order of the jitter's square here)."""
    rng = np.random.default_rng(7)
    pts = scene(rng, 2000, offset=(-50.0, -30.0, 0.0))
    q = pts + rng.normal(scale=0.01, size=pts.shape)
    got = LF.nearest_neighbors_cuda(q, pts, block=256, device="cpu")
    kd = LF.nearest_neighbors_kdtree(q, pts)
    np.testing.assert_array_equal(pts[got], pts[kd])


def frames_with_car(rng, n_frames=4):
    static = scene(rng)
    frames = [static + rng.normal(scale=0.01, size=static.shape)
              for _ in range(n_frames)]
    car = np.array([[5.0, 5.0, 1.0]]) + rng.normal(scale=0.05, size=(30, 3))
    frames[-1] = np.vstack([frames[-1], car + 50.0])
    return frames


@pytest.mark.parametrize("backend", ["cuda", "native", "kdtree"])
def test_background_and_filter_equal_jax(backend):
    frames = frames_with_car(np.random.default_rng(8))
    bg = LF.build_background(frames[:3], 100, backend, device="cpu")
    want_bg = JLF.build_background(frames[:3], 100, JAX_BACKEND[backend])
    np.testing.assert_array_equal(bg, want_bg)
    got = LF.filter_frame(frames[3], bg, backend, device="cpu")
    want = JLF.filter_frame(frames[3], want_bg, JAX_BACKEND[backend])
    np.testing.assert_array_equal(got, want)
    assert len(got) <= 40 and (got[:, 0] > 40).all()


@pytest.mark.parametrize("backend", ["cuda", "kdtree"])
def test_lidar_process_scenario_same_bytes_as_jax(tmp_path, backend):
    src = tmp_path / "scenario31" / "lidar_data"
    src.mkdir(parents=True)
    for i, f in enumerate(frames_with_car(np.random.default_rng(9))):
        ply.write_points(src / f"{i}.ply", f)
    outs = {}
    for name, module, b in (("port", LF, backend),
                            ("jax", JLF, JAX_BACKEND[backend])):
        dst = tmp_path / name
        kw = {"device": "cpu"} if name == "port" else {}
        module.process_scenario([str(src)], [str(dst / "filtered")],
                                "scenario31", str(dst / "bg.ply"), b,
                                min_points=100, **kw)
        outs[name] = {f: (dst / "filtered" / f).read_bytes()
                      for f in sorted(os.listdir(dst / "filtered"))}
        outs[name]["bg"] = (dst / "bg.ply").read_bytes()
    assert len(outs["port"]) == 5 and outs["port"] == outs["jax"]


def test_lidar_unknown_backend_raises(tmp_path):
    with pytest.raises(ValueError, match="backend"):
        LF.process_scenario([str(tmp_path)], [str(tmp_path)], "scenario31",
                            backend="tpu")


def test_lidar_cli_on_cpu(tmp_path, monkeypatch):
    monkeypatch.setitem(LF.SCENARIO_MIN_POINTS, "scenario32", 100)
    src = tmp_path / "scenario32" / "unit1" / "lidar_data"
    src.mkdir(parents=True)
    for i, f in enumerate(frames_with_car(np.random.default_rng(10))):
        ply.write_points(src / f"{i}.ply", f)
    assert LF.main(["scenario32", str(src), "--device", "cpu"]) == 0
    assert sorted(os.listdir(tmp_path / "scenario32" / "unit1"
                             / "lidar_data_filtered")) == [
        f"{i}.ply" for i in range(4)]


@pytest.mark.parametrize("module,argv", [
    (radar, ["radar_data"]), (LF, ["scenario31", "lidar_data"])])
def test_preprocess_clis_default_to_cuda(monkeypatch, tmp_path, module,
                                         argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    (tmp_path / argv[-1]).mkdir()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)


# -- the augmentation writers -------------------------------------------------

def both_dirs(tmp_path):
    return tmp_path / "port", tmp_path / "jax"


def dir_bytes(d):
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d))}


def test_augment_images_byte_equal_jax(tmp_path):
    rng = np.random.default_rng(11)
    src = tmp_path / "camera_data"
    src.mkdir()
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (24, 40, 3), dtype=np.uint8),
                        "RGB").save(src / f"scenario31_{i}.jpg")
    port, jax_dir = both_dirs(tmp_path)
    assert augment.augment_image_dir(str(src), str(port), seed=3) == 2
    assert jaug.augment_image_dir(str(src), str(jax_dir), seed=3) == 2
    got = dir_bytes(port)
    assert len(got) == 14 and got == dir_bytes(jax_dir)


def test_augment_lidar_byte_equal_jax(tmp_path):
    rng = np.random.default_rng(12)
    src = tmp_path / "lidar_data"
    src.mkdir()
    for i in range(2):
        ply.write_points(src / f"{i}.ply", rng.uniform(-40, 10, (50, 3)))
    port, jax_dir = both_dirs(tmp_path)
    assert augment.augment_lidar_dir(str(src), str(port), seed=4) == 2
    assert jaug.augment_lidar_dir(str(src), str(jax_dir), seed=4) == 2
    got = dir_bytes(port)
    assert sorted(got) == ["0_1.ply", "0_2.ply", "1_1.ply", "1_2.ply"]
    assert got == dir_bytes(jax_dir)


def test_augment_radar_byte_equal_jax(tmp_path):
    maps = np.random.default_rng(13).uniform(0, 1, (2, 2, 16, 16)).astype(
        np.float32)
    for name in ("port", "jax"):
        for k, kind in enumerate(("ang", "vel")):
            d = tmp_path / name / f"radar_data_{kind}"
            d.mkdir(parents=True)
            for i in range(2):
                np.save(d / f"{i}.npy", maps[k, i])
    for name, module in (("port", augment), ("jax", jaug)):
        d = tmp_path / name
        assert module.augment_radar_dirs(str(d / "radar_data_ang"),
                                         str(d / "radar_data_vel"),
                                         seed=5) == 2
    for kind in ("ang", "vel"):
        got = dir_bytes(tmp_path / "port" / f"radar_data_{kind}_aug")
        assert len(got) == 2
        assert got == dir_bytes(tmp_path / "jax" / f"radar_data_{kind}_aug")


def test_augment_cli_writes_as_jax(tmp_path):
    src = tmp_path / "lidar_data"
    src.mkdir()
    ply.write_points(src / "7.ply",
                     np.random.default_rng(14).uniform(-5, 5, (20, 3)))
    assert augment.main(["lidar", str(src), "--dst",
                         str(tmp_path / "port"), "--seed", "2"]) == 0
    assert jaug.main(["lidar", str(src), "--dst", str(tmp_path / "jax"),
                      "--seed", "2"]) == 0
    assert dir_bytes(tmp_path / "port") == dir_bytes(tmp_path / "jax")


# -- the CSV writers ----------------------------------------------------------

def raw_tree(root, rng, scen="scenario32", ids=range(12, 40, 2)):
    """The raw layout create_root_csv reads (as tests/test_preprocess.py
    writes it)."""
    u1 = os.path.join(root, scen, "unit1")
    for sub in ("camera_data", "radar_data", "lidar_data", "mmWave_data",
                "GPS_data"):
        os.makedirs(os.path.join(u1, sub), exist_ok=True)
    os.makedirs(os.path.join(root, scen, "unit2", "GPS_data"), exist_ok=True)
    for i in ids:
        for sub, name in (("camera_data", f"cam_{i}.jpg"),
                          ("radar_data", f"radar_{i}.npy"),
                          ("lidar_data", f"lidar_{i}.ply")):
            open(os.path.join(u1, sub, name), "w").close()
        with open(os.path.join(u1, "mmWave_data", f"pwr_{i}.txt"), "w") as f:
            # mixed widths: the string max is not always the numeric max
            f.write("\n".join(f"{v:.{1 + j % 4}f}" for j, v in
                              enumerate(rng.uniform(0, 12, 64))))
    for i in range(0, 60, 6):
        with open(os.path.join(root, scen, "unit2", "GPS_data",
                               f"gps_{i}.txt"), "w") as f:
            f.write("33.42 -111.93")


@pytest.mark.parametrize("seq_len,pred_len", [(3, 1), (2, 3)])
def test_root_csv_byte_equal_jax(tmp_path, seq_len, pred_len):
    raw_tree(str(tmp_path), np.random.default_rng(15))
    n = csv_builder.create_root_csv(str(tmp_path), "port.csv", seq_len,
                                    pred_len, ["scenario32"])
    m = jcsv.create_root_csv(str(tmp_path), "jax.csv", seq_len, pred_len,
                             ["scenario32"])
    assert n == m > 0
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "jax.csv").read_bytes()


def test_beam_label_keeps_the_string_max(tmp_path):
    with open(tmp_path / "p.txt", "w") as f:
        f.write("9.5\n10.25\n3.0\n")
    assert csv_builder.get_beam_label(["p.txt"], str(tmp_path)) == "1"
    assert csv_builder.get_beam_label(["p.txt"], str(tmp_path)) == \
        jcsv.get_beam_label(["p.txt"], str(tmp_path))


def test_scenario_csv_byte_equal_jax(tmp_path):
    raw_tree(str(tmp_path), np.random.default_rng(16))
    jcsv.create_root_csv(str(tmp_path), "dev.csv", 3, 1, ["scenario32"])
    for keyword in ("scenario32", "scenario33"):
        n = csv_builder.create_scenario_csv(
            str(tmp_path / "dev.csv"), str(tmp_path / f"port_{keyword}"),
            keyword)
        m = jcsv.create_scenario_csv(
            str(tmp_path / "dev.csv"), str(tmp_path / f"jax_{keyword}"),
            keyword)
        assert n == m and (n > 0) == (keyword == "scenario32")
        assert (tmp_path / f"port_{keyword}.csv").read_bytes() == \
            (tmp_path / f"jax_{keyword}.csv").read_bytes()
    with open(tmp_path / "port_scenario32.csv", newline="") as f:
        assert next(csv.reader(f)) == csv_builder.create_row_head(3, 1)
