"""The port's native data-loader core (deepsense6g_tii_tpu_torch/runtime/):
PLY parse, BEV histogram, the threaded batch path and the k-d tree, held
bit for bit to the Python path (the port's utils/ply.py and
lidar_to_bev_np, and the JAX package's); the dataset's samples with native
on and off; the build's contract (no toolchain or DEEPSENSE_DISABLE_NATIVE
gives the Python path, a compile error raises, processes building at once
each end with a loadable library).  The JAX package's native loader is
never built here: its build races under xdist (ROADMAP.md Queue 3).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from deepsense6g_tii_tpu.data import features as jF
from deepsense6g_tii_tpu.utils import ply as jply
from deepsense6g_tii_tpu_torch.config import DEFAULT_FOV, GlobalConfig
from deepsense6g_tii_tpu_torch.data import dataset as pds
from deepsense6g_tii_tpu_torch.data import features as F
from deepsense6g_tii_tpu_torch.runtime import native
from deepsense6g_tii_tpu_torch.utils import ply
from deepsense6g_tii_tpu_torch.utils.demo_data import make_demo_root
from test_torch_modules import two_torch_threads  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def lib(monkeypatch):
    """The native library, built (g++ is part of the test environment)."""
    monkeypatch.delenv("DEEPSENSE_DISABLE_NATIVE", raising=False)
    assert native.available()
    return native


@pytest.mark.parametrize("ascii_", [True, False])
def test_read_ply_equals_python(lib, tmp_path, ascii_):
    pts = np.random.default_rng(1).normal(size=(500, 3)) * 30
    p = str(tmp_path / "c.ply")
    ply.write_points(p, pts, ascii=ascii_)
    got = lib.read_ply(p)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, ply.read_points(p))
    np.testing.assert_array_equal(got, jply.read_points(p))


def test_read_ply_float32_vertices_with_extra_properties(lib, tmp_path):
    rng = np.random.default_rng(2)
    rows = np.zeros(10, dtype=[("x", "<f4"), ("i", "u1"), ("y", "<f4"),
                               ("z", "<f4"), ("t", "<f8")])
    for k in ("x", "y", "z"):
        rows[k] = rng.normal(size=10)
    p = tmp_path / "f32.ply"
    p.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 10\n"
                  b"property float x\nproperty uchar i\nproperty float y\n"
                  b"property float z\nproperty double t\nend_header\n"
                  + rows.tobytes())
    got = lib.read_ply(str(p))
    np.testing.assert_array_equal(got, ply.read_points(str(p)))
    np.testing.assert_array_equal(
        got, np.stack([rows[k] for k in "xyz"], 1).astype(np.float64))


@pytest.mark.parametrize("content", [b"not a ply",
                                     b"ply\nformat ascii 1.0\nelement vertex"
                                     b" 3\nproperty double x\nend_header\n"])
def test_bad_file_returns_none(lib, tmp_path, content):
    p = tmp_path / "bad.ply"
    p.write_bytes(content)
    assert lib.read_ply(str(p)) is None
    assert lib.batch_ply_to_bev([str(p)], np.asarray([DEFAULT_FOV])) is None


def _cloud(seed, n, fov):
    """Points over and around ``fov``, with some exactly on its edges and
    on interior bin edges."""
    x_lo, x_hi, y_lo, y_hi = fov
    rng = np.random.default_rng(seed)
    pts = rng.uniform([x_lo - 5, y_lo - 5, -3], [x_hi + 5, y_hi + 5, 3],
                      size=(n, 3))
    xs = np.linspace(x_lo, x_hi, 257)
    ys = np.linspace(y_lo, y_hi, 257)
    pts[:6, :2] = [[x_hi, y_hi], [x_lo, y_lo], [x_hi, y_lo], [x_lo, y_hi],
                   [xs[100], ys[7]], [xs[255], ys[256]]]
    return pts


@pytest.mark.parametrize("scenario", ["scenario31", "scenario32",
                                      "scenario33", "default"])
def test_bev_equals_python(lib, scenario):
    fov = F.fov_for_address(scenario, True)
    pts = _cloud(3, 20000, fov)
    got = lib.bev_histogram(pts, fov)
    np.testing.assert_array_equal(got, F.lidar_to_bev_np(pts, fov)[0])
    np.testing.assert_array_equal(got, jF.lidar_to_bev_np(pts, fov)[0])


def test_bev_edge_inclusive(lib):
    got = lib.bev_histogram(np.array([[0.0, 50.0, 1.0]] * 7), DEFAULT_FOV)
    assert got[255, 255] == np.float32(1.0)        # clipped at 5 a pixel
    assert got.sum() == np.float32(1.0)
    one = lib.bev_histogram(np.array([[-50.0, -50.0, 0.0]]), DEFAULT_FOV)
    assert one[0, 0] == np.float32(0.2) and one.sum() == np.float32(0.2)


def test_batch_equals_singles(lib, tmp_path):
    paths, fovs = [], []
    for i, s in enumerate(["scenario31", "scenario32", "scenario33",
                           "scenario34", "default", "scenario31"]):
        fov = F.fov_for_address(s, True)
        p = str(tmp_path / f"{i}.ply")
        ply.write_points(p, _cloud(i, 1500, fov), ascii=i % 2 == 0)
        paths.append(p)
        fovs.append(fov)
    native.reset_calls()
    got = lib.batch_ply_to_bev(paths, np.asarray(fovs), n_threads=4)
    assert native.CALLS == {"batch_ply_to_bev": 6}
    for g, p, fov in zip(got, paths, fovs):
        np.testing.assert_array_equal(g, lib.bev_histogram(lib.read_ply(p),
                                                           fov))
        np.testing.assert_array_equal(
            g, F.lidar_to_bev_np(ply.read_points(p), fov)[0])
    with pytest.raises(ValueError, match="fovs"):
        lib.batch_ply_to_bev(paths, np.asarray(fovs[:2]))


@pytest.mark.parametrize("n", [1, 2, 3000])
def test_kdtree_nearest_equals_brute_force(lib, n):
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 3))
    queries = np.concatenate([rng.normal(size=(400, 3)), pts[:5]])
    got = lib.KdTree(pts).nearest(queries, n_threads=4)
    d2 = ((queries[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    # indices may differ on exact ties: compare the distances
    np.testing.assert_array_equal(d2[np.arange(len(queries)), got],
                                  d2.min(1))
    with pytest.raises(ValueError, match="points"):
        lib.KdTree(pts[:, :2])


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    return make_demo_root(str(tmp_path_factory.mktemp("demo")), n_train=2,
                          n_adapt=1, n_test=1, seq_len=2) + "/Multi_Modal/"


def test_dataset_samples_identical_native_on_and_off(demo, monkeypatch,
                                                     lib):
    ds = pds.BeamDataset(demo, "ml_challenge_dev_multi_modal.csv",
                         GlobalConfig(seq_len=2))
    native.reset_calls()
    on = [ds[i] for i in range(len(ds))]
    assert native.CALLS == {"batch_ply_to_bev": 2 * len(ds)}
    monkeypatch.setenv("DEEPSENSE_DISABLE_NATIVE", "1")
    assert not native.available()
    native.reset_calls()
    off = [ds[i] for i in range(len(ds))]
    assert native.CALLS == {}
    for a, b in zip(on, off):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_disabled_gives_none_everywhere(monkeypatch, tmp_path):
    monkeypatch.setenv("DEEPSENSE_DISABLE_NATIVE", "1")
    p = str(tmp_path / "c.ply")
    ply.write_points(p, np.ones((3, 3)))
    assert native.get_lib() is None
    assert native.read_ply(p) is None
    assert native.bev_histogram(np.ones((3, 3)), DEFAULT_FOV) is None
    assert native.batch_ply_to_bev([p], np.asarray([DEFAULT_FOV])) is None
    with pytest.raises(RuntimeError, match="unavailable"):
        native.KdTree(np.ones((3, 3)))


def test_no_toolchain_takes_the_python_path(monkeypatch, demo):
    monkeypatch.delenv("DEEPSENSE_DISABLE_NATIVE", raising=False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_NO_TOOLCHAIN", False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    ds = pds.BeamDataset(demo, "ml_challenge_dev_multi_modal.csv",
                         GlobalConfig(seq_len=2))
    assert ds[0]["lidar"].shape == (2, 256, 256, 1)


def test_compile_error_raises_with_the_compiler_output(monkeypatch,
                                                       tmp_path):
    bad = tmp_path / "broken.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.delenv("DEEPSENSE_DISABLE_NATIVE", raising=False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_NO_TOOLCHAIN", False)
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "build_dir", lambda sub: tmp_path / sub)
    for _ in range(2):          # not cached as "unavailable"
        with pytest.raises(RuntimeError, match="broken.cc.*error"):
            native.get_lib()
    assert not list((tmp_path / "native").iterdir())    # no temp file left


_BUILDER = """
import sys, time
from pathlib import Path
import numpy as np
from deepsense6g_tii_tpu_torch.runtime import native
native.build_dir = lambda sub: Path(sys.argv[1]) / sub
while time.time() < float(sys.argv[2]):
    pass
pts = np.array([[-10.0, 0.0, 0.0]])
print(native.library_path().name,
      native.bev_histogram(pts, (-50.0, 0.0, -50.0, 50.0)).sum())
"""


BUILDERS = 6        # as many as the tier-1 run's xdist workers


def test_concurrent_builds_each_load(tmp_path):
    """Six processes start the build into one empty directory at the same
    moment: each loads a whole library, and no temporary file is left.
    (With one temporary name shared by all, most of them fail here.)"""
    import time
    start = f"{time.time() + 3.0}"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("DEEPSENSE_DISABLE_NATIVE", None)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILDER,
                               str(tmp_path), start], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(BUILDERS)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * BUILDERS, outs
    name = native.library_path().name
    assert [o[0].split() for o in outs] == [[name, "0.2"]] * BUILDERS
    assert sorted(os.listdir(tmp_path / "native")) == [name]
