"""ctypes bindings for the native data-loader core (``native_loader.cc``):
own copy of ``deepsense6g_tii_tpu/runtime/native.py`` with the same entry
points.

The library is host C++ (PLY parse, BEV histogram, threaded batch PLY->BEV,
a 3-D k-d tree).  It is built at first use, never at import, with
``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into
``build/native/native_loader-<hash>.so`` at the root of the checkout (a
per-user cache for an installed package, as ``ops/_build.py`` places the
CUDA kernels), keyed by a hash of the source and the flags.  Each process
compiles to a name of its own and renames it into place, so processes
building at once (test workers) each end with a loadable library.

Without ``g++``, or with ``DEEPSENSE_DISABLE_NATIVE`` set (read at every
call), every entry point gives None (``KdTree`` raises) and callers take
the Python path (``utils/ply.py`` + ``data/features.py::lidar_to_bev_np``),
which gives the same values bit for bit: native is a throughput upgrade,
not a dependency.  A compile error with ``g++`` present raises with the
compiler's output.  ``CALLS`` counts the native calls by entry point (a
batch call counts its files), so a caller can see which path ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from ..ops._build import build_dir

SOURCE = Path(__file__).resolve().parent / "native_loader.cc"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

CALLS: Dict[str, int] = {}
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_NO_TOOLCHAIN = False


def _count(name: str, n: int = 1) -> None:
    with _LOCK:
        CALLS[name] = CALLS.get(name, 0) + n


def reset_calls() -> None:
    with _LOCK:
        CALLS.clear()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + b"\0"
                       + SOURCE.read_bytes())
    return build_dir("native") / f"native_loader-{h.hexdigest()[:16]}.so"


def _compile(gxx: str) -> Path:
    """The library, compiled unless it is there.  The output goes to a
    name of this process's and is renamed into place, so concurrent
    builders never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([gxx, *FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ply_count.restype = ctypes.c_int64
    lib.ply_count.argtypes = [ctypes.c_char_p]
    lib.ply_read.restype = ctypes.c_int64
    lib.ply_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                             ctypes.c_int64]
    lib.bev_histogram.restype = None
    lib.bev_histogram.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_void_p, ctypes.c_void_p]
    lib.batch_ply_to_bev.restype = ctypes.c_int64
    lib.batch_ply_to_bev.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_int]
    lib.kdtree_build.restype = ctypes.c_void_p
    lib.kdtree_build.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.kdtree_free.restype = None
    lib.kdtree_free.argtypes = [ctypes.c_void_p]
    lib.kdtree_nearest.restype = None
    lib.kdtree_nearest.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int64, ctypes.c_void_p,
                                   ctypes.c_int]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled library (built at the first call), or None when
    ``DEEPSENSE_DISABLE_NATIVE`` is set or there is no ``g++``."""
    global _LIB, _NO_TOOLCHAIN
    if os.environ.get("DEEPSENSE_DISABLE_NATIVE"):
        return None
    if _LIB is not None or _NO_TOOLCHAIN:
        return _LIB
    with _LOCK:
        if _LIB is None and not _NO_TOOLCHAIN:
            gxx = shutil.which("g++")
            if gxx is None:
                _NO_TOOLCHAIN = True
            else:
                _LIB = _bind(ctypes.CDLL(str(_compile(gxx))))
    return _LIB


def available() -> bool:
    return get_lib() is not None


def _xyz(points: np.ndarray) -> np.ndarray:
    """The (N, 3) xyz columns as contiguous float64, the layout the C side
    reads."""
    points = np.asarray(points)
    if points.ndim != 2 or points.shape[1] < 3:
        raise ValueError(f"points must be (N, >=3), got {points.shape}")
    return np.ascontiguousarray(points[:, :3], np.float64)


def read_ply(path: str) -> Optional[np.ndarray]:
    """(N, 3) float64 points via the native parser; None when unavailable or
    on parse failure (the caller falls back to utils.ply)."""
    lib = get_lib()
    if lib is None:
        return None
    _count("read_ply")
    n = lib.ply_count(path.encode())
    if n < 0:
        return None
    out = np.empty((n, 3), np.float64)
    got = lib.ply_read(path.encode(), out.ctypes.data, n)
    return out if got == n else None


def bev_histogram(points: np.ndarray,
                  fov: Sequence[float]) -> Optional[np.ndarray]:
    """The (256, 256) float32 BEV map of ``points`` (clip 5 a pixel, /5;
    ``data/features.py::lidar_to_bev_np``'s bins), or None when
    unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    _count("bev_histogram")
    pts = _xyz(points)
    fov_arr = np.ascontiguousarray(fov, np.float32)
    if fov_arr.shape != (4,):
        raise ValueError(f"fov must hold 4 numbers, got {fov_arr.shape}")
    out = np.empty((256, 256), np.float32)
    lib.bev_histogram(pts.ctypes.data, pts.shape[0], fov_arr.ctypes.data,
                      out.ctypes.data)
    return out


def batch_ply_to_bev(paths: Sequence[str], fovs: np.ndarray,
                     n_threads: int = 8) -> Optional[np.ndarray]:
    """Parse + project a batch of PLY files in native threads.  Returns
    (len(paths), 256, 256) float32, or None when unavailable or when any
    file fails to parse."""
    lib = get_lib()
    if lib is None:
        return None
    fovs = np.ascontiguousarray(fovs, np.float32)
    if fovs.shape != (len(paths), 4):
        raise ValueError(f"fovs must be ({len(paths)}, 4), got {fovs.shape}")
    _count("batch_ply_to_bev", len(paths))
    blob = b"".join(p.encode() + b"\0" for p in paths)
    out = np.empty((len(paths), 256, 256), np.float32)
    failures = lib.batch_ply_to_bev(blob, len(paths), fovs.ctypes.data,
                                    out.ctypes.data, n_threads)
    return None if failures else out


class KdTree:
    """Native 3-D k-d tree (nearest neighbour only)."""

    def __init__(self, points: np.ndarray):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        _count("kdtree_build")
        self._lib = lib
        self._pts = _xyz(points)
        self._handle = lib.kdtree_build(self._pts.ctypes.data,
                                        self._pts.shape[0])

    def nearest(self, queries: np.ndarray, n_threads: int = 8) -> np.ndarray:
        """The index of each query's nearest point, (m,) int32."""
        _count("kdtree_nearest")
        q = _xyz(queries)
        out = np.empty((q.shape[0],), np.int32)
        self._lib.kdtree_nearest(self._handle, q.ctypes.data, q.shape[0],
                                 out.ctypes.data, n_threads)
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.kdtree_free(self._handle)
            self._handle = None
