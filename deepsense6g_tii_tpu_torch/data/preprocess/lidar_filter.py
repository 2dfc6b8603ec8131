"""LiDAR static-background filtering (``deepsense6g_tii_tpu/data/
preprocess/lidar_filter.py``): the original pipeline's two passes, with its
numerics.

  pass 1 (background): over the frames with >= min_points, find each
    background point's 3-D nearest neighbour in the frame and keep the
    midpoint iff their 2-D (x, y) distance is below f(r) = 0.3 + 4.7 *
    (r / 30)^4, r the point's 2-D range;
  pass 2 (filter): drop every frame point whose 2-D distance to its 3-D
    nearest neighbour in the background is below f(r).

Nearest-neighbour backends: ``cuda`` (the default; a blocked brute force on
the card, :func:`nearest_neighbors_cuda`), ``native`` (the port's C++ k-d
tree, ``runtime/native.py``) and ``kdtree`` (scipy's cKDTree).  They find
the same neighbouring points; an index may differ only where two points lie
at the same distance.

    python -m deepsense6g_tii_tpu_torch.data.preprocess.lidar_filter \\
        scenario32 ROOT/scenario32/unit1/lidar_data [--backend cuda] \\
        [--device cuda]

The ``cuda`` backend takes ``--device`` (``cuda`` by default, which raises
without it; ``cpu`` runs the same search on the host).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from ...utils import ply
from ...utils.device import resolve_device

FILTER_DISTANCE_MIN = 0.3
FILTER_DISTANCE_MAX = 5.0
LIDAR_DISTANCE_CST = 30.0
SCENARIO_MIN_POINTS = {"scenario31": 16400, "scenario32": 18000,
                       "scenario33": 18000, "scenario34": 18600}
BACKENDS = ("cuda", "native", "kdtree")
NN_BLOCK = 2048


def filter_threshold(points: np.ndarray) -> np.ndarray:
    """f(r) per point, r its 2-D range."""
    r = np.sqrt(points[:, 0] ** 2 + points[:, 1] ** 2)
    return FILTER_DISTANCE_MIN + (FILTER_DISTANCE_MAX - FILTER_DISTANCE_MIN) \
        * (r / LIDAR_DISTANCE_CST) ** 4


def nearest_neighbors_kdtree(queries: np.ndarray,
                             points: np.ndarray) -> np.ndarray:
    """3-D nearest neighbour indices of ``queries`` in ``points`` (scipy)."""
    from scipy.spatial import cKDTree
    _, idx = cKDTree(points).query(queries, k=1, workers=-1)
    return np.asarray(idx)


def nearest_neighbors_cuda(queries: np.ndarray, points: np.ndarray,
                           block: int = NN_BLOCK, device="cuda"
                           ) -> np.ndarray:
    """3-D nearest neighbour indices of ``queries`` in ``points`` by a
    blocked brute force on ``device``: ``block`` queries at a time against
    every point, in float32, the first index on ties.

    The squared distance is summed one coordinate at a time in the
    difference-square form, ((qx-px)² + (qy-py)²) + (qz-pz)², never as
    |q|² + |p|² - 2 q·p (``torch.cdist``'s product form past 25 rows): at
    coordinates of ~50 m that form errs by ~1e-4 m², the squared spacing of
    jittered static points, and picks other neighbours.  The points and
    queries cross to the device once a call; only the indices come back."""
    import torch
    dev = resolve_device(device)
    pts = torch.from_numpy(np.ascontiguousarray(
        points, np.float32)[:, :3].T.copy()).to(dev)        # (3, N)
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    out = torch.empty(q.shape[0], dtype=torch.int64, device=dev)
    for i in range(0, q.shape[0], block):
        qb = q[i:i + block]
        d2 = (qb[:, 0:1] - pts[0]).square_()
        for c in (1, 2):
            d2 += (qb[:, c:c + 1] - pts[c]).square_()
        out[i:i + block] = d2.argmin(dim=1)
    return out.cpu().numpy()


def _nn(queries, points, backend, device):
    if backend == "cuda":
        return nearest_neighbors_cuda(queries, points, device=device)
    if backend == "native":
        from ...runtime import native
        return native.KdTree(points).nearest(queries)
    if backend == "kdtree":
        return nearest_neighbors_kdtree(queries, points)
    raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")


def update_background(background: np.ndarray, frame: np.ndarray,
                      backend: str = "cuda", device="cuda") -> np.ndarray:
    """One background-refinement step of pass 1."""
    idx = _nn(background, frame, backend, device)
    nn = frame[idx]
    d2d = np.sqrt(((background[:, :2] - nn[:, :2]) ** 2).sum(1))
    keep = d2d < filter_threshold(background)
    return (background[keep] + nn[keep]) / 2.0


def build_background(frames: List[np.ndarray], min_points: int,
                     backend: str = "cuda", device="cuda") -> np.ndarray:
    """Pass 1: the background the frames agree on."""
    background = None
    for frame in frames:
        if frame.shape[0] < min_points:
            continue
        if background is None:
            background = frame
            continue
        background = update_background(background, frame, backend, device)
        if background.shape[0] == 0:
            break
    if background is None:
        raise ValueError(f"no frame reaches min_points={min_points}")
    return background


def filter_frame(frame: np.ndarray, background: np.ndarray,
                 backend: str = "cuda", device="cuda") -> np.ndarray:
    """Pass 2: the frame without the points within f(r) of the
    background."""
    if background.shape[0] == 0:
        return frame
    idx = _nn(frame, background, backend, device)
    nn = background[idx]
    d2d = np.sqrt(((frame[:, :2] - nn[:, :2]) ** 2).sum(1))
    return frame[d2d >= filter_threshold(frame)]


def process_scenario(lidar_dirs: List[str], out_dirs: List[str],
                     scenario: str, background_path: Optional[str] = None,
                     backend: str = "cuda",
                     min_points: Optional[int] = None,
                     device="cuda") -> np.ndarray:
    """Builds the scenario's background from the first directory's clouds
    and writes every directory's clouds, filtered, to its ``out_dirs``
    entry (the ``lidar_data_filtered/`` the data path reads); returns the
    background."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, "
                         f"got {backend!r}")
    if backend == "cuda":
        device = resolve_device(device)
    min_pts = (min_points if min_points is not None
               else SCENARIO_MIN_POINTS.get(scenario, 16000))
    first = sorted(os.listdir(lidar_dirs[0]))
    frames = [ply.read_points(os.path.join(lidar_dirs[0], f))
              for f in first if f.endswith(".ply")]
    background = build_background(frames, min_pts, backend, device)
    if background_path:
        os.makedirs(os.path.dirname(background_path), exist_ok=True)
        ply.write_points(background_path, background)

    for src, dst in zip(lidar_dirs, out_dirs):
        os.makedirs(dst, exist_ok=True)
        for f in sorted(os.listdir(src)):
            if not f.endswith(".ply"):
                continue
            cloud = ply.read_points(os.path.join(src, f))
            ply.write_points(os.path.join(dst, f),
                             filter_frame(cloud, background, backend, device))
    return background


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("scenario", help="scenario31..scenario34")
    p.add_argument("lidar_dirs", nargs="+")
    p.add_argument("--out_suffix", default="_filtered",
                   help="output dir = <src> with lidar_data -> "
                        "lidar_data<out_suffix>")
    p.add_argument("--background", default=None)
    p.add_argument("--backend", default="cuda", choices=list(BACKENDS))
    p.add_argument("--device", default="cuda",
                   help="the cuda backend's device: cuda (default) or cpu")
    a = p.parse_args(argv)
    outs = [d.rstrip("/").replace("lidar_data", "lidar_data" + a.out_suffix)
            for d in a.lidar_dirs]
    bg = process_scenario(a.lidar_dirs, outs, a.scenario, a.background,
                          a.backend, device=a.device)
    print(f"background: {bg.shape[0]} points")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
