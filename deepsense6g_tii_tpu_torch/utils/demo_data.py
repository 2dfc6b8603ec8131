"""Synthetic on-disk demo dataset in the DeepSense 6G layout (own copy of
``deepsense6g_tii_tpu/utils/demo_data.py``).

Lets anyone run the whole training path — dataset assembly, features,
training, validation, test CSV export — without the challenge dataset:
camera JPEGs, ascii .ply LiDAR clouds, radar .npy maps, GPS .txt files and
the index CSVs, laid out as the data path expects.  With the same seed and
the default frame size the tree is the JAX package's, file for file.

    python -m deepsense6g_tii_tpu_torch.utils.demo_data ROOT [--n_train 8]
"""

import csv
import os

import numpy as np

from . import image, ply


def make_fake_dataset_tree(root, scenarios=("scenario31", "scenario32"),
                           n_samples=4, seq_len=5, seed=0,
                           frame_shape=(32, 48)):
    """Creates a DeepSense-layout tree and its index CSV under ``root``;
    returns the CSV's name.  Camera frames are random (H, W) =
    ``frame_shape`` RGB images.

    Layout per scenario:
      unit1/camera_data/<scenario>_<id>.jpg        (enhanced camera)
      unit1/lidar_data/<id>.ply
      unit1/radar_data_{ang,vel}/<id>.npy
      unit2/GPS_data/<id>.txt ; unit1/GPS_data/gps_loc.txt
    """
    rng = np.random.default_rng(seed)
    rows = []
    header = ["index"]
    for t in range(1, seq_len + 1):
        header += [f"unit1_rgb_{t}", f"unit1_lidar_{t}", f"unit1_radar_{t}"]
    header += ["unit2_loc_1", "unit2_loc_2", "unit1_loc", "unit1_beam"]

    for s in scenarios:
        base = os.path.join(root, s, "unit1")
        for sub in ("camera_data", "lidar_data", "radar_data_ang",
                    "radar_data_vel"):
            os.makedirs(os.path.join(base, sub), exist_ok=True)
        os.makedirs(os.path.join(root, s, "unit2", "GPS_data"), exist_ok=True)
        os.makedirs(os.path.join(base, "GPS_data"), exist_ok=True)

        bs_path = f"./{s}/unit1/GPS_data/gps_loc.txt"
        np.savetxt(os.path.join(root, bs_path[2:]),
                   [33.42 + rng.normal(scale=1e-5), -111.93])

        for i in range(n_samples):
            row = [len(rows)]
            for t in range(1, seq_len + 1):
                fid = i * seq_len + t
                cam = f"./{s}/unit1/camera_data/{s}_{fid}.jpg"
                image.write_jpeg(
                    os.path.join(root, cam[2:]),
                    rng.integers(0, 255, (*frame_shape, 3), dtype=np.uint8))
                lid = f"./{s}/unit1/lidar_data/{fid}.ply"
                pts = rng.uniform(-40, 10, size=(200, 3))
                ply.write_points(os.path.join(root, lid[2:]), pts)
                rad = f"./{s}/unit1/radar_data/{fid}.npy"
                for kind in ("ang", "vel"):
                    np.save(os.path.join(
                        root, s, "unit1", f"radar_data_{kind}", f"{fid}.npy"),
                        rng.uniform(0, 1, (256, 256)).astype(np.float32))
                row += [cam, lid, rad]
            g1 = f"./{s}/unit2/GPS_data/{i}_1.txt"
            g2 = f"./{s}/unit2/GPS_data/{i}_2.txt"
            for g in (g1, g2):
                np.savetxt(os.path.join(root, g[2:]),
                           [33.42 + rng.normal(scale=1e-4),
                            -111.93 + rng.normal(scale=1e-4)])
            row += [g1, g2, bs_path, int(rng.integers(1, 65))]
            rows.append(row)

    csv_name = "fake_index.csv"
    with open(os.path.join(root, csv_name), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    return csv_name


def make_demo_root(root, n_train=3, n_adapt=2, n_test=2, seq_len=2, seed=0,
                   frame_shape=(32, 48)):
    """Builds the three-split data_root the training CLI expects:
    Multi_Modal (development), Adaptation_dataset_multi_modal and
    Multi_Modal_Test, each with its index CSV under the challenge's name and
    ``n_*`` samples in each of its two scenarios.  Returns ``root``.
    """
    splits = [
        ("Multi_Modal", "ml_challenge_dev_multi_modal.csv", n_train, 0),
        ("Adaptation_dataset_multi_modal",
         "ml_challenge_data_adaptation_multi_modal.csv", n_adapt, 1),
        ("Multi_Modal_Test", "ml_challenge_test_multi_modal.csv", n_test, 2),
    ]
    for sub, csv_name, n, seed_off in splits:
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        tmp = make_fake_dataset_tree(d + os.sep, n_samples=n,
                                     seq_len=seq_len, seed=seed + seed_off,
                                     frame_shape=frame_shape)
        os.replace(os.path.join(d, tmp), os.path.join(d, csv_name))
    return root


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("root")
    p.add_argument("--n_train", type=int, default=8)
    p.add_argument("--n_adapt", type=int, default=4)
    p.add_argument("--n_test", type=int, default=4)
    p.add_argument("--seq_len", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frame_shape", type=int, nargs=2, default=(540, 960),
                   metavar=("H", "W"))
    a = p.parse_args(argv)
    make_demo_root(a.root, a.n_train, a.n_adapt, a.n_test, a.seq_len,
                   a.seed, tuple(a.frame_shape))
    print(a.root)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
