"""CSV-indexed multi-modal dataset (``deepsense6g_tii_tpu/data/dataset.py:
27-258, 281-357``), numpy only.

Per sample: ``seq_len`` frames of (camera frame resized to the input
resolution, LiDAR .ply -> BEV histogram, radar range-angle [+
range-velocity] .npy), 2 normalised GPS samples, the scenario tag and a
Gaussian soft beam target.  Path rewriting selects the enhanced or _raw
camera, the _mask/_seg overlays, filtered LiDAR and the offline-augmented
variants; ``flip`` gives the horizontally mirrored copy.  The sample dicts
equal the JAX package's key by key, in dtype and shape: image (T, H, H, 3)
float32 0..255, lidar (T, H, H, 1), radar (T, H, H, 1|2), gps (2, 2).

The index CSV is read with the standard library's ``csv`` module; beam
labels are parsed as the JAX package's pandas types them (an int, or a
"b1_..._bP" string for ``pred_len > 1``).  A LiDAR cloud is parsed and
histogrammed by the native C++ loader (runtime/native.py) when it is
built, else in Python (utils/ply.py + features.lidar_to_bev_np); both give
the same map bit for bit.
"""

from __future__ import annotations

import csv
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import GlobalConfig
from ..runtime import native
from ..utils import image as _image
from ..utils import ply
from . import features as F


def read_index(path: str) -> Dict[str, List[str]]:
    """An index CSV as {column: [cell, ...]}, every cell a string."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {name: [r[j] for r in body] for j, name in enumerate(header)}


def _shrink_map(arr: np.ndarray, res: int) -> np.ndarray:
    """Block-mean downsample of a square on-disk map (radar .npy and BEV are
    made at 256) to ``config.input_resolution``; a no-op at 256."""
    s = arr.shape[0]
    if s == res:
        return arr
    if s % res:
        raise ValueError(f"input_resolution {res} must divide map size {s}")
    k = s // res
    return arr.reshape(res, k, res, k).mean(axis=(1, 3)).astype(arr.dtype)


def _lidar_bev(path: str, fov) -> np.ndarray:
    """A .ply cloud's (256, 256) BEV map: through the native loader when it
    is built, else utils.ply + numpy (the same map bit for bit)."""
    out = native.batch_ply_to_bev([path], np.asarray([fov]), n_threads=1)
    if out is not None:
        return out[0]
    return F.lidar_to_bev_np(ply.read_points(path), fov)[0]


def _insert_tag(path: str, tag: str, pos: int = 30) -> str:
    """The dataset layout's fixed path surgery: path[:30] + tag +
    path[30:]."""
    return path[:pos] + tag + path[pos:]


class BeamDataset:
    """Map-style dataset over one index CSV.

    ``augment`` selects offline-augmentation variants per modality: camera k
    in 0..7, lidar k in 0..2, radar k in 0..1.
    """

    def __init__(self, root: str, root_csv: str, config: GlobalConfig,
                 test: bool = False,
                 augment: Optional[Dict[str, int]] = None,
                 flip: bool = False):
        self.columns = read_index(root + root_csv)
        self.root = root
        self.config = config
        self.seq_len = config.seq_len
        self.test = test
        self.augment = augment or {"camera": 0, "lidar": 0, "radar": 0}
        self.flip = flip
        self.pos_input_normalized = self._load_gps()

    def _load_gps(self) -> np.ndarray:
        c = self.columns
        n = len(self)
        pos_ue = np.zeros((n, 2, 2))
        pos_bs = np.zeros((n, 2))
        for i in range(n):
            pos_ue[i, 0] = np.loadtxt(os.path.join(self.root,
                                                   c["unit2_loc_1"][i][2:]))
            pos_ue[i, 1] = np.loadtxt(os.path.join(self.root,
                                                   c["unit2_loc_2"][i][2:]))
            pos_bs[i] = np.loadtxt(os.path.join(self.root,
                                                c["unit1_loc"][i][2:]))
        return F.normalize_loc_np(pos_ue, pos_bs, c["unit1_loc"],
                                  angle_norm=bool(self.config.angle_norm))

    def __len__(self) -> int:
        return len(self.columns["unit1_loc"])

    # -- path selection ------------------------------------------------------

    def _camera_path(self, t: int, index: int) -> str:
        path = self.columns[f"unit1_rgb_{t}"][index]
        if self.augment["camera"] > 0:
            path = re.sub("camera_data/", "camera_data_aug/", path)
            return path[:-4] + "_" + str(self.augment["camera"]) + ".jpg"
        cfg = self.config
        if "scenario31" in path or "scenario32" in path:
            if cfg.add_mask:
                return _insert_tag(path, "_mask")
            return path          # the seg overlay is blended at load time
        if cfg.add_mask and cfg.enhanced:
            raise ValueError("mask or enhance, both are not possible")
        if cfg.add_mask:
            return _insert_tag(path, "_mask")
        if cfg.enhanced:
            return path
        return _insert_tag(path, "_raw")

    def _lidar_path(self, t: int, index: int) -> str:
        path = self.columns[f"unit1_lidar_{t}"][index]
        if self.augment["lidar"] > 0:
            path = re.sub("lidar_data/", "lidar_data_aug/", path)
            return path[:-4] + "_" + str(self.augment["lidar"]) + ".ply"
        if self.config.filtered:
            return re.sub("lidar_data/", "lidar_data_filtered/", path)
        return path

    def _radar_path(self, t: int, index: int) -> str:
        path = self.columns[f"unit1_radar_{t}"][index]
        sub = ("radar_data_ang_aug/" if self.augment["radar"] > 0
               else "radar_data_ang/")
        return re.sub("radar_data/", sub, path)

    # -- loading -------------------------------------------------------------

    def _load_image(self, rel: str) -> np.ndarray:
        cfg = self.config
        res = cfg.input_resolution
        img = _image.read_frame(self.root + rel, res)
        if (self.augment["camera"] == 0 and cfg.add_seg and not cfg.add_mask
                and ("scenario31" in rel or "scenario32" in rel)):
            seg = _image.read_frame(self.root + _insert_tag(rel, "_seg"), res)
            img = _image.blend_seg(img, seg)
        return img

    def __getitem__(self, index: int) -> Dict:
        cfg = self.config
        data: Dict = {}
        gps = self.pos_input_normalized[index].copy()
        if self.flip:
            gps[:, 1] = -gps[:, 1]
        data["gps"] = gps.astype(np.float32)

        # the scenario tag comes from the last frame's camera path
        anchor = self.columns[f"unit1_rgb_{self.seq_len}"][index]
        data["scenario"] = next(
            (s for s in ("scenario31", "scenario32", "scenario33",
                         "scenario34") if s in anchor), "")
        data["loss_weight"] = 1.0

        images, lidars, radars = [], [], []
        for t in range(1, self.seq_len + 1):
            img = self._load_image(self._camera_path(t, index))
            if self.flip:
                img = np.ascontiguousarray(np.flip(img, 1))
            images.append(img.astype(np.float32))

            radar_ang = _shrink_map(
                np.load(self.root + self._radar_path(t, index)),
                cfg.input_resolution)
            if self.flip:
                radar_ang = np.ascontiguousarray(np.flip(radar_ang, 1))
            chans = [radar_ang]
            if cfg.add_velocity:
                vel = _shrink_map(
                    np.load(self.root
                            + self._radar_path(t, index).replace("ang", "vel")),
                    cfg.input_resolution)
                if self.flip:
                    vel = np.ascontiguousarray(np.flip(vel, 1))
                chans.append(vel)
            radars.append(np.stack(chans, axis=-1).astype(np.float32))

            lidar_rel = self._lidar_path(t, index)
            fov = F.fov_for_address(lidar_rel, bool(cfg.custom_FoV_lidar))
            bev = _shrink_map(_lidar_bev(self.root + lidar_rel, fov),
                              cfg.input_resolution)
            if self.flip:
                bev = np.ascontiguousarray(np.flip(bev, 1))
            lidars.append(bev[..., np.newaxis].astype(np.float32))

        data["image"] = np.stack(images)
        data["lidar"] = np.stack(lidars)
        data["radar"] = np.stack(radars)

        if not self.test:
            raw = self.columns["unit1_beam"][index]
            if cfg.pred_len > 1:
                # multi-step labels "b1_b2_..._bP", one soft target each
                idxs = [int(x) - 1 for x in raw.split("_")]
                if len(idxs) != cfg.pred_len:
                    raise ValueError(
                        f"expected {cfg.pred_len} beam labels, got {raw!r}")
                beams = np.stack([F.soft_beam_target_np(i, cfg.num_beams)
                                  for i in idxs])
                if self.flip:
                    idxs = [cfg.num_beams - 1 - i for i in idxs]
                    beams = np.ascontiguousarray(np.flip(beams, 1))
                data["beam"] = beams.astype(np.float32)
                data["beamidx"] = np.asarray(idxs, np.int32)
            else:
                beamidx = int(raw) - 1
                beam = F.soft_beam_target_np(beamidx, cfg.num_beams)
                if self.flip:
                    beamidx = cfg.num_beams - 1 - beamidx
                    beam = np.ascontiguousarray(np.flip(beam, 0))
                data["beam"] = beam.astype(np.float32)
                data["beamidx"] = np.int32(beamidx)
        return data


class ConcatDataset:
    """torch.utils.data.ConcatDataset's indexing over map-style datasets."""

    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, index: int):
        di = int(np.searchsorted(self._offsets, index, side="right") - 1)
        return self.datasets[di][index - int(self._offsets[di])]


class Subset:
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, index: int):
        return self.dataset[int(self.indices[index])]


def random_split(dataset, lengths: Sequence[int], seed: int = 100):
    """Subsets of a seeded permutation (np.random.default_rng(seed)), the
    JAX package's split."""
    if sum(lengths) != len(dataset):
        raise ValueError("lengths must sum to dataset size")
    perm = np.random.default_rng(seed).permutation(len(dataset))
    out, ofs = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + n]))
        ofs += n
    return out


def dataset_augmentation(root: str, root_csv: str, config: GlobalConfig,
                         camera_aug: int = 7, lidar_aug: int = 2,
                         radar_aug: int = 1) -> ConcatDataset:
    """The offline-augmentation product of one adaptation-scenario CSV:
    every (camera, lidar, radar) variant combination but the original,
    (8*3*2)-1 = 47 with the defaults."""
    sets = []
    for i in range(camera_aug + 1):
        for j in range(lidar_aug + 1):
            for k in range(radar_aug + 1):
                if i == j == k == 0:
                    continue
                sets.append(BeamDataset(
                    root, root_csv, config, test=False,
                    augment={"camera": i, "lidar": j, "radar": k}))
    return ConcatDataset(sets)


def build_train_val_sets(config: GlobalConfig, *,
                         trainval_root: str, train_root_csv: str,
                         adaptation_root: str, adaptation_csv: str,
                         train_adapt_together: bool = True,
                         finetune: bool = False,
                         augmentation: bool = True,
                         flip: bool = False,
                         seed: int = 100):
    """The training CLI's train and validation sets.

    Returns (train_set, val_set): with ``train_adapt_together`` the
    development set (with its flipped copy under ``flip`` and the
    augmented adaptation scenarios under ``augmentation``) and the
    adaptation set, split 90/10; without it the development set alone,
    split 80/20.  Finetune mode returns (adaptation + 25 random scenario-34
    development samples, None).
    """
    if finetune and train_adapt_together:
        raise ValueError(
            "train on 31 and finetune can not be done at the same time")
    if finetune:
        adaptation = BeamDataset(adaptation_root, adaptation_csv, config)
        dev34 = BeamDataset(trainval_root, "scenario34.csv", config)
        dev34_sub, _ = random_split(dev34, [25, len(dev34) - 25], seed)
        return ConcatDataset([adaptation, dev34_sub]), None

    development = BeamDataset(trainval_root, train_root_csv, config)
    if not train_adapt_together:
        n_train = int(0.8 * len(development))
        return random_split(development,
                            [n_train, len(development) - n_train], seed)

    adaptation = BeamDataset(adaptation_root, adaptation_csv, config)
    dev: List = [development]
    adapt: List = [adaptation]
    if flip:
        dev.append(BeamDataset(trainval_root, train_root_csv, config,
                               flip=True))
        adapt.append(BeamDataset(adaptation_root, adaptation_csv, config,
                                 flip=True))
    development_set = ConcatDataset(dev) if len(dev) > 1 else dev[0]
    adaptation_set = ConcatDataset(adapt) if len(adapt) > 1 else adapt[0]

    if augmentation:
        aug = ConcatDataset([
            dataset_augmentation(adaptation_root, f"scenario3{i}.csv", config)
            for i in (1, 2, 3)])
        development_set = ConcatDataset([development_set, aug])

    full = ConcatDataset([development_set, adaptation_set])
    n_train = int(0.9 * len(full))
    return random_split(full, [n_train, len(full) - n_train], seed)
