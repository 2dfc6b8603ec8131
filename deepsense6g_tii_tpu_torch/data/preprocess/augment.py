"""Offline data-augmentation writers (own copy of
``deepsense6g_tii_tpu/data/preprocess/augment.py``: with the same seed they
write the same bytes).  They run on the host (PIL and numpy) and take no
device.  Per input, the writers emit:

  camera: 7 variants ``*_1..7.jpg`` — brightness U(0.5,3), contrast U(0.5,4),
    gamma U(0.5,3), hue U(-.5,.5), saturation U(0,4), sharpness U(0,10),
    Gaussian blur (the reference's torchvision kernel (9,7), sigma (3,5)).
  lidar: 2 variants ``*_1.ply`` (random 0.9 downsample), ``*_2.ply``
    (per-point uniform +-0.4 m jitter).
  radar: 1 variant in radar_data_{ang,vel}_aug — per-cell multiplicative
    spectral noise v + U(0.25*0.1v, 0.1v), then re-minmax.

Image adjustments use PIL ImageEnhance (the same backend torchvision's
functional transforms wrap for PIL inputs) + an explicit gamma/hue/blur.

    python -m deepsense6g_tii_tpu_torch.data.preprocess.augment \\
        image|lidar|radar SRC [--dst DST] [--vel_src VEL] [--seed 0]
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image, ImageEnhance

from ...utils import ply
from .. import features as F


# -- image variants ----------------------------------------------------------

def adjust_gamma(img: Image.Image, gamma: float) -> Image.Image:
    """torchvision PIL adjust_gamma LUT (truncation, scale 256-1e-3), the
    exact table the reference augmentation applies — a round-to-nearest
    LUT differs on 72/256 entries at gamma=2."""
    lut = [min(255, int((255 + 1 - 1e-3) * (i / 255.0) ** gamma))
           for i in range(256)]
    return img.point(lut * len(img.getbands()))


def adjust_hue(img: Image.Image, hue_factor: float) -> Image.Image:
    """torchvision adjust_hue semantics: shift H by hue_factor*360 deg."""
    h, s, v = img.convert("HSV").split()
    h = h.point(lambda x: (x + int(hue_factor * 255)) % 256)
    return Image.merge("HSV", (h, s, v)).convert("RGB")


def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    """torchvision _get_gaussian_kernel1d: normalized Gaussian pdf sampled at
    linspace(-(size-1)/2, (size-1)/2, size)."""
    x = np.linspace(-(size - 1) * 0.5, (size - 1) * 0.5, size)
    pdf = np.exp(-0.5 * (x / sigma) ** 2)
    return (pdf / pdf.sum()).astype(np.float32)


def gaussian_blur(img: Image.Image, kernel_size=(9, 7),
                  sigma=(3.0, 5.0)) -> Image.Image:
    """torchvision.transforms.functional.gaussian_blur semantics
    (Image_data_augmentation.py:46-50): kernel_size=(kx, ky), sigma=
    (sigma_x, sigma_y), separable conv with reflect padding, rounded and
    clamped back to uint8 — NOT PIL's isotropic GaussianBlur filter."""
    kx = _gaussian_kernel1d(kernel_size[0], sigma[0])
    ky = _gaussian_kernel1d(kernel_size[1], sigma[1])
    arr = np.asarray(img, dtype=np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    px, py = kernel_size[0] // 2, kernel_size[1] // 2
    arr = np.pad(arr, ((py, py), (px, px), (0, 0)), mode="reflect")
    # separable: convolve height (y) then width (x)
    arr = np.einsum("k,khwc->hwc", ky, np.stack(
        [arr[i:i + arr.shape[0] - 2 * py] for i in range(kernel_size[1])]))
    arr = np.einsum("k,hkwc->hwc", kx, np.stack(
        [arr[:, i:i + arr.shape[1] - 2 * px] for i in range(kernel_size[0])],
        axis=1))
    out = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    return Image.fromarray(out.squeeze() if out.shape[-1] == 1 else out)


def augment_image(img: Image.Image, rng: np.random.Generator):
    """Yields the 7 augmented variants in reference order
    (Image_data_augmentation.py:16-50).  The enhance factors are passed
    through unmapped — torchvision's PIL paths ARE PIL ImageEnhance
    (torchvision _functional_pil), so the factor distributions match the
    reference exactly."""
    yield ImageEnhance.Brightness(img).enhance(rng.uniform(0.5, 3))
    yield ImageEnhance.Contrast(img).enhance(rng.uniform(0.5, 4))
    yield adjust_gamma(img, rng.uniform(0.5, 3))
    yield adjust_hue(img, rng.uniform(-0.5, 0.5))
    yield ImageEnhance.Color(img).enhance(rng.uniform(0, 4))
    yield ImageEnhance.Sharpness(img).enhance(rng.uniform(0, 10))
    yield gaussian_blur(img, kernel_size=(9, 7), sigma=(3.0, 5.0))


def augment_image_dir(src_dir: str, dst_dir: str, seed: int = 0) -> int:
    os.makedirs(dst_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = 0
    for name in sorted(os.listdir(src_dir)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        img = Image.open(os.path.join(src_dir, name)).convert("RGB")
        stem = name.rsplit(".", 1)[0]
        for k, var in enumerate(augment_image(img, rng), start=1):
            var.save(os.path.join(dst_dir, f"{stem}_{k}.jpg"), "JPEG")
        n += 1
    return n


# -- lidar variants ----------------------------------------------------------

def augment_lidar(points: np.ndarray, rng: np.random.Generator,
                  noise_range: float = 0.4):
    """Returns (downsampled_0.9, jittered) variants
    (Lidar_data_augmentation.py:16-39)."""
    n = points.shape[0]
    keep = rng.permutation(n)[: int(round(n * 0.9))]
    down = points[np.sort(keep)]
    jitter = points + rng.uniform(-noise_range, noise_range, points.shape)
    return down, jitter


def augment_lidar_dir(src_dir: str, dst_dir: str, seed: int = 0) -> int:
    os.makedirs(dst_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = 0
    for name in sorted(os.listdir(src_dir)):
        if not name.endswith(".ply"):
            continue
        pts = ply.read_points(os.path.join(src_dir, name))
        down, jit = augment_lidar(pts, rng)
        stem = name[:-4]
        ply.write_points(os.path.join(dst_dir, f"{stem}_1.ply"), down)
        ply.write_points(os.path.join(dst_dir, f"{stem}_2.ply"), jit)
        n += 1
    return n


# -- radar variant -----------------------------------------------------------

def augment_radar_map(m: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Per-cell multiplicative spectral noise + re-minmax
    (radar_data_augmentation.py:77-108)."""
    shift = m * 0.1
    noisy = m + rng.uniform(0.25 * shift, shift)
    return F.minmax_np(noisy)


def augment_radar_dirs(ang_dir: str, vel_dir: str,
                       ang_out: Optional[str] = None,
                       vel_out: Optional[str] = None, seed: int = 0) -> int:
    ang_out = ang_out or ang_dir.rstrip("/") + "_aug"
    vel_out = vel_out or vel_dir.rstrip("/") + "_aug"
    os.makedirs(ang_out, exist_ok=True)
    os.makedirs(vel_out, exist_ok=True)
    rng = np.random.default_rng(seed)
    n = 0
    for name in sorted(os.listdir(ang_dir)):
        if not name.endswith(".npy"):
            continue
        np.save(os.path.join(ang_out, name),
                augment_radar_map(np.load(os.path.join(ang_dir, name)), rng))
        np.save(os.path.join(vel_out, name),
                augment_radar_map(np.load(os.path.join(vel_dir, name)), rng))
        n += 1
    return n


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("kind", choices=["image", "lidar", "radar"])
    p.add_argument("src", help="source dir (radar: the _ang dir)")
    p.add_argument("--dst", default=None)
    p.add_argument("--vel_src", default=None, help="radar _vel dir")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    if a.kind == "image":
        n = augment_image_dir(a.src, a.dst or a.src.rstrip("/") + "_aug",
                              a.seed)
    elif a.kind == "lidar":
        n = augment_lidar_dir(a.src, a.dst or a.src.rstrip("/") + "_aug",
                              a.seed)
    else:
        n = augment_radar_dirs(a.src, a.vel_src
                               or a.src.replace("ang", "vel"), seed=a.seed)
    print(f"augmented {n} files")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
