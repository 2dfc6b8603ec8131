"""Camera frames: the reader of ``deepsense6g_tii_tpu/data/dataset.py:
126-143`` and the JPEG writer of the demo tree.

Frames decode with Pillow and resize with Pillow's default filter (BICUBIC
in Pillow 12), exactly as the JAX package does, so both packages hand the
model the same pixels.  Pillow is imported where it is used, never when the
package is imported.
"""

from __future__ import annotations

import numpy as np


def read_frame(path: str, res: int) -> np.ndarray:
    """The (res, res, 3) uint8 frame at ``path``, resized."""
    from PIL import Image
    with Image.open(path) as img:
        return np.array(img.resize((res, res)))


def blend_seg(img: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """A frame with its car-segmentation overlay blended in: img*0.8 +
    (img & seg's blue channel)*0.5, saturating at 255 like
    cv2.addWeighted."""
    a = seg[..., 2:3].repeat(3, axis=2)
    seg_car = np.bitwise_and(img, a)
    return np.clip(np.rint(img * 0.8 + seg_car * 0.5), 0,
                   255).astype(np.uint8)


def write_jpeg(path: str, frame: np.ndarray) -> None:
    """An (H, W, 3) uint8 frame as a JPEG with Pillow's defaults."""
    from PIL import Image
    Image.fromarray(frame, "RGB").save(path)
