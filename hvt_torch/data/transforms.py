"""Host-side eval transform — the eval half of ``hvt/data/transforms.py``.

[Resize shorter side?] → CenterCrop → uint8 RGB HWC numpy, through Pillow
with bilinear resampling, exactly as hvt does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
from PIL import Image

BILINEAR = Image.BILINEAR


def to_rgb(img: Image.Image) -> Image.Image:
    return img if img.mode == "RGB" else img.convert("RGB")


def resize_shorter(img: Image.Image, size: int) -> Image.Image:
    """Resize so the shorter side equals `size`, keeping aspect ratio."""
    w, h = img.size
    if w <= h:
        new = (size, max(1, int(round(h * size / w))))
    else:
        new = (max(1, int(round(w * size / h))), size)
    return img.resize(new, BILINEAR)


def center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    left = max(0, (w - size) // 2)
    top = max(0, (h - size) // 2)
    if w < size or h < size:  # pad-by-resize when the image is smaller than the crop
        img = img.resize((max(size, w), max(size, h)), BILINEAR)
        w, h = img.size
        left, top = (w - size) // 2, (h - size) // 2
    return img.crop((left, top, left + size, top + size))


class EvalTransform:
    """[Resize?] → CenterCrop → uint8 HWC."""

    def __init__(self, crop_size: int, resize_size: int = -1):
        self.crop_size = crop_size
        self.resize_size = resize_size

    def __call__(self, img: Image.Image, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        img = to_rgb(img)
        if self.resize_size > 0:
            img = resize_shorter(img, self.resize_size)
        img = center_crop(img, self.crop_size)
        return np.asarray(img, dtype=np.uint8)
