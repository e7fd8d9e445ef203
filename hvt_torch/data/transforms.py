"""Host-side Pillow transforms — port of ``hvt/data/transforms.py``.

train = [Resize shorter side?] → RandomResizedCrop(scale 0.08-1, ratio
3/4-4/3) → HFlip → [RandAugment?] → [ColOut?]; eval = [Resize?] →
CenterCrop; uint8 RGB HWC numpy out, bilinear resampling throughout.
All randomness flows through the caller's ``np.random.Generator``, so a
(seed, epoch, sample index) key reproduces a sample's augmentation, and the
same generator gives hvt's pixels bit for bit (both sides are numpy and
Pillow).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

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


def sample_crop_box(
    w: int,
    h: int,
    rng: np.random.Generator,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3 / 4, 4 / 3),
) -> tuple[int, int, int, int]:
    """RandomResizedCrop box sampling → (left, top, cw, ch).

    torchvision semantics: crop area uniform in scale·area, aspect ratio
    log-uniform in `ratio`, 10 rejection attempts, then the largest
    ratio-clamped center crop as fallback.
    """
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))

    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = int(rng.integers(0, w - cw + 1))
            top = int(rng.integers(0, h - ch + 1))
            return left, top, cw, ch

    # Fallback: largest center crop within the ratio bounds.
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left, top = (w - cw) // 2, (h - ch) // 2
    return left, top, cw, ch


def random_resized_crop(
    img: Image.Image,
    size: int,
    rng: np.random.Generator,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (3 / 4, 4 / 3),
) -> Image.Image:
    """torchvision-style RandomResizedCrop."""
    w, h = img.size
    left, top, cw, ch = sample_crop_box(w, h, rng, scale, ratio)
    return img.resize((size, size), BILINEAR, box=(left, top, left + cw, top + ch))


def random_hflip(img: Image.Image, rng: np.random.Generator, p: float = 0.5) -> Image.Image:
    if rng.random() < p:
        return img.transpose(Image.FLIP_LEFT_RIGHT)
    return img


# ---------------------------------------------------------------------------
# RandAugment
# ---------------------------------------------------------------------------

_MAX_SEVERITY = 10


def _level(severity: int, maxval: float) -> float:
    return severity / _MAX_SEVERITY * maxval


def _randomly_negate(v: float, rng: np.random.Generator) -> float:
    return -v if rng.random() < 0.5 else v


def _shear_x(img, sev, rng):
    v = _randomly_negate(_level(sev, 0.3), rng)
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0), BILINEAR)


def _shear_y(img, sev, rng):
    v = _randomly_negate(_level(sev, 0.3), rng)
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0), BILINEAR)


def _translate_x(img, sev, rng):
    v = _randomly_negate(_level(sev, 0.45) * img.size[0], rng)
    return img.transform(img.size, Image.AFFINE, (1, 0, v, 0, 1, 0), BILINEAR)


def _translate_y(img, sev, rng):
    v = _randomly_negate(_level(sev, 0.45) * img.size[1], rng)
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, v), BILINEAR)


def _rotate(img, sev, rng):
    return img.rotate(_randomly_negate(_level(sev, 30.0), rng), BILINEAR)


def _autocontrast(img, sev, rng):
    return ImageOps.autocontrast(img)


def _equalize(img, sev, rng):
    return ImageOps.equalize(img)


def _posterize(img, sev, rng):
    bits = 8 - int(_level(sev, 4))
    return ImageOps.posterize(img, max(1, bits))


def _solarize(img, sev, rng):
    return ImageOps.solarize(img, 256 - int(_level(sev, 256)))


def _enhance(factory):
    def op(img, sev, rng):
        v = 1.0 + _randomly_negate(_level(sev, 0.9), rng)
        return factory(img).enhance(max(0.05, v))

    return op


_color = _enhance(ImageEnhance.Color)
_contrast = _enhance(ImageEnhance.Contrast)
_brightness = _enhance(ImageEnhance.Brightness)
_sharpness = _enhance(ImageEnhance.Sharpness)

RANDAUGMENT_OPS = (
    _autocontrast,
    _equalize,
    _posterize,
    _solarize,
    _rotate,
    _shear_x,
    _shear_y,
    _translate_x,
    _translate_y,
    _color,
    _contrast,
    _brightness,
    _sharpness,
)


def rand_augment(
    img: Image.Image,
    rng: np.random.Generator,
    depth: int = 1,
    severity: int = 9,
) -> Image.Image:
    """Apply `depth` randomly chosen ops at the given severity
    (configs/recipes/hot.yaml asks for depth 1, severity 9)."""
    for _ in range(depth):
        op = RANDAUGMENT_OPS[int(rng.integers(0, len(RANDAUGMENT_OPS)))]
        img = op(img, severity, rng)
    return img


def colout(
    arr: np.ndarray,
    rng: np.random.Generator,
    p_row: float = 0.05,
    p_col: float = 0.05,
) -> np.ndarray:
    """ColOut: drop each row and each column with probability p (at least
    one of each kept); the caller resizes back to the crop."""
    h, w = arr.shape[:2]
    keep_rows = rng.random(h) >= p_row
    keep_cols = rng.random(w) >= p_col
    if not keep_rows.any():
        keep_rows[0] = True
    if not keep_cols.any():
        keep_cols[0] = True
    return arr[keep_rows][:, keep_cols]


# ---------------------------------------------------------------------------
# Composed pipelines
# ---------------------------------------------------------------------------


class TrainTransform:
    """[Resize?] → RandomResizedCrop → HFlip → [RandAugment?] → uint8 HWC."""

    def __init__(
        self,
        crop_size: int,
        resize_size: int = -1,
        randaugment_depth: int = 0,
        randaugment_severity: int = 9,
        colout_p: Optional[tuple[float, float]] = None,
    ):
        self.crop_size = crop_size
        self.resize_size = resize_size
        self.randaugment_depth = randaugment_depth
        self.randaugment_severity = randaugment_severity
        self.colout_p = colout_p

    def __call__(self, img: Image.Image, rng: np.random.Generator) -> np.ndarray:
        img = to_rgb(img)
        if self.resize_size > 0:
            img = resize_shorter(img, self.resize_size)
        img = random_resized_crop(img, self.crop_size, rng)
        img = random_hflip(img, rng)
        return self.post_augment(np.asarray(img, dtype=np.uint8), rng)

    @property
    def has_post_ops(self) -> bool:
        return self.randaugment_depth > 0 or self.colout_p is not None

    def post_augment(self, arr: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """RandAugment + ColOut on an already-cropped uint8 HWC array.

        Split out so the native decode route (decode + RandomResizedCrop +
        flip, :mod:`hvt_torch.data.native`) can hand off here: both apply
        *after* the crop, on the small crop_size² image, while the JPEG
        decode of the full-size source stays in the native core."""
        if self.randaugment_depth > 0:
            img = Image.fromarray(arr)
            img = rand_augment(
                img, rng, self.randaugment_depth, self.randaugment_severity
            )
            arr = np.asarray(img, dtype=np.uint8)
        if self.colout_p is not None:
            arr = colout(arr, rng, *self.colout_p)
            arr = np.asarray(
                Image.fromarray(arr).resize((self.crop_size, self.crop_size), BILINEAR),
                dtype=np.uint8,
            )
        return arr


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
