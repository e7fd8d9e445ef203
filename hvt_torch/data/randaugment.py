"""Device RandAugment, the 13-op policy on a uint8 NHWC batch — port of
``hvt/data/randaugment.py``.

``{cls: RandAugment, args: {device: true}}`` runs the policy inside the
train step on the card, so the host delivers bare crops. The laws are
hvt's, which are Pillow's (the host policy, :mod:`hvt_torch.data.transforms`):

* pointwise ops (autocontrast, equalize, posterize, solarize, color,
  contrast, brightness, sharpness) reproduce Pillow's integer and float
  laws exactly; equalize's histogram is one ``torch.bincount`` over
  ``value + 256·(image·C + channel)`` and its table one gather;
* geometric ops (rotate, shear x/y, translate x/y) use Pillow's
  output→input affine matrices, black fill where the mapped pixel centre
  leaves the image, edge-clamped bilinear taps and a truncating store.

Two policies, as hvt's. **Stratified** (the default): a random permutation
deals each op a static slice of about B/13 images, the remainder to the
first ops in ``OP_NAMES`` order, so each op computes on its slice only;
its geometric ops are per-row (or per-column) constant shifts with a
two-tap lerp, each computed once at +severity on mirror-adjusted inputs (a
mirror turns op₊ into op₋), and its rotation is the **Paeth three-shear**
on an edge-padded canvas with the exact rotation footprint masked at the
end, which is hvt's law (not a direct bilinear rotation). **iid**
(``stratified: false``): each image draws its op; every candidate is
computed on the whole batch and the drawn one kept, the geometric ones by a
per-pixel gather warp.

The op choice, sign flips and permutation are *draws*
(:func:`draw_rand_augment`, from the caller's ``torch.Generator`` on the
batch's device); :func:`rand_augment` is a pure function of the batch and
the draws. The index tables of the shifts depend only on the shape and the
severity, so they are built once per device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

# Index order matches the host policy (transforms.RANDAUGMENT_OPS).
OP_NAMES = (
    "autocontrast", "equalize", "posterize", "solarize", "rotate",
    "shear_x", "shear_y", "translate_x", "translate_y", "color",
    "contrast", "brightness", "sharpness",
)
_MAX_SEVERITY = 10  # transforms._MAX_SEVERITY


# ---------------------------------------------------------------------------
# Pointwise ops (exact Pillow laws, batched)
# ---------------------------------------------------------------------------


def autocontrast(x: torch.Tensor) -> torch.Tensor:
    """Per-channel min/max stretch (ImageOps.autocontrast, cutoff 0): the
    exact integer ``255·(v − lo) // (hi − lo)``."""
    xi = x.to(torch.int32)
    lo = xi.amin(dim=(1, 2), keepdim=True)
    hi = xi.amax(dim=(1, 2), keepdim=True)
    span = hi - lo
    stretched = torch.div(255 * (xi - lo), torch.clamp(span, min=1), rounding_mode="floor")
    return torch.where(span > 0, stretched, xi).to(torch.uint8)


def equalize(x: torch.Tensor) -> torch.Tensor:
    """Per-channel histogram equalization (ImageOps.equalize: step =
    (total − last nonzero bin) // 255; lut[i] = (step//2 + Σ_{j<i} h[j]) //
    step; identity with at most one nonzero bin or step 0)."""
    b, h, w, c = x.shape
    xi = x.to(torch.int64)
    plane = (torch.arange(b, device=x.device)[:, None, None, None] * c
             + torch.arange(c, device=x.device))
    hist = torch.bincount((xi + 256 * plane).reshape(-1), minlength=b * c * 256).view(b, c, 256)
    cum_ex = torch.cumsum(hist, dim=-1) - hist
    nz = hist > 0
    n_nonzero = nz.sum(dim=-1)
    last_idx = 255 - torch.argmax(nz.flip(-1).to(torch.int32), dim=-1)
    last = torch.gather(hist, -1, last_idx[..., None])[..., 0]
    step = torch.div(h * w - last, 255, rounding_mode="floor")
    lut = torch.div(torch.div(step, 2, rounding_mode="floor")[..., None] + cum_ex,
                    torch.clamp(step, min=1)[..., None], rounding_mode="floor")
    lut = torch.clamp(lut, 0, 255)
    identity = torch.arange(256, device=x.device).expand_as(lut)
    lut = torch.where(((n_nonzero <= 1) | (step == 0))[..., None], identity, lut)
    planes = xi.permute(0, 3, 1, 2).reshape(b, c, h * w)
    out = torch.gather(lut, -1, planes).view(b, c, h, w).permute(0, 2, 3, 1)
    return out.to(torch.uint8)


def posterize(x: torch.Tensor, severity: int) -> torch.Tensor:
    """Keep the top ``bits`` bits (bits = 8 − int(sev/10·4), at least 1)."""
    bits = max(1, 8 - int(severity / _MAX_SEVERITY * 4))
    mask = (0xFF << (8 - bits)) & 0xFF
    return (x.to(torch.int32) & mask).to(torch.uint8)


def solarize(x: torch.Tensor, severity: int) -> torch.Tensor:
    """Invert pixels ≥ 256 − int(sev/10·256)."""
    threshold = 256 - int(severity / _MAX_SEVERITY * 256)
    xi = x.to(torch.int32)
    return torch.where(xi < threshold, xi, 255 - xi).to(torch.uint8)


def _grayscale(x: torch.Tensor) -> torch.Tensor:
    """Pillow's convert("L"): (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    xi = x.to(torch.int32)
    return (19595 * xi[..., 0] + 38470 * xi[..., 1] + 7471 * xi[..., 2] + 32768) >> 16


def _blend(degenerate: torch.Tensor, image: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Image.blend / ImageEnhance: f32 ``d + factor·(image − d)``, clipped to
    [0, 255], truncated to uint8; ``factor`` per image (B,)."""
    f = factor.to(torch.float32)[:, None, None, None]
    d = degenerate.to(torch.float32)
    v = d + f * (image.to(torch.float32) - d)
    return torch.clamp(v, 0.0, 255.0).to(torch.uint8)


def color(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Saturation (ImageEnhance.Color): blend with the grayscale image."""
    gray = _grayscale(x)[..., None].to(torch.uint8)
    return _blend(gray.expand_as(x), x, factor)


def contrast(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """ImageEnhance.Contrast: blend with the grayscale mean rounded half up."""
    _, h, w, _ = x.shape
    total = h * w
    gsum = _grayscale(x).to(torch.int64).sum(dim=(1, 2))
    mean = torch.div(2 * gsum + total, 2 * total, rounding_mode="floor")
    return _blend(mean[:, None, None, None].to(torch.uint8).expand_as(x), x, factor)


def brightness(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """ImageEnhance.Brightness: blend with black."""
    return _blend(torch.zeros_like(x), x, factor)


def sharpness(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """ImageEnhance.Sharpness: blend with the SMOOTH-filtered image (3×3
    kernel [[1,1,1],[1,5,1],[1,1,1]]/13, rounded; the 1-px border unfiltered)."""
    xf = x.to(torch.float32)
    p = F.pad(xf, (0, 0, 1, 1, 1, 1))
    acc = (p[:, :-2, :-2] + p[:, :-2, 1:-1] + p[:, :-2, 2:]
           + p[:, 1:-1, :-2] + 5.0 * p[:, 1:-1, 1:-1] + p[:, 1:-1, 2:]
           + p[:, 2:, :-2] + p[:, 2:, 1:-1] + p[:, 2:, 2:])
    sm = torch.clamp(torch.floor(acc / 13.0 + 0.5), 0.0, 255.0)
    _, h, w, _ = x.shape
    interior = torch.zeros((h, w, 1), dtype=torch.bool, device=x.device)
    interior[1:-1, 1:-1] = True
    deg = torch.where(interior, sm, xf).to(torch.uint8)
    return _blend(deg, x, factor)


# ---------------------------------------------------------------------------
# Geometric ops, iid policy: one batched inverse-affine bilinear warp
# ---------------------------------------------------------------------------


def _bilinear_warp(x: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Sample ``x`` (B, H, W, C uint8) at per-image output→input affine maps
    ``mats`` (B, 6) = (a, b, c, d, e, f), source = (a·xo + b·yo + c,
    d·xo + e·yo + f) in Pillow's corner coordinates at output pixel centres.
    A pixel whose mapped centre leaves [0, W)×[0, H) is black; the others
    take edge-clamped bilinear taps, truncated."""
    b, h, w, c = x.shape
    yo, xo = torch.meshgrid(torch.arange(h, device=x.device, dtype=torch.float32) + 0.5,
                            torch.arange(w, device=x.device, dtype=torch.float32) + 0.5,
                            indexing="ij")
    a, bb, cc, d, e, f = (mats[:, i][:, None, None] for i in range(6))
    xs = a * xo + bb * yo + cc
    ys = d * xo + e * yo + f
    valid = ((xs >= 0) & (xs < w) & (ys >= 0) & (ys < h))[..., None]
    xs = xs - 0.5
    ys = ys - 0.5
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = x.to(torch.float32).reshape(b, h * w, c)

    def tap(yi, xi):
        idx = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        return torch.gather(flat, 1, idx.reshape(b, h * w, 1).expand(b, h * w, c)).view(b, h, w, c)

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    out = (1 - wy) * ((1 - wx) * v00 + wx * v01) + wy * ((1 - wx) * v10 + wx * v11)
    out = torch.clamp(torch.floor(out), 0.0, 255.0)
    return torch.where(valid, out, 0.0).to(torch.uint8)


def _affine_matrices(op: torch.Tensor, sign: torch.Tensor, severity: int,
                     h: int, w: int) -> torch.Tensor:
    """Per-image Pillow affine matrices for ops 4-8; identity for the others
    (an exact pass-through under :func:`_bilinear_warp`)."""
    lvl = severity / _MAX_SEVERITY
    theta = sign * (lvl * 30.0) * (math.pi / 180.0)
    shear = sign * (lvl * 0.3)
    tx = sign * (lvl * 0.45 * w)
    ty = sign * (lvl * 0.45 * h)
    one, zero = torch.ones_like(sign), torch.zeros_like(sign)
    a, b_, c_, d, e, f = one, zero, zero, zero, one, zero
    # Image.rotate(angle) builds its output→input map about the centre with
    # the angle negated: [cos θ, −sin θ, c; sin θ, cos θ, f]
    cos, sin = torch.cos(theta), torch.sin(theta)
    cx, cy = w / 2.0, h / 2.0
    rot = op == 4
    a = torch.where(rot, cos, a)
    b_ = torch.where(rot, -sin, b_)
    c_ = torch.where(rot, cx - cos * cx + sin * cy, c_)
    d = torch.where(rot, sin, d)
    e = torch.where(rot, cos, e)
    f = torch.where(rot, cy - sin * cx - cos * cy, f)
    b_ = torch.where(op == 5, shear, b_)
    d = torch.where(op == 6, shear, d)
    c_ = torch.where(op == 7, tx, c_)
    f = torch.where(op == 8, ty, f)
    return torch.stack([a, b_, c_, d, e, f], dim=1)


# ---------------------------------------------------------------------------
# Geometric ops, stratified policy: per-row constant shifts
# ---------------------------------------------------------------------------


def _row_shift_tables(h: int, w: int, shift: np.ndarray, fill: bool):
    """Tables for sampling at source x = xo + shift[yo] (float64 (H,)): the
    two taps' flat indices (edge-clamped), the lerp weight per row, and, with
    ``fill``, the 0/1 mask of pixels whose mapped corner-space centre
    xo + 0.5 + shift stays inside [0, W)."""
    k = np.floor(shift).astype(np.int64)
    frac = (shift - k).astype(np.float32)
    xo = np.arange(w)
    rows = np.arange(h)[:, None] * w
    tap_a = (rows + np.clip(xo[None, :] + k[:, None], 0, w - 1)).reshape(-1)
    tap_b = (rows + np.clip(xo[None, :] + k[:, None] + 1, 0, w - 1)).reshape(-1)
    valid = None
    if fill:
        centre = xo[None, :] + 0.5 + shift[:, None]
        valid = ((centre >= 0.0) & (centre < w)).astype(np.float32)
    return tap_a, tap_b, frac, valid


class _Shift:
    """One per-row shift pass on the device: taps, weights and mask."""

    def __init__(self, h: int, w: int, shift: np.ndarray, fill: bool, device):
        tap_a, tap_b, frac, valid = _row_shift_tables(h, w, np.asarray(shift, np.float64), fill)
        self.tap_a = torch.from_numpy(tap_a).to(device)
        self.tap_b = torch.from_numpy(tap_b).to(device)
        self.wgt = torch.from_numpy(frac).to(device)[None, :, None, None]
        self.valid = None if valid is None else torch.from_numpy(valid).to(device)[None, :, :, None]

    def along_x(self, xf: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) f32 → the two-tap lerp (1 − f)·a + f·b per row."""
        n, h, w, c = xf.shape
        flat = xf.reshape(n, h * w, c)
        a = flat[:, self.tap_a].view(n, h, w, c)
        b = flat[:, self.tap_b].view(n, h, w, c)
        out = (1.0 - self.wgt) * a + self.wgt * b
        return out if self.valid is None else out * self.valid

    def along_y(self, xf: torch.Tensor) -> torch.Tensor:
        """The pass on the H/W-transposed image: a per-column constant y-shift."""
        return self.along_x(xf.transpose(1, 2)).transpose(1, 2)


@functools.lru_cache(maxsize=128)
def _passes(name: str, h: int, w: int, severity: int, device: torch.device):
    """The shift passes of geometric op ``name`` at +severity on an (h, w)
    image: [(pass, axis)], and for rotation the canvas margin and the
    footprint mask."""
    lvl = severity / _MAX_SEVERITY
    ys = np.arange(h, dtype=np.float64) + 0.5
    xs = np.arange(w, dtype=np.float64) + 0.5
    if name == "shear_x":
        return [(_Shift(h, w, (lvl * 0.3) * ys, True, device), "x")], 0, None
    if name == "shear_y":
        return [(_Shift(w, h, (lvl * 0.3) * xs, True, device), "y")], 0, None
    if name == "translate_x":
        return [(_Shift(h, w, np.full(h, lvl * 0.45 * w), True, device), "x")], 0, None
    if name == "translate_y":
        return [(_Shift(w, h, np.full(w, lvl * 0.45 * h), True, device), "y")], 0, None
    if name != "rotate":
        raise ValueError(f"unknown geometric op {name!r}")
    # Paeth: with a = −tan(θ/2), b = sin θ the shears Sx(a)·Sy(b)·Sx(a) compose
    # to the output→input rotation; the canvas margin keeps every pass's
    # content from clipping (growth |a|·h/2, then |b|·(w/2 + g1), then
    # |a|·(h/2 + g2)).
    theta = (lvl * 30.0) * (math.pi / 180.0)
    a = -math.tan(theta / 2.0)
    b = math.sin(theta)
    g1 = abs(a) * h / 2.0
    g2 = abs(b) * (w / 2.0 + g1)
    g3 = abs(a) * (h / 2.0 + g2)
    m = int(math.ceil(max(g1 + g3, g2))) + 1
    hc, wc = h + 2 * m, w + 2 * m
    cx, cy = m + w / 2.0, m + h / 2.0
    sh_rows = a * (np.arange(hc, dtype=np.float64) + 0.5 - cy)
    sh_cols = b * (np.arange(wc, dtype=np.float64) + 0.5 - cx)
    rows_pass = _Shift(hc, wc, sh_rows, False, device)
    passes = [(rows_pass, "x"), (_Shift(wc, hc, sh_cols, False, device), "y"), (rows_pass, "x")]
    # the exact footprint (Pillow's black region), in float64
    gx, gy = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    u, v = gx - w / 2.0, gy - h / 2.0
    xsrc = math.cos(theta) * u - math.sin(theta) * v + w / 2.0
    ysrc = math.sin(theta) * u + math.cos(theta) * v + h / 2.0
    valid = (xsrc >= 0) & (xsrc < w) & (ysrc >= 0) & (ysrc < h)
    return passes, m, torch.from_numpy(valid.astype(np.float32)).to(device)[None, :, :, None]


def _geometric(name: str, xf: torch.Tensor, severity: int) -> torch.Tensor:
    """Op ``name`` at +severity on an f32 (N, H, W, C) batch, unquantized."""
    _, h, w, _ = xf.shape
    passes, m, footprint = _passes(name, h, w, severity, xf.device)
    if m:  # rotation: an edge-replicated canvas, cropped back at the end
        rows = torch.clamp(torch.arange(-m, h + m, device=xf.device), 0, h - 1)
        cols = torch.clamp(torch.arange(-m, w + m, device=xf.device), 0, w - 1)
        xf = xf[:, rows][:, :, cols]
    for shift, axis in passes:
        xf = shift.along_x(xf) if axis == "x" else shift.along_y(xf)
    if m:
        xf = xf[:, m:m + h, m:m + w] * footprint
    return xf


def _signed_variants(x: torch.Tensor, sign: torch.Tensor, name: str, severity: int,
                     flip_axis: int) -> torch.Tensor:
    """A geometric op at each image's sign, computed once at +severity: a
    mirror along ``flip_axis`` (W for x-ops and rotation, H for y-ops) turns
    op₊ into op₋. Quantized as the warp: floor, clip, uint8."""
    xf = x.to(torch.float32)
    pos = (sign > 0)[:, None, None, None]
    out = _geometric(name, torch.where(pos, xf, torch.flip(xf, dims=(flip_axis,))), severity)
    out = torch.where(pos, out, torch.flip(out, dims=(flip_axis,)))
    return torch.clamp(torch.floor(out), 0.0, 255.0).to(torch.uint8)


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------


def _factor(sign: torch.Tensor, severity: int) -> torch.Tensor:
    """The enhance ops' factor: 1 ± sev/10·0.9, at least 0.05."""
    return torch.clamp(1.0 + sign * (severity / _MAX_SEVERITY * 0.9), min=0.05)


def _apply_op_static(name: str, x: torch.Tensor, sign: torch.Tensor, factor: torch.Tensor,
                     severity: int) -> torch.Tensor:
    """One op, known when the step is built, on its stratified slice."""
    if name == "autocontrast":
        return autocontrast(x)
    if name == "equalize":
        return equalize(x)
    if name == "posterize":
        return posterize(x, severity)
    if name == "solarize":
        return solarize(x, severity)
    if name == "color":
        return color(x, factor)
    if name == "contrast":
        return contrast(x, factor)
    if name == "brightness":
        return brightness(x, factor)
    if name == "sharpness":
        return sharpness(x, factor)
    return _signed_variants(x, sign, name, severity, 1 if name.endswith("_y") else 2)


def _apply_stratified(x: torch.Tensor, perm: torch.Tensor, sign: torch.Tensor,
                      severity: int) -> torch.Tensor:
    """One stratified round: ``perm`` deals op i the static slice
    [offs[i], offs[i+1]) of the permuted batch (sizes B//13, the first B%13
    ops one more), ``sign`` per permuted position; the inverse permutation
    restores the batch order."""
    b = x.shape[0]
    n = len(OP_NAMES)
    factor = _factor(sign, severity)
    xp = x[perm]
    sizes = [b // n + (1 if i < b % n else 0) for i in range(n)]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    pieces = []
    for i, name in enumerate(OP_NAMES):
        if sizes[i]:
            sl = slice(int(offs[i]), int(offs[i + 1]))
            pieces.append(_apply_op_static(name, xp[sl], sign[sl], factor[sl], severity))
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=0)
    return out[torch.argsort(perm)]


def _apply_one(x: torch.Tensor, op: torch.Tensor, sign: torch.Tensor, severity: int) -> torch.Tensor:
    """One iid round: image i takes op[i] ∈ [0, 13) at sign[i]."""
    _, h, w, _ = x.shape
    out = _bilinear_warp(x, _affine_matrices(op, sign, severity, h, w))
    factor = _factor(sign, severity)
    pointwise = ((0, autocontrast(x)), (1, equalize(x)), (2, posterize(x, severity)),
                 (3, solarize(x, severity)), (9, color(x, factor)), (10, contrast(x, factor)),
                 (11, brightness(x, factor)), (12, sharpness(x, factor)))
    for idx, cand in pointwise:
        out = torch.where((op == idx)[:, None, None, None], cand, out)
    return out


def draw_rand_augment(generator: torch.Generator, batch: int, depth: int, stratified: bool,
                      device) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Each round's draws on ``device``: (perm, sign) for the stratified
    policy, (op, sign) for the iid one; sign ±1 with even odds."""
    draws = []
    for _ in range(int(depth)):
        if stratified:
            choice = torch.randperm(batch, generator=generator, device=device)
        else:
            choice = torch.randint(0, len(OP_NAMES), (batch,), generator=generator, device=device)
        coin = torch.rand((batch,), generator=generator, device=device)
        draws.append((choice, torch.where(coin < 0.5, 1.0, -1.0)))
    return draws


def rand_augment(images: torch.Tensor, draws, severity: int = 9,
                 stratified: bool = True) -> torch.Tensor:
    """RandAugment over a uint8 NHWC batch, one round per entry of
    ``draws`` (:func:`draw_rand_augment`), shapes and dtype unchanged."""
    if images.dtype != torch.uint8:
        raise ValueError(f"device RandAugment operates on uint8 pixel batches (before "
                         f"normalization), got {images.dtype}")
    for choice, sign in draws:
        sign = sign.to(torch.float32)
        if stratified:
            images = _apply_stratified(images, choice, sign, severity)
        else:
            images = _apply_one(images, choice, sign, severity)
    return images
