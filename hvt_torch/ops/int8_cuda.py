"""int8 × int8 → int32 products of the w8a8 serving forward, with hvt's dequant.

hvt computes them in XLA (``_quant_dense`` and ``_quant_conv``,
hvt/ops/quant.py:136-211: ``lax.dot_general`` / ``lax.conv_general_dilated``
with ``preferred_element_type=int32``), outside any Pallas kernel. Here:

* :func:`int8_linear`: ``x (…, K) int8 · w (N, K) int8ᵀ`` → int32, then the
  epilogue. On the card the product is ``torch._int_mm`` (cuBLAS's int8
  tensor-core GEMM; hvt leaves the product to XLA too), its operands padded
  with zeros where ``_int_mm`` wants it (m > 16, k and n multiples of 8;
  zero rows and columns change no sum), and the epilogue is
  ``hvt_int8_dequant`` of ``csrc/int8_conv.cu``.
* :func:`int8_conv2d`: an NHWC int8 x and an HWIO int8 kernel, any
  ``groups`` (dense, grouped, depthwise), stride and explicit (top,
  bottom, left, right) pads → NHWC. On the card ``hvt_int8_conv``
  (``csrc/int8_conv.cu``: an implicit GEMM on ``dp4a`` for dense and grouped
  convs, a direct loop for depthwise ones, the epilogue in both). A 1×1
  conv without pads and one group is a plain product: the quantizer
  (:class:`hvt_torch.ops.quant.Int8`) keeps its weight as (O, C) and sends
  it to :func:`int8_linear` on the strided grid.

The epilogue is hvt's, rounding twice: ``y = f32(acc) · (sx · sw[o])``, then
``y + b[o]`` in f32, then the cast to the layer's dtype (bf16 rounds to
nearest even). ``sx`` is the activation's scale, a 0-d f32 tensor; ``sw``
the weight's per-output-channel scales, (N,) f32; ``b`` None or (N,) f32.
``out_dtype`` None returns the int32 accumulation itself.

Dispatch is by device alone, as in every wrapper of the port: a CUDA tensor
goes to the kernels (or raises on what they do not take), a CPU tensor to
the plain versions (:func:`linear_acc_plain`, :func:`conv_acc_plain` and
:func:`dequant_plain`), which accumulate exactly: products of two values
in [-127, 127] summed in f64, exact below 2⁵³, so they give hvt's int32
sums whatever the order. A sum that could leave int32 (K · 127² ≥ 2³¹)
raises on either device.

Counts: ``CONV_KERNEL.launches`` and ``DEQUANT_KERNEL.launches`` (the
``_build.Kernel`` counts), and :data:`INT_MM` for the ``torch._int_mm``
calls (each followed by one dequant launch).
"""

from __future__ import annotations

import types

import torch
import torch.nn.functional as F

from hvt_torch.ops import _build
from hvt_torch.ops._build import I, L, P

CONV_KERNEL = _build.Kernel("int8_conv", "hvt_int8_conv",
                            [P, P, P, P, P, P] + [I] * 17 + [P])
DEQUANT_KERNEL = _build.Kernel("int8_conv", "hvt_int8_dequant",
                               [P, P, P, P, P, L, I, I, I, P])
_OUT_KINDS = {None: 0, torch.float32: 1, torch.bfloat16: 2}
MAX_K = (2 ** 31 - 1) // (127 * 127)  # the longest sum that stays inside int32


INT_MM = types.SimpleNamespace(launches=0)  # the torch._int_mm calls made on the card


def _check_k(k: int, what: str) -> None:
    if k < 1 or k > MAX_K:
        raise ValueError(f"{what}: a sum over {k} int8 products does not fit int32 "
                         f"(at most {MAX_K})")


def dequant_plain(acc: torch.Tensor, sx, sw, bias, out_dtype):
    """hvt's epilogue on an int32 ``acc`` (…, N): f32(acc)·(sx·sw), + bias, cast."""
    if out_dtype is None:
        return acc
    y = acc.float() * (sx * sw)
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype)


def linear_acc_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(…, K) int8 · (N, K) int8ᵀ → (…, N) int32, summed exactly in f64."""
    return (xq.double() @ wq.double().t()).to(torch.int32)


def conv_out_hw(h: int, w: int, kh: int, kw: int, stride, pads) -> tuple[int, int]:
    """The output grid of a conv on an (h, w) map, pads (top, bottom, left, right)."""
    return ((h + pads[0] + pads[1] - kh) // stride[0] + 1,
            (w + pads[2] + pads[3] - kw) // stride[1] + 1)


def conv_acc_plain(xq: torch.Tensor, wq: torch.Tensor, stride, pads, groups: int) -> torch.Tensor:
    """NHWC int8 x, HWIO int8 w (KH, KW, C/groups, O) → NHWC int32, summed
    exactly in f64 over an unfold of the padded input."""
    n, h, w, c = xq.shape
    kh, kw, cg, o = wq.shape
    oh, ow = conv_out_hw(h, w, kh, kw, stride, pads)
    x = F.pad(xq.permute(0, 3, 1, 2).double(), (pads[2], pads[3], pads[0], pads[1]))
    cols = F.unfold(x, (kh, kw), stride=tuple(stride))  # (N, C·KH·KW, L), c-major
    cols = cols.view(n, groups, cg * kh * kw, oh * ow)
    wmat = wq.permute(3, 2, 0, 1).reshape(groups, o // groups, cg * kh * kw).double()
    acc = torch.einsum("gok,ngkl->ngol", wmat, cols)
    return acc.reshape(n, o, oh, ow).permute(0, 2, 3, 1).to(torch.int32)


def _scale_args(sx, sw, bias, device):
    sx = sx.reshape(()).to(device=device, dtype=torch.float32).contiguous()
    sw = sw.reshape(-1).to(device=device, dtype=torch.float32).contiguous()
    b = None if bias is None else bias.reshape(-1).to(device=device, dtype=torch.float32).contiguous()
    return sx, sw, b


def _ceil(v: int, m: int) -> int:
    return -(-v // m) * m


def int8_linear(xq: torch.Tensor, wq: torch.Tensor, sx, sw, bias=None, out_dtype=None):
    """(…, K) int8 activation · (N, K) int8 weightᵀ → (…, N) in ``out_dtype``
    through hvt's epilogue (int32 with ``out_dtype`` None)."""
    k, n = xq.shape[-1], wq.shape[0]
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or wq.shape[1] != k:
        raise ValueError(f"int8_linear: int8 (…, K) · (N, K) expected, got {xq.dtype} "
                         f"{tuple(xq.shape)} · {wq.dtype} {tuple(wq.shape)}")
    _check_k(k, "int8_linear")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"int8_linear: out dtype {out_dtype} (float32, bfloat16 or None)")
    lead = xq.shape[:-1]
    if xq.device.type != "cuda":
        acc = linear_acc_plain(xq.reshape(-1, k), wq).reshape(*lead, n)
        return dequant_plain(acc, sx, sw, bias, out_dtype)
    return _linear_cuda(xq.reshape(-1, k), wq, sx, sw, bias, out_dtype).reshape(*lead, n)


def _linear_cuda(x2: torch.Tensor, wq: torch.Tensor, sx, sw, bias, out_dtype):
    m, k = x2.shape
    n = wq.shape[0]
    if wq.device != x2.device:
        raise ValueError(f"int8_linear: x on {x2.device}, w on {wq.device}")
    mp = m if m > 16 else 32
    kp, np_ = _ceil(k, 8), _ceil(n, 8)
    if (mp, kp) != (m, k) or not x2.is_contiguous() or x2.data_ptr() % 16:
        padded = x2.new_zeros((mp, kp))
        padded[:m, :k] = x2
        x2 = padded
    if (np_, kp) != (n, k) or not wq.is_contiguous() or wq.data_ptr() % 16:
        padded = wq.new_zeros((np_, kp))
        padded[:n, :k] = wq
        wq = padded
    acc = torch._int_mm(x2, wq.t())  # (mp, np_) int32
    INT_MM.launches += 1
    out = torch.empty((m, n), device=x2.device,
                      dtype=torch.int32 if out_dtype is None else out_dtype)
    sx, sw, b = _scale_args(sx, sw, bias, x2.device)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    DEQUANT_KERNEL(acc.data_ptr(), sx.data_ptr(), sw.data_ptr(), 0 if b is None else b.data_ptr(),
                   out.data_ptr(), m * n, n, np_, _OUT_KINDS[out_dtype], stream)
    return out


def _norm_stride(stride) -> tuple[int, int]:
    return (stride, stride) if isinstance(stride, int) else (int(stride[0]), int(stride[1]))


def int8_conv2d(xq: torch.Tensor, wq: torch.Tensor, sx, sw, bias=None, out_dtype=None, *,
                stride=1, pads=(0, 0, 0, 0), groups: int = 1):
    """NHWC int8 x (N, H, W, C) and HWIO int8 w (KH, KW, C/groups, O) → NHWC
    (N, OH, OW, O) in ``out_dtype`` through hvt's epilogue (int32 with
    ``out_dtype`` None); ``pads`` (top, bottom, left, right) as flax resolves
    them."""
    stride, pads = _norm_stride(stride), tuple(int(p) for p in pads)
    n, h, w, c = xq.shape
    kh, kw, cg, o = wq.shape
    if (xq.dtype != torch.int8 or wq.dtype != torch.int8 or groups < 1 or c % groups
            or o % groups or cg * groups != c or min(stride) < 1 or min(pads) < 0):
        raise ValueError(f"int8_conv2d: int8 NHWC x {tuple(xq.shape)} and HWIO w "
                         f"{tuple(wq.shape)} with groups {groups}, stride {stride}, pads {pads}")
    _check_k(kh * kw * cg, "int8_conv2d")
    if out_dtype not in _OUT_KINDS:
        raise ValueError(f"int8_conv2d: out dtype {out_dtype} (float32, bfloat16 or None)")
    oh, ow = conv_out_hw(h, w, kh, kw, stride, pads)
    if oh < 1 or ow < 1:
        raise ValueError(f"int8_conv2d: a {kh}x{kw} kernel leaves no output on {h}x{w}")
    if xq.device.type != "cuda":
        return dequant_plain(conv_acc_plain(xq, wq, stride, pads, groups), sx, sw, bias, out_dtype)
    return _conv_cuda(xq, wq, sx, sw, bias, out_dtype, stride, pads, groups, oh, ow)


def _conv_cuda(xq, wq, sx, sw, bias, out_dtype, stride, pads, groups, oh, ow):
    if wq.device != xq.device:
        raise ValueError(f"int8_conv2d: x on {xq.device}, w on {wq.device}")
    if not xq.is_contiguous() or not wq.is_contiguous():
        raise ValueError("int8_conv2d: the kernel takes contiguous NHWC x and HWIO w")
    n, h, w, c = xq.shape
    kh, kw, cg, o = wq.shape
    out = torch.empty((n, oh, ow, o), device=xq.device,
                      dtype=torch.int32 if out_dtype is None else out_dtype)
    sx, sw, b = _scale_args(sx, sw, bias, xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    CONV_KERNEL(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                0 if b is None else b.data_ptr(), out.data_ptr(),
                n, h, w, c, kh, kw, o, groups, stride[0], stride[1], pads[0], pads[2],
                oh, ow, _OUT_KINDS[out_dtype], xq.data_ptr() % 8, wq.data_ptr() % 8, stream)
    return out
