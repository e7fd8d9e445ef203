"""The MLP half's forward chain on the CPU: its plan, its refusals and its
plain version.

* ``mlp_fwd_plan``, the helper both forward wrappers call: at every SwinV2-T
  and SwinV2-B stage shape at batch 1, 64 and 128, fc1's and fc2's grids
  cover each (row tile, column tile) of h (T, 4C) and of the pre-LN sum
  (T, C) once, fc2's tile width is one the C entry takes, and the forward's
  scratch (h and the f32 sum) is no larger than the backward's
  (``_mlp_bwd_buffers``, shapes only, on the meta device);
* ``mlp_unsupported`` and ``chunked_unsupported``: the kernels take C at
  run time, a multiple of 32 up to 1024 (the LayerNorm passes' register
  buckets) with hidden 4C, and refuse the rest naming why;
* ``SwinTransformerV2.cuda_unsupported``: the same lines as before the
  chain for every SwinV2 variant of the factory, only the reason of the one
  MLP line (swinv2_large's C = 1536) naming the LayerNorm bucket;
* the port's plain MLP forward against hvt's ``mlp_half`` in interpret
  mode at C = 96 and 128 (test_torch_port_ops.py holds C = 64), residual on
  and off. Both round matmul operands to bf16 (hvt's ``_dot``), so a
  product can land on the other side of a rounding boundary: max|Δ| ≤
  2e-2·max|ref|, the rule of tests/test_fused_halves.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.ops import fused_halves_pallas as jfh
from hvt_torch.models import factory
from hvt_torch.models import swinv2 as tswin
from hvt_torch.ops import fused_halves_cuda as fh
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# (grid, C) of each stage at 224 px
SWINV2_T = ((56, 96), (28, 192), (14, 384), (7, 768))
SWINV2_B = ((56, 128), (28, 256), (14, 512), (7, 1024))


def _intervals(tiles: int, size: int, extent: int):
    return [(i * size, min((i + 1) * size, extent)) for i in range(tiles)]


def _covers_once(tiles: int, size: int, extent: int) -> bool:
    """Whether ``tiles`` tiles of ``size`` cover [0, extent) once: none
    empty, each starting where the last ended, the last ending at extent."""
    spans = _intervals(tiles, size, extent)
    return (all(lo < hi for lo, hi in spans) and spans[0][0] == 0 and spans[-1][1] == extent
            and all(a[1] == b[0] for a, b in zip(spans, spans[1:])))


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("batch", [1, 64, 128])
@pytest.mark.parametrize("grid,c", SWINV2_T + SWINV2_B)
def test_forward_plan_covers_each_tile_once(batch, grid, c):
    t = batch * grid * grid
    plan = fh.mlp_fwd_plan(t, c)
    for product, cols in (("fc1", 4 * c), ("fc2", c)):
        (rows, width), (col_tiles, row_tiles) = plan[product]
        assert rows == fh.TILE_ROWS
        assert _covers_once(row_tiles, rows, t), (product, t)
        assert _covers_once(col_tiles, width, cols), (product, cols, width)
    assert plan["fc1"][0][1] == fh.FC1_COLS and (4 * c) % fh.FC1_COLS == 0
    assert plan["fc2"][0][1] in fh.FC2_COLS
    x = torch.empty((t, c), dtype=torch.bfloat16, device="meta")
    scratch = fh._mlp_fwd_scratch(x, plan)
    assert [tuple(s.shape) for s in scratch] == [(t, 4 * c), (t, c)]
    assert [s.dtype for s in scratch] == [torch.bfloat16, torch.float32]
    _, bwd_scratch, _ = fh._mlp_bwd_buffers(x)
    assert _bytes(scratch) <= _bytes(bwd_scratch)


def test_forward_plan_masks_the_last_fc2_tile_at_other_widths():
    """Widths that are not a multiple of fc2's widest tile (160, 96, 192,
    64): every column is covered once, the last tile part full only where C
    is a multiple of none of 128, 96 and 64 (160)."""
    for c, tiles in ((160, 3), (96, 1), (192, 2), (64, 1), (1024, 8)):
        (_, width), (col_tiles, _) = fh.mlp_fwd_plan(300, c)["fc2"]
        assert col_tiles == tiles and _covers_once(col_tiles, width, c)


@pytest.mark.parametrize("c", [64, 160, 96, 1024])
def test_mlp_kernels_take_c_at_run_time(c):
    assert fh.mlp_unsupported(c, 4 * c, 1, training=False) is None
    assert fh.chunked_unsupported(c, 4 * c, 2) is None
    assert fh.mlp_unsupported(c, 4 * c, 2, training=True) is None
    if c <= fh.MLP_BWD_MAX_WIDTH:
        assert fh.mlp_unsupported(c, 4 * c, 1, training=True) is None


@pytest.mark.parametrize("c,hidden", [(1536, 6144), (1056, 4224), (80, 320), (96, 256), (128, 1024)])
def test_mlp_kernels_refuse_what_they_do_not_take(c, hidden):
    whys = [fh.mlp_unsupported(c, hidden, 1, training=False), fh.chunked_unsupported(c, hidden, 2),
            fh.mlp_unsupported(c, hidden, 4, training=True)]
    for why in whys:
        assert why is not None
        if hidden != 4 * c:
            assert "is not 4C" in why, why
        else:  # too wide or not a multiple of 32 for one warp's register buckets
            assert "LayerNorm" in why and "buckets" in why and "1024" in why, why
    assert fh.mlp_unsupported(c, hidden, 0, training=True) is None  # plain PyTorch takes any


_BUILT = "(96, 192, 384, 768, 128, 256, 512, 1024)"
_BWD_64 = "the backward kernel takes head dim 32 and windows of at most 64 tokens, not head dim"
_W1536 = ("width 1536: the MLP kernels' LayerNorm passes hold a row in one warp's registers, in "
          "buckets of at most 32 registers of 32 columns: C a multiple of 32 up to 1024")
_MICRO_FUSED = [f"stage 1 (fused): width 16 is not one the kernels are built for {_BUILT}",
                f"stage 2 (fused): width 32 is not one the kernels are built for {_BUILT}"]
_MICRO_UNFUSED_TRAIN = [f"stage {s} (unfused): {_BWD_64} 8 and 16 tokens" for s in (1, 2)]
_SMEM_256 = "windows of 256 tokens at head dim 32 need 364544 B of shared memory (the card has 232448)"
# (name, image size) -> {(fuse, training): lines}; every case not listed gives none
CUDA_UNSUPPORTED = {
    ("swinv2_micro", 224): {(False, True): _MICRO_UNFUSED_TRAIN, (True, False): _MICRO_FUSED,
                            (True, True): _MICRO_FUSED},
    ("swinv2_micro_deep", 224): {(False, True): _MICRO_UNFUSED_TRAIN, (True, False): _MICRO_FUSED,
                                 (True, True): _MICRO_FUSED},
    ("swinv2_tiny", 224): {},
    ("swinv2_tiny_window8_256", 256): {},
    ("swinv2_tiny_window16_256", 256): {
        (False, False): [f"stage {s} (unfused): {_SMEM_256}" for s in (1, 2, 3)],
        (False, True): [f"stage {s} (unfused): {_BWD_64} 32 and 256 tokens" for s in (1, 2, 3)],
        (True, False): [f"stage {s} (fused): windows of 256 tokens are more than 64" for s in (1, 2)],
        (True, True): [f"stage {s} (fused): windows of 256 tokens are more than 64" for s in (1, 2)],
    },
    ("swinv2_small", 224): {},
    ("swinv2_base", 224): {},
    ("swinv2_large", 224): {
        (True, False): [f"stage 4 (fused): width 1536 is not one the kernels are built for {_BUILT}"],
        (True, True): [f"stage 4 (fused): {_W1536}"],
    },
    ("swinv2_large_window12_192", 192): {
        (False, True): [f"stage {s} (unfused): {_BWD_64} 32 and 144 tokens" for s in (1, 2, 3)],
        (True, False): [f"stage {s} (fused): windows of 144 tokens are more than 64" for s in (1, 2, 3)]
        + [f"stage 4 (fused): width 1536 is not one the kernels are built for {_BUILT}"],
        (True, True): [f"stage {s} (fused): windows of 144 tokens are more than 64" for s in (1, 2)]
        + [f"stage 4 (fused): {_W1536}"],
    },
}


def test_cuda_unsupported_lists_every_swinv2_variant():
    assert sorted(name for name, _ in CUDA_UNSUPPORTED) == sorted(factory._SWIN)


@pytest.mark.parametrize("name,image_size", sorted(CUDA_UNSUPPORTED))
def test_cuda_unsupported_lines_are_unchanged(name, image_size):
    """The lines SwinTransformerV2.cuda_unsupported gave before the MLP
    forward took C at run time, on both routes, in eval and in training:
    the attention kernels still refuse what they refused, and the MLP
    refuses only C = 1536, now naming the LayerNorm bucket."""
    want = CUDA_UNSUPPORTED[(name, image_size)]
    for fuse in (False, True):
        with torch.device("meta"):  # the structure only: no weights drawn
            model = getattr(tswin, name)(10, fuse=fuse)
        for training in (False, True):
            found = model.cuda_unsupported(image_size, training=training)
            assert found == want.get((fuse, training), []), (fuse, training, found)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("c", [96, 128])
@pytest.mark.parametrize("resid", [False, True])
def test_plain_mlp_forward_matches_pallas(c, resid):
    rng = np.random.default_rng(c + resid)
    b, tpi = 4, 16
    p = {"w1": rng.normal(size=(c, 4 * c)) / math.sqrt(c), "b1": rng.normal(size=4 * c) * 0.1,
         "w2": rng.normal(size=(4 * c, c)) / math.sqrt(4 * c), "b2": rng.normal(size=c) * 0.1,
         "lns": 1.0 + rng.normal(size=c) * 0.1, "lnb": rng.normal(size=c) * 0.1}
    x = rng.normal(size=(b * tpi, c)).astype(np.float32)
    s = np.asarray([0.0, 1.25, 1.25, 1.0], np.float32)  # dropped, kept at 1/keep, eval
    jargs = [jnp.asarray(p[k], jnp.float32) for k in ("w1", "b1", "w2", "b2", "lns", "lnb")]
    targs = [_t(p["w1"].T), _t(p["b1"]), _t(p["w2"].T), _t(p["b2"]), _t(p["lns"]), _t(p["lnb"])]
    before = fh.MLP_KERNEL.launches
    if resid:
        dp = jnp.broadcast_to(jnp.asarray(s)[:, None, None], (b, 8, 128))
        ref = jfh.mlp_half(jnp.asarray(x), *jargs, True, tpi, dp=dp)
        got = fh.mlp_half(_t(x), *targs, tpi=tpi, dp=_t(s))
    else:
        ref = jfh.mlp_half(jnp.asarray(x), *jargs, True)
        got = fh.mlp_half(_t(x), *targs)
    assert fh.MLP_KERNEL.launches == before  # a CPU tensor never reaches the kernel
    got, ref = got.numpy().astype(np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= 2e-2 * scale, f"C={c} resid={resid}: max|Δ| {err:.3g} > 2e-2·{scale:.3g}"
