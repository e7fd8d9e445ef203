"""The port's SwinV2 forward against hvt's, on the CPU in f32.

The same flax parameter tree — every leaf drawn from a seeded numpy
generator, so the zero-initialised res-post-norm cannot hide a branch — runs
through hvt's ``SwinTransformerV2.apply(train=False)`` and, after
``hvt_torch.models.convert.swin_params_from_flax``, through the port on
``device="cpu"`` (the kernels' plain versions). Both routes:

* ``fuse=False``: hvt's jnp attention oracle vs the port's packed path;
  both f32, tolerance max|Δ| ≤ 1e-4·max|ref|.
* ``fuse=True``: hvt's fused Pallas halves in interpret mode vs the port's
  plain fused halves; both round matmul operands to bf16, so a product can
  land on the other side of a rounding boundary: max|Δ| ≤ 2e-2·max|ref|,
  the JAX suite's own rule for these kernels.

Two geometries: ``swinv2_micro`` (window 4) and a tiny SwinV2-T geometry
(embed 96, depths 2-2, heads 3-6, window 7, 56 px) with the real N = 49,
head dim 32, a shifted block and a global-window stage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt.models import swinv2 as jswin
from hvt_torch.models import convert
from hvt_torch.models import swinv2 as tswin
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GEOMETRIES = {
    # name: (hvt builder kwargs, image size)
    "micro": (dict(embed_dim=16, depths=(1, 1), num_heads=(2, 4), window_size=4), 32),
    "tiny": (dict(embed_dim=96, depths=(2, 2), num_heads=(3, 6), window_size=7), 56),
}
NUM_CLASSES = 10
BATCH = 2


def _randomize(shapes, seed):
    """A param tree of the given shapes, every leaf drawn at a scale that keeps
    activations O(1): LN scales around 1, logit scales around log 10."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name = path[-1].key
        shape = sds.shape
        if name == "scale":
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name == "logit_scale":
            return np.log(10.0) + 0.3 * rng.normal(size=shape)
        if name in ("bias", "q_bias", "v_bias", "cpb_b1"):
            return 0.1 * rng.normal(size=shape)
        if name == "cpb_w1":
            return rng.normal(size=shape)
        fan_in = int(np.prod(shape[:-1]))  # Dense/Conv kernels, qkv_kernel, cpb_w2
        return rng.normal(size=shape) / np.sqrt(fan_in)

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _jax_model(geometry, fuse, num_classes=NUM_CLASSES):
    kw, _ = GEOMETRIES[geometry]
    return jswin.SwinTransformerV2(num_classes=num_classes, dtype=jnp.float32, fuse=fuse,
                                   drop_path_rate=0.0, **kw)


def _port_model(geometry, fuse, tree, num_classes=NUM_CLASSES):
    kw, _ = GEOMETRIES[geometry]
    model = tswin.SwinTransformerV2(num_classes=num_classes, dtype=torch.float32, fuse=fuse, **kw)
    return convert.swin_params_from_flax(model, tree).eval()


@pytest.fixture(scope="module")
def trees():
    """One randomized tree and input batch per geometry (hvt's params are
    identical for both routes, so shapes come from one fuse=False trace)."""
    out = {}
    for i, (name, (_, img)) in enumerate(GEOMETRIES.items()):
        x = np.random.default_rng(10 + i).normal(size=(BATCH, img, img, 3)).astype(np.float32)
        shapes = jax.eval_shape(
            lambda: _jax_model(name, False).init(jax.random.key(0), jnp.asarray(x), train=False)
        )["params"]
        out[name] = (_randomize(shapes, seed=20 + i), x)
    return out


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


@pytest.mark.parametrize("fuse,tol", [(False, 1e-4), (True, 2e-2)])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_logits_match_hvt(trees, geometry, fuse, tol):
    tree, x = trees[geometry]
    ref = _jax_model(geometry, fuse).apply({"params": tree}, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = _port_model(geometry, fuse, tree)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, ref, tol, f"{geometry} fuse={fuse} logits")


def test_routes_agree_and_branches_are_live(trees):
    """The fused and unfused port routes agree on one tree, and a randomized
    res-post-norm makes every block's branch matter (zeroing norm1 changes
    the logits), so the parity above is not the identity-block trap."""
    tree, x = trees["tiny"]
    with torch.inference_mode():
        a = _port_model("tiny", False, tree)(torch.from_numpy(x))
        b = _port_model("tiny", True, tree)(torch.from_numpy(x))
        model = _port_model("tiny", False, tree)
        model.stage0_block1.norm1.weight.zero_()
        c = model(torch.from_numpy(x))
    _close(b, a, 2e-2, "fused vs unfused")
    assert float((c - a).abs().max()) > 1e-3


def test_features_only_and_eval_guard(trees):
    tree, x = trees["micro"]
    model = _port_model("micro", False, tree)
    with torch.inference_mode():
        feats = model(torch.from_numpy(x), features_only=True)
    ref = _jax_model("micro", False).apply({"params": tree}, jnp.asarray(x), train=False,
                                           features_only=True)
    _close(feats, ref, 1e-4, "features")
    # train mode runs on both routes, and the fused one reaches every parameter
    model.train()
    assert torch.isfinite(model(torch.from_numpy(x))).all()
    fused = _port_model("micro", True, tree).train()
    out = fused(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all()
    out.square().sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in fused.parameters())


def test_multitask_head_and_top_down_decode():
    """Per-tier logits of a multitask head match hvt's, and the constrained
    top-down decode over them picks the same tiers and masks the same way."""
    from hvt.downstream import predict as jpredict
    from hvt.data import synthetic as jsyn
    from hvt import hierarchy as jhier
    from hvt_torch.downstream import predict as tpredict
    from hvt_torch import hierarchy as thier

    classes = jsyn.synthetic_class_names(12)
    _, num_classes = jhier.assign_tier_indices(classes)
    assert thier.assign_tier_indices(classes)[1] == num_classes
    x = np.random.default_rng(3).normal(size=(4, 32, 32, 3)).astype(np.float32)
    jm = _jax_model("micro", False, num_classes=num_classes)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.asarray(x), train=False))
    tree = _randomize(shapes["params"], seed=7)
    ref = jm.apply({"params": tree}, jnp.asarray(x), train=False)
    with torch.inference_mode():
        got = _port_model("micro", False, tree, num_classes=num_classes)(torch.from_numpy(x))
    assert len(got) == len(ref) == 7
    for t, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, 1e-4, f"tier {t}")

    lookups = jhier.parent_lookup_from_classes(classes)
    for a, b in zip(lookups, thier.parent_lookup_from_classes(classes)):
        np.testing.assert_array_equal(a, b)
    logits = [np.asarray(r) for r in ref]
    jp, jmask, jn = jpredict._top_down_decode([jnp.asarray(v) for v in logits], lookups)
    tp, tmask, tn = tpredict._top_down_decode([torch.from_numpy(v) for v in logits], lookups)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy())
    np.testing.assert_array_equal(np.asarray(jn), tn.numpy())
    jout = jpredict._decode_topk([jnp.asarray(v) for v in logits], lookups, 3)
    tout = tpredict._decode_topk([torch.from_numpy(v) for v in logits], lookups, 3)
    jout = [np.asarray(v) for v in jout]
    tout = [v.numpy() for v in tout]
    np.testing.assert_array_equal(jout[2], tout[2])  # tier predictions
    # Past a row's n_allowed children every probability is exactly 0, a tie
    # the two top-k implementations break differently; the served record
    # stops at n_allowed, so the records are what must agree.
    for row in range(len(x)):
        a = jpredict.topk_record(classes, row, *jout, 3)
        b = tpredict.topk_record(classes, row, *tout, 3)
        assert a["classes"] == b["classes"] and a["class_ids"] == b["class_ids"]
        assert a["tier_ids"] == b["tier_ids"]
        np.testing.assert_allclose(a["probs"], b["probs"], atol=2e-6)


def test_convert_rejects_unknown_and_misshapen_params(trees):
    tree, _ = trees["micro"]
    model = tswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=torch.float32,
                                    **GEOMETRIES["micro"][0])
    with pytest.raises(KeyError):
        convert.swin_params_from_flax(model, {**tree, "absolute_pos_embed": np.zeros((1,))})
    bad = dict(tree)
    bad["head"] = {"kernel": np.zeros((3, 3), np.float32), "bias": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="head.weight"):
        convert.swin_params_from_flax(model, bad)


def test_factory_builds_swin_and_names_unported_families():
    from hvt_torch import config as tconfig
    from hvt_torch.models import build_model

    cfg = tconfig.loads({"model": {"name": "swinv2_micro", "args": {"fuse": True}},
                         "precision": {"compute_dtype": "float32"}, "seed": 3})
    model = build_model(cfg, 5)
    assert isinstance(model, tswin.SwinTransformerV2) and model.dtype == torch.float32
    assert model.stage0_block0.fuse
    # zero-initialised res-post-norm, as hvt's init
    assert float(model.stage0_block0.norm1.weight.abs().sum()) == 0.0
    again = build_model(cfg, 5)
    torch.testing.assert_close(model.state_dict(), again.state_dict())  # seeded
    from hvt_torch.models.convnext import ConvNeXt

    with torch.device("meta"):
        assert isinstance(build_model(tconfig.loads({"model": {"name": "convnext_tiny"}}), 5),
                          ConvNeXt)
    with pytest.raises(ValueError, match="unknown model 'swinv2_huge'"):
        build_model(tconfig.loads({"model": {"name": "swinv2_huge"}}), 5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(tconfig.loads({"model": {"name": "swinv2_micro", "args": {"pipe": 2}}}), 5)


@pytest.mark.parametrize("name,fuse,image_size,stages", [
    ("swinv2_tiny", False, 224, []),
    ("swinv2_tiny", True, 224, []),
    ("swinv2_tiny_window8_256", True, 256, []),
    ("swinv2_tiny_window16_256", False, 256, [1, 2, 3]),  # 256 tokens: N x N logits overflow smem
    ("swinv2_base", True, 224, []),  # widths 128-1024, stage 4's MLP chunked in training
    ("swinv2_large", True, 224, [4]),  # width 1536
    # 144-token windows, width 1536; in training hvt does not fuse stage 3's
    # attention half (fits_vmem) and takes its XLA route, which needs no kernel
    ("swinv2_large_window12_192", True, 192, ([1, 2, 3, 4], [1, 2, 4])),
])
def test_cuda_unsupported_names_the_stages_the_kernels_cannot_take(name, fuse, image_size, stages):
    """The same stages in eval and in training (forward and backward),
    unless the case gives (eval, training)."""
    with torch.device("meta"):  # the structure only: no weights drawn
        model = getattr(tswin, name)(10, fuse=fuse)
    for training in (False, True):
        want = stages[training] if isinstance(stages, tuple) else stages
        found = model.cuda_unsupported(image_size, training=training)
        assert [int(line.split()[1]) for line in found] == want, (training, found)
