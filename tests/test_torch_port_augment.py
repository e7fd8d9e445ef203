"""The port's device augmentations and the train step that runs them,
against hvt's, on the CPU.

Every apply function gets the draws hvt's own ``jax.random`` lines make
from the same key (``_hvt_*`` below), since JAX's streams cannot be made
without JAX; the port's draw functions are held to hvt's laws in
distribution instead. Tolerances:

* MixUp and CutMix (flat and multitask targets), f32: images and targets
  within 1e-6 (the same f32 arithmetic);
* device ColOut, uint8: within 1 on under 1% of pixels (its f32 resize
  rounds to the nearest level; a sum in another order can tip one);
* ``progressive_resize`` at each bucket of 224 px and of 56 px: f32
  within 1e-5·max|x|; bf16 within one bf16 ulp of hvt's value at 224 px
  (two bf16 contractions in jax's order, each summed in f32, in another
  order), and at 56 px one ulp of max|x| more (an intermediate rounded
  apart);
* device RandAugment with hvt's op, sign and permutation: pointwise ops
  bit-equal, geometric ops within 1 on under 1% of pixels (hvt's own
  limits, tests/test_data.py), the stratified and the iid policy, depth 1
  and 2, batches smaller and larger than the 13 ops;
* one train step of a small ResNet with every augmentation and a scale of
  0.5, the draws passed in, against hvt's step run op by op (jitted, XLA's
  fusion moves hvt's geometric ops by a level on a few pixels): the loss
  within 1e-5 relative and every
  parameter and running statistic within 1e-5·max|ref|, the tolerances of
  ``tests/test_torch_port_resnet.py``'s trajectory;
* a CPU resume with every augmentation on: bit-equal to the straight run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hvt import objectives as jobjectives
from hvt.data import device as jdevice
from hvt.data import randaugment as jra
from hvt.models import resnet as jresnet
from hvt.train import algorithms as jalgorithms
from hvt.train import optim as joptim
from hvt.train import schedule as jschedule
from hvt.train import step as jstep
from hvt.train.state import TrainState
from hvt_torch import config as tconfig
from hvt_torch import objectives as tobjectives
from hvt_torch.data import device as tdevice
from hvt_torch.data import randaugment as tra
from hvt_torch.models import convert
from hvt_torch.models import resnet as tresnet
from hvt_torch.train import algorithms as talgorithms
from hvt_torch.train import checkpoint as tckpt
from hvt_torch.train import optim as toptim
from hvt_torch.train import schedule as tschedule
from hvt_torch.train import step as tstep
from hvt_torch.train.loop import Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUM_CLASSES = 10
TIERS = (2, 3, 5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _near_uint8(got, ref, what):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(ref).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (what, d.max(), (d > 0).mean())


def _images(seed, b=6, h=33, w=29):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    gy, gx = np.mgrid[0:h, 0:w]
    imgs[1] = np.stack([gx * 4 + gy * 3] * 3, -1).astype(np.uint8)  # smooth content
    imgs[2] = 7  # constant: the identity branches
    return imgs


# hvt's draws, by hvt's own jax.random lines -----------------------------------


def _hvt_mixup(key):
    return torch.tensor(float(jax.random.beta(key, 0.2, 0.2, dtype=jnp.float32)))


def _hvt_cutmix(key, h, w, alpha=1.0):
    kbeta, kx, ky = jax.random.split(key, 3)
    lam = float(jax.random.beta(kbeta, alpha, alpha, dtype=jnp.float32))
    cy, cx = int(jax.random.randint(ky, (), 0, h)), int(jax.random.randint(kx, (), 0, w))
    return torch.tensor(lam), torch.tensor(cy), torch.tensor(cx)


def _hvt_colout(key, b, h, w, p_row, p_col):
    keep_h, keep_w = tdevice.colout_keep(h, w, p_row, p_col)
    if keep_h >= h and keep_w >= w:
        return None
    kr, kc = jax.random.split(key)

    def keep(k, n, m):
        return jnp.sort(jax.random.permutation(k, n)[:m])

    rows = jax.vmap(lambda k: keep(k, h, keep_h))(jax.random.split(kr, b))
    cols = jax.vmap(lambda k: keep(k, w, keep_w))(jax.random.split(kc, b))
    return _t(rows).long(), _t(cols).long()


def _hvt_rand_augment(key, b, depth, stratified):
    draws = []
    for _ in range(depth):
        if stratified:
            key, kr = jax.random.split(key)
            kperm, ksign = jax.random.split(kr)
            choice = jax.random.permutation(kperm, b)
        else:
            key, kop, ksign = jax.random.split(key, 3)
            choice = jax.random.randint(kop, (b,), 0, len(tra.OP_NAMES))
        sign = jnp.where(jax.random.bernoulli(ksign, 0.5, (b,)), 1.0, -1.0)
        draws.append((_t(choice).long(), _t(sign).float()))
    return draws


# ---------------------------------------------------------------------------
# MixUp, CutMix, ColOut, progressive resizing
# ---------------------------------------------------------------------------


def _targets(labels, multitask):
    if multitask:
        return (jdevice.prepare_targets(jnp.asarray(labels), TIERS, 0.1),
                tdevice.prepare_targets(_t(labels), TIERS, 0.1))
    return (jdevice.prepare_targets(jnp.asarray(labels[:, 0]), NUM_CLASSES, 0.1),
            tdevice.prepare_targets(_t(labels[:, 0]), NUM_CLASSES, 0.1))


def _same_targets(got, ref, what):
    if isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r, 1e-6, what)
    else:
        _close(got, ref, 1e-6, what)


@pytest.mark.parametrize("multitask", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_and_cutmix_match_hvt_given_its_draws(multitask, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(6, 20, 18, 3)).astype(np.float32)
    labels = np.stack([rng.integers(0, n, 6) for n in TIERS], 1).astype(np.int32)
    jt, tt = _targets(labels, multitask)
    key = jax.random.key(seed)
    ref_x, ref_t = jdevice.mixup(key, jnp.asarray(x), jt, 0.2)
    got_x, got_t = tdevice.mixup(_t(x), tt, _hvt_mixup(key))
    _close(got_x, ref_x, 1e-6, "mixup images")
    _same_targets(got_t, ref_t, "mixup targets")
    ref_x, ref_t = jdevice.cutmix(key, jnp.asarray(x), jt, 1.0)
    got_x, got_t = tdevice.cutmix(_t(x), tt, *_hvt_cutmix(key, 20, 18))
    _close(got_x, ref_x, 1e-6, "cutmix images")
    _same_targets(got_t, ref_t, "cutmix targets")


@pytest.mark.parametrize("p", [(0.05, 0.05), (0.15, 0.1), (0.5, 0.3)])
def test_device_colout_matches_hvt_given_its_draws(p):
    imgs = _images(3, b=5, h=40, w=36)
    for seed in range(3):
        key = jax.random.key(seed)
        ref = jdevice.colout(key, jnp.asarray(imgs), *p)
        got = tdevice.colout(_t(imgs), _hvt_colout(key, 5, 40, 36, *p))
        assert got.dtype == torch.uint8 and got.shape == imgs.shape
        _near_uint8(got, ref, f"colout {p}")
    assert tdevice.draw_colout(torch.Generator(), 2, 8, 8, 0.01, 0.01, "cpu") is None


@pytest.mark.parametrize("size", [224, 56])
def test_progressive_resize_matches_hvt_at_each_bucket(size):
    prog = talgorithms.ProgressiveResizing()
    scales = sorted({prog.scale_at(t / 100) for t in range(101)})
    assert scales == [0.5, 0.625, 0.75, 0.875, 1.0]
    if size == 224:
        assert [tdevice.resized_size(224, s) for s in scales] == [112, 136, 168, 192, 224]
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(np.float32) * 2
    for scale in scales:
        ref = np.asarray(jdevice.progressive_resize(jnp.asarray(x), scale))
        got = tdevice.progressive_resize(_t(x), scale).numpy()
        _close(got, ref, 1e-5, f"f32 at {scale}")
        refb = np.asarray(jdevice.progressive_resize(jnp.asarray(x).astype(jnp.bfloat16), scale)
                          .astype(jnp.float32))
        gotb = tdevice.progressive_resize(_t(x).bfloat16(), scale).float().numpy()
        assert gotb.shape == refb.shape
        # one bf16 ulp at hvt's value, 2^(exponent - 7); at 56 px (24/56 is
        # no ratio of small integers) the first contraction's bf16
        # intermediates may round apart, and each output, a convex
        # combination of them, moves by up to one ulp of max|x| more
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(refb), 1e-30))) - 7)
        if size != 224:
            ulp = ulp + 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)
        assert (np.abs(gotb - refb) <= ulp).all(), f"bf16 at {scale}"


# ---------------------------------------------------------------------------
# Device RandAugment
# ---------------------------------------------------------------------------

POINTWISE = ("autocontrast", "equalize", "posterize", "solarize", "color", "contrast",
             "brightness", "sharpness")
GEOMETRIC = ("rotate", "shear_x", "shear_y", "translate_x", "translate_y")


@pytest.mark.parametrize("name", POINTWISE + GEOMETRIC)
def test_each_device_op_matches_hvt(name):
    imgs = _images(4)
    b = len(imgs)
    for sev in (5, 9):
        for s in (1.0, -1.0):
            sign = np.full((b,), s, np.float32)
            factor = np.maximum(0.05, 1.0 + sign * (sev / 10 * 0.9)).astype(np.float32)
            ref = np.asarray(jra._apply_op_static(name, jnp.asarray(imgs), jnp.asarray(sign),
                                                  jnp.asarray(factor), sev))
            got = tra._apply_op_static(name, _t(imgs), _t(sign), _t(factor), sev).numpy()
            if name in POINTWISE:
                np.testing.assert_array_equal(got, ref, err_msg=f"{name} sev {sev} sign {s}")
            else:
                _near_uint8(got, ref, f"{name} sev {sev} sign {s}")
            op = np.full((b,), tra.OP_NAMES.index(name), np.int32)
            ref = np.asarray(jra._apply_one(jnp.asarray(imgs), jnp.asarray(op),
                                            jnp.asarray(sign), sev))
            got = tra._apply_one(_t(imgs), _t(op).long(), _t(sign), sev).numpy()
            if name in POINTWISE:
                np.testing.assert_array_equal(got, ref, err_msg=f"iid {name}")
            else:
                _near_uint8(got, ref, f"iid {name}")


@pytest.mark.parametrize("stratified", [True, False])
@pytest.mark.parametrize("b,depth", [(5, 1), (26, 1), (14, 2)])
def test_rand_augment_matches_hvt_given_its_draws(stratified, b, depth):
    imgs = np.concatenate([_images(s) for s in range(5)])[:b]
    for seed in range(2):
        key = jax.random.key(seed)
        ref = np.asarray(jra.rand_augment(key, jnp.asarray(imgs), depth, 9, stratified))
        got = tra.rand_augment(_t(imgs), _hvt_rand_augment(key, b, depth, stratified), 9,
                               stratified).numpy()
        _near_uint8(got, ref, f"rand_augment b={b} depth={depth}")
    with pytest.raises(ValueError, match="uint8"):
        tra.rand_augment(_t(imgs).float(), [], 9)


# ---------------------------------------------------------------------------
# The draws, by law
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_beta_draws_follow_beta(alpha):
    g = torch.Generator().manual_seed(0)
    lam = torch.stack([tdevice.draw_beta(g, alpha, "cpu") for _ in range(4000)]).double()
    assert lam.dtype == torch.float64 and ((lam >= 0) & (lam <= 1)).all()
    var = 1.0 / (4.0 * (2.0 * alpha + 1.0))  # Beta(α, α): mean 1/2
    assert abs(lam.mean().item() - 0.5) < 4 * (var / 4000) ** 0.5
    assert abs(lam.var().item() - var) < 0.1 * var
    # the same draw again from the same state
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert tdevice.draw_beta(g1, alpha, "cpu") == tdevice.draw_beta(g2, alpha, "cpu")


def test_cutmix_centres_and_colout_subsets_follow_hvts_laws():
    g = torch.Generator().manual_seed(1)
    centres = torch.stack([torch.stack(tdevice.draw_cutmix(g, 1.0, 7, 5, "cpu")[1:])
                           for _ in range(3500)])
    for axis, n in ((0, 7), (1, 5)):
        counts = torch.bincount(centres[:, axis], minlength=n).double()
        assert len(counts) == n and (abs(counts / counts.sum() - 1 / n) < 0.03).all()
    rows, cols = tdevice.draw_colout(g, 400, 40, 30, 0.1, 0.2, "cpu")
    assert rows.shape == (400, 36) and cols.shape == (400, 24)  # exactly round(p·n) dropped
    for kept, n in ((rows, 40), (cols, 30)):
        assert (kept[:, 1:] > kept[:, :-1]).all()  # sorted, distinct
        share = torch.bincount(kept.reshape(-1), minlength=n).double() / len(kept)
        assert (abs(share - kept.shape[1] / n) < 0.08).all()  # each row kept alike


def test_stratified_draws_give_each_op_its_share():
    g = torch.Generator().manual_seed(2)
    b = 30
    for choice, sign in tra.draw_rand_augment(g, b, 3, True, "cpu"):
        assert sorted(choice.tolist()) == list(range(b))
        assert set(sign.tolist()) <= {-1.0, 1.0}
    sizes = [b // 13 + (1 if i < b % 13 else 0) for i in range(13)]
    assert sizes == [3, 3, 3, 3] + [2] * 9 and sum(sizes) == b
    # each image lands on each op with probability (its slice size)/B
    hits = torch.zeros(13)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    for _ in range(300):
        (perm, _), = tra.draw_rand_augment(g, b, 1, True, "cpu")
        slot = torch.argsort(perm)[0].item()  # where image 0 went
        hits[int(np.searchsorted(offs, slot, side="right")) - 1] += 1
    expected = torch.tensor(sizes, dtype=torch.float32) / b
    assert (abs(hits / 300 - expected) < 0.07).all()
    ops = tra.draw_rand_augment(g, 13000, 1, False, "cpu")[0][0]
    assert (abs(torch.bincount(ops, minlength=13) / 13000 - 1 / 13) < 0.01).all()


def test_progressive_schedule_matches_hvt():
    for args in (dict(), dict(initial_scale=0.25, delay_fraction=0.1, finetune_fraction=0.3),
                 dict(initial_scale=1.0)):
        got, ref = talgorithms.ProgressiveResizing(**args), jalgorithms.ProgressiveResizing(**args)
        assert got.num_buckets == ref.num_buckets == 4
        for t in np.linspace(0.0, 1.0, 401):
            assert got.scale_at(float(t)) == ref.scale_at(float(t)), (args, t)


def test_every_algorithm_runs_in_the_step():
    """The algorithms the port once refused in part (SAM) parse into the
    step's settings with the augmentations, and one step of the micro ResNet
    runs them all: SAM at its default rho 0.05 and interval 1."""
    names = ["MixUp", "CutMix", "ProgressiveResizing", "SAM", "RandAugment", "ColOut"]
    layer = {"algorithms": [{"cls": n, "args": {"device": True} if n in ("RandAugment", "ColOut")
                             else {}} for n in names]}
    s = talgorithms.parse_algorithms(tconfig.loads(layer))
    assert (s.sam_rho, s.sam_interval) == (0.05, 1)
    settings = tstep.StepSettings(NUM_CLASSES, mixup_alpha=s.mixup_alpha,
                                  cutmix_alpha=s.cutmix_alpha, sam_rho=s.sam_rho,
                                  sam_interval=s.sam_interval, randaugment=s.randaugment_device,
                                  colout=s.colout_device)
    model = tresnet.resnet_micro_bottleneck(NUM_CLASSES)
    opt = toptim.Optimizer(model.named_parameters(), "adamw", 1e-3, 0.05, 0.9,
                           tschedule.cosine_with_warmup(1, 10))
    prep = tdevice.DevicePrep(mean=(0.5, 0.5, 0.5), std=(0.25, 0.25, 0.25),
                              compute_dtype=torch.float32)
    step = tstep.build_train_step(model, tobjectives.soft_cross_entropy, opt, prep, settings)
    rng = np.random.default_rng(2)
    stats = step(_t(rng.integers(0, 256, size=(4, 48, 48, 3), dtype=np.uint8)),
                 _t(rng.integers(0, NUM_CLASSES, size=4)), torch.ones(4),
                 torch.Generator().manual_seed(1), s.progressive.scale_at(0.0))
    assert all(bool(torch.isfinite(v)) for v in stats.values()) and opt.count == 1


# ---------------------------------------------------------------------------
# The train step with every augmentation
# ---------------------------------------------------------------------------


def _randomized(shapes, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, size=shape)
        elif name in ("bias", "mean"):
            a = 0.1 * rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) / np.sqrt(int(np.prod(shape[:-1])))
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def test_one_step_with_every_augmentation_matches_hvt():
    img, batch, scale = 48, 6, 0.5
    rng = np.random.default_rng(21)
    images = rng.integers(0, 256, size=(batch, img, img, 3), dtype=np.uint8)
    labels = rng.integers(0, NUM_CLASSES, size=batch).astype(np.int32)
    mask = np.ones(batch, np.float32)
    jm = jresnet.resnet_micro_bottleneck(NUM_CLASSES, stem_s2d=True)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, img, img, 3)),
                                            train=False))
    variables = _randomized(shapes, seed=22)
    mean, std = jdevice.scale_channel_stats((0.463, 0.480, 0.376), (0.238, 0.229, 0.247))
    lr, wd, momentum, clip, smoothing = 0.2, 5e-4, 0.875, 2.0, 0.08
    aug = dict(mixup_alpha=0.2, cutmix_alpha=1.0, randaugment=(1, 9, True), colout=(0.1, 0.1))

    # hvt, its draws from the step's key
    optim_cfg = type("Optim", (), dict(name="DecoupledSGDW", lr=lr, weight_decay=wd,
                                       momentum=momentum))
    tx = joptim.build_optimizer(optim_cfg, jschedule.cosine_with_warmup(1, 10),
                                grad_clip_norm=clip, no_decay_substrings=())
    jprep = jdevice.DevicePrep(mean=mean, std=std, compute_dtype=jnp.float32)
    jtrain = jstep.build_train_step(jm, jobjectives.soft_cross_entropy, tx, jprep,
                                    jstep.StepSettings(num_classes=NUM_CLASSES,
                                                       smoothing=smoothing, **aug))
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                       opt_state=tx.init(params), ema_params=None, ema_batch_stats=None)
    base = jax.random.key(4)
    # op by op: XLA's fusion moves hvt's own geometric ops by a level on a
    # few pixels (6 of 41,472 here) against its eager ops, which the port's
    # equal bit for bit
    with jax.disable_jit():
        state, out = jtrain(state, jnp.asarray(images), jnp.asarray(labels), jnp.asarray(mask),
                            base, scale=scale)
    ref_loss = float(out["loss_sum"])
    ref = convert.resnet_state_dict_from_flax(jax.tree.map(np.asarray, state.params),
                                              jax.tree.map(np.asarray, state.batch_stats))
    key = jax.random.fold_in(base, 0)
    key, k_ra = jax.random.split(key)
    key, k_co = jax.random.split(key)
    key, k_mix = jax.random.split(key)
    key, k_cut = jax.random.split(key)
    size = tdevice.resized_size(img, scale)
    draws = {"randaugment": _hvt_rand_augment(k_ra, batch, 1, True),
             "colout": _hvt_colout(k_co, batch, img, img, 0.1, 0.1),
             "mixup": _hvt_mixup(k_mix), "cutmix": _hvt_cutmix(k_cut, size, size)}

    # the port, with hvt's draws
    model = tresnet.resnet_micro_bottleneck(NUM_CLASSES, stem_s2d=True)
    convert.resnet_params_from_flax(model, variables)
    opt = toptim.Optimizer(model.named_parameters(), "decoupledsgdw", lr, wd, momentum,
                           tschedule.cosine_with_warmup(1, 10), grad_clip_norm=clip,
                           no_decay_substrings=model.no_weight_decay_substrings)
    tprep = tdevice.DevicePrep(mean=mean, std=std, compute_dtype=torch.float32)
    step = tstep.build_train_step(model, tobjectives.soft_cross_entropy, opt, tprep,
                                  tstep.StepSettings(num_classes=NUM_CLASSES, smoothing=smoothing,
                                                     **aug))
    got = step(_t(images), _t(labels), _t(mask), None, scale, draws)
    np.testing.assert_allclose(float(got["loss_sum"]), ref_loss, rtol=1e-5)
    live = model.state_dict()
    assert set(live) == set(ref)
    for name in ref:
        _close(live[name], ref[name], 1e-5, f"{name} after the step")
    # the step draws for itself when not given draws, from the generator
    g = torch.Generator().manual_seed(0)
    shape = tuple(images.shape)
    a = tstep.draw_augmentations(g, tstep.StepSettings(NUM_CLASSES, **aug), shape, scale, "cpu")
    assert set(a) == {"randaugment", "colout", "mixup", "cutmix"}
    assert a["colout"][0].shape == (batch, img - 5)
    assert int(a["cutmix"][1]) < size and int(a["cutmix"][2]) < size


# ---------------------------------------------------------------------------
# Resume with every augmentation on
# ---------------------------------------------------------------------------


def _folder(root):
    rng = np.random.default_rng(8)
    for i, name in enumerate(("00000_a_b_c_d_e_f_g", "00001_a_b_c_d_e_f_h")):
        for split, n in (("train", 8), ("val", 2)):
            (root / split / name).mkdir(parents=True)
            for j in range(n):
                arr = rng.integers(0, 256, size=(40 + 8 * j, 56, 3), dtype=np.uint8)
                Image.fromarray(arr).save(root / split / name / f"{j}.jpg", quality=90)
    return root


def _resume_layer(root, save_root, **change):
    layer = {
        "run_name": "aug_resume", "seed": 5, "max_duration": "6ba", "grad_accum": 1,
        "machine": {"save_root": str(save_root), "datasets": {"fix": str(root)}},
        "model": {"name": "resnet_micro_bottleneck", "args": {"stem_s2d": True}},
        "train_dataset": {"path": "fix", "crop_size": 32, "global_batch_size": 4,
                          "shuffle": True, "drop_last": True},
        "eval_dataset": {"path": "fix", "crop_size": 32, "resize_size": 36,
                         "global_batch_size": 4},
        "optim": {"name": "DecoupledSGDW", "lr": 0.2, "momentum": 0.875, "weight_decay": 5e-4},
        "precision": {"compute_dtype": "float32"},
        "save": {"interval": "3ba", "num_checkpoints_to_keep": 5, "wandb": False},
        "loader": {"num_workers": 2, "prefetch_batches": 2},
        "algorithms": [
            {"cls": "EMA", "args": {"half_life": "4ba", "update_interval": "1ba"}},
            {"cls": "RandAugment", "args": {"depth": 1, "severity": 9, "device": True}},
            {"cls": "ColOut", "args": {"p_row": 0.1, "p_col": 0.1, "device": True}},
            {"cls": "MixUp", "args": {"alpha": 0.2}},
            {"cls": "CutMix", "args": {"alpha": 1.0}},
            {"cls": "ProgressiveResizing", "args": {"initial_scale": 0.5}},
            {"cls": "LabelSmoothing", "args": {"smoothing": 0.08}}],
    }
    layer.update(change)
    return layer


def test_resume_with_every_augmentation_is_bit_exact(tmp_path):
    root = _folder(tmp_path / "data")
    part = Trainer(tconfig.loads(_resume_layer(root, tmp_path, run_name="interrupted")),
                   device="cpu")
    assert part.steps_per_epoch == 4
    assert [part._scale_for_step(s) for s in range(6)] == [0.5, 0.5, 0.5, 0.625, 0.875, 1.0]
    part.fit()
    part.close()
    ckpts = tmp_path / "interrupted" / "checkpoints"
    assert sorted(int(p.name) for p in ckpts.iterdir()) == [3, 6]
    resumed = Trainer(tconfig.loads(_resume_layer(root, tmp_path, run_name="resumed",
                                                  load_path=f"ckpt://{ckpts}:3")), device="cpu")
    losses = []
    resumed.fit(on_step=lambda step, stats: losses.append((step, float(stats["loss_sum"]))))
    resumed.close()
    straight = Trainer(tconfig.loads(_resume_layer(root, tmp_path, run_name="straight")),
                       device="cpu")
    ref_losses = []
    straight.fit(on_step=lambda step, stats: ref_losses.append((step, float(stats["loss_sum"]))))
    straight.close()
    assert [s for s, _ in losses] == [4, 5, 6] and losses == ref_losses[3:]
    a, b = tckpt.to_host(resumed.state_dict()), tckpt.to_host(straight.state_dict())
    assert torch.equal(a["rng"], b["rng"])
    fresh = torch.Generator().manual_seed(5).get_state()
    assert not torch.equal(a["rng"], fresh)  # the augmentations drew from it
    for key in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        for name, t in a[key].items():
            assert torch.equal(t, b[key][name]), f"{key} {name}"
