"""Evaluation, the port against hvt, on the CPU.

The same seeded numpy inputs (and the same flax variables, carried across
by ``convert.swin_params_from_flax`` / ``resnet_params_from_flax``, every
leaf drawn) go through hvt and through the port on ``device="cpu"`` (the
plain versions of the kernels), in f32. Tolerances:

* ``tree_dist_matrix``, ``build_tree_dist_matrix`` (its cache written, then
  read) and ``LeafCountLookup``, on synthetic class names and on a tiny
  Pillow JPEG folder: exact;
* ``batch_stats`` with tree distances (flat and multitask): the count
  exact, every other sum within 1e-5 relative (f32 sums in another order);
  ``accuracy_topk`` and ``mean_tree_distance``: within 1e-12 (both numpy);
* the eval loader's batches, labels and masks against hvt's ``Loader`` on
  its Pillow path (``use_native = False``), with a ragged tail: exact;
* ``build_eval_step`` against hvt's on a micro SwinV2 on both routes (hvt's
  Pallas kernels in interpret mode, the port's plain versions) and on a
  micro ResNet in eval mode: count and correct@k exact, ce_sum and
  tree_dist_sum within 1e-4 relative; ``build_feature_step``: within
  1e-4·max|ref| on the unfused route and on ResNet, 5e-3·max|ref| on the
  fused route (both sides round every product's operands to bf16 there, so
  an operand can land on the other side of a rounding boundary: the bound
  of tests/test_torch_port_fused_train.py; measured 5.2e-4);
* the Trainer evaluates the EMA copy and leaves the training weights as
  they were; ``fit()`` evaluates at hvt's steps for ``2ba``, ``1ep`` and
  ``0.5dur``; ``is_train: false`` returns after one evaluation, with
  ``tree-dist``; ``python -m hvt_torch.main --device cpu`` prints it;
* the kernel wrappers whose products put 128-row tiles on gridDim.y refuse
  a batch past its 65,535 tiles before any launch (meta tensors stand in
  for the card's).

hvt's side runs first in each test and is copied to numpy.
"""

import json
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from hvt import config as jconfig
from hvt import hierarchy as jhier
from hvt import metrics as jmetrics
from hvt import parallel
from hvt.data import device as jdevice
from hvt.data import loader as jloader
from hvt.models import resnet as jresnet
from hvt.models import swinv2 as jswin
from hvt.train import loop as jloop
from hvt.train import step as jstep
from hvt_torch import config as tconfig
from hvt_torch import hierarchy as thier
from hvt_torch import main as tmain
from hvt_torch import metrics as tmetrics
from hvt_torch.data import device as tdevice
from hvt_torch.data import loader as tloader
from hvt_torch.data import synthetic as tsynthetic
from hvt_torch.models import convert
from hvt_torch.models import resnet as tresnet
from hvt_torch.models import swinv2 as tswin
from hvt_torch.ops import fused_halves_cuda as fh
from hvt_torch.train import step as tstep
from hvt_torch.train.loop import Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUM_CLASSES = 10
MEAN, STD = (118.0, 122.4, 95.9), (60.7, 58.4, 63.0)
FOLDER_CLASSES = {  # split: class directories (the union has five)
    "train": ["00000_animalia_chordata_aves_accipitriformes_accipitridae_accipiter_badius",
              "00001_animalia_chordata_aves_accipitriformes_accipitridae_accipiter_nisus",
              "00002_animalia_chordata_aves_passeriformes_corvidae_corvus_corax",
              "00003_plantae_tracheophyta_magnoliopsida_rosales_rosaceae_rosa_canina"],
    "val": ["00000_animalia_chordata_aves_accipitriformes_accipitridae_accipiter_badius",
            "00002_animalia_chordata_aves_passeriformes_corvidae_corvus_corax",
            "00004_plantae_tracheophyta_magnoliopsida_rosales_rosaceae_rubus_idaeus"],
}
VAL_SIZES = ((40, 30), (30, 44), (36, 36), (52, 40), (33, 39), (48, 34), (40, 40))  # 7 images


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref, tol, what):
    got, ref = float(got), float(ref)
    assert np.isfinite(got), what
    assert abs(got - ref) <= tol * max(abs(ref), 1e-30), f"{what}: {got} vs {ref} (rel {tol})"


def _labels(names):
    return [thier.HierarchicalLabel.parse(n) for n in names], [jhier.HierarchicalLabel.parse(n)
                                                                for n in names]


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    """train/ and val/ class folders of small JPEGs (val: 7 images over 3
    classes, of several sizes)."""
    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(11)
    sizes = iter(VAL_SIZES)
    for split, names in FOLDER_CLASSES.items():
        for i, name in enumerate(names):
            (root / split / name).mkdir(parents=True)
            for j in range(3 if split == "val" and i == 0 else 2):
                w, h = next(sizes) if split == "val" else (24, 24)
                arr = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
                Image.fromarray(arr).save(root / split / name / f"{j}.jpg", quality=90)
    return root


# ---------------------------------------------------------------------------
# Hierarchy: tree distances and leaf counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 12, 37])
def test_tree_dist_matrix_matches_hvt_on_synthetic_names(n):
    tl, jl = _labels(tsynthetic.synthetic_class_names(n))
    got, ref = thier.tree_dist_matrix(tl), jhier.tree_dist_matrix(jl)
    assert got.dtype == ref.dtype == np.uint8 and got.shape == (n, n)
    np.testing.assert_array_equal(got, ref)
    assert (np.diagonal(got) == 0).all()


def test_tree_dist_matrix_and_its_cache_match_hvt_on_a_folder(jpeg_root, tmp_path):
    assert ([lab.raw for lab in thier.union_labels(jpeg_root)]
            == [lab.raw for lab in jhier.union_labels(jpeg_root)])
    got_root, ref_root = tmp_path / "port", tmp_path / "hvt"
    for dst in (got_root, ref_root):
        shutil.copytree(jpeg_root, dst)
    got, ref = thier.build_tree_dist_matrix(got_root), jhier.build_tree_dist_matrix(ref_root)
    assert got.shape == (5, 5)
    np.testing.assert_array_equal(got, ref)
    for root in (got_root, ref_root):
        np.testing.assert_array_equal(np.load(root / thier.TREE_DIST_CACHE), got)
    # a second build reads the cache rather than rescanning the folder
    marker = np.full((5, 5), 3, np.uint8)
    for root in (got_root, ref_root):
        np.save(root / thier.TREE_DIST_CACHE, marker)
    np.testing.assert_array_equal(thier.build_tree_dist_matrix(got_root), marker)
    np.testing.assert_array_equal(jhier.build_tree_dist_matrix(ref_root), marker)
    assert thier.TREE_DIST_CACHE == jhier.TREE_DIST_CACHE and thier.TIER_NAMES == jhier.TIER_NAMES


@pytest.mark.parametrize("source", ["synthetic", "folder"])
def test_leaf_count_lookup_matches_hvt(jpeg_root, source):
    names = (tsynthetic.synthetic_class_names(24) if source == "synthetic"
             else [lab.raw for lab in thier.union_labels(jpeg_root)])
    tl, jl = _labels(names)
    got, ref = thier.LeafCountLookup(tl), jhier.LeafCountLookup(jl)
    assert got.total == ref.total == len(names)
    for n in (0, 1, 2, 3, 5, 100, 0.0, 0.25, 0.5, 1.0):
        assert got.closest(n) == ref.closest(n), n
    for lookup in (got, ref):
        with pytest.raises(ValueError, match="fractional n"):
            lookup.closest(1.5)
    for empty in (thier.LeafCountLookup([]), jhier.LeafCountLookup([])):
        with pytest.raises(RuntimeError, match="no values"):
            empty.closest(1)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def _tree_dists(n):
    return thier.tree_dist_matrix(_labels(tsynthetic.synthetic_class_names(n))[0])


@pytest.mark.parametrize("multitask", [False, True])
def test_batch_stats_with_tree_distances_match_hvt(multitask):
    rng = np.random.default_rng(21)
    b, n = 16, 12
    logits = rng.normal(size=(b, n)).astype(np.float32)
    labels = rng.integers(0, n, size=b).astype(np.int32)
    logits[3, labels[3]] = logits[3].max() + 1.0  # one row right
    mask = (rng.random(b) < 0.8).astype(np.float32)
    td = _tree_dists(n)
    if multitask:
        outputs = [rng.normal(size=(b, 4)).astype(np.float32), logits]
        labels = np.stack([rng.integers(0, 4, size=b), labels], 1).astype(np.int32)
        jout, tout = [jnp.asarray(o) for o in outputs], [_t(o) for o in outputs]
    else:
        jout, tout = jnp.asarray(logits), _t(logits)
    ref = jmetrics.batch_stats(jout, jnp.asarray(labels), jnp.asarray(mask), jnp.asarray(td))
    got = tmetrics.batch_stats(tout, _t(labels), _t(mask), torch.from_numpy(td))
    assert set(got) == set(ref) and "tree_dist_sum" in got
    assert float(got["count"]) == float(ref["count"])
    for k in ref:
        _rel(got[k], ref[k], 1e-5, k)
    jacc, tacc = jmetrics.MetricAccumulator(), tmetrics.MetricAccumulator()
    for acc, stats in ((jacc, ref), (tacc, got)):
        acc.update(stats)
        acc.update(stats)
    assert set(tacc.compute()) == set(jacc.compute()) == {"acc@1", "acc@5", "cross-entropy",
                                                            "tree-dist"}
    assert tacc.compute() == pytest.approx(jacc.compute(), rel=1e-5)


@pytest.mark.parametrize("multitask", [False, True])
def test_accuracy_topk_and_mean_tree_distance_match_hvt(multitask):
    rng = np.random.default_rng(22)
    b, n = 32, 15
    outputs = rng.normal(size=(b, n))
    labels = rng.integers(0, n, size=b)
    if multitask:
        outputs = [rng.normal(size=(b, 3)), outputs]
        labels = np.stack([rng.integers(0, 3, size=b), labels], 1)
    for topk in (1, 3, 5, 40):
        for level in (0, -1) if multitask else (-1,):
            got = tmetrics.accuracy_topk(outputs, labels, topk, level)
            assert got == pytest.approx(jmetrics.accuracy_topk(outputs, labels, topk, level),
                                        abs=1e-12), (topk, level)
    preds, flat = rng.integers(0, n, size=b), rng.integers(0, n, size=b)
    td = _tree_dists(n)
    assert tmetrics.mean_tree_distance(preds, flat, td) == pytest.approx(
        jmetrics.mean_tree_distance(preds, flat, td), abs=1e-12)


# ---------------------------------------------------------------------------
# The eval loader
# ---------------------------------------------------------------------------


def _eval_layer(root=None, is_train=True, hierarchical=False, drop_last=False):
    if root is None:
        data = {"source": "synthetic", "synthetic_num_classes": NUM_CLASSES,
                "synthetic_num_samples": 7}
        machine = {}
    else:
        data = {"path": "fix"}
        machine = {"machine": {"datasets": {"fix": str(root)}}}
    return {
        "run_name": "eval_test", "seed": 7, "is_train": is_train, **machine,
        "eval_dataset": {**data, "crop_size": 32, "resize_size": 36, "global_batch_size": 3,
                         "drop_last": drop_last},
        "hierarchy": {"variant": "multitask" if hierarchical else "flat"},
        "loader": {"num_workers": 2},
    }


@pytest.mark.parametrize("source,hierarchical,drop_last", [
    ("synthetic", False, False), ("synthetic", True, True), ("folder", False, False),
    ("folder", True, False), ("folder", False, True)])
def test_eval_loader_matches_hvt(jpeg_root, source, hierarchical, drop_last):
    layer = _eval_layer(jpeg_root if source == "folder" else None, is_train=False,
                        hierarchical=hierarchical, drop_last=drop_last)
    ref, ref_info = jloader.build_loader(jconfig.loads(layer), is_train=False, process_index=0,
                                         process_count=1)
    got, info = tloader.build_loader(tconfig.loads(layer), is_train=False)
    # the Pillow route on both sides (the native route: test_torch_port_loader.py)
    ref.use_native = got.use_native = False
    assert got.batches_per_epoch == ref.batches_per_epoch == (2 if drop_last else 3)
    assert info.num_classes == ref_info.num_classes
    np.testing.assert_array_equal(info.tree_dists, ref_info.tree_dists)
    pairs = list(zip(got.epoch(0), ref.epoch(0)))
    assert len(pairs) == ref.batches_per_epoch
    for a, b in pairs:
        for field in ("images", "labels", "mask"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    if not drop_last:
        assert pairs[-1][0].mask.tolist() == [1.0, 0.0, 0.0]  # the ragged tail, padded


def test_tree_distances_only_for_an_eval_only_run(jpeg_root):
    for root in (None, jpeg_root):
        _, info = tloader.build_loader(tconfig.loads(_eval_layer(root)), is_train=False)
        assert info.tree_dists is None


def test_a_missing_eval_folder_raises(tmp_path):
    layer = _eval_layer(tmp_path / "absent")
    with pytest.raises(FileNotFoundError):
        tloader.build_loader(tconfig.loads(layer), is_train=False)
    del layer["machine"]
    with pytest.raises(KeyError):
        tloader.build_loader(tconfig.loads(layer), is_train=False)
    train = _trainer_layer()
    del train["eval_dataset"]  # the default eval source, a folder the machine does not name
    with pytest.raises(KeyError):
        Trainer(tconfig.loads(train), device="cpu")


# ---------------------------------------------------------------------------
# The eval and feature steps
# ---------------------------------------------------------------------------

SWIN = dict(embed_dim=16, depths=(1, 1), num_heads=(2, 4), window_size=4)


def _swin_tree(jm, seed):
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == "scale":
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name == "logit_scale":
            return np.log(10.0) + 0.3 * rng.normal(size=shape)
        if name in ("bias", "q_bias", "v_bias", "cpb_b1"):
            return 0.1 * rng.normal(size=shape)
        if name == "cpb_w1":
            return rng.normal(size=shape)
        return rng.normal(size=shape) / np.sqrt(int(np.prod(shape[:-1])))

    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.tree_util.tree_map_with_path(leaf, shapes))


def _resnet_variables(jm, seed):
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))
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


def _models(family, fuse=False):
    """(hvt model, its params, its batch_stats, the port's model)."""
    if family == "swinv2":
        jm = jswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=jnp.float32, fuse=fuse,
                                     drop_path_rate=0.0, **SWIN)
        tree = _swin_tree(jm, seed=31)
        tm = tswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=torch.float32, fuse=fuse,
                                     drop_path_rate=0.0, **SWIN)
        return jm, tree, {}, convert.swin_params_from_flax(tm, tree)
    jm = jresnet.resnet_micro_bottleneck(NUM_CLASSES, dtype=jnp.float32, stem_s2d=True)
    variables = _resnet_variables(jm, seed=32)
    tm = tresnet.resnet_micro_bottleneck(NUM_CLASSES, dtype="float32", stem_s2d=True,
                                         bn_pallas=True)
    convert.resnet_params_from_flax(tm, variables)
    return jm, variables["params"], variables["batch_stats"], tm


def _port_state(tm):
    params = dict(tm.named_parameters())
    stats = {n: b for n, b in tm.named_buffers() if n.endswith(("running_mean", "running_var"))}
    return params, stats


def _batch(b=6, seed=33):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, size=(b, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, NUM_CLASSES, size=b).astype(np.int32)
    mask = np.ones(b, np.float32)
    mask[-1] = 0.0  # a padded row
    return images, labels, mask


EVAL_CASES = [("swinv2", False), ("swinv2", True), ("resnet", False)]
FEATURE_TOL = {False: 1e-4, True: 5e-3}  # by fuse


@pytest.mark.parametrize("family,fuse", EVAL_CASES)
def test_eval_step_matches_hvt(family, fuse):
    jm, params, stats, tm = _models(family, fuse)
    images, labels, mask = _batch()
    td = _tree_dists(NUM_CLASSES)
    jprep = jdevice.DevicePrep(mean=MEAN, std=STD, compute_dtype=jnp.float32)
    ref = jstep.build_eval_step(jm, jprep, td)(params, stats, jnp.asarray(images),
                                               jnp.asarray(labels), jnp.asarray(mask))
    ref = {k: float(v) for k, v in ref.items()}
    tprep = tdevice.DevicePrep(mean=MEAN, std=STD, compute_dtype=torch.float32)
    tm.train()
    got = tstep.build_eval_step(tm, tprep, td)(*_port_state(tm), _t(images), _t(labels), _t(mask))
    assert tm.training  # the step puts the model's mode back
    assert set(got) == set(ref) == {"correct@1", "correct@5", "ce_sum", "count", "tree_dist_sum"}
    for k in ("count", "correct@1", "correct@5"):
        assert float(got[k]) == ref[k], k
    for k in ("ce_sum", "tree_dist_sum"):
        _rel(got[k], ref[k], 1e-4, k)


@pytest.mark.parametrize("family,fuse", EVAL_CASES)
def test_feature_step_matches_hvt(family, fuse):
    jm, params, stats, tm = _models(family, fuse)
    images, _, _ = _batch()
    jprep = jdevice.DevicePrep(mean=MEAN, std=STD, compute_dtype=jnp.float32)
    ref = np.asarray(jstep.build_feature_step(jm, jprep)(params, stats, jnp.asarray(images)))
    tprep = tdevice.DevicePrep(mean=MEAN, std=STD, compute_dtype=torch.float32)
    got = tstep.build_feature_step(tm, tprep)(*_port_state(tm), _t(images))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    err, scale = np.abs(got.numpy() - ref).max(), np.abs(ref).max()
    tol = FEATURE_TOL[fuse]
    assert err <= tol * scale, f"features: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


# ---------------------------------------------------------------------------
# The Trainer's evaluation and its schedule
# ---------------------------------------------------------------------------


def _trainer_layer(**change):
    layer = {
        "run_name": "eval_trainer", "seed": 5, "max_duration": "3ba", "grad_accum": 1,
        "model": {"name": "resnet_micro_bottleneck", "args": {"stem_s2d": True}},
        "train_dataset": {"source": "synthetic", "crop_size": 32, "global_batch_size": 4,
                          "synthetic_num_classes": NUM_CLASSES, "synthetic_num_samples": 12,
                          "drop_last": True, "shuffle": True},
        "eval_dataset": {"source": "synthetic", "crop_size": 32, "global_batch_size": 4,
                         "synthetic_num_classes": NUM_CLASSES, "synthetic_num_samples": 6},
        "optim": {"name": "DecoupledSGDW", "lr": 0.2, "momentum": 0.875, "weight_decay": 5e-4},
        "scheduler": {"args": {"t_warmup": "1ba"}},
        "precision": {"compute_dtype": "float32"},
        "algorithms": [{"cls": "EMA", "args": {"half_life": "4ba", "update_interval": "1ba"}}],
        "save": {"interval": None, "wandb": False},
        "loader": {"num_workers": 1, "prefetch_batches": 1},
    }
    layer.update(change)
    return layer


def _eval_sums(trainer, params, stats):
    sums = {}
    for batch in trainer.eval_loader.epoch(0):
        out = trainer.eval_step(params, stats, *trainer._to_device(batch))
        sums = {k: sums.get(k, 0.0) + float(v) for k, v in out.items()}
    return sums


def test_trainer_evaluates_the_ema_and_leaves_the_training_weights(tmp_path):
    trainer = Trainer(tconfig.loads(_trainer_layer(machine={"save_root": str(tmp_path)})),
                      device="cpu")
    trainer.fit()
    live = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    ema = {k: v.clone() for k, v in {**trainer.ema.params, **trainer.ema.batch_stats}.items()}
    trainer.model.train()
    metrics = trainer.evaluate()
    assert trainer.model.training
    for name, value in trainer.model.state_dict().items():
        assert torch.equal(value, live[name]), name
    for name, value in {**trainer.ema.params, **trainer.ema.batch_stats}.items():
        assert torch.equal(value, ema[name]), name
    on_ema = _eval_sums(trainer, trainer.ema.params, trainer.ema.batch_stats)
    on_live = _eval_sums(trainer, dict(trainer.model.named_parameters()),
                         {n: live[n] for n in trainer.ema.batch_stats})
    assert on_ema["count"] == 6.0
    assert metrics["cross-entropy"] == pytest.approx(on_ema["ce_sum"] / 6.0, rel=1e-6)
    assert abs(on_live["ce_sum"] - on_ema["ce_sum"]) > 1e-4 * abs(on_ema["ce_sum"])
    assert set(trainer.train_metrics) == {"acc@1", "acc@5", "cross-entropy", "loss", "lr"}


def _hvt_eval_steps(layer, tmp_path):
    """The steps at which hvt's ``fit`` evaluates: its train step stubbed to
    count steps, its evaluation to record them, its checkpoint to nothing."""
    cfg = jconfig.loads({**layer, "machine": {"save_root": str(tmp_path)}})
    trainer = jloop.Trainer(cfg, mesh=parallel.cpu_mesh(1), log_interval=50)
    steps = []
    trainer.train_step = lambda state, *args, **kwargs: (state.replace(step=state.step + 1), {})
    trainer.evaluate = lambda: steps.append(int(trainer.state.step)) or {}
    trainer._save_checkpoint = lambda step: None
    try:
        trainer.fit()
    finally:
        trainer.close()
    return steps


@pytest.mark.parametrize("interval,steps", [("2ba", [0, 2, 4, 6, 7]), ("1ep", [0, 3, 6, 7]),
                                            ("0.5dur", [0, 3, 6, 7])])
def test_fit_evaluates_at_hvts_steps(tmp_path, interval, steps):
    layer = _trainer_layer(max_duration="7ba", eval_interval=interval,
                           machine={"save_root": str(tmp_path / "port")})
    assert _hvt_eval_steps(layer, tmp_path) == steps
    trainer = Trainer(tconfig.loads(layer), device="cpu")
    seen, trained = [], []
    evaluate = trainer._evaluate_at
    trainer._evaluate_at = lambda step: seen.append(step) or evaluate(step)
    metrics = trainer.fit(on_step=lambda step, stats: trained.append(step))
    assert seen == steps and trained == list(range(1, 8))
    assert set(metrics) == {"acc@1", "acc@5", "cross-entropy"}


def test_an_eval_only_run_evaluates_once_with_tree_distances(tmp_path):
    layer = _trainer_layer(is_train=False, machine={"save_root": str(tmp_path)})
    trainer = Trainer(tconfig.loads(layer), device="cpu")
    seen, trained = [], []
    evaluate = trainer._evaluate_at
    trainer._evaluate_at = lambda step: seen.append(step) or evaluate(step)
    metrics = trainer.fit(on_step=lambda step, stats: trained.append(step))
    assert seen == [0] and trained == [] and trainer.train_metrics == {}
    assert set(metrics) == {"acc@1", "acc@5", "cross-entropy", "tree-dist"}
    # tree-dist is hvt's mean_tree_distance of the EMA copy's argmax predictions
    preds, labels = [], []
    tm = trainer.model.eval()
    with torch.inference_mode():
        for batch in trainer.eval_loader.epoch(0):
            images, lab, mask = trainer._to_device(batch)
            out = torch.func.functional_call(
                tm, {**trainer.eval_params, **trainer.eval_batch_stats},
                (trainer.eval_prep.normalize(images),))
            keep = mask.bool()
            preds.append(out.argmax(-1)[keep].numpy())
            labels.append(lab[keep].numpy())
    ref = jmetrics.mean_tree_distance(np.concatenate(preds), np.concatenate(labels),
                                      trainer.tree_dists)
    assert metrics["tree-dist"] == pytest.approx(ref, rel=1e-6)


def test_main_evaluates_on_the_cpu(tmp_path):
    exp = tmp_path / "eval_only.yaml"
    exp.write_text(yaml.safe_dump({"is_train": False, "machine": {"save_root": str(tmp_path)}}))
    out = subprocess.run(
        [sys.executable, "-m", "hvt_torch.main", "--machine", "configs/machines/local.yaml",
         "--exp", "configs/pretrain/debug_synthetic.yaml", str(exp), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-2].startswith("[r50_debug_synthetic] step=0, eval/acc@1=")
    metrics = json.loads(lines[-1])
    assert set(metrics) == {"acc@1", "acc@5", "cross-entropy", "tree-dist"}
    assert all(np.isfinite(v) for v in metrics.values())
    assert 0.0 <= metrics["tree-dist"] <= 7.0


def test_main_returns_the_eval_metrics(tmp_path):
    layer = _trainer_layer(max_duration="2ba", machine={"save_root": str(tmp_path)})
    metrics = tmain.main(tconfig.loads(layer), device="cpu")
    assert set(metrics) == {"acc@1", "acc@5", "cross-entropy"}


def test_the_wrappers_refuse_rows_past_the_grid_limit(monkeypatch):
    """A SwinV2 stage-1 map at 224 px is 3,136 rows an image: 2,674 images
    fit gridDim.y's 65,535 row tiles of 128 (the eval batch, 2,048, with
    room), 2,675 do not, and the wrappers raise naming the limit."""
    tpi = 56 * 56
    assert fh.rows_unsupported(2048 * tpi) is None and fh.rows_unsupported(2674 * tpi) is None
    assert "gridDim.y limit of 65535" in fh.rows_unsupported(2675 * tpi)
    monkeypatch.setattr(fh, "_on_card", lambda name, x: True)  # as if x were on the card

    def meta(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")

    with pytest.raises(ValueError, match="mlp_half: .*gridDim.y limit of 65535"):
        fh.mlp_half_forward(meta(2675 * tpi, 96), meta(384, 96), *[None] * 5)
    with pytest.raises(ValueError, match="attention_half_nhwc: .*gridDim.y limit of 65535"):
        fh.attention_half_nhwc_forward(meta(2675, 56, 56, 96), *[None] * 9, 7, 3)
