"""The port's downstream layer against hvt's, on the CPU: feature
extraction and its cache, the centroids, ``python -m hvt_torch.simpleshot``,
the parent lookups and the one-shot metric record.

Both packages get the same weights: hvt's seeded flax tree (every leaf
drawn), saved as an hvt checkpoint that hvt reads as ``ckpt://`` and
exported by ``hvt.tools.export_torch`` to the ``torch://`` file the port
reads. The image folder is tests/test_downstream.py's shape (4 taxonomy
classes, 5 train and 2 val images a class, 36 px, 32 px crops) with each
class's images around a colour of its own, so that every fit separates the
classes. Tolerances:

* ``extract_features``: features within 1e-4·max|f| on a ``resnet_micro``
  and 5e-3·max|f| on a two-stage ``swinv2_micro`` on ``fuse: true`` (hvt's
  Pallas kernels in interpret mode; the bound of
  tests/test_torch_port_eval.py's feature step); labels (flat and (N, 7))
  and the cache's path under the save root equal; a cache hit opens no
  image and runs no forward;
* ``center``, ``l2_normalize``, ``tree_distance``: within 1e-12;
* ``NearestCentroid`` against sklearn's and ``HierarchicalNearestCentroid``
  against hvt's: predictions equal (ties, the no-child fallback, chunks of
  4096 rows), centroids within 1e-12, the same errors;
* ``simpleshot.main`` (flat, l2n, cl2n, hierarchical) against hvt's
  ``simpleshot.main``: the metrics equal, and the metric record's keys;
* ``build_parent_label_lookup`` and ``publish_run_metrics``' record: equal.
"""

import json
import pathlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.neighbors
import torch
from PIL import Image

import simpleshot as jsimpleshot
from hvt import config as jconfig
from hvt import hierarchy as jhier
from hvt.downstream import centroid as jcentroid
from hvt.downstream import features as jfeatures
from hvt.models import build_model as jbuild_model
from hvt.tools import export_torch as jexport
from hvt.train import checkpoint as jckpt
from hvt.utils import logging as jlogging
from hvt_torch import config as tconfig
from hvt_torch import device as device_lib
from hvt_torch import hierarchy as thier
from hvt_torch import simpleshot as tsimpleshot
from hvt_torch.data import synthetic as tsynthetic
from hvt_torch.downstream import centroid as tcentroid
from hvt_torch.downstream import features as tfeatures
from hvt_torch.train import step as tstep
from hvt_torch.utils import logging as tlogging
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NAMES = [
    "00001_animalia_chordata_aves_accipitriformes_accipitridae_accipiter_badius",
    "00002_animalia_chordata_aves_accipitriformes_accipitridae_accipiter_cooperii",
    "00003_animalia_chordata_aves_accipitriformes_pandionidae_pandion_haliaetus",
    "00004_plantae_tracheophyta_pinopsida_pinales_pinaceae_pinus_strobus",
]
COLOURS = ((60, 120, 200), (200, 60, 60), (60, 200, 60), (220, 220, 40))
IMG = 32
FEATURE_TOL = {"resnet_micro": 1e-4, "swinv2_micro": 5e-3}
MODEL_ARGS = {"resnet_micro": {}, "swinv2_micro": {"fuse": True}}
# hvt initialises its model on 2 images, sharded over the batch's divisor mesh
# of the 8 CPU devices: the fused SwinV2's kernels take no mesh wider than 2
BATCH = {"resnet_micro": 4, "swinv2_micro": 2}


def write_folder(root: pathlib.Path, train: int = 5, val: int = 2, seed: int = 0,
                 names=NAMES) -> pathlib.Path:
    """train/ and val/ class folders of 36 px JPEGs, each class around its
    own colour (``COLOURS``, then seeded ones)."""
    rng = np.random.default_rng(seed)
    colours = [*COLOURS, *rng.integers(30, 226, size=(max(0, len(names) - len(COLOURS)), 3))]
    for split, k in (("train", train), ("val", val)):
        for name, colour in zip(names, colours):
            (root / split / name).mkdir(parents=True)
            for i in range(k):
                arr = np.clip(np.asarray(colour) + rng.normal(0, 25, (36, 36, 3)), 0, 255)
                Image.fromarray(arr.astype(np.uint8)).save(root / split / name / f"{i}.jpg")
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_folder(tmp_path_factory.mktemp("downstream-fixture"))


def _randomized(shapes, seed):
    """Every leaf drawn at a scale that keeps activations O(1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, size=shape)
        elif name == "logit_scale":
            a = np.log(10.0) + 0.3 * rng.normal(size=shape)
        elif name in ("bias", "mean", "q_bias", "v_bias", "cpb_b1"):
            a = 0.1 * rng.normal(size=shape)
        elif name == "cpb_w1":
            a = rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) / np.sqrt(int(np.prod(shape[:-1])))
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def write_weights(root: pathlib.Path, model: str, num_classes=2, seed: int = 3,
                  multitask: bool = False) -> tuple[str, str]:
    """hvt's seeded variables of ``model`` saved as an hvt checkpoint and
    exported by hvt's export_torch → (hvt's ckpt:// URI, the port's
    torch:// URI)."""
    layer = {"model": {"name": model, "args": MODEL_ARGS[model]},
             "precision": {"compute_dtype": "float32"}}
    if multitask:
        layer["hierarchy"] = {"variant": "multitask"}
    jm = jbuild_model(jconfig.loads(layer), num_classes)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)),
                                            train=False))
    variables = _randomized(dict(shapes), seed)
    ckpt = root / "hvt-ckpt"
    saver = jckpt.Checkpointer(ckpt)
    saver.save(0, {"params": variables["params"],
                   "batch_stats": variables.get("batch_stats", {})})
    saver.close()
    out = root / "weights.pt"
    jexport.export(f"ckpt://{ckpt}", str(out))
    return f"ckpt://{ckpt}", f"torch://{out}"


def layers(root, save_root, variant, model, uri, **extra) -> dict:
    layer = {
        "run_name": "downstream_test", "seed": 0,
        "model": {"name": model, "variant": variant, "pretrained_checkpoint": uri,
                  "args": MODEL_ARGS[model]},
        "machine": {"datasets": {"fix": str(root)}, "save_root": str(save_root)},
        "train_dataset": {"path": "fix", "crop_size": IMG, "resize_size": 34,
                          "global_batch_size": BATCH[model]},
        "eval_dataset": {"path": "fix", "crop_size": IMG, "resize_size": 34,
                         "global_batch_size": BATCH[model]},
        "precision": {"compute_dtype": "float32"},
        "loader": {"num_workers": 1},
        "save": {"wandb": False},
    }
    for key, value in extra.items():
        layer[key] = {**layer.get(key, {}), **value} if isinstance(value, dict) else value
    return layer


def config_pair(root, tmp_path, variant, model="resnet_micro", uris=None, **extra):
    """(hvt's config, the port's): the same layers, each package its own
    save root and its own URI of the same weights."""
    uris = uris or write_weights(tmp_path, model)
    return (jconfig.loads(layers(root, tmp_path / "hvt", variant, model, uris[0], **extra)),
            tconfig.loads(layers(root, tmp_path / "port", variant, model, uris[1], **extra)))


def assert_close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def last_record(save_root, run_name="downstream_test") -> dict:
    lines = (pathlib.Path(save_root) / run_name / "logs" / "log0.txt").read_text().splitlines()
    return json.loads(lines[-1])


# ---------------------------------------------------------------------------
# Hierarchy and the metric record
# ---------------------------------------------------------------------------


def test_build_parent_label_lookup_matches_hvt(folder, tmp_path):
    for got, ref in zip(thier.build_parent_label_lookup(folder),
                        jhier.build_parent_label_lookup(folder), strict=True):
        np.testing.assert_array_equal(got, ref)
    # a taxonomy where tiers branch: the synthetic names as a folder
    names = tsynthetic.synthetic_class_names(24)
    for split, chosen in (("train", names[:20]), ("val", names[10:])):
        for name in chosen:
            (tmp_path / split / name).mkdir(parents=True)
    got, ref = thier.build_parent_label_lookup(tmp_path), jhier.build_parent_label_lookup(tmp_path)
    assert len(got) == len(ref) == thier.N_TIERS - 1
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_publish_run_metrics_writes_hvts_record(tmp_path):
    layer = {"run_name": "downstream_test", "tags": ["probe"], "save": {"wandb": False}}
    metrics = {"acc@1": 0.625, "tree-dist": np.float64(1.5)}
    for logging_lib, cfg_lib, root in ((tlogging, tconfig, tmp_path / "port"),
                                       (jlogging, jconfig, tmp_path / "hvt")):
        cfg = cfg_lib.loads(layer, {"machine": {"save_root": str(root)}})
        logging_lib.publish_run_metrics(cfg, metrics, prefix="simpleshot")
    got, ref = last_record(tmp_path / "port"), last_record(tmp_path / "hvt")
    assert got.pop("time") > 0 and ref.pop("time") > 0
    assert got == ref == {"step": 0, "simpleshot/acc@1": 0.625, "simpleshot/tree-dist": 1.5}
    text = (tmp_path / "port" / "downstream_test" / "logs" / "log0.txt").read_text()
    assert text.startswith(tconfig.to_yaml(tconfig.loads(
        layer, {"machine": {"save_root": str(tmp_path / "port")}})))


# ---------------------------------------------------------------------------
# Feature extraction and its cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("source", ["synthetic", "folder"])
def test_cache_path_matches_hvt(folder, tmp_path, source):
    extra = {} if source == "folder" else {"train_dataset": {"path": "", "source": "synthetic"},
                                          "eval_dataset": {"path": "", "source": "synthetic"}}
    jcfg, tcfg = config_pair(folder, tmp_path, "linear-probe", uris=("", ""), **extra)
    for is_train in (True, False):
        for kind in ("linear-probe", "simpleshot"):
            got = pathlib.Path(tfeatures.cache_path(tcfg, kind, is_train))
            ref = pathlib.Path(jfeatures.cache_path(jcfg, kind, is_train))
            assert got.relative_to(tmp_path / "port") == ref.relative_to(tmp_path / "hvt")
            assert got.parent.is_dir()


@pytest.mark.parametrize("model", ["resnet_micro", "swinv2_micro"])
def test_extract_features_matches_hvt(folder, tmp_path, model):
    jcfg, tcfg = config_pair(folder, tmp_path, "linear-probe", model)
    for is_train in (True, False):
        ref, ref_labels = jfeatures.extract_features(jcfg, is_train, "linear-probe")
        got, labels = tfeatures.extract_features(tcfg, is_train, "linear-probe", device="cpu")
        assert got.dtype == np.float32 and got.shape == ref.shape == (20 if is_train else 8, got.shape[1])
        assert_close(got, ref, FEATURE_TOL[model], f"{model} features, train={is_train}")
        np.testing.assert_array_equal(labels, ref_labels)
        np.testing.assert_array_equal(np.load(tfeatures.cache_path(tcfg, "linear-probe", is_train)),
                                      got)
    # hierarchical labels: the (N, 7) tier indices, from the cache
    _, ref_labels = jfeatures.extract_features(jcfg, False, "linear-probe", hierarchical_labels=True)
    _, labels = tfeatures.extract_features(tcfg, False, "linear-probe", hierarchical_labels=True,
                                           device="cpu")
    assert labels.shape == (8, thier.N_TIERS)
    np.testing.assert_array_equal(labels, ref_labels)


def test_a_cache_hit_decodes_nothing_and_runs_no_forward(folder, tmp_path, monkeypatch):
    _, tcfg = config_pair(folder, tmp_path, "simpleshot")
    feats, labels = tfeatures.extract_features(tcfg, True, "simpleshot", device="cpu")

    def boom(*a, **k):
        raise AssertionError("a cache hit decoded an image or built a forward")

    monkeypatch.setattr("PIL.Image.open", boom)
    monkeypatch.setattr("hvt_torch.data.native.load_batch", boom)
    monkeypatch.setattr(tstep, "build_feature_step", boom)
    feats2, labels2 = tfeatures.extract_features(tcfg, True, "simpleshot", device="cpu")
    np.testing.assert_array_equal(feats, feats2)
    np.testing.assert_array_equal(labels, labels2)


def test_extract_features_refuses_on_the_card_a_model_the_kernels_cannot_take(folder, tmp_path,
                                                                             monkeypatch):
    # swinv2_micro fused (width 16) is a CPU-only model: refused before any weight moves
    _, tcfg = config_pair(folder, tmp_path, "simpleshot", "swinv2_micro", uris=("", "torch://none"))
    monkeypatch.setattr(device_lib, "resolve", lambda device=None: torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="width 16 is not one the kernels are built for"):
        tfeatures.extract_features(tcfg, True, "simpleshot")


def test_normalisations_and_tree_distance_match_hvt():
    rng = np.random.default_rng(4)
    x = rng.normal(1.0, 0.5, size=(9, 6))
    for name in ("center", "l2_normalize"):
        assert_close(getattr(tfeatures, name)(x), getattr(jfeatures, name)(x), 1e-12, name)
    np.testing.assert_allclose(tfeatures.center(np.asarray([[1.0, 3.0], [2.0, 2.0]])),
                               [[0.5, 1.5], [1.0, 1.0]])  # divides by the row mean
    td = thier.tree_dist_matrix([thier.HierarchicalLabel.parse(n) for n in NAMES])
    labels, preds = rng.integers(0, 4, 11), rng.integers(0, 4, 11)
    assert tfeatures.tree_distance(labels, preds, tree_dists=td) == pytest.approx(
        jfeatures.tree_distance(labels, preds, tree_dists=td), abs=1e-12)


# ---------------------------------------------------------------------------
# Centroids
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,classes,dim", [(0, 3, 2), (1, 17, 8), (2, 40, 64)])
def test_nearest_centroid_matches_sklearn(seed, classes, dim):
    rng = np.random.default_rng(seed)
    labels = 7 * rng.integers(0, classes, size=20 * classes) + 3  # sparse, unsorted label values
    x = rng.normal(size=(labels.size, dim)) + 0.5 * rng.normal(size=(classes, dim))[(labels - 3) // 7]
    queries = rng.normal(size=(5000, dim))  # two chunks of the port's 4096
    ref = sklearn.neighbors.NearestCentroid().fit(x, labels)
    got = tcentroid.NearestCentroid().fit(x, labels)
    np.testing.assert_array_equal(got.classes_, ref.classes_)
    assert_close(got.centroids_.numpy(), ref.centroids_, 1e-12, "centroids")
    np.testing.assert_array_equal(got.predict(queries), ref.predict(queries))


def test_nearest_centroid_ties_and_errors_match_sklearn():
    x = np.asarray([[0.0, 1.0], [0.0, 1.0], [2.0, 0.0], [2.0, 0.0], [5.0, 5.0]])
    y = np.asarray([4, 2, 4, 2, 9])  # classes 2 and 4 share their centroid
    queries = np.asarray([[1.0, 0.5], [5.0, 4.0], [1.0, 0.6]])
    ref = sklearn.neighbors.NearestCentroid().fit(x, y).predict(queries)
    got = tcentroid.NearestCentroid().fit(x, y).predict(queries)
    np.testing.assert_array_equal(got, ref)
    assert got[0] == 2  # the first class on a tie
    for bad_x, bad_y, match in ((x, np.zeros(5, int), "greater than one"),
                                (np.ones((5, 2)), y, "zero variance")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(ValueError, match=match):
                sklearn.neighbors.NearestCentroid().fit(bad_x, bad_y)
        with pytest.raises(ValueError, match=match):
            tcentroid.NearestCentroid().fit(bad_x, bad_y)


# an uneven taxonomy of 12 species (tiers: kingdom a/b down to species)
TAXONOMY = [f"{i:05d}_{path}" for i, path in enumerate((
    "a_p0_c0_o0_f0_g0_s0", "a_p0_c0_o0_f0_g0_s1", "a_p0_c0_o0_f0_g1_s2", "a_p0_c1_o1_f1_g2_s3",
    "a_p1_c2_o2_f2_g3_s4", "b_p2_c3_o3_f3_g4_s5", "b_p2_c3_o3_f4_g5_s6", "b_p3_c4_o4_f5_g6_s7",
    "b_p3_c4_o5_f6_g7_s8", "a_p1_c5_o6_f7_g8_s9", "b_p4_c6_o7_f8_g9_s10", "a_p0_c1_o1_f1_g2_s11"))]


@pytest.mark.parametrize("shots,spread", [(4, 0.3), (1, 2.0)])
def test_hierarchical_centroid_matches_hvt(shots, spread):
    # as in SimpleShot: the parent lookups over the union of the folder's
    # classes, the labels' tier indices over the train split's 7 of them,
    # so that a predicted parent can have no child present
    lookups = thier.parent_lookup_from_classes(TAXONOMY)
    split = sorted(np.random.default_rng(4).choice(TAXONOMY, size=7, replace=False))
    table, _ = thier.assign_tier_indices(split)
    rng = np.random.default_rng(shots)
    rows = np.repeat(np.arange(7), shots)
    centres = rng.normal(size=(7, 5))
    x = centres[rows] + spread * rng.normal(size=(rows.size, 5))
    queries = centres[rng.integers(0, 7, 4500)] + spread * rng.normal(size=(4500, 5))
    ref = jcentroid.HierarchicalNearestCentroid(lookups).fit(x, table[rows])
    got = tcentroid.HierarchicalNearestCentroid(lookups).fit(x, table[rows])
    for g, r in zip(got.classes_, ref.classes_, strict=True):
        np.testing.assert_array_equal(g, r)
    for g, r in zip(got.centroids_, ref.centroids_, strict=True):
        assert_close(g.numpy(), r, 1e-12, "tier centroids")
    preds = got.predict(queries)
    np.testing.assert_array_equal(preds, ref.predict(queries))
    # the fallback ran: a tier predicted outside the previous tier's children
    assert any((lookups[t - 1][preds[:, t]] != preds[:, t - 1]).any()
               for t in range(1, thier.N_TIERS))


def test_hierarchical_centroid_needs_two_classes_a_tier():
    table, _ = thier.assign_tier_indices(TAXONOMY)
    lookups = thier.parent_lookup_from_classes(TAXONOMY)
    for lib in (tcentroid, jcentroid):
        with pytest.raises(ValueError, match="All levels need > 1 class"):
            lib.HierarchicalNearestCentroid(lookups).fit(np.zeros((4, 2)), np.tile(table[0], (4, 1)))
    with pytest.raises(RuntimeError, match="not fitted"):
        tcentroid.HierarchicalNearestCentroid(lookups).predict(np.zeros((1, 2)))


# ---------------------------------------------------------------------------
# python -m hvt_torch.simpleshot
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def resnet_uris(tmp_path_factory):
    return write_weights(tmp_path_factory.mktemp("weights"), "resnet_micro")


@pytest.mark.parametrize("variant,extra", [
    ("simpleshot", {}), ("simpleshot-l2n", {}), ("simpleshot-cl2n", {}),
    ("simpleshot", {"simpleshot": {"hierarchical": True}}),
])
def test_simpleshot_main_matches_hvt(folder, tmp_path, resnet_uris, variant, extra, capsys):
    jcfg, tcfg = config_pair(folder, tmp_path, variant, uris=resnet_uris, **extra)
    ref = jsimpleshot.main(jcfg)
    capsys.readouterr()
    got = tsimpleshot.main(tcfg, device="cpu")
    out = capsys.readouterr().out
    assert got == ref and set(got) == {"acc@1", "tree-dist"}
    if not extra:  # flat: every class its own colour (top-down, the kingdom tier can err)
        assert got["acc@1"] == 1.0
    for line in ("Loaded train features.", "Loaded test features.", f"acc@1: {got['acc@1']:.4f}"):
        assert line in out
    rec, ref_rec = last_record(tmp_path / "port"), last_record(tmp_path / "hvt")
    assert {k: v for k, v in rec.items() if k != "time"} == {
        k: v for k, v in ref_rec.items() if k != "time"}


def test_simpleshot_main_refuses_other_variants(folder, tmp_path):
    jcfg, tcfg = config_pair(folder, tmp_path, "full-tuning", uris=("", ""))
    with pytest.raises(ValueError, match="simpleshot variant"):
        jsimpleshot.main(jcfg)
    with pytest.raises(ValueError, match="simpleshot variant"):
        tsimpleshot.main(tcfg, device="cpu")
