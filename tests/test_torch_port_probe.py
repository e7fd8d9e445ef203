"""The linear probe's fit (``hvt_torch.downstream.linear``) and
``python -m hvt_torch.linear_probe`` against sklearn, scipy and hvt, on the
CPU.

hvt fits the probe with ``GridSearchCV(StandardScaler → SGDClassifier)``;
the port solves the same objective with L-BFGS (the module's docstring).
Held here:

* the folds: equal to ``StratifiedKFold(5).split`` row for row (balanced,
  unbalanced, after hvt's seeded permutation, labels first seen out of
  order), with sklearn's errors when there are fewer rows than folds or
  every class has fewer than 5 members and its warning when some have;
* the scaler: ``StandardScaler``'s mean, scale and output within 1e-12,
  a constant column included;
* the objective: the port's minimum at each alpha no higher than the
  objective of the coefficients hvt's own ``build_linear_model()`` fits
  (its SGD seeded on the returned estimator) + 1e-6 relative; within 1e-6
  relative of scipy's f64 L-BFGS-B minimum of the objective written in
  numpy at the default tolerance, and
  within 1e-10 (weights within 1e-4·max|w|) at a tolerance of 1e-9; f32
  within 1e-5 of f64; two classes fit as one output;
* the grid search on seeded clusters separated well enough that SGD's
  answer predicts as the minimum does: hvt's chosen alpha, fold
  accuracies and test accuracy, equal;
* ``linear_probe.main`` against hvt's on the class-coloured folder of
  tests/test_torch_port_downstream.py (features within 1e-4·max|f|): the
  metrics equal (both fits separate the colours; where SGD's answer
  differs from the minimum only the objective above is compared), the
  printed lines and the metric record; a 1-shot split raises in both.
"""

import warnings

import numpy as np
import pytest
import scipy.optimize
import scipy.special
import sklearn.base
import torch
from sklearn.model_selection import StratifiedKFold
from sklearn.preprocessing import StandardScaler

import linear_probe as jprobe
import test_torch_port_downstream as downstream
from hvt_torch import linear_probe as tprobe
from hvt_torch.data import synthetic as tsynthetic
from hvt_torch.downstream import linear as L


def _unbalanced(seed=0):
    rng = np.random.default_rng(seed)
    counts = rng.integers(5, 18, size=9)
    y = np.repeat(np.arange(9) * 3 + 1, counts)
    return y[rng.permutation(y.size)]


LABELS = {
    "balanced": lambda: np.repeat(np.arange(6), 10),
    "unbalanced": _unbalanced,
    "hvt_permutation": lambda: _unbalanced(1)[np.random.default_rng(0).permutation(_unbalanced(1).size)],
    "first_seen_out_of_order": lambda: np.asarray([5, 2, 9, 2, 5, 9, 7] * 6),
    "strings": lambda: np.asarray(["b", "a", "c", "a"] * 5),
}


@pytest.mark.parametrize("case", sorted(LABELS))
def test_stratified_folds_match_sklearn(case):
    y = LABELS[case]()
    ref = list(StratifiedKFold(5).split(np.zeros((y.size, 1)), y))
    got = L.fold_indices(y)
    assert len(got) == len(ref) == 5
    for (g_train, g_test), (r_train, r_test) in zip(got, ref):
        np.testing.assert_array_equal(g_train, r_train)
        np.testing.assert_array_equal(g_test, r_test)


def test_stratified_folds_raise_and_warn_as_sklearn():
    for split in (lambda y: list(StratifiedKFold(5).split(np.zeros((y.size, 1)), y)), L.fold_indices):
        with pytest.raises(ValueError, match="n_splits=5 cannot be greater than the number of "
                                             "members in each class"):
            split(np.arange(12))  # one shot a class
        with pytest.raises(ValueError, match="n_splits=5 greater than the number of samples: "
                                             "n_samples=4"):
            split(np.asarray([0, 1, 0, 1]))
    some_few = np.asarray([0] * 7 + [1] * 3 + [2] * 6)
    with pytest.warns(UserWarning, match="only 3 members, which is less than n_splits=5") as ref_w:
        ref = list(StratifiedKFold(5).split(np.zeros((some_few.size, 1)), some_few))
    with pytest.warns(UserWarning, match="only 3 members, which is less than n_splits=5") as got_w:
        got = L.fold_indices(some_few)
    assert str(got_w[0].message) == str(ref_w[0].message)
    for (g, _), (r, _) in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_scaler_matches_standard_scaler():
    rng = np.random.default_rng(2)
    x = rng.normal(3.0, 2.0, size=(40, 6))
    x[:, 2] = 7.25  # constant: scaled by 1
    x[:, 4] *= 1e-3
    ref = StandardScaler().fit(x)
    got = L.Scaler(torch.from_numpy(x))
    np.testing.assert_allclose(got.mean.numpy(), ref.mean_, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got.scale.numpy(), ref.scale_, rtol=1e-12)
    assert got.scale[2] == 1.0
    np.testing.assert_allclose(got(torch.from_numpy(x)).numpy(), ref.transform(x), atol=1e-12)


def _clusters(seed, n_classes=4, per_class=30, dim=8, spread=1.0, offset=2.0):
    """Seeded gaussian clusters on correlated, shifted features."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(n_classes, dim)) * offset
    y = np.repeat(np.arange(n_classes), per_class)
    mix = rng.normal(size=(dim, dim)) / np.sqrt(dim) + np.eye(dim)
    x = (centres[y] + spread * rng.normal(size=(y.size, dim))) @ mix + 5.0
    order = rng.permutation(y.size)
    return x[order], y[order]


def _codes(y):
    return np.unique(y, return_inverse=True)[1]


@pytest.mark.parametrize("alpha", L.ALPHAS)
def test_minimum_is_no_higher_than_hvts_sgd(alpha):
    x, y = _clusters(0, spread=2.0)
    pipe = sklearn.base.clone(jprobe.build_linear_model(n_jobs=1).estimator)
    pipe.set_params(sgdclassifier__alpha=alpha, sgdclassifier__random_state=0).fit(x, y)
    xs = torch.from_numpy(pipe[0].transform(x))
    sgd = pipe[-1]
    sgd_objective = L.ovr_objective(xs, _codes(y), torch.from_numpy(sgd.coef_.T.copy()),
                                    torch.from_numpy(sgd.intercept_.copy()), alpha)
    fit = L.fit_ovr(torch.from_numpy(x), y, alpha)
    assert fit.objective <= sgd_objective * (1 + 1e-6), (fit.objective, sgd_objective)
    # the whole grid search of hvt's estimator, its random_state set on it
    grid = jprobe.build_linear_model(n_jobs=1)
    grid.set_params(estimator__sgdclassifier__random_state=0, verbose=0).fit(x, y)
    best = grid.best_estimator_[-1]
    best_alpha = grid.best_params_["sgdclassifier__alpha"]
    objective = L.ovr_objective(torch.from_numpy(grid.best_estimator_[0].transform(x)), _codes(y),
                                torch.from_numpy(best.coef_.T.copy()),
                                torch.from_numpy(best.intercept_.copy()), best_alpha)
    assert L.fit_ovr(torch.from_numpy(x), y, best_alpha).objective <= objective * (1 + 1e-6)


def _scipy_minimum(xs, y, alpha):
    """scipy's L-BFGS-B on the one-vs-rest objective, written in numpy."""
    xs = xs.numpy()
    classes, codes = np.unique(y, return_inverse=True)
    k = 1 if classes.size == 2 else classes.size
    n, d = xs.shape
    sign = -np.ones((n, k))
    if k == 1:
        sign[codes == 1, 0] = 1.0
    else:
        sign[np.arange(n), codes] = 1.0

    def f(theta):
        w, b = theta[:d * k].reshape(d, k), theta[d * k:]
        z = -sign * (xs @ w + b)
        g = -sign * scipy.special.expit(z) / n
        loss = np.logaddexp(0.0, z).sum() / n + 0.5 * alpha * np.square(w).sum()
        return loss, np.concatenate([(xs.T @ g + alpha * w).ravel(), g.sum(0)])

    r = scipy.optimize.minimize(f, np.zeros(d * k + k), jac=True, method="L-BFGS-B",
                                options={"maxiter": 20000, "gtol": 1e-12, "ftol": 0.0})
    return r.fun, r.x[:d * k].reshape(d, k)


@pytest.mark.parametrize("n_classes", [2, 5])
@pytest.mark.parametrize("alpha", L.ALPHAS)
def test_fit_reaches_scipys_minimum(n_classes, alpha):
    x, y = _clusters(1, n_classes=n_classes, spread=2.5)
    x = torch.from_numpy(x)
    ref, ref_w = _scipy_minimum(L.Scaler(x)(x), y, alpha)
    fit = L.fit_ovr(x, y, alpha)
    assert fit.weight.shape == (8, 1 if n_classes == 2 else n_classes)
    assert abs(fit.objective - ref) <= 1e-6 * ref
    tight = L.fit_ovr(x, y, alpha, tol=1e-9, max_iter=5000)
    assert abs(tight.objective - ref) <= 1e-10 * ref
    assert np.abs(tight.weight.numpy() - ref_w).max() <= 1e-4 * np.abs(ref_w).max()
    f32 = L.fit_ovr(x.float(), y, alpha)
    assert f32.weight.dtype == torch.float32
    assert abs(f32.objective - ref) <= 1e-5 * ref
    # predict: argmax of the decision values, or the second class where positive
    s = tight.decision(x)
    want = (s[:, 0] > 0).long() if n_classes == 2 else s.argmax(1)
    np.testing.assert_array_equal(tight.predict(x), np.unique(y)[want.numpy()])


def test_grid_search_matches_hvt_on_separated_clusters():
    # separated so that SGD's answer classifies as the minimum does: every
    # fold of every alpha scores 1 on both, and the first alpha wins the tie
    x, y = _clusters(3, n_classes=5, per_class=40, spread=0.5, offset=3.0)
    x_test, y_test = _clusters(3, n_classes=5, per_class=40, spread=0.5, offset=3.0)
    x_test = x_test + np.random.default_rng(9).normal(scale=0.3, size=x_test.shape)
    grid = jprobe.build_linear_model(n_jobs=1)
    grid.set_params(estimator__sgdclassifier__random_state=0, verbose=0).fit(x, y)
    probe = L.LinearProbe().fit(x, y)
    ref_scores = np.stack([grid.cv_results_[f"split{i}_test_score"] for i in range(5)], 1)
    np.testing.assert_array_equal(probe.cv_scores_, ref_scores)
    assert probe.best_alpha_ == grid.best_params_["sgdclassifier__alpha"]
    assert np.mean(probe.predict(x_test) == y_test) == np.mean(grid.predict(x_test) == y_test)
    assert len(probe.fold_fits_) == 15 and all(f["iterations"] > 0 for f in probe.fold_fits_)


# ---------------------------------------------------------------------------
# python -m hvt_torch.linear_probe
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return downstream.write_folder(tmp_path_factory.mktemp("probe-fixture"))


def _seeded_sgd(monkeypatch):
    build = jprobe.build_linear_model

    def seeded(n_jobs=1):
        return build(n_jobs=1).set_params(estimator__sgdclassifier__random_state=0)

    monkeypatch.setattr(jprobe, "build_linear_model", seeded)


def test_linear_probe_main_matches_hvt(folder, tmp_path, monkeypatch, capsys):
    _seeded_sgd(monkeypatch)
    jcfg, tcfg = downstream.config_pair(folder, tmp_path, "linear-probing")
    ref = jprobe.main(jcfg)
    capsys.readouterr()
    got = tprobe.main(tcfg, device="cpu")
    out = capsys.readouterr().out
    assert got == ref == {"acc@1": 1.0, "tree-dist": 0.0}
    for line in ("Loaded train features.", "Loaded test features.",
                 "Fitting 5 folds for each of 3 candidates, totalling 15 fits",
                 "acc@1: 1.0000", "tree-dist: 0.0000"):
        assert line in out
    for is_train in (True, False):
        downstream.assert_close(
            np.load(tfeatures_path(tcfg, is_train)), np.load(jfeatures_path(jcfg, is_train)),
            1e-4, "features")
    rec, ref_rec = downstream.last_record(tmp_path / "port"), downstream.last_record(tmp_path / "hvt")
    assert rec.pop("time") > 0 and ref_rec.pop("time") > 0
    assert rec == ref_rec == {"step": 0, "linear-probe/acc@1": 1.0, "linear-probe/tree-dist": 0.0}


def tfeatures_path(cfg, is_train):
    from hvt_torch.downstream import features

    return features.cache_path(cfg, "linear-probe", is_train)


def jfeatures_path(cfg, is_train):
    from hvt.downstream import features

    return features.cache_path(cfg, "linear-probe", is_train)


def test_linear_probe_main_raises_as_hvt_on_one_shot_splits(tmp_path, monkeypatch):
    _seeded_sgd(monkeypatch)
    # rand_species_1shot's shape: more rows than folds, every class one
    root = downstream.write_folder(tmp_path / "one-shot", train=1, val=1,
                                   names=tsynthetic.synthetic_class_names(7))
    uris = downstream.write_weights(tmp_path, "resnet_micro")
    jcfg, tcfg = downstream.config_pair(root, tmp_path, "linear-probe", uris=uris)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ValueError, match="n_splits=5 cannot be greater") as ref:
            jprobe.main(jcfg)
    with pytest.raises(ValueError, match="n_splits=5 cannot be greater") as got:
        tprobe.main(tcfg, device="cpu")
    assert str(got.value) == str(ref.value)


def test_linear_probe_main_refuses_other_variants(folder, tmp_path):
    jcfg, tcfg = downstream.config_pair(folder, tmp_path, "simpleshot", uris=("", ""))
    with pytest.raises(ValueError, match="linear-probe"):
        jprobe.main(jcfg)
    with pytest.raises(ValueError, match="linear-probe"):
        tprobe.main(tcfg, device="cpu")
