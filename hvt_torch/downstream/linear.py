"""The linear probe's fit, without sklearn.

hvt fits the probe with sklearn (``linear_probe.py``'s
``build_linear_model``)::

    GridSearchCV(make_pipeline(StandardScaler(), SGDClassifier(loss="log_loss")),
                 {"sgdclassifier__alpha": [1e-4, 1e-2, 1.0]})

and the card's machine has no sklearn, so the port carries its own fit of
the same estimator, in torch on the features' device:

* folds: ``StratifiedKFold(n_splits=5, shuffle=False)``, sklearn's
  ``_make_test_folds`` in numpy (classes encoded by first appearance, each
  class spread over the folds by ``bincount(sort(y)[i::5])``, folds given out
  in row order; its ``ValueError`` when there are fewer than 5 rows or
  every class has fewer than 5 members, its warning when some have). The
  folds depend on the row order, so the caller shuffles as hvt does first.
* scaler: each fit standardises with its training rows' mean and
  population standard deviation, a (near) constant column scaled by 1, as
  ``StandardScaler`` does.
* classifier: one-vs-rest over the classes of the training rows (one
  classifier for two classes), class c minimising
  ``mean_i log(1 + exp(-y_ic (x_i·w_c + b_c))) + alpha/2 ||w_c||²`` with y in
  {-1, +1} and the intercept not penalised: ``SGDClassifier``'s objective
  with ``penalty="l2"``. ``predict`` is the class of the largest decision
  value, the first on a tie (for two classes the second class where the
  decision is positive).
* selection: the mean fold accuracy picks alpha, the first on a tie; the
  refit uses every training row.

Where the port differs from hvt: it solves this convex objective to
convergence, deterministically, with full-batch L-BFGS in torch on every
class at once, batched: each class keeps its own curvature pairs (10), its
own step (Armijo backtracking from 1) and its own end, its gradients within
``tol`` (max-abs, 1e-7), or its objective lowered by less than 1e-9 of
itself three iterations running in f32 (1e-13 in f64: where the products
resolve no further), within ``max_iter`` (1000) iterations. (One L-BFGS over
all classes together, sharing pairs and steps, needs 10-30 times the
iterations: the classes' curvatures differ by orders of magnitude.) The
objective is summed in f64 in either dtype. It does not replay SGD's
trajectory: hvt's ``SGDClassifier`` runs with ``random_state=None`` and
stops after a few epochs, so its own answer changes from run to run and lies
above this minimum. Arithmetic is f32 on the card (TF32 off for the fit)
and f64 on the CPU unless ``dtype`` says otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

ALPHAS = (1e-4, 1e-2, 1.0)
N_SPLITS = 5
TOL = 1e-7  # max |gradient| of an output's objective at convergence
MAX_ITER = 1000  # L-BFGS iterations a fit
HISTORY = 10  # curvature pairs each output keeps
ARMIJO = 1e-4  # sufficient decrease of the backtracking line search
HALVINGS = 12  # halvings a line search tries before the output counts as stalled
# an output whose objective falls by less than this (relative) three
# iterations running is done: where f32's products resolve no further
STALL_RTOL = {torch.float32: 1e-9, torch.float64: 1e-13}


def fold_indices(y) -> list[tuple[np.ndarray, np.ndarray]]:
    """[(train rows, test rows)] of each fold, as ``StratifiedKFold(5).split``
    (no shuffle) gives them."""
    y = np.asarray(y)
    if y.ndim != 1:
        raise ValueError(f"labels must be one-dimensional, got shape {y.shape}")
    if N_SPLITS > y.size:
        raise ValueError(f"Cannot have number of splits n_splits={N_SPLITS} greater than the "
                         f"number of samples: n_samples={y.size}.")
    _, first, inverse = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(first, return_inverse=True)
    encoded = class_perm[inverse]  # classes numbered by first appearance
    n_classes = first.size
    counts = np.bincount(encoded)
    if np.all(N_SPLITS > counts):
        raise ValueError(
            "n_splits=%d cannot be greater than the number of members in each class." % N_SPLITS)
    if N_SPLITS > counts.min():
        warnings.warn("The least populated class in y has only %d members, which is less than "
                      "n_splits=%d." % (counts.min(), N_SPLITS), UserWarning)
    ordered = np.sort(encoded)
    allocation = np.asarray([np.bincount(ordered[i::N_SPLITS], minlength=n_classes)
                             for i in range(N_SPLITS)])
    folds = np.empty(len(y), dtype="i")
    for k in range(n_classes):
        folds[encoded == k] = np.arange(N_SPLITS).repeat(allocation[:, k])
    rows = np.arange(len(y))
    return [(rows[folds != i], rows[folds == i]) for i in range(N_SPLITS)]


class Scaler:
    """``StandardScaler`` fitted on ``x`` (N, D): (x - mean) / std, with the
    population std and 1 in place of a (near) constant column's."""

    def __init__(self, x: torch.Tensor):
        n = x.shape[0]
        self.mean = x.mean(0)
        var = (x - self.mean).square_().mean(0)
        eps = torch.finfo(x.dtype).eps
        constant = var <= n * eps * var + (n * self.mean * eps).square()
        self.scale = torch.where(constant, torch.ones_like(var), var.sqrt())

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.scale


@contextlib.contextmanager
def _exact_matmul():
    """TF32 off for the products of a fit (their f32 sums stay f32)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _positives(codes: torch.Tensor, n_outputs: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, outputs) of the +1 targets: each row's own class, or for one
    output (two classes) the rows of the second class."""
    if n_outputs == 1:
        rows = torch.nonzero(codes == 1).flatten()
        return rows, torch.zeros_like(rows)
    return torch.arange(codes.shape[0], device=codes.device), codes


def _objective(xs, positives, w, b, alpha, grad: bool = True):
    """Each output's objective, (outputs,) in f64, and with ``grad`` its
    gradients (w (D, outputs), b (outputs,))."""
    n = xs.shape[0]
    rows, cols = positives
    z = torch.addmm(b, xs, w)  # decision values s; z = -y·s from here on
    z[rows, cols] = z[rows, cols].neg()
    # summed in f64: the line search compares objectives that differ by less
    # than f32 resolves near the minimum
    f = (z.clamp(min=0) + torch.log1p(torch.exp(-z.abs()))).sum(0, dtype=torch.float64) / n
    f += 0.5 * alpha * w.square().sum(0, dtype=torch.float64)
    if not grad:
        return f
    z.sigmoid_()  # d loss / d s = -y·sigmoid(-y·s) / n
    z[rows, cols] = z[rows, cols].neg()
    z.div_(n)
    return f, xs.T @ z + alpha * w, z.sum(0)


def ovr_objective(xs: torch.Tensor, codes, w: torch.Tensor, b: torch.Tensor, alpha: float) -> float:
    """The summed objective at (w (D, K), b (K,)) of standardised rows ``xs``
    whose classes are ``codes`` (index of each row's class, in [0, K), or
    0/1 for one output)."""
    codes = torch.as_tensor(np.asarray(codes), device=xs.device)
    with torch.no_grad(), _exact_matmul():
        f = _objective(xs, _positives(codes, w.shape[1]), w.to(xs.dtype), b.to(xs.dtype), alpha,
                       grad=False)
    return float(f.sum())


@dataclasses.dataclass
class OneVsRest:
    """A fitted one-vs-rest logistic classifier on standardised inputs."""

    classes: np.ndarray
    scaler: Scaler
    weight: torch.Tensor  # (D, outputs)
    bias: torch.Tensor  # (outputs,)
    alpha: float
    objective: float
    iterations: int
    stop: str  # why the fit ended: "gradient", "stalled" or "max_iter"

    def decision(self, x: torch.Tensor) -> torch.Tensor:
        with _exact_matmul():
            return torch.addmm(self.bias, self.scaler(x.to(self.weight.dtype)), self.weight)

    def predict(self, x: torch.Tensor) -> np.ndarray:
        s = self.decision(x)
        enc = (s[:, 0] > 0).long() if s.shape[1] == 1 else s.argmax(1)
        return self.classes[enc.cpu().numpy()]


def _lbfgs(xs, positives, outputs: int, alpha: float, tol: float, max_iter: int):
    """L-BFGS on every output at once, each output with its own curvature
    pairs, step (Armijo backtracking from 1) and end: its gradients within
    ``tol``, or its objective stalled. → (w, b, iterations, stop)."""
    d = xs.shape[1]

    def evaluate(theta, grad=True):  # theta: w's rows, then b
        out = _objective(xs, positives, theta[:d], theta[d], alpha, grad)
        return (out[0], torch.cat([out[1], out[2][None]])) if grad else out

    theta = xs.new_zeros((d + 1, outputs))
    f, g = evaluate(theta)
    pairs = []  # (s, y, rho) of the last HISTORY iterations, oldest first
    active = torch.ones(outputs, dtype=torch.bool, device=xs.device)
    stalled, strikes = torch.zeros_like(active), torch.zeros(outputs, device=xs.device)
    iterations, stop = 0, "max_iter"
    while iterations < max_iter:
        active &= (g.abs().amax(0) > tol) & ~stalled
        if not bool(active.any()):
            stop = "stalled" if bool(stalled.any()) else "gradient"
            break
        # the two-loop recursion, each output on its own pairs
        q, coefs = g.clone(), []
        for s_, y_, rho in reversed(pairs):
            coefs.append(rho * (s_ * q).sum(0))
            q -= coefs[-1] * y_
        if pairs:
            s_, y_, rho = pairs[-1]
            gamma = torch.where(rho > 0, (s_ * y_).sum(0) / y_.square().sum(0).clamp(min=1e-300),
                                1.0)
        else:
            gamma = (1.0 / g.abs().sum(0)).clamp(max=1.0)
        q *= gamma
        for (s_, y_, rho), coef in zip(pairs, reversed(coefs)):
            q += s_ * (coef - rho * (y_ * q).sum(0))
        direction = torch.where(active, -q, 0.0)
        slope = (g * direction).sum(0)
        uphill = active & (slope >= 0)  # a poor curvature pair: steepest descent this once
        direction = torch.where(uphill, -g * gamma, direction)
        slope = torch.where(uphill, (g * direction).sum(0), slope)
        step = torch.where(active, 1.0, 0.0).to(xs.dtype)
        f_new, g_new = evaluate(theta + step * direction)
        ok = (f_new <= f + ARMIJO * step * slope) | ~active
        if not bool(ok.all()):  # backtrack the outputs that need it, on objectives alone
            for _ in range(HALVINGS):
                step = torch.where(ok, step, step / 2)
                ok = (evaluate(theta + step * direction, grad=False) <= f + ARMIJO * step * slope)
                ok |= ~active
                if bool(ok.all()):
                    break
            else:  # no sufficient decrease at any step tried: the output is done
                stalled |= ~ok
                step = torch.where(ok, step, 0.0)
            f_new, g_new = evaluate(theta + step * direction)
        new = theta + step * direction
        s_, y_ = new - theta, g_new - g
        sy = (s_ * y_).sum(0)
        pairs = [*pairs[1 - HISTORY:], (s_, y_, torch.where(sy > 0, 1.0 / sy, 0.0))]
        flat = active & (f - f_new <= STALL_RTOL[xs.dtype] * f_new.abs())
        strikes = torch.where(flat, strikes + 1, 0.0)
        stalled |= strikes >= 3
        theta, f, g = new, f_new, g_new
        iterations += 1
    return theta[:d], theta[d], iterations, stop


def fit_ovr(x: torch.Tensor, y, alpha: float, *, tol: float = TOL,
            max_iter: int = MAX_ITER) -> OneVsRest:
    """Standardise ``x`` (N, D) and fit the one-vs-rest classifier of labels
    ``y`` (N,) at ``alpha``, in ``x``'s dtype on its device. ``stop`` says
    why it ended: every gradient within ``tol`` ("gradient"), some output
    where its arithmetic resolves no further ("stalled"), or ``max_iter``
    iterations ("max_iter")."""
    y = np.asarray(y)
    classes, codes = np.unique(y, return_inverse=True)
    if classes.size < 2:
        raise ValueError(f"The number of classes has to be greater than one; got {classes.size} class")
    outputs = 1 if classes.size == 2 else classes.size
    scaler = Scaler(x)
    xs = scaler(x)
    positives = _positives(torch.as_tensor(codes, device=x.device), outputs)
    with torch.no_grad(), _exact_matmul():
        w, b, iterations, stop = _lbfgs(xs, positives, outputs, alpha, tol, max_iter)
        objective = float(_objective(xs, positives, w, b, alpha, grad=False).sum())
    return OneVsRest(classes, scaler, w, b, float(alpha), objective, iterations, stop)


class LinearProbe:
    """``GridSearchCV(StandardScaler → SGDClassifier(log_loss), alpha grid)``
    with the fit above: ``fit(X, y)`` scores each of ALPHAS over the
    stratified folds (``cv_scores_`` (alphas, folds); ``fold_fits_``: each
    fit's iterations, stop, objective and seconds), keeps the best
    (``best_alpha_``) and refits on every row (``model_``); ``predict(X)``.
    ``device`` None means the CPU; ``dtype`` defaults to f32 on the card
    and f64 on the CPU."""

    def __init__(self, *, device=None, dtype: Optional[torch.dtype] = None, verbose: bool = False):
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        self.dtype = dtype or (torch.float32 if self.device.type == "cuda" else torch.float64)
        self.verbose = verbose

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device).to(self.dtype)

    def fit(self, X, y) -> "LinearProbe":
        y = np.asarray(y)
        folds = fold_indices(y)
        if self.verbose:
            print(f"Fitting {N_SPLITS} folds for each of {len(ALPHAS)} candidates, "
                  f"totalling {N_SPLITS * len(ALPHAS)} fits")
        x = self._tensor(X)
        self.cv_scores_ = np.zeros((len(ALPHAS), N_SPLITS))
        self.fold_fits_ = []
        for j, (train, test) in enumerate(folds):
            train_t, test_t = (torch.as_tensor(r, device=self.device) for r in (train, test))
            for i, alpha in enumerate(ALPHAS):
                t0 = time.perf_counter()
                fit = fit_ovr(x[train_t], y[train], alpha)
                self.cv_scores_[i, j] = np.average(fit.predict(x[test_t]) == y[test])
                self.fold_fits_.append({"alpha": alpha, "fold": j, "iterations": fit.iterations,
                                        "stop": fit.stop, "objective": fit.objective,
                                        "seconds": time.perf_counter() - t0})
        self.mean_scores_ = self.cv_scores_.mean(1)
        self.best_alpha_ = ALPHAS[int(np.argmax(self.mean_scores_))]
        self.model_ = fit_ovr(x, y, self.best_alpha_)
        return self

    def predict(self, X) -> np.ndarray:
        return self.model_.predict(self._tensor(X))
