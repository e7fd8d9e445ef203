"""Linear probe on frozen features — the port of hvt's ``linear_probe.py``.

    python -m hvt_torch.linear_probe --machine configs/machines/local.yaml \\
        --exp configs/linear_probe/r50_base.yaml <dataset and weights layers> [--device cpu]

The frozen pretrained backbone extracts (or reads from its cache) the
train and eval features, the train rows are shuffled with ``seed``, and the
probe hvt fits with sklearn (StandardScaler, then one-vs-rest logistic
regression, alpha in {1e-4, 1e-2, 1} chosen over 5 stratified folds) is fit
by :mod:`hvt_torch.downstream.linear`: the same folds, scaler and
objective, solved to convergence by L-BFGS instead of SGD. Prints
``acc@1`` (and ``tree-dist`` for a folder eval split) and logs them under
``linear-probe/``. Runs on the CUDA card (f32) unless ``--device cpu``
(f64).
"""

from __future__ import annotations

import argparse

import numpy as np

from hvt_torch import config as config_lib
from hvt_torch import device as device_lib
from hvt_torch import hierarchy, parallel
from hvt_torch.downstream import features as F
from hvt_torch.downstream import linear as linear_lib
from hvt_torch.utils.logging import publish_run_metrics


def main(config: config_lib.Config, device=None) -> dict:
    # the reference's configs spell the variant linear-probing
    if config.model.variant not in ("linear-probe", "linear-probing"):
        raise ValueError(f"model.variant must be linear-probe, got {config.model.variant!r}")
    parallel.one_process_entry(config, "hvt_torch.linear_probe")
    device = device_lib.resolve(device)
    config = config_lib.loads(config_lib.to_dict(config), {"model": {"variant": "linear-probe"}})

    train_features, train_classes = F.extract_features(config, is_train=True, kind="linear-probe",
                                                       device=device)
    print("Loaded train features.")
    test_features, test_classes = F.extract_features(config, is_train=False, kind="linear-probe",
                                                     device=device)
    print("Loaded test features.")

    # shuffled as hvt shuffles them: the stratified folds follow row order
    order = np.random.default_rng(config.seed).permutation(len(train_features))
    train_features, train_classes = train_features[order], train_classes[order]

    clf = linear_lib.LinearProbe(device=device, verbose=True).fit(train_features, train_classes)
    preds = clf.predict(test_features)

    metrics = {"acc@1": float(np.sum(preds == test_classes) / len(test_classes))}
    if config.eval_dataset.path:
        tree_dists = hierarchy.build_tree_dist_matrix(
            config.machine.datasets[config.eval_dataset.path])
        metrics["tree-dist"] = F.tree_distance(test_classes, preds, tree_dists=tree_dists)

    for key, value in metrics.items():
        print(f"{key}: {value:.4f}")

    publish_run_metrics(config, metrics, prefix="linear-probe")
    return metrics


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m hvt_torch.linear_probe",
                                     description=__doc__.splitlines()[0])
    config_lib.add_exp_args(parser)
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card (an error without one)")
    args = parser.parse_args()
    main(config_lib.load(machine=args.machine, exps=args.exp), device=args.device)
