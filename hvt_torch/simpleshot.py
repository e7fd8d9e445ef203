"""SimpleShot nearest-centroid evaluation on frozen features — the port
of hvt's ``simpleshot.py``.

    python -m hvt_torch.simpleshot --machine configs/machines/local.yaml \\
        --exp configs/simpleshot/r50_base.yaml <dataset and weights layers> [--device cpu]

Frozen features (extracted or read from their cache), optionally
``center``-ed (``simpleshot.centered`` or ``simpleshot-cl2n``) and
``l2_normalize``-d (``simpleshot.l2_normalized``, ``simpleshot-l2n`` or
``-cl2n``), then the flat nearest centroid or, with
``simpleshot.hierarchical``, the parent-constrained top-down centroid over
the train folder's taxonomy, scored on the species tier. Prints ``acc@1``
(and ``tree-dist`` for a folder eval split) and logs them under
``simpleshot/``. Features and centroids live on the CUDA card unless
``--device cpu``; the centroids are f64 on either.
"""

from __future__ import annotations

import argparse

import numpy as np

from hvt_torch import config as config_lib
from hvt_torch import device as device_lib
from hvt_torch import hierarchy, parallel
from hvt_torch.downstream import centroid as centroid_lib
from hvt_torch.downstream import features as F
from hvt_torch.utils.logging import publish_run_metrics


def main(config: config_lib.Config, device=None) -> dict:
    if not config.model.variant.startswith("simpleshot"):
        raise ValueError(
            f"model.variant must be a simpleshot variant, got {config.model.variant!r}")
    parallel.one_process_entry(config, "hvt_torch.simpleshot")
    device = device_lib.resolve(device)

    hier = config.simpleshot.hierarchical
    train_features, train_classes = F.extract_features(
        config, is_train=True, kind="simpleshot", hierarchical_labels=hier, device=device)
    print("Loaded train features.")
    test_features, test_classes = F.extract_features(
        config, is_train=False, kind="simpleshot", hierarchical_labels=hier, device=device)
    print("Loaded test features.")

    # the variant shorthands imply the normalisations
    centered = config.simpleshot.centered or config.model.variant == "simpleshot-cl2n"
    l2n = config.simpleshot.l2_normalized or config.model.variant in ("simpleshot-l2n",
                                                                      "simpleshot-cl2n")
    if centered:
        train_features, test_features = F.center(train_features), F.center(test_features)
    if l2n:
        train_features = F.l2_normalize(train_features)
        test_features = F.l2_normalize(test_features)

    if hier:
        lookups = hierarchy.build_parent_label_lookup(
            config.machine.datasets[config.train_dataset.path])
        clf = centroid_lib.HierarchicalNearestCentroid(lookups, device=device)
    else:
        clf = centroid_lib.NearestCentroid(device=device)
    clf.fit(train_features, train_classes)
    preds = clf.predict(test_features)

    if hier:  # scored on the species tier
        assert test_classes.shape[1] == hierarchy.N_TIERS
        test_classes, preds = test_classes[:, -1], preds[:, -1]

    metrics = {"acc@1": float(np.sum(preds == test_classes) / len(test_classes))}
    if config.eval_dataset.path:
        tree_dists = hierarchy.build_tree_dist_matrix(
            config.machine.datasets[config.eval_dataset.path])
        metrics["tree-dist"] = F.tree_distance(test_classes, preds, tree_dists=tree_dists)

    for key, value in metrics.items():
        print(f"{key}: {value:.4f}")

    publish_run_metrics(config, metrics, prefix="simpleshot")
    return metrics


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m hvt_torch.simpleshot",
                                     description=__doc__.splitlines()[0])
    config_lib.add_exp_args(parser)
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card (an error without one)")
    args = parser.parse_args()
    main(config_lib.load(machine=args.machine, exps=args.exp), device=args.device)
