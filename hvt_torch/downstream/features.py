"""Frozen-feature extraction with its on-disk cache — port of
``hvt/downstream/features.py``.

A frozen pretrained backbone (PretrainedBackbone's ``checkpoint``, else
``model.pretrained_checkpoint``) runs the feature step over a split in the
loader's epoch-0 order; the pooled features are cached as f32 ``.npy`` at
``<save_root>/<kind>-features/<run_name>/<dataset>-{train|eval}-features.npy``.
Labels come from the dataset's scan, never from a decode, so a cache hit
opens no image and runs no forward. The linear probe and SimpleShot fit on
these features (``hvt_torch.downstream.linear``, ``.centroid``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from hvt_torch import config as config_lib
from hvt_torch import device as device_lib
from hvt_torch import parallel
from hvt_torch.data import DevicePrep, build_loader
from hvt_torch.data.loader import host_tensor
from hvt_torch.models import build_model
from hvt_torch.train import checkpoint as checkpoint_lib
from hvt_torch.train import ema as ema_lib
from hvt_torch.train import step as step_lib


def cache_path(config, kind: str, is_train: bool) -> str:
    """The split's feature cache (its directory is made here)."""
    save_dir = os.path.join(config.machine.save_root, f"{kind}-features", config.run_name)
    os.makedirs(save_dir, exist_ok=True)
    data_cfg = config.train_dataset if is_train else config.eval_dataset
    split = "train" if is_train else "eval"
    return os.path.join(save_dir, f"{data_cfg.path or 'synthetic'}-{split}-features.npy")


def load_pretrained_variables(config, params: dict, batch_stats: Optional[dict]
                              ) -> tuple[dict, Optional[dict]]:
    """The pretrained backbone the config names (PretrainedBackbone's
    ``checkpoint`` and ``strict``, else ``model.pretrained_checkpoint``)
    merged into ``params`` and ``batch_stats`` ({state-dict name: tensor});
    both come back unchanged when it names none. The running statistics
    travel with the weights: a frozen backbone normalises with them
    (reference models.py:155-205)."""
    uri, strict = None, False
    for algo in config.algorithms:
        if algo.cls == "PretrainedBackbone":
            uri = str(algo.args["checkpoint"])
            strict = bool(algo.args.get("strict", False))
    if uri is None:
        uri = config.model.pretrained_checkpoint
    if not uri:
        return params, batch_stats
    return checkpoint_lib.load_pretrained(uri, params, batch_stats, strict=strict)


def load_pretrained_params(config, params: dict) -> dict:
    """Params-only variant of :func:`load_pretrained_variables`."""
    return load_pretrained_variables(config, params, None)[0]


def extract_features(config, is_train: bool, kind: str, hierarchical_labels: bool = False,
                     device=None) -> tuple[np.ndarray, np.ndarray]:
    """→ (features (N, D) f32, labels (N,) or (N, 7) with
    ``hierarchical_labels``), padded rows dropped, in the split's epoch-0
    order. ``device`` None means the CUDA card (an error without one)."""
    parallel.one_process_entry(config, "feature extraction")
    device = device_lib.resolve(device)
    cfg_dict = config_lib.to_dict(config)
    cfg_dict["hierarchy"] = dict(cfg_dict["hierarchy"],
                                 variant="multitask" if hierarchical_labels else "")
    cfg_dict["is_train"] = True  # the loader builds no tree-distance matrix
    loader_cfg = config_lib.loads(cfg_dict)
    loader, _ = build_loader(loader_cfg, is_train=is_train, pin_memory=device.type == "cuda")
    labels = np.asarray(loader.dataset.labels)[loader.epoch_indices(0)]

    cache = cache_path(config, kind, is_train)
    if os.path.isfile(cache):
        print(f"Using cached features at {cache}.")
        return np.load(cache), labels

    # Features do not depend on the head: a 2-class head on the flat
    # hierarchy (reference linear_probe.py:143-144). hvt also switches its
    # SwinV2 attention to the Pallas kernel here on a TPU; the port routes
    # by the config's own knobs (fuse, use_pallas, ...) as everywhere else.
    flat_cfg = config_lib.loads(dict(cfg_dict, hierarchy=dict(cfg_dict["hierarchy"], variant="")))
    model = build_model(flat_cfg, 2)
    data_cfg = config.train_dataset if is_train else config.eval_dataset
    unsupported = device.type == "cuda" and model.cuda_unsupported(data_cfg.crop_size)
    if unsupported:
        raise NotImplementedError(
            f"{config.model.name} {dict(config.model.args)} at {data_cfg.crop_size} px "
            "does not run on the CUDA kernels yet: " + "; ".join(unsupported))
    params, batch_stats = dict(model.named_parameters()), ema_lib.batch_stats(model)
    src, src_stats = load_pretrained_variables(config, params, batch_stats)
    checkpoint_lib.copy_into(params, src, "params")
    checkpoint_lib.copy_into(batch_stats, src_stats, "batch_stats")
    model = model.to(device).eval()
    params, batch_stats = dict(model.named_parameters()), ema_lib.batch_stats(model)

    feature_step = step_lib.build_feature_step(model, DevicePrep.from_config(data_cfg,
                                                                             config.precision))
    feats = []
    for batch in loader.epoch(0):
        images = host_tensor(batch.images).to(device, non_blocking=True)
        keep = torch.from_numpy(batch.mask > 0).to(device, non_blocking=True)
        feats.append(feature_step(params, batch_stats, images)[keep].cpu())
    features = torch.cat(feats).numpy().astype(np.float32)
    np.save(cache, features)
    return features, labels


def l2_normalize(features: np.ndarray) -> np.ndarray:
    """Each row over its euclidean norm (reference simpleshot.py:139-145)."""
    assert features.ndim == 2
    return features / np.linalg.norm(features, ord=2, axis=1, keepdims=True)


def center(features: np.ndarray) -> np.ndarray:
    """Each row over its own mean: the reference divides where centring
    would subtract the train mean (reference simpleshot.py:148-154), and hvt
    keeps the quirk. Rows of mean near 0 (post-LayerNorm backbones) give
    inf/NaN, as there; use the l2n variant for them."""
    assert features.ndim == 2
    return features / np.mean(features, axis=1, keepdims=True)


def tree_distance(labels: np.ndarray, preds: np.ndarray, *, tree_dists: np.ndarray) -> float:
    """Mean tree distance between predictions and labels (reference
    linear_probe.py:57-58)."""
    return float(np.sum(tree_dists[preds, labels]) / labels.size)
