"""Top-k inference: the server's step and batch prediction — port of
``hvt/downstream/predict.py`` without its serving-artifact and int8
branches (ROADMAP.md queue 1, item 10).

``build_topk_step`` returns ``step(images uint8 (B, H, W, 3) numpy) →
(top_i, top_p, tiers, n_allowed)`` as numpy: device prep, the forward under
``torch.inference_mode()``, then the flat or constrained hierarchical
(top-down) decode, on the model's device. ``predict`` runs it over the eval
split and yields one record per image (the top-k ``classes``, ``class_ids``
and ``probs``, ``tier_ids`` with the hierarchical decode, the ``label``, and
the file ``path`` of a folder dataset); ``run`` writes them as JSONL.

Weights resolve in hvt's order: ``load_path`` (a port checkpoint, its EMA
copy unless ``use_ema`` is false), else the pretrained URIs (``ckpt://``,
``swin://``, ``torch://``; the head from the model's seeded init), else the
seeded init.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from hvt_torch import device as device_lib
from hvt_torch import parallel
from hvt_torch.data import DevicePrep, build_loader
from hvt_torch.downstream import features as features_lib
from hvt_torch.models import build_model
from hvt_torch.train import checkpoint as checkpoint_lib
from hvt_torch.train import ema as ema_lib


def _resolve_weights(config, model: torch.nn.Module, use_ema: bool = True) -> torch.nn.Module:
    """Load a serving model's weights (hvt's order): ``load_path``, a port
    checkpoint (its EMA copy unless ``use_ema`` is false), else the
    pretrained URIs (``ckpt://``, ``swin://``, ``torch://``; the head from
    the model's seeded init), else the seeded init (``config.seed``).
    Returns the model."""
    params, batch_stats = dict(model.named_parameters()), ema_lib.batch_stats(model)
    if config.load_path:
        raw = checkpoint_lib.load_raw(config.load_path)
        src, src_stats = raw["params"], raw["batch_stats"]
        if use_ema and raw.get("ema_params") is not None:
            src, src_stats = raw["ema_params"], raw["ema_batch_stats"]
    else:
        src, src_stats = features_lib.load_pretrained_variables(config, params, batch_stats)
    checkpoint_lib.copy_into(params, src, "params")
    checkpoint_lib.copy_into(batch_stats, src_stats, "batch_stats")
    return model


def _top_down_decode(tier_logits, lookups):
    """Constrained hierarchical decode: per-tier argmax, each tier restricted to
    the children of the previous tier's prediction. Returns (tier preds,
    masked fine-tier logits, per-row allowed-child count of the fine tier)."""
    neg = torch.tensor(-1e30, dtype=torch.float32, device=tier_logits[0].device)
    masked = tier_logits[0].float()
    preds = [masked.argmax(-1)]
    n_allowed = torch.full(masked.shape[:1], masked.shape[-1], dtype=torch.int32,
                           device=masked.device)
    for t in range(1, len(tier_logits)):
        parents = torch.as_tensor(lookups[t - 1], device=masked.device)
        allowed = parents[None, :] == preds[-1][:, None]
        masked = torch.where(allowed, tier_logits[t].float(), neg)
        preds.append(masked.argmax(-1))
        n_allowed = allowed.sum(-1).to(torch.int32)
    return preds, masked, n_allowed


def taxonomy_lookups(classes, num_classes):
    """Validated parent lookups for constrained hierarchical decoding."""
    if not isinstance(num_classes, tuple):
        raise ValueError("hierarchical decoding needs a multitask model (hierarchy.variant: multitask)")
    from hvt_torch import hierarchy as hierarchy_lib

    name = None
    try:
        for name in classes:
            hierarchy_lib.HierarchicalLabel.parse(name)
    except ValueError as e:
        raise ValueError(
            "hierarchical decoding needs taxonomy-formatted class directory names "
            f"('<index>_<kingdom>_..._<species>'); got {name!r}"
        ) from e
    return hierarchy_lib.parent_lookup_from_classes(classes)


def _decode_topk(out, lookups, k):
    """Model output (logits or per-tier logits) → (top_i, top_p, tiers, n_allowed)."""
    tiers = n_allowed = None
    if isinstance(out, (list, tuple)):
        if lookups is not None:
            tier_preds, out, n_allowed = _top_down_decode(out, lookups)
            tiers = torch.stack(tier_preds, dim=-1)
        else:
            out = out[-1]
    probs = torch.softmax(out.float(), dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    return top_i, top_p, tiers, n_allowed


def build_topk_step(model, prep, lookups, k, device: torch.device):
    """→ ``step(images) → (top_i, top_p, tiers, n_allowed)`` numpy arrays."""

    def step(images: np.ndarray):
        with torch.inference_mode():
            x = prep.normalize(torch.from_numpy(np.ascontiguousarray(images)).to(device))
            out = _decode_topk(model(x), lookups, k)
        return tuple(None if v is None else v.cpu().numpy() for v in out)

    return step


def topk_record(classes, row, top_i, top_p, tiers, n_allowed, k) -> dict:
    """One image row of a step's output → the JSON-ready top-k record; a
    hierarchical decode trims to the predicted parent's child count."""
    kk = k if n_allowed is None else min(k, int(n_allowed[row]))
    rec = {
        "classes": [classes[i] if classes else int(i) for i in top_i[row][:kk]],
        "class_ids": [int(i) for i in top_i[row][:kk]],
        "probs": [round(float(p), 6) for p in top_p[row][:kk]],
    }
    if tiers is not None:
        rec["tier_ids"] = [int(t) for t in tiers[row]]
    return rec



def predict(config, *, topk: int = 5, use_ema: bool = True, hierarchical: bool = False,
            limit_batches: Optional[int] = None, artifact: Optional[str] = None,
            quantize: Optional[str] = None, calibrate: int = 0, device=None):
    """→ an iterator of one top-k record per image of the eval split (padded
    rows skipped), over at most ``limit_batches`` batches. ``hierarchical``
    (multitask models): the top-down decode, the species tier's top-k.
    ``device`` None means the CUDA card (an error without one). Serving
    artifacts and int8 (``artifact``, ``quantize``, ``calibrate``) raise."""
    if artifact is not None or quantize is not None or calibrate:
        raise NotImplementedError("prediction from serving artifacts and int8 (artifact, quantize, "
                                  "calibrate) is not ported yet (ROADMAP.md queue 1, item 10)")
    parallel.one_process_entry(config, "batch prediction")
    device = device_lib.resolve(device)
    loader, info = build_loader(config, is_train=False)
    data_cfg = config.eval_dataset
    model = build_model(config, info.num_classes)
    unsupported = device.type == "cuda" and model.cuda_unsupported(data_cfg.crop_size)
    if unsupported:
        raise NotImplementedError(
            f"{config.model.name} {dict(config.model.args)} at {data_cfg.crop_size} px "
            "does not run on the CUDA kernels yet: " + "; ".join(unsupported))
    classes = list(getattr(loader.dataset, "classes", ()))
    lookups = taxonomy_lookups(classes, info.num_classes) if hierarchical else None
    k = min(topk, info.fine_grained_num_classes)
    model = _resolve_weights(config, model, use_ema).to(device).eval()
    step = build_topk_step(model, DevicePrep.from_config(data_cfg, config.precision), lookups, k,
                           device)
    return _records(loader, step, classes, k, limit_batches)


def _records(loader, step, classes, k, limit_batches):
    paths = getattr(loader.dataset, "paths", None)
    for batch_idx, batch in enumerate(loader.epoch(0)):
        if limit_batches is not None and batch_idx >= limit_batches:
            break
        top_i, top_p, tiers, n_allowed = step(batch.images)
        for row in range(batch.images.shape[0]):
            if batch.mask[row] <= 0:
                continue
            rec = topk_record(classes, row, top_i, top_p, tiers, n_allowed, k)
            label = batch.labels[row]
            rec["label"] = [int(t) for t in label] if np.ndim(label) else int(label)
            if paths is not None and batch.indices is not None:
                rec["path"] = str(paths[int(batch.indices[row])])
            yield rec


def run(config, output: Optional[str], **kwargs) -> dict:
    """Predict and write JSONL to ``output`` (stdout without one); returns
    ``{"count", "top1", "topk"}``, the accuracy against the dataset's labels
    (the species tier of a multitask label)."""
    n = hit1 = hitk = 0
    records = predict(config, **kwargs)
    out_f = open(output, "w") if output else None
    try:
        for rec in records:
            n += 1
            label = rec["label"][-1] if isinstance(rec["label"], list) else rec["label"]
            hit1 += label == rec["class_ids"][0]
            hitk += label in rec["class_ids"]
            line = json.dumps(rec)
            if out_f is not None:
                out_f.write(line + "\n")
            else:
                print(line)
    finally:
        if out_f is not None:
            out_f.close()
    summary = {"count": n, "top1": hit1 / n if n else 0.0, "topk": hitk / n if n else 0.0}
    if output:
        print(f"[{config.run_name}] wrote {n} predictions to {output} "
              f"(top1={summary['top1']:.4f}, topk={summary['topk']:.4f})")
    return summary
