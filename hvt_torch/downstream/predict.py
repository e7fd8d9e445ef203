"""Top-k inference step and decode — port of the parts of
``hvt/downstream/predict.py`` that the server uses.

``build_topk_step`` returns ``step(images uint8 (B, H, W, 3) numpy) →
(top_i, top_p, tiers, n_allowed)`` as numpy: device prep, the forward under
``torch.inference_mode()``, then the flat or constrained hierarchical
(top-down) decode, on the model's device.
"""

from __future__ import annotations

import numpy as np
import torch

from hvt_torch.downstream import features as features_lib
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
