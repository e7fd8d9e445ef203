"""Pretrained weights for the downstream entry points — port of
``load_pretrained_variables`` in ``hvt/downstream/features.py``. Feature
extraction and its cache are ROADMAP.md queue 1, item 10."""

from __future__ import annotations

from typing import Optional

from hvt_torch.train import checkpoint as checkpoint_lib


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
