"""Export a port checkpoint to the reference torch format — port of
``hvt/tools/export_torch.py``.

    python -m hvt_torch.tools.export_torch <checkpoint-uri> <out.pt> [--raw]

``checkpoint-uri`` is a checkpoints directory (its latest step), a step's
directory or ``ckpt://<dir>:<step>``. The file holds ``{"model":
state_dict}``: SwinV2 in the Microsoft naming, ResNet in timm's
``conv1/bn1/layer{s}.{b}/fc`` naming with the BatchNorm running statistics,
which ``swin://``/``torch://`` URIs read back (the port's and hvt's
``load_torch_variables``). The EMA copy is exported where the checkpoint has
one; ``--raw`` exports the trained parameters instead.
"""

from __future__ import annotations

import argparse


def export(uri: str, out: str, use_ema: bool = True) -> dict:
    from hvt_torch.models import torch_compat
    from hvt_torch.train import checkpoint as checkpoint_lib

    raw = checkpoint_lib.load_raw(uri)
    ema = use_ema and raw.get("ema_params") is not None
    params = raw["ema_params"] if ema else raw["params"]
    stats = raw["ema_batch_stats"] if ema else raw["batch_stats"]
    if "patch_embed.weight" in params:  # SwinV2 (LayerNorm: no running statistics)
        keys, family = torch_compat.save_swin_checkpoint(params, out), "swinv2"
    elif "stem.conv.weight" in params:
        keys, family = torch_compat.save_resnet_checkpoint(params, stats, out), "resnet"
    else:
        raise ValueError("torch export covers the SwinV2 family (the reference's swin:// format) "
                         "and the ResNet family (timm naming); this checkpoint matches neither "
                         f"(first names: {sorted(params)[:8]})")
    return {"keys": keys, "family": family, "source": "ema_params" if ema else "params"}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m hvt_torch.tools.export_torch",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint")
    parser.add_argument("out")
    parser.add_argument("--raw", action="store_true",
                        help="export the trained parameters even where EMA weights exist")
    args = parser.parse_args(argv)
    info = export(args.checkpoint, args.out, use_ema=not args.raw)
    print(f"wrote {args.out}: {info['family']}, {info['keys']} tensors from {info['source']}")


if __name__ == "__main__":
    main()
