"""Batch-prediction entry point of the port, with the CLI of hvt's
``predict.py``.

    python -m hvt_torch.predict --machine configs/machines/local.yaml \\
        --exp configs/pretrain/swinv2_tiny.yaml --output preds.jsonl \\
        [--topk 5] [--raw-weights] [--hierarchical] [--limit-batches N] \\
        [--quantize int8 [--calibrate N]] [--device cpu]

Writes one JSON line per image of the eval split (stdout without
``--output``): the top-k class names, ids and probabilities, the label,
and the file path of a folder dataset; ``--hierarchical`` decodes a
multitask model top-down and adds the per-tier ids. Weights: ``load_path``
(a port checkpoint, its EMA copy unless ``--raw-weights``), else a
PretrainedBackbone or ``model.pretrained_checkpoint`` URI, else the seeded
init. ``--quantize int8`` runs the w8a8 forward, ``--calibrate N`` with
static activation scales from the first N eval batches. Runs on the CUDA
card unless ``--device cpu``. Serving artifacts (``--artifact``) are not
ported yet.
"""

from __future__ import annotations

import argparse

from hvt_torch import config as config_lib
from hvt_torch.serve import NOT_PORTED, NotPorted, add_quant_args, check_quant_args


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m hvt_torch.predict",
                                     description=__doc__.splitlines()[0])
    config_lib.add_exp_args(parser)
    parser.add_argument("--output", default=None, help="JSONL path (default: stdout)")
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--raw-weights", action="store_true",
                        help="the checkpoint's trained weights rather than its EMA copy")
    parser.add_argument("--hierarchical", action="store_true",
                        help="multitask models: top-down parent-constrained decode; rows gain "
                             "per-tier predictions")
    parser.add_argument("--limit-batches", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card (an error without one)")
    parser.add_argument("--artifact", action=NotPorted,
                        help=f"prediction from a StableHLO serving artifact {NOT_PORTED}")
    add_quant_args(parser)
    return parser


def main(argv=None) -> dict:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_quant_args(parser, args)
    from hvt_torch.downstream import predict as predict_lib

    config = config_lib.load(machine=args.machine, exps=args.exp)
    return predict_lib.run(config, args.output, topk=args.topk, use_ema=not args.raw_weights,
                           hierarchical=args.hierarchical, limit_batches=args.limit_batches,
                           quantize=args.quantize, calibrate=args.calibrate, device=args.device)


if __name__ == "__main__":
    main()
