"""Inference-server entry point of the port.

    python -m hvt_torch.serve --machine configs/machines/local.yaml \\
        --exp configs/pretrain/swinv2_tiny.yaml [--port 8000] [--topk 5] \\
        [--batch 64] [--hierarchical] [--device cpu]

Then ``curl -s localhost:8000/healthz`` and
``curl -s --data-binary @image.jpg localhost:8000/predict?topk=3``.
Runs on the CUDA card unless ``--device cpu``. Weights: ``load_path`` (a
port checkpoint, its EMA copy unless ``--raw-weights``), else a
PretrainedBackbone or ``model.pretrained_checkpoint`` URI (``ckpt://``,
``swin://``, ``torch://``), else the seeded init. Serving artifacts and int8
(``--artifact``, ``--quantize``, ``--calibrate``) are not ported yet.
"""

from __future__ import annotations

import argparse

from hvt_torch import config as config_lib

NOT_PORTED = "is not ported to hvt_torch yet (ROADMAP.md queue 1, item 10)"


class NotPorted(argparse.Action):
    """A flag of hvt's serving tools (``serve.py``, ``predict.py``,
    ``serve_bench``) that the port refuses as soon as it is parsed, before
    the required --machine/--exp are checked."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string}: {self.help}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m hvt_torch.serve", description=__doc__.splitlines()[0])
    config_lib.add_exp_args(parser)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--topk", type=int, default=5)
    parser.add_argument("--batch", type=int, default=0,
                        help="batch shape of the forward (requests pad into it); 0 = 1")
    parser.add_argument("--raw-weights", action="store_true")
    parser.add_argument("--hierarchical", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card (an error without one)")
    parser.add_argument("--artifact", action=NotPorted,
                        help=f"serving a StableHLO artifact directory {NOT_PORTED}")
    parser.add_argument("--quantize", action=NotPorted, help=f"int8 serving {NOT_PORTED}")
    parser.add_argument("--calibrate", action=NotPorted, metavar="N",
                        help=f"static int8 calibration {NOT_PORTED}")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from hvt_torch.downstream import serve as serve_lib

    config = config_lib.load(machine=args.machine, exps=args.exp)
    serve_lib.serve(config, host=args.host, port=args.port, topk=args.topk, batch=args.batch,
                    use_ema=not args.raw_weights, hierarchical=args.hierarchical,
                    device=args.device)


if __name__ == "__main__":
    main()
