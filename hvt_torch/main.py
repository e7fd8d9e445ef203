"""Pretraining entry point of the port, with the CLI of hvt's ``main.py``.

    python -m hvt_torch.main --machine configs/machines/local.yaml \\
        --exp configs/pretrain/swinv2_tiny.yaml [more YAMLs] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` (and raises when there is no
card). SwinV2 trains on both routes (``fuse: false`` through the packed
window-attention kernel and its backward, ``fuse: true`` through the fused
halves and theirs); ResNet trains with torch's BatchNorm, or with
``model.args.bn_pallas: true`` through the BatchNorm reduction kernels, and
with EMA where the recipe asks for it (configs/pretrain/inat21.yaml). The
algorithms the port's train step does not run yet raise. Unlike hvt's
``main.py`` it neither evaluates nor writes checkpoints (see
:mod:`hvt_torch.train.loop`); it prints the train metrics of the last log
window as one JSON line.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Optional

from hvt_torch import config as config_lib
from hvt_torch.train.loop import Trainer


def main(config: config_lib.Config, device=None,
         on_step: Optional[Callable[[int, dict], None]] = None) -> dict:
    return Trainer(config, device=device).fit(on_step=on_step)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m hvt_torch.main",
                                     description=__doc__.splitlines()[0])
    config_lib.add_exp_args(parser)
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card (an error without one)")
    args = parser.parse_args()
    metrics = main(config_lib.load(machine=args.machine, exps=args.exp), device=args.device)
    print(json.dumps(metrics))
