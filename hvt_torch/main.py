"""Pretraining and evaluation entry point of the port, with the CLI of
hvt's ``main.py``.

    python -m hvt_torch.main --machine configs/machines/local.yaml \\
        --exp configs/pretrain/swinv2_tiny.yaml [more YAMLs] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` (and raises when there is no
card). As hvt's ``main.py``, it evaluates before training, at every
``eval_interval`` and at the end, on the EMA copy where there is one, and
with ``is_train: false`` only evaluates, adding the tree-distance metric;
it prints the last eval metrics (acc@1, acc@5, cross-entropy, tree-dist)
as one JSON line. SwinV2 trains and evaluates on both routes (``fuse:
false`` through the packed window-attention kernel, and its backward in
training; ``fuse: true`` through the fused halves); ResNet trains with
torch's BatchNorm, or with ``model.args.bn_pallas: true`` through the
BatchNorm reduction kernels, and with EMA where the recipe asks for it.
Training reads the synthetic source or an image folder (the native JPEG
core or Pillow, with hvt's augmentations: host or device RandAugment and
ColOut, MixUp, CutMix, progressive resizing), so
configs/pretrain/inat21.yaml runs as written. The algorithms the port's
train step does not run yet (SAM) raise.

What persists, as with hvt's ``main.py``: checkpoints under
``<save_root>/<run_name>/checkpoints/<step>/state.pt`` (at every
``save.interval``, at the end, and on SIGTERM, keeping
``save.num_checkpoints_to_keep``) and the run log
``<save_root>/<run_name>/logs/log0.txt`` (the config, then one JSON record
per evaluation and log window). ``load_path: ckpt://<dir>[:step]`` resumes
from a checkpoint, ``auto_resume: true`` from the run's own latest, and a
PretrainedBackbone loads ``ckpt://``, ``swin://`` or ``torch://`` weights
(see :mod:`hvt_torch.train.loop`). The last checkpoint write is joined
before the JSON line is printed.
"""

from __future__ import annotations

import argparse
import json
from typing import Callable, Optional

from hvt_torch import config as config_lib
from hvt_torch.train.loop import Trainer


def main(config: config_lib.Config, device=None,
         on_step: Optional[Callable[[int, dict], None]] = None) -> dict:
    trainer = Trainer(config, device=device)
    try:
        return trainer.fit(on_step=on_step)
    finally:
        trainer.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(prog="python -m hvt_torch.main",
                                     description=__doc__.splitlines()[0])
    config_lib.add_exp_args(parser)
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card (an error without one)")
    args = parser.parse_args()
    metrics = main(config_lib.load(machine=args.machine, exps=args.exp), device=args.device)
    print(json.dumps(metrics))
