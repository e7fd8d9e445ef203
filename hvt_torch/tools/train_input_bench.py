"""Real-input training throughput: does the input path overlap the card? —
port of ``hvt/tools/train_input_bench.py``.

    python -m hvt_torch.tools.train_input_bench --machine configs/machines/local.yaml \\
        --exp configs/pretrain/inat21.yaml [more YAMLs] --root DIR [--steps 20] [--device cpu]

Builds the Trainer of the config with its train source pointed at the
image folder ``--root`` and measures three rates (images/s):

* ``host_only``: the loader alone (decode, augment, collate, pin), no step;
* ``device_only``: the port's train step on one batch already on the
  device, no host work;
* ``combined``: the real loop, the loader's batches copied and stepped,

plus the predictions ``overlap`` = min(host, device) (the producer thread
builds the next batch while the card steps) and ``serial`` =
1/(1/host + 1/device), and ``overlap_efficiency``, where combined falls on
[serial, overlap] (1 = perfect overlap, 0 = serial). Each rate ends in a
device synchronize. The host ms of one call of the step (its launches
queued, the device idle) is taken alone and in the combined loop, where
the loader's threads share the interpreter lock with it. Runs on the CUDA
card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time


def _batches(loader, steps: int):
    """``steps`` batches, wrapping epochs (a fixture may be small)."""
    epoch, got = 0, 0
    while got < steps:
        for batch in loader.epoch(epoch):
            yield batch
            got += 1
            if got >= steps:
                return
        epoch += 1


def measure(trainer, steps: int) -> dict:
    """The three rates of ``trainer``'s train path at full size (its model trains)."""
    import torch

    def sync():
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)

    loader, step, gen = trainer.train_loader, trainer.train_step, trainer.generator
    batch = loader.local_batch_size
    warm = next(_batches(loader, 1))
    resident = trainer._to_device(warm)
    for _ in range(3):  # warm: first launches, the cuDNN plans, the producer's pool
        step(*resident, gen)
    sync()

    n, t0 = 0, time.perf_counter()
    for b in _batches(loader, steps):
        n += int(b.mask.sum())
    host = n / (time.perf_counter() - t0)

    t0 = time.perf_counter()
    for _ in range(steps):
        step(*resident, gen)
    sync()
    device = steps * batch / (time.perf_counter() - t0)

    alone = []
    for _ in range(3):
        sync()
        t1 = time.perf_counter()
        step(*resident, gen)
        alone.append(time.perf_counter() - t1)
    sync()

    n, calls, t0 = 0, [], time.perf_counter()
    for b in _batches(loader, steps):
        args = trainer._to_device(b)
        t1 = time.perf_counter()
        step(*args, gen)
        calls.append(time.perf_counter() - t1)
        n += batch
    sync()
    combined = n / (time.perf_counter() - t0)

    overlap = min(host, device)
    serial = 1.0 / (1.0 / host + 1.0 / device)
    return {"host_only_img_s": host, "device_only_img_s": device, "combined_img_s": combined,
            "predicted_overlap_img_s": overlap, "predicted_serial_img_s": serial,
            "overlap_efficiency": (combined - serial) / max(overlap - serial, 1e-9),
            "step_call_ms_alone": 1e3 * sorted(alone)[1],
            "step_call_ms_in_loop": 1e3 * sorted(calls)[len(calls) // 2],
            "batch": batch, "steps": steps, "workers": loader.num_workers,
            "decoder": loader.decoder, "device": str(trainer.device)}


def main(argv=None):
    from hvt_torch import config as config_lib
    from hvt_torch.train.loop import Trainer

    parser = argparse.ArgumentParser(prog="python -m hvt_torch.tools.train_input_bench",
                                     description=__doc__.splitlines()[0])
    config_lib.add_exp_args(parser)
    parser.add_argument("--root", required=True, help="image folder with train/ and val/")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--device", default=None, help="default the CUDA card")
    args = parser.parse_args(argv)
    base = config_lib.load(machine=args.machine, exps=args.exp)
    config = config_lib.loads(config_lib.to_dict(base), {
        "machine": {"datasets": {"bench": args.root}},
        "train_dataset": {"source": "imagefolder", "path": "bench"},
        "eval_dataset": {"source": "imagefolder", "path": "bench"},
        "save": {"wandb": False}})
    trainer = Trainer(config, device=args.device)
    try:
        print(json.dumps(measure(trainer, args.steps)))
    finally:
        trainer.close()


if __name__ == "__main__":
    main()
