"""Input-pipeline throughput: images/s of decode + augment per route — port of
``hvt/tools/loader_bench.py``.

    python -m hvt_torch.tools.loader_bench [--root DIR] [--batch-size 64] \\
        [--batches 8] [--threads 1,4,8] [--eval] [--augment none|host|device]

Times the port's ``Loader`` (its producer thread and worker pool) on both
decode routes, the native libjpeg core and Pillow, at each thread count,
for the train transform (RandomResizedCrop + flip, with host RandAugment +
ColOut under ``--augment host``; ``device`` delivers bare crops, the
policy running in the train step) or the eval transform (``--eval``).
Without ``--root`` it writes hvt's fixture first: iNat-shaped 500×375
JPEGs of seeded noise, written by Pillow. Prints one JSON line per
(route, threads). Host-side only: no device is touched.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HOT_PAIR = ({"cls": "RandAugment", "args": {"depth": 1, "severity": 9}},
            {"cls": "ColOut", "args": {"p_row": 0.05, "p_col": 0.05}})


def make_fixture(root, train_images: int = 64, val_images: int = 64, classes: int = 1,
                 size=(500, 375), workers: int = 8) -> dict:
    """An ImageFolder of ``classes`` class directories (taxonomy-shaped names)
    with ``train_images`` and ``val_images`` JPEGs of seeded noise at ``size``
    (w, h), quality 85, image i of a split in class i % classes. Returns the
    root, the seconds the writing took and the mean file size in bytes."""
    from PIL import Image

    from hvt_torch.data.synthetic import synthetic_class_names

    root = pathlib.Path(root)
    names = synthetic_class_names(classes)
    t0 = time.perf_counter()
    jobs = []
    for split, n in (("train", train_images), ("val", val_images)):
        for name in names:
            (root / split / name).mkdir(parents=True, exist_ok=True)
        jobs += [(split, i, root / split / names[i % classes] / f"img{i:05d}.jpg") for i in range(n)]

    def write(job):
        split, i, path = job
        if not path.exists():
            rng = np.random.default_rng((split == "train", i))
            arr = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
            Image.fromarray(arr).save(path, quality=85)
        return path.stat().st_size

    with ThreadPoolExecutor(workers) as pool:
        sizes = list(pool.map(write, jobs))
    return {"root": str(root), "seconds": time.perf_counter() - t0,
            "images": len(sizes), "mean_bytes": float(np.mean(sizes)) if sizes else 0.0}


def bench_pipeline(root: str, batch_size: int, batches: int, threads: int, route: str,
                   is_train: bool, augment: str = "none") -> dict:
    """The Loader's img/s over ``batches`` batches after one warm-up batch,
    on ``route`` ("native" or "pillow")."""
    from hvt_torch import config as config_lib
    from hvt_torch.data import loader as loader_lib
    from hvt_torch.data import native as native_lib

    algorithms = []
    if augment != "none":
        algorithms = [{**a, "args": {**a["args"], "device": augment == "device"}} for a in HOT_PAIR]
    cfg = config_lib.loads({
        "train_dataset": {"path": "bench", "global_batch_size": batch_size, "drop_last": True,
                          "shuffle": False, "crop_size": 224},
        "eval_dataset": {"path": "bench", "global_batch_size": batch_size, "crop_size": 224},
        "machine": {"datasets": {"bench": root}},
        "loader": {"num_workers": threads, "prefetch_batches": 1},
        "algorithms": algorithms,
    })
    ldr, _ = loader_lib.build_loader(cfg, is_train=is_train)
    if route == "native" and not ldr.use_native:
        return {"route": route, "skipped": native_lib.unavailable_reason() or "not eligible"}
    ldr.use_native = route == "native"
    epoch, n = 0, 0
    it = ldr.epoch(epoch)
    next(it)  # warm: the pool and the producer started, first touch
    t0 = time.perf_counter()
    for _ in range(batches):
        batch = next(it, None)
        if batch is None:  # wrap to a fresh epoch (other augmentation seeds)
            epoch += 1
            it = ldr.epoch(epoch)
            batch = next(it)
        n += int(batch.mask.sum())
    dt = time.perf_counter() - t0
    it.close()
    return {"route": route, "mode": "train" if is_train else "eval", "augment": augment,
            "threads": threads, "images": n, "seconds": dt, "images_per_sec": n / dt}


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m hvt_torch.tools.loader_bench",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=None, help="ImageFolder root (default: a fixture)")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--batches", type=int, default=8)
    parser.add_argument("--threads", default="1")
    parser.add_argument("--eval", action="store_true", help="the eval transform")
    parser.add_argument("--augment", default="none", choices=("none", "host", "device"))
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="hvt-loader-bench-") as tmp:
        root = args.root or make_fixture(tmp, args.batch_size * 2, args.batch_size * 2)["root"]
        for threads in [int(t) for t in args.threads.split(",")]:
            for route in ("pillow", "native"):
                print(json.dumps(bench_pipeline(root, args.batch_size, args.batches, threads,
                                                route, not args.eval, args.augment)), flush=True)


if __name__ == "__main__":
    main()
