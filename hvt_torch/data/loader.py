"""Datasets and the prefetching host-side loader — port of ``hvt/data/loader.py``.

:class:`Loader` gives hvt's batches for one process (hvt's
``process_index`` 0 of 1; sharding across processes is ROADMAP.md queue 1,
item 11): a permutation seeded by (seed, epoch) when shuffling, the tail
dropped under ``drop_last``, a padded last batch with a validity mask
otherwise, so eval metrics are exact at one static batch shape.

* Sources: the synthetic dataset, or an image folder's ``train/`` or
  ``val/`` split.
* Folder images: JPEG folders decode through the native core
  (:mod:`hvt_torch.data.native`: decode + RandomResizedCrop + flip, or the
  eval crop, one C call a batch over ``num_workers`` threads), then the
  host RandAugment/ColOut post pass over the worker pool; other folders, or
  a machine without the core, decode each image with Pillow through
  ``TrainTransform``/``EvalTransform``. ``Loader.decoder`` says which.
  Every sample's randomness is a pure function of (seed, epoch, index).
* A producer thread builds the batches ahead of the consumer into a queue
  of ``prefetch_batches``; with ``pin_memory`` it also pins each batch, so
  the copy to the card does not wait on the training thread. A worker's
  exception is raised again in the consumer, an early exit stops and joins
  the producer, and nothing is touched at interpreter shutdown.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
from PIL import Image

from hvt_torch import hierarchy
from hvt_torch.data import folder as folder_lib
from hvt_torch.data import native as native_lib
from hvt_torch.data import synthetic as synthetic_lib
from hvt_torch.data import transforms as T


def _native_eligible(dataset, transform) -> bool:
    """The C++ core covers decode + RandomResizedCrop + resize + flip over
    JPEG folders; RandAugment/ColOut run after it over the small crops
    (``TrainTransform.post_augment``)."""
    if not isinstance(dataset, folder_lib.FolderDataset):
        return False
    if not isinstance(transform, (T.EvalTransform, T.TrainTransform)):
        return False
    if not all(p.lower().endswith((".jpg", ".jpeg")) for p in dataset.paths[:8]):
        return False
    return native_lib.available()


@dataclasses.dataclass
class Batch:
    """One host-local batch. images uint8 (B, H, W, 3); mask 1.0 for real rows."""

    images: np.ndarray
    labels: np.ndarray  # (B,) or (B, N_TIERS) int32
    mask: np.ndarray  # (B,) float32
    indices: Optional[np.ndarray] = None  # dataset index of each row, -1 for padding


def _decode_folder_sample(dataset, index: int, transform, rng) -> np.ndarray:
    with Image.open(dataset.paths[index]) as img:
        return transform(img, rng)


def _host_buffer(shape, dtype, pin: bool) -> np.ndarray:
    """An uninitialized numpy array, in page-locked memory when ``pin``
    (torch's caching host allocator: the array keeps its tensor, and so
    the block, alive)."""
    if not pin:
        return np.empty(shape, dtype=dtype)
    import torch

    return torch.empty(shape, dtype=getattr(torch, np.dtype(dtype).name), pin_memory=True).numpy()


def host_tensor(arr: np.ndarray):
    """The torch tensor under a buffer of :func:`_host_buffer` (pinned: the
    caching host allocator then tracks an asynchronous copy out of it),
    else a tensor sharing ``arr``'s memory."""
    import torch

    base = arr.base
    if isinstance(base, torch.Tensor) and tuple(base.shape) == arr.shape:
        return base
    return torch.from_numpy(arr)


class Loader:
    """Iterable over epochs of host-local batches; :meth:`epoch` gives a
    deterministic, shuffled (if asked) iterator fed by a producer thread."""

    def __init__(self, dataset, transform, local_batch_size: int, *, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 8,
                 prefetch_batches: int = 2, pin_memory: bool = False):
        if not isinstance(dataset, synthetic_lib.SyntheticDataset) and transform is None:
            raise ValueError("a folder dataset needs a transform to decode its images")
        self.dataset = dataset
        self.transform = transform
        self.local_batch_size = local_batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.pin_memory = pin_memory
        self.use_native = _native_eligible(dataset, transform)

        n = len(dataset)
        if drop_last:
            self.batches_per_epoch = n // local_batch_size
        else:
            self.batches_per_epoch = -(-n // local_batch_size)
        if self.batches_per_epoch == 0:
            raise ValueError(f"dataset ({n} samples) smaller than one batch "
                             f"({local_batch_size}) with drop_last")

    @property
    def decoder(self) -> str:
        """How images are made: ``synthetic``, ``native`` (the libjpeg core)
        or ``pillow`` (with the reason where the core was passed over)."""
        if isinstance(self.dataset, synthetic_lib.SyntheticDataset):
            return "synthetic"
        if self.use_native:
            return "native"
        why = native_lib.unavailable_reason()
        return f"pillow ({why})" if why else "pillow"

    # -- sample order -------------------------------------------------------

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """The dataset indices visited in ``epoch``, in batch order: a pure
        function of (seed, epoch)."""
        n = len(self.dataset)
        order = np.random.default_rng((self.seed, epoch)).permutation(n) if self.shuffle else np.arange(n)
        if self.drop_last:
            order = order[: self.batches_per_epoch * self.local_batch_size]
        return order

    # -- decode -------------------------------------------------------------

    def _load_one(self, epoch: int, index: int) -> np.ndarray:
        if isinstance(self.dataset, synthetic_lib.SyntheticDataset):
            return self.dataset.load(index)
        rng = np.random.default_rng((self.seed, epoch, int(index)))
        return _decode_folder_sample(self.dataset, index, self.transform, rng)

    def _native_batch_images(self, pool: ThreadPoolExecutor, epoch: int,
                             idxs: np.ndarray) -> np.ndarray:
        tf = self.transform
        is_train = isinstance(tf, T.TrainTransform)
        paths = [self.dataset.paths[int(i)] for i in idxs]
        # per-sample seed from (seed, epoch, index); splitmix64 diffuses it in C
        seeds = [((self.seed & 0xFFFFF) << 44) ^ ((epoch & 0xFFFFF) << 24) ^ int(i) for i in idxs]
        images, failures = native_lib.load_batch(
            paths, seeds, is_train=is_train, resize_size=tf.resize_size, out_size=tf.crop_size,
            num_threads=self.num_workers)
        failed_rows = set()
        if failures:  # corrupt files: Pillow decodes the zero-filled slots, post ops included
            for row, i in enumerate(idxs):
                if not images[row].any():
                    failed_rows.add(row)
                    rng = np.random.default_rng((self.seed, epoch, int(i)))
                    images[row] = _decode_folder_sample(self.dataset, int(i), tf, rng)
        if is_train and tf.has_post_ops:
            # RandAugment / ColOut over the crops, on streams disjoint from the
            # Pillow route's (seed, epoch, index)
            def post(row_i):
                row, i = row_i
                rng = np.random.default_rng((self.seed, epoch, int(i), 0xA6))
                return row, tf.post_augment(images[row], rng)

            todo = [(row, i) for row, i in enumerate(idxs) if row not in failed_rows]
            results = pool.map(post, todo) if self.num_workers > 1 else map(post, todo)
            for row, arr in results:
                images[row] = arr
        return images

    def _make_batch(self, pool: ThreadPoolExecutor, epoch: int, idxs: np.ndarray) -> Batch:
        bs, n_valid = self.local_batch_size, len(idxs)
        if self.use_native:
            arrays = self._native_batch_images(pool, epoch, idxs)
        elif isinstance(self.dataset, synthetic_lib.SyntheticDataset):
            # copies out of the pool: the worker threads would only contend
            # for the interpreter lock with the training thread
            arrays = [self.dataset.load(int(i)) for i in idxs]
        else:
            arrays = list(pool.map(lambda i: self._load_one(epoch, int(i)), idxs))
        pin = self.pin_memory
        images = _host_buffer((bs, *arrays[0].shape), np.uint8, pin)
        for row, arr in enumerate(arrays):
            images[row] = arr
        images[n_valid:] = 0
        label_arr = self.dataset.labels[idxs]
        labels = _host_buffer((bs, *label_arr.shape[1:]), np.int32, pin)
        labels[:n_valid] = label_arr
        labels[n_valid:] = 0
        mask = _host_buffer((bs,), np.float32, pin)
        mask[:n_valid] = 1.0
        mask[n_valid:] = 0.0
        row_idx = np.full((bs,), -1, dtype=np.int64)
        row_idx[:n_valid] = idxs
        return Batch(images=images, labels=labels, mask=mask, indices=row_idx)

    # -- iteration ----------------------------------------------------------

    def epoch(self, epoch: int, start_batch: int = 0) -> Iterator[Batch]:
        """The epoch's batches from batch ``start_batch`` on: the order is a
        pure function of (seed, epoch), so a resume mid-epoch continues at
        the next batch without decoding the skipped ones."""
        indices = self.epoch_indices(epoch)
        bs = self.local_batch_size
        chunks = [indices[i:i + bs] for i in range(start_batch * bs, len(indices), bs)]

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        sentinel = object()
        stop = threading.Event()
        error: list[BaseException] = []
        # Bound now: a generator abandoned until interpreter shutdown may be
        # finalized after the modules' globals are gone; the finally below
        # then touches nothing (the producer is a daemon thread).
        queue_empty = queue.Empty
        finalizing = sys.is_finalizing

        def put(item) -> bool:
            """Bounded put that gives up when the consumer went away."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for chunk in chunks:
                        if stop.is_set() or not put(self._make_batch(pool, epoch, chunk)):
                            return
            except BaseException as e:  # raised again in the consumer, not lost
                error.append(e)
            finally:
                put(sentinel)

        thread = threading.Thread(target=producer, daemon=True, name=f"hvt-loader-epoch{epoch}")
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is sentinel:
                    if error:
                        raise RuntimeError(f"data loader worker failed on epoch {epoch}") from error[0]
                    break
                yield item
            thread.join()
        finally:
            # early exit (the end of training mid-epoch, a consumer error):
            # unblock and retire the producer rather than leak it
            stop.set()
            if not finalizing():
                while True:
                    try:
                        out_q.get_nowait()
                    except queue_empty:
                        break
                thread.join(timeout=30)


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def build_dataset(config, is_train: bool = False):
    """Scan/construct the split's dataset → (dataset, DatasetInfo). The
    tree-distance matrix is built for eval-only runs (``config.is_train``
    false): over the synthetic class names, or over the folder's train∪val
    classes (cached in the folder)."""
    data_cfg = config.train_dataset if is_train else config.eval_dataset
    hierarchical = config.hierarchy.variant == "multitask"
    if data_cfg.source == "synthetic":
        dataset = synthetic_lib.build_synthetic(
            num_samples=data_cfg.synthetic_num_samples,
            num_leaf_classes=data_cfg.synthetic_num_classes,
            crop_size=data_cfg.crop_size,
            hierarchical=hierarchical,
            seed=config.seed,
        )
        tree_dists = None
        if not config.is_train:
            tree_dists = hierarchy.tree_dist_matrix(
                [hierarchy.HierarchicalLabel.parse(name) for name in dataset.classes])
        return dataset, folder_lib.DatasetInfo(dataset.num_classes, tree_dists)
    path = config.machine.datasets[data_cfg.path]
    dataset = folder_lib.scan_image_folder(path, "train" if is_train else "val",
                                           hierarchical=hierarchical)
    tree_dists = None if config.is_train else hierarchy.build_tree_dist_matrix(path)
    return dataset, folder_lib.DatasetInfo(dataset.num_classes, tree_dists)


def build_transform(config, is_train: bool):
    """``TrainTransform`` with host RandAugment/ColOut where an algorithm
    asks for them without ``device: true`` (with it, the train step runs
    them on the batch instead), or ``EvalTransform``."""
    data_cfg = config.train_dataset if is_train else config.eval_dataset
    if not is_train:
        return T.EvalTransform(crop_size=data_cfg.crop_size, resize_size=data_cfg.resize_size)
    ra_depth, ra_sev, colout_p = 0, 9, None
    for algo in config.algorithms:
        if algo.cls == "RandAugment" and not algo.args.get("device", False):
            ra_depth = int(algo.args.get("depth", 1))
            ra_sev = int(algo.args.get("severity", 9))
        elif algo.cls == "ColOut" and not algo.args.get("device", False):
            colout_p = (float(algo.args.get("p_row", 0.05)), float(algo.args.get("p_col", 0.05)))
    return T.TrainTransform(crop_size=data_cfg.crop_size, resize_size=data_cfg.resize_size,
                            randaugment_depth=ra_depth, randaugment_severity=ra_sev,
                            colout_p=colout_p)


def build_loader(config, is_train: bool = False, pin_memory: bool = False):
    """Config → (Loader, DatasetInfo) for the train split (shuffled as the
    config says) or the eval split (never shuffled); ``pin_memory`` for a
    consumer that copies the batches to the card."""
    dataset, info = build_dataset(config, is_train)
    data_cfg = config.train_dataset if is_train else config.eval_dataset
    loader = Loader(dataset, build_transform(config, is_train), data_cfg.global_batch_size,
                    shuffle=data_cfg.shuffle if is_train else False, drop_last=data_cfg.drop_last,
                    seed=config.seed, num_workers=config.loader.num_workers,
                    prefetch_batches=config.loader.prefetch_batches, pin_memory=pin_memory)
    return loader, info
