"""Datasets and the host-side loader — port of ``hvt/data/loader.py``.

* Eval split: the dataset, its transform and the batch size
  (:class:`EvalLoader`), which the serving path reads.
* Train split: :class:`Loader` over the synthetic source, with hvt's batch
  order for one process: a permutation seeded by (seed, epoch) when
  shuffling, the tail dropped under ``drop_last``, a padded last batch with
  a validity mask otherwise. A folder train source
  needs the training transform (RandomResizedCrop, RandAugment, ColOut) and
  raises until it is ported (ROADMAP.md queue 1, item 6).

Batches are built on the calling thread: a synthetic batch is a copy out of
a 64-image pool, and the train step does not wait for the card, so the host
builds the next batch while the card runs the last one.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from hvt_torch.data import folder as folder_lib
from hvt_torch.data import synthetic as synthetic_lib
from hvt_torch.data import transforms as T

_TRAIN_FOLDER = ("a folder train source needs the training transform (TrainTransform, "
                 "RandAugment, ColOut): ROADMAP.md queue 1, item 6; use "
                 "train_dataset.source: synthetic")


@dataclasses.dataclass(frozen=True)
class EvalLoader:
    """The eval split's dataset, its transform and the batch size."""

    dataset: object
    transform: T.EvalTransform
    batch_size: int


@dataclasses.dataclass
class Batch:
    """One host-local batch. images uint8 (B, H, W, 3); mask 1.0 for real rows."""

    images: np.ndarray
    labels: np.ndarray  # (B,) or (B, N_TIERS) int32
    mask: np.ndarray  # (B,) float32


class Loader:
    """Iterable over epochs of host-local batches of a synthetic dataset."""

    def __init__(self, dataset: synthetic_lib.SyntheticDataset, local_batch_size: int, *,
                 shuffle: bool = False, drop_last: bool = False, seed: int = 0):
        if not isinstance(dataset, synthetic_lib.SyntheticDataset):
            raise NotImplementedError(_TRAIN_FOLDER)
        self.dataset = dataset
        self.local_batch_size = local_batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        n = len(dataset)
        if drop_last:
            self.batches_per_epoch = n // local_batch_size
        else:
            self.batches_per_epoch = -(-n // local_batch_size)
        if self.batches_per_epoch == 0:
            raise ValueError(f"dataset ({n} samples) smaller than one batch "
                             f"({local_batch_size}) with drop_last")

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """The dataset indices visited in ``epoch``, in batch order: a pure
        function of (seed, epoch)."""
        n = len(self.dataset)
        order = np.random.default_rng((self.seed, epoch)).permutation(n) if self.shuffle else np.arange(n)
        if self.drop_last:
            order = order[: self.batches_per_epoch * self.local_batch_size]
        return order

    def _make_batch(self, idxs: np.ndarray) -> Batch:
        bs, n_valid = self.local_batch_size, len(idxs)
        first = self.dataset.load(int(idxs[0]))
        images = np.zeros((bs, *first.shape), dtype=np.uint8)
        for row, i in enumerate(idxs):
            images[row] = self.dataset.load(int(i))
        label_arr = self.dataset.labels[idxs]
        labels = np.zeros((bs, *label_arr.shape[1:]), dtype=np.int32)
        labels[:n_valid] = label_arr
        mask = np.zeros((bs,), dtype=np.float32)
        mask[:n_valid] = 1.0
        return Batch(images=images, labels=labels, mask=mask)

    def epoch(self, epoch: int) -> Iterator[Batch]:
        """The epoch's batches."""
        indices = self.epoch_indices(epoch)
        bs = self.local_batch_size
        for start in range(0, len(indices), bs):
            yield self._make_batch(indices[start:start + bs])


def build_dataset(config, is_train: bool = False):
    """Scan/construct the split's dataset → (dataset, DatasetInfo)."""
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
    elif is_train:
        raise NotImplementedError(_TRAIN_FOLDER)
    else:
        path = config.machine.datasets[data_cfg.path]
        dataset = folder_lib.scan_image_folder(path, "val", hierarchical=hierarchical)
    return dataset, folder_lib.DatasetInfo(dataset.num_classes)


def build_loader(config, is_train: bool = False):
    """Config → (Loader, DatasetInfo) for the train split, or
    (EvalLoader, DatasetInfo) for the eval split."""
    dataset, info = build_dataset(config, is_train)
    if not is_train:
        data_cfg = config.eval_dataset
        transform = T.EvalTransform(crop_size=data_cfg.crop_size, resize_size=data_cfg.resize_size)
        return EvalLoader(dataset, transform, data_cfg.global_batch_size), info
    data_cfg = config.train_dataset
    loader = Loader(dataset, data_cfg.global_batch_size,
                    shuffle=data_cfg.shuffle, drop_last=data_cfg.drop_last, seed=config.seed)
    return loader, info
