"""Datasets and the host-side loader — port of ``hvt/data/loader.py``.

:class:`Loader` gives hvt's batch order for one process: a permutation
seeded by (seed, epoch) when shuffling, the tail dropped under
``drop_last``, a padded last batch with a validity mask otherwise, so eval
metrics are exact at one static batch shape.

* Train split: the synthetic source. A folder train source needs the
  training transform (RandomResizedCrop, RandAugment, ColOut) and raises
  until it is ported (ROADMAP.md queue 1, item 6).
* Eval split: the synthetic source or an image folder's ``val/``, never
  shuffled, each image decoded through Pillow with ``EvalTransform`` (hvt's
  native JPEG core is item 6 too). Evaluation and serving read it. An
  eval-only run (``is_train: false``) also gets the tree-distance matrix.

Synthetic batches are built on the calling thread (a copy out of a
64-image pool); folder images are decoded by ``num_workers`` threads, as
Pillow releases the interpreter lock while it decodes. The train and eval
steps do not wait for the card, so the host builds the next batch while the
card runs the last one.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
from PIL import Image

from hvt_torch import hierarchy
from hvt_torch.data import folder as folder_lib
from hvt_torch.data import synthetic as synthetic_lib
from hvt_torch.data import transforms as T

_TRAIN_FOLDER = ("a folder train source needs the training transform (TrainTransform, "
                 "RandAugment, ColOut): ROADMAP.md queue 1, item 6; use "
                 "train_dataset.source: synthetic")


@dataclasses.dataclass
class Batch:
    """One host-local batch. images uint8 (B, H, W, 3); mask 1.0 for real rows."""

    images: np.ndarray
    labels: np.ndarray  # (B,) or (B, N_TIERS) int32
    mask: np.ndarray  # (B,) float32


class Loader:
    """Iterable over epochs of host-local batches of a synthetic dataset, or
    of a folder dataset decoded with ``transform``."""

    def __init__(self, dataset, local_batch_size: int, *,
                 transform: Optional[T.EvalTransform] = None, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0, num_workers: int = 1):
        if not isinstance(dataset, synthetic_lib.SyntheticDataset) and transform is None:
            raise ValueError("a folder dataset needs a transform to decode its images")
        self.dataset = dataset
        self.transform = transform
        self.local_batch_size = local_batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
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

    def _decode(self, index: int) -> np.ndarray:
        with Image.open(self.dataset.paths[index]) as img:
            return self.transform(img)

    def _images(self, idxs: np.ndarray) -> list[np.ndarray]:
        if isinstance(self.dataset, synthetic_lib.SyntheticDataset):
            return [self.dataset.load(int(i)) for i in idxs]
        with ThreadPoolExecutor(self.num_workers) as pool:
            return list(pool.map(self._decode, (int(i) for i in idxs)))

    def _make_batch(self, idxs: np.ndarray) -> Batch:
        bs, n_valid = self.local_batch_size, len(idxs)
        arrays = self._images(idxs)
        images = np.zeros((bs, *arrays[0].shape), dtype=np.uint8)
        for row, arr in enumerate(arrays):
            images[row] = arr
        label_arr = self.dataset.labels[idxs]
        labels = np.zeros((bs, *label_arr.shape[1:]), dtype=np.int32)
        labels[:n_valid] = label_arr
        mask = np.zeros((bs,), dtype=np.float32)
        mask[:n_valid] = 1.0
        return Batch(images=images, labels=labels, mask=mask)

    def epoch(self, epoch: int, start_batch: int = 0) -> Iterator[Batch]:
        """The epoch's batches from batch ``start_batch`` on: the order is a
        pure function of (seed, epoch), so a resume mid-epoch continues at
        the next batch without building the skipped ones."""
        indices = self.epoch_indices(epoch)
        bs = self.local_batch_size
        for start in range(start_batch * bs, len(indices), bs):
            yield self._make_batch(indices[start:start + bs])


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
    if is_train:
        raise NotImplementedError(_TRAIN_FOLDER)
    path = config.machine.datasets[data_cfg.path]
    dataset = folder_lib.scan_image_folder(path, "val", hierarchical=hierarchical)
    tree_dists = None if config.is_train else hierarchy.build_tree_dist_matrix(path)
    return dataset, folder_lib.DatasetInfo(dataset.num_classes, tree_dists)


def build_loader(config, is_train: bool = False):
    """Config → (Loader, DatasetInfo) for the train split (shuffled as the
    config says) or the eval split (never shuffled, decoded with
    ``EvalTransform``)."""
    dataset, info = build_dataset(config, is_train)
    data_cfg = config.train_dataset if is_train else config.eval_dataset
    transform = None if is_train else T.EvalTransform(crop_size=data_cfg.crop_size,
                                                      resize_size=data_cfg.resize_size)
    loader = Loader(dataset, data_cfg.global_batch_size, transform=transform,
                    shuffle=data_cfg.shuffle if is_train else False, drop_last=data_cfg.drop_last,
                    seed=config.seed, num_workers=config.loader.num_workers)
    return loader, info
