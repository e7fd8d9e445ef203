"""The Trainer — port of ``Trainer.__init__``, ``evaluate`` and the step
and evaluation schedule of ``fit`` in ``hvt/train/loop.py``.

Assembles from a Config the train and eval loaders, the durations and lr
schedule, the model (SwinV2 or ResNet, through the factory), the objective,
the optimizer (with the model's no-decay names and gradient clipping), the
EMA where the algorithms ask for it, the train step and the eval step (with
the tree-distance matrix of an eval-only run), on one device (the CUDA card
unless the caller asks for the CPU).

``fit()`` follows hvt's: it evaluates before training (and returns at once
when ``is_train`` is false), at every ``eval_interval`` in the Composer time
grammar ("Nep" at epoch ends, "Nba" every N steps, "Fdur" as a fraction of
``max_duration``) and at the end unless it just did, on the EMA copy where
there is one; it prints one line per evaluation and per log window and
returns the last eval metrics (the last window's train metrics stay in
``train_metrics``). Unlike hvt's it saves no checkpoint, does not resume
from ``load_path``/``auto_resume`` and has no RunLogger (ROADMAP.md queue 1,
item 8). SAM, MixUp, CutMix, progressive resizing, device RandAugment/ColOut,
a pretrained backbone and ``grad_accum`` > 1 are refused, never ignored.
``grad_accum: auto`` is sized on the card as hvt sizes it
(:mod:`hvt_torch.train.microbatch`: the peak memory of a probe forward and
backward at the full batch against the card's memory) and resolves to 1
where the batch fits, and to 1 on the CPU, as hvt's does without a memory
limit; where the batch would need more microbatches the Trainer raises,
since gradient accumulation is not ported.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from hvt_torch import config as config_lib
from hvt_torch import device as device_lib
from hvt_torch import metrics as metrics_lib
from hvt_torch import objectives as objectives_lib
from hvt_torch.data import DevicePrep
from hvt_torch.data import device as device_prep
from hvt_torch.data.loader import Batch, build_loader
from hvt_torch.models import build_model
from hvt_torch.train import algorithms as algorithms_lib
from hvt_torch.train import ema as ema_lib
from hvt_torch.train import microbatch
from hvt_torch.train import optim as optim_lib
from hvt_torch.train import schedule as schedule_lib
from hvt_torch.train import step as step_lib

LOG_INTERVAL = 50  # steps per log window: one host sync and one printed line each


class Trainer:
    def __init__(self, config: config_lib.Config, device=None):
        self.config = config
        self.algos = algorithms_lib.parse_algorithms(config)
        refused = algorithms_lib.unported(self.algos)
        if refused:
            raise NotImplementedError("not ported to hvt_torch's train step yet: " + "; ".join(refused))
        self.device = device_lib.resolve(device)

        # Data ------------------------------------------------------------
        self.train_loader, self.info = build_loader(config, is_train=True)
        self.eval_loader, eval_info = build_loader(config, is_train=False)
        self.steps_per_epoch = self.train_loader.batches_per_epoch
        self.tree_dists = eval_info.tree_dists

        # Durations / schedule -------------------------------------------
        self.total_steps = schedule_lib.parse_duration(config.max_duration).to_steps(
            self.steps_per_epoch)
        self.total_epochs = max(1, math.ceil(self.total_steps / self.steps_per_epoch))
        self.lr_multiplier = schedule_lib.build_multiplier_schedule(
            config.scheduler, self.steps_per_epoch, self.total_steps)

        # Model / objective / optimizer ----------------------------------
        model = build_model(config, self.info.num_classes)
        if self.device.type == "cuda":
            why = model.cuda_unsupported(config.eval_dataset.crop_size, training=False)
            if config.is_train:
                why += [w for w in model.cuda_unsupported(config.train_dataset.crop_size,
                                                          training=True) if w not in why]
            if why:
                raise NotImplementedError(
                    f"the CUDA kernels cannot run {config.model.name}: " + "; ".join(why))
        self.model = model.to(self.device)
        self.ema = ema_lib.Ema(self.algos.ema, self.model) if self.algos.ema else None
        self.objective = objectives_lib.build_objective(
            config, self.info, getattr(self.train_loader.dataset, "classes", None))
        self.optimizer = optim_lib.build_optimizer(
            self.model, config.optim, self.lr_multiplier,
            grad_clip_norm=self.algos.grad_clip_norm,
            no_decay_substrings=self.model.no_weight_decay_substrings)
        self.prep = DevicePrep.from_config(config.train_dataset, config.precision)
        self.eval_prep = DevicePrep.from_config(config.eval_dataset, config.precision)
        if config.grad_accum == "auto":
            grad_accum = self._auto_grad_accum()
            print(f"[{config.run_name}] grad_accum auto: {grad_accum}", flush=True)
            if grad_accum > 1:
                raise NotImplementedError(
                    f"grad_accum auto: a batch of {config.train_dataset.global_batch_size} needs "
                    f"{grad_accum} microbatches on {self.device}; gradient accumulation is "
                    "ROADMAP.md queue 1, item 5 (train step)")
        else:
            grad_accum = int(config.grad_accum)
        self.grad_accum = grad_accum
        self.settings = step_lib.StepSettings(
            num_classes=self.info.num_classes, smoothing=self.algos.label_smoothing,
            grad_accum=grad_accum)
        self.train_step = step_lib.build_train_step(
            self.model, self.objective, self.optimizer, self.prep, self.settings, self.ema)
        self.eval_step = step_lib.build_eval_step(self.model, self.eval_prep, self.tree_dists)
        # stochastic-depth draws; hvt folds the step into its key instead
        self.generator = torch.Generator(self.device).manual_seed(int(config.seed))
        self.train_metrics: dict[str, float] = {}  # of the last log window

    def _auto_grad_accum(self) -> int:
        """``grad_accum: auto`` as hvt's ``_resolve_auto_grad_accum``: the
        smallest power-of-two split of the batch whose probe step fits the
        device, by :func:`microbatch.choose_grad_accum`. The probe (zero
        images, class-0 labels, its own generator) leaves the model, the
        optimizer, the EMA and the Trainer's generator as it found them."""
        cfg = self.config.train_dataset
        batch, crop = int(cfg.global_batch_size), int(cfg.crop_size)
        limit = microbatch.device_bytes_limit(self.device)
        if limit is None:
            return microbatch.choose_grad_accum(lambda accum: None, batch, None)
        classes = self.info.num_classes
        generator = torch.Generator(self.device).manual_seed(0)

        def loss(model, n):
            images = torch.zeros((n, crop, crop, 3), dtype=torch.uint8, device=self.device)
            tiers = (len(classes),) if isinstance(classes, tuple) else ()
            labels = torch.zeros((n, *tiers), dtype=torch.int32, device=self.device)
            targets = device_prep.prepare_targets(labels, classes, self.algos.label_smoothing)
            out = model(self.prep.normalize(images), generator=generator)
            return self.objective(out, targets, torch.ones(n, device=self.device))

        state = microbatch.optimizer_state_bytes(self.optimizer)
        return microbatch.choose_grad_accum(
            lambda accum: state + microbatch.probe_peak_bytes(self.model, loss, batch // accum,
                                                              self.device),
            batch, limit)

    @property
    def eval_params(self) -> dict[str, torch.Tensor]:
        """The parameters evaluation uses: the EMA copy when there is one."""
        return self.ema.params if self.ema else dict(self.model.named_parameters())

    @property
    def eval_batch_stats(self) -> dict[str, torch.Tensor]:
        """The running statistics evaluation uses: the EMA copy when there is one."""
        return self.ema.batch_stats if self.ema else ema_lib.batch_stats(self.model)

    def _to_device(self, batch: Batch):
        images = torch.from_numpy(batch.images)
        if self.device.type == "cuda":  # pinned, so the copy does not wait for the card
            images = images.pin_memory()
        return (images.to(self.device, non_blocking=True),
                torch.from_numpy(batch.labels).to(self.device),
                torch.from_numpy(batch.mask).to(self.device))

    def evaluate(self) -> dict[str, float]:
        """hvt's metrics (acc@1, acc@5, cross-entropy, and tree-dist in an
        eval-only run) over one pass of the eval loader, on ``eval_params``
        and ``eval_batch_stats``. The batches' sums add up on the device;
        one host sync reads them at the end."""
        params, batch_stats = self.eval_params, self.eval_batch_stats
        sums = None
        for batch in self.eval_loader.epoch(0):
            stats = self.eval_step(params, batch_stats, *self._to_device(batch))
            sums = stats if sums is None else {k: sums[k] + v for k, v in stats.items()}
        acc = metrics_lib.MetricAccumulator()
        if sums is not None:
            acc.update(dict(zip(sums, torch.stack(list(sums.values())).tolist())))
        return acc.compute()

    def _evaluate_at(self, step: int) -> dict[str, float]:
        metrics = self.evaluate()
        print(f"[{self.config.run_name}] eval at step {step}: "
              + " ".join(f"{k} {v:.4g}" for k, v in metrics.items()), flush=True)
        return metrics

    def fit(self, on_step: Optional[Callable[[int, dict], None]] = None) -> dict[str, float]:
        """Evaluate, then (unless ``is_train`` is false) train for
        ``max_duration`` from the model's current weights, evaluating at
        every ``eval_interval`` and at the end, as hvt's ``fit``; returns the
        last eval metrics. ``on_step(step, stats)`` is called after each
        step with its device-side stats, before that step's evaluation."""
        eval_metrics = self._evaluate_at(0)
        if not self.config.is_train:
            return eval_metrics
        eval_every = schedule_lib.parse_duration(self.config.eval_interval)
        eval_every_ep = eval_every_ba = None
        if eval_every.unit == "ep":
            eval_every_ep = max(1, int(eval_every.value))
        else:
            eval_every_ba = max(1, eval_every.to_steps(self.steps_per_epoch, self.total_steps))
        last_eval_step = -1
        acc = metrics_lib.MetricAccumulator()
        window = None
        step = 0
        for epoch in range(self.total_epochs):
            for batch in self.train_loader.epoch(epoch):
                if step >= self.total_steps:
                    break
                stats = self.train_step(*self._to_device(batch), self.generator)
                window = stats if window is None else {k: window[k] + v for k, v in stats.items()}
                step += 1
                if on_step is not None:
                    on_step(step, stats)
                if eval_every_ba is not None and step % eval_every_ba == 0:
                    eval_metrics = self._evaluate_at(step)
                    last_eval_step = step
                if step % LOG_INTERVAL == 0 or step == self.total_steps:
                    acc.reset()
                    acc.update(window)  # the one host sync of the window
                    window = None
                    self.train_metrics = acc.compute()
                    self.train_metrics["lr"] = float(
                        self.config.optim.lr * self.lr_multiplier(step))
                    print(f"[{self.config.run_name}] step {step}/{self.total_steps} "
                          + " ".join(f"{k} {v:.4g}" for k, v in self.train_metrics.items()),
                          flush=True)
            due_ep = eval_every_ep is not None and (epoch + 1) % eval_every_ep == 0
            if (due_ep or step >= self.total_steps) and last_eval_step != step:
                eval_metrics = self._evaluate_at(step)
                last_eval_step = step
            if step >= self.total_steps:
                break
        return eval_metrics
