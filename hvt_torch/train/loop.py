"""The Trainer — port of ``hvt/train/loop.py``.

Assembles from a Config the train and eval loaders (prefetching on a
producer thread, which pins each batch for the card; the first log line
names each loader's decoder: synthetic, the native libjpeg core or Pillow),
the durations and lr
schedule, the model (SwinV2 or ResNet, through the factory), the objective,
the optimizer (with the model's no-decay names and gradient clipping), the
EMA where the algorithms ask for it, the train step and the eval step (with
the tree-distance matrix of an eval-only run), on one device (the CUDA card
unless the caller asks for the CPU). Then, as hvt's: a PretrainedBackbone is
merged into the model (its BatchNorm statistics with it); the
:class:`~hvt_torch.train.checkpoint.Checkpointer` opens
``<save_root>/<run_name>/checkpoints``; ``load_path`` (a ``ckpt://`` URI or
path), or else with ``auto_resume`` the run's own latest checkpoint, is
restored; the RunLogger writes ``<save_root>/<run_name>/logs/log{rank}.txt``.

Data parallelism (hvt's Trainer over its mesh's ``data`` axis,
``hvt/train/loop.py:52-153, 271``): in a process group (``torchrun``, see
:mod:`hvt_torch.main`) the Trainer reads its rank and world, checks
``config.mesh`` against the world before anything is built (only ``data``
is ported: -1 or the world), declares the group to the model code
(:mod:`hvt_torch.parallel`), and builds the loaders for its rank: the train
loader in hvt's microbatch layout, the eval loader ``order[rank::world]``
padded to the same batches on every rank. After any restore it broadcasts
rank 0's parameters, running statistics and EMA copies and checks that every
rank holds the same update count and generator state. The step sums the
ranks' gradients (:mod:`hvt_torch.train.step`); the eval sums are summed
over the ranks before the metrics are formed; ``grad_accum: auto`` is
probed on the local batch, each rank alone, and the ranks take the largest;
rank 0 alone prints and saves (between barriers); the speed monitor counts
the global batch; a SIGTERM on any rank stops every rank at the same step.
Without a group it is one process, as before.

Tensor parallelism and ZeRO-1 (hvt's ``mesh.model`` and ``mesh.zero``,
``hvt/train/loop.py:198-216``, ``:351-370``): the Trainer declares the grid
of data × model ranks (:func:`hvt_torch.parallel.set_data_group`), builds
the loaders for its data index (model peers load the same rows), cuts the
built model's MLP and expert weights to its shard (``parallel.shard_model_``;
``moe_experts`` must divide by ``model``, as hvt checks) before
the optimizer and the EMA copy are made, so both hold shards, and gives the
optimizer ``zero`` where data > 1. Every rank joins the gathers of a save
(the checkpoint holds full tensors, the same files as a data-parallel run's)
and a restore slices them for the current grid. ``grad_accum: auto`` probes
each rank's own share, its state bytes the rank's; the ranks take the
largest. Evaluation runs on the shards.

A restore sets the model's parameters and running statistics, the optimizer
state with its update count (hvt's ``state.step``), the EMA copies in place
and the state of the generator that draws drop-path masks. hvt folds the
step into one base key, so its resume redraws nothing; the port draws from
one advancing ``torch.Generator``, whose state is therefore saved too. With
the batch order a pure function of (seed, epoch), a resume mid-epoch
continues at the next batch and reproduces the uninterrupted run bit for
bit on the CPU.

``fit()`` follows hvt's: it evaluates before training (and returns at once
when ``is_train`` is false), at every ``eval_interval`` in the Composer time
grammar ("Nep" at epoch ends, "Nba" every N steps, "Fdur" as a fraction of
``max_duration``) and at the end unless it just did, on the EMA copy where
there is one; it saves at every ``save.interval`` (same grammar) and always
at the end; a SIGTERM finishes the step in flight, saves and returns. Its
records go through the RunLogger with hvt's prefixes (``eval``, ``train``
every ``log_interval`` steps with the lr, the step's progressive-resize
scale, samples/sec and memory, ``train-epoch``); it returns the last eval
metrics, and ``train_metrics`` keeps the last train record's metrics with
its lr. MixUp, CutMix, progressive resizing (``_scale_for_step``: hvt's
bucketed schedule over the fraction of training) and host or device
RandAugment/ColOut run, their draws from the one saved generator, so a
resume stays exact with them on; so do SAM and gradient accumulation
(:mod:`hvt_torch.train.step`). ``grad_accum: auto`` is sized on the card as
hvt sizes it, with hvt's doubling (:mod:`hvt_torch.train.microbatch`: the
peak memory of the step's gradient pass at the full batch, split into the
candidate's microbatches and with SAM's second pass where the algorithms
ask for SAM, against the card's memory), and resolves to 1 on the CPU, as
hvt's does without a memory limit.
"""

from __future__ import annotations

import math
import os
import signal
import threading
import zlib
from typing import Callable, Optional

import torch
import torch.distributed as dist

from hvt_torch import config as config_lib
from hvt_torch import device as device_lib
from hvt_torch import metrics as metrics_lib
from hvt_torch import objectives as objectives_lib
from hvt_torch import parallel
from hvt_torch.data import DevicePrep
from hvt_torch.data import device as device_prep
from hvt_torch.data.loader import Batch, build_loader, host_tensor
from hvt_torch.models import build_model
from hvt_torch.train import algorithms as algorithms_lib
from hvt_torch.train import checkpoint as checkpoint_lib
from hvt_torch.train import ema as ema_lib
from hvt_torch.train import microbatch
from hvt_torch.train import optim as optim_lib
from hvt_torch.train import schedule as schedule_lib
from hvt_torch.train import step as step_lib
from hvt_torch.utils.logging import RunLogger, SpeedMonitor, memory_stats


class Trainer:
    def __init__(self, config: config_lib.Config, device=None, log_interval: int = 50):
        self.config = config
        self.log_interval = log_interval  # steps between train records: one host sync each
        # the process group, if this process is in one, and hvt's mesh against it,
        # before any weight moves
        self.rank, self.world = parallel.process_world()
        model_axis = int(getattr(config.mesh, "model", 1))
        experts = int(dict(config.model.args).get("moe_experts", 0) or 0)
        if experts and model_axis > 1 and experts % model_axis:
            raise ValueError(  # hvt/train/loop.py:155-166
                f"model.args.moe_experts={experts} must be divisible by the mesh's model-axis "
                f"size {model_axis} (expert weights shard their expert dim over that axis)")
        self.data_size = parallel.check_mesh(config.mesh, self.world)
        self.model_size = self.world // self.data_size
        self.zero = bool(getattr(config.mesh, "zero", False)) and self.data_size > 1
        self.data_rank = self.rank // self.model_size
        self.algos = algorithms_lib.parse_algorithms(config)
        self.device = device_lib.resolve(device)
        self._declared = dist.is_available() and dist.is_initialized()
        if self._declared:
            parallel.set_data_group(dist.group.WORLD, self.device if self.device.type == "cuda"
                                    else None, model=self.model_size)

        # Data ------------------------------------------------------------
        pin = self.device.type == "cuda"  # the producer pins; _to_device only copies
        self.train_loader, self.info = build_loader(config, is_train=True, pin_memory=pin,
                                                    process_index=self.data_rank,
                                                    process_count=self.data_size)
        self.eval_loader, eval_info = build_loader(config, is_train=False, pin_memory=pin,
                                                   process_index=self.data_rank,
                                                   process_count=self.data_size)
        self.steps_per_epoch = self.train_loader.batches_per_epoch
        self.tree_dists = eval_info.tree_dists
        self._say(f"train loader: {len(self.train_loader.dataset)} images, "
                  f"decoder {self.train_loader.decoder}; eval loader: "
                  f"{len(self.eval_loader.dataset)} images, decoder {self.eval_loader.decoder}")
        if self._declared:
            self._say(f"data parallel: rank {self.rank} of world {self.world} "
                      f"({dist.get_backend()}), local batch {self.train_loader.local_batch_size} "
                      f"of {config.train_dataset.global_batch_size}")
            if self.model_size > 1 or self.zero:
                self._say(f"grid: data {self.data_size} x model {self.model_size}, "
                          f"zero {'on' if self.zero else 'off'}")

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
                for size in self._train_sizes():
                    why += [w for w in model.cuda_unsupported(size, training=True) if w not in why]
            if why:
                raise NotImplementedError(
                    f"the CUDA kernels cannot run {config.model.name}: " + "; ".join(why))
        parallel.shard_model_(model)  # the rank's MLP shards, before any copy is made
        self.model = model.to(self.device)
        self.ema = ema_lib.Ema(self.algos.ema, self.model) if self.algos.ema else None
        self.objective = objectives_lib.build_objective(
            config, self.info, getattr(self.train_loader.dataset, "classes", None))
        self.optimizer = optim_lib.build_optimizer(
            self.model, config.optim, self.lr_multiplier,
            grad_clip_norm=self.algos.grad_clip_norm,
            no_decay_substrings=self.model.no_weight_decay_substrings, zero=self.zero)
        self.prep = DevicePrep.from_config(config.train_dataset, config.precision)
        self.eval_prep = DevicePrep.from_config(config.eval_dataset, config.precision)
        if config.grad_accum == "auto":
            grad_accum = self._auto_grad_accum()
            self._say(f"grad_accum auto: {grad_accum}")
        else:
            grad_accum = int(config.grad_accum)
        self.grad_accum = grad_accum
        # each rank's batch: its share of every microbatch of the global batch
        parallel.microbatch_rows(int(config.train_dataset.global_batch_size), grad_accum,
                                 self.data_size, self.data_rank)
        self.train_loader.microbatches = grad_accum
        self.settings = self._settings(grad_accum)
        self.train_step = step_lib.build_train_step(
            self.model, self.objective, self.optimizer, self.prep, self.settings, self.ema)
        self.eval_step = step_lib.build_eval_step(self.model, self.eval_prep, self.tree_dists)
        # augmentation and stochastic-depth draws; hvt folds the step into its key instead
        self.generator = torch.Generator(self.device).manual_seed(int(config.seed))
        self.train_metrics: dict[str, float] = {}  # of the last train record, with its lr

        # Pretrained backbone: into the model only; the EMA copy keeps the
        # init, as hvt's state does. Merged on full tensors, then sliced.
        if self.algos.pretrained_backbone is not None:
            uri, strict = self.algos.pretrained_backbone
            live = dict(self.model.named_parameters())
            live_stats = ema_lib.batch_stats(self.model)
            params, stats = checkpoint_lib.load_pretrained(uri, parallel.full_tensors(live),
                                                           live_stats, strict=strict)
            checkpoint_lib.copy_into(live, parallel.local_shards(params), uri)
            checkpoint_lib.copy_into(live_stats, stats, uri)

        # Checkpointing / logging -----------------------------------------
        save_folder = os.path.join(config.machine.save_root, config.run_name)
        self.checkpointer = checkpoint_lib.Checkpointer(
            os.path.join(save_folder, "checkpoints"),
            max_to_keep=config.save.num_checkpoints_to_keep)
        if config.load_path:
            self.restore(checkpoint_lib.load_raw(config.load_path))
        elif config.auto_resume and (step := self.checkpointer.latest_step()) is not None:
            self.restore(self.checkpointer.restore(step))
            self._say(f"auto-resumed from step {step}")
        self._sync_ranks()
        self.logger = RunLogger(save_folder, config.run_name, rank=self.rank,
                                use_wandb=config.save.wandb, wandb_entity=config.wandb.entity,
                                wandb_project=config.wandb.project, tags=list(config.tags),
                                world=self.world)
        self.logger.log_config(config_lib.to_yaml(config))
        self.speed = SpeedMonitor(window_size=50, num_chips=self.world)
        self._preempted = False

    def _say(self, line: str) -> None:
        """A line of the run on stdout, from rank 0."""
        if self.rank == 0:
            print(f"[{self.config.run_name}] {line}", flush=True)

    def _sync_ranks(self) -> None:
        """Data index 0's parameters, running statistics and EMA copies on
        every rank of its data group (after any restore), then a check that
        every rank holds the same update count and generator state."""
        if not self._declared:
            return
        tensors = [*self.model.parameters(), *self.model.buffers()]
        if self.ema is not None:
            tensors += [*self.ema.params.values(), *self.ema.batch_stats.values()]
        parallel.broadcast_tensors_(tensors)
        rng = self.generator.get_state()
        digest = int(zlib.crc32(rng.cpu().numpy().tobytes()))
        parallel.check_same([self.step, digest], "the update count and the generator's state")

    def _settings(self, grad_accum: int) -> step_lib.StepSettings:
        a = self.algos
        return step_lib.StepSettings(
            num_classes=self.info.num_classes, smoothing=a.label_smoothing,
            mixup_alpha=a.mixup_alpha, cutmix_alpha=a.cutmix_alpha, grad_accum=grad_accum,
            sam_rho=a.sam_rho, sam_interval=a.sam_interval, randaugment=a.randaugment_device,
            colout=a.colout_device)

    def _auto_grad_accum(self) -> int:
        """``grad_accum: auto`` as hvt's ``_resolve_auto_grad_accum``: the
        smallest power-of-two split of the batch whose step fits the device,
        by :func:`microbatch.choose_grad_accum`. Each candidate runs the
        step's gradient pass on the full batch (zero images, class-0 labels,
        its own generator), with SAM's second pass where SAM is on, as hvt
        sizes the step with SAM's branch in it; the probe leaves the model,
        the optimizer, the EMA and the Trainer's generator as it found them."""
        cfg = self.config.train_dataset
        batch, crop = self.train_loader.local_batch_size, int(cfg.crop_size)
        limit = microbatch.device_bytes_limit(self.device)
        if limit is None:
            return microbatch.choose_grad_accum(lambda accum: None, batch, None)
        classes = self.info.num_classes
        tiers = (len(classes),) if isinstance(classes, tuple) else ()
        images = torch.zeros((batch, crop, crop, 3), dtype=torch.uint8, device=self.device)
        labels = torch.zeros((batch, *tiers), dtype=torch.int32, device=self.device)
        mask = torch.ones(batch, device=self.device)
        sam = bool(self.algos.sam_rho)

        def measure(accum: int) -> float:
            gradients = step_lib.build_gradients(self.model, self.objective, self.prep,
                                                 self._settings(accum))
            generator = torch.Generator(self.device).manual_seed(0)
            return microbatch.probe_peak_bytes(
                self.model, lambda: gradients(images, labels, mask, generator, sam=sam),
                self.device)

        state = microbatch.optimizer_state_bytes(self.optimizer)
        with parallel.no_data_group():  # each rank alone: a rank that runs out skips collectives
            accum = microbatch.choose_grad_accum(lambda accum: state + measure(accum), batch, limit)
        return parallel.host_max([accum])[0]

    def _scale_for_step(self, step: int) -> float:
        """The progressive-resize scale of step ``step`` (1.0 without it)."""
        if self.algos.progressive is None:
            return 1.0
        return self.algos.progressive.scale_at(step / max(self.total_steps, 1))

    def _train_sizes(self) -> list[int]:
        """The image sizes training meets: each progressive bucket's, and the crop."""
        crop = int(self.config.train_dataset.crop_size)
        prog = self.algos.progressive
        if prog is None:
            return [crop]
        scales = {prog.scale_at(t / 1000) for t in range(1001)}
        return sorted({crop if s >= 1.0 else device_prep.resized_size(crop, s) for s in scales})

    @property
    def step(self) -> int:
        """Updates taken: the optimizer's count, hvt's ``state.step``."""
        return self.optimizer.count

    def state_dict(self) -> dict:
        """The checkpoint's fields (hvt's TrainState names; see
        :mod:`hvt_torch.train.checkpoint`): live tensors, and under a grid
        the full ones gathered from the shards and slices (every rank of the
        grid must call it)."""
        ema = self.ema.state_dict() if self.ema else {}
        ema_params = ema.get("params")
        return {"step": self.step,
                "params": parallel.full_tensors(dict(self.model.named_parameters())),
                "batch_stats": ema_lib.batch_stats(self.model),
                "opt_state": self.optimizer.state_dict(),
                "ema_params": None if ema_params is None else parallel.full_tensors(ema_params),
                "ema_batch_stats": ema.get("batch_stats"),
                "ema_updates": ema.get("updates"), "rng": self.generator.get_state(),
                "config": config_lib.to_yaml(self.config)}

    def restore(self, state: dict) -> None:
        """Set the model, the optimizer (its count included), the EMA (in
        place) and the generator from a saved :meth:`state_dict`, each full
        tensor sliced to this rank's shard."""
        checkpoint_lib.copy_into(dict(self.model.named_parameters()),
                                 parallel.local_shards(state["params"]), "params")
        checkpoint_lib.copy_into(ema_lib.batch_stats(self.model), state["batch_stats"],
                                 "batch_stats")
        self.optimizer.load_state_dict(state["opt_state"])
        if (self.ema is None) != (state["ema_params"] is None):
            raise ValueError(f"the checkpoint {'has' if self.ema is None else 'lacks'} an EMA "
                             f"copy and this run {'has none' if self.ema is None else 'has one'}")
        if self.ema is not None:
            self.ema.load_state_dict({"params": parallel.local_shards(state["ema_params"]),
                                      "batch_stats": state["ema_batch_stats"],
                                      "updates": state["ema_updates"]})
        self.generator.set_state(state["rng"])
        if self.step != state["step"]:
            raise ValueError(f"checkpoint step {state['step']} but optimizer count {self.step}")

    def save_checkpoint(self, step: int) -> None:
        """Save (hvt's ``_save_checkpoint``): the host copy now, the write in
        the background; with a wandb run, the step is uploaded as an artifact
        with the ``latest``/``ep{N}-ba{M}`` aliases (reference
        monkey_patch.py:33-91). In a data group every rank joins the gathers
        of the state and rank 0 alone saves, between two barriers."""
        parallel.barrier()
        state = self.state_dict()
        if self.rank == 0:
            self.checkpointer.save(step, state)
        del state
        parallel.barrier()
        if self.rank != 0:
            return
        if self.config.save.wandb and self.logger.uploads:
            self.checkpointer.wait()  # the upload reads the files
            epoch = step // self.steps_per_epoch
            self.logger.log_artifact(self.checkpointer.directory / str(step),
                                     name=f"{self.config.run_name}-checkpoints",
                                     aliases=["latest", f"ep{epoch}-ba{step}"],
                                     metadata={"step": step, "epoch": epoch})

    @property
    def eval_params(self) -> dict[str, torch.Tensor]:
        """The parameters evaluation uses: the EMA copy when there is one."""
        return self.ema.params if self.ema else dict(self.model.named_parameters())

    @property
    def eval_batch_stats(self) -> dict[str, torch.Tensor]:
        """The running statistics evaluation uses: the EMA copy when there is one."""
        return self.ema.batch_stats if self.ema else ema_lib.batch_stats(self.model)

    def _to_device(self, batch: Batch):
        """The batch's copies to the device, queued behind the card's work: the
        loader's producer pinned them (on the card)."""
        return tuple(host_tensor(a).to(self.device, non_blocking=True)
                     for a in (batch.images, batch.labels, batch.mask))

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
        if sums is not None:  # every rank has as many batches: the sums of all of them
            acc.update(dict(zip(sums, parallel.all_reduce_(torch.stack(list(sums.values())))
                                .tolist())))
        return acc.compute()

    def _evaluate_at(self, step: int) -> dict[str, float]:
        metrics = self.evaluate()
        self.logger.log(step, metrics, prefix="eval")
        return metrics

    def request_preempt(self) -> None:
        """Ask the loop to checkpoint and return at the next step boundary;
        the SIGTERM handler that ``fit`` installs calls it."""
        self._preempted = True

    def fit(self, on_step: Optional[Callable[[int, dict], None]] = None) -> dict[str, float]:
        """Evaluate, then (unless ``is_train`` is false) train from the
        current step to ``max_duration``, evaluating and saving on hvt's
        schedule, and save at the end; returns the last eval metrics.
        ``on_step(step, stats)`` is called after each step with its
        device-side stats, before that step's evaluation.

        On SIGTERM (preemptible machines and SLURM send it ahead of the
        kill) the step in flight finishes, a checkpoint is saved and ``fit``
        returns; a resubmission with ``auto_resume`` continues from it. The
        handler only sets a flag; it is installed on the main thread only
        and the previous one is put back in ``finally`` (``SIG_DFL`` where
        that was a C-level handler)."""
        eval_metrics = self._evaluate_at(self.step)
        if not self.config.is_train:
            return eval_metrics
        self._preempted = False
        installed = threading.current_thread() is threading.main_thread()
        previous = None
        if installed:
            previous = signal.signal(signal.SIGTERM, lambda _sig, _frame: self.request_preempt())
        try:
            return self._fit_loop(eval_metrics, on_step)
        finally:
            if installed:
                signal.signal(signal.SIGTERM, previous if previous is not None else signal.SIG_DFL)

    def _every(self, interval: Optional[str]) -> tuple[Optional[int], Optional[int]]:
        """(every N epochs, every N steps) of a Composer duration; one is None."""
        if not interval:
            return None, None
        dur = schedule_lib.parse_duration(interval)
        if dur.unit == "ep":
            return max(1, int(dur.value)), None
        return None, max(1, dur.to_steps(self.steps_per_epoch, self.total_steps))

    def _fit_loop(self, eval_metrics, on_step) -> dict[str, float]:
        eval_every_ep, eval_every_ba = self._every(self.config.eval_interval)
        save_every_ep, save_every_ba = self._every(self.config.save.interval)
        step = self.step
        start_epoch = step // self.steps_per_epoch
        resume_offset = step % self.steps_per_epoch  # the interrupted epoch's next batch
        last_eval_step = -1
        acc = metrics_lib.MetricAccumulator()
        sums = None  # the steps' stats, added on the device until a record needs them

        def drain():
            nonlocal sums
            if sums is not None:
                acc.update(dict(zip(sums, torch.stack(list(sums.values())).tolist())))
                sums = None

        def record(step: int) -> dict[str, float]:
            drain()
            metrics = acc.compute()
            lr = float(self.config.optim.lr * self.lr_multiplier(step))
            self.train_metrics = {**metrics, "lr": lr}
            return metrics

        for epoch in range(start_epoch, self.total_epochs):
            skip = resume_offset if epoch == start_epoch else 0
            for batch in self.train_loader.epoch(epoch, start_batch=skip):
                if step >= self.total_steps:
                    break
                scale = self._scale_for_step(step)
                stats = self.train_step(*self._to_device(batch), self.generator, scale)
                sums = stats if sums is None else {k: sums[k] + v for k, v in stats.items()}
                # known on the host: no sync; the global batch's samples
                self.speed.batch_end(int(batch.mask.sum()) * self.data_size)
                step += 1
                if on_step is not None:
                    on_step(step, stats)
                if self._declared:  # a SIGTERM on any rank stops every rank at this step
                    self._preempted = bool(parallel.host_max([int(self._preempted)])[0])
                if self._preempted:
                    break
                if eval_every_ba is not None and step % eval_every_ba == 0:
                    eval_metrics = self._evaluate_at(step)
                    last_eval_step = step
                if save_every_ba is not None and step % save_every_ba == 0:
                    self.save_checkpoint(step)
                if step % self.log_interval == 0:
                    record(step)
                    self.logger.log(step, {**self.train_metrics, "scale": scale,
                                           **self.speed.metrics(), **memory_stats(self.device)},
                                    prefix="train")
            if self._preempted:
                break
            self.logger.log(step, record(step), prefix="train-epoch")
            acc.reset()
            due_ep = eval_every_ep is not None and (epoch + 1) % eval_every_ep == 0
            if (due_ep or step >= self.total_steps) and last_eval_step != step:
                eval_metrics = self._evaluate_at(step)
                last_eval_step = step
            if save_every_ep is not None and (epoch + 1) % save_every_ep == 0:
                self.save_checkpoint(step)
            if step >= self.total_steps:
                break
        if self._preempted:
            self._say(f"preempted (SIGTERM): checkpointing at step {step} and exiting cleanly")
        self.save_checkpoint(step)  # always the final state: on preemption, the resume point
        return eval_metrics

    def close(self) -> None:
        """Join the last checkpoint write (raising what it raised), close the
        log; in a data group every rank leaves once rank 0's writes are
        committed, and the group's declaration is cleared."""
        try:
            self.checkpointer.close()
        finally:
            self.logger.close()
            if self._declared:
                parallel.barrier()
                parallel.set_data_group(None)
