"""What each rank of ``tests/torch_ddp_worker.py`` runs: the port's
data-parallel route on this rank's rows of global inputs made by the test.
torch and ``hvt_torch`` only (no JAX); every function takes the inputs the
test saved and the run's directory and returns what the rank saves.
"""

import numpy as np
import torch
import torch.distributed as dist

from hvt_torch import config as tconfig
from hvt_torch import objectives as tobjectives
from hvt_torch import parallel
from hvt_torch.data import device as tdevice
from hvt_torch.models import common as tcommon
from hvt_torch.models import resnet as tresnet
from hvt_torch.models import swinv2 as tswin
from hvt_torch.ops import bn_stats
from hvt_torch.train import optim as toptim
from hvt_torch.train import schedule as tschedule
from hvt_torch.train import step as tstep

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _declare():
    parallel.set_data_group(dist.group.WORLD)
    return dist.get_rank(), dist.get_world_size()


def _rows(a, rank, world):
    """This rank's contiguous share of a global batch's leading dim."""
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


# ---------------------------------------------------------------------------
# BatchNorm: bn_train and the four modules
# ---------------------------------------------------------------------------


def _bn_train(case, rank, world):
    dtype = DTYPES[case["dtype"]]
    x = _t(_rows(case["x"], rank, world), dtype).requires_grad_()
    scale = _t(case["scale"]).requires_grad_()
    bias = _t(case["bias"]).requires_grad_()
    y, mean, var = bn_stats.bn_train(x, scale, bias, 1e-5, dtype, case.get("plain", False))
    torch.autograd.backward(y, _t(_rows(case["dy"], rank, world), dtype))
    return {"y": y.detach().float(), "mean": mean, "var": var, "dx": x.grad.float(),
            "dscale": scale.grad, "dbias": bias.grad}


MODULES = {"batchnorm": tcommon.BatchNorm, "pallas": tcommon.PallasBatchNorm,
           "custom": tcommon.CustomBatchNorm}


def _module(case, rank, world):
    c = case["x"].shape[-1]
    if case["kind"] == "grouped":
        m = tcommon.GroupedBatchNorm(c, case["groups"])
    else:
        m = MODULES[case["kind"]](c)
    with torch.no_grad():
        m.weight.copy_(_t(case["weight"]))
        m.bias.copy_(_t(case["bias"]))
        m.running_mean.copy_(_t(case["mean"]))
        m.running_var.copy_(_t(case["var"]))
    m.train()
    dtype = DTYPES[case["dtype"]]
    x = _t(_rows(case["x"], rank, world), dtype).requires_grad_()
    y = m(x)
    torch.autograd.backward(y, _t(_rows(case["dy"], rank, world), dtype))
    return {"y": y.detach().float(), "dx": x.grad.float(), "dscale": m.weight.grad,
            "dbias": m.bias.grad, "running_mean": m.running_mean.clone(),
            "running_var": m.running_var.clone()}


# ---------------------------------------------------------------------------
# Draws over the global microbatch: against one process on the whole batch
# ---------------------------------------------------------------------------


def _augment(case, rank, world):
    """The step's augmentations and a drop-path mask on this rank's rows,
    and the same from one process on the whole batch (no group, the same
    generator seed): each as (this rank's, one process's rows of it)."""
    settings = tstep.StepSettings(**case["settings"])
    prep = tdevice.DevicePrep(mean=(120.0, 115.0, 100.0), std=(60.0, 58.0, 62.0),
                              compute_dtype=torch.float32)
    images, labels = _t(case["images"]), _t(case["labels"]).long()
    b = images.shape[0] // world
    mine = slice(rank * b, (rank + 1) * b)

    def run(imgs, labs):
        gen = torch.Generator().manual_seed(case["seed"])
        draws = tstep.draw_augmentations(gen, settings, tuple(imgs.shape), 1.0, imgs.device)
        x, targets = tstep.augment(imgs, labs, prep, settings, 1.0, draws)
        scale = tcommon.drop_path_scale(imgs.shape[0], 0.5, gen)
        return x, targets, scale, gen.get_state()

    got = run(images[mine], labels[mine])
    with parallel.no_data_group():
        ref = run(images, labels)
    ref_targets = [t[mine] for t in ref[1]] if isinstance(ref[1], list) else ref[1][mine]
    return {"x": (got[0], ref[0][mine]), "targets": (got[1], ref_targets),
            "drop_path": (got[2], ref[2][mine]), "generator": (got[3], ref[3])}


def ops(inputs, directory):
    rank, world = _declare()
    return {"bn_train": [_bn_train(c, rank, world) for c in inputs.get("bn_train", [])],
            "modules": [_module(c, rank, world) for c in inputs.get("modules", [])],
            "augment": [_augment(c, rank, world) for c in inputs.get("augment", [])]}


# ---------------------------------------------------------------------------
# Train steps on this rank's share of each global batch
# ---------------------------------------------------------------------------

NUM_CLASSES = 10


def _model(case):
    if case["family"] == "resnet":
        return tresnet.resnet_micro_bottleneck(NUM_CLASSES, **case["model_kw"])
    return tswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=torch.float32,
                                   drop_path_rate=0.0, img_size=case["img"], **case["model_kw"])


def _steps(case, rank, world):
    model = _model(case)
    model.load_state_dict({k: _t(v) for k, v in case["state"].items()})
    name, wd = case["optim"]
    opt = toptim.Optimizer(model.named_parameters(), name, case["lr"], wd, 0.9,
                           tschedule.cosine_with_warmup(1, 10), grad_clip_norm=5.0,
                           no_decay_substrings=model.no_weight_decay_substrings)
    prep = tdevice.DevicePrep(mean=case["mean_std"][0], std=case["mean_std"][1],
                              compute_dtype=torch.float32)
    settings = tstep.StepSettings(num_classes=NUM_CLASSES, smoothing=0.1, **case["settings"])
    step = tstep.build_train_step(model, tobjectives.soft_cross_entropy, opt, prep, settings)
    generator = torch.Generator().manual_seed(0)
    stats = []
    for images, labels, mask in case["batches"]:
        rows = parallel.microbatch_rows(images.shape[0], settings.grad_accum, world, rank)
        out = step(_t(images[rows]), _t(labels[rows]), _t(mask[rows]), generator)
        stats.append({k: float(v) for k, v in out.items()})
    return {"stats": stats, "state": {k: v.clone() for k, v in model.state_dict().items()}}


def train_steps(inputs, directory):
    rank, world = _declare()
    return [_steps(c, rank, world) for c in inputs]


# ---------------------------------------------------------------------------
# The Trainer
# ---------------------------------------------------------------------------


def trainer(inputs, directory):
    """Each of ``inputs``' config layers through a ``Trainer`` on the CPU, in
    turn: its eval metrics, each step's stats, the last state and generator,
    the step it started at and how many checkpoints this rank saved."""
    from hvt_torch.train import loop as tloop

    out = []
    for layer in inputs:
        records = {}
        trainer = tloop.Trainer(tconfig.loads(layer), device="cpu", log_interval=1)
        saves = []
        save = trainer.checkpointer.save
        trainer.checkpointer.save = lambda step, state: (saves.append(step), save(step, state))
        start = trainer.step
        try:
            metrics = trainer.fit(on_step=lambda s, stats: records.setdefault(
                s, {k: float(v) for k, v in stats.items()}))
            out.append({"eval": metrics, "steps": records, "world": trainer.world,
                        "rank": trainer.rank, "saves": len(saves), "resumed_at": start,
                        "state": {k: v.detach().clone() for k, v in
                                  trainer.model.state_dict().items()},
                        "rng": trainer.generator.get_state()})
        finally:
            trainer.close()
    return out
