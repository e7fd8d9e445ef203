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


# ---------------------------------------------------------------------------
# The grid: tensor parallelism and ZeRO-1
# ---------------------------------------------------------------------------


def grid_model(case):
    """The port's model of ``case`` from its factory in f32, the full weights
    of ``case["state"]`` loaded, then cut to this rank's shards."""
    from hvt_torch.models import build_model

    config = tconfig.loads({"seed": 0, "model": {"name": case["name"], "args": case["args"]},
                            "precision": {"compute_dtype": "float32"},
                            "train_dataset": {"crop_size": case["img"]}})
    model = build_model(config, NUM_CLASSES)
    model.load_state_dict({k: _t(v) for k, v in case["state"].items()})
    cut = parallel.shard_model_(model)
    return model, cut


def _grid_steps(case):
    parallel.set_data_group(dist.group.WORLD, model=case["model"])
    data, data_rank, model_rank = parallel.world(), parallel.rank(), parallel.model_rank()
    model, cut = grid_model(case)
    name, wd = case["optim"]
    opt = toptim.Optimizer(model.named_parameters(), name, case["lr"], wd, 0.9,
                           tschedule.cosine_with_warmup(1, 10), grad_clip_norm=5.0,
                           no_decay_substrings=model.no_weight_decay_substrings,
                           zero=case["zero"])
    prep = tdevice.DevicePrep(mean=case["mean_std"][0], std=case["mean_std"][1],
                              compute_dtype=torch.float32)
    settings = tstep.StepSettings(num_classes=NUM_CLASSES, smoothing=0.1, **case["settings"])
    step = tstep.build_train_step(model, tobjectives.soft_cross_entropy, opt, prep, settings)
    generator = torch.Generator().manual_seed(0)
    counts = dict(parallel.COUNTS)
    stats = []
    for images, labels, mask in case["batches"]:
        rows = parallel.microbatch_rows(images.shape[0], settings.grad_accum, data, data_rank)
        out = step(_t(images[rows]), _t(labels[rows]), _t(mask[rows]), generator)
        stats.append({k: float(v) for k, v in out.items()})
    names = {p: n for n, p in model.named_parameters()}
    local = {names[p]: {k: tuple(v.shape) for k, v in s.items()} for p, s in opt.state.items()}
    full_opt = opt.state_dict()
    parallel.set_data_group(None)
    return {"stats": stats, "cut": cut, "grid": (data_rank, data, model_rank),
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "opt_local": local, "opt_full": full_opt,
            "param_names": [names[p] for g in opt.param_groups for p in g["params"]],
            "collectives": {k: parallel.COUNTS[k] - counts[k] for k in counts}}


def grid_steps(inputs, directory):
    """Train steps of each case on its grid (``case["model"]``, ``case["zero"]``)."""
    return [_grid_steps(c) for c in inputs]


def grid_trainers(inputs, directory):
    """Each (config layer, action) through a ``Trainer`` in turn, its
    ``mesh`` setting the grid: "fit" trains it, "save" saves the state it
    restored at its step. Returns each one's step stats, grid, final state
    and the shapes of its EMA copy."""
    from hvt_torch.train import loop as tloop

    out = []
    for layer, action in inputs:
        trainer = tloop.Trainer(tconfig.loads(layer), device="cpu", log_interval=1)
        records = {}
        try:
            if action == "fit":
                trainer.fit(on_step=lambda s, stats: records.setdefault(
                    s, {k: float(v) for k, v in stats.items()}))
            else:
                trainer.save_checkpoint(trainer.step)
            out.append({"steps": records, "grid": (trainer.data_rank, trainer.data_size,
                                                   trainer.model_size, trainer.zero),
                        "state": {k: v.detach().clone() for k, v in
                                  trainer.model.state_dict().items()},
                        "ema_shapes": {k: tuple(v.shape) for k, v in
                                       (trainer.ema.params.items() if trainer.ema else ())}})
        finally:
            trainer.close()
    return out


def cuda_grid(inputs, directory):
    """On cuda:0, the world as one model group over gloo: the three
    model-group Functions, the host-staged all-gather, ZeRO-1's slice
    gather over the world as a data group, and the MLP half's kernels fed
    weights gathered from each rank's shards, beside the plain half's
    gradients on the full weights."""
    from hvt_torch.ops import fused_halves_cuda as fh

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    world = dist.get_world_size()
    parallel.set_data_group(dist.group.WORLD, device, model=world)
    r = parallel.model_rank()
    out = {"model": (r, parallel.model_size()), "backend": dist.get_backend()}

    x = torch.full((4, 3), float(r + 1), device=device, requires_grad=True)
    y = parallel.reduce_from_model(x)
    y.backward(torch.full_like(y, float(r + 1)))
    out["reduce"] = (y.detach().cpu(), x.grad.cpu())
    x = torch.full((4, 3), 2.0, device=device, requires_grad=True)
    z = parallel.copy_to_model(x)
    (z * float(r + 1)).sum().backward()
    out["copy"] = (z.detach().cpu(), x.grad.cpu())
    full = torch.arange(8 * 6, dtype=torch.float32, device=device).reshape(8, 6)
    for dim in (0, 1):
        w = parallel.shard(full, dim, r, world).clone().requires_grad_()
        g = parallel.gather_from_model(w, dim)
        upstream = torch.arange(full.numel(), dtype=torch.float32, device=device).view_as(full)
        g.backward(upstream)
        out[f"gather{dim}"] = (g.detach().cpu(), w.grad.cpu(),
                               parallel.shard(upstream, dim, r, world).cpu(), g.device.type)
    staged = parallel.all_gather(torch.full((3,), float(r), device=device), parallel.model_group())
    out["staged"] = (staged.cpu(), staged.device.type)

    mlp = {}
    for c in inputs["widths"]:
        rng = np.random.default_rng(c)

        def t(*shape, scale=1.0):
            return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32),
                                   device=device)

        w1, b1 = t(4 * c, c, scale=c ** -0.5), t(4 * c, scale=0.1)
        w2, b2 = t(c, 4 * c, scale=(4 * c) ** -0.5), t(c, scale=0.1)
        lns, lnb = 1.0 + t(c, scale=0.1), t(c, scale=0.1)
        x = t(3 * 196, c).bfloat16()
        g = t(3 * 196, c).bfloat16()
        shards = [parallel.shard(w, d, r, world).clone().requires_grad_()
                  for w, d in ((w1, 0), (b1, 0), (w2, 1))]
        before = fh.MLP_KERNEL.launches, fh.MLP_BWD_KERNEL.launches
        y = fh.mlp_half(x, parallel.gather_from_model(shards[0], 0),
                        parallel.gather_from_model(shards[1], 0),
                        parallel.gather_from_model(shards[2], 1), b2, lns, lnb)
        y.backward(g)
        torch.cuda.synchronize()
        launches = (fh.MLP_KERNEL.launches - before[0], fh.MLP_BWD_KERNEL.launches - before[1])
        plain_y = fh.mlp_half_plain(x, w1, b1, w2, b2, lns, lnb)
        plain = fh.mlp_half_backward_plain(x, w1, b1, w2, b2, lns, g)
        want = [parallel.shard(p, d, r, world) for p, d in ((plain[1], 0), (plain[2], 0),
                                                            (plain[3], 1))]
        mlp[c] = {"launches": launches, "y": (y.detach().float().cpu(), plain_y.float().cpu()),
                  "grads": [(s.grad.float().cpu(), w.float().cpu()) for s, w in zip(shards, want)]}
    out["mlp"] = mlp

    parallel.set_data_group(dist.group.WORLD, device)  # the world as one data group
    full = torch.zeros(6, 4, device=device)
    mine = torch.full((6, 4 // world), float(r + 1), device=device)
    parallel.all_gather_slices_([(full, mine, 1)])
    out["slices"] = full.cpu()
    parallel.set_data_group(None)
    return out
