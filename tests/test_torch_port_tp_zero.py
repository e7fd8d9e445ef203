"""The port's tensor parallelism (``mesh.model``) and ZeRO-1 (``mesh.zero``)
against hvt's, on the CPU.

Gloo worlds of spawned ranks on one torch thread each
(``tests/torch_ddp_worker.py``, the ranks' code in ``tests/torch_ddp_jobs.py``),
one spawn for each world of this file in a test session, shared by the
xdist workers: W = 2 for the train steps, W = 4 for the train steps on a
2 × 2 grid, and W = 2 for the Trainers. Rank r of W has data index r // 2
and model index r % 2 at model 2 (hvt's ``make_mesh`` order).

* Three steps of hvt's ``build_train_step`` jitted on ``cpu_mesh(W,
  model=2)`` (or ``cpu_mesh(W)`` for ZeRO at model 1), the state laid out by
  hvt's ``tp_shardings`` (with ``zero=True``, the update constrained by
  ``zero_update_shardings`` and the output state pinned, as hvt's Trainer
  does), against the port's step on W ranks from the same seeded flax
  variables (``convert``), each rank cutting its shards
  (``parallel.shard_model_``) and taking its data index's rows of the same
  batches of 8: ``swinv2_micro`` on ``fuse: false`` and ``fuse: true``
  (hvt's interpret-mode kernels inside ``shard_map``, the port's fused MLP
  on the gathered weights), ``vit_micro``, ``convnext_micro`` (grad_accum 2)
  at W = 2; SwinV2 on both routes (``fuse: false`` with SAM at rho 0.5) and
  ``resnet_micro_bottleneck`` with ``bn_pallas`` at W = 4, where the data
  group is not the world; ZeRO-1 on the ResNet (DecoupledSGDW's trace) and
  on the fused SwinV2 (AdamW's mu, nu) at W = 2, and with ``model: 2`` at
  W = 4 (their data-parallel twins run beside them, held against hvt by
  ``test_torch_port_ddp_train.py``). All adamw at lr 1e-3 but the ZeRO
  ResNet, clipping at 5.0.
  Tolerances are ``test_torch_port_accum_sam.py``'s: f32 losses and metric
  sums within 1e-5 relative and ``grad_norm`` 1e-4 (``UNFUSED_TOL``, equal
  to ``RESNET_TOL``'s), the fused route ``FUSED_TOL``; the ResNet's state
  within 1e-5·max|ref| per tensor, the transformers' as
  ``_close_after_adam`` holds them after Adam (ViT's as
  ``test_torch_port_vit.py`` does: the key third of qkv's bias, whose
  gradient is 0 in exact arithmetic, to the max bound alone).
* ZeRO-1's steps equal the same grid's steps without it, bit for bit, and
  every rank's state is the same; model peers hold the same replicated
  parameters and their own shards.
* Each rank's optimizer state is laid out as hvt's ``tp_shardings(...,
  zero=True)`` decides: TP leaves by the rules, the rest split on a dim the
  data size divides, the others whole; the rules' split against hvt's for
  every parameter of four families at data 3 (leaves that 3 does not divide)
  and model 2, the EMA copy never split.
* Checkpoints: a TP run's checkpoint restored on a data-parallel world and
  saved, then restored on the TP grid and saved, gives the same files tensor
  for tensor; a ZeRO-1 run's checkpoints equal a data-parallel run's, and a
  ZeRO-1 run resumed from the data-parallel one's step 1 equals it at step 2.
* The refusals that remain: ``spatial`` and ``pipe`` above 1, a ``model``
  that does not divide the world; with ``moe_experts``, hvt's own: ``pipe``
  above 1 and experts that ``model`` does not divide.
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_conv_families
import torch_ddp_worker
from hvt import config as jconfig
from hvt import objectives as jobjectives
from hvt import parallel as jparallel
from hvt.data import device as jdevice
from hvt.models import build_model as jbuild_model
from hvt.train import optim as joptim
from hvt.train import schedule as jschedule
from hvt.train import step as jstep
from hvt.train.state import TrainState
from hvt_torch import config as tconfig
from hvt_torch import parallel
from hvt_torch.models import build_model as tbuild_model
from hvt_torch.models import convert
from hvt_torch.train import loop as tloop
from test_torch_port_accum_sam import (FUSED_TOL, MEAN_STD, RESNET_TOL, UNFUSED_TOL, _close,
                                       _close_after_adam)
from test_torch_port_accum_sam import randomized as swin_resnet_randomized
from test_torch_port_vit import _close_after_adam as vit_close_after_adam
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

NUM_CLASSES, IMG, BATCH, STEPS, LR = 10, 32, 8, 3, 1e-3
SWIN = {"drop_path_rate": 0.0}
RESNET = {"bn_pallas": True, "stem_s2d": True}

# (id, world, model name, args, model axis, zero, step settings, optimizer)
CASES = [
    ("w2-swin-unfused-tp", 2, "swinv2_micro", {**SWIN, "fuse": False}, 2, False, {}, "adamw"),
    ("w2-swin-fused-tp", 2, "swinv2_micro", {**SWIN, "fuse": True}, 2, False, {}, "adamw"),
    ("w2-vit-tp", 2, "vit_micro", {"drop_path_rate": 0.0}, 2, False, {}, "adamw"),
    ("w2-convnext-tp-accum2", 2, "convnext_micro", {}, 2, False, {"grad_accum": 2}, "adamw"),
    ("w2-resnet-zero", 2, "resnet_micro_bottleneck", RESNET, 1, True, {}, "decoupledsgdw"),
    ("w2-resnet-dp", 2, "resnet_micro_bottleneck", RESNET, 1, False, {}, "decoupledsgdw"),
    ("w2-swin-fused-zero", 2, "swinv2_micro", {**SWIN, "fuse": True}, 1, True, {}, "adamw"),
    ("w2-swin-fused-dp", 2, "swinv2_micro", {**SWIN, "fuse": True}, 1, False, {}, "adamw"),
    ("w4-swin-unfused-tp-sam", 4, "swinv2_micro", {**SWIN, "fuse": False}, 2, False,
     {"sam_rho": 0.5}, "adamw"),
    ("w4-swin-fused-tp", 4, "swinv2_micro", {**SWIN, "fuse": True}, 2, False, {}, "adamw"),
    ("w4-resnet-tp", 4, "resnet_micro_bottleneck", RESNET, 2, False, {}, "adamw"),
    ("w4-swin-fused-tp-zero", 4, "swinv2_micro", {**SWIN, "fuse": True}, 2, True, {}, "adamw"),
]
IDS = [c[0] for c in CASES]
OPTIM = {"adamw": ("adamw", 0.05, LR), "decoupledsgdw": ("decoupledsgdw", 5e-4, 0.2)}
# the ZeRO case and the case without it that it equals bit for bit
TWINS = {"w2-resnet-zero": "w2-resnet-dp", "w2-swin-fused-zero": "w2-swin-fused-dp",
         "w4-swin-fused-tp-zero": "w4-swin-fused-tp"}


def _family(name):
    return name.split("_")[0].replace("swinv2", "swin")


def _flax_model(name, args):
    config = jconfig.loads({"model": {"name": name, "args": args},
                            "precision": {"compute_dtype": "float32"}})
    return jbuild_model(config, NUM_CLASSES)


def _flat(name, variables):
    """A flax variables tree → the port's state-dict entries (numpy)."""
    v = jax.tree.map(np.asarray, variables)
    family = _family(name)
    if family == "swin":
        return convert.swin_state_dict_from_flax(v["params"])
    if family == "resnet":
        return convert.resnet_state_dict_from_flax(v["params"], v["batch_stats"])
    if family == "vit":
        return convert.vit_state_dict_from_flax(v["params"])
    return convert.convnet_state_dict_from_flax(v["params"], v.get("batch_stats"))


def _shapes(jm):
    return jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)),
                                          train=False))


def _case(index):
    key, world, name, args, model, zero, settings, optim = CASES[index]
    jm = _flax_model(name, args)
    family = _family(name)
    index = IDS.index(TWINS.get(key, key))  # a ZeRO case draws its twin's weights and batches
    seed = 700 + index
    if family in ("swin", "resnet"):
        variables = swin_resnet_randomized(_shapes(jm), seed, family)
    else:
        variables = torch_conv_families.randomized(_shapes(jm), seed)
    rng = np.random.default_rng(800 + index)
    batches = [(rng.integers(0, 256, size=(BATCH, IMG, IMG, 3), dtype=np.uint8),
                rng.integers(0, NUM_CLASSES, size=BATCH).astype(np.int32),
                np.ones(BATCH, np.float32)) for _ in range(STEPS)]
    opt_name, wd, lr = OPTIM[optim]
    return {"key": key, "name": name, "args": args, "img": IMG, "model": model, "zero": zero,
            "settings": settings, "batches": batches, "lr": lr, "optim": (opt_name, wd),
            "mean_std": MEAN_STD, "variables": variables,
            "state": {k: np.asarray(v) for k, v in _flat(name, variables).items()}}


def _rank_inputs(world):
    return [{k: v for k, v in _case(i).items() if k != "variables"}
            for i, c in enumerate(CASES) if c[1] == world]


def _shared(key, world, tmp_path_factory):
    return torch_ddp_worker.Shared(key, "grid_steps", world, tmp_path_factory,
                                   lambda: _rank_inputs(world), timeout=420.0)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _shared("grid-steps-2", 2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _shared("grid-steps-4", 4, tmp_path_factory)


def _results(shared, key):
    """Every rank's result of case ``key``."""
    inputs, results = shared.get()
    at = [c["key"] for c in inputs].index(key)
    return [r[at] for r in results]


# ---------------------------------------------------------------------------
# hvt's side
# ---------------------------------------------------------------------------


def _hvt_steps(case, world):
    jm = _flax_model(case["name"], case["args"])
    name, wd = case["optim"]
    optim_cfg = type("Optim", (), dict(name=name, lr=case["lr"], weight_decay=wd, momentum=0.9))
    tx = joptim.build_optimizer(optim_cfg, jschedule.cosine_with_warmup(1, 10), grad_clip_norm=5.0,
                                no_decay_substrings=getattr(jm, "no_weight_decay_substrings", ()))
    mesh = jparallel.cpu_mesh(world, model=case["model"])
    variables = case["variables"]
    params = jax.tree.map(jnp.asarray, variables["params"])
    out_shardings = None
    if case["zero"]:
        tx = jparallel.constrain_tx_updates(tx, jparallel.zero_update_shardings(mesh, params))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=jax.tree.map(jnp.asarray, variables.get("batch_stats", {})),
                       opt_state=tx.init(params))
    shardings = jparallel.tp_shardings(mesh, state, zero=case["zero"])
    if case["zero"]:
        out_shardings = shardings
    prep = jdevice.DevicePrep(mean=MEAN_STD[0], std=MEAN_STD[1], compute_dtype=jnp.float32)
    train = jstep.build_train_step(jm, jobjectives.soft_cross_entropy, tx, prep,
                                   jstep.StepSettings(num_classes=NUM_CLASSES, smoothing=0.1,
                                                      **case["settings"]),
                                   out_state_shardings=out_shardings)
    jparallel.set_kernel_mesh(mesh)
    try:
        state = jax.device_put(state, shardings)
        out = {"stats": []}
        for images, labels, mask in case["batches"]:
            sharded = [jax.device_put(jnp.asarray(a), jparallel.batch_sharding(mesh))
                       for a in (images, labels, mask)]
            state, stats = train(state, *sharded, jax.random.key(0), scale=1.0)
            out["stats"].append({k: float(v) for k, v in stats.items()})
        out["state"] = _flat(case["name"], {"params": state.params,
                                            "batch_stats": state.batch_stats})
    finally:
        jparallel.set_kernel_mesh(None)
    return out


def _check_against_hvt(case, ref, got):
    fused = bool(case["args"].get("fuse"))
    family = _family(case["name"])
    tol = FUSED_TOL if fused else (RESNET_TOL if family == "resnet" else UNFUSED_TOL)
    for i, (r, g) in enumerate(zip(ref["stats"], got["stats"])):
        for k in ("loss_sum", "ce_sum"):
            assert g[k] == pytest.approx(r[k], rel=tol["loss"]), f"{k}, step {i}"
        assert g["grad_norm"] == pytest.approx(r["grad_norm"], rel=tol["norm"]), f"norm, step {i}"
        for k in ("correct@1", "correct@5", "count", "batches"):
            assert g[k] == r[k], f"{k}, step {i}"
    assert ref["stats"][0]["loss_sum"] != ref["stats"][-1]["loss_sum"]
    assert set(got["state"]) == set(ref["state"])
    for name, r in ref["state"].items():
        if family == "resnet":
            _close(got["state"][name], r, tol["state"], f"{name} after {STEPS} steps")
        elif family == "vit":  # the key third of qkv's bias moves on rounding noise
            vit_close_after_adam(got["state"][name], r, case["lr"], STEPS, name)
        else:
            _close_after_adam(got["state"][name], r, case["lr"], STEPS, name, fused)


def _full_state(results, model):
    """The ranks' states joined over the model group (data index 0's peers)."""
    shards = [{k: v.numpy() for k, v in r["state"].items()} for r in results[:model]]
    return convert.unshard_state_dicts(shards)


# the data-parallel twins are held against hvt by test_torch_port_ddp_train.py
HVT_CASES = [i for i, key in enumerate(IDS) if key not in TWINS.values()]


@pytest.mark.parametrize("index", HVT_CASES, ids=[IDS[i] for i in HVT_CASES])
def test_grid_steps_match_hvt(request, index):
    _, world, _, _, model, zero, _, _ = CASES[index]
    # only the case's own world: a test holding one world's lock while it
    # waits for the other's could wait on a worker that waits on it
    shared = request.getfixturevalue(f"world{world}")
    case = _case(index)
    ref = _hvt_steps(case, world)  # while the ranks run
    results = _results(shared, case["key"])
    data = world // model
    for r, rank in zip(results, range(world)):
        assert r["grid"] == (rank // model, data, rank % model)
        assert r["cut"] == (0 if model == 1 else sum(
            parallel.tp_rule(n) is not None for n in case["state"]))
        assert r["stats"] == results[0]["stats"]  # every rank returns the global stats
    got = {"stats": results[0]["stats"], "state": _full_state(results, model)}
    _check_against_hvt(case, ref, got)
    for rank, r in enumerate(results):  # data peers equal; model peers share what is replicated
        peer = results[rank % model]
        for name, t in r["state"].items():
            assert torch.equal(t, peer["state"][name]), (rank, name)
            if parallel.tp_rule(name) is None or model == 1:
                assert torch.equal(t, results[0]["state"][name]), (rank, name)


@pytest.mark.parametrize("zero_key", sorted(TWINS))
def test_zero_steps_equal_the_grid_without_zero_bit_for_bit(request, zero_key):
    shared = request.getfixturevalue("world2" if zero_key.startswith("w2") else "world4")
    zero, plain = _results(shared, zero_key), _results(shared, TWINS[zero_key])
    for a, b in zip(zero, plain):
        assert a["stats"] == b["stats"]
        for name, t in a["state"].items():
            assert torch.equal(t, b["state"][name]), name
        for index, moments in a["opt_full"]["state"].items():  # the gathered moments too
            for k, v in moments.items():
                assert torch.equal(v, b["opt_full"]["state"][index][k]), (index, k)
        # ZeRO-1's parameter gather: at least one all-gather a step more
        assert a["collectives"]["all_gather"] - b["collectives"]["all_gather"] >= STEPS


# ---------------------------------------------------------------------------
# The optimizer state's layout against hvt's tp_shardings
# ---------------------------------------------------------------------------


def _hvt_layout(name, args, world, model):
    """{port name: "model", "data" or "whole"} of each parameter's optimizer
    state and EMA copy as hvt's ``tp_shardings(..., zero=True)`` lays them
    out on ``cpu_mesh(world, model=model)``."""
    jm = _flax_model(name, args)
    shapes = _shapes(jm)
    mesh = jparallel.cpu_mesh(world, model=model)
    tree = {"opt_state": shapes["params"], "ema_params": shapes["params"]}
    specs = jparallel.tp_shardings(mesh, tree, zero=True)
    codes = {"model": 1 if model > 1 else 0, "data": 2}  # a model axis of 1 replicates
    out = {}
    for part in ("opt_state", "ema_params"):
        code = jax.tree.map(lambda s, sh: np.full(sh.shape, codes.get(
            next((a for a in s.spec if a), None), 0), np.float32), specs[part], tree[part])
        flat = _flat(name, {"params": code, "batch_stats": jax.tree.map(
            lambda s: np.zeros(s.shape, np.float32), shapes.get("batch_stats", {}))})
        out[part] = {k: ("whole", "model", "data")[int(v.flat[0])] for k, v in flat.items()
                     if not k.endswith(("running_mean", "running_var"))}
    return out


@pytest.mark.parametrize("name,args", [("swinv2_micro", SWIN), ("resnet_micro_bottleneck", RESNET),
                                       ("vit_micro", {}), ("convnext_micro", {})])
@pytest.mark.parametrize("world,model", [(3, 1), (6, 2)])
def test_zero_and_tp_layout_rules_match_hvts(name, args, world, model):
    """The port's rules (``tp_rule``, ``zero_split``) decide every
    parameter's state as hvt's do, at data 3: some leaves 3 does not
    divide stay whole."""
    hvt = _hvt_layout(name, args, world, model)
    data = world // model
    shapes = {k: v.shape for k, v in tbuild_model(tconfig.loads(
        {"model": {"name": name, "args": args}, "train_dataset": {"crop_size": IMG}}),
        NUM_CLASSES).named_parameters()}
    assert set(shapes) == set(hvt["opt_state"])
    kinds = set()
    for n, shape in shapes.items():
        if model > 1 and parallel.tp_rule(n) is not None:
            port = "model"
        else:
            port = "whole" if parallel.zero_split(n, shape, data) is None else "data"
        if model == 1 and parallel.tp_rule(n) is not None:
            assert hvt["opt_state"][n] == "whole" and port == "whole", n  # the rule wins at 1
        assert port == hvt["opt_state"][n], (n, shape, port, hvt["opt_state"][n])
        assert hvt["ema_params"][n] == ("model" if port == "model" else "whole"), n
        kinds.add(port)
    assert "whole" in kinds and "data" in kinds


def test_each_ranks_state_is_laid_out_by_the_rules(world2, world4):
    """The state the ranks hold after three steps: the TP shards, the
    ZeRO-1 slices and the whole leaves, by ``tp_rule`` and ``zero_split``;
    ``state_dict`` gathers every moment to its parameter's full shape."""
    for shared, key in ((world2, "w2-swin-fused-zero"), (world2, "w2-resnet-zero"),
                        (world4, "w4-swin-fused-tp-zero"), (world2, "w2-swin-unfused-tp")):
        case = next(c for c in shared.get()[0] if c["key"] == key)
        data, model = len(shared.get()[1]) // case["model"], case["model"]
        full = case["state"]
        for r in _results(shared, key):
            split = 0
            for n, moments in r["opt_local"].items():
                want = list(full[n].shape)
                if model > 1 and parallel.tp_rule(n) is not None:
                    want[parallel.tp_rule(n)] //= model
                elif case["zero"] and (d := parallel.zero_split(n, full[n].shape, data)) is not None:
                    want[d] //= data
                    split += 1
                for k, shape in moments.items():
                    assert list(shape) == want, (key, n, k, shape, want)
            assert (split > 0) == case["zero"], key
            for index, moments in r["opt_full"]["state"].items():
                n = r["param_names"][index]
                for k, v in moments.items():
                    assert tuple(v.shape) == full[n].shape, (key, n, k)


def test_shard_and_unshard_state_dicts_round_trip():
    case = _case(0)
    full = case["state"]
    shards = [convert.shard_state_dict(full, r, 2) for r in range(2)]
    for name, t in full.items():
        dim = parallel.tp_rule(name)
        if dim is None:
            assert shards[1][name] is t
        else:
            assert shards[1][name].shape[dim] * 2 == t.shape[dim]
    joined = convert.unshard_state_dicts(shards)
    assert all(np.array_equal(joined[k], v) for k, v in full.items())
    tensors = convert.unshard_state_dicts([{k: torch.from_numpy(np.ascontiguousarray(v))
                                            for k, v in s.items()} for s in shards])
    assert all(np.array_equal(tensors[k].numpy(), v) for k, v in full.items())


# ---------------------------------------------------------------------------
# Checkpoints across grids, through the Trainer
# ---------------------------------------------------------------------------


def _layer(root, tag, mesh, **change):
    layer = {
        "run_name": "grid", "seed": 3, "max_duration": "2ba", "grad_accum": 1,
        "eval_interval": "1dur", "machine": {"save_root": str(root / tag)}, "mesh": mesh,
        "model": {"name": "swinv2_micro", "args": {**SWIN, "fuse": False}},
        "train_dataset": {"source": "synthetic", "crop_size": IMG, "synthetic_num_classes": NUM_CLASSES,
                          "synthetic_num_samples": 32, "global_batch_size": BATCH,
                          "shuffle": True, "drop_last": True},
        "eval_dataset": {"source": "synthetic", "crop_size": IMG, "synthetic_num_classes": NUM_CLASSES,
                         "synthetic_num_samples": 8, "global_batch_size": 4},
        "optim": {"name": "AdamW", "lr": 1e-3, "weight_decay": 0.05},
        "scheduler": {"args": {"t_warmup": "1ba"}},
        "precision": {"compute_dtype": "float32"},
        "save": {"interval": "1ba", "num_checkpoints_to_keep": 3, "wandb": False},
        "loader": {"num_workers": 1, "prefetch_batches": 1},
        "algorithms": [{"cls": "EMA", "args": {"half_life": "2ba", "update_interval": "1ba"}},
                       {"cls": "GradientClipping", "args": {"clipping_threshold": 1.0}}],
    }
    layer.update(change)
    return layer


def _ckpt(root, tag, step):
    return f"ckpt://{root / tag / 'grid' / 'checkpoints'}:{step}"


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    root = root / "grid-trainer-runs"
    layers = [
        (_layer(root, "tp", {"model": 2}), "fit"),
        (_layer(root, "dp_from_tp", {}, load_path=_ckpt(root, "tp", 2)), "save"),
        (_layer(root, "tp_again", {"model": 2}, load_path=_ckpt(root, "dp_from_tp", 2)), "save"),
        (_layer(root, "zero", {"zero": True}), "fit"),
        (_layer(root, "dp", {}), "fit"),
        (_layer(root, "zero_from_dp", {"zero": True}, load_path=_ckpt(root, "dp", 1)), "fit"),
    ]
    return torch_ddp_worker.Shared("grid-trainer-2", "grid_trainers", 2, tmp_path_factory,
                                   lambda: layers, timeout=420.0)


def _saved(layer, step):
    path = pathlib.Path(layer["machine"]["save_root"]) / "grid" / "checkpoints" / str(step)
    state = torch.load(path / "state.pt", weights_only=True)
    state.pop("config")
    return state


def _equal_trees(a, b, what):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.shape == b.shape and torch.equal(a, b), what
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), (what, sorted(a.keys() ^ b.keys())[:5])
        for k in a:
            _equal_trees(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{what}/{i}")
    else:
        assert a == b, (what, a, b)


def test_tp_checkpoint_restores_on_a_data_parallel_world_and_back(trainers):
    layers, results = trainers.get()
    tp = _saved(layers[0][0], 2)
    _equal_trees(_saved(layers[1][0], 2), tp, "tp → data parallel")
    _equal_trees(_saved(layers[2][0], 2), tp, "tp → data parallel → tp")
    params = tp["params"]
    fc1 = next(n for n in params if n.endswith("mlp.fc1.weight"))
    for rank, r in enumerate(results):
        assert r[0]["grid"] == (0, 1, 2, False) and r[1]["grid"] == (rank, 2, 1, False)
        for run in (0, 2):  # each TP rank holds its shards, the EMA copy too
            assert r[run]["state"][fc1].shape[0] * 2 == params[fc1].shape[0]
            assert r[run]["ema_shapes"][fc1] == tuple(r[run]["state"][fc1].shape)
            assert torch.equal(r[run]["state"][fc1], params[fc1].chunk(2)[rank])
        for name, t in r[1]["state"].items():  # the data-parallel restore holds the full tensors
            assert torch.equal(t, params.get(name, tp["batch_stats"].get(name))), name


def test_zero_checkpoints_equal_data_parallel_ones(trainers):
    layers, results = trainers.get()
    for step in (1, 2):
        _equal_trees(_saved(layers[3][0], step), _saved(layers[4][0], step), f"step {step}")
    _equal_trees(_saved(layers[5][0], 2), _saved(layers[3][0], 2), "zero resumed from step 1")
    for r in results:
        assert r[3]["grid"][3] and not r[4]["grid"][3]
        assert r[3]["steps"] == r[4]["steps"] and r[5]["steps"][2] == r[3]["steps"][2]
        assert r[3]["ema_shapes"] == {k: tuple(v.shape) for k, v in r[4]["state"].items()
                                      if k in r[3]["ema_shapes"]}  # never ZeRO-split


# ---------------------------------------------------------------------------
# What stays refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh,world,error", [
    ({"spatial": 2}, 2, NotImplementedError), ({"pipe": 2}, 2, NotImplementedError),
    ({"model": 2, "spatial": 2}, 4, NotImplementedError), ({"model": 3}, 4, ValueError),
    ({"model": 2, "data": 3}, 4, ValueError),
])
def test_mesh_refusals_that_remain(mesh, world, error):
    with pytest.raises(error, match="queue 1, item 11"):
        parallel.check_mesh(tconfig.loads({"mesh": mesh}).mesh, world)
    assert parallel.check_mesh(tconfig.loads({"mesh": {"model": 2, "zero": True}}).mesh, 4) == 2
    assert parallel.check_mesh(tconfig.loads({"mesh": {"model": 2, "data": 2}}).mesh, 4) == 2


def test_moe_experts_stay_refused(tmp_path):
    """The Switch-MoE builds now; what stays refused with it is hvt's:
    ``pipe > 1`` together with MoE, and experts that the model axis does
    not divide (the Trainer, before any weight moves)."""
    args = {"moe_experts": 4, "moe_from_stage": 0, "moe_every": 1}
    config = tconfig.loads({"model": {"name": "swinv2_micro", "args": args},
                            "train_dataset": {"crop_size": IMG}})
    assert sum(n.endswith(".moe.w1") for n, _ in tbuild_model(config, NUM_CLASSES)
               .named_parameters()) == 2
    with pytest.raises(ValueError, match="pipe > 1 and moe_experts > 0"):
        tbuild_model(tconfig.loads({"model": {"name": "swinv2_micro",
                                              "args": {**args, "pipe": 2}},
                                    "train_dataset": {"crop_size": IMG}}), NUM_CLASSES)
    layer = {"model": {"name": "swinv2_micro", "args": {**args, "moe_experts": 3}},
             "mesh": {"model": 2}, "machine": {"save_root": str(tmp_path)},
             "train_dataset": {"source": "synthetic", "crop_size": IMG}}
    with pytest.raises(ValueError, match="must be divisible by the mesh's model-axis size 2"):
        tloop.Trainer(tconfig.loads(layer), device="cpu")
