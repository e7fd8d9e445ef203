"""The port's data-parallel training against hvt's and against one process,
on the CPU.

Gloo worlds of two spawned ranks on one torch thread each
(``tests/torch_ddp_worker.py``): one for each train-step case, running while
this process computes hvt's side, and one for the Trainers, shared by the
xdist workers; and one ``torchrun`` of the trainer's CLI:

* Three steps of hvt's ``build_train_step`` jitted on ``cpu_mesh(2)`` with
  the global batch sharded over the data axis, against the port's step on
  two ranks, each given its rows of every microbatch
  (``parallel.microbatch_rows``), from the same flax variables (every leaf
  drawn) and batches of 8 images, both on adamw at lr 1e-3:
  ``resnet_micro_bottleneck`` with ``bn_pallas`` (the port's ``bn_train``
  on its data-parallel route; hvt's ``PallasBatchNorm`` takes its jnp route
  on the CPU, the formulas of its interpret-mode kernels, which
  ``test_torch_port_ddp.py`` holds) and
  ``swinv2_micro`` on ``fuse: true`` (hvt's fused halves in interpret mode
  inside ``shard_map``); each at accumulation 1 and 2, the ResNet at 2 with
  SAM (rho 0.5, every step). Drop path 0 and no MixUp: JAX's PRNG and
  torch's draw differently (``test_torch_port_ddp.py`` holds the port's
  draws over the global batch against one process). Tolerances are
  ``test_torch_port_accum_sam.py``'s: ResNet (all f32) losses and metric
  sums within 1e-5 relative, ``grad_norm`` 1e-4, the state 1e-5·max|ref|
  per tensor; SwinV2 (``FUSED_TOL``) losses and norms 2e-3, parameters as
  ``_close_after_adam`` holds them after Adam. Both ranks end with the same
  state, bit for bit.
* A ``Trainer`` on two ranks against the port's one-process ``Trainer`` at
  the same global batch (accumulation 1, no random draws: the two worlds
  order a batch's rows differently), with evaluation: losses and metrics
  within 1e-5 relative, the state within 1e-5·max|ref| per tensor. Rank 0
  alone saves checkpoints and prints; each rank writes ``log{rank}.txt``.
* A run with accumulation 2, SAM, MixUp, CutMix and drop path resumed at
  step 2 of 3 (mid-epoch) from its checkpoint equals the uninterrupted run
  bit for bit on both ranks.
* ``torchrun --nproc_per_node=2 -m hvt_torch.main --device cpu`` trains,
  evaluates and checkpoints, rank 0 printing the one JSON line.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_worker
from hvt import objectives as jobjectives
from hvt import parallel as jparallel
from hvt.data import device as jdevice
from hvt.train import optim as joptim
from hvt.train import schedule as jschedule
from hvt.train import step as jstep
from hvt.train.state import TrainState
from hvt_torch import config as tconfig
from hvt_torch.train import loop as tloop
from test_torch_port_accum_sam import (FUSED_TOL, LR, MEAN_STD, RESNET_TOL, SWIN_MICRO,
                                       check_both, flat_state, models, randomized)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NUM_CLASSES, IMG, BATCH, STEPS = 10, 32, 8, 3
CASES = [("resnet", 1, None), ("resnet", 2, 0.5), ("swin", 1, None), ("swin", 2, None)]


# ---------------------------------------------------------------------------
# Three steps against hvt on cpu_mesh(2)
# ---------------------------------------------------------------------------


def _case(index):
    family, accum, rho = CASES[index]
    model_kw = {"bn_pallas": True} if family == "resnet" else {**SWIN_MICRO, "fuse": True}
    settings = {"grad_accum": accum, **({"sam_rho": rho} if rho else {})}
    rng = np.random.default_rng(500 + index)
    batches = [(rng.integers(0, 256, size=(BATCH, IMG, IMG, 3), dtype=np.uint8),
                rng.integers(0, NUM_CLASSES, size=BATCH).astype(np.int32),
                np.ones(BATCH, np.float32)) for _ in range(STEPS)]
    _, _, shapes = models(family, model_kw)
    variables = randomized(shapes, 600 + index, family)
    return {"family": family, "model_kw": model_kw, "settings": settings, "img": IMG,
            "batches": batches, "lr": LR["swin"], "mean_std": MEAN_STD,  # adamw's 1e-3
            "optim": ("adamw", 0.05),
            "variables": variables,
            "state": {k: np.asarray(v) for k, v in flat_state(family, variables).items()}}


def _hvt_steps(case):
    family = case["family"]
    kw = dict(case["model_kw"])
    jm, _, _ = models(family, kw)
    name, wd = case["optim"]
    optim_cfg = type("Optim", (), dict(name=name, lr=case["lr"], weight_decay=wd, momentum=0.9))
    tx = joptim.build_optimizer(optim_cfg, jschedule.cosine_with_warmup(1, 10), grad_clip_norm=5.0,
                                no_decay_substrings=getattr(jm, "no_weight_decay_substrings", ()))
    prep = jdevice.DevicePrep(mean=MEAN_STD[0], std=MEAN_STD[1], compute_dtype=jnp.float32)
    train = jstep.build_train_step(jm, jobjectives.soft_cross_entropy, tx, prep,
                                   jstep.StepSettings(num_classes=NUM_CLASSES, smoothing=0.1,
                                                      **case["settings"]))
    variables = case["variables"]
    mesh = jparallel.cpu_mesh(2)
    jparallel.set_kernel_mesh(mesh)
    try:
        params = jax.tree.map(jnp.asarray, variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=jax.tree.map(jnp.asarray, variables.get("batch_stats", {})),
                           opt_state=tx.init(params))
        state = jax.device_put(state, jparallel.replicated(mesh))
        out = {"stats": []}
        for images, labels, mask in case["batches"]:
            sharded = [jax.device_put(jnp.asarray(a), jparallel.batch_sharding(mesh))
                       for a in (images, labels, mask)]
            state, stats = train(state, *sharded, jax.random.key(0), scale=1.0)
            out["stats"].append({k: float(v) for k, v in stats.items()})
        out["state"] = flat_state(family, {"params": state.params,
                                           "batch_stats": state.batch_stats})
    finally:
        jparallel.set_kernel_mesh(None)
    return out


@pytest.mark.parametrize("index", range(len(CASES)),
                         ids=[f"{f}-accum{a}{'-sam' if r else ''}" for f, a, r in CASES])
def test_three_steps_on_two_ranks_match_hvt_on_a_two_device_mesh(tmp_path_factory, index):
    family = CASES[index][0]
    case = _case(index)
    ranks = torch_ddp_worker.Shared(f"train-steps-{index}", "train_steps", 2, tmp_path_factory,
                                    lambda: [{k: v for k, v in case.items() if k != "variables"}])
    ref = _hvt_steps(case)  # while the ranks run
    _, results = ranks.get()
    results = [r[0] for r in results]
    got = [{"stats": r["stats"], "state": {k: v.numpy() for k, v in r["state"].items()}}
           for r in results]
    if family == "resnet":  # f32 throughout: the state within RESNET_TOL, running statistics too
        check_both(family, ref, got[0], RESNET_TOL, steps=STEPS)
    else:
        check_both(family, ref, got[0], FUSED_TOL, fused=True, steps=STEPS)
    assert got[1]["stats"] == got[0]["stats"]  # every rank returns the global stats
    for name, t in results[0]["state"].items():
        assert torch.equal(t, results[1]["state"][name]), name


# ---------------------------------------------------------------------------
# The Trainer on two ranks
# ---------------------------------------------------------------------------


def _layer(save_root, run_name, **change):
    layer = {
        "run_name": run_name, "seed": 5, "max_duration": "4ba", "grad_accum": 1,
        "eval_interval": "2ba", "machine": {"save_root": str(save_root)},
        "model": {"name": "resnet_micro_bottleneck", "args": {"bn_pallas": True}},
        "train_dataset": {"source": "synthetic", "crop_size": IMG, "synthetic_num_classes": NUM_CLASSES,
                          "synthetic_num_samples": 48, "global_batch_size": BATCH,
                          "shuffle": True, "drop_last": True},
        "eval_dataset": {"source": "synthetic", "crop_size": IMG, "synthetic_num_classes": NUM_CLASSES,
                         "synthetic_num_samples": 10, "global_batch_size": 4},
        "optim": {"name": "DecoupledSGDW", "lr": 0.2, "momentum": 0.875, "weight_decay": 5e-4},
        "scheduler": {"args": {"t_warmup": "1ba"}},
        "precision": {"compute_dtype": "float32"},
        "save": {"interval": "2ba", "num_checkpoints_to_keep": 3, "wandb": False},
        "loader": {"num_workers": 1, "prefetch_batches": 1},
        "algorithms": [{"cls": "EMA", "args": {"half_life": "2ba", "update_interval": "1ba"}},
                       {"cls": "LabelSmoothing", "args": {"smoothing": 0.08}}],
    }
    layer.update(change)
    return layer


DRAWS = [{"cls": "MixUp", "args": {"alpha": 0.2}}, {"cls": "CutMix", "args": {"alpha": 1.0}},
         {"cls": "SAM", "args": {"rho": 0.5, "interval": 2}},
         {"cls": "LabelSmoothing", "args": {"smoothing": 0.08}}]


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    root = root / "ddp-trainer-runs"
    straight = _layer(root / "straight", "draws", grad_accum=2, algorithms=DRAWS,
                      max_duration="3ba",
                      model={"name": "resnet_micro_bottleneck",
                             "args": {"bn_pallas": True, "stochastic_depth_rate": 0.3}})
    ckpt = root / "straight" / "draws" / "checkpoints"
    resumed = {**straight, "load_path": f"ckpt://{ckpt}:2",
               "machine": {"save_root": str(root / "resumed")}}
    plain = _layer(root / "two", "plain", max_duration="2ba", eval_interval="1ba",
                   save={"interval": "1ba", "num_checkpoints_to_keep": 3, "wandb": False})
    layers = [plain, straight, resumed]
    return torch_ddp_worker.Shared("trainer-2", "trainer", 2, tmp_path_factory, lambda: layers)


def _rel(got, ref, tol, what):
    assert abs(got - ref) <= tol * max(abs(ref), 1e-12), f"{what}: {got} against {ref}"


def test_trainer_on_two_ranks_matches_one_process(trainers, tmp_path):
    layers = trainers.make_inputs()
    one = tloop.Trainer(tconfig.loads({**layers[0], "machine": {"save_root": str(tmp_path)}}),
                        device="cpu", log_interval=1)
    records = {}
    try:
        eval_metrics = one.fit(on_step=lambda s, st: records.setdefault(
            s, {k: float(v) for k, v in st.items()}))
        state = {k: v.detach().clone() for k, v in one.model.state_dict().items()}
    finally:
        one.close()
    _, results = trainers.get()
    for rank, r in enumerate(results):
        got = r[0]
        assert (got["world"], got["rank"]) == (2, rank)
        assert got["steps"].keys() == records.keys() == {1, 2}
        for s, ref in records.items():
            for k in ("loss_sum", "ce_sum", "grad_norm"):
                _rel(got["steps"][s][k], ref[k], 1e-5, f"{k}, step {s}, rank {rank}")
            for k in ("correct@1", "correct@5", "count"):
                assert got["steps"][s][k] == ref[k], (k, s, rank)
        for k, v in eval_metrics.items():
            _rel(got["eval"][k], v, 1e-5, f"eval {k}, rank {rank}")
        for name, ref in state.items():
            err = (got["state"][name].double() - ref.double()).abs().max().item()
            assert err <= 1e-5 * max(ref.double().abs().max().item(), 1e-12), name


def test_rank_zero_alone_saves_and_every_rank_logs(trainers):
    layers, results = trainers.get()
    # steps 1 and 2, and the final state at 2 again, from rank 0 alone
    assert [r[0]["saves"] for r in results] == [3, 0]
    run = pathlib.Path(layers[0]["machine"]["save_root"]) / "plain"
    assert sorted(p.name for p in (run / "checkpoints").iterdir()) == ["1", "2"]
    for rank in (0, 1):
        lines = (run / "logs" / f"log{rank}.txt").read_text().splitlines()
        records = [json.loads(x) for x in lines if x.startswith("{")]
        assert [r["step"] for r in records if "eval/acc@1" in r] == [0, 1, 2]
    saved = torch.load(run / "checkpoints" / "2" / "state.pt", weights_only=True)
    for name, t in results[0][0]["state"].items():
        assert torch.equal(saved["params"].get(name, saved["batch_stats"].get(name)), t), name


def test_resume_on_two_ranks_is_bit_equal(trainers):
    _, results = trainers.get()
    for rank, r in enumerate(results):
        straight, resumed = r[1], r[2]
        assert resumed["resumed_at"] == 2 and straight["steps"].keys() == {1, 2, 3}
        assert torch.equal(straight["rng"], resumed["rng"]), rank
        for name, t in straight["state"].items():
            assert torch.equal(t, resumed["state"][name]), (rank, name)
        for s in (3,):
            assert straight["steps"][s] == resumed["steps"][s], (rank, s)


def test_torchrun_trains_evaluates_and_checkpoints(tmp_path):
    layer = _layer(tmp_path, "cli", max_duration="1ba", eval_interval="1ep",
                   save={"interval": None, "num_checkpoints_to_keep": 1, "wandb": False})
    (tmp_path / "layer.json").write_text(json.dumps(layer))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "hvt_torch.main", "--machine", "configs/machines/local.yaml", "--exp",
         str(tmp_path / "layer.json"), "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert "[cli] data parallel: rank 0 of world 2 (gloo), local batch 4 of 8" in lines
    metrics = [json.loads(x) for x in lines if x.startswith('{"acc@1"')]
    assert len(metrics) == 1 and np.isfinite(list(metrics[0].values())).all()
    assert not any("rank 1" in x for x in lines)  # rank 1 prints nothing of the run
    run = tmp_path / "cli"
    assert [p.name for p in (run / "checkpoints").iterdir()] == ["1"]
    assert sorted(p.name for p in (run / "logs").iterdir()) == ["log0.txt", "log1.txt"]
