"""The Switch-MoE under the port's grid (data parallelism, expert
parallelism over ``mesh.model``, ZeRO-1) against hvt's, on the CPU.

Gloo worlds of spawned ranks on one torch thread each
(``tests/torch_ddp_worker.py``; the ranks run ``torch_ddp_jobs.grid_steps``
and ``grid_trainers``), one spawn a world a test session: W = 2 and W = 4
for the train steps, W = 2 for the Trainers. Rank r has data index r //
model and model index r % model (hvt's ``make_mesh`` order).

* Three steps of hvt's ``build_train_step`` jitted on ``cpu_mesh(W,
  model=m)`` with hvt's ``tp_shardings`` (what hvt's Trainer does on that
  mesh) against the port's step on W ranks, from the same seeded flax
  variables, on the model of hvt's ``tests/test_moe.py:91-135``
  (``swinv2_micro`` in f32, 2 experts in every block): data 2 (each rank's
  aux loss at its share of the global microbatch's images; a wrong share
  trains apart), data 2 with ``grad_accum: 2`` on ``fuse: true`` (MoE on
  stage 1, the dense stage on the fused halves), model 2 alone (each rank
  holds one expert of each block), and data 2 × model 2 on both routes.
  Tolerances are ``test_torch_port_accum_sam.py``'s (``UNFUSED_TOL``,
  ``FUSED_TOL``, parameters after Adam by ``_close_after_adam``), as
  ``test_torch_port_tp_zero.py`` holds its grid steps.
* Each rank holds E / model experts of each MoE block; model peers hold the
  same router (replicated, its gradient equal on every peer) and data
  peers the same state; every rank reports the same global stats. Each
  MoE block's step makes three model-group all-reduces (the combined
  output forward; the tokens' and the gate's gradients backward), and the
  clipping's norm one.
* ZeRO-1 with MoE at model 1 equals data parallelism bit for bit, and the
  expert leaves' moments stay whole (hvt's rule spec wins over ``zero``),
  while other leaves are split.
* A checkpoint written by a Trainer at ``model: 2`` restores on ``data:
  2`` (``model: 1``) and saves the same tensors.
"""

import pathlib

import numpy as np
import pytest
import torch

import torch_ddp_worker
from hvt_torch import parallel
from test_torch_port_accum_sam import MEAN_STD
from test_torch_port_accum_sam import randomized as swin_randomized
from test_torch_port_tp_zero import (IMG, LR, _check_against_hvt, _equal_trees, _flat,
                                     _flax_model, _full_state, _hvt_steps, _shapes)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

BATCH, STEPS = 8, 3
MOE = {"drop_path_rate": 0.0, "moe_experts": 2, "moe_from_stage": 0, "moe_every": 1}
FUSED_MOE = {**MOE, "moe_from_stage": 1, "fuse": True}

# (id, world, model args, model axis, zero, step settings)
CASES = [
    ("w2-moe-dp", 2, {**MOE, "fuse": False}, 1, False, {}),
    ("w2-moe-zero", 2, {**MOE, "fuse": False}, 1, True, {}),
    ("w2-moe-dp-fused-accum2", 2, FUSED_MOE, 1, False, {"grad_accum": 2}),
    ("w2-moe-ep", 2, {**MOE, "fuse": False}, 2, False, {}),
    ("w4-moe-ep", 4, {**MOE, "fuse": False}, 2, False, {}),
    ("w4-moe-ep-fused", 4, FUSED_MOE, 2, False, {}),
]
IDS = [c[0] for c in CASES]
TWINS = {"w2-moe-zero": "w2-moe-dp"}  # the ZeRO case and the case it equals bit for bit
NAME = "swinv2_micro"


def _case(index):
    key, world, args, model, zero, settings = CASES[index]
    index = IDS.index(TWINS.get(key, key))  # a ZeRO case draws its twin's weights and batches
    variables = swin_randomized(_shapes(_flax_model(NAME, args)), 900 + index, "swin")
    rng = np.random.default_rng(950 + index)
    batches = [(rng.integers(0, 256, size=(BATCH, IMG, IMG, 3), dtype=np.uint8),
                rng.integers(0, 10, size=BATCH).astype(np.int32),
                np.ones(BATCH, np.float32)) for _ in range(STEPS)]
    return {"key": key, "name": NAME, "args": args, "img": IMG, "model": model, "zero": zero,
            "settings": settings, "batches": batches, "lr": LR, "optim": ("adamw", 0.05),
            "mean_std": MEAN_STD, "variables": variables,
            "state": {k: np.asarray(v) for k, v in _flat(NAME, variables).items()}}


def _rank_inputs(world):
    return [{k: v for k, v in _case(i).items() if k != "variables"}
            for i, c in enumerate(CASES) if c[1] == world]


def _shared(key, world, tmp_path_factory):
    return torch_ddp_worker.Shared(key, "grid_steps", world, tmp_path_factory,
                                   lambda: _rank_inputs(world), timeout=420.0)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _shared("moe-steps-2", 2, tmp_path_factory)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _shared("moe-steps-4", 4, tmp_path_factory)


def _results(shared, key):
    inputs, results = shared.get()
    at = [c["key"] for c in inputs].index(key)
    return [r[at] for r in results]


def _moe_blocks(state):
    return sorted({n.rsplit(".moe.", 1)[0] for n in state if ".moe." in n})


def _hvt_cases(world):
    return [i for i, c in enumerate(CASES) if c[0] not in TWINS and c[1] == world]


# One world a test: a test that asked for both could wait on the world that
# another worker owns while that worker waits on the one it owns.
@pytest.mark.parametrize("index", _hvt_cases(2), ids=[IDS[i] for i in _hvt_cases(2)])
def test_moe_grid_steps_match_hvt_on_two_ranks(world2, index):
    _held_against_hvt(world2, index)


@pytest.mark.parametrize("index", _hvt_cases(4), ids=[IDS[i] for i in _hvt_cases(4)])
def test_moe_grid_steps_match_hvt_on_four_ranks(world4, index):
    _held_against_hvt(world4, index)


def _held_against_hvt(shared, index):
    _, world, args, model, _, settings = CASES[index]
    case = _case(index)
    ref = _hvt_steps(case, world)  # while the ranks run
    results = _results(shared, case["key"])
    data = world // model
    full = case["state"]
    blocks = _moe_blocks(full)
    assert blocks
    for rank, r in enumerate(results):
        assert r["grid"] == (rank // model, data, rank % model)
        assert r["stats"] == results[0]["stats"]  # every rank returns the global stats
        for b in blocks:  # E / model experts a rank, the router whole
            for n in ("w1", "b1", "w2", "b2"):
                assert r["state"][f"{b}.moe.{n}"].shape[0] == 2 // model
            assert tuple(r["state"][f"{b}.moe.router"].shape) == full[f"{b}.moe.router"].shape
    _check_against_hvt(case, ref, {"stats": results[0]["stats"],
                                   "state": _full_state(results, model)})
    for rank, r in enumerate(results):  # data peers equal; model peers share what is replicated
        for name, t in r["state"].items():
            assert torch.equal(t, results[rank % model]["state"][name]), (rank, name)
            if parallel.tp_rule(name) is None or model == 1:
                assert torch.equal(t, results[0]["state"][name]), (rank, name)
    if model > 1:  # per MoE block a step: the output forward, the tokens' and gate's backward
        moe_blocks = len(blocks)
        accum = settings.get("grad_accum", 1)
        want = STEPS * (3 * moe_blocks * accum + 1)  # and the clipping's norm
        assert all(r["collectives"]["model_all_reduce"] == want for r in results), (
            [r["collectives"] for r in results], want)


def test_zero_with_moe_equals_data_parallelism_and_keeps_expert_moments_whole(world2):
    zero, plain = _results(world2, "w2-moe-zero"), _results(world2, "w2-moe-dp")
    case = next(c for c in world2.get()[0] if c["key"] == "w2-moe-zero")
    full = case["state"]
    for a, b in zip(zero, plain):
        assert a["stats"] == b["stats"]
        for name, t in a["state"].items():
            assert torch.equal(t, b["state"][name]), name
        for index, moments in a["opt_full"]["state"].items():
            for k, v in moments.items():
                assert torch.equal(v, b["opt_full"]["state"][index][k]), (index, k)
        split = whole = 0
        for n, moments in a["opt_local"].items():
            for shape in moments.values():
                if parallel.tp_rule(n) is not None:  # an expert leaf: whole at model 1
                    assert list(shape) == list(full[n].shape), (n, shape)
                    whole += 1
                elif list(shape) != list(full[n].shape):
                    split += 1
        assert whole > 0 and split > 0


# ---------------------------------------------------------------------------
# A checkpoint written at model 2, restored at model 1
# ---------------------------------------------------------------------------


def _layer(root, tag, mesh, **change):
    layer = {
        "run_name": "moe_grid", "seed": 3, "max_duration": "2ba", "grad_accum": 1,
        "eval_interval": "1dur", "machine": {"save_root": str(root / tag)}, "mesh": mesh,
        "model": {"name": NAME, "args": {**MOE, "fuse": False}},
        "train_dataset": {"source": "synthetic", "crop_size": IMG, "synthetic_num_classes": 10,
                          "synthetic_num_samples": 32, "global_batch_size": BATCH,
                          "shuffle": True, "drop_last": True},
        "eval_dataset": {"source": "synthetic", "crop_size": IMG, "synthetic_num_classes": 10,
                         "synthetic_num_samples": 8, "global_batch_size": 4},
        "optim": {"name": "AdamW", "lr": 1e-3, "weight_decay": 0.05},
        "scheduler": {"args": {"t_warmup": "1ba"}},
        "precision": {"compute_dtype": "float32"},
        "save": {"interval": "1ba", "num_checkpoints_to_keep": 3, "wandb": False},
        "loader": {"num_workers": 1, "prefetch_batches": 1},
        "algorithms": [{"cls": "EMA", "args": {"half_life": "2ba", "update_interval": "1ba"}}],
    }
    layer.update(change)
    return layer


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    import os

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    root = root / "moe-grid-trainer-runs"
    ckpt = f"ckpt://{root / 'ep' / 'moe_grid' / 'checkpoints'}:2"
    layers = [(_layer(root, "ep", {"model": 2}), "fit"),
              (_layer(root, "dp_from_ep", {}, load_path=ckpt), "save")]
    return torch_ddp_worker.Shared("moe-grid-trainer-2", "grid_trainers", 2, tmp_path_factory,
                                   lambda: layers, timeout=420.0)


def _saved(layer, step):
    path = pathlib.Path(layer["machine"]["save_root"]) / "moe_grid" / "checkpoints" / str(step)
    state = torch.load(path / "state.pt", weights_only=True)
    state.pop("config")
    return state


def test_expert_parallel_checkpoint_restores_at_model_1(trainers):
    layers, results = trainers.get()
    ep = _saved(layers[0][0], 2)
    _equal_trees(_saved(layers[1][0], 2), ep, "model 2 → model 1")
    params = ep["params"]
    w1 = next(n for n in params if n.endswith("moe.w1"))
    assert params[w1].shape[0] == 2  # the checkpoint holds every expert
    for rank, r in enumerate(results):
        assert r[0]["grid"] == (0, 1, 2, False) and r[1]["grid"] == (rank, 2, 1, False)
        assert torch.equal(r[0]["state"][w1], params[w1][rank:rank + 1])  # its expert
        assert r[0]["ema_shapes"][w1] == (1, *params[w1].shape[1:])  # the EMA copy mirrors it
        for name, t in r[1]["state"].items():  # the model-1 restore holds the full tensors
            assert torch.equal(t, params.get(name, ep["batch_stats"].get(name))), name
