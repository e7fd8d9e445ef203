"""The port's data parallelism against hvt's, on the CPU: its pieces.

Each world is one gloo process group of spawned ranks on one torch thread
(``tests/torch_ddp_worker.py``, the ranks' code in ``tests/torch_ddp_jobs.py``),
one spawn for each world size of this file in a test session (shared by
the xdist workers, ``torch_ddp_worker.Shared``): W = 2 (``bn_train``, the four
BatchNorm modules, the draws), W = 3 (``bn_train``) and W = 4 (the modules).
Each rank takes its contiguous share of a seeded global batch; hvt's side
runs the global batch in this process, sharded over ``parallel.cpu_mesh(W)``
(conftest gives 8 CPU devices):

* ``bn_train``'s data-parallel route (the rank's partial sums, an
  all-reduce, the finish on the global n), f32 and bf16, against hvt's ``bn_train`` with its
  Pallas kernels in interpret mode under ``set_kernel_mesh(cpu_mesh(W))``,
  hvt's own psum form. y, mean and var within 1e-5·max|ref| in f32, the
  gradients within 1e-4·max|ref| (three cancelling terms of dy's size, as
  ``test_torch_port_bn_stats.py`` holds them); bf16 y and dx within
  1e-2·max|ref| (an ulp of bf16 at the largest value, 2^-7, beside the f32
  bound). dscale and dbias are the global sums on rank 0 and zeros on the
  others, added up here as the train step's gradient all-reduce adds them.
* ``BatchNorm``, ``PallasBatchNorm``, ``CustomBatchNorm`` and
  ``GroupedBatchNorm`` (G = 1, 2, 4; at W = 4 and G = 2 each group spans two
  ranks; G = 2 once more on channels whose mean is 100 times their std,
  where only a two-pass variance as hvt's keeps its digits) against hvt's
  ``make_batch_norm`` modules jitted on the sharded global batch, in f32: y and the running statistics within 1e-5·max|ref|,
  dx, dscale and dbias within 1e-4·max|ref|. Every rank's running
  statistics are equal.
* MixUp, CutMix, device RandAugment (stratified and iid), ColOut and a
  drop-path mask on each rank's rows against one process on the whole
  global microbatch from the same generator seed: bit-equal, with the
  generators equal after.

In this process only: the loader's row plan against hvt's ``Loader`` for
W ∈ {1, 2, 3, 4} and accumulation ∈ {1, 2, 4}; each ``mesh`` field off its
default, and ``data`` other than the world, refused before any weight
moves; each downstream entry point refusing a world above 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ddp_worker
from hvt import parallel as jparallel
from hvt.data import loader as jloader
from hvt.data import synthetic as jsynthetic
from hvt.models import resnet as jresnet
from hvt.ops import bn_stats_pallas as jbn
from hvt_torch import config as tconfig
from hvt_torch import parallel
from hvt_torch.data import loader as tloader
from hvt_torch.data import synthetic as tsynthetic
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

F32_TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 1e-2
BN_C = 16  # hvt folds 8 rows into its 128 lanes; 64 rows a rank keep the Pallas route
MOD_SHAPE = (8, 4, 4, BN_C)  # the modules' global NHWC batch


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _np(t):
    return t.detach().float().numpy()


def _cat(results, key):
    return np.concatenate([_np(r[key]) for r in results])


def _sum(results, key):
    return np.sum([_np(r[key]) for r in results], axis=0)


# ---------------------------------------------------------------------------
# Inputs and the spawned worlds
# ---------------------------------------------------------------------------


def _bn_train_cases(world):
    out = []
    for i, dtype in enumerate(("float32", "bfloat16")):
        rng = np.random.default_rng(10 * world + i)
        m = 64 * world
        out.append({"dtype": dtype, "x": (rng.normal(size=(m, BN_C)) * 2.0 + 0.5).astype(np.float32),
                    "dy": rng.normal(size=(m, BN_C)).astype(np.float32),
                    "scale": rng.uniform(0.5, 1.5, size=BN_C).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=BN_C)).astype(np.float32)})
    return out


# (kind, groups, the channels' mean in units of their std): the last case's
# mean of 100 std would lose its variance's digits to E[x²] − E[x]² in f32
MODULE_KINDS = [("batchnorm", 1, 0.5), ("pallas", 1, 0.5), ("custom", 1, 0.5),
                ("grouped", 2, 0.5), ("grouped", 4, 0.5), ("grouped", 2, 100.0)]
MODULE_IDS = [f"{k}{g}" + ("" if mu == 0.5 else f"-mean{mu:g}std")
              for k, g, mu in MODULE_KINDS]


def _module_cases(world):
    out = []
    for i, (kind, groups, mu) in enumerate(MODULE_KINDS):
        rng = np.random.default_rng(100 * world + i)
        out.append({"kind": kind, "groups": groups, "dtype": "float32",
                    "x": (rng.normal(size=MOD_SHAPE) + mu).astype(np.float32),
                    "dy": rng.normal(size=MOD_SHAPE).astype(np.float32),
                    "weight": rng.uniform(0.5, 1.5, size=BN_C).astype(np.float32),
                    "bias": (0.1 * rng.normal(size=BN_C)).astype(np.float32),
                    "mean": (0.1 * rng.normal(size=BN_C)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, size=BN_C).astype(np.float32)})
    return out


AUGMENT_SETTINGS = [
    dict(num_classes=10, smoothing=0.1, mixup_alpha=0.2, cutmix_alpha=1.0),
    dict(num_classes=(3, 10), mixup_alpha=0.4),  # multitask targets roll too
    dict(num_classes=10, randaugment=(1, 9, True), colout=(0.25, 0.25)),
    dict(num_classes=10, randaugment=(2, 5, False), cutmix_alpha=1.0),
]


def _augment_cases():
    out = []
    for i, settings in enumerate(AUGMENT_SETTINGS):
        rng = np.random.default_rng(300 + i)
        tiers = len(settings["num_classes"]) if isinstance(settings["num_classes"], tuple) else 0
        labels = rng.integers(0, 3, size=(16, tiers) if tiers else 16).astype(np.int64)
        out.append({"settings": settings, "seed": 40 + i,
                    "images": rng.integers(0, 256, size=(16, 16, 16, 3), dtype=np.uint8),
                    "labels": labels})
    return out


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return torch_ddp_worker.Shared(
        "ops-2", "ops", 2, tmp_path_factory,
        lambda: {"bn_train": _bn_train_cases(2), "modules": _module_cases(2),
                 "augment": _augment_cases()})


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    return torch_ddp_worker.Shared("ops-3", "ops", 3, tmp_path_factory,
                                   lambda: {"bn_train": _bn_train_cases(3)})


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return torch_ddp_worker.Shared("ops-4", "ops", 4, tmp_path_factory,
                                   lambda: {"modules": _module_cases(4)})


# ---------------------------------------------------------------------------
# hvt's side
# ---------------------------------------------------------------------------


def _on_mesh(world, fn, *global_args):
    """``fn`` jitted on the global arrays, each sharded over the data axis
    of ``cpu_mesh(world)``, with that mesh declared to hvt's kernels."""
    mesh = jparallel.cpu_mesh(world)
    jparallel.set_kernel_mesh(mesh)
    try:
        args = [jax.device_put(a, jparallel.batch_sharding(mesh)) for a in global_args]
        return jax.tree.map(np.asarray, jax.jit(fn)(*args))
    finally:
        jparallel.set_kernel_mesh(None)


def _hvt_bn_train(case, world):
    dtype = jnp.float32 if case["dtype"] == "float32" else jnp.bfloat16
    scale, bias = jnp.asarray(case["scale"]), jnp.asarray(case["bias"])

    def fn(x, dy):
        def f(x, s, b):
            return jbn.bn_train(x, s, b, 1e-5, dtype, True, True)  # Pallas, interpret mode

        (y, mean, var), vjp = jax.vjp(f, x, scale, bias)
        dx, ds, db = vjp((dy, jnp.zeros_like(mean), jnp.zeros_like(var)))
        return {"y": y.astype(jnp.float32), "mean": mean, "var": var,
                "dx": dx.astype(jnp.float32), "dscale": ds, "dbias": db}

    return _on_mesh(world, fn, jnp.asarray(case["x"], dtype), jnp.asarray(case["dy"], dtype))


def _hvt_module(case, world):
    kind, groups = case["kind"], case["groups"]
    module = jresnet.make_batch_norm(True, jnp.float32, jax.nn.initializers.ones,
                                     bn_groups=groups if kind == "grouped" else 1,
                                     bn_pallas=kind == "pallas", bn_custom=kind == "custom")
    params = {"scale": jnp.asarray(case["weight"]), "bias": jnp.asarray(case["bias"])}
    stats = {"mean": jnp.asarray(case["mean"]), "var": jnp.asarray(case["var"])}

    def fn(x, dy):
        def f(x, p):
            y, new = module.apply({"params": p, "batch_stats": stats}, x,
                                  mutable=["batch_stats"])
            return y, new["batch_stats"]

        (y, new), vjp = jax.vjp(f, x, params)
        dx, dp = vjp((dy, jax.tree.map(jnp.zeros_like, new)))
        return {"y": y, "dx": dx, "dscale": dp["scale"], "dbias": dp["bias"],
                "running_mean": new["mean"], "running_var": new["var"]}

    return _on_mesh(world, fn, jnp.asarray(case["x"]), jnp.asarray(case["dy"]))


# ---------------------------------------------------------------------------
# bn_train and the modules
# ---------------------------------------------------------------------------


def _check_bn_train(shared, world):
    cases = _bn_train_cases(world)
    refs = [_hvt_bn_train(case, world) for case in cases]  # while the ranks run
    _, results = shared.get()
    for i, (case, ref) in enumerate(zip(cases, refs)):
        got = [r["bn_train"][i] for r in results]
        out_tol = F32_TOL if case["dtype"] == "float32" else BF16_TOL
        dx_tol = GRAD_TOL if case["dtype"] == "float32" else BF16_TOL
        what = f"W={world} {case['dtype']}"
        _close(_cat(got, "y"), ref["y"], out_tol, f"y, {what}")
        _close(_cat(got, "dx"), ref["dx"], dx_tol, f"dx, {what}")
        for k in ("mean", "var"):
            for r in got:  # every rank holds the global moments
                _close(_np(r[k]), ref[k], F32_TOL, f"{k}, {what}")
        _close(_sum(got, "dscale"), ref["dscale"], GRAD_TOL, f"dscale, {what}")
        _close(_sum(got, "dbias"), ref["dbias"], GRAD_TOL, f"dbias, {what}")


def test_bn_train_data_parallel_matches_hvt_at_two_ranks(world2):
    _check_bn_train(world2, 2)


def test_bn_train_data_parallel_matches_hvt_at_three_ranks(world3):
    _check_bn_train(world3, 3)


def _check_module(shared, world, index):
    case = _module_cases(world)[index]
    ref = _hvt_module(case, world)  # while the ranks run
    _, results = shared.get()
    got = [r["modules"][index] for r in results]
    what = f"{case['kind']} G={case['groups']} W={world}"
    _close(_cat(got, "y"), ref["y"], F32_TOL, f"y, {what}")
    _close(_cat(got, "dx"), ref["dx"], GRAD_TOL, f"dx, {what}")
    _close(_sum(got, "dscale"), ref["dscale"], GRAD_TOL, f"dscale, {what}")
    _close(_sum(got, "dbias"), ref["dbias"], GRAD_TOL, f"dbias, {what}")
    for k in ("running_mean", "running_var"):
        _close(_np(got[0][k]), ref[k], F32_TOL, f"{k}, {what}")
        for r in got[1:]:
            assert torch.equal(r[k], got[0][k]), f"{k} differs between ranks, {what}"


@pytest.mark.parametrize("index", range(len(MODULE_KINDS)), ids=MODULE_IDS)
def test_batchnorm_modules_match_hvt_at_two_ranks(world2, index):
    _check_module(world2, 2, index)


@pytest.mark.parametrize("index", range(len(MODULE_KINDS)), ids=MODULE_IDS)
def test_batchnorm_modules_match_hvt_at_four_ranks(world4, index):
    _check_module(world4, 4, index)


# ---------------------------------------------------------------------------
# Draws over the global microbatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("index", range(len(AUGMENT_SETTINGS)))
def test_draws_over_the_global_microbatch_equal_one_process(world2, index):
    _, results = world2.get()
    for rank, r in enumerate(results):
        case = r["augment"][index]
        for key in ("x", "drop_path", "generator"):
            got, ref = case[key]
            assert torch.equal(got, ref), f"{key}, rank {rank}"
        got, ref = case["targets"]
        for g, t in zip(got if isinstance(got, list) else [got],
                        ref if isinstance(ref, list) else [ref]):
            assert torch.equal(g, t), f"targets, rank {rank}"
    # the draws did something: ranks' rows differ from an unaugmented batch
    assert not torch.equal(results[0]["augment"][index]["x"][0],
                           results[1]["augment"][index]["x"][0])


# ---------------------------------------------------------------------------
# The loader's row plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("accum", [1, 2, 4])
def test_loader_rows_are_hvts_global_microbatches(world, accum):
    local = 4
    n = 2 * world * local + 3  # two steps and a tail that drop_last drops
    jset = jsynthetic.build_synthetic(num_samples=n, num_leaf_classes=5, crop_size=8, seed=1)
    tset = tsynthetic.build_synthetic(num_samples=n, num_leaf_classes=5, crop_size=8, seed=1)
    for epoch in (0, 1):
        hvt_local = [jloader.Loader(jset, None, local, shuffle=True, drop_last=True, seed=7,
                                    process_index=q, process_count=world).epoch_indices(epoch)
                     for q in range(world)]
        steps = len(hvt_local[0]) // local
        seen = []
        for rank in range(world):
            port = tloader.Loader(tset, None, local, shuffle=True, drop_last=True, seed=7,
                                  process_index=rank, process_count=world, microbatches=accum)
            assert port.batches_per_epoch == steps
            batches = port.epoch_batches(epoch)
            share = local // accum
            for s in range(steps):
                hvt_global = np.concatenate([h[s * local:(s + 1) * local] for h in hvt_local])
                mb = hvt_global.size // accum
                for i in range(accum):
                    got = batches[s, i * share:(i + 1) * share]
                    want = hvt_global[i * mb + rank * share:i * mb + (rank + 1) * share]
                    np.testing.assert_array_equal(got, want)
            seen.append(port.epoch_indices(epoch))
        seen = np.concatenate(seen)
        assert len(np.unique(seen)) == len(seen) == steps * local * world  # each sample once
    # one rank's decoded batch holds the images and labels of its rows
    port = tloader.Loader(tset, None, local, shuffle=True, drop_last=True, seed=7,
                          process_index=world - 1, process_count=world, microbatches=accum)
    batch = next(iter(port.epoch(1)))
    rows = port.epoch_batches(1)[0]
    np.testing.assert_array_equal(batch.indices, rows)
    np.testing.assert_array_equal(batch.labels, tset.labels[rows])
    np.testing.assert_array_equal(batch.images[0], tset.load(int(rows[0])))


def test_eval_loader_pads_every_rank_to_the_same_batches():
    """hvt's eval split per process, ``order[rank::world]``, with a padded
    tail; a rank with fewer samples pads to the same number of batches."""
    tset = tsynthetic.build_synthetic(num_samples=9, num_leaf_classes=5, crop_size=8, seed=1)
    jset = jsynthetic.build_synthetic(num_samples=9, num_leaf_classes=5, crop_size=8, seed=1)
    loaders = [tloader.Loader(tset, None, 2, process_index=r, process_count=4) for r in range(4)]
    assert [lo.batches_per_epoch for lo in loaders] == [2] * 4
    for r, lo in enumerate(loaders):
        ref = jloader.Loader(jset, None, 2, process_index=r, process_count=4).epoch_indices(0)
        np.testing.assert_array_equal(lo.epoch_indices(0), ref)
        masks = [b.mask for b in lo.epoch(0)]
        assert float(np.sum(masks)) == len(ref)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


def _layer(tmp_path, **change):
    layer = {"run_name": "ddp_refuse", "max_duration": "1ba",
             "machine": {"save_root": str(tmp_path)},
             "model": {"name": "resnet_micro_bottleneck", "args": {}},
             "train_dataset": {"source": "synthetic", "crop_size": 16, "synthetic_num_classes": 4,
                               "synthetic_num_samples": 8, "global_batch_size": 4},
             "eval_dataset": {"source": "synthetic", "crop_size": 16, "synthetic_num_classes": 4,
                              "synthetic_num_samples": 4, "global_batch_size": 4}}
    layer.update(change)
    return layer


@pytest.mark.parametrize("mesh,error", [
    ({"model": 2}, NotImplementedError), ({"spatial": 2}, NotImplementedError),
    ({"pipe": 2}, NotImplementedError), ({"zero": True}, NotImplementedError),
    ({"data": 2}, ValueError),  # a world of one process
])
def test_trainer_refuses_unported_mesh_before_weights_move(tmp_path, monkeypatch, mesh, error):
    from hvt_torch.train import loop as tloop

    def moved(*a, **k):
        raise AssertionError("the refusal came after the loaders or the model were built")

    monkeypatch.setattr(tloop, "build_model", moved)
    monkeypatch.setattr(tloop, "build_loader", moved)
    with pytest.raises(error, match="queue 1, item 11"):
        tloop.Trainer(tconfig.loads(_layer(tmp_path, mesh=mesh)), device="cpu")
    # data: -1 and the world's own size are what one process runs
    assert parallel.check_mesh(tconfig.loads(_layer(tmp_path, mesh={"data": 1})).mesh, 1) == 1
    assert parallel.check_mesh(tconfig.loads(_layer(tmp_path)).mesh, 3) == 3


def _downstream_entries():
    from hvt_torch import linear_probe, simpleshot
    from hvt_torch.downstream import features, predict, serve

    return {
        "linear_probe": lambda c: linear_probe.main(
            tconfig.loads({**c, "model": {**c["model"], "variant": "linear-probe"}}), "cpu"),
        "simpleshot": lambda c: simpleshot.main(
            tconfig.loads({**c, "model": {**c["model"], "variant": "simpleshot"}}), "cpu"),
        "features": lambda c: features.extract_features(tconfig.loads(c), True, "simpleshot",
                                                        device="cpu"),
        "predict": lambda c: predict.predict(tconfig.loads(c), device="cpu"),
        "serve": lambda c: serve.InferenceEngine(tconfig.loads(c), device="cpu"),
    }


@pytest.mark.parametrize("entry", ["linear_probe", "simpleshot", "features", "predict", "serve"])
def test_downstream_entry_points_refuse_a_world_above_one(tmp_path, monkeypatch, entry):
    """Started by a launcher with a world of 2 (its environment), each
    refuses before it builds anything; so does a mesh off one process."""
    run = _downstream_entries()[entry]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    with pytest.raises(NotImplementedError, match="queue 1, item 11"):
        run(_layer(tmp_path))
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("RANK")
    with pytest.raises(NotImplementedError, match="queue 1, item 11"):
        run(_layer(tmp_path, mesh={"model": 2}))
