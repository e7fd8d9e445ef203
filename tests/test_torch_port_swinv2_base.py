"""SwinV2-B's training path on ``fuse: true``, the port against hvt on the CPU.

* A small SwinV2 on ``fuse: true`` in train mode, routed as SwinV2-B's
  stage 4 is: embed 32, depths 2-2, heads 1-2 (head dim 32), window 7,
  56 px, with hvt's routing threshold at 4 MiB (hvt's ``HVT_FITS_VMEM_MB``,
  the port's ``FITS_THRESHOLD_BYTES``), where both stages' MLP halves take
  ``mlp_half_chunked`` in K = 2 and the attention halves stay fused. The
  same seeded flax tree and batches go through hvt's ``build_train_step``
  (its Pallas halves in interpret mode) and the port's train step (the
  plain versions): losses and the step-1 gradient norm within 2e-3
  relative, step-1 gradients within 5e-2·max|ref| per tensor and parameters
  after 3 adamw steps within 6·lr and a mean |Δ| of 0.1·lr per tensor: the
  fused route's tolerances of ``tests/test_torch_port_train.py``
  (``FUSED_TOL``), since both sides round every product's operands to bf16.
  With ``fuse_mlp_chunked: false`` both take the plain LayerNorm(MLP)
  instead, held the same way.
* ``swin_state_dict_from_flax`` maps a ``swinv2_base`` tree (shapes from
  ``jax.eval_shape``) onto the port's model leaf for leaf, shape for shape.
* ``grad_accum: "auto"``: the port's ``choose_grad_accum`` gives hvt's
  answers on a table of cases; a Trainer whose probe needs more than the
  card holds splits the batch and trains; on the CPU it resolves to 1; the
  probe leaves the parameters, buffers, optimizer and generator as it found
  them, and gradients the parameters already hold unchanged, to the bit.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hvt import objectives as jobjectives
from hvt.data import device as jdevice
from hvt.models import swinv2 as jswin
from hvt.ops import fused_halves_pallas as jfh
from hvt.train import microbatch as jmicrobatch
from hvt.train import optim as joptim
from hvt.train import schedule as jschedule
from hvt.train import step as jstep
from hvt.train.state import TrainState
from hvt_torch import config as tconfig
from hvt_torch import objectives as tobjectives
from hvt_torch.data import device as tdevice
from hvt_torch.models import convert
from hvt_torch.models import swinv2 as tswin
from hvt_torch.ops import fused_halves_cuda as fh
from hvt_torch.train import loop as tloop
from hvt_torch.train import microbatch as tmicrobatch
from hvt_torch.train import optim as toptim
from hvt_torch.train import schedule as tschedule
from hvt_torch.train import step as tstep
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GEOMETRY = dict(embed_dim=32, depths=(2, 2), num_heads=(1, 2), window_size=7)
IMAGE = 56
NUM_CLASSES = 10
THRESHOLD_MB = 4
TOL = {"loss": 2e-3, "norm": 2e-3, "grad": 5e-2}
LR = 1e-3


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _randomized(shapes, seed):
    """Every leaf drawn at a scale that keeps activations O(1) (LN scales
    around 1, so the zero-initialised res-post-norm hides no branch)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name == "scale":
            return 1.0 + 0.1 * rng.normal(size=shape)
        if name == "logit_scale":
            return np.log(10.0) + 0.3 * rng.normal(size=shape)
        if name in ("bias", "q_bias", "v_bias", "cpb_b1"):
            return 0.1 * rng.normal(size=shape)
        if name == "cpb_w1":
            return rng.normal(size=shape)
        return rng.normal(size=shape) / np.sqrt(int(np.prod(shape[:-1])))

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture
def chunked_budget(monkeypatch):
    monkeypatch.setenv("HVT_FITS_VMEM_MB", str(THRESHOLD_MB))
    monkeypatch.setattr(fh, "FITS_THRESHOLD_BYTES", THRESHOLD_MB * 2**20)


@pytest.mark.parametrize("chunked", [True, False])
def test_three_adamw_steps_on_the_chunked_route_match_hvt(chunked, chunked_budget, monkeypatch):
    for c, heads in ((32, 1), (64, 2)):  # both stages: MLP chunked (or plain), attention fused
        assert jfh.mlp_chunks(c, 4 * c, train=True) == 2
        assert not jfh.fits_vmem(c, heads, 49, mlp_hidden=4 * c, train=True)
        assert jfh.fits_vmem(c, heads, 49, train=True)
    rng = np.random.default_rng(80)
    batches = [(rng.integers(0, 256, size=(4, IMAGE, IMAGE, 3), dtype=np.uint8),
                rng.integers(0, NUM_CLASSES, size=4).astype(np.int32),
                np.ones(4, np.float32)) for _ in range(3)]
    jm = jswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=jnp.float32, fuse=True,
                                 fuse_mlp_chunked=chunked, drop_path_rate=0.0, **GEOMETRY)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, IMAGE, IMAGE, 3)),
                                            train=False))["params"]
    tree = _randomized(shapes, seed=81)
    mean, std = jdevice.scale_channel_stats((0.463, 0.480, 0.376), (0.238, 0.229, 0.247))

    # hvt: step-1 gradients, then three steps of its jitted train step
    jprep = jdevice.DevicePrep(mean=mean, std=std, compute_dtype=jnp.float32)
    objective = jobjectives.soft_cross_entropy
    images, labels, mask = (jnp.asarray(a) for a in batches[0])

    def loss_fn(params):
        out = jm.apply({"params": params}, jprep.normalize(images), train=True)
        return objective(out, jdevice.prepare_targets(labels, NUM_CLASSES, 0.1), mask)

    ref_grads = convert.swin_state_dict_from_flax(
        jax.tree.map(np.asarray, jax.jit(jax.grad(loss_fn))(jax.tree.map(jnp.asarray, tree))))
    tx = joptim.build_optimizer(
        types.SimpleNamespace(name="adamw", lr=LR, weight_decay=0.05, momentum=0.9),
        jschedule.cosine_with_warmup(0, 10), grad_clip_norm=5.0,
        no_decay_substrings=jm.no_weight_decay_substrings)
    jtrain = jstep.build_train_step(jm, objective, tx, jprep,
                                    jstep.StepSettings(num_classes=NUM_CLASSES, smoothing=0.1))
    params = jax.tree.map(jnp.asarray, tree)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats={},
                       opt_state=tx.init(params))
    ref_losses = []
    for im, la, ma in batches:
        state, stats = jtrain(state, jnp.asarray(im), jnp.asarray(la), jnp.asarray(ma),
                              jax.random.key(0), scale=1.0)
        ref_losses.append(float(stats["loss_sum"]))
    ref_params = convert.swin_state_dict_from_flax(jax.tree.map(np.asarray, state.params))

    # the port, counting its chunked-MLP calls
    calls = []
    chunked_half = fh.mlp_half_chunked
    monkeypatch.setattr(fh, "mlp_half_chunked",
                        lambda *a: calls.append(a[-1]) or chunked_half(*a))
    model = tswin.SwinTransformerV2(num_classes=NUM_CLASSES, dtype=torch.float32, fuse=True,
                                    fuse_mlp_chunked=chunked, drop_path_rate=0.0, **GEOMETRY)
    model = convert.swin_params_from_flax(model, tree)
    assert [getattr(model, n).mlp_route(True) for n in model.layer_names if "block" in n] == \
        [2 if chunked else 0] * 4
    opt = toptim.Optimizer(model.named_parameters(), "adamw", LR, 0.05, 0.9,
                           tschedule.cosine_with_warmup(0, 10), grad_clip_norm=5.0,
                           no_decay_substrings=model.no_weight_decay_substrings)
    tprep = tdevice.DevicePrep(mean=mean, std=std, compute_dtype=torch.float32)
    step = tstep.build_train_step(model, tobjectives.soft_cross_entropy, opt, tprep,
                                  tstep.StepSettings(num_classes=NUM_CLASSES, smoothing=0.1))
    losses = []
    for i, (im, la, ma) in enumerate(batches):
        stats = step(*(torch.from_numpy(a) for a in (im, la, ma)))
        losses.append(float(stats["loss_sum"]))
        if i == 0:  # p.grad holds the clipped gradient after the step
            grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()}
            grad_norm = float(stats["grad_norm"])
    assert calls == ([2] * 12 if chunked else [])  # 4 blocks, 3 steps
    assert set(grads) == set(ref_grads)
    ref_norm = np.sqrt(sum(float(np.sum(np.square(g, dtype=np.float64))) for g in ref_grads.values()))
    clip_factor = min(1.0, 5.0 / ref_norm)
    np.testing.assert_allclose(losses, ref_losses, rtol=TOL["loss"])
    assert ref_losses[0] != ref_losses[2]
    assert grad_norm == pytest.approx(ref_norm, rel=TOL["norm"])
    for name, g in grads.items():
        _close(g, ref_grads[name] * clip_factor, TOL["grad"], f"step-1 gradient {name}")
    for name, p in model.state_dict().items():
        diff = np.abs(p.numpy() - ref_params[name])
        assert diff.max() <= 6 * LR, f"{name}: max|Δ| {diff.max():.3g} > 6·lr"
        assert diff.mean() <= 0.1 * LR, f"{name}: mean|Δ| {diff.mean():.3g} > 0.1·lr"


def test_swin_params_from_flax_maps_a_swinv2_base_tree_leaf_for_leaf():
    """Leaves stand in as zero-strided views of their shape (no memory)."""
    jm = jswin.swinv2_base(10, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 224, 224, 3)),
                                            train=False))["params"]
    tree = jax.tree.map(lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    state = convert.swin_state_dict_from_flax(tree)
    with torch.device("meta"):
        model = tswin.swinv2_base(10, fuse=True)
    ref = model.state_dict()
    assert set(state) == set(ref)
    for name, arr in state.items():
        assert tuple(arr.shape) == tuple(ref[name].shape), name
    assert len(jax.tree.leaves(shapes)) == len(ref)
    assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)) == \
        sum(p.numel() for p in model.parameters())


# ---------------------------------------------------------------------------
# grad_accum: "auto"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("need,batch,limit,max_accum", [
    (100, 8, 1000, None),    # fits at 1
    (3000, 8, 1000, None),   # 4 microbatches
    (3000, 12, 1000, None),  # 4 divides 12
    (3000, 6, 1000, None),   # 2 then no power of two divides 6: MemoryError
    (9000, 8, 1000, 4),      # capped below what it needs: MemoryError
    (100, 8, None, None),    # no limit: 1
    (None, 8, 1000, None),   # no measurement: 1
])
def test_choose_grad_accum_matches_hvt(need, batch, limit, max_accum):
    def measure(accum):
        return None if need is None else need / accum

    def run(fn):
        try:
            return fn(measure, batch, limit, max_accum=max_accum)
        except MemoryError:
            return "MemoryError"

    assert run(tmicrobatch.choose_grad_accum) == run(jmicrobatch.choose_grad_accum)


def _layer(save_root, model="resnet_micro_bottleneck"):
    return {
        "run_name": "auto_accum", "seed": 5, "max_duration": "1ba", "grad_accum": "auto",
        "machine": {"save_root": str(save_root)},
        "model": {"name": model, "args": {}},
        "train_dataset": {"source": "synthetic", "crop_size": 32, "synthetic_num_classes": NUM_CLASSES,
                          "synthetic_num_samples": 8, "global_batch_size": 4},
        "eval_dataset": {"source": "synthetic", "crop_size": 32, "synthetic_num_classes": NUM_CLASSES,
                         "synthetic_num_samples": 4, "global_batch_size": 4},
        "optim": {"name": "adamw", "lr": 1e-3, "weight_decay": 0.05},
        "precision": {"compute_dtype": "float32"},
    }


def test_grad_accum_auto_resolves_to_1_on_the_cpu(tmp_path):
    trainer = tloop.Trainer(tconfig.loads(_layer(tmp_path)), device="cpu")
    assert trainer.grad_accum == 1 and trainer.settings.grad_accum == 1


def test_grad_accum_auto_probes_without_touching_the_model_and_trains_a_split(monkeypatch,
                                                                             tmp_path):
    """The card is faked: a limit of 300 bytes, and a probe that runs the
    Trainer's real probe (the step's gradient pass) on the CPU and reports
    100 bytes per image of the largest microbatch it ran. A batch of 4 (400
    bytes) then needs 2 microbatches, and the Trainer trains at 2; with a
    limit that holds the batch it resolves to 1. Either way the probe left
    every parameter, buffer, the optimizer and the generator as a Trainer
    without a probe has them."""
    probed = []

    def probe(model, run, device):
        sizes = []
        handle = model.register_forward_pre_hook(lambda m, args: sizes.append(args[0].shape[0]))
        try:
            tmicrobatch.probe_step(model, run)
        finally:
            handle.remove()
        probed.append(max(sizes))
        return 100.0 * max(sizes)

    monkeypatch.setattr(tmicrobatch, "probe_peak_bytes", probe)
    monkeypatch.setattr(tmicrobatch, "optimizer_state_bytes", lambda opt: 0)
    monkeypatch.setattr(tmicrobatch, "device_bytes_limit", lambda device: 300)
    split = tloop.Trainer(tconfig.loads(_layer(tmp_path / "split")), device="cpu")
    assert probed == [4, 2] and split.grad_accum == 2 and split.settings.grad_accum == 2

    monkeypatch.setattr(tmicrobatch, "device_bytes_limit", lambda device: 10**6)
    trainer = tloop.Trainer(tconfig.loads(_layer(tmp_path)), device="cpu")
    assert probed[2:] == [4] and trainer.grad_accum == 1
    plain = tloop.Trainer(tconfig.loads({**_layer(tmp_path / "plain"), "grad_accum": 1}),
                          device="cpu")
    ref = plain.model.state_dict()
    assert any("running_mean" in name for name in ref)  # BatchNorm buffers are covered
    for probed_trainer in (trainer, split):
        got = probed_trainer.model.state_dict()
        for name in ref:
            torch.testing.assert_close(got[name], ref[name], rtol=0, atol=0, msg=name)
        assert all(p.grad is None for p in probed_trainer.model.parameters())
        assert not probed_trainer.optimizer.state and probed_trainer.optimizer.count == 0
        assert torch.equal(probed_trainer.generator.get_state(), plain.generator.get_state())
        assert probed_trainer.model.training == plain.model.training
    seen = []
    split.fit(on_step=lambda step, stats: seen.append(float(stats["loss_sum"])))
    split.close()
    assert len(seen) == 1 and np.isfinite(seen[0]) and split.step == 1


def test_probe_step_leaves_held_gradients_as_they_were():
    """A probe run while the parameters already hold gradients hands back the
    same tensors with the same values (exactly): its backward must not
    accumulate into them."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    held = {}
    for name, p in model.named_parameters():
        p.grad = torch.randn_like(p)
        held[name] = (p.grad, p.grad.clone())

    def loss(m, batch):
        return m(torch.randn(batch, 3, generator=torch.Generator().manual_seed(1))).square().sum()

    tmicrobatch.probe_step(model, lambda: loss(model, 8).backward())
    for name, p in model.named_parameters():
        assert p.grad is held[name][0], name
        torch.testing.assert_close(p.grad, held[name][1], rtol=0, atol=0, msg=name)
