"""The port's Switch-MoE MLP (``hvt_torch.ops.moe``) and SwinV2 with
``moe_experts`` against hvt's (``hvt/ops/moe.py``, ``hvt/models/swinv2.py``),
on the CPU, one torch thread a test.

* ``MoeMlp`` against hvt's ``MoeMlp`` on the same seeded inputs and weights,
  in f32 and in bf16: output, aux loss and the gradients of the input and of
  every parameter, each within ``TOL[dtype]``·max|hvt's| (f32 1e-5: summation
  order only; bf16 2e-2: both sides round each product, bias add and GELU
  to bf16, the odd element an ulp apart). The routing is compared exactly: a
  token may take another expert only where hvt's top two probabilities lie
  within 1e-6, and the test counts those. At several capacities (none
  dropped, hvt's 1.25, one slot), and with groups of one token.
* hvt's own cases (``tests/test_moe.py:22-90``) on the port: one expert
  equals the dense MLP with the same weights; top-1 routing against a
  per-token loop; capacity drops the tokens after the first of each image
  (a zero router sends every token to expert 0, the first index of a tie);
  the aux loss with a zero router is the aux weight.
* The whole SwinV2 against hvt's, from hvt's flax weights (every leaf drawn)
  carried by the converter: ``swinv2_micro`` with ``moe_from_stage: 0,
  moe_every: 1`` (every block MoE) and ``swinv2_micro_deep`` with
  ``moe_from_stage: 1, moe_every: 2`` (MoE on stage 1's blocks 1 and 3,
  dense blocks beside them), on both ``fuse`` routes: train-mode logits
  and aux loss, eval-mode logits (``test_torch_port_swinv2.py``'s 1e-4 and
  2e-2 of max|logit| for the unfused and fused routes; the aux within 1e-5
  relative, 1e-3 on the fused route, whose dense blocks round their products
  to bf16 before the MoE blocks route). The MoE blocks are the ones hvt picks, unfused on
  ``fuse: true``.
* Three train steps of hvt's ``build_train_step`` and of the port's, aux
  loss in the objective, at ``test_torch_port_accum_sam.py``'s tolerances:
  unfused, fused, unfused with ``remat: true``, fused with ``grad_accum:
  2``, and unfused with SAM (rho 0.5, every step).
* The refusals: ``pipe > 1`` with MoE raises hvt's error; a block with
  ``fuse`` and MoE raises hvt's on a map its window tiles; the Trainer
  refuses ``moe_experts`` that ``mesh.model`` does not divide.
* The rest: ``cuda_unsupported`` says nothing new for SwinV2-T with 8
  experts; the optimizer decays the MoE parameters as hvt's ``decay_mask``;
  the aux loss is a Python 0.0 without MoE and after an eval forward, and a
  recomputation keeps the forward's (the step's aux counted once); the
  converter and ``torch_compat`` carry the ``moe`` leaves across both ways;
  a Trainer resumed from its checkpoint equals the straight run bit for bit;
  ``predict`` equals hvt's records, and the features equal the model's eval
  forward.
"""

import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_predict as predict_tests
from hvt import config as jconfig
from hvt.downstream import predict as jpredict
from hvt.models import swinv2 as jswin
from hvt.models.swinv2 import Mlp as JMlp
from hvt.ops.moe import MoeMlp as JMoeMlp
from hvt.train import optim as joptim
from hvt_torch import config as tconfig
from hvt_torch.downstream import features as tfeatures
from hvt_torch.downstream import predict as tpredict
from hvt_torch.models import common as tcommon
from hvt_torch.models import convert, torch_compat
from hvt_torch.models import swinv2 as tswin
from hvt_torch.ops import moe
from hvt_torch.train import loop as tloop
from hvt_torch.train import optim as toptim
from test_torch_port_accum_sam import FUSED_TOL, UNFUSED_TOL, check_both, run_both
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TIE = 1e-6  # hvt's top two probabilities closer than this may route apart
NUM_CLASSES, IMG = 10, 32
MOE = {"moe_experts": 2, "moe_from_stage": 0, "moe_every": 1}  # hvt's tests/test_moe.py layout


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


# ---------------------------------------------------------------------------
# MoeMlp against hvt's
# ---------------------------------------------------------------------------


def _pair(e, hidden, c, cf, aux_weight, dtype, seed, scale=0.3):
    """hvt's MoeMlp and the port's with the same drawn weights (the router
    at ``scale``, so that the probabilities spread)."""
    jm = JMoeMlp(num_experts=e, hidden=hidden, out=c, capacity_factor=cf, aux_weight=aux_weight,
                 dtype=getattr(jnp, dtype))
    rng = np.random.default_rng(seed)
    params = {"router": rng.normal(size=(c, e)) * scale,
              "w1": rng.normal(size=(e, c, hidden)) / np.sqrt(c),
              "b1": rng.normal(size=(e, hidden)) * 0.1,
              "w2": rng.normal(size=(e, hidden, c)) / np.sqrt(hidden),
              "b2": rng.normal(size=(e, c)) * 0.1}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    tm = moe.MoeMlp(c, e, hidden, c, cf, aux_weight)
    with torch.no_grad():
        for k, v in params.items():
            getattr(tm, k).copy_(torch.from_numpy(v))
    return jm, tm, params


def _hvt_run(jm, params, x, dy):
    """hvt's output, aux (sown), and the gradients of Σ(y·dy) + aux."""
    def f(p, xx):
        y, mut = jm.apply({"params": p}, xx, mutable=["aux_losses"])
        return y, sum(jax.tree.leaves(mut["aux_losses"]))

    def loss(p, xx):
        y, aux = f(p, xx)
        return (y.astype(jnp.float32) * dy).sum() + aux

    y, aux = f(params, x)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    return _f32(y), float(aux), {k: _f32(v) for k, v in gp.items()}, _f32(gx)


def _port_run(tm, x, dy):
    tm.train()
    x = x.clone().requires_grad_()
    y = tm(x)
    aux = moe.moe_aux_loss(tm)
    ((y.float() * torch.from_numpy(dy)).sum() + aux).backward()
    return (y.detach().float().numpy(), float(aux.detach()),
            {k: getattr(tm, k).grad.numpy() for k in ("router", "w1", "b1", "w2", "b2")},
            x.grad.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf,shape", [(1.25, (3, 6, 6)), (4.0, (2, 5, 7)), (0.25, (3, 4, 4)),
                                      (1.25, (5, 1, 1))], ids=["cf1.25", "none-dropped",
                                                               "one-slot", "one-token"])
def test_moe_mlp_matches_hvt(dtype, cf, shape):
    e, hidden, c = 4, 48, 16
    jm, tm, params = _pair(e, hidden, c, cf, 0.01, dtype, seed=len(shape) * 7 + int(cf * 4))
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(size=(*shape, c)).astype(np.float32), getattr(jnp, dtype))
    dy = rng.normal(size=(*shape, c)).astype(np.float32)
    ref = _hvt_run(jm, params, x, dy)
    tx = torch.from_numpy(_f32(x)).to(getattr(torch, dtype))
    got = _port_run(tm, tx, dy)
    tol = TOL[dtype]
    _close(got[0], ref[0], tol, "y")
    assert got[1] == pytest.approx(ref[1], rel=1e-5), "aux"
    _close(got[3], ref[3], tol, "dx")
    for k in ("router", "w1", "b1", "w2", "b2"):
        _close(got[2][k], ref[2][k], tol, f"d{k}")
    # the routing, exactly: hvt's argmax of its f32 probabilities
    g = shape[0]
    tokens = _f32(x).reshape(g, -1, c)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(tokens) @ params["router"], axis=-1))
    with torch.no_grad():
        _, expert, slot, kept, _ = tm.route(torch.from_numpy(tokens).to(getattr(torch, dtype)))
    want = probs.argmax(-1)
    top2 = np.sort(probs, -1)[..., -2:]
    apart = expert.numpy() != want
    assert np.all(top2[..., 1][apart] - top2[..., 0][apart] < TIE), "a routing off a tie"
    assert apart.sum() == 0 or apart.mean() < 0.01
    cap = max(1, math.ceil(tokens.shape[1] / e * cf))
    onehot = np.eye(e)[want]
    ranks = ((np.cumsum(onehot, 1) - 1) * onehot).sum(-1)
    np.testing.assert_array_equal(kept.numpy()[~apart], (ranks < cap)[~apart])
    assert tm.dropped_share() == pytest.approx(float((ranks >= cap).mean()),
                                               abs=apart.sum() / ranks.size + 1e-6)


def test_single_expert_equals_dense_mlp():
    """hvt's test: one expert with room for every token is the dense MLP."""
    tm = moe.MoeMlp(6, 1, 8, 6, capacity_factor=8.0)
    tm.reset_parameters(torch.Generator().manual_seed(1))
    dense = tcommon.TransformerMlp(6, 8)
    with torch.no_grad():
        dense.fc1.weight.copy_(tm.w1[0].T)
        dense.fc1.bias.copy_(tm.b1[0])
        dense.fc2.weight.copy_(tm.w2[0].T)
        dense.fc2.bias.copy_(tm.b2[0])
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 5, 6)).astype(np.float32))
    np.testing.assert_allclose(tm(x).detach().numpy(), dense(x).detach().numpy(), atol=1e-5)
    jdense = JMlp(hidden=8, out=6, dtype=jnp.float32)  # and hvt's dense Mlp
    want = jdense.apply({"params": {"fc1": {"kernel": tm.w1[0].detach().numpy(),
                                            "bias": tm.b1[0].detach().numpy()},
                                    "fc2": {"kernel": tm.w2[0].detach().numpy(),
                                            "bias": tm.b2[0].detach().numpy()}}}, x.numpy())
    np.testing.assert_allclose(tm(x).detach().numpy(), np.asarray(want), atol=1e-5)


def test_top1_routing_matches_reference_loop():
    e, g, s, m, hid = 4, 2, 6, 8, 12
    tm = moe.MoeMlp(m, e, hid, m, capacity_factor=float(e))  # capacity >= s: nothing dropped
    tm.reset_parameters(torch.Generator().manual_seed(3))
    with torch.no_grad():
        tm.router.mul_(20.0)
        tm.b1.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(4))
    x = np.random.default_rng(2).normal(size=(g, s, m)).astype(np.float32)
    got = tm(torch.from_numpy(x)).detach().numpy()
    p = {k: getattr(tm, k).detach().numpy().astype(np.float64) for k in ("router", "w1", "b1",
                                                                       "w2", "b2")}
    logits = x.astype(np.float64) @ p["router"]
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    want = np.zeros((g, s, m))
    for gi in range(g):
        for si in range(s):
            ei = int(np.argmax(probs[gi, si]))
            pre = x[gi, si] @ p["w1"][ei] + p["b1"][ei]
            h = 0.5 * pre * (1.0 + np.vectorize(math.erf)(pre / math.sqrt(2.0)))
            want[gi, si] = probs[gi, si, ei] * (h @ p["w2"][ei] + p["b2"][ei])
    assert len(set(np.argmax(probs, -1).ravel().tolist())) > 1  # more than one expert in use
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_capacity_drops_tokens():
    """A zero router: uniform probabilities, every token to expert 0 (the
    first index of the tie, as jnp.argmax); capacity 1 keeps only each
    image's first token, the rest give 0."""
    e, g, s, m = 4, 2, 6, 8
    tm = moe.MoeMlp(m, e, 8, m, capacity_factor=e / s)  # cap = ceil(s/e · e/s) = 1
    tm.reset_parameters(torch.Generator().manual_seed(5))
    with torch.no_grad():
        tm.router.zero_()
    tm.train()
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(g, s, m)).astype(np.float32))
    y = tm(x).detach().numpy()
    assert np.abs(y[:, 0]).max() > 0
    np.testing.assert_array_equal(y[:, 1:], 0)
    assert tm.dropped_share() == pytest.approx((s - 1) / s)
    _, expert, slot, _, _ = tm.route(x)
    assert expert.eq(0).all() and slot[0].tolist() == list(range(s))


def test_aux_loss_value_with_a_zero_router():
    """f = (1, 0, ...), P = 1/E: aux = E · 1/E = 1, times the aux weight."""
    tm = moe.MoeMlp(8, 4, 8, 8, aux_weight=0.5)
    tm.train()
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 6, 8)).astype(np.float32))
    tm(x)
    assert float(moe.moe_aux_loss(tm).detach()) == pytest.approx(0.5, abs=1e-6)
    assert moe.moe_aux_loss(tm) == 0.0 and tm.aux is None  # taken once, then cleared
    tm.eval()
    tm(x)
    assert moe.moe_aux_loss(tm) == 0.0  # an eval forward keeps none


# ---------------------------------------------------------------------------
# The whole SwinV2
# ---------------------------------------------------------------------------

LAYOUTS = {  # id: (variant, model args, the MoE blocks hvt picks)
    "micro-every-block": ("swinv2_micro", MOE, ["stage0_block0", "stage1_block0"]),
    "micro-deep-stage1-every-2": ("swinv2_micro_deep",
                                  {"moe_experts": 2, "moe_from_stage": 1, "moe_every": 2},
                                  ["stage1_block1", "stage1_block3"]),
}


def _swin_pair(variant, args, fuse, seed=3):
    from test_torch_port_accum_sam import randomized

    jm = getattr(jswin, variant)(NUM_CLASSES, dtype=jnp.float32, drop_path_rate=0.0, fuse=fuse,
                                 **args)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)),
                                            train=False))
    params = randomized(shapes, seed, "swin")["params"]
    tm = getattr(tswin, variant)(NUM_CLASSES, dtype="float32", drop_path_rate=0.0, fuse=fuse,
                                 img_size=IMG, **args)
    convert.swin_params_from_flax(tm, params)
    return jm, params, tm


@pytest.mark.parametrize("fuse,tol", [(False, 1e-4), (True, 2e-2)])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_whole_model_matches_hvt(layout, fuse, tol):
    variant, args, blocks = LAYOUTS[layout]
    jm, params, tm = _swin_pair(variant, args, fuse)
    assert sorted(n.removesuffix(".moe") for n, _ in moe.moe_layers(tm)) == blocks
    for name in tm.layer_names:
        block = getattr(tm, name)
        if "block" in name:  # hvt's fuse and not block_moe
            assert block.fuse == (fuse and name not in blocks), name
            assert (block.mlp is None) == (name in blocks) != (block.moe is None)
    x = np.random.default_rng(1).normal(size=(4, IMG, IMG, 3)).astype(np.float32)
    ref, mut = jm.apply({"params": params}, jnp.asarray(x), train=True, mutable=["aux_losses"])
    ref_aux = float(sum(jax.tree.leaves(mut["aux_losses"])))
    tm.train()
    got = tm(torch.from_numpy(x)).detach().numpy()
    aux = moe.moe_aux_loss(tm)
    _close(got, np.asarray(ref), tol, f"{layout} fuse={fuse} train logits")
    assert float(aux.detach()) == pytest.approx(ref_aux, rel=1e-3 if fuse else 1e-5)
    tm.eval()
    with torch.inference_mode():
        got = tm(torch.from_numpy(x)).numpy()
    assert moe.moe_aux_loss(tm) == 0.0
    ref = jm.apply({"params": params}, jnp.asarray(x), train=False)
    _close(got, np.asarray(ref), tol, f"{layout} fuse={fuse} eval logits")


MOE_MICRO = {**MOE}
STEP_CASES = {  # id: (model args, step settings, tolerances, fused)
    "unfused": ({**MOE_MICRO, "fuse": False}, {}, UNFUSED_TOL, False),
    "fused": ({**MOE_MICRO, "fuse": True, "moe_from_stage": 1}, {}, FUSED_TOL, True),
    "unfused-remat": ({**MOE_MICRO, "fuse": False, "remat": True}, {}, UNFUSED_TOL, False),
    "fused-accum2": ({**MOE_MICRO, "fuse": True, "moe_from_stage": 1}, {"grad_accum": 2},
                     FUSED_TOL, True),
    "unfused-sam": ({**MOE_MICRO, "fuse": False}, {"sam_rho": 0.5}, UNFUSED_TOL, False),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_match_hvt(case):
    """hvt's step adds the sown aux loss to each microbatch's objective; the
    port's must too: the reported loss counts it, and the router trains."""
    args, settings, tol, fused = STEP_CASES[case]
    ref, got = run_both("swin", args, settings, seed=40 + list(STEP_CASES).index(case))
    check_both("swin", ref, got, tol, fused=fused)
    router = next(k for k in ref["state"] if k.endswith("moe.router"))
    assert np.abs(got["state"][router]).max() > 0


def test_a_recomputed_block_keeps_the_forwards_aux_once():
    """Under ``remat`` the backward recomputes each MoE block: the aux the
    step reads is the first forward's, with its graph, and the
    recomputation leaves none behind; the gradients equal those without
    remat bit for bit."""
    grads, auxes = [], []
    for remat in (False, True):
        tm = tswin.swinv2_micro(NUM_CLASSES, dtype="float32", drop_path_rate=0.5, remat=remat,
                                img_size=IMG, **MOE)
        tm.train()
        x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, IMG, IMG, 3))
                             .astype(np.float32))
        out = tm(x, generator=torch.Generator().manual_seed(0))
        aux = moe.moe_aux_loss(tm)
        assert isinstance(aux, torch.Tensor) and aux.requires_grad
        (out.sum() + aux).backward()
        assert all(m.aux is None for _, m in moe.moe_layers(tm))  # nothing left to add twice
        auxes.append(float(aux.detach()))
        grads.append({n: p.grad.clone() for n, p in tm.named_parameters()})
    assert auxes[0] == auxes[1]
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
    assert grads[0]["stage0_block0.moe.router"].abs().max() > 0


def test_a_model_without_moe_adds_nothing():
    tm = tswin.swinv2_micro(NUM_CLASSES, dtype="float32", img_size=IMG)
    tm.train()
    tm(torch.zeros(1, IMG, IMG, 3))
    aux = moe.moe_aux_loss(tm)
    assert aux == 0.0 and isinstance(aux, float)


# ---------------------------------------------------------------------------
# Refusals and the model's facts
# ---------------------------------------------------------------------------


def test_pipe_with_moe_raises_hvts_error():
    with pytest.raises(ValueError, match="pipe > 1 and moe_experts > 0 are mutually exclusive"):
        tswin.swinv2_micro(NUM_CLASSES, pipe=2, **MOE)
    with pytest.raises(NotImplementedError, match="queue 1, item 11"):
        tswin.swinv2_micro(NUM_CLASSES, pipe=2)


def test_a_fused_block_with_moe_raises_as_hvts():
    block = tswin.SwinBlock(16, 2, 4, 0, fuse=True, moe_experts=2)
    with pytest.raises(ValueError, match="MoE blocks require the unfused path"):
        block(torch.zeros(1, 8, 8, 16))
    tswin.SwinBlock(16, 2, 4, 0, fuse=False, moe_experts=2)(torch.zeros(1, 8, 8, 16))


def test_trainer_refuses_experts_the_model_axis_does_not_divide(tmp_path):
    layer = {"model": {"name": "swinv2_micro", "args": {**MOE, "moe_experts": 3}},
             "mesh": {"model": 2}, "machine": {"save_root": str(tmp_path)},
             "train_dataset": {"source": "synthetic", "crop_size": IMG}}
    with pytest.raises(ValueError, match="moe_experts=3 must be divisible by the mesh's "
                                         "model-axis size 2"):
        tloop.Trainer(tconfig.loads(layer), device="cpu")


def test_cuda_unsupported_says_nothing_new_for_swinv2_tiny_with_experts():
    for fuse in (False, True):
        dense = tswin.swinv2_tiny(1000, fuse=fuse)
        tm = tswin.swinv2_tiny(1000, fuse=fuse, moe_experts=8)
        assert len(moe.moe_layers(tm)) == 4
        for training in (False, True):
            for size in (224, 192):
                assert tm.cuda_unsupported(size, training) == dense.cuda_unsupported(size, training)
        assert tm.cuda_unsupported(224, True) == []
    params = sum(p.numel() for p in tm.parameters())
    assert 85e6 < params < 87e6  # SwinV2-T with 8 experts: about 86 M


def test_decay_mask_matches_hvt_for_the_moe_parameters():
    variant, args, _ = LAYOUTS["micro-deep-stage1-every-2"]
    jm, params, tm = _swin_pair(variant, args, False)
    mask = joptim.decay_mask(params, jm.no_weight_decay_substrings)
    flags = jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32), mask, params)
    ref = {k: bool(v.all()) for k, v in convert.swin_state_dict_from_flax(flags).items()}
    got = toptim.decay_mask(tm.named_parameters(), tm.no_weight_decay_substrings)
    assert got == ref
    assert all(got[f"stage1_block1.moe.{n}"] for n in ("router", "w1", "b1", "w2", "b2"))


# ---------------------------------------------------------------------------
# Checkpoints, predict and features
# ---------------------------------------------------------------------------


def _train_layer(root, **change):
    layer = {"run_name": "moe_test", "seed": 3, "max_duration": "2ba", "grad_accum": 1,
             "eval_interval": "1dur", "machine": {"save_root": str(root)},
             "model": {"name": "swinv2_micro", "args": {**MOE, "drop_path_rate": 0.2}},
             "train_dataset": {"source": "synthetic", "crop_size": IMG,
                               "synthetic_num_classes": NUM_CLASSES, "synthetic_num_samples": 8,
                               "global_batch_size": 4, "shuffle": True, "drop_last": True},
             "eval_dataset": {"source": "synthetic", "crop_size": IMG,
                              "synthetic_num_classes": NUM_CLASSES, "synthetic_num_samples": 4,
                              "global_batch_size": 4},
             "optim": {"name": "AdamW", "lr": 1e-3, "weight_decay": 0.05},
             "scheduler": {"args": {"t_warmup": "1ba"}},
             "precision": {"compute_dtype": "float32"},
             "save": {"interval": "1ba", "num_checkpoints_to_keep": 3, "wandb": False},
             "loader": {"num_workers": 1, "prefetch_batches": 1}}
    layer.update(change)
    return layer


def test_checkpoints_round_trip_the_experts(tmp_path):
    """A Trainer of the MoE model resumed from step 1 equals the straight
    run at step 2 bit for bit (the checkpoint holds ``moe.*``); the
    Microsoft-format file (``save_swin_checkpoint``) reads back tensor for
    tensor."""
    straight = tloop.Trainer(tconfig.loads(_train_layer(tmp_path / "a")), device="cpu")
    straight.fit()
    straight.close()
    ckpt = f"ckpt://{tmp_path / 'a' / 'moe_test' / 'checkpoints'}:1"
    resumed = tloop.Trainer(tconfig.loads(_train_layer(tmp_path / "b", load_path=ckpt)),
                            device="cpu")
    assert resumed.step == 1
    resumed.fit()
    resumed.close()
    want = dict(straight.model.named_parameters())
    assert any(".moe.w1" in n for n in want)
    for n, p in resumed.model.named_parameters():
        assert torch.equal(p, want[n]), n
    path = tmp_path / "swin.pt"
    params = {n: p.detach() for n, p in straight.model.named_parameters()}
    assert torch_compat.save_swin_checkpoint(params, str(path)) == len(params)
    back, stats = torch_compat.load_torch_variables(f"swin://{path}")
    assert stats == {} and back.keys() == params.keys()
    assert all(torch.equal(back[n], p) for n, p in params.items())
    assert "layers.0.blocks.0.moe.router" in torch.load(path, weights_only=True)["model"]


def test_predict_matches_hvt_and_features_match_the_eval_forward(tmp_path):
    layer = {"run_name": "predict_test", "seed": 0,
             "model": {"name": "swinv2_micro", "args": {**MOE, "fuse": True}},
             "eval_dataset": {"source": "synthetic", "synthetic_num_classes": 6,
                              "synthetic_num_samples": 7, "crop_size": IMG,
                              "global_batch_size": 4},
             "precision": {"compute_dtype": "float32"}, "loader": {"num_workers": 1},
             "save": {"wandb": False}}
    jcfg, tcfg = predict_tests._write_checkpoints(tmp_path, layer, 6)
    ref = list(jpredict.predict(jcfg, topk=3))
    got = list(tpredict.predict(tcfg, topk=3, device="cpu"))
    predict_tests._assert_records_match(got, ref)

    feature_layer = {**layer, "run_name": "feat_test",
                     "machine": {"save_root": str(tmp_path / "runs")},
                     "model": {**layer["model"], "pretrained_checkpoint": tcfg.load_path},
                     "train_dataset": {**layer["eval_dataset"]}}
    feats, labels = tfeatures.extract_features(tconfig.loads(feature_layer), False, "simpleshot",
                                               device="cpu")
    engine_model = tpredict._resolve_weights(tcfg, tswin.swinv2_micro(
        6, dtype="float32", img_size=IMG, fuse=True, **MOE), True).eval()
    from hvt_torch.data import build_loader
    loader, _ = build_loader(tconfig.loads(feature_layer), is_train=False)
    from hvt_torch.data import DevicePrep
    prep = DevicePrep.from_config(tconfig.loads(feature_layer).eval_dataset,
                                  tconfig.loads(feature_layer).precision)
    rows = []
    with torch.inference_mode():
        for batch in loader.epoch(0):
            x = prep.normalize(torch.as_tensor(np.asarray(batch.images)))
            f = engine_model(x, features_only=True).numpy()
            rows.append(f[np.asarray(batch.mask) > 0])
    want = np.concatenate(rows)
    assert feats.shape == want.shape == (7, engine_model.num_features)
    _close(feats, want, 1e-6, "features")
    assert pathlib.Path(tmp_path / "runs").exists()
