"""The port's checkpoints, resume, preemption, run log and torch-format
weights against hvt's, on the CPU.

Inputs are seeded numpy (weights drawn, never left at init); hvt runs on
the CPU as its own tests run it. Tolerances:

* ``swin://`` and ``torch://`` files written by hvt's ``torch_compat`` and
  merged by both packages' ``load_pretrained`` into the same init: logits
  within 1e-5·max|ref| (f32, eval mode), the head left at its init on both
  sides and the backbone equal to the file's tensors exactly;
* the port's checkpoints exported by ``python -m hvt_torch.tools.export_torch``
  and read by hvt's ``load_torch_variables``: hvt's logits on them within
  1e-5·max|ref| of the port's (the EMA copy, or ``--raw``'s trained weights);
* a resume mid-epoch (and after SIGTERM, and by ``auto_resume``) against the
  straight run: every parameter, running statistic, EMA copy, optimizer
  tensor, the update count and the generator's state **exactly**;
* the run log: hvt's record prefixes, keys and steps (time, speed and memory
  values are not compared), and ``to_yaml`` equal to hvt's;
* serving from ``load_path``: the engine's logits equal the Trainer's eval
  forward on the EMA copy (on the trained weights with ``use_ema=False``);
* the loader's ``start_batch``: hvt's batches, exactly.
"""

import json
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hvt import config as jconfig
from hvt import parallel
from hvt.data import loader as jloader
from hvt.models import build_model as jbuild_model
from hvt.models import torch_compat as jtc
from hvt.train import checkpoint as jckpt
from hvt.train import loop as jloop
from hvt_torch import config as tconfig
from hvt_torch import serve as tserve
from hvt_torch.data import loader as tloader
from hvt_torch.downstream import serve as serve_lib
from hvt_torch.models import build_model as tbuild_model
from hvt_torch.models import convert
from hvt_torch.models import torch_compat as ttc
from hvt_torch.tools import export_torch
from hvt_torch.train import checkpoint as tckpt
from hvt_torch.train import ema as tema
from hvt_torch.train import step as tstep
from hvt_torch.train.loop import Trainer
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUM_CLASSES = 10
IMG = 32


def _close(got, ref, tol, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.isfinite(got).all(), what
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, f"{what}: max|Δ| {err:.3g} > {tol}·{scale:.3g}"


def _images(seed=1, n=2):
    return np.random.default_rng(seed).normal(size=(n, IMG, IMG, 3)).astype(np.float32)


def _randomized(shapes, seed):
    """Every leaf drawn at a scale that keeps activations O(1)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sds):
        name, shape = path[-1].key, sds.shape
        if name in ("scale", "var"):
            a = rng.uniform(0.5, 1.5, size=shape)
        elif name == "logit_scale":
            a = np.log(10.0) + 0.3 * rng.normal(size=shape)
        elif name in ("bias", "mean", "q_bias", "v_bias", "cpb_b1"):
            a = 0.1 * rng.normal(size=shape)
        elif name == "cpb_w1":
            a = rng.normal(size=shape)
        else:
            a = rng.normal(size=shape) / np.sqrt(int(np.prod(shape[:-1])))
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _model_layer(name, **args):
    return {"model": {"name": name, "args": {"use_pallas": False, **args} if "swin" in name
                      else args},
            "precision": {"compute_dtype": "float32"}}


def _hvt_variables(name, seed, **args):
    jm = jbuild_model(jconfig.loads(_model_layer(name, **args)), NUM_CLASSES)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)),
                                            train=False))
    return jm, _randomized(dict(shapes), seed)


def _port_model(name, variables, **args):
    tm = tbuild_model(tconfig.loads(_model_layer(name, **args)), NUM_CLASSES).eval()
    if "swin" in name:
        return convert.swin_params_from_flax(tm, variables["params"])
    return convert.resnet_params_from_flax(tm, variables)


def _port_logits(model, params=None, stats=None, x=None):
    with torch.no_grad():
        if params is None:
            return model.eval()(torch.from_numpy(x)).numpy()
        return tstep._eval_forward(model, params, stats, torch.from_numpy(x)).numpy()


# ---------------------------------------------------------------------------
# 1-2. swin:// and torch:// files merged by both packages
# ---------------------------------------------------------------------------


def test_swin_file_merges_as_hvts(tmp_path):
    jm, trained = _hvt_variables("swinv2_micro", seed=3)
    _, init = _hvt_variables("swinv2_micro", seed=4)
    path = tmp_path / "swin.pt"
    jtc.save_swin_checkpoint(trained["params"], str(path))
    merged, _ = jckpt.load_pretrained(f"swin://{path}", init["params"], None)
    x = _images()
    ref = np.asarray(jm.apply({"params": merged}, jnp.asarray(x), train=False))

    tm = _port_model("swinv2_micro", init)
    live = dict(tm.named_parameters())
    params, _ = tckpt.load_pretrained(f"swin://{path}", live, {}, strict=True)
    tckpt.copy_into(live, params, "swin")
    _close(_port_logits(tm, x=x), ref, 1e-5, "logits after swin://")
    want = convert.swin_state_dict_from_flax(trained["params"])
    head = convert.swin_state_dict_from_flax(init["params"])
    for name, t in tm.state_dict().items():
        src = head if name.startswith("head.") else want
        np.testing.assert_array_equal(t.numpy(), src[name], err_msg=name)
    np.testing.assert_array_equal(merged["head"]["kernel"], init["params"]["head"]["kernel"])


@pytest.mark.parametrize("file_s2d,model_s2d", [(False, True), (True, False), (True, True)])
def test_torch_resnet_file_merges_as_hvts(tmp_path, file_s2d, model_s2d):
    _, trained = _hvt_variables("resnet_micro_bottleneck", seed=5, stem_s2d=file_s2d)
    jm, init = _hvt_variables("resnet_micro_bottleneck", seed=6, stem_s2d=model_s2d)
    path = tmp_path / "resnet.pt"
    jtc.save_resnet_checkpoint(trained["params"], trained["batch_stats"], str(path))
    params, stats = jckpt.load_pretrained(f"torch://{path}", init["params"],
                                          init["batch_stats"], strict=True)
    x = _images(2)
    ref = np.asarray(jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                              train=False))

    tm = _port_model("resnet_micro_bottleneck", init, stem_s2d=model_s2d)
    live, live_stats = dict(tm.named_parameters()), tema.batch_stats(tm)
    got, got_stats = tckpt.load_pretrained(f"torch://{path}", live, live_stats, strict=True)
    tckpt.copy_into(live, got, "torch")
    tckpt.copy_into(live_stats, got_stats, "torch")
    _close(_port_logits(tm, x=x), ref, 1e-5, "logits after torch://")
    want = convert.resnet_state_dict_from_flax(trained["params"], trained["batch_stats"])
    init_sd = convert.resnet_state_dict_from_flax(init["params"], init["batch_stats"])
    for name, t in tm.state_dict().items():
        src = init_sd if name.startswith("head.") else want
        np.testing.assert_array_equal(t.numpy(), src[name], err_msg=name)

    # strict: a key missing from the file raises on both sides, as KeyError
    blob = torch.load(path, weights_only=True)
    del blob["model"]["layer1.0.conv2.weight"]
    torch.save(blob, path)
    with pytest.raises(KeyError, match="missing keys"):
        jckpt.load_pretrained(f"torch://{path}", init["params"], init["batch_stats"], strict=True)
    with pytest.raises(KeyError, match="missing keys.*stage1_block0.conv2.conv.weight"):
        tckpt.load_pretrained(f"torch://{path}", live, live_stats, strict=True)
    # without strict it warns and keeps the model's tensor
    kept, _ = tckpt.load_pretrained(f"torch://{path}", live, live_stats, strict=False)
    assert kept["stage1_block0.conv2.conv.weight"] is live["stage1_block0.conv2.conv.weight"]


def test_other_families_and_shapes_raise(tmp_path):
    """A timm ConvNeXt file loads into the port's ConvNeXt tree (its family
    is ported); a shape mismatch and a wandb URI without the package raise."""
    path = tmp_path / "convnext.pt"
    sd = {"stem.0.weight": torch.ones(8, 3, 4, 4), "stem.0.bias": torch.zeros(8),
          "stem.1.weight": torch.ones(8), "stem.1.bias": torch.zeros(8),
          "stages.0.blocks.0.conv_dw.weight": torch.full((8, 1, 7, 7), 2.0),
          "stages.0.blocks.0.conv_dw.bias": torch.zeros(8),
          "stages.0.blocks.0.norm.weight": torch.ones(8), "stages.0.blocks.0.norm.bias": torch.zeros(8),
          "stages.0.blocks.0.mlp.fc1.weight": torch.ones(32, 8), "stages.0.blocks.0.mlp.fc1.bias": torch.zeros(32),
          "stages.0.blocks.0.mlp.fc2.weight": torch.ones(8, 32), "stages.0.blocks.0.mlp.fc2.bias": torch.zeros(8),
          "stages.0.blocks.0.gamma": torch.full((8,), 0.5),
          "head.norm.weight": torch.ones(8), "head.norm.bias": torch.zeros(8)}
    torch.save({"model": sd}, path)
    params, stats = ttc.load_torch_variables(f"torch://{path}")
    assert stats == {} and torch.equal(params["stage0_block0.dwconv.weight"], sd["stages.0.blocks.0.conv_dw.weight"])
    from hvt_torch.models.convnext import ConvNeXt

    model = ConvNeXt(5, depths=(1,), dims=(8,))
    kept, _ = tckpt.load_pretrained(f"torch://{path}", dict(model.named_parameters()), None, strict=True)
    assert torch.equal(kept["stage0_block0.gamma"], sd["stages.0.blocks.0.gamma"])
    assert kept["head.weight"] is model.head.weight  # the head keeps the model's
    cur = {"a.weight": torch.zeros(2, 3)}
    with pytest.raises(ValueError, match="shape mismatch at a.weight"):
        tckpt.merge_backbone(cur, {"a.weight": torch.zeros(3, 2)})
    with pytest.raises(RuntimeError, match="wandb package"):
        tckpt.load_pretrained("wandb://e/p/run:latest?model.pt", cur, None)


# ---------------------------------------------------------------------------
# Trainer configs
# ---------------------------------------------------------------------------


def _train_layer(save_root, model="resnet", **change):
    layer = {
        "run_name": "ckpt_test", "seed": 5, "max_duration": "8ba", "grad_accum": 1,
        "machine": {"save_root": str(save_root)},
        "train_dataset": {"source": "synthetic", "crop_size": IMG, "global_batch_size": 8,
                          "synthetic_num_classes": NUM_CLASSES, "synthetic_num_samples": 32,
                          "shuffle": True},
        "eval_dataset": {"source": "synthetic", "crop_size": IMG, "global_batch_size": 8,
                         "synthetic_num_classes": NUM_CLASSES, "synthetic_num_samples": 8},
        "scheduler": {"args": {"t_warmup": "2ba"}},
        "precision": {"compute_dtype": "float32"},
        "save": {"interval": None, "num_checkpoints_to_keep": 1, "wandb": False},
        "loader": {"num_workers": 1, "prefetch_batches": 1},
    }
    if model == "resnet":
        layer.update({
            "model": {"name": "resnet_micro_bottleneck", "args": {"stem_s2d": True}},
            "optim": {"name": "DecoupledSGDW", "lr": 0.2, "momentum": 0.875,
                      "weight_decay": 5e-4},
            "algorithms": [{"cls": "EMA", "args": {"half_life": "4ba", "update_interval": "1ba"}},
                           {"cls": "LabelSmoothing", "args": {"smoothing": 0.08}}],
        })
    else:
        layer.update({
            "model": {"name": "swinv2_micro", "args": {"drop_path_rate": 0.2}},
            "optim": {"name": "adamw", "lr": 1e-3, "weight_decay": 0.05},
            "algorithms": [{"cls": "GradientClipping",
                            "args": {"clipping_type": "norm", "clipping_threshold": 5.0}}],
        })
    for key, value in change.items():
        layer[key] = {**layer[key], **value} if isinstance(value, dict) else value
    return layer


def _trainer(layer, **kw):
    return Trainer(tconfig.loads(layer), device="cpu", **kw)


def _assert_same_state(a: Trainer, b: Trainer):
    """Every tensor of the two Trainers' checkpoints, the count and the
    generator state, exactly."""
    sa, sb = tckpt.to_host(a.state_dict()), tckpt.to_host(b.state_dict())
    assert sa["step"] == sb["step"] and sa["opt_state"]["count"] == sb["opt_state"]["count"]
    assert torch.equal(sa["rng"], sb["rng"])
    for key in ("params", "batch_stats", "ema_params", "ema_batch_stats"):
        if sa[key] is None:
            assert sb[key] is None
            continue
        for name, t in sa[key].items():
            assert torch.equal(t, sb[key][name]), f"{key} {name}"
    opt_a, opt_b = sa["opt_state"]["state"], sb["opt_state"]["state"]
    assert opt_a.keys() == opt_b.keys() and opt_a
    for i, slots in opt_a.items():
        for slot, t in slots.items():
            assert torch.equal(t, opt_b[i][slot]), f"optimizer {i} {slot}"
    assert sa["ema_updates"] == sb["ema_updates"]


# ---------------------------------------------------------------------------
# 3. Export round trip into hvt
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["resnet", "swin"])
def test_export_reads_into_hvt(tmp_path, model):
    algos = ([{"cls": "EMA", "args": {"half_life": "2ba", "update_interval": "1ba"}}]
             if model == "swin" else None)
    layer = _train_layer(tmp_path, model, max_duration="3ba",
                         **({"algorithms": algos} if algos else {}))
    trainer = _trainer(layer)
    trainer.fit()
    trainer.close()
    ckpts = tmp_path / "ckpt_test" / "checkpoints"
    assert trainer.ema is not None and [p.name for p in ckpts.iterdir()] == ["3"]
    name = layer["model"]["name"]
    args = {k: v for k, v in layer["model"]["args"].items() if k != "stem_s2d"}  # timm's stem
    jm = jbuild_model(jconfig.loads(_model_layer(name, **args)), NUM_CLASSES)
    x = _images(7)
    for raw, params, stats in ((False, trainer.ema.params, trainer.ema.batch_stats),
                               (True, dict(trainer.model.named_parameters()),
                                tema.batch_stats(trainer.model))):
        out = tmp_path / f"export_{raw}.pt"
        export_torch.main([str(ckpts), str(out)] + (["--raw"] if raw else []))
        jparams, jstats = jtc.load_torch_variables(f"torch://{out}")
        variables = {"params": jparams, **({"batch_stats": jstats} if jstats else {})}
        ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
        got = _port_logits(trainer.model, params, stats, x)
        _close(got, ref, 1e-5, f"{model} logits, raw={raw}")
        _close(ref, got, 1e-5, f"{model} logits, raw={raw} (hvt against the port)")


# ---------------------------------------------------------------------------
# 4-6. Resume, auto-resume, SIGTERM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["resnet", "swin"])
def test_mid_epoch_resume_is_bitwise_exact(tmp_path, model):
    """4 steps an epoch; run A saves every 3 steps and B resumes from its
    step 6 (mid-epoch 2) to 8; C trains 8 straight."""
    part = _train_layer(tmp_path, model, run_name="interrupted",
                        save={"interval": "3ba", "num_checkpoints_to_keep": 5})
    a = _trainer(part, log_interval=10)
    assert a.steps_per_epoch == 4
    a.fit()
    a.close()
    ckpts = tmp_path / "interrupted" / "checkpoints"
    assert sorted(int(p.name) for p in ckpts.iterdir()) == [3, 6, 8]
    b = _trainer(_train_layer(tmp_path, model, run_name="resumed",
                              load_path=f"ckpt://{ckpts}:6"), log_interval=10)
    assert b.step == 6 and b.optimizer.count == 6
    saved = tckpt.load_raw(f"ckpt://{ckpts}:6")
    assert torch.equal(b.generator.get_state(), saved["rng"])
    steps = []
    b.fit(on_step=lambda step, stats: steps.append(step))
    b.close()
    assert steps == [7, 8]
    c = _trainer(_train_layer(tmp_path, model, run_name="straight"), log_interval=10)
    c.fit()
    c.close()
    _assert_same_state(b, c)
    if model == "swin":  # drop path drew masks: the generator moved past its seed
        fresh = torch.Generator().manual_seed(5).get_state()
        assert not torch.equal(c.generator.get_state(), fresh)


def test_auto_resume_picks_up_the_runs_own_checkpoint(tmp_path):
    layer = _train_layer(tmp_path, run_name="autoresume", auto_resume=True, max_duration="2ba")
    tr = _trainer(layer)
    assert tr.step == 0
    tr.fit()
    tr.close()
    tr2 = _trainer({**layer, "max_duration": "4ba"})
    assert tr2.step == 2
    tr2.fit()
    assert tr2.step == 4
    tr2.close()
    other = tmp_path / "autoresume" / "checkpoints"
    tr3 = _trainer({**layer, "run_name": "autoresume2", "load_path": str(other)})
    assert tr3.step == 4  # load_path wins: the other run's latest
    tr3.close()


def test_sigterm_saves_returns_and_resumes(tmp_path):
    layer = _train_layer(tmp_path, model="swin", max_duration="6ba")
    tr = _trainer(layer)
    before = signal.getsignal(signal.SIGTERM)
    seen = []

    def on_step(step, stats):
        seen.append(step)
        if step == 2:
            signal.raise_signal(signal.SIGTERM)

    metrics = tr.fit(on_step=on_step)
    assert seen == [1, 2] and tr.step == 2 and np.isfinite(metrics["cross-entropy"])
    assert tr.checkpointer.latest_step() == 2
    tr.close()
    assert signal.getsignal(signal.SIGTERM) == before
    tr2 = _trainer({**layer, "auto_resume": True})
    assert tr2.step == 2
    tr2.fit(on_step=lambda step, stats: seen.append(step))
    assert seen == [1, 2, 3, 4, 5, 6] and tr2.checkpointer.latest_step() == 6
    tr2.close()
    straight = _trainer({**layer, "run_name": "straight"})
    straight.fit()
    straight.close()
    _assert_same_state(tr2, straight)


def test_main_resumes_and_loads_a_backbone_on_the_cpu(tmp_path):
    """Through ``python -m hvt_torch.main``: saves at ``save.interval``, an
    ``auto_resume`` resubmission continues, a PretrainedBackbone loads the
    run's checkpoint (strict) and ``load_path`` resumes from a step."""
    def run(name, **change):
        exp = tmp_path / f"{name}.yaml"
        exp.write_text(yaml.safe_dump(_train_layer(tmp_path, **change)))
        out = subprocess.run(
            [sys.executable, "-m", "hvt_torch.main", "--machine", "configs/machines/local.yaml",
             "--exp", str(exp), "--device", "cpu"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert out.returncode == 0, out.stderr
        return out.stdout.strip().splitlines()

    ckpts = tmp_path / "ckpt_test" / "checkpoints"
    run("first", max_duration="2ba", save={"interval": "1ba", "num_checkpoints_to_keep": 2})
    assert sorted(int(p.name) for p in ckpts.iterdir()) == [1, 2]
    lines = run("resubmit", max_duration="3ba", auto_resume=True)
    assert "[ckpt_test] auto-resumed from step 2" in lines
    assert sorted(int(p.name) for p in ckpts.iterdir()) == [3]
    backbone = {"cls": "PretrainedBackbone", "args": {"checkpoint": f"ckpt://{ckpts}",
                                                      "strict": True}}
    lines = run("backbone", run_name="backbone", max_duration="1ba",
                algorithms=_train_layer(tmp_path)["algorithms"] + [backbone])
    assert json.loads(lines[-1])["acc@1"] >= 0.0
    lines = run("load", run_name="load", max_duration="4ba", load_path=f"ckpt://{ckpts}:3")
    assert lines[-2].startswith("[load] step=4, eval/acc@1=")


def test_pretrained_backbone_reaches_the_trainer(tmp_path):
    """PretrainedBackbone merges the backbone and its running statistics
    into the model (EMA weights preferred) and keeps the head; the EMA copy
    keeps the init, as hvt's state does."""
    src = _trainer(_train_layer(tmp_path, run_name="source", max_duration="2ba"))
    src.fit()
    src.close()
    backbone = {"cls": "PretrainedBackbone",
                "args": {"checkpoint": f"ckpt://{tmp_path}/source/checkpoints", "strict": True}}
    layer = _train_layer(tmp_path, run_name="target", seed=9)
    layer["algorithms"] = layer["algorithms"] + [backbone]
    tr = _trainer(layer)
    init = _trainer({**layer, "algorithms": layer["algorithms"][:-1], "run_name": "init"})
    for name, t in {**dict(tr.model.named_parameters()), **tema.batch_stats(tr.model)}.items():
        want = (dict(init.model.named_parameters())[name] if name.startswith("head.")
                else {**src.ema.params, **src.ema.batch_stats}[name])
        assert torch.equal(t, want), name
    for name, t in tr.ema.params.items():
        assert torch.equal(t, init.ema.params[name]), name
    tr.close()
    init.close()


# ---------------------------------------------------------------------------
# 7. Storage rules
# ---------------------------------------------------------------------------


def test_keep_policy_and_half_written_steps(tmp_path):
    ck = tckpt.Checkpointer(tmp_path / "c", max_to_keep=2)
    for step in (1, 2, 3):
        ck.save(step, {"step": step, "w": torch.full((3,), float(step))})
    assert ck.latest_step() == 3 and ck.steps() == [2, 3]
    (tmp_path / "c" / "9.tmp").mkdir()  # a write that never committed
    (tmp_path / "c" / "9.tmp" / tckpt.STATE_FILE).write_bytes(b"torn")
    assert ck.latest_step() == 3 and ck.restore()["step"] == 3
    assert tckpt.load_raw(str(tmp_path / "c"))["step"] == 3
    assert tckpt.load_raw(f"ckpt://{tmp_path / 'c'}:2")["step"] == 2
    with pytest.raises(FileNotFoundError):
        tckpt.load_raw(f"ckpt://{tmp_path / 'c'}:1")
    ck.close()
    assert tckpt.Checkpointer(tmp_path / "z", max_to_keep=0).max_to_keep == 1


def test_save_copies_before_it_returns(tmp_path):
    """The next step's in-place update cannot reach the saved copy."""
    w = torch.arange(6.0)
    ck = tckpt.Checkpointer(tmp_path, max_to_keep=1)
    ck.save(1, {"step": 1, "params": {"w": w}})
    w.add_(100.0)  # as the optimizer's _foreach_ update would, before the write ends
    ck.wait()
    assert torch.equal(ck.restore(1)["params"]["w"], torch.arange(6.0))


def test_a_failed_write_raises_at_the_next_wait(tmp_path, monkeypatch):
    ck = tckpt.Checkpointer(tmp_path, max_to_keep=1)

    def broken(obj, f):
        raise OSError("disk full")

    monkeypatch.setattr(tckpt.torch, "save", broken)
    ck.save(1, {"step": 1})
    with pytest.raises(RuntimeError, match="failed") as info:
        ck.wait()
    assert isinstance(info.value.__cause__, OSError)
    assert ck.latest_step() is None  # nothing was committed
    monkeypatch.undo()
    ck.save(2, {"step": 2})
    ck.close()
    assert ck.steps() == [2]


def test_state_file_loads_with_weights_only(tmp_path):
    tr = _trainer(_train_layer(tmp_path, max_duration="1ba"))
    tr.fit()
    tr.close()
    state = torch.load(tmp_path / "ckpt_test" / "checkpoints" / "1" / tckpt.STATE_FILE,
                       weights_only=True)
    assert set(state) == {"step", "params", "batch_stats", "opt_state", "ema_params",
                          "ema_batch_stats", "ema_updates", "rng", "config"}
    assert state["step"] == 1 and state["opt_state"]["count"] == 1 and state["ema_updates"] == 1
    assert yaml.safe_load(state["config"])["run_name"] == "ckpt_test"
    assert set(state["params"]) | set(state["batch_stats"]) == set(tr.model.state_dict())


# ---------------------------------------------------------------------------
# 8. The run log against hvt's
# ---------------------------------------------------------------------------


def _records(path):
    out = []
    for line in path.read_text().splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            out.append((rec["step"], sorted(k for k in rec if k not in ("step", "time"))))
    return out


def test_run_log_matches_hvts(tmp_path):
    layer = _train_layer(tmp_path / "port", max_duration="5ba", eval_interval="2ba",
                         train_dataset={"synthetic_num_samples": 16})
    layer["algorithms"] = layer["algorithms"][1:]  # hvt's EMA stats are not the point here
    assert tconfig.to_yaml(tconfig.loads(layer)) == jconfig.to_yaml(jconfig.loads(layer))
    port = _trainer(layer, log_interval=3)
    port.fit()
    port.close()
    jlayer = {**layer, "machine": {"save_root": str(tmp_path / "hvt")}}
    ref = jloop.Trainer(jconfig.loads(jlayer), mesh=parallel.cpu_mesh(1), log_interval=3)
    ref.fit()
    ref.close()
    got = _records(tmp_path / "port" / "ckpt_test" / "logs" / "log0.txt")
    want = _records(tmp_path / "hvt" / "ckpt_test" / "logs" / "log0.txt")
    assert got == want
    prefixes = {k.split("/")[0] for _, keys in got for k in keys}
    assert prefixes == {"eval", "train", "train-epoch"}
    train = [keys for _, keys in got if "train/lr" in keys]
    assert train and all("train/samples_per_sec" in keys for keys in train)
    text = (tmp_path / "port" / "ckpt_test" / "logs" / "log0.txt").read_text()
    assert text.startswith(tconfig.to_yaml(tconfig.loads(layer)))


# ---------------------------------------------------------------------------
# 9. Serving's weights
# ---------------------------------------------------------------------------


def test_inference_engine_serves_a_checkpoint(tmp_path, monkeypatch):
    layer = _train_layer(tmp_path, max_duration="2ba")
    tr = _trainer(layer)
    tr.fit()
    tr.close()
    cfg = tconfig.loads({**layer, "load_path": f"ckpt://{tmp_path}/ckpt_test/checkpoints:2"})
    x = _images(9, n=4)
    cases = ((True, tr.ema.params, tr.ema.batch_stats),
             (False, dict(tr.model.named_parameters()), tema.batch_stats(tr.model)))
    for use_ema, params, stats in cases:
        engine = serve_lib.InferenceEngine(cfg, batch=4, use_ema=use_ema, device="cpu")
        try:
            np.testing.assert_array_equal(_port_logits(engine.model, x=x),
                                          _port_logits(tr.model, params, stats, x))
        finally:
            engine.close()
    # the CLI's --raw-weights reaches the engine as use_ema=False
    captured = {}
    monkeypatch.setattr(serve_lib, "serve", lambda config, **kw: captured.update(kw))
    exp = tmp_path / "serve.yaml"
    exp.write_text(yaml.safe_dump(tconfig.to_dict(cfg)))
    tserve.main(["--machine", "configs/machines/local.yaml", "--exp", str(exp), "--raw-weights",
                 "--device", "cpu"])
    assert captured["use_ema"] is False and captured["device"] == "cpu"


# ---------------------------------------------------------------------------
# 10. The loader's start_batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("start", [0, 1, 3])
def test_start_batch_yields_hvts_batches(tmp_path, shuffle, start):
    layer = _train_layer(tmp_path, train_dataset={"shuffle": shuffle, "synthetic_num_samples": 30})
    ref, _ = jloader.build_loader(jconfig.loads(layer), is_train=True)
    got, _ = tloader.build_loader(tconfig.loads(layer), is_train=True)
    for epoch in (0, 1):
        pairs = list(zip(got.epoch(epoch, start_batch=start), ref.epoch(epoch, start_batch=start)))
        assert len(pairs) == ref.batches_per_epoch - start
        for a, b in pairs:
            for field in ("images", "labels", "mask"):
                np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
