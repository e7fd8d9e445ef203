"""Batch prediction (``hvt_torch.downstream.predict``, ``python -m
hvt_torch.predict``) and ``python -m hvt_torch.tools.serve_bench`` against
hvt's, on the CPU.

Both packages serve the same weights from ``load_path``: hvt's seeded
flax tree (every leaf drawn, the head too) saved as an hvt checkpoint for
hvt and as a port checkpoint (``<dir>/0/state.pt``) through the port's
converters. Held here:

* ``predict`` on a ``resnet_micro`` (synthetic eval split and the
  class-coloured folder of tests/test_torch_port_downstream.py) and on a
  multitask two-stage ``swinv2_micro`` on ``fuse: true`` (hvt's Pallas
  kernels in interpret mode), flat and with the hierarchical decode: every
  record's ``classes``, ``class_ids``, ``label``, ``path`` and ``tier_ids``
  equal to hvt's, ``probs`` within 1e-4; ``limit_batches``; ``run``'s JSONL
  and summary equal to hvt's;
* the CLI: hvt's flags, ``--device cpu``, and ``--artifact``, ``--quantize``
  and ``--calibrate`` refused with the message the server gives;
  ``predict(artifact=...)`` raises;
* ``run_bench`` on a CPU engine (2 clients × 2 requests, engine and HTTP
  modes): hvt's record keys, hvt's ``run_bench`` on the same engine giving
  the same keys; ``serve_bench``'s CLI flags and its ``--artifact`` refusal.
"""

import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

import test_torch_port_downstream as downstream
from hvt import config as jconfig
from hvt.downstream import predict as jpredict
from hvt.models import build_model as jbuild_model
from hvt.tools import serve_bench as jbench
from hvt.train import checkpoint as jckpt
from hvt_torch import config as tconfig
from hvt_torch.downstream import predict as tpredict
from hvt_torch.downstream import serve as serve_lib
from hvt_torch.models import build_model as tbuild_model
from hvt_torch.models import convert
from hvt_torch.tools import serve_bench as tbench
from hvt_torch.train import checkpoint as tckpt
from hvt_torch.train import ema as tema

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUM_CLASSES = 6


def _layer(model, source, root=None, multitask=False):
    batch = downstream.BATCH[model]
    data = ({"source": "synthetic", "synthetic_num_classes": NUM_CLASSES,
             "synthetic_num_samples": 7, "crop_size": downstream.IMG, "global_batch_size": batch}
            if source == "synthetic" else
            {"path": "fix", "crop_size": downstream.IMG, "resize_size": 34,
             "global_batch_size": batch})
    layer = {"run_name": "predict_test", "seed": 0,
             "model": {"name": model, "args": downstream.MODEL_ARGS[model]},
             "eval_dataset": data, "precision": {"compute_dtype": "float32"},
             "loader": {"num_workers": 1}, "save": {"wandb": False}}
    if root is not None:
        layer["machine"] = {"datasets": {"fix": str(root)}}
    if multitask:
        layer["hierarchy"] = {"variant": "multitask", "multitask_coeffs": [1.0] * 7}
    return layer


def _write_checkpoints(tmp_path, layer, num_classes):
    """hvt's seeded variables as an hvt checkpoint and as a port checkpoint
    → (hvt's config, the port's), each with its ``load_path``."""
    jm = jbuild_model(jconfig.loads(layer), num_classes)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))
    variables = downstream._randomized(dict(shapes), seed=5)
    stats = variables.get("batch_stats", {})
    saver = jckpt.Checkpointer(tmp_path / "hvt-ckpt")
    saver.save(0, {"params": variables["params"], "batch_stats": stats})
    saver.close()

    tm = tbuild_model(tconfig.loads(layer), num_classes)
    if layer["model"]["name"].startswith("swin"):
        convert.swin_params_from_flax(tm, variables["params"])
    else:
        convert.resnet_params_from_flax(tm, variables)
    port = tckpt.Checkpointer(tmp_path / "port-ckpt")
    port.save(0, {"params": {k: v.detach() for k, v in tm.named_parameters()},
                  "batch_stats": tema.batch_stats(tm), "ema_params": None})
    port.close()
    return (jconfig.loads(layer, {"load_path": f"ckpt://{tmp_path / 'hvt-ckpt'}"}),
            tconfig.loads(layer, {"load_path": str(tmp_path / "port-ckpt")}))


def _num_classes(layer):
    from hvt_torch.data import build_loader

    return build_loader(tconfig.loads(layer))[1].num_classes


CASES = {  # name: (model, source, multitask, hierarchical)
    "resnet_synthetic": ("resnet_micro", "synthetic", False, False),
    "resnet_folder": ("resnet_micro", "folder", False, False),
    "swin_fused_multitask": ("swinv2_micro", "synthetic", True, False),
    "swin_fused_hierarchical": ("swinv2_micro", "synthetic", True, True),
    "resnet_folder_hierarchical": ("resnet_micro", "folder", True, True),
}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return downstream.write_folder(tmp_path_factory.mktemp("predict-fixture"))


def _pair(case, folder, tmp_path):
    model, source, multitask, _ = CASES[case]
    layer = _layer(model, source, folder if source == "folder" else None, multitask)
    return _write_checkpoints(tmp_path, layer, _num_classes(layer))


def _assert_records_match(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for key in ("classes", "class_ids", "label", "path", "tier_ids"):
            assert g.get(key) == r.get(key), (key, g, r)
        np.testing.assert_allclose(g["probs"], r["probs"], atol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_records_match_hvt(case, folder, tmp_path):
    jcfg, tcfg = _pair(case, folder, tmp_path)
    hierarchical = CASES[case][3]
    ref = list(jpredict.predict(jcfg, topk=3, hierarchical=hierarchical))
    got = list(tpredict.predict(tcfg, topk=3, hierarchical=hierarchical, device="cpu"))
    _assert_records_match(got, ref)
    assert len(got) == (8 if CASES[case][1] == "folder" else 7)  # the padded rows skipped
    if CASES[case][2]:
        assert all(isinstance(r["label"], list) and len(r["label"]) == 7 for r in got)
    if hierarchical:
        assert all(len(r["tier_ids"]) == 7 for r in got)
    if CASES[case][1] == "folder":
        assert all(pathlib.Path(r["path"]).is_file() for r in got)


def test_run_and_limit_batches_match_hvt(folder, tmp_path):
    jcfg, tcfg = _pair("resnet_folder", folder, tmp_path)
    ref = jpredict.run(jcfg, str(tmp_path / "hvt.jsonl"), topk=2)
    got = tpredict.run(tcfg, str(tmp_path / "port.jsonl"), topk=2, device="cpu")
    assert got == ref and got["count"] == 8
    rows = [json.loads(line) for line in (tmp_path / "port.jsonl").read_text().splitlines()]
    ref_rows = [json.loads(line) for line in (tmp_path / "hvt.jsonl").read_text().splitlines()]
    _assert_records_match(rows, ref_rows)
    limited = list(tpredict.predict(tcfg, limit_batches=1, device="cpu"))
    assert len(limited) == len(list(jpredict.predict(jcfg, limit_batches=1))) == 4
    # the checkpoint has no EMA copy: use_ema=False serves the same weights
    raw = tpredict.predict(tcfg, topk=2, use_ema=False, device="cpu")
    assert [r["class_ids"] for r in raw] == [r["class_ids"] for r in rows]


def _config_file(tmp_path) -> pathlib.Path:
    path = tmp_path / "predict.yaml"
    path.write_text(yaml.safe_dump(_layer("resnet_micro", "synthetic")))
    return path


def test_predict_cli(tmp_path):
    exp = _config_file(tmp_path)
    run = lambda *a: subprocess.run([sys.executable, "-m", "hvt_torch.predict", *a],  # noqa: E731
                                    cwd=ROOT, capture_output=True, text=True, timeout=300)
    out = run("--help")
    assert out.returncode == 0, out.stderr
    for flag in ("--machine", "--exp", "--output", "--topk", "--raw-weights", "--hierarchical",
                 "--limit-batches", "--device", "--artifact", "--quantize", "--calibrate"):
        assert flag in out.stdout
    out = run("--machine", str(ROOT / "configs/machines/local.yaml"), "--exp", str(exp),
              "--output", str(tmp_path / "p.jsonl"), "--topk", "2", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    rows = [json.loads(line) for line in (tmp_path / "p.jsonl").read_text().splitlines()]
    assert len(rows) == 7 and all(len(r["class_ids"]) == 2 for r in rows)
    assert "wrote 7 predictions" in out.stdout
    for args in (("--artifact", "some/dir"),
                 ("--machine", "m.yaml", "--exp", "e.yaml", "--quantize", "int8"),
                 ("--calibrate", "8", "--machine", "m.yaml")):
        out = run(*args)
        assert out.returncode != 0 and "not ported to hvt_torch yet" in out.stderr


@pytest.mark.parametrize("kwargs", [{"artifact": "dir"}, {"quantize": "int8"}, {"calibrate": 4}])
def test_predict_refuses_artifacts_and_int8(kwargs):
    cfg = tconfig.loads(_layer("resnet_micro", "synthetic"))
    with pytest.raises(NotImplementedError, match="queue 1, item 10"):
        tpredict.predict(cfg, device="cpu", **kwargs)


# ---------------------------------------------------------------------------
# serve_bench
# ---------------------------------------------------------------------------

RECORD_KEYS = {"metric", "model", "mode", "clients", "requests_per_client", "batch",
               "failed_requests", "throughput_rps", "latency_ms"}


def test_run_bench_gives_hvts_record():
    cfg = tconfig.loads(_layer("swinv2_micro", "synthetic"))
    engine = serve_lib.InferenceEngine(cfg, batch=2, topk=3, device="cpu")
    try:
        records = {mode: tbench.run_bench(engine, clients=2, requests=2, http=mode == "http")
                   for mode in ("engine", "http")}
        ref = jbench.run_bench(engine, clients=2, requests=2)
    finally:
        engine.close()
    for mode, rec in records.items():
        assert set(rec) == set(ref) == RECORD_KEYS
        assert set(rec["latency_ms"]) == set(ref["latency_ms"]) == {"p50", "p90", "p99", "mean",
                                                                    "max"}
        assert (rec["metric"], rec["model"], rec["mode"], rec["clients"],
                rec["requests_per_client"], rec["batch"], rec["failed_requests"]) == (
            "serving_latency", "swinv2_micro", mode, 2, 2, 2, 0)
        assert rec["throughput_rps"] > 0
        lat = rec["latency_ms"]
        assert 0 < lat["p50"] <= lat["p90"] <= lat["p99"] <= lat["max"]
    assert tbench._jpeg_bytes() == jbench._jpeg_bytes()
    assert engine.stats()["errors"] == 0


def test_serve_bench_cli(tmp_path, capsys):
    exp = _config_file(tmp_path)
    rec = tbench.main(["--machine", str(ROOT / "configs/machines/local.yaml"), "--exp", str(exp),
                       "--clients", "2", "--requests", "2", "--batch", "2", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert set(rec) == RECORD_KEYS and rec["model"] == "resnet_micro" and rec["batch"] == 2
    help_text = tbench.build_parser().format_help()
    for flag in ("--clients", "--requests", "--batch", "--topk", "--http", "--device", "--artifact"):
        assert flag in help_text
    with pytest.raises(SystemExit):
        tbench.main(["--artifact", "some/dir"])
    assert "not ported to hvt_torch yet" in capsys.readouterr().err
