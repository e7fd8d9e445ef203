"""The port's serving path on the CPU, and the rules the port keeps.

* ``InferenceEngine(device="cpu")`` behind ``make_server`` on port 0:
  status codes, top-k records (held against a direct forward of the same
  image), ``/healthz``, ``/stats``, the hierarchical decode, ``close()``.
* ``python -m hvt_torch.serve``: the config-mode flag surface of hvt's
  ``serve.py``, and the modes that are not ported yet exit with a message.
* The host-side pieces against hvt's: config trees, synthetic data, folder
  scans, the eval transform and device prep.
* Hygiene: importing every ``hvt_torch`` module and ``chip_smoke.py``
  loads neither jax nor hvt nor sklearn (the card's machine has none of
  them), and an entry point given no device (the server, feature
  extraction, batch prediction, serve_bench) raises when CUDA is absent
  instead of drifting to the CPU.
"""

import http.client
import io
import json
import pathlib
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from hvt import config as jconfig
from hvt.data import device as jdevice
from hvt.data import folder as jfolder
from hvt.data import loader as jloader
from hvt.data import synthetic as jsynthetic
from hvt.data import transforms as jtransforms
from hvt_torch import config as tconfig
from hvt_torch import device as device_lib
from hvt_torch.data import device as tdevice
from hvt_torch.data import folder as tfolder
from hvt_torch.data import loader as tloader
from hvt_torch.data import synthetic as tsynthetic
from hvt_torch.data import transforms as ttransforms
from hvt_torch.downstream import serve as serve_lib
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = pathlib.Path(__file__).resolve().parents[1]
NUM_CLASSES = 10


def _config(hierarchical: bool = False):
    return tconfig.loads({
        "run_name": "serve_test",
        "seed": 0,
        "model": {"name": "swinv2_micro", "args": {"fuse": True}},
        "eval_dataset": {"source": "synthetic", "crop_size": 32, "resize_size": 36,
                         "synthetic_num_classes": NUM_CLASSES, "synthetic_num_samples": 8,
                         "global_batch_size": 4},
        "precision": {"compute_dtype": "float32"},
        "hierarchy": {"variant": "multitask" if hierarchical else ""},
    })


def _png(seed: int, size=(40, 48)) -> bytes:
    arr = np.random.default_rng(seed).integers(0, 256, size=(*size, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _request(url, data=None):
    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=data), timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served():
    engine = serve_lib.InferenceEngine(_config(), batch=4, topk=5, device="cpu")
    server = serve_lib.make_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield engine, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    engine.close()


def test_server_answers_batched_predictions(served):
    engine, url = served
    images = [_png(i) for i in range(6)]  # more than one batch of 4
    before = engine.stats()
    with ThreadPoolExecutor(6) as pool:
        replies = list(pool.map(lambda b: _request(f"{url}/predict?topk=3", b), images))
    for data, (code, rec) in zip(images, replies):
        assert code == 200, rec
        assert set(rec) == {"classes", "class_ids", "probs"}
        assert len(rec["class_ids"]) == 3 and rec["probs"] == sorted(rec["probs"], reverse=True)
        # the same image alone through the model, outside the batcher
        with Image.open(io.BytesIO(data)) as img:
            arr = engine.transform(img.convert("RGB"))
        prep = tdevice.DevicePrep.from_config(engine.config.eval_dataset, engine.config.precision)
        with torch.inference_mode():
            logits = engine.model(prep.normalize(torch.from_numpy(arr[None].copy())))
        top_p, top_i = torch.softmax(logits, -1).topk(3)
        assert rec["class_ids"] == top_i[0].tolist()
        assert rec["classes"] == [engine.classes[i] for i in rec["class_ids"]]
        np.testing.assert_allclose(rec["probs"], top_p[0].numpy(), atol=1e-5)
    stats = engine.stats()
    assert stats["requests"] - before["requests"] == 6
    assert stats["dispatches"] - before["dispatches"] >= 2
    assert stats["errors"] == before["errors"]


def test_server_takes_a_burst_of_concurrent_connections(served):
    """48 clients connect at once: every one is answered. (With
    socketserver's default listen backlog of 5, connections of such a burst
    are reset or retried a second later.)"""
    engine, url = served
    port = int(url.rsplit(":", 1)[1])
    body = _png(0)

    def one(_):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            conn.request("POST", "/predict", body=body)
            return conn.getresponse().status
        finally:
            conn.close()

    with ThreadPoolExecutor(48) as pool:
        codes = list(pool.map(one, range(48)))
    assert codes == [200] * 48


def test_server_endpoints_and_client_errors(served):
    engine, url = served
    code, health = _request(f"{url}/healthz")
    assert code == 200
    assert health == {"status": "ok", "model": "swinv2_micro", "classes": NUM_CLASSES,
                      "hierarchical": False, "native_artifact": False}
    assert _request(f"{url}/predict?topk=0", _png(0))[0] == 400
    assert _request(f"{url}/predict?topk=x", _png(0))[0] == 400
    assert _request(f"{url}/predict", b"not an image")[0] == 400
    assert _request(f"{url}/nowhere")[0] == 404
    assert _request(f"{url}/nowhere", _png(0))[0] == 404
    code, stats = _request(f"{url}/stats")
    assert code == 200 and stats["model"] == "swinv2_micro" and stats["batch"] == 4
    assert stats["errors"] >= 1  # the undecodable body
    assert set(stats) == {"model", "batch", "requests", "errors", "dispatches",
                          "mean_rows_per_dispatch", "mean_occupancy", "mean_step_ms"}


def test_hierarchical_engine_decodes_top_down():
    engine = serve_lib.InferenceEngine(_config(hierarchical=True), batch=2, topk=5,
                                       hierarchical=True, device="cpu")
    try:
        assert isinstance(engine.num_classes, tuple) and len(engine.num_classes) == 7
        rec = engine.predict_image(_png(3))
        assert len(rec["tier_ids"]) == 7
        # the fine tier is restricted to the children of the predicted genus
        assert 1 <= len(rec["class_ids"]) <= 5
        assert all(engine.classes[i].split("_")[-2] == engine.classes[rec["class_ids"][0]].split("_")[-2]
                   for i in rec["class_ids"])
    finally:
        engine.close()
    with pytest.raises(RuntimeError, match="closed"):
        engine.predict_image(_png(3))


def test_serve_cli_flag_surface():
    run = lambda *a: subprocess.run([sys.executable, "-m", "hvt_torch.serve", *a],  # noqa: E731
                                    cwd=ROOT, capture_output=True, text=True, timeout=120)
    out = run("--help")
    assert out.returncode == 0, out.stderr
    for flag in ("--machine", "--exp", "--host", "--port", "--topk", "--batch", "--raw-weights",
                 "--hierarchical", "--quantize", "--calibrate", "--artifact", "--device"):
        assert flag in out.stdout
    for args, message in ((("--artifact", "some/dir"), "not ported"),
                          (("--machine", "m.yaml", "--exp", "e.yaml", "--quantize", "int4"),
                           "invalid choice: 'int4'"),
                          (("--calibrate", "8", "--machine", "m.yaml", "--exp", "e.yaml"),
                           "--calibrate requires --quantize int8")):
        out = run(*args)
        assert out.returncode != 0 and message in out.stderr


# ---------------------------------------------------------------------------
# Host-side pieces against hvt's
# ---------------------------------------------------------------------------


def test_config_trees_match_hvt():
    layers = dict(machine=str(ROOT / "configs/machines/local.yaml"),
                  exps=[str(ROOT / "configs/pretrain/swinv2_tiny.yaml")])
    assert tconfig.to_dict(tconfig.load(**layers)) == jconfig.to_dict(jconfig.load(**layers))
    raw = {"model": {"name": "swinv2_tiny", "args": {"fuse": True}}, "seed": 3}
    assert tconfig.to_dict(tconfig.loads(raw)) == jconfig.to_dict(jconfig.loads(raw))


@pytest.mark.parametrize("hierarchical", [False, True])
def test_synthetic_data_and_eval_loader_match_hvt(hierarchical):
    kw = dict(num_samples=10, num_leaf_classes=12, crop_size=16, hierarchical=hierarchical, seed=3)
    a, b = tsynthetic.build_synthetic(**kw), jsynthetic.build_synthetic(**kw)
    assert a.classes == b.classes and a.num_classes == b.num_classes
    np.testing.assert_array_equal(a.labels, b.labels)
    for i in (0, 7):
        np.testing.assert_array_equal(a.load(i), b.load(i))

    cfg = _config(hierarchical)
    loader, info = tloader.build_loader(cfg)
    jdataset, jinfo = jloader.build_dataset(jconfig.loads(tconfig.to_dict(cfg)), False)
    assert tuple(loader.dataset.classes) == tuple(jdataset.classes)
    assert info.num_classes == jinfo.num_classes
    assert loader.local_batch_size == 4 and loader.transform.crop_size == 32
    np.testing.assert_array_equal(loader.dataset.load(2), jdataset.load(2))


def test_image_folder_scan_matches_hvt(tmp_path):
    names = ["00000_animalia_chordata_aves_accipitriformes_accipitridae_accipiter_badius",
             "00001_animalia_chordata_aves_accipitriformes_accipitridae_accipiter_nisus",
             "00002_plantae_tracheophyta_magnoliopsida_rosales_rosaceae_rosa_canina"]
    for i, name in enumerate(names):
        (tmp_path / "val" / name).mkdir(parents=True)
        for j in range(2):
            (tmp_path / "val" / name / f"{j}.png").write_bytes(_png(10 * i + j, (8, 8)))
    for hierarchical in (False, True):
        a = tfolder.scan_image_folder(tmp_path, "val", hierarchical=hierarchical)
        b = jfolder.scan_image_folder(tmp_path, "val", hierarchical=hierarchical)
        assert (a.paths, a.classes, a.num_classes) == (b.paths, b.classes, b.num_classes)
        np.testing.assert_array_equal(a.labels, b.labels)


@pytest.mark.parametrize("size,mode", [((50, 40), "RGB"), ((30, 70), "L"), ((20, 24), "RGB")])
def test_eval_transform_matches_hvt(size, mode):
    arr = np.random.default_rng(sum(size)).integers(0, 256, size=(*size[::-1], 3), dtype=np.uint8)
    img = Image.fromarray(arr).convert(mode)
    for crop, resize in ((32, 36), (32, -1)):
        np.testing.assert_array_equal(ttransforms.EvalTransform(crop, resize)(img),
                                      jtransforms.EvalTransform(crop, resize)(img))
    np.testing.assert_array_equal(np.asarray(ttransforms.resize_shorter(img, 33)),
                                  np.asarray(jtransforms.resize_shorter(img, 33)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_prep_normalize_matches_hvt(dtype):
    cfg = _config()
    cfg.precision.compute_dtype = dtype
    images = np.random.default_rng(0).integers(0, 256, size=(2, 8, 8, 3), dtype=np.uint8)
    got = tdevice.DevicePrep.from_config(cfg.eval_dataset, cfg.precision).normalize(
        torch.from_numpy(images))
    ref = jdevice.DevicePrep.from_config(cfg.eval_dataset, cfg.precision).normalize(
        jnp.asarray(images))
    assert got.dtype == getattr(torch, dtype)
    # same f32 arithmetic; the bf16 cast may round one ulp apart where XLA
    # reassociates the division
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# Hygiene
# ---------------------------------------------------------------------------

_IMPORTS_EVERYTHING = """
import importlib, importlib.util, json, pkgutil, sys
import hvt_torch
for m in pkgutil.walk_packages(hvt_torch.__path__, "hvt_torch."):
    importlib.import_module(m.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "hvt", "sklearn"))))
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] == "hvt_torch")))
"""
# the training slices' modules, which the walk above must reach
_TRAINING_MODULES = {
    "hvt_torch.main", "hvt_torch.objectives", "hvt_torch.metrics", "hvt_torch.models.common",
    "hvt_torch.train.algorithms", "hvt_torch.train.loop", "hvt_torch.train.optim",
    "hvt_torch.train.schedule", "hvt_torch.train.step", "hvt_torch.ops.window_attention_cuda",
    "hvt_torch.train.ema", "hvt_torch.models.resnet", "hvt_torch.ops.bn_stats",
    "hvt_torch.ops.bn_stats_cuda", "hvt_torch.parallel",
}
# the downstream slice's modules: the card's machine has no sklearn either
_DOWNSTREAM_MODULES = {
    "hvt_torch.linear_probe", "hvt_torch.simpleshot", "hvt_torch.predict",
    "hvt_torch.tools.serve_bench", "hvt_torch.downstream.features",
    "hvt_torch.downstream.centroid", "hvt_torch.downstream.linear",
    "hvt_torch.downstream.predict",
}


def test_port_imports_neither_jax_nor_hvt():
    out = subprocess.run([sys.executable, "-c", _IMPORTS_EVERYTHING], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    foreign, imported = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert foreign == []
    wanted = _TRAINING_MODULES | _DOWNSTREAM_MODULES
    assert wanted <= set(imported), wanted - set(imported)
    # and no import of them hides inside a function
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|hvt|sklearn)(\.|\s|$)", re.M)
    for path in [*sorted((ROOT / "hvt_torch").rglob("*.py")), ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path


def test_entry_points_never_drift_to_the_cpu(monkeypatch, tmp_path):
    from hvt_torch.downstream import features, predict
    from hvt_torch.tools import serve_bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_lib.resolve()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lib.InferenceEngine(_config())
    cfg = tconfig.loads(tconfig.to_dict(_config()), {"machine": {"save_root": str(tmp_path)},
                                                       "train_dataset": {"source": "synthetic"}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        features.extract_features(cfg, is_train=False, kind="simpleshot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.predict(cfg)
    exp = tmp_path / "exp.yaml"
    exp.write_text(tconfig.to_yaml(cfg))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_bench.main(["--machine", str(ROOT / "configs/machines/local.yaml"), "--exp", str(exp)])
    with pytest.raises(RuntimeError, match="not available"):
        device_lib.resolve("cuda")
    assert device_lib.resolve("cpu") == torch.device("cpu")


def test_engine_refuses_on_the_card_a_model_the_kernels_cannot_take(monkeypatch):
    # swinv2_micro fused (width 16) is a CPU-only model: on the card the engine
    # refuses it before any weight moves
    monkeypatch.setattr(device_lib, "resolve", lambda device=None: torch.device("cuda"))
    with pytest.raises(NotImplementedError, match="width 16 is not one the kernels are built for"):
        serve_lib.InferenceEngine(_config())
