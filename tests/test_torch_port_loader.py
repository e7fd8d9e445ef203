"""The port's training input path against hvt's, on the CPU.

Both sides are numpy, Pillow and the same C++ core, so every comparison is
bit for bit, on a seeded folder of small JPEGs (64-120 px, written by
Pillow into ``tmp_path``):

* ``sample_crop_box``, ``TrainTransform`` (crop, flip, host RandAugment,
  host ColOut, a shorter-side resize) and each of the 13 host RandAugment
  ops, given the same ``np.random.Generator``;
* the native core (``hvt_torch/data/_native/decode.cc``, built by the test with
  g++ and libjpeg) against hvt's: ``load_batch`` on the same paths and
  seeds, train and eval, at two sizes, and ``decode_eval``;
* the ``Loader`` against hvt's on the same folder, seed and epoch
  (process 0 of 1), on both decode routes, with and without the host post
  ops, at 1 and 3 workers: images, labels, mask and indices; a resume at
  ``start_batch``; a worker's exception raised again in the consumer; an
  early ``break`` that leaves no live producer; a corrupt file decoded
  again through Pillow as hvt does;
* ``build_transform``'s routing of host and device RandAugment/ColOut, the
  decoder the loader reports, and a Trainer that trains from the folder.
"""

import os
import pathlib
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from PIL import Image

from hvt import config as jconfig
from hvt.data import loader as jloader
from hvt.data import native as jnative
from hvt.data import transforms as jtransforms
from hvt_torch import config as tconfig
from hvt_torch import main as tmain
from hvt_torch.data import loader as tloader
from hvt_torch.data import native as tnative
from hvt_torch.data import transforms as ttransforms
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CLASSES = ("00000_animalia_chordata_aves_accipitriformes_accipitridae_accipiter_badius",
           "00001_animalia_chordata_aves_accipitriformes_accipitridae_accipiter_nisus",
           "00002_plantae_tracheophyta_magnoliopsida_rosales_rosaceae_rosa_canina")
SIZES = ((96, 72), (64, 120), (120, 80), (80, 80), (100, 64))  # (w, h)


def _write_folder(root, per_class: int, seed: int):
    """train/ (``per_class`` JPEGs a class) and val/ (2 a class); smooth
    content with noise, so crops and ops see structure."""
    rng = np.random.default_rng(seed)
    k = 0
    for split, n in (("train", per_class), ("val", 2)):
        for name in CLASSES:
            (root / split / name).mkdir(parents=True)
            for j in range(n):
                w, h = SIZES[k % len(SIZES)]
                k += 1
                gy, gx = np.mgrid[0:h, 0:w]
                base = np.stack([gx * 2, gy * 2, (gx + gy)], -1) % 256
                arr = (base + rng.integers(0, 60, size=(h, w, 3))).clip(0, 255).astype(np.uint8)
                Image.fromarray(arr).save(root / split / name / f"{j}.jpg", quality=90)
    return root


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return _write_folder(tmp_path_factory.mktemp("jpegs"), per_class=4, seed=3)


@pytest.fixture(scope="module")
def native_pair():
    if not (tnative.available() and jnative.available()):
        pytest.skip("the native core needs g++ and libjpeg: "
                    f"{tnative.unavailable_reason()}")
    return tnative, jnative


def _image(seed, w=88, h=70):
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[0:h, 0:w]
    base = np.stack([gx * 3, gy * 3, gx + gy], -1) % 256
    return Image.fromarray((base + rng.integers(0, 40, (h, w, 3))).clip(0, 255).astype(np.uint8))


# ---------------------------------------------------------------------------
# Host transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w,h", [(500, 375), (64, 120), (30, 300), (300, 30)])
def test_sample_crop_box_matches_hvt(w, h):
    for seed in range(50):
        got = ttransforms.sample_crop_box(w, h, np.random.default_rng(seed))
        ref = jtransforms.sample_crop_box(w, h, np.random.default_rng(seed))
        assert got == ref
    # the clamped centre crop after 10 misses
    for ratio in ((3 / 4, 4 / 3), (2.0, 3.0)):
        kw = dict(scale=(0.99, 1.0), ratio=ratio)
        assert (ttransforms.sample_crop_box(w, h, np.random.default_rng(1), **kw)
                == jtransforms.sample_crop_box(w, h, np.random.default_rng(1), **kw))


@pytest.mark.parametrize("resize,depth,colout", [
    (-1, 0, None), (56, 0, None), (-1, 1, None), (-1, 2, (0.05, 0.05)), (56, 1, (0.2, 0.1))])
def test_train_transform_matches_hvt(resize, depth, colout):
    kw = dict(crop_size=48, resize_size=resize, randaugment_depth=depth, colout_p=colout)
    got_tf, ref_tf = ttransforms.TrainTransform(**kw), jtransforms.TrainTransform(**kw)
    assert got_tf.has_post_ops == ref_tf.has_post_ops == (depth > 0 or colout is not None)
    for seed in range(12):
        img = _image(seed).convert("L" if seed % 5 == 4 else "RGB")
        got = got_tf(img, np.random.default_rng((seed, 1)))
        ref = ref_tf(img, np.random.default_rng((seed, 1)))
        assert got.shape == (48, 48, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)
        arr = np.asarray(_image(seed + 100, 48, 48))
        np.testing.assert_array_equal(got_tf.post_augment(arr, np.random.default_rng(seed)),
                                      ref_tf.post_augment(arr, np.random.default_rng(seed)))


@pytest.mark.parametrize("op", range(13))
def test_host_randaugment_op_matches_hvt(op):
    assert ttransforms.RANDAUGMENT_OPS[op].__name__ == jtransforms.RANDAUGMENT_OPS[op].__name__
    for seed in range(6):
        img = _image(seed)
        for sev in (3, 9):
            got = ttransforms.RANDAUGMENT_OPS[op](img, sev, np.random.default_rng(seed))
            ref = jtransforms.RANDAUGMENT_OPS[op](img, sev, np.random.default_rng(seed))
            np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_host_rand_augment_and_colout_match_hvt():
    for seed in range(10):
        img = _image(seed)
        got = ttransforms.rand_augment(img, np.random.default_rng(seed), depth=2, severity=9)
        ref = jtransforms.rand_augment(img, np.random.default_rng(seed), depth=2, severity=9)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
        arr = np.asarray(img)
        got = ttransforms.colout(arr, np.random.default_rng(seed), 0.3, 0.2)
        ref = jtransforms.colout(arr, np.random.default_rng(seed), 0.3, 0.2)
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# The native core
# ---------------------------------------------------------------------------


def _paths(root, split="train"):
    return sorted(str(p) for p in (root / split).rglob("*.jpg"))


def test_native_core_builds_from_the_port_into_its_build_dir(native_pair):
    path = tnative.library_path()
    assert path.exists() and path.parent.name == "_build" and path.parent.parent.name == "ops"
    assert tnative._SRC_PATH.parts[-4:] == ("hvt_torch", "data", "_native", "decode.cc")
    assert tnative.unavailable_reason() is None


def test_a_library_that_does_not_load_is_rebuilt_once(tmp_path, native_pair):
    """A library under the core's name that does not load here (one built on
    another machine against another libjpeg) is rebuilt before the loader
    falls back to Pillow; without g++ the reason names the failed build."""
    script = (
        "import sys, pathlib\n"
        "from hvt_torch.data import native\n"
        f"native.BUILD_DIR = pathlib.Path({str(tmp_path)!r})\n"
        "out = native.library_path(); out.parent.mkdir(exist_ok=True)\n"
        "out.write_bytes(b'not a library')\n"
        "ok = native.available()\n"
        "print(ok, native.unavailable_reason(), out.stat().st_size > 1000)\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    run = subprocess.run([sys.executable, "-c", script], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    assert run.stdout.split() == ["True", "None", "True"]
    env = {**os.environ, "PATH": str(tmp_path / "no-compiler")}
    run = subprocess.run([sys.executable, "-c", script.replace(str(tmp_path), str(tmp_path / "b"))],
                         cwd=root, capture_output=True, text=True, timeout=300, env=env)
    assert run.returncode == 0, run.stderr
    assert "False g++ build failed" in run.stdout and "decodes with Pillow" in run.stdout


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("resize,size", [(-1, 48), (72, 64)])
def test_native_load_batch_matches_hvt(folder, native_pair, is_train, resize, size):
    paths = _paths(folder)
    seeds = [((7 & 0xFFFFF) << 44) ^ ((2 & 0xFFFFF) << 24) ^ i for i in range(len(paths))]
    for threads in (1, 3):
        got, got_fail = tnative.load_batch(paths, seeds, is_train=is_train, resize_size=resize,
                                           out_size=size, num_threads=threads)
        ref, ref_fail = jnative.load_batch(paths, seeds, is_train=is_train, resize_size=resize,
                                           out_size=size, num_threads=threads)
        assert got_fail == ref_fail == 0 and got.shape == (len(paths), size, size, 3)
        np.testing.assert_array_equal(got, ref)


def test_native_decode_eval_matches_hvt(folder, native_pair):
    for path in _paths(folder, "val"):
        data = pathlib.Path(path).read_bytes()
        for resize, size in ((-1, 48), (72, 64)):
            got = tnative.decode_eval(data, resize_size=resize, out_size=size)
            ref = jnative.decode_eval(data, resize_size=resize, out_size=size)
            np.testing.assert_array_equal(got, ref)
    assert tnative.decode_eval(b"not a jpeg", resize_size=-1, out_size=48) is None


# ---------------------------------------------------------------------------
# The Loader
# ---------------------------------------------------------------------------


def _layer(root, *, batch=5, workers=1, algorithms=(), shuffle=True, drop_last=False, **extra):
    return {
        "run_name": "loader_test", "seed": 7, "max_duration": "2ba", "grad_accum": 1,
        "model": {"name": "resnet_micro_bottleneck", "args": {"stem_s2d": True}},
        "machine": {"datasets": {"fix": str(root)}},
        "train_dataset": {"path": "fix", "crop_size": 48, "resize_size": -1,
                          "global_batch_size": batch, "shuffle": shuffle, "drop_last": drop_last},
        "eval_dataset": {"path": "fix", "crop_size": 48, "resize_size": 56, "global_batch_size": 4},
        "loader": {"num_workers": workers, "prefetch_batches": 2},
        "precision": {"compute_dtype": "float32"},
        "algorithms": list(algorithms),
        **extra,
    }


HOST_POST = [{"cls": "RandAugment", "args": {"depth": 1, "severity": 9}},
             {"cls": "ColOut", "args": {"p_row": 0.1, "p_col": 0.1}}]


def _loaders(layer, is_train, native):
    ref, _ = jloader.build_loader(jconfig.loads(layer), is_train=is_train, process_index=0,
                                  process_count=1)
    got, _ = tloader.build_loader(tconfig.loads(layer), is_train=is_train)
    if native:
        assert got.use_native and ref.use_native and got.decoder == "native"
    else:
        got.use_native = ref.use_native = False
    return got, ref


def _same_batches(got_iter, ref_iter, n):
    pairs = list(zip(got_iter, ref_iter))
    assert len(pairs) == n
    for a, b in pairs:
        for field in ("images", "labels", "mask", "indices"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    return pairs


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("post_ops", [False, True])
@pytest.mark.parametrize("route", ["native", "pillow"])
def test_train_loader_matches_hvt(folder, native_pair, route, post_ops, workers):
    layer = _layer(folder, workers=workers, algorithms=HOST_POST if post_ops else ())
    got, ref = _loaders(layer, True, route == "native")
    assert got.transform.has_post_ops == post_ops
    assert got.batches_per_epoch == ref.batches_per_epoch == 3  # 12 images, a padded tail of 2
    for epoch in (0, 1):
        np.testing.assert_array_equal(got.epoch_indices(epoch), ref.epoch_indices(epoch))
        pairs = _same_batches(got.epoch(epoch), ref.epoch(epoch), 3)
        assert pairs[-1][0].mask.tolist() == [1, 1, 0, 0, 0]
        assert pairs[-1][0].indices.tolist()[2:] == [-1, -1, -1]
    assert not np.array_equal(got.epoch_indices(0), got.epoch_indices(1))


@pytest.mark.parametrize("route", ["native", "pillow"])
def test_eval_loader_routes_match_hvt(folder, native_pair, route):
    got, ref = _loaders(_layer(folder), False, route == "native")
    _same_batches(got.epoch(0), ref.epoch(0), 2)


@pytest.mark.parametrize("route", ["native", "pillow"])
@pytest.mark.parametrize("start", [1, 2])
def test_start_batch_resumes_the_tail(folder, native_pair, route, start):
    got, ref = _loaders(_layer(folder, batch=4, algorithms=HOST_POST), True, route == "native")
    full = list(got.epoch(1))
    tail = _same_batches(got.epoch(1, start_batch=start), ref.epoch(1, start_batch=start),
                         3 - start)
    for a, (b, _) in zip(full[start:], tail):
        np.testing.assert_array_equal(a.images, b.images)


def test_a_worker_exception_is_raised_in_the_consumer(folder):
    got, _ = _loaders(_layer(folder, workers=2), True, native=False)

    def broken(epoch, index):
        raise OSError(f"cannot read sample {index}")

    got._load_one = broken
    with pytest.raises(RuntimeError, match="worker failed on epoch 0") as info:
        list(got.epoch(0))
    assert isinstance(info.value.__cause__, OSError)


def test_an_early_break_stops_and_joins_the_producer(folder):
    got, _ = _loaders(_layer(folder, batch=1, workers=2), True, native=False)
    got.prefetch_batches = 1
    before = {t for t in threading.enumerate() if t.name.startswith("hvt-loader")}
    it = got.epoch(0)
    first = next(it)
    assert first.images.shape == (1, 48, 48, 3)
    it.close()  # what a `break` out of a for loop does to the generator
    alive = [t for t in threading.enumerate() if t.name.startswith("hvt-loader") and t not in before]
    assert not alive, alive


def test_a_corrupt_file_is_decoded_again_through_pillow(tmp_path, native_pair):
    root = _write_folder(tmp_path, per_class=2, seed=9)
    bad = sorted((root / "train").rglob("*.jpg"))[3]
    img = Image.open(bad).convert("RGB")
    img.save(bad.with_suffix(".png"), format="PNG")
    bad.write_bytes(bad.with_suffix(".png").read_bytes())  # PNG bytes under a .jpg name
    bad.with_suffix(".png").unlink()
    got, ref = _loaders(_layer(root, batch=3, algorithms=HOST_POST), True, native=True)
    pairs = _same_batches(got.epoch(0), ref.epoch(0), 2)
    assert all(b.images[:int(b.mask.sum())].reshape(-1, 48 * 48 * 3).any(axis=1).all()
               for b, _ in pairs)


def test_build_transform_routes_host_and_device_augmentations(folder):
    device = [{"cls": "RandAugment", "args": {"depth": 2, "severity": 7, "device": True}},
              {"cls": "ColOut", "args": {"device": True}}]
    for algos in (HOST_POST, device, ()):
        layer = _layer(folder, algorithms=algos)
        got = tloader.build_transform(tconfig.loads(layer), True)
        ref = jloader.build_transform(jconfig.loads(layer), True)
        assert (got.randaugment_depth, got.randaugment_severity, got.colout_p) == (
            ref.randaugment_depth, ref.randaugment_severity, ref.colout_p)
    assert tloader.build_transform(tconfig.loads(_layer(folder)), False).crop_size == 48


def test_the_loader_says_which_decoder_it_uses(folder, monkeypatch):
    layer = tconfig.loads(_layer(folder))
    got, _ = tloader.build_loader(layer, is_train=True)
    assert got.decoder == ("native" if tnative.available() else
                           f"pillow ({tnative.unavailable_reason()})")
    monkeypatch.setattr(tnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "unavailable_reason", lambda: "no libjpeg")
    got, _ = tloader.build_loader(layer, is_train=True)
    assert not got.use_native and got.decoder == "pillow (no libjpeg)"
    synthetic = _layer(folder)
    synthetic["train_dataset"].update(source="synthetic", synthetic_num_samples=6,
                                      synthetic_num_classes=3)
    assert tloader.build_loader(tconfig.loads(synthetic), is_train=True)[0].decoder == "synthetic"


def test_trainer_trains_from_the_folder_and_prints_its_decoder(folder, tmp_path, capsys):
    layer = _layer(folder, algorithms=HOST_POST + [
        {"cls": "MixUp", "args": {"alpha": 0.2}},
        {"cls": "ProgressiveResizing", "args": {"initial_scale": 0.5}}])
    layer["machine"]["save_root"] = str(tmp_path)
    layer["max_duration"] = "4ba"  # crosses an epoch (3 batches an epoch)
    seen = []
    metrics = tmain.main(tconfig.loads(layer), device="cpu",
                         on_step=lambda step, stats: seen.append(float(stats["loss_sum"])))
    assert len(seen) == 4 and np.isfinite(seen).all() and np.isfinite(metrics["cross-entropy"])
    first = capsys.readouterr().out.splitlines()[0]
    decoder = "native" if tnative.available() else "pillow"
    assert first.startswith("[loader_test] train loader: 12 images, decoder " + decoder), first
    assert "eval loader: 6 images" in first


def test_pinned_buffers_back_the_batch_only_on_request(folder):
    got, _ = _loaders(_layer(folder), True, native=False)
    batch = next(got.epoch(0))
    t = tloader.host_tensor(batch.images)
    assert isinstance(t, torch.Tensor) and t.data_ptr() == batch.images.ctypes.data
    assert not got.pin_memory


def test_the_input_tools_run_on_the_cpu(tmp_path):
    """``loader_bench`` writes hvt's fixture shape and times both routes;
    ``train_input_bench`` gives its three rates and the predictions on a
    CPU Trainer (numbers from the CPU mean nothing; the shape of the
    record is what is held)."""
    from hvt_torch.tools import loader_bench, train_input_bench
    from hvt_torch.train.loop import Trainer

    fx = loader_bench.make_fixture(tmp_path / "fx", 12, 4, classes=3, size=(80, 60), workers=2)
    assert fx["images"] == 16 and fx["mean_bytes"] > 0
    assert len(list((tmp_path / "fx" / "train").iterdir())) == 3
    with Image.open(next((tmp_path / "fx" / "val").rglob("*.jpg"))) as img:
        assert img.size == (80, 60)
    for route in ("pillow", "native"):
        row = loader_bench.bench_pipeline(fx["root"], 4, 3, 2, route, True, "host")
        if "skipped" not in row:
            assert row["route"] == route and row["images"] == 12 and row["images_per_sec"] > 0
    layer = _layer(tmp_path / "fx", batch=4, algorithms=[{"cls": "CutMix", "args": {}}])
    layer["machine"]["save_root"] = str(tmp_path)
    trainer = Trainer(tconfig.loads(layer), device="cpu")
    try:
        row = train_input_bench.measure(trainer, 2)
    finally:
        trainer.close()
    assert row["batch"] == 4 and row["device"] == "cpu"
    assert row["predicted_serial_img_s"] <= row["predicted_overlap_img_s"]
    assert all(row[k] > 0 for k in ("host_only_img_s", "device_only_img_s", "combined_img_s",
                                    "step_call_ms_alone", "step_call_ms_in_loop"))


def test_many_workers_under_a_short_switch_interval_give_the_same_batches(folder):
    """More decode threads than cores and a 1 µs switch interval: the
    producer's batches, their order and every pixel equal one worker's."""
    one, _ = _loaders(_layer(folder, batch=3, workers=1, algorithms=HOST_POST), True, False)
    many, _ = _loaders(_layer(folder, batch=3, workers=4 * (os.cpu_count() or 1),
                              algorithms=HOST_POST), True, False)
    many.prefetch_batches = 1
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = []
        worker = threading.Thread(target=lambda: got.extend(many.epoch(1)), daemon=True)
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive()
    finally:
        sys.setswitchinterval(interval)
    ref = list(one.epoch(1))
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        for field in ("images", "labels", "mask", "indices"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
