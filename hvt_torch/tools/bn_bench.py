"""The BatchNorm kernels on the card, beside an earlier version of them.

    python -m hvt_torch.tools.bn_bench [--parent OLD/bn_stats.cu] \\
        [--configs 224x256,112x256,...] [--out chiprun_out/bn_bench.json]

For each configuration (image size x batch), ResNet-50's 53 BatchNorm
inputs (its 12 shapes: the image size halved one to five times, each
halving rounding up, as the stride-2 convolutions do) as seeded bf16
(rows, C) views. Times, with CUDA events over back-to-back calls, each
shape's time a call times its layers, summed to a training step:

* new: the four launches of ``csrc/bn_stats.cu`` (the sums with their
  finish, the normalize, the reduce with its finish, dx) through their
  wrappers, and ``bn_train``'s forward (sums, normalize) and backward
  (reduce, dx) as the Function calls them;
* parent (``--parent``: ``bn_stats.cu`` as it stood before the redesign,
  one reduction kernel and ``sum_parts`` a call; built with nvcc under
  another library name, against the current ``csrc`` headers): its two
  reductions as its wrappers launched them (a check, the launch shape, two
  ``torch.empty``, one ctypes call), and its ``bn_train`` forward and
  backward: its reduction, then the eager f32 formulas;
* plain: the forward and backward on the plain versions (torch's
  reductions and the eager formulas: the ``bn_custom`` route);
* library: ``torch.batch_norm_stats``, ``torch.batch_norm_backward_reduce``
  and ``torch.native_batch_norm`` forward and backward on the channels-last
  view;
* the bound: the bytes each must move at 3.35 TB/s (each input read once,
  each output written once).

Versions in turns (parent, new, new, parent). Prints one JSON line per
configuration and writes them all to ``--out``, with each shape's host ms
a call (the median time a call takes to return from an idle card) and
device ms a call (torch.profiler) of each launch, new and parent. Needs a
CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import tempfile

CONFIGS = ((224, 256), (112, 256), (136, 256), (168, 256), (192, 256), (88, 2048), (176, 2048))
# (map index, channels, layers): map i is the image size halved i + 1 times
RESNET50_BN = ((0, 64, 1), (1, 64, 6), (1, 256, 4), (1, 128, 1), (2, 128, 7), (2, 512, 5),
               (2, 256, 1), (3, 256, 11), (3, 1024, 7), (3, 512, 1), (4, 512, 5), (4, 2048, 4))
BYTES_PER_S = 3.35e12  # HBM3 of the H100 SXM
EPS = 1e-5


def bn_shapes(size: int) -> list[tuple[int, int, int]]:
    """(H = W, channels, layers) of ResNet-50's BatchNorm inputs at ``size`` px."""
    maps = []
    for _ in range(5):
        size = -(-size // 2)
        maps.append(size)
    return [(maps[i], c, n) for i, c, n in RESNET50_BN]


def bytes_of(m: int, c: int) -> dict:
    """Bytes each launch must move over (m, c) bf16 and its (C,) f32 vectors."""
    return {"sums": 2 * m * c + 20 * c, "normalize": 4 * m * c + 16 * c,
            "reduce": 4 * m * c + 32 * c, "dx": 6 * m * c + 20 * c}


def build_old(source: pathlib.Path, workdir: pathlib.Path) -> ctypes.CDLL:
    from hvt_torch.ops import _build

    src = workdir / "bn_stats_parent.cu"
    src.write_text(source.read_text())
    lib = workdir / "libbn_stats_parent.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib))


def parent_reductions(lib):
    """The parent's two wrappers: (channel_sums(x), bn_bwd_reduce(g, x, mean,
    rstd)), each launching its reduction kernel and sum_parts."""
    import torch

    from hvt_torch.ops import bn_stats_cuda as bsc

    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.hvt_bn_channel_sums.argtypes = [P, L, I, I, I, P, P, I, P]
    lib.hvt_bn_bwd_reduce.argtypes = [P, P, P, P, L, I, I, I, P, P, I, P]

    def shape(m, c):  # the parent's launch_shape
        tx = min(c // 8, 32)
        tiles = -(-c // (8 * tx))
        return tx, max(1, min(-(-1056 // tiles), m // (256 // tx * 4)))

    def check(err):
        if err:
            raise RuntimeError(f"parent launch failed ({err})")

    def sums(x):
        bsc._check("channel_sums", x)
        m, c = x.shape
        tx, chunks = shape(m, c)
        part = torch.empty((chunks, 2, c), dtype=torch.float32, device=x.device)
        out = torch.empty((2, c), dtype=torch.float32, device=x.device)
        check(lib.hvt_bn_channel_sums(x.data_ptr(), m, c, tx, chunks, part.data_ptr(),
                                      out.data_ptr(), 0, torch.cuda.current_stream().cuda_stream))
        return out[0], out[1]

    def bwd(g, x, mean, rstd):
        bsc._check("bn_bwd_reduce", g, x)
        m, c = x.shape
        tx, chunks = shape(m, c)
        part = torch.empty((chunks, 2, c), dtype=torch.float32, device=x.device)
        out = torch.empty((2, c), dtype=torch.float32, device=x.device)
        check(lib.hvt_bn_bwd_reduce(g.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                    m, c, tx, chunks, part.data_ptr(), out.data_ptr(), 0,
                                    torch.cuda.current_stream().cuda_stream))
        return out[0], out[1]

    return sums, bwd


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_device_ms(fn, iters: int = 10) -> tuple[float, float]:
    """(host ms, device ms) of one call from an idle card: the median time
    the host takes to return, and the mean kernel time of a call from
    torch.profiler."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    host = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if str(e.device_type).endswith("CUDA"))
    return sorted(host)[iters // 2], dev_us / 1e3 / iters


def shape_cases(x, g, scale, bias, old, batch: int, h: int) -> dict:
    """{version: {name: fn}} over one (rows, C) shape."""
    import torch

    from hvt_torch.ops import bn_stats as bs
    from hvt_torch.ops import bn_stats_cuda as bsc

    n = x.shape[0]
    mean, var, rstd = bsc.bn_moments(x, EPS)
    terms = bsc.bn_bwd_terms(g, x, mean, rstd, scale)
    new = {
        "sums": lambda: bsc.bn_moments(x, EPS),
        "normalize": lambda: bsc.bn_normalize(x, mean, rstd, scale, bias, torch.bfloat16),
        "reduce": lambda: bsc.bn_bwd_terms(g, x, mean, rstd, scale),
        "dx": lambda: bsc.bn_dx(g, x, mean, rstd, terms),
        "forward": lambda: bs.bn_normalize(x, *bs.bn_moments(x, EPS)[::2], scale, bias,
                                           torch.bfloat16),
        "backward": lambda: bs.bn_dx(g, x, mean, rstd, bs.bn_bwd_terms(g, x, mean, rstd, scale)),
    }

    def eager(reduce_sums, reduce_bwd):
        def forward():
            s, q = reduce_sums(x)
            mu = s / n
            rs = torch.rsqrt(torch.clamp_min(q / n - mu * mu, 0.0) + EPS)
            return bs.bn_normalize_plain(x, mu, rs, scale, bias, torch.bfloat16)

        def backward():
            tg, tgx = reduce_bwd(g, x, mean, rstd)
            return bs.bn_dx_plain(g, x, mean, rstd, (tg, tgx, scale * rstd, tg / n, tgx / n))

        return forward, backward

    x4 = x.view(batch, h, h, x.shape[1]).permute(0, 3, 1, 2)  # channels-last views
    g4 = g.view(batch, h, h, x.shape[1]).permute(0, 3, 1, 2)
    _, save_mean, save_invstd = torch.native_batch_norm(x4, scale, bias, None, None, True, 0.0, EPS)
    versions = {"new": new}
    fwd, bwd = eager(bs.channel_sums_plain, bs.bn_bwd_reduce_plain)
    versions["plain"] = {"forward": fwd, "backward": bwd}
    versions["library"] = {
        "sums": lambda: torch.batch_norm_stats(x4, EPS),
        "reduce": lambda: torch.batch_norm_backward_reduce(g4, x4, mean, rstd, scale, True, True,
                                                           True),
        "forward": lambda: torch.native_batch_norm(x4, scale, bias, None, None, True, 0.0, EPS),
        "backward": lambda: torch.ops.aten.native_batch_norm_backward(
            g4, x4, scale, None, None, save_mean, save_invstd, True, EPS, [True, True, True]),
    }
    if old is not None:
        fwd, bwd = eager(*old)
        versions["parent"] = {"sums": lambda: old[0](x),
                              "reduce": lambda: old[1](g, x, mean, rstd),
                              "forward": fwd, "backward": bwd}
    return versions


def bench_config(size: int, batch: int, old) -> dict:
    import torch

    rec = {"size": size, "batch": batch, "ms": {}, "bound_ms": {}, "max_abs_diff": {},
           "shapes": []}
    for i, (h, c, layers) in enumerate(bn_shapes(size)):
        gen = torch.Generator("cuda").manual_seed(100 + i)
        m = batch * h * h
        x = (torch.randn(m, c, device="cuda", generator=gen) * 1.5
             + torch.randn(c, device="cuda", generator=gen)).bfloat16()
        g = torch.randn(m, c, device="cuda", generator=gen).bfloat16()
        scale = torch.rand(c, device="cuda", generator=gen)
        bias = torch.randn(c, device="cuda", generator=gen) * 0.1
        versions = shape_cases(x, g, scale, bias, old, batch, h)
        for name, b in bytes_of(m, c).items():
            rec["bound_ms"][name] = rec["bound_ms"].get(name, 0.0) + layers * b / BYTES_PER_S * 1e3
        names = {name for fns in versions.values() for name in fns}
        for name in sorted(names):
            turns = ("parent", "new", "new", "parent") if old is not None else ("new",)
            order = (*turns, "plain", "library")
            for pos, tag in enumerate(order):
                fn = versions.get(tag, {}).get(name)
                if fn is None:
                    continue
                runs = rec["ms"].setdefault(tag, {}).setdefault(name, [])
                t = layers * time_ms(fn)
                turn = order[:pos].count(tag)  # this version's first or second turn
                if turn < len(runs):  # summed over the shapes, turn by turn
                    runs[turn] += t
                else:
                    runs.append(t)
        shape = {"rows": m, "channels": c, "layers": layers, "host_ms": {}, "device_ms": {}}
        for tag in ("new", "parent"):
            for name in ("sums", "normalize", "reduce", "dx"):
                fn = versions.get(tag, {}).get(name)
                if fn is not None:
                    shape["host_ms"][f"{tag} {name}"], shape["device_ms"][f"{tag} {name}"] = \
                        host_device_ms(fn)
        rec["shapes"].append(shape)
        if old is not None:
            from hvt_torch.ops import bn_stats_cuda as bsc

            new_sums, old_sums = bsc.channel_sums(x), old[0](x)
            rec["max_abs_diff"][f"{m}x{c}"] = max(float((a - b).abs().max())
                                                  for a, b in zip(new_sums, old_sums))
        del x, g, versions
        torch.cuda.empty_cache()
    for name in ("forward", "backward"):
        rec["bound_ms"][name] = rec["bound_ms"]["sums" if name == "forward" else "reduce"] + \
            rec["bound_ms"]["normalize" if name == "forward" else "dx"]
    return rec


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=pathlib.Path, default=None)
    parser.add_argument("--configs", default=",".join(f"{s}x{b}" for s, b in CONFIGS))
    parser.add_argument("--out", type=pathlib.Path,
                        default=pathlib.Path("chiprun_out/bn_bench.json"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bn_bench needs a CUDA card")
    old = None
    with tempfile.TemporaryDirectory() as tmp:
        if args.parent is not None:
            old = parent_reductions(build_old(args.parent, pathlib.Path(tmp)))
        rows = []
        for item in args.configs.split(","):
            size, batch = (int(v) for v in item.split("x"))
            rec = bench_config(size, batch, old)
            print(json.dumps(rec), flush=True)
            rows.append(rec)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": torch.cuda.get_device_name(0), "rows": rows},
                                   indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
