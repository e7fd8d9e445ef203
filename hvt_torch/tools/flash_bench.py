"""The flash-attention kernels on the card, beside an earlier version of them.

    python -m hvt_torch.tools.flash_bench [--parent OLD/flash_attention.cu] \\
        [--shapes 2048x12x197,64x12x197,...] [--out chiprun_out/flash_bench.json]

Times, in one process, on bf16 packed qkv of each (B, H, N) shape at head
dim 64 (seeded, unit variance, sm_scale 1/8), with CUDA events over
back-to-back launches, each pair of versions in turns (parent, new, new,
parent): the forward, dK/dV and dQ kernels of ``csrc/flash_attention.cu``
(dQ forms D = rowsum(dO∘O) itself); with ``--parent``, the same three of an
earlier source of that file, as it stood with the TMA forward and dK/dV
and the strided ``mma.sync`` dQ (its C interface; built here with nvcc
under another library name, against the current ``csrc`` headers), whose
dQ read a D computed before it in torch: its "dq" is that composite,
``delta_rows`` then its dQ kernel, and "dq_kernel" its dQ alone. Also
SDPA's flash forward on the same q, k, v, ``delta_rows`` alone, and the
whole backward (new: ``backward``, dQ then dK/dV; parent: ``delta_rows``,
its dK/dV and dQ). The bounds are chip_smoke.py's (phase 18). Also the host
ms a call takes to return (the tensor maps are encoded at each call), each
kernel's registers, shared memory and spills from ptxas, and the largest
difference between the versions' outputs (D: the new kernel's against
``delta_rows``). Prints one JSON line per shape and writes them all to
``--out``. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import tempfile
import time

SHAPES = ((2048, 12, 197), (64, 12, 197), (64, 12, 257), (8, 12, 1025), (4, 12, 1370))


def build_old(source: pathlib.Path, tag: str, workdir: pathlib.Path):
    """An earlier flash_attention.cu as a library of its own: (ctypes
    library, ptxas report)."""
    from hvt_torch.ops import _build

    src = workdir / f"flash_{tag}.cu"
    src.write_text(source.read_text())
    lib = workdir / f"libflash_{tag}.so"
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout}{done.stderr}")
    return ctypes.CDLL(str(lib)), done.stdout + done.stderr


def ptxas_rows(log: str) -> list[dict]:
    """[{kernel, registers, smem, spills}] of the flash kernels in a ptxas report."""
    rows, row = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w*flash\w*)'", line)
        if m:
            row = {"kernel": m.group(1), "registers": None, "smem": 0, "spills": None}
            rows.append(row)
        elif row is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                row["spills"] = [int(m.group(1)), int(m.group(2))]
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
            if m:
                row["registers"], row["smem"] = int(m.group(1)), int(m.group(2) or 0)
    return rows


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
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


def host_ms(fn, iters: int = 10) -> float:
    """The median ms a call takes to return from an idle card."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return sorted(times)[iters // 2]


def old_launchers(lib, qkv, dout, out, lse, delta, dqkv, heads: int):
    """The earlier source's launches: its forward and dK/dV on the packed
    qkv (TMA), its dQ through its strided interface (q, k, v as views of
    qkv, (image, head, row) strides in elements, then dO likewise), which
    reads ``delta``."""
    import torch

    P, L, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    tail = [I, I, I, I, F, I, P]
    lib.hvt_flash_attention_fwd.argtypes = [P] * 3 + tail
    lib.hvt_flash_attention_bwd_dkv.argtypes = [P] * 5 + tail
    lib.hvt_flash_attention_bwd_dq.argtypes = [P, P, P, L, L, L, P, L, L, L] + [P] * 3 + tail
    b, n, c3 = qkv.shape
    c, step = c3 // 3, c3 // 3 * qkv.element_size()
    base, gbase = qkv.data_ptr(), dqkv.data_ptr()
    shape = (b, heads, n, 64, 0.125, 0, torch.cuda.current_stream().cuda_stream)

    def check(err):
        if err:
            raise RuntimeError(f"launch failed: {lib.hvt_error_string(err).decode()}")

    lib.hvt_error_string.restype = ctypes.c_char_p
    return {
        "fwd": lambda: check(lib.hvt_flash_attention_fwd(base, out.data_ptr(), lse.data_ptr(),
                                                         *shape)),
        "dkv": lambda: check(lib.hvt_flash_attention_bwd_dkv(
            base, dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), gbase, *shape)),
        "dq_kernel": lambda: check(lib.hvt_flash_attention_bwd_dq(
            base, base + step, base + 2 * step, n * c3, 64, c3, dout.data_ptr(), n * c, 64, c,
            lse.data_ptr(), delta.data_ptr(), gbase, *shape)),
    }


def bench_shape(b: int, h: int, n: int, olds: dict) -> dict:
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from hvt_torch.ops import flash_attention as fa

    gen = torch.Generator("cuda").manual_seed(1)
    qkv = torch.randn((b, n, 3 * h * 64), generator=gen, device="cuda").bfloat16()
    dout = torch.randn((b, n, h * 64), generator=gen, device="cuda").bfloat16()
    out, lse = fa.forward(qkv, h, 0.125)
    delta, new_d = torch.empty((b, h, n), device="cuda"), torch.empty_like(qkv)
    new = {"fwd": lambda: fa.forward(qkv, h, 0.125),
           "dkv": lambda: fa.backward_dkv(qkv, dout, lse, delta, new_d, h, 0.125),
           "dq": lambda: fa.backward_dq(qkv, out, dout, lse, delta, new_d, h, 0.125),
           "backward": lambda: fa.backward(qkv, out, lse, dout, h, 0.125)}
    new["dq"]()  # D for dK/dV's launches
    versions = {"new": new}
    outputs = {}
    for tag, lib in olds.items():
        o_out, o_lse, o_d = torch.empty_like(out), torch.empty_like(lse), torch.empty_like(qkv)
        o_delta = torch.empty_like(delta)
        old = old_launchers(lib, qkv, dout, o_out, o_lse, o_delta, o_d, h)

        def composite(old=old, o_delta=o_delta):
            o_delta.copy_(fa.delta_rows(out, dout, h))
            old["dq_kernel"]()

        def backward(old=old, o_delta=o_delta):
            o_delta.copy_(fa.delta_rows(out, dout, h))
            old["dkv"]()
            old["dq_kernel"]()

        versions[tag] = {**old, "dq": composite, "backward": backward}
        outputs[tag] = (o_out, o_lse, o_d, o_delta)
    rec = {"shape": [b, h, n], "ms": {}, "host_ms": {}}
    order = [t for t in versions if t != "new"]
    for kernel in ("fwd", "dkv", "dq", "dq_kernel", "backward"):
        tags = [t for t in versions if kernel in versions[t]]
        for tag in tags:
            rec["ms"].setdefault(tag, {})[kernel] = []
        for tag in (*order, "new", "new", *reversed(order)):  # parent, new, new, parent
            if tag in tags:
                rec["ms"][tag][kernel].append(time_ms(versions[tag][kernel]))
        for tag in tags:
            rec["host_ms"].setdefault(tag, {})[kernel] = host_ms(versions[tag][kernel])
    new["dq"]()
    new["dkv"]()
    torch.cuda.synchronize()
    c = h * 64
    for tag, (o_out, o_lse, o_d, o_delta) in outputs.items():
        versions[tag]["fwd"]()
        versions[tag]["backward"]()
        torch.cuda.synchronize()
        rec.setdefault("max_abs_diff", {})[tag] = {
            "o": float((o_out.float() - out.float()).abs().max()),
            "lse": float((o_lse - lse).abs().max()),
            "d": float((o_delta - delta).abs().max()),
            **{g: float((o_d[..., i * c:(i + 1) * c].float()
                         - new_d[..., i * c:(i + 1) * c].float()).abs().max())
               for i, g in enumerate(("dq", "dk", "dv"))}}
    q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, h, 64).permute(2, 0, 3, 1, 4))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        rec["sdpa_flash_fwd_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    rec["delta_rows_ms"] = time_ms(lambda: fa.delta_rows(out, dout, h))
    return rec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=pathlib.Path,
                        help="an earlier csrc/flash_attention.cu whose dQ has the strided C "
                             "interface")
    parser.add_argument("--shapes", default=",".join("x".join(map(str, s)) for s in SHAPES))
    parser.add_argument("--out", type=pathlib.Path,
                        default=pathlib.Path("chiprun_out/flash_bench.json"))
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("flash_bench: needs a CUDA card")
    from hvt_torch.ops import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {"new": _build._finish(*_build._start("flash_attention"), "flash_attention")}
    olds = {}
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        if args.parent:
            olds["parent"], logs["parent"] = build_old(args.parent, "parent", pathlib.Path(tmp))
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True)
        head = {"card": card.stdout.strip(), "ptxas": {t: ptxas_rows(g) for t, g in logs.items()}}
        print(json.dumps(head), flush=True)
        records = [head]
        for shape in args.shapes.split(","):
            rec = bench_shape(*map(int, shape.split("x")), olds)
            print(json.dumps(rec), flush=True)
            records.append(rec)
            torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(records, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
