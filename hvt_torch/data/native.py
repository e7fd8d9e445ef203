"""ctypes binding for the native JPEG decode core — port of ``hvt/data/native.py``.

``hvt_torch/data/_native/decode.cc`` (a copy of hvt's core) is compiled at
first use with ``g++ -O3 -fPIC -shared -std=c++17 -pthread … -ljpeg`` into
``hvt_torch/ops/_build/`` (git ignores it), under a name keyed by the
source and the flags, written to a temporary file and renamed, so processes
that build at once each see a whole library or none. Every call releases
the interpreter lock and fans out over a C++ thread pool.

Where the toolchain or libjpeg is missing, or ``HVT_NATIVE=0``, the core is
unavailable and the loader takes the Pillow route, as hvt's does. The two
routes crop with different random streams, so :func:`unavailable_reason`
says why, and the loader reports which route it took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_SRC_PATH = pathlib.Path(__file__).parent / "_native" / "decode.cc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "ops" / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_reason: Optional[str] = None  # why the core is unavailable, once known


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC_PATH.read_bytes())
    return BUILD_DIR / f"libhvtdecode-{h.hexdigest()[:16]}.so"


def _build(out: pathlib.Path) -> Optional[str]:
    """Compile the core into ``out``; None on success, else why not."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_SRC_PATH), "-o", str(tmp), "-ljpeg"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=180)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        lines = (getattr(e, "stderr", b"") or b"").decode(errors="replace").splitlines()
        why = next((ln for ln in lines if "error" in ln), lines[-1] if lines else str(e))
        return f"g++ build failed: {why.strip()[-300:]}"
    os.replace(tmp, out)
    return None


def _bind(lib: ctypes.CDLL) -> None:
    lib.hvt_load_batch.restype = ctypes.c_int
    lib.hvt_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),  # paths
        ctypes.POINTER(ctypes.c_uint64),  # seeds
        ctypes.c_int,  # n
        ctypes.c_int,  # is_train
        ctypes.c_int,  # resize_size
        ctypes.c_int,  # out_size
        ctypes.c_double, ctypes.c_double,  # scale
        ctypes.c_double, ctypes.c_double,  # ratio
        ctypes.c_int,  # n_threads
        ctypes.POINTER(ctypes.c_uint8),  # out
    ]
    lib.hvt_decode_eval_buffer.restype = ctypes.c_int
    lib.hvt_decode_eval_buffer.argtypes = [
        ctypes.c_char_p,  # data
        ctypes.c_size_t,  # len
        ctypes.c_int,  # resize_size
        ctypes.c_int,  # out_size
        ctypes.POINTER(ctypes.c_uint8),  # out
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _reason
    with _lock:
        if _lib is not None or _reason is not None:
            return _lib
        if os.environ.get("HVT_NATIVE", "1") == "0":
            _reason = "HVT_NATIVE=0"
            return None
        out = library_path()
        # a library built elsewhere may not load here (another libjpeg): rebuild it once
        for attempt in range(2):
            if attempt or not out.exists():
                _reason = _build(out)
                if _reason is not None:
                    break
            try:
                lib = ctypes.CDLL(str(out))
                _bind(lib)
            except (OSError, AttributeError) as e:
                _reason = f"cannot load {out.name}: {e}"
                continue
            _lib, _reason = lib, None
            return _lib
        print(f"[hvt_torch.native] {_reason}; the loader decodes with Pillow", flush=True)
        return None


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """None when the core loads, else why it does not (building it if need be)."""
    _load()
    return _reason


def load_batch(
    paths: Sequence[str],
    seeds: Optional[Sequence[int]],
    *,
    is_train: bool,
    resize_size: int,
    out_size: int,
    scale: tuple[float, float] = (0.08, 1.0),
    ratio: tuple[float, float] = (0.75, 4.0 / 3.0),
    num_threads: int = 8,
) -> tuple[np.ndarray, int]:
    """Decode a batch → (uint8 (N, S, S, 3), num_failures). Failed slots are
    zero-filled and counted rather than raising; the loader decodes them
    again through Pillow."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native decoder unavailable: {_reason}")
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), dtype=np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    if seeds is None:
        seeds = [0] * n
    c_seeds = (ctypes.c_uint64 * n)(*[int(s) & (2**64 - 1) for s in seeds])
    failures = lib.hvt_load_batch(
        c_paths, c_seeds, n, int(is_train), int(resize_size), int(out_size),
        float(scale[0]), float(scale[1]), float(ratio[0]), float(ratio[1]),
        int(num_threads), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out, int(failures)


def decode_eval(data: bytes, *, resize_size: int, out_size: int) -> Optional[np.ndarray]:
    """In-memory eval decode: JPEG bytes → uint8 (S, S, 3), the loader's
    native eval law (virtual shorter-side resize → center crop → one
    bilinear resample). None on a decode failure or when the core is
    unavailable (the caller falls back to Pillow)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_size, out_size, 3), dtype=np.uint8)
    rc = lib.hvt_decode_eval_buffer(data, len(data), int(resize_size), int(out_size),
                                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None
