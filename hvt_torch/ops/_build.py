"""Build the CUDA sources under ``csrc/`` and bind their C entry points.

Each ``csrc/<name>.cu`` compiles with ``nvcc -gencode arch=compute_90a,
code=sm_90a`` into ``_build/lib<name>-<digest>.so``, a shared library with a
plain C interface, loaded through ``ctypes``: no PyTorch header is compiled,
so a build takes seconds. The digest covers every file under ``csrc/`` (a
source may include another, as ``fused_halves_base.cu`` includes
``fused_halves.cu``) and the flags, so an edited kernel never loads a stale
library. Libraries build at first use, or all at once (one ``nvcc`` per
source, in parallel) through :func:`build_all`.

A :class:`Kernel` is one C entry point, in one library or, where the widths
a kernel is built for are split over two sources so that their builds run
side by side, in one library per width. Calling it launches on the stream
passed in, raises if the launcher returns a nonzero ``cudaError_t``, and only
then counts the launch in ``Kernel.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).parent / "_build"
SOURCES = ("window_attention", "window_attention_bwd", "fused_halves", "fused_halves_bwd",
           "fused_halves_base", "fused_halves_bwd_base", "mlp", "attention_half",
           "attention_half_base", "bn_stats", "swin_block", "flash_attention", "int8_conv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--expt-relaxed-constexpr",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # report registers, shared memory and spills of each kernel
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if not path.is_file():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the hvt_torch kernels build "
            "from hvt_torch/ops/csrc at first use on a machine with the CUDA toolkit"
        )
    return str(path)


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(name.encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(proc, tmp: pathlib.Path, out: pathlib.Path, name: str) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder sees a whole library or none
    return log


def build_all() -> dict[str, str]:
    """Build every source that has no current library, one ``nvcc`` each, all
    started together. Returns {name: compiler output} of the sources built,
    with ptxas's report of each kernel."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with _lock:
        jobs = {name: _start(name) for name in SOURCES if not library_path(name).is_file()}
        return {name: _finish(*job, name) for name, job in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.is_file():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _finish(*_start(name), name)
            lib = ctypes.CDLL(str(path))
            lib.hvt_error_string.argtypes = [ctypes.c_int]
            lib.hvt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


class Kernel:
    """One C launcher, with its launch count. ``library`` names the csrc
    source that holds it, or maps each width to one: a call then passes
    ``width=``, and a width outside the map raises."""

    def __init__(self, library: "str | dict[int, str]", symbol: str, argtypes: list):
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fns: dict[str, ctypes._CFuncPtr] = {}

    def __call__(self, *args, width: "int | None" = None) -> None:
        name = self.library if isinstance(self.library, str) else self.library[width]
        fn = self._fns.get(name)
        if fn is None:
            fn = getattr(load(name), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fns[name] = fn
        err = fn(*args)
        if err != 0:
            msg = load(name).hvt_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: launch failed ({err}: {msg})")
        self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float
