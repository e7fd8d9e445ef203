"""Time the kernels' build as ``_build.build_all`` runs it (one ``nvcc`` per
source, all started together) against two other layouts of the same
kernels:

* ``folded``: the windowed attention half (``attention_half.cu`` and its
  ``_base`` twin) compiled inside the fused halves' backward units
  (``fused_halves_bwd.cu``, ``fused_halves_bwd_base.cu``) instead of in
  units of its own;
* ``one_unit``: each fused-halves family in one translation unit, the
  forwards at all eight widths in one ``nvcc`` and the backwards (with the
  windowed attention half) in another.

The sources outside those families (the attention cores,
``mlp``, ``bn_stats`` and ``swin_block``) build as they
are in all three layouts.

    python -m hvt_torch.ops.build_times

Needs ``nvcc``. Builds into ``_build/timing/`` (deleted after) with
``_build.NVCC_FLAGS`` and prints one JSON object: for each layout, the wall
seconds of the parallel build and the seconds at which each source's
``nvcc`` ended.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import time

from hvt_torch.ops import _build
from hvt_torch.ops import fused_halves_cuda as fh

FAMILY = ("fused_halves", "fused_halves_base", "fused_halves_bwd", "fused_halves_bwd_base")
WINDOWED = ("attention_half", "attention_half_base")


def _widths(macro: str, widths) -> str:
    return f"#define {macro}(F) " + " ".join(f"F({c})" for c in widths) + "\n"


def _includes(*names: str) -> str:
    return "".join(f'#include "{name}.cu"\n' for name in names)


def _run(sources: dict[str, str], out_dir) -> dict:
    t0 = time.perf_counter()
    procs = {}
    for name, path in sources.items():
        with open(out_dir / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(
                [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                 "-o", str(out_dir / f"{name}.so"), path],
                stdout=log, stderr=subprocess.STDOUT)
    each = {}
    while len(each) < len(procs):
        time.sleep(0.05)
        for name, proc in procs.items():
            if name not in each and proc.poll() is not None:
                each[name] = time.perf_counter() - t0
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for {name}:\n"
                                       + (out_dir / f"{name}.log").read_text())
    return {"wall_s": time.perf_counter() - t0, "sources_s": each}


def _layout(out_dir, keep: tuple, units: dict[str, str]) -> dict[str, str]:
    """The sources of ``_build.SOURCES`` named in ``keep``, and ``units``
    (name: text) written to ``out_dir``."""
    sources = {name: str(_build.CSRC / f"{name}.cu") for name in keep}
    for name, text in units.items():
        (out_dir / f"{name}.cu").write_text(text)
        sources[name] = str(out_dir / f"{name}.cu")
    return sources


def main() -> None:
    out_dir = _build.BUILD_DIR / "timing"
    out_dir.mkdir(parents=True, exist_ok=True)
    try:
        split = {name: str(_build.CSRC / f"{name}.cu") for name in _build.SOURCES}
        rest = tuple(name for name in _build.SOURCES if name not in FAMILY + WINDOWED)
        base = _widths("HVT_WIDTHS", fh.BASE_WIDTHS)
        folded = _layout(out_dir, rest + ("fused_halves", "fused_halves_base"), {
            "fused_halves_bwd_folded": _includes("fused_halves_bwd", "attention_half"),
            "fused_halves_bwd_base_folded": base + _includes("fused_halves_bwd", "attention_half"),
        })
        one_unit = _layout(out_dir, rest, {
            "fused_halves_all": _widths("HVT_WIDTHS", fh.WIDTHS) + _includes("fused_halves"),
            "fused_halves_bwd_all": _widths("HVT_WIDTHS", fh.WIDTHS)
            + _includes("fused_halves_bwd", "attention_half"),
        })
        print(json.dumps({"split": _run(split, out_dir), "folded": _run(folded, out_dir),
                          "one_unit": _run(one_unit, out_dir)}))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
