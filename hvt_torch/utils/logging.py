"""Run logging and throughput — port of ``hvt/utils/logging.py``.

:class:`RunLogger` writes ``<save_folder>/logs/log0.txt`` (the resolved
config as YAML, then one JSON object a record: ``step``, ``time`` and the
metrics under their ``prefix/``), prints each record on stdout as
``[run] step=…, prefix/key=…``, and feeds an optional wandb sink, active only
when ``save.wandb`` asks for it and the wandb package can be imported (it
warns, as hvt's does, when the package is missing; the package is imported
only then). :class:`SpeedMonitor`
gives samples/sec over a sliding window (reference main.py:92,
window_size=50). :func:`memory_stats` reads the card's allocator under hvt's
key names. The port is one process: rank 0, no broadcast.
"""

from __future__ import annotations

import collections
import json
import pathlib
import time
import warnings
from typing import Any, Optional


def _import_wandb():
    try:
        import wandb  # type: ignore
    except ImportError:
        return None
    return wandb


class RunLogger:
    def __init__(self, save_folder: str | pathlib.Path, run_name: str, use_wandb: bool = False,
                 wandb_entity: str = "", wandb_project: str = "",
                 tags: Optional[list[str]] = None):
        self.run_name = run_name
        log_dir = pathlib.Path(save_folder) / "logs"
        log_dir.mkdir(parents=True, exist_ok=True)
        self._file = open(log_dir / "log0.txt", "a")
        self._wandb = _import_wandb() if use_wandb else None
        self._wandb_run = None
        if use_wandb and self._wandb is None:
            warnings.warn(
                "wandb logging/upload requested (save.wandb: true) but the wandb package is "
                "not installed — metrics stay in the jsonl logs and checkpoints are not "
                "uploaded as artifacts")
        if self._wandb is not None:
            self._wandb_run = self._wandb.init(name=run_name, entity=wandb_entity or None,
                                               project=wandb_project or None, tags=tags or [])

    @property
    def uploads(self) -> bool:
        """Whether a wandb run takes records and artifacts."""
        return self._wandb_run is not None

    def log(self, step: int, metrics: dict[str, Any], prefix: str = "") -> None:
        record = {"step": step, "time": time.time(),
                  **{(f"{prefix}/{k}" if prefix else k): _scalar(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        printable = ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                              for k, v in record.items() if k != "time")
        print(f"[{self.run_name}] {printable}", flush=True)
        if self._wandb_run is not None:
            self._wandb_run.log(record, step=step)

    def log_config(self, config_yaml: str) -> None:
        """Print and keep the resolved config; push it to wandb.config when a
        run exists (reference utils.py:7-12)."""
        print(config_yaml, flush=True)
        self._file.write(config_yaml + "\n")
        self._file.flush()
        if self._wandb_run is not None:
            import yaml

            self._wandb_run.config.update(yaml.safe_load(config_yaml))

    def log_artifact(self, path: str | pathlib.Path, name: str, *,
                     artifact_type: str = "checkpoint", aliases: Optional[list[str]] = None,
                     metadata: Optional[dict] = None) -> bool:
        """Upload a file or directory as a wandb Artifact with aliases
        (reference monkey_patch.py:33-91), skipping ``.txt`` files and
        symlinks as the reference's uploader does; False without a run."""
        if self._wandb_run is None:
            return False
        path = pathlib.Path(path)
        if path.is_symlink() or path.suffix == ".txt":
            return False
        artifact = self._wandb.Artifact(name=name, type=artifact_type,
                                  metadata={"timestamp": time.time(), **(metadata or {})})
        if path.is_dir():
            for sub in sorted(path.rglob("*")):
                if sub.is_symlink() or sub.suffix == ".txt" or not sub.is_file():
                    continue
                artifact.add_file(str(sub), name=str(sub.relative_to(path)))
        else:
            artifact.add_file(str(path))
        self._wandb_run.log_artifact(artifact, aliases=list(aliases or []))
        return True

    def close(self) -> None:
        self._file.close()
        if self._wandb_run is not None:
            self._wandb_run.finish()


def _scalar(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v


def memory_stats(device) -> dict[str, float]:
    """The card's allocator: bytes in use and the peak (hvt's MemoryMonitor
    keys, device 0); empty on the CPU."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {}
    m = torch.cuda.memory_stats(device)
    return {"memory/device0_bytes_in_use": float(m.get("allocated_bytes.all.current", 0)),
            "memory/device0_peak_bytes": float(m.get("allocated_bytes.all.peak", 0))}


class SpeedMonitor:
    """Sliding-window samples/sec (reference SpeedMonitor, window_size=50),
    and per chip, as hvt's keys have it: the port runs on one card."""

    def __init__(self, window_size: int = 50):
        self.window: collections.deque = collections.deque(maxlen=window_size)

    def batch_end(self, num_samples: int) -> None:
        self.window.append((time.perf_counter(), num_samples))

    def metrics(self) -> dict[str, float]:
        if len(self.window) < 2:
            return {}
        t0, t1 = self.window[0][0], self.window[-1][0]
        samples = sum(n for _, n in list(self.window)[1:])  # completed between the ticks
        ips = samples / max(t1 - t0, 1e-9)
        return {"samples_per_sec": ips, "samples_per_sec_per_chip": ips}
