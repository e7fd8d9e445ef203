"""Checkpoints and pretrained weights — port of ``hvt/train/checkpoint.py``.

hvt saves its TrainState with Orbax; the port saves the same fields in its
own torch format, one ``<directory>/<step>/state.pt`` per step, loadable with
``torch.load(..., weights_only=True)``:

* ``step``, ``params`` and ``batch_stats`` (the model's parameters and
  BatchNorm running statistics, by the port's state-dict names);
* ``opt_state``: the optimizer's ``state_dict``, its update count included;
* ``ema_params`` and ``ema_batch_stats`` (None without EMA), ``ema_updates``;
* ``rng``: the state of the generator that draws drop-path masks;
* ``config``: the run's YAML.

:class:`Checkpointer` follows hvt's contract: ``save`` copies every tensor
to host memory before it returns, so the next step's in-place updates cannot
reach the copy, and a background thread writes the file; any earlier write
is joined first, and ``wait``, ``latest_step``, ``restore`` and ``close``
join too. A write goes to ``<step>.tmp/`` and is committed by ``os.replace``
to ``<step>/``; only then does the keep policy prune, so a reader never sees
a half-written step. An exception in the writer is raised again at the next
``save``, ``wait``, ``latest_step``, ``restore`` or ``close``. In a data
group (hvt's multi-process Trainer) rank 0 alone saves, between two
barriers of the Trainer's, and the Trainer's ``close`` lets every rank go
only once rank 0's writes are committed; every rank restores the same files.

Cross-run loading (``load_pretrained``): ``ckpt://<path>[:step]`` or a bare
path (a port checkpoint, EMA weights preferred), ``swin://``/``torch://``
(:mod:`hvt_torch.models.torch_compat`) and ``wandb://`` (an artifact holding
a torch-format file; needs the wandb package). hvt's Orbax checkpoints are
not read: ``python -m hvt.tools.export_torch``, run beside JAX, writes them
as a ``.pt`` that ``torch://`` reads.
"""

from __future__ import annotations

import logging
import os
import pathlib
import re
import shutil
import tempfile
import threading
from collections.abc import Mapping
from typing import Any, Optional

import torch

log = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def to_host(tree):
    """A copy of every tensor of a nested dict/list on the host, complete when
    this returns (a blocking device-to-host copy, or a clone on the CPU)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, Mapping):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


@torch.no_grad()
def copy_into(dst: Mapping[str, torch.Tensor], src: Mapping[str, Any], what: str) -> None:
    """Copy ``src``'s tensors into ``dst``'s in place, name for name; raises
    when the names or a shape differ."""
    if dst.keys() != src.keys():
        diff = sorted(dst.keys() ^ src.keys())
        raise KeyError(f"{what}: names differ from the model's ({len(diff)}: {diff[:5]})")
    for name, t in dst.items():
        if tuple(src[name].shape) != tuple(t.shape):
            raise ValueError(f"{what}: {name} has shape {tuple(src[name].shape)}, "
                             f"the model {tuple(t.shape)}")
        t.copy_(src[name])


def _is_step(path: pathlib.Path) -> bool:
    return path.is_dir() and path.name.isdigit() and (path / STATE_FILE).is_file()


class Checkpointer:
    """Save and restore the Trainer's state under ``directory``, keeping the
    newest ``max_to_keep`` steps (at least 1)."""

    def __init__(self, directory: str | pathlib.Path, max_to_keep: int = 1):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max(int(max_to_keep), 1)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state: dict) -> None:
        """Copy ``state`` to the host, then write it in the background."""
        self.wait()
        host = to_host(state)
        self._thread = threading.Thread(target=self._write, args=(int(step), host),
                                        name=f"checkpoint-{step}")
        self._thread.start()

    def _write(self, step: int, host: dict) -> None:
        try:
            tmp = self.directory / f"{step}.tmp"
            final = self.directory / str(step)
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            torch.save(host, tmp / STATE_FILE)
            if final.exists():  # an earlier run's step of the same number: overwritten
                shutil.rmtree(final)
            os.replace(tmp, final)
            for old in self.steps()[:-self.max_to_keep]:
                shutil.rmtree(self.directory / str(old))
        except BaseException as e:  # raised again in the caller's thread at the next join
            self._error = e

    def wait(self) -> None:
        """Join the write in flight, and raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise RuntimeError(f"writing a checkpoint under {self.directory} failed") from error

    def steps(self) -> list[int]:
        """The committed steps, oldest first."""
        return sorted(int(p.name) for p in self.directory.iterdir() if _is_step(p))

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> dict:
        """The saved state of ``step`` (default the latest), on the host."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        self.wait()
        return _load(self.directory / str(step))

    def close(self) -> None:
        self.wait()


def _load(step_dir: pathlib.Path) -> dict:
    return torch.load(step_dir / STATE_FILE, map_location="cpu", weights_only=True)


# ---------------------------------------------------------------------------
# Cross-run (backbone) loading
# ---------------------------------------------------------------------------

_CKPT_URI = re.compile(r"^ckpt://(?P<path>[^:]+)(?::(?P<step>\d+))?$")
_WANDB_URI = re.compile(r"^wandb://(?P<artifact>[\w./-]+:[\w./-]+)\?(?P<file>[\w./-]+)$")


def resolve_wandb_uri(uri: str) -> str:
    """``wandb://entity/proj/name:alias?file`` → local file path; needs the
    wandb package and an authenticated run, and raises without them."""
    m = _WANDB_URI.match(uri)
    if not m:
        raise ValueError(f"uri {uri!r} doesn't match wandb://<artifact>?<file>")
    try:
        import wandb  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "wandb:// checkpoint URIs need the wandb package (not installed); "
            "use ckpt://<local-path> or swin://<path> instead"
        ) from e
    artifact = wandb.Api().artifact(m.group("artifact"))
    root = pathlib.Path(tempfile.gettempdir(), "hvt-wandb-cache",
                        m.group("artifact").replace("/", "_"))
    return str(artifact.get_path(m.group("file")).download(root=str(root)))


def parse_checkpoint_uri(uri: str) -> tuple[pathlib.Path, Optional[int]]:
    """'ckpt:///a/b:36' → (/a/b, 36); bare paths pass through."""
    m = _CKPT_URI.match(uri)
    if m:
        return pathlib.Path(m.group("path")), int(m.group("step")) if m.group("step") else None
    return pathlib.Path(uri), None


def load_raw(uri: str) -> dict:
    """A port checkpoint as saved, on the host: ``uri`` names a checkpoints
    directory (its latest step, or the URI's step) or one step's directory."""
    path, step = parse_checkpoint_uri(uri)
    if step is None and (path / STATE_FILE).is_file():
        return _load(path)
    if path.is_dir():
        steps = sorted(int(p.name) for p in path.iterdir() if _is_step(p))
        if step is None and steps:
            step = steps[-1]
        if step in steps:
            return _load(path / str(step))
    raise FileNotFoundError(f"no checkpoint found at {uri}")


def strip_head(params: Mapping) -> dict:
    """Drop the classification head (reference algorithmic.py:70-74)."""
    return {k: v for k, v in params.items() if k != "head" and not k.startswith("head.")}


def merge_backbone(current: Mapping, loaded: Mapping, strict: bool = False) -> dict:
    """Overlay ``loaded`` onto ``current`` by name. A shape mismatch raises;
    missing or unexpected names raise under ``strict``, and are logged as
    warnings otherwise (reference algorithmic.py:76-85)."""
    merged = {}
    for name, cur in current.items():
        new = loaded.get(name)
        if new is not None and tuple(new.shape) != tuple(cur.shape):
            raise ValueError(f"shape mismatch at {name}: {tuple(cur.shape)} vs {tuple(new.shape)}")
        merged[name] = cur if new is None else new
    missing = [k for k in current if k not in loaded]
    unexpected = [k for k in loaded if k not in current]
    for label, names in (("missing keys in checkpoint", missing),
                         ("unexpected keys in checkpoint", unexpected)):
        if names:
            msg = f"{label}: {', '.join(names)}"
            if strict:
                raise KeyError(msg)
            log.warning(msg)
    return merged


def load_pretrained(uri: str, params: Mapping, batch_stats: Optional[Mapping],
                    strict: bool = False) -> tuple[dict, Optional[dict]]:
    """PretrainedBackbone (reference algorithmic.py:35-85): read the URI's
    parameters and running statistics (EMA copies where a port checkpoint
    has them), strip the head, and merge them into ``params`` and
    ``batch_stats`` (both {state-dict name: tensor}); the head keeps
    ``params``' tensors. Running statistics travel with the weights: a frozen
    backbone normalises with them."""
    if uri.startswith("wandb://"):
        uri = f"torch://{resolve_wandb_uri(uri)}"
    if uri.startswith(("swin://", "torch://")):
        from hvt_torch.models import torch_compat

        src, src_stats = torch_compat.load_torch_variables(uri)
    else:
        raw = load_raw(uri)
        src, src_stats = raw["params"], raw.get("batch_stats") or {}
        if raw.get("ema_params") is not None:
            src, src_stats = raw["ema_params"], raw.get("ema_batch_stats") or src_stats
    merged = merge_backbone(strip_head(params), strip_head(src), strict=strict)
    merged.update({k: v for k, v in params.items() if k not in merged})
    merged_stats = batch_stats
    if batch_stats and src_stats:
        merged_stats = merge_backbone(strip_head(batch_stats), strip_head(src_stats), strict=strict)
    return merged, merged_stats
