"""Typed, layered YAML configuration — the port's own copy of ``hvt/config.py``.

Same schema and merge engine as hvt, so the repository's YAML trees load
unchanged. PyYAML is imported only where a YAML file is read or written:
``loads`` of dict layers needs nothing beyond the standard library.

Mirrors the reference's config system (reference configs.py:1-128, utils.py:15-35,
main.py:139-147): a structured dataclass schema onto which a machine YAML and an
ordered list of experiment YAMLs are merged right-over-left, with ``${a.b}``
interpolation (used e.g. by reference configs/linear_probe/r50_base.yaml:40-42).

The reference uses OmegaConf; this is a small self-contained engine with the same
observable behavior for the subset the configs exercise:

* structured merge — unknown keys are rejected, values are type-coerced to the
  schema (so ``optim.lr: 2`` in YAML still yields a float),
* lists replace rather than concatenate,
* ``${dotted.path}`` string interpolation resolved against the merged tree.

TPU-specific extensions beyond the reference schema are grouped under
``mesh``, ``precision`` and ``loader`` so reference YAMLs remain valid as-is.
"""

from __future__ import annotations

import dataclasses
import re
import typing
from dataclasses import dataclass, field
from typing import Any, Optional, Union

Args = dict[str, Any]

# ---------------------------------------------------------------------------
# Schema (parity with reference configs.py:7-128)
# ---------------------------------------------------------------------------


@dataclass
class ModelConfig:
    # e.g. "resnet50", "swinv2_tiny_window8_256", "swinv2_tiny_window16_256"
    name: str = "resnet50"
    # full-tuning | linear-probe | simpleshot | simpleshot-l2n | simpleshot-cl2n
    variant: str = "full-tuning"
    # Checkpoint URI understood by hvt.train.checkpoint (local path or ckpt://).
    pretrained_checkpoint: Optional[str] = None
    # "" (cross-entropy) or "binary_cross_entropy". The reference's recipe
    # YAMLs set this but its schema rejects it (SURVEY.md §2.4 quirk 2);
    # here it is a real knob.
    loss_name: str = ""
    # Free-form overrides forwarded to the model constructor (e.g. drop_path_rate).
    args: Args = field(default_factory=dict)


@dataclass
class DatasetConfig:
    # Must be a key in config.machine.datasets.
    path: str = ""
    # Resize size before crop; -1 means no resize (reference configs.py:22).
    resize_size: int = -1
    crop_size: int = 224
    global_batch_size: int = 2048

    drop_last: bool = False
    shuffle: bool = False

    # iNat21 training defaults (reference configs.py:30-31).
    channel_mean: tuple[float, float, float] = (0.463, 0.480, 0.376)
    channel_std: tuple[float, float, float] = (0.238, 0.229, 0.247)

    # TPU extension: "imagefolder" scans class dirs on disk; "synthetic"
    # generates random data with the given number of classes (for benchmarks
    # and tests on machines without the dataset).
    source: str = "imagefolder"
    synthetic_num_classes: int = 1000
    synthetic_num_samples: int = 2048


@dataclass
class MachineConfig:
    # Lookup from dataset name to dataset location (train/ and val/ inside).
    datasets: dict[str, str] = field(default_factory=dict)
    save_root: str = "."


@dataclass
class OptimConfig:
    name: str = "DecoupledSGDW"
    lr: float = 2.048
    momentum: float = 0.875
    weight_decay: float = 5e-4


@dataclass
class SchedulerConfig:
    name: str = "CosineAnnealingWithWarmupScheduler"
    args: Args = field(default_factory=lambda: {"t_warmup": "8ep", "alpha_f": 0.0})


@dataclass
class SaveConfig:
    interval: Optional[str] = "10ep"
    num_checkpoints_to_keep: int = 1
    overwrite: bool = True
    # Kept for config-compat with the reference (wandb artifact upload,
    # reference configs.py:64-65); a no-op unless wandb is installed.
    wandb: bool = True


@dataclass
class WandbConfig:
    entity: str = "imageomics"
    project: str = "hierarchical-vision"


@dataclass
class SimpleShotConfig:
    centered: bool = False
    l2_normalized: bool = False
    hierarchical: bool = False


@dataclass
class AlgorithmConfig:
    cls: str = ""
    args: Args = field(default_factory=dict)


@dataclass
class HierarchyConfig:
    # "" (flat), "multitask", or "hxe".
    variant: str = ""
    multitask_coeffs: list[float] = field(default_factory=list)
    # "uniform" or "exponential" (reference configs.py:93-96; the reference's
    # hxe loss is an unimplemented stub — hvt implements it for real).
    hxe_tree_weights: str = "uniform"
    hxe_alpha: float = 0.1


# --- TPU-native extensions -------------------------------------------------


@dataclass
class MeshConfig:
    """Device mesh for GSPMD parallelism.

    The reference's only strategy is DDP data parallelism (SURVEY.md §2.2);
    here the batch axis is sharded over the `data` mesh axis. -1 means
    "all available devices".
    """

    data: int = -1
    # Reserved for model-parallel experiments; 1 keeps params replicated.
    model: int = 1
    # Spatial partitioning: shard the image H dim over this many devices
    # (GSPMD inserts the conv halo exchanges / BN psums). For conv
    # families; SwinV2 needs {fuse: false, use_pallas: false} with it.
    spatial: int = 1
    # Pipeline parallelism: split the SwinV2 deep trunk into this many
    # pipeline stages (stage params sharded over the `pipe` mesh axis; a
    # GPipe microbatch schedule shifts activations via collective-permute).
    # SwinV2 only, and requires the plain-XLA lowering
    # (model.args {fuse: false, use_pallas: false} — the Trainer injects
    # these and the matching model.args.pipe automatically).
    pipe: int = 1
    # ZeRO-1: shard optimizer state (AdamW mu/nu, SGD momentum) over the
    # data axis instead of replicating it — one parameter all-gather per
    # step buys back 2x params of f32 HBM per chip under AdamW.
    zero: bool = False


@dataclass
class PrecisionConfig:
    # Parameters are kept in f32; activations/compute in bf16 by default
    # (the TPU-native analog of the reference's AMP, reference main.py:32).
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"


@dataclass
class LoaderConfig:
    num_workers: int = 8
    prefetch_batches: int = 2


@dataclass
class Config:
    run_name: str = "base"
    is_train: bool = True
    seed: int = 42
    max_duration: str = "90ep"
    # int microbatch count, or "auto": the Trainer reads XLA's compile-time
    # memory analysis and doubles the count until the step fits HBM
    # (hvt/train/microbatch.py; the reference's Composer grad_accum "auto").
    grad_accum: Union[str, int] = "auto"
    load_path: Optional[str] = None
    # Resume from this run's own checkpoints automatically when they exist
    # (load_path wins when set). The reference's recovery is manual
    # (SURVEY.md §5: fixed SLURM allocations, re-submit with load_path);
    # auto_resume makes a preempted job re-submission idempotent.
    auto_resume: bool = False
    tags: list[str] = field(default_factory=list)

    hierarchy: HierarchyConfig = field(default_factory=HierarchyConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    train_dataset: DatasetConfig = field(default_factory=DatasetConfig)
    eval_dataset: DatasetConfig = field(default_factory=DatasetConfig)

    optim: OptimConfig = field(default_factory=OptimConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)

    algorithms: list[AlgorithmConfig] = field(default_factory=list)

    machine: MachineConfig = field(default_factory=MachineConfig)
    save: SaveConfig = field(default_factory=SaveConfig)
    wandb: WandbConfig = field(default_factory=WandbConfig)
    simpleshot: SimpleShotConfig = field(default_factory=SimpleShotConfig)

    mesh: MeshConfig = field(default_factory=MeshConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)
    loader: LoaderConfig = field(default_factory=LoaderConfig)

    # Evaluate every N epochs during training (reference main.py:109).
    eval_interval: str = "1ep"


# ---------------------------------------------------------------------------
# Engine: structured merge + interpolation
# ---------------------------------------------------------------------------


class ConfigError(ValueError):
    pass


def _type_name(tp) -> str:
    return getattr(tp, "__name__", str(tp))


def _coerce(value, tp, path):
    """Coerce a YAML-loaded value to the schema type `tp`."""
    origin = typing.get_origin(tp)
    targs = typing.get_args(tp)

    if tp is Any:
        return value

    if origin is Union:
        # Optional[...] and str|int unions: try each arm.
        if value is None and type(None) in targs:
            return None
        for arm in targs:
            if arm is type(None):
                continue
            try:
                return _coerce(value, arm, path)
            except (ConfigError, TypeError, ValueError):
                continue
        raise ConfigError(f"{path}: cannot coerce {value!r} to {tp}")

    if dataclasses.is_dataclass(tp):
        if isinstance(value, tp):
            return value
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected mapping for {_type_name(tp)}, got {value!r}")
        return _from_dict(tp, value, path)

    if origin in (list,):
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{path}: expected list, got {value!r}")
        elem = targs[0] if targs else Any
        return [_coerce(v, elem, f"{path}[{i}]") for i, v in enumerate(value)]

    if origin in (tuple,):
        if not isinstance(value, (list, tuple)):
            raise ConfigError(f"{path}: expected sequence, got {value!r}")
        if len(targs) == 2 and targs[1] is Ellipsis:
            return tuple(_coerce(v, targs[0], f"{path}[{i}]") for i, v in enumerate(value))
        if targs and len(targs) != len(value):
            raise ConfigError(f"{path}: expected {len(targs)} elements, got {len(value)}")
        return tuple(
            _coerce(v, t, f"{path}[{i}]") for i, (v, t) in enumerate(zip(value, targs))
        )

    if origin in (dict,):
        if not isinstance(value, dict):
            raise ConfigError(f"{path}: expected mapping, got {value!r}")
        kt = targs[0] if targs else Any
        vt = targs[1] if targs else Any
        return {
            _coerce(k, kt, f"{path}.{k}"): _coerce(v, vt, f"{path}.{k}")
            for k, v in value.items()
        }

    if tp is bool:
        if isinstance(value, bool):
            return value
        raise ConfigError(f"{path}: expected bool, got {value!r}")
    if tp is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ConfigError(f"{path}: expected int, got {value!r}")
        return value
    if tp is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ConfigError(f"{path}: expected float, got {value!r}")
        return float(value)
    if tp is str:
        if not isinstance(value, str):
            raise ConfigError(f"{path}: expected str, got {value!r}")
        return value
    # Fallback: accept as-is.
    return value


def _from_dict(cls, data: dict, path: str = ""):
    """Build dataclass `cls` from a nested dict, rejecting unknown keys."""
    known = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(known)
    if unknown:
        raise ConfigError(
            f"{path or _type_name(cls)}: unknown key(s) {sorted(unknown)} "
            f"(valid: {sorted(known)})"
        )
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for name, f in known.items():
        sub = f"{path}.{name}" if path else name
        if name in data:
            kwargs[name] = _coerce(data[name], hints[name], sub)
    return cls(**kwargs)


def to_dict(obj) -> Any:
    """Recursively convert dataclasses/tuples to plain dict/list (YAML-able)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    return obj


def merge_dicts(base: dict, overlay: dict) -> dict:
    """Right-over-left deep merge; lists and scalars replace."""
    out = dict(base)
    for key, val in overlay.items():
        if key in out and isinstance(out[key], dict) and isinstance(val, dict):
            out[key] = merge_dicts(out[key], val)
        else:
            out[key] = val
    return out


_INTERP = re.compile(r"^\$\{([\w.]+)\}$")
_INTERP_INNER = re.compile(r"\$\{([\w.]+)\}")


def _lookup(tree: dict, dotted: str):
    node: Any = tree
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            raise ConfigError(f"interpolation ${{{dotted}}}: key {part!r} not found")
    return node


def resolve_interpolations(tree: dict) -> dict:
    """Resolve ``${a.b}`` references against the merged tree (fixed point)."""

    def resolve(node):
        if isinstance(node, dict):
            return {k: resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v) for v in node]
        if isinstance(node, str):
            m = _INTERP.match(node)
            if m:
                return resolve(_lookup(tree, m.group(1)))
            return _INTERP_INNER.sub(
                lambda mm: str(resolve(_lookup(tree, mm.group(1)))), node
            )
        return node

    return resolve(tree)


def load_yaml(filepath: Optional[str]) -> dict:
    """Load one YAML layer; empty path → empty layer (reference utils.py:15-20)."""
    if not filepath:
        return {}
    import yaml

    with open(filepath) as fd:
        data = yaml.safe_load(fd)
    return data or {}


def load(machine: Optional[str] = None, exps: typing.Sequence[str] = ()) -> Config:
    """Structured defaults ← machine YAML ← exp YAMLs, left-to-right.

    Mirrors reference main.py:139-147 (OmegaConf.merge of structured defaults,
    the machine layer, then each experiment layer in order).
    """
    tree = to_dict(Config())
    for layer in [load_yaml(machine), *[load_yaml(e) for e in exps]]:
        tree = merge_dicts(tree, layer)
    tree = resolve_interpolations(tree)
    return _from_dict(Config, tree, "config")


def loads(*layers: dict) -> Config:
    """Merge already-loaded dict layers onto the structured defaults."""
    tree = to_dict(Config())
    for layer in layers:
        tree = merge_dicts(tree, layer)
    tree = resolve_interpolations(tree)
    return _from_dict(Config, tree, "config")


def to_yaml(config: Config) -> str:
    """The resolved config as YAML, key order kept (hvt's ``to_yaml``)."""
    import yaml

    return yaml.safe_dump(to_dict(config), sort_keys=False)


def add_exp_args(parser) -> None:
    """Standard --machine/--exp CLI (reference utils.py:23-35)."""
    parser.add_argument(
        "--machine",
        help="Machine-specific YAML (dataset paths, save root).",
        required=True,
    )
    parser.add_argument(
        "--exp",
        help="Experiment YAMLs, merged left-to-right (right-most wins).",
        nargs="+",
        default=[],
        required=True,
    )
