"""One run of one cell: what ``run.py`` drives, found by name.

``BENCHMARK.json`` names the cell; ``workloads/<cell>.json`` holds its
driver, its traffic parameters and the limits of its compared numbers;
``configs/<config>.json`` the model configuration as it is run;
``drivers/<driver>.py`` the entry point it measures; ``metrics/<metric>.py``
one reader a per-layer metric. Files are loaded by path, so a name may
hold dots and dashes.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import math
import os
import pathlib
import sys
from dataclasses import dataclass, field

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "multi_speaker_tts_tpu")


def load_json(path: pathlib.Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over`` merged in, nested dicts key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def isolate_caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port's nvcc builds land in its own ``_kernels_build/``), and no JAX
    behind a library's back. Before torch is imported."""
    cache = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: pathlib.Path):
    """A module of the benchmark by file path (its name may hold dots)."""
    name = "_bench_" + path.relative_to(BENCH_DIR).as_posix().replace("/", "__").replace(
        ".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name, taken whole, is JAX's, flax's or
    the JAX package's (the port's own name only begins with the latter)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


@dataclass
class Cell:
    name: str
    entry: dict  # the BENCHMARK.json workload entry
    spec: dict  # workloads/<name>.json
    config: dict  # configs/<config>.json
    end_to_end: list = field(default_factory=list)  # metric entries this cell reports
    per_layer: list = field(default_factory=list)

    @classmethod
    def by_name(cls, name: str, bench: dict | None = None) -> "Cell":
        bench = manifest() if bench is None else bench
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        entry = entries[name]
        spec = load_json(BENCH_DIR / "workloads" / f"{name}.json")
        configs = {c["name"]: c for c in bench["configs"]}
        config = load_json(ROOT / configs[entry["config"]]["file"])

        def mine(metric):
            return name in metric.get("workloads", [name])

        return cls(name, entry, spec, config,
                   [m for m in bench["end_to_end"] if mine(m)],
                   [m for m in bench["per_layer"] if mine(m)])

    def driver(self):
        return load_module(BENCH_DIR / "drivers" / f"{self.spec['driver']}.py")

    def reader(self, metric: str):
        return load_module(BENCH_DIR / "metrics" / f"{metric}.py")


@dataclass
class Context:
    """What a driver is given: the cell, the run's arguments, the device,
    and for the harness's own tests ``overrides`` of the configuration, the
    traffic and the limits (a small size on the CPU); the benchmark's own
    runs override nothing."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    overrides: dict = field(default_factory=dict)
    control: bool = False  # also read the control's numbers (control.py)

    @property
    def params(self) -> dict:
        return {**self.cell.spec["params"], **self.overrides.get("params", {})}

    @property
    def limits(self) -> dict:
        return self.overrides.get("limits", self.cell.spec["limits"])


@dataclass
class Compared:
    """One number the check compares, beside its limit (at most)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def judge(compared: list[Compared]) -> bool:
    return bool(compared) and all(c.ok for c in compared)
