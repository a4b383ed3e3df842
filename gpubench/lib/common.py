"""Paths, file lookup by name, spans and small statistics."""
from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import time
from contextlib import contextmanager
from typing import List, Tuple

BENCH = pathlib.Path(__file__).resolve().parents[1]      # gpubench/
ROOT = BENCH.parent                                       # the checkout
# top-level module names that must not be loaded in a run's process, and
# that no file of the benchmark may import: the JAX package and JAX
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
# what the plain references may not import besides: the port itself
FORBIDDEN_IN_REFERENCE = FORBIDDEN_MODULES + ("repro_torch",)
# fixed cache directories inside the checkout (the build of the port's
# kernels goes to build/kernels by the port's own rule)
CACHE_DIR = ROOT / "build" / "gpubench-cache"


def load_json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """Import a file of the benchmark by its path (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    spec = importlib.util.spec_from_file_location(
        "gpubench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def set_cache_env() -> None:
    """Point every compiler cache a library may open at fixed directories
    inside the checkout, before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE_DIR / sub)
    os.environ["USE_FLAX"] = "0"


def top_level_names(modules) -> List[str]:
    return sorted({name.split(".")[0] for name in modules})


def forbidden_loaded(modules) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    compared whole: ``repro_torch`` is not ``repro``."""
    return [n for n in top_level_names(modules) if n in FORBIDDEN_MODULES]


class Spans:
    """Host-clock spans the harness records around calls into the port:
    (name, start, end) in ``time.perf_counter`` seconds, kept in memory."""

    def __init__(self):
        self.items: List[Tuple[str, float, float]] = []

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, t0, time.perf_counter()))

    def durations(self, name: str) -> List[float]:
        return [t1 - t0 for n, t0, t1 in self.items if n == name]


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of ``values``, linear between
    the order statistics (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def seed_stream(seed: int, tag: str) -> int:
    """A 64-bit seed for one use of ``seed`` (weights, prompts, checks),
    so that the streams do not overlap; any whole number is taken."""
    import hashlib
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)
