"""Checkpointing: atomic, async, keep-N, in the JAX package's layout.

Layout (one directory per step), the same files and path strings as the
JAX package's ``repro/train/checkpoint.py`` writes, so a checkpoint that
either package writes restores into the other:

    <dir>/step_00001234/
        arrays.npz      — the tree's leaves as ``a0``, ``a1``, ...
        meta.json       — step, leaf paths / dtypes / shapes, user metadata
    <dir>/step_00001234.tmp/   (write side; atomically renamed when complete)

A leaf's path joins its keys with "/": dict keys as they are, a
NamedTuple's fields as ``.name`` (``opt_state/.m/embed/embedding``),
sequence items by index.  bfloat16 leaves are stored as 2-byte raw
(``V2``) arrays with the dtype ``bfloat16`` in ``meta.json``, as numpy
stores the JAX package's ``ml_dtypes`` arrays; the port reads them back
bit for bit.

Fault-tolerance contract: a checkpoint is visible iff its final rename
happened, so readers never see partial state; the async writer keeps at
most one save in flight.  The port updates parameters in place, so
:meth:`CheckpointManager.save` copies every leaf to host numpy before it
returns (the step loop may then overwrite the tensors at once).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.errors import CheckpointError, ValidationError

_BF16 = "bfloat16"


def _flatten_with_paths(tree, prefix=()):
    """[(path, leaf)] in the tree's order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = ((f".{name}", val) for name, val in zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [("/".join(str(p) for p in prefix), tree)]
    out = []
    for key, val in items:
        out.extend(_flatten_with_paths(val, prefix + (key,)))
    return out


def _unflatten(template, leaves, prefix=()):
    if isinstance(template, dict):
        return {key: _unflatten(val, leaves, prefix + (key,))
                for key, val in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _unflatten(val, leaves, prefix + (f".{name}",))
            for name, val in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(val, leaves, prefix + (i,))
                              for i, val in enumerate(template))
    return leaves["/".join(str(p) for p in prefix)]


def _to_host(leaf):
    """(numpy array, dtype name) of a leaf: a tensor (bfloat16 as raw V2
    bytes), a numpy array or a Python scalar."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)   # never a view of the leaf
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2"), _BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def host_copy(state):
    """``state`` with every leaf copied to host numpy, as
    ``(array, dtype name)`` pairs (what :func:`save_checkpoint` writes)."""
    paths_leaves = _flatten_with_paths(state)
    return [(path, _to_host(leaf)) for path, leaf in paths_leaves]


def _write(directory: Path, step: int, host, metadata) -> Path:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "arrays.npz",
             **{f"a{i}": arr for i, (_, (arr, _)) in enumerate(host)})
    meta = {
        "step": step,
        "paths": [path for path, _ in host],
        "dtypes": [dt for _, (_, dt) in host],
        "shapes": [list(arr.shape) for _, (arr, _) in host],
        "metadata": metadata or {},
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)            # atomic visibility
    return final


def save_checkpoint(directory: str | Path, step: int, state,
                    metadata: Optional[Dict[str, Any]] = None) -> Path:
    """Write ``state`` (nested dicts / NamedTuples / sequences of tensors,
    numpy arrays or scalars) atomically; returns the checkpoint's path."""
    return _write(Path(directory), step, host_copy(state), metadata)


def _candidates(directory: Path) -> List[Path]:
    if not directory.exists():
        return []
    return sorted(p for p in directory.iterdir()
                  if p.is_dir() and p.name.startswith("step_")
                  and not p.name.endswith(".tmp"))


def latest_checkpoint(directory: str | Path) -> Optional[Path]:
    cands = _candidates(Path(directory))
    return cands[-1] if cands else None


def checkpoint_step(path: Path) -> int:
    return int(path.name.split("_")[1])


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def restore_checkpoint(path: str | Path, template, *, device=None):
    """(state, meta): the checkpoint at ``path`` in the structure of
    ``template``, each leaf a tensor of the template leaf's dtype on its
    device (on ``device`` if given: a template of ``meta`` tensors then
    takes no memory).  Raises :class:`ValidationError` if a leaf is
    missing or its shape differs from the template's."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    with np.load(path / "arrays.npz") as z:
        host = {p: (z[f"a{i}"], dt) for i, (p, dt) in
                enumerate(zip(meta["paths"], meta["dtypes"]))}
    want = _flatten_with_paths(template)
    missing = [p for p, _ in want if p not in host]
    if missing:
        raise ValidationError(f"checkpoint missing leaves: {missing[:5]}...")
    leaves = {}
    for p, t in want:
        arr, dt = host[p]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValidationError(f"{p}: shape {tuple(arr.shape)} != "
                                  f"template {tuple(t.shape)}")
        leaves[p] = _from_host(arr, dt).to(
            device=t.device if device is None else device, dtype=t.dtype)
    return _unflatten(template, leaves), meta


def garbage_collect(directory: str | Path, keep: int) -> None:
    cands = _candidates(Path(directory))
    for p in cands[:-keep] if keep > 0 else []:
        shutil.rmtree(p)


class CheckpointManager:
    """Async keep-N checkpoint writer (one save in flight)."""

    def __init__(self, directory: str | Path, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = Path(directory)
        self.keep = keep
        self.async_save = async_save
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._errors: List[BaseException] = []
        self._worker: Optional[threading.Thread] = None
        if async_save:
            self._worker = threading.Thread(target=self._run, daemon=True)
            self._worker.start()

    def _run(self):
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            step, host, meta = item
            try:
                _write(self.directory, step, host, meta)
                garbage_collect(self.directory, self.keep)
            except BaseException as e:      # surfaced on next save/wait
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def _raise_errors(self):
        if self._errors:
            raise CheckpointError("async checkpoint failed") \
                from self._errors[0]

    def save(self, step: int, state, metadata=None):
        """Copy ``state`` to the host now, then write it (in the
        background when async; blocks while an earlier save is queued)."""
        self._raise_errors()
        host = host_copy(state)
        if self.async_save:
            self._queue.put((step, host, metadata))
        else:
            _write(self.directory, step, host, metadata)
            garbage_collect(self.directory, self.keep)

    def wait(self):
        if self.async_save:
            self._queue.join()
        self._raise_errors()

    def latest(self) -> Optional[Path]:
        self.wait()
        return latest_checkpoint(self.directory)

    def close(self):
        if self.async_save and self._worker is not None:
            self.wait()
            self._queue.put(None)
            self._worker.join()
            self._worker = None
