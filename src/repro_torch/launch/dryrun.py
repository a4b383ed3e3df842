"""Multi-pod dry run: trace one step of every (arch × shape × mesh) cell
without allocating it, and record its analytic and counted costs as JSON.

The port of the JAX package's ``repro/launch/dryrun.py``, and like it the
one entry point that runs on the host by design: no card is used and no
kernel is launched.  Each cell joins a fake ``torch.distributed`` world
of 256 (16 × 16) or 512 (2 × 16 × 16) ranks in this process (the
``"fake"`` backend: rank 0's view, collectives that move nothing), builds
``Model(cfg, make_sharder(cfg, mesh))`` and traces one train, prefill or
decode step under a ``FakeTensorMode`` on fake ``cpu`` tensors, each
argument of its rank's block shape (:mod:`repro_torch.launch.steps`'
``sds_*`` specs).  Host metadata stays real: an operation whose tensor
arguments are all real tensors (the attention schedule, the caches'
lengths, the optimizer's step) runs for real, so the host-side checks of
the path run as they do on the card.  The record holds the JAX record's
keys (``params``, ``active_params``, ``analytic``, ``analytic_bytes``,
``model_flops_ref``), ``trace_s`` in place of ``lower_s`` /
``compile_s``, ``cost.flops`` counted by
``torch.utils.flop_counter.FlopCounterMode`` (rank 0's share), the
collectives through the port's wrappers by kind
(:func:`repro_torch.core.collectives.record_traffic`), each rank's
argument bytes (``args_bytes``: params, moments, batch and cache blocks)
and the peak of live fake-tensor bytes during the trace
(``peak_live_bytes``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out build/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, SHAPES, ShapeDef, get_config,
                                 shape_applicable)
from repro_torch.core.collectives import record_traffic
from repro_torch.core.errors import ValidationError
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import _mesh
from repro_torch.models.attention import KVCache
from repro_torch.models.transformer import Model
from repro_torch.parallel.sharding import make_sharder
from repro_torch.perf.analytic import (bytes_model, flops_model,
                                       model_flops_reference)
from repro_torch.train.optimizer import AdamW, cosine_schedule

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
# the JAX dry run's optimizer (its moments' dtype sizes the state)
_OPT = AdamW(cosine_schedule(3e-4, 100, 10_000))


def _fake_mode_class():
    """A ``FakeTensorMode`` in which operations on real tensors only run
    for real (host metadata), and which tracks the live fake bytes."""
    import torch.utils._pytree as pytree
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from torch.utils._mode_utils import no_dispatch

    class HostFakeMode(FakeTensorMode):
        def __init__(self):
            super().__init__(allow_non_fake_inputs=True)
            self.live = {}           # storage key -> [bytes, tensors]
            self.live_bytes = 0
            self.peak_bytes = 0

        def _release(self, key):
            entry = self.live.get(key)
            if entry is None:
                return
            entry[1] -= 1
            if entry[1] == 0:
                self.live_bytes -= entry[0]
                del self.live[key]

        def _track(self, out):
            for t in pytree.tree_leaves(out):
                if not isinstance(t, FakeTensor):
                    continue
                key = t.untyped_storage()._cdata
                entry = self.live.get(key)
                if entry is None:
                    entry = self.live[key] = [t.untyped_storage().nbytes(),
                                              0]
                    self.live_bytes += entry[0]
                    self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                entry[1] += 1
                weakref.finalize(t, self._release, key)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            tensors = [t for t in pytree.arg_tree_leaves(*args, **kwargs)
                       if isinstance(t, torch.Tensor)]
            if tensors and not any(isinstance(t, FakeTensor)
                                   for t in tensors):
                with no_dispatch():
                    return func(*args, **kwargs)
            out = super().__torch_dispatch__(func, types, args, kwargs)
            self._track(out)
            return out

    return HostFakeMode


@contextlib.contextmanager
def fake_world(world_size: int):
    """This process as rank 0 of a fake world of ``world_size`` ranks
    (the default group is destroyed on exit); a process that has a
    default group already is refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise ValidationError("the dry run needs a process without a "
                              "default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _cell_specs(model: Model, shape: ShapeDef) -> Dict:
    """The ``sds_*`` specs of the cell's step arguments: ``params``
    (float32 to train and prefill, the compute dtype to decode, as the
    JAX dry run), ``opt`` (training), ``batch`` (training and prefill),
    ``token`` and ``enc_out`` (decode; the latter for an encoder-decoder
    model) and ``cache`` (prefill and decode)."""
    cfg, sharder, kind = model.cfg, model.sharder, shape.kind
    b, s = shape.global_batch, shape.seq_len
    specs = {"params": steps_lib.sds_params(
        model, sharder, cfg.dtype if kind == "decode" else None)}
    if kind == "train":
        specs["opt"] = steps_lib.sds_opt_state(model, sharder, _OPT)
    if kind == "decode":
        specs["token"] = steps_lib.sds_token(cfg, b, sharder)
        if cfg.is_encoder_decoder:
            specs["enc_out"] = steps_lib.sds_enc_out(cfg, b, s, sharder)
    else:
        specs["batch"] = steps_lib.sds_batch(cfg, shape, sharder)
    if kind != "train":
        specs["cache"] = steps_lib.sds_cache(model, sharder, b, s)
    return specs


def argument_bytes(cfg, shape: ShapeDef, mesh) -> Dict[str, int]:
    """Each rank's argument bytes of the cell's step on ``mesh`` (a
    ``DeviceMesh`` or a :class:`MeshShape`): its blocks of the params,
    the moments, the batch (the decode token and encoder output) and the
    cache."""
    model = Model(cfg, sharder=make_sharder(cfg, mesh), device="meta")
    specs = _cell_specs(model, shape)
    opt = specs.get("opt")
    out = {"params": steps_lib.spec_bytes(specs["params"]),
           "moments": 0 if opt is None else steps_lib.spec_bytes(
               (opt.m, opt.v)),
           "batch": sum(steps_lib.spec_bytes(specs.get(k))
                        for k in ("batch", "token", "enc_out")),
           "cache": steps_lib.spec_bytes(specs.get("cache"))}
    out["total"] = sum(out.values())
    return out


def _fake(spec) -> torch.Tensor:
    """A fake ``cpu`` tensor of a spec's block (inside the fake mode)."""
    return torch.empty(spec.block.shape, dtype=spec.dtype, device="cpu")


def _fake_tree(tree):
    if isinstance(tree, steps_lib.ShardedSpec):
        return _fake(tree)
    return {k: _fake_tree(v) for k, v in tree.items()}


def _global(spec) -> torch.Tensor:
    """A fake ``cpu`` tensor of a spec's global shape: the model takes
    the global batch on every rank and keeps its rows."""
    return torch.empty(spec.shape, dtype=spec.dtype, device="cpu")


def _cache(tree, length: int):
    """Fake cache blocks; each KV cache's length is real host state."""
    out = {}
    for name, state in tree.items():
        leaves = [_fake(s) for s in state]
        if isinstance(state, KVCache):
            leaves[2] = torch.from_numpy(
                np.full(state.length.shape, length, np.int32))
        out[name] = type(state)(*leaves)
    return out


def _trace(cfg, shape: ShapeDef, mesh) -> Dict:
    from torch.utils.flop_counter import FlopCounterMode

    model = Model(cfg, sharder=make_sharder(cfg, mesh), device="cpu")
    specs = _cell_specs(model, shape)       # on the meta device, first
    s = shape.seq_len
    mode = _fake_mode_class()()
    counter = FlopCounterMode(display=False)
    t0 = time.perf_counter()
    with mode, record_traffic() as traffic, counter:
        params = _fake_tree(specs["params"])
        if shape.kind == "train":
            opt = specs["opt"]
            opt_state = type(opt)(torch.from_numpy(np.zeros((), np.int32)),
                                  _fake_tree(opt.m), _fake_tree(opt.v))
            batch = {k: _global(v) for k, v in specs["batch"].items()}
            steps_lib.make_train_step(model, _OPT)(params, opt_state, batch)
        elif shape.kind == "prefill":
            batch = {k: _global(v) for k, v in specs["batch"].items()}
            steps_lib.make_prefill_step(model)(params, batch,
                                               _cache(specs["cache"], 0))
        else:
            args = [params, _global(specs["token"]),
                    _cache(specs["cache"], s - 1), s - 1]
            if cfg.is_encoder_decoder:
                args.append(_fake(specs["enc_out"]))
            steps_lib.make_decode_step(model, cfg.is_encoder_decoder)(*args)
    return {"trace_s": round(time.perf_counter() - t0, 3),
            "cost": {"flops": float(counter.get_total_flops())},
            "collectives": _traffic_record(traffic),
            "peak_live_bytes": int(mode.peak_bytes)}


def _traffic_record(traffic) -> Dict:
    return {"by_op": traffic,
            "operand_bytes": sum(v["operand_bytes"] for v in traffic.values()),
            "wire_bytes": sum(v["wire_bytes"] for v in traffic.values()),
            "count": sum(v["count"] for v in traffic.values())}


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             cfg=None, shape: Optional[ShapeDef] = None,
             mesh: Optional[Tuple[Sequence[int], Sequence[str]]] = None
             ) -> dict:
    """One cell's record.  ``cfg``, ``shape`` and ``mesh`` ((sizes,
    names) of the fake world) override the registry's config, the
    ``SHAPES`` entry and the production mesh (a reduced cell)."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    sizes, names = mesh if mesh is not None else PRODUCTION[multi_pod]
    world = int(np.prod(sizes))
    rec: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(n) for n in sizes),
        "devices": world,
        "kind": shape.kind,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "analytic": flops_model(cfg, shape),
        "analytic_bytes": bytes_model(cfg, shape),
        "model_flops_ref": model_flops_reference(cfg, shape),
    }
    with fake_world(world):
        device_mesh = _mesh(range(world), tuple(sizes), tuple(names), "cpu")
        rec["args_bytes"] = argument_bytes(cfg, shape, device_mesh)
        rec.update(_trace(cfg, shape, device_mesh))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="trace every (arch x shape x mesh) cell on the host "
                    "under a fake world and fake tensors")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            ok, why = shape_applicable(arch, shape_name)
            for multi in meshes:
                tag = f"{'multi' if multi else 'single'}_{arch}_{shape_name}"
                path = outdir / f"dryrun_{tag}.json"
                mesh_name = "2x16x16" if multi else "16x16"
                if args.skip_existing and path.exists():
                    print(f"[skip existing] {tag}")
                    continue
                if not ok:
                    path.write_text(json.dumps(
                        {"arch": arch, "shape": shape_name,
                         "mesh": mesh_name, "skipped": why}, indent=2))
                    print(f"[SKIP] {tag}: {why}")
                    continue
                try:
                    rec = run_cell(arch, shape_name, multi)
                    path.write_text(json.dumps(rec, indent=2))
                    cb = rec["collectives"]["wire_bytes"]
                    print(f"[OK] {tag}: trace {rec['trace_s']}s flops "
                          f"{rec['cost']['flops']:.3e} coll {cb / 1e9:.2f}GB "
                          f"args {rec['args_bytes']['total'] / 2**30:.2f}GiB "
                          f"peak {rec['peak_live_bytes'] / 2**30:.2f}GiB",
                          flush=True)
                except Exception as e:
                    failures += 1
                    path.write_text(json.dumps(
                        {"arch": arch, "shape": shape_name,
                         "mesh": mesh_name, "error": str(e),
                         "traceback": traceback.format_exc()}, indent=2))
                    print(f"[FAIL] {tag}: {e}", flush=True)
    print(f"done; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
