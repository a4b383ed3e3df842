"""The rank side of ``tests/test_torch_sharded.py``: one gloo world of CPU
ranks runs every case of the port's sharded engines and each rank saves
what it got.  Imports torch and the port only (the spawned ranks never
load JAX)."""
from __future__ import annotations

import pathlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import core
from repro_torch.core import collectives
from repro_torch.core import prefix
from repro_torch.core.errors import ValidationError
from repro_torch.core.intervals import Extents
from repro_torch.launch import mesh as mesh_lib

BF_BLOCK = 64


def extents(lo, hi) -> Extents:
    return Extents(torch.from_numpy(np.array(lo, np.float32)),
                   torch.from_numpy(np.array(hi, np.float32)))


def _raises(fn) -> str:
    """The name of the port error ``fn`` raises ("" if none)."""
    try:
        fn()
    except ValidationError as exc:
        return f"ValidationError: {exc}"
    return ""


def _run_cases(mesh, spec: dict) -> dict:
    axis = mesh.mesh_dim_names[0]
    group, p, index = collectives.mesh_axis(mesh, axis)
    out = {}
    x = torch.from_numpy(spec["cumsum"])
    shard = collectives.shard_padded(x, p, index, 0)
    out["cumsum"] = prefix.shard_inclusive_cumsum(shard, group)
    totals = torch.stack([shard.sum(dtype=torch.int64),
                          -shard.sum(dtype=torch.int64)])
    out["offsets"] = prefix.shard_exclusive_offsets(totals, group)
    for name, (s_lo, s_hi, u_lo, u_hi) in spec["counts"].items():
        subs, upds = extents(s_lo, s_hi), extents(u_lo, u_hi)
        out[f"sbm {name}"] = core.sbm_count_sharded(subs, upds, mesh, axis)
        out[f"rank {name}"] = core.rank_count_sharded(subs, upds, mesh, axis)
        out[f"bf {name}"] = core.bf_count_sharded(subs, upds, mesh, axis,
                                                  block=BF_BLOCK)
        out[f"enumerate {name}"] = core.sbm_enumerate_sharded(
            subs, upds, mesh, axis, max_pairs=spec["max_pairs"])
    subs, upds = extents(*spec["cut"][:2]), extents(*spec["cut"][2:])
    out["enumerate cut"] = core.sbm_enumerate_sharded(
        subs, upds, mesh, axis, max_pairs=spec["cut_pairs"])
    out["enumerate capped"] = core.sbm_enumerate_sharded(
        subs, upds, mesh, axis, max_pairs=spec["max_pairs"],
        max_pairs_per_shard=spec["caps"][p])
    for name, (s_lo, s_hi, u_lo, u_hi) in spec["bitmatrix"].items():
        out[f"bitmatrix {name}"] = core.bitmatrix_sharded(
            extents(s_lo, s_hi), extents(u_lo, u_hi), mesh, axis)
    n, m = spec["wide"]
    subs = Extents(torch.zeros(n), torch.ones(n))
    upds = Extents(torch.full((m,), 0.5), torch.full((m,), 2.0))
    out["wide sbm"] = core.sbm_count_sharded(subs, upds, mesh, axis)
    out["wide rank"] = core.rank_count_sharded(subs, upds, mesh, axis)
    out["wide enumerate"] = core.sbm_enumerate_sharded(
        subs, upds, mesh, axis, max_pairs=16)
    # the collectives themselves
    row = torch.arange(3, dtype=torch.int32) + 10 * index
    out["gather"] = collectives.all_gather(row, group)
    out["gather empty"] = collectives.all_gather(row[:0], group)
    out["reduce"] = collectives.all_reduce_sum(row, group)
    return out


def _mesh_cases(world: int) -> dict:
    """The mesh builders' answers in this world (every rank calls each)."""
    out = {
        "production": _raises(lambda: mesh_lib.make_production_mesh(
            device="cpu")),
        "multi-pod": _raises(lambda: mesh_lib.make_production_mesh(
            multi_pod=True, device="cpu")),
        "host num=0": _raises(lambda: mesh_lib.make_host_mesh(0,
                                                              device="cpu")),
        "elastic indivisible": _raises(lambda: mesh_lib.make_elastic_mesh(
            model_parallel=world + 1, device="cpu")),
    }
    elastic = mesh_lib.make_elastic_mesh(model_parallel=world, device="cpu")
    out["elastic"] = (tuple(elastic.mesh.shape), elastic.mesh_dim_names)
    host = mesh_lib.make_host_mesh(axis="p", device="cpu")
    out["host"] = (tuple(host.mesh.shape), host.mesh_dim_names)
    wide = mesh_lib.make_host_mesh(world + 5, device="cpu")
    out["host num>world"] = tuple(wide.mesh.shape)
    out["unknown axis"] = _raises(lambda: core.rank_count_sharded(
        extents([0], [1]), extents([0], [1]), host, "model"))
    # the first two ranks only: the others hold a mesh they are not in
    pair = mesh_lib.make_host_mesh(2, device="cpu")
    subs, upds = extents([0, 2, 4], [1, 3, 5]), extents([0.5, 3], [2.5, 9])
    if dist.get_rank() < 2:
        out["host num=2"] = core.sbm_count_sharded(subs, upds, pair, "data")
    else:
        out["host num=2"] = _raises(lambda: core.sbm_count_sharded(
            subs, upds, pair, "data"))
    return out


def run_world(rank: int, world: int, init_file: str, spec: dict,
              out_dir: str) -> None:
    """One rank: join the gloo world, run every case, save the results."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        results = _run_cases(mesh_lib.make_host_mesh(device="cpu"), spec)
        results["mesh"] = _mesh_cases(world)
        torch.save(results, pathlib.Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()
