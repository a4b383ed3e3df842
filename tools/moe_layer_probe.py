"""Each MoE mode's layer outputs inside a granite-moe-3b-a800m prefill,
on one card shared by a world of 4 gloo ranks (mesh data 1 x model 4).

For every MoE layer of a 4 x 2048 prefill (full width, the first
``--layers`` layers, random weights from a seed) and for ``moe_impl``
auto (ep), cap and ffn, prints the layer's bf16 output against the
einsum path's on the same input and weights (max |diff| over its max),
and whether the output is the same on every model rank (it feeds the
next layer's routing, which each rank computes for itself).

    python3 tools/moe_layer_probe.py [--layers N] [SRC]

SRC is the ``src/`` directory of the port to load (default this
checkout's), so that two commits run in one call on one card.
"""
import argparse
import dataclasses
import datetime
import json
import pathlib
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def run(rank: int, port: int, src: str, layers: int) -> None:
    sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_elastic_mesh
    from repro_torch.models import Model, moe
    from repro_torch.parallel.sharding import make_sharder

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank,
                            timeout=datetime.timedelta(seconds=600))
    mesh = make_elastic_mesh(model_parallel=WORLD, device="cuda")
    group = mesh.get_group("model")
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              num_layers=layers)
    params = Model(cfg, sharder=make_sharder(cfg, mesh), device="cuda") \
        .init(torch.Generator("cuda").manual_seed(7))
    toks = torch.randint(1, cfg.vocab_size, (4, 2048),
                         generator=torch.Generator().manual_seed(7)).cuda()
    defs = moe.moe_defs(cfg)
    real = moe.moe_layer
    report = {}
    for impl in ("auto", "cap", "ffn"):
        c = dataclasses.replace(cfg, moe_impl=impl)
        model = Model(c, sharder=make_sharder(c, mesh), device="cuda")
        rows = []

        def hooked(p, x, cf, sharder=None, **kw):
            res = real(p, x, cf, sharder, **kw)
            whole = {n: moe._block(t, defs[n], sharder) for n, t in p.items()}
            one = real(whole, x, dataclasses.replace(cf, moe_impl="auto"))[0]
            bits = res[0].contiguous().view(torch.int16).sum(dtype=torch.int64)
            hi, lo = bits.clone(), -bits
            dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
            dist.all_reduce(lo, op=dist.ReduceOp.MAX, group=group)
            rows.append({"vs einsum": float((res[0].float() - one.float())
                                            .abs().max() / one.float().abs()
                                            .max()),
                         "same on every rank": bool(hi == -lo)})
            return res
        moe.moe_layer = hooked
        try:
            with torch.no_grad():
                model.prefill(params, {"tokens": toks},
                              model.init_cache(4, 2048 + 8))
        finally:
            moe.moe_layer = real
        report[impl] = rows
    if rank == 0:
        print(json.dumps({"src": src, "layers": report}), flush=True)
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("src", nargs="?", default=str(
        pathlib.Path(__file__).resolve().parents[1] / "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("moe_layer_probe: needs a CUDA device")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.start_processes(run, args=(port, str(pathlib.Path(args.src).resolve()),
                                  args.layers),
                       nprocs=WORLD, join=True, start_method="spawn")


if __name__ == "__main__":
    main()
