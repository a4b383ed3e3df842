"""Serving launcher: the wave-batching engine over synthetic requests, on
one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --prompt-len 2048 --max-len 2560
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \\
        --prompt-len 8192 --max-len 8704
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m --prompt-len 2048 --max-len 2560
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
        --prompt-len 2048 --max-len 2560

Every arch of ``repro_torch.configs.ARCH_IDS`` is served but the two whose
prefill needs more than tokens (phi-3-vision-4.2b's image prefix,
seamless-m4t-medium's encoder frames), which raise ``ValidationError``
before any weight is made.  Prompts longer
than ``attn_block_q`` (512 at full width) and a multiple of it take the
blockwise attention path, the flash kernel's call site; shorter ones take
the dense path and never launch it, and mamba2-2.7b, attention-free,
never does.  ``--device cpu`` runs the plain versions (reduced configs
only, in practice).

Under ``torchrun`` (``WORLD_SIZE`` > 1; NCCL on the card, gloo on the
CPU), or in a process group initialised before ``main``, a world of more
than one rank serves on ``make_elastic_mesh(model_parallel=--tp)``: each
rank holds its blocks of the weights, every rank runs the same waves on
its rows, and rank 0 prints.

    torchrun --nproc-per-node 2 -m repro_torch.launch.serve \\
        --arch granite-moe-3b-a800m --prompt-len 2048 --max-len 2560 --tp 2
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.launch.mesh import init_distributed, world_mesh
from repro_torch.models.transformer import Model
from repro_torch.parallel.sharding import make_sharder
from repro_torch.serve.engine import Request, ServeEngine, check_servable


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tp", type=int, default=1, help="model-parallel size")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    check_servable(cfg)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        init_distributed(args.device)
    mesh = world_mesh(args.tp, args.device)
    model = Model(cfg, sharder=None if mesh is None
                  else make_sharder(cfg, mesh), device=args.device)
    params = model.init(torch.Generator(args.device).manual_seed(args.seed))
    log = print if mesh is None or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    log(f"serving {cfg.name} ({cfg.param_count()/1e6:.1f}M params, "
        f"{cfg.active_param_count()/1e6:.1f}M active) on {args.device}, "
        f"{args.slots} slots, max_len {args.max_len}"
        + (f", mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}"
           if mesh is not None else ""))

    eng = ServeEngine(model, params, num_slots=args.slots,
                      max_len=args.max_len, device=args.device)
    rng = np.random.RandomState(args.seed)
    launches = flash_attention_kernel.launches
    t0 = time.time()
    for rid in range(args.requests):
        eng.submit(Request(rid,
                           rng.randint(1, cfg.vocab_size,
                                       size=args.prompt_len).tolist(),
                           max_new_tokens=args.max_new))
    results = eng.run()
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    total_new = sum(len(r.tokens) for r in results.values())
    log(f"{len(results)} requests, {total_new} tokens in {dt:.1f}s "
        f"({total_new/dt:.1f} tok/s), flash kernel launches "
        f"{flash_attention_kernel.launches - launches}")
    for rid in sorted(results)[:4]:
        log(f"  req {rid}: {results[rid].tokens[:8]}...")
    return results


if __name__ == "__main__":
    main()
