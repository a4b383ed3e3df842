"""Training launcher: the training loop over synthetic packed documents.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 8 --batch 8 --seq 4096 --microbatches 2 \\
        --ckpt-dir build/ck-smollm
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 20 --reduced --batch 8 --seq 128 --device cpu \\
        --ckpt-dir build/ck-reduced
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-360m --steps 8 --batch 8 --seq 4096 --tp 2 \\
        --distributed --ckpt-dir build/ck-smollm-tp2

Sequences longer than ``attn_block_q`` (512 at full width, 32 reduced) and
a multiple of it take the blockwise attention path, where the flash
kernel runs the forward of every attention layer (under autograd, and
again in the backward pass's recomputation with ``remat``); at the
default ``--seq 128`` a full-width config takes the dense path and
launches no kernel.  ``--device cpu`` runs the plain versions.

``--distributed`` joins the world of the ``torchrun`` environment (NCCL
on the card, gloo with ``--device cpu``; a process group initialised
before ``main`` is kept).  In a world of more than one rank the mesh is
``make_elastic_mesh(model_parallel=--tp)``, (data, model): every rank
draws the same global batch and keeps its rows, and the model runs
tensor parallel over the model axis.  Rank 0 prints and writes the
checkpoints (gathered arrays, restorable in a world of any size).  A run
resumes from the latest checkpoint in ``--ckpt-dir``: a rerun into the
same directory trains only the steps left, so each configuration wants a
directory of its own.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_config
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.launch.mesh import init_distributed, world_mesh
from repro_torch.models.transformer import Model
from repro_torch.parallel.sharding import make_sharder
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.optimizer import AdamW, cosine_schedule


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--tp", type=int, default=1, help="model-parallel size")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized variant of the arch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="build/checkpoints",
                    help="resumes from the latest checkpoint here")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--distributed", action="store_true",
                    help="join the torchrun world (init_process_group)")
    args = ap.parse_args(argv)

    if args.distributed:
        init_distributed(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    mesh = world_mesh(args.tp, args.device)
    model = Model(cfg, sharder=None if mesh is None
                  else make_sharder(cfg, mesh), device=args.device)
    log = print if mesh is None or dist.get_rank() == 0 \
        else (lambda *a, **k: None)
    log(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params on "
        f"{args.device}, batch {args.batch} x {args.seq}, "
        f"{args.microbatches} microbatch(es)"
        + (f", mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}"
           if mesh is not None else ""), flush=True)

    data = SyntheticLM(SyntheticConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed), device=args.device)
    loop = TrainLoop(
        model,
        AdamW(cosine_schedule(args.lr, max(args.steps // 10, 1), args.steps)),
        data,
        TrainLoopConfig(total_steps=args.steps,
                        checkpoint_every=args.ckpt_every,
                        checkpoint_dir=args.ckpt_dir,
                        microbatches=args.microbatches, log_every=1),
        metrics_hook=lambda step, rec: log(
            f"step {step:5d}  loss {rec['loss']:.4f}  "
            f"grad_norm {rec['grad_norm']:.4f}  {rec['time_s']*1e3:.0f} ms"
            + ("  [STRAGGLER]" if rec["straggler"] else ""), flush=True),
    )
    launches = flash_attention_kernel.launches
    t0 = time.perf_counter()
    try:
        final = loop.run(args.seed)
    finally:
        loop.close()
    log(f"done at step {final.step} in {time.perf_counter() - t0:.1f} s, "
        f"flash kernel launches {flash_attention_kernel.launches - launches}")
    return loop


if __name__ == "__main__":
    main()
