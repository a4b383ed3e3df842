"""Quickstart of the PyTorch/CUDA port: train a small LM end to end —
packed synthetic data (document extents from the DDM engine),
interest-managed attention, AdamW, async checkpointing, restart.

The twin of ``examples/quickstart.py`` on ``repro_torch``.  ``--preset
tiny`` is a few M parameters (the loss visibly falls within 30 steps);
``--preset 100m`` is a ~100M-parameter smollm-family config on the same
code path.  Runs on the card unless given ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 200] [--preset tiny] [--device cpu]
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.models import Model
from repro_torch.train.loop import TrainLoop, TrainLoopConfig
from repro_torch.train.optimizer import AdamW, cosine_schedule


def build_config(preset: str):
    base = get_config("smollm-360m")
    if preset == "tiny":
        cfg = dataclasses.replace(
            reduce_config(base), d_model=128, num_layers=4, d_ff=384,
            num_heads=4, num_kv_heads=2, head_dim=32, vocab_size=4099)
        data = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=128,
                               global_batch=8, mean_doc_len=48)
    elif preset == "100m":
        cfg = dataclasses.replace(
            base, num_layers=12, d_model=768, num_heads=12, num_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=32_000,
            dtype=torch.bfloat16, remat=False)
        data = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=1024,
                               global_batch=32, mean_doc_len=256)
    else:
        raise SystemExit(f"unknown preset {preset}")
    return cfg, data


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--ckpt-dir", default="build/quickstart_torch")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, data_cfg = build_config(args.preset)
    model = Model(cfg, device=args.device)
    n_params = cfg.param_count()
    print(f"model: {cfg.name} ({args.preset}) — {n_params/1e6:.1f}M params "
          f"on {args.device}")

    loop = TrainLoop(
        model,
        AdamW(cosine_schedule(3e-3, 20, args.steps),
              moment_dtype=torch.float32),
        SyntheticLM(data_cfg, device=args.device),
        TrainLoopConfig(total_steps=args.steps, checkpoint_every=50,
                        checkpoint_dir=args.ckpt_dir, log_every=10),
        metrics_hook=lambda step, rec: print(
            f"step {step:4d}  loss {rec['loss']:.4f}  "
            f"gnorm {rec['grad_norm']:.3f}  {rec['time_s']*1e3:.0f} ms"
            + ("  [STRAGGLER]" if rec["straggler"] else "")),
    )
    final = loop.run(0, resume=True)
    loop.close()
    losses = [h["loss"] for h in loop.history if "loss" in h]
    if losses:
        print(f"\ntrained to step {final.step}: "
              f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"checkpoints in {args.ckpt_dir} (restart me to resume)")


if __name__ == "__main__":
    main()
