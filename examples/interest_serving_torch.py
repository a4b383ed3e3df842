"""Serving with interest-managed attention on the PyTorch/CUDA port:
batched requests through the continuous-batching engine, plus a look
inside the DDM block schedule that prunes attention for long contexts.

The twin of ``examples/interest_serving.py`` on ``repro_torch``.  Runs on
the card unless given ``--device cpu``.

    PYTHONPATH=src python examples/interest_serving_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.kernels.ops import build_block_structure
from repro_torch.models import Model
from repro_torch.serve.engine import Request, ServeEngine


def show_block_schedule() -> None:
    print("== DDM interest matching → attention block schedule ==")
    s, w, blk = 8192, 1024, 512
    kv_index, kv_count, bm = build_block_structure(
        s, s, block_q=blk, block_k=blk, causal=True, window=w,
        num_global_blocks=1)
    dense = (s // blk) * (s // blk + 1) // 2
    print(f"seq {s}, window {w}, block {blk}: "
          f"{int(bm.sum())}/{dense} causal blocks kept "
          f"({int(bm.sum())/dense:.1%}) — per-q-block kv lists:")
    for i in (0, 7, 15):
        idx = kv_index[i, :kv_count[i]]
        print(f"  q-block {i:3d} -> kv blocks {list(idx)}")


def serve_batch(device) -> dict:
    print(f"\n== batched serving on {device} (gemma2-family reduced: "
          "local+global) ==")
    cfg = reduce_config(get_config("gemma2-2b"))
    model = Model(cfg, device=device)
    params = model.init(torch.Generator(device).manual_seed(0))
    eng = ServeEngine(model, params, num_slots=4, max_len=128, device=device)
    rng = np.random.RandomState(0)
    n_req = 10
    for rid in range(n_req):
        plen = rng.choice([16, 16, 32])
        eng.submit(Request(rid, rng.randint(1, cfg.vocab_size,
                                            size=plen).tolist(),
                           max_new_tokens=8))
    results = eng.run()
    for rid in sorted(results):
        r = results[rid]
        print(f"  req {rid}: prompt {r.prompt_len:3d} tokens -> "
              f"generated {r.tokens}")
    assert len(results) == n_req
    assert all(len(r.tokens) == 8 and all(0 <= t < cfg.padded_vocab
                                          for t in r.tokens)
               for r in results.values())
    print("all requests served")
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    show_block_schedule()
    serve_batch(args.device)
    print("\nOK")


if __name__ == "__main__":
    main()
