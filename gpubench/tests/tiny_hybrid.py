"""Tiny stand-ins for the hybrid cell's files, for the CPU tests only:
the same keys and driver at sizes a CPU runs in a second."""
import copy

from gpubench.lib.common import BENCH, load_json

CELL = "granite-4.0-h-small.prefill-4k"
TINY_HYBRID = {
    "hidden_size": 64, "intermediate_size": 32,
    "shared_intermediate_size": 32, "num_attention_heads": 4,
    "num_key_value_heads": 2, "num_local_experts": 8,
    "num_experts_per_tok": 2, "vocab_size": 515, "mamba_n_heads": 4,
    "mamba_d_head": 32, "mamba_d_state": 16,
}


def hybrid_files(*, prompt_len: int = 64, hidden: int = 64, **traffic):
    """The cell's files at a tiny width (``hidden``, its Mamba heads of
    32 following it), prompts above the attention block (the flash path's
    plain version)."""
    cfg = copy.deepcopy(load_json(BENCH / "configs"
                                  / "granite-4.0-h-small.json"))
    cfg.update(TINY_HYBRID, hidden_size=hidden,
               mamba_n_heads=cfg["mamba_expand"] * hidden // 32)
    cfg["assumed"].update(attn_block=32, vocab_pad_multiple=64)
    tr = load_json(BENCH / "traffic" / "prefill-4k.json")
    tr.update(prompt_len=prompt_len, warmup_waves=1, logit_waves=4,
              kv_waves=2)
    tr.update(traffic)
    limits = load_json(BENCH / "limits" / f"{CELL}.json")
    return {"config": cfg, "traffic": tr, "limits": limits}
