"""Tiny stand-ins for the cells' files, for the CPU tests only: the same
keys and drivers at sizes a CPU runs in a second."""
import copy

from gpubench.lib.common import BENCH, load_json

TINY_DECODER = {
    "hidden_size": 64, "intermediate_size": 32, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 2,
    "num_local_experts": 8, "num_experts_per_tok": 2, "vocab_size": 515,
}
TINY_DECODER_ASSUMED = {"head_dim": 16, "attn_block": 32}


def run_multipliers(cfg):
    """Set the multipliers the port runs (sqrt(d), head_dim**-0.5, 1, 1)
    for ``cfg``'s sizes."""
    a = cfg["assumed"]
    a["multipliers_run"] = {
        "embedding_multiplier": cfg["hidden_size"] ** 0.5,
        "attention_multiplier": a["head_dim"] ** -0.5,
        "residual_multiplier": 1.0, "logits_scaling": 1.0}
    return cfg


def decoder_files(cell: str, *, prompt_len: int = 64, clients: int = 4):
    """The files of a granite cell at tiny sizes (prompts above the
    attention block take the flash path's plain version)."""
    cfg = copy.deepcopy(load_json(BENCH / "configs"
                                  / "granite-moe-3b-a800m.json"))
    cfg.update(TINY_DECODER)
    cfg["assumed"].update(TINY_DECODER_ASSUMED)
    run_multipliers(cfg)
    traffic = load_json(BENCH / "traffic" / (cell.split(".")[1] + ".json"))
    traffic.update(clients=clients, slots=clients, prompt_len=prompt_len,
                   warmup_waves=1)
    limits = load_json(BENCH / "limits" / f"{cell}.json")
    return {"config": cfg, "traffic": traffic, "limits": limits}


def ddm_files(n: int = 3000, alpha: float = 30.0):
    cfg = load_json(BENCH / "configs" / "ddm-paper-n1e6.json")
    cfg.update(n_extents=2 * n, n_subscriptions=n, n_updates=n, alpha=alpha)
    traffic = load_json(BENCH / "traffic" / "match-a100.json")
    traffic.update(warmup_matches=1)
    limits = load_json(BENCH / "limits" / "ddm-paper.match-a100.json")
    return {"config": cfg, "traffic": traffic, "limits": limits}
