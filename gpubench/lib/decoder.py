"""A decoder configuration file (Hugging Face keys) as the port's model,
and its weights: drawn once from the seed on the device, in the
reference's layout, and handed to the port as views of the same tensors.
"""
from __future__ import annotations

from typing import Dict

from gpubench.lib.arith import decoder_dims

# the reference's weights, stacked over the layers: name -> (shape of one
# layer in terms of the sizes, fan-in of the draw's std; None: a norm
# scale)
LAYOUT = {
    "attn_norm": (("d",), None),
    "wq": (("d", "heads", "head_dim"), "d"),
    "wk": (("d", "kv_heads", "head_dim"), "d"),
    "wv": (("d", "kv_heads", "head_dim"), "d"),
    "wo": (("heads", "head_dim", "d"), "heads*head_dim"),
    "mlp_norm": (("d",), None),
    "router": (("d", "experts"), "d"),
    "w_gate": (("experts", "d", "ffn"), "d"),
    "w_up": (("experts", "d", "ffn"), "d"),
    "w_down": (("experts", "ffn", "d"), "ffn"),
}
NORM_STD = 0.1


def _size(dims: Dict[str, int], expr: str) -> int:
    out = 1
    for part in expr.split("*"):
        out *= dims[part]
    return out


def make_weights(cfg: Dict, seed: int, device: str, torch) -> Dict:
    """Float32 weights from a generator on ``device`` seeded with
    ``seed``: one draw a stacked leaf, normal with std 1/sqrt(fan-in),
    norm scales normal with std NORM_STD; the embedding (padded vocabulary
    rows included) with std 1/sqrt(d)."""
    x = decoder_dims(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def draw(shape, std):
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return t.mul_(std)

    w = {"embedding": draw((x["padded_vocab"], x["d"]), x["d"] ** -0.5),
         "final_norm": draw((x["d"],), NORM_STD)}
    for name, (shape, fan) in LAYOUT.items():
        full = (x["layers"],) + tuple(x[s] for s in shape)
        w[name] = draw(full, NORM_STD if fan is None
                       else _size(x, fan) ** -0.5)
    return w


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` of a MoE decoder configuration file."""
    import torch

    from repro_torch.models.api import LayerSpec, ModelConfig

    if cfg["model_type"] != "granitemoe":
        raise ValueError(f"{cfg['name']}: no port model for model_type "
                         f"{cfg['model_type']!r}")
    x = decoder_dims(cfg)
    a = cfg["assumed"]
    run = a["multipliers_run"]
    if abs(run["embedding_multiplier"] - x["d"] ** 0.5) > 1e-9 \
            or run["attention_multiplier"] != x["head_dim"] ** -0.5 \
            or run["residual_multiplier"] != 1.0 \
            or run["logits_scaling"] != 1.0:
        raise ValueError(f"{cfg['name']}: the port's model runs only the "
                         "multipliers sqrt(d), head_dim**-0.5, 1 and 1")
    return ModelConfig(
        name=cfg["name"], family="moe", num_layers=x["layers"],
        d_model=x["d"], num_heads=x["heads"], num_kv_heads=x["kv_heads"],
        head_dim=x["head_dim"], d_ff=x["ffn"], vocab_size=x["vocab"],
        pattern=(LayerSpec("attn", "moe"),), num_experts=x["experts"],
        num_experts_per_token=x["top_k"],
        moe_capacity_factor=float(a["moe_capacity_factor"]),
        moe_group_rows=int(a["moe_group_rows"]),
        rope_theta=float(cfg["rope_theta"]),
        norm_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        dtype=getattr(torch, cfg["torch_dtype"]), param_dtype=torch.float32,
        attn_block_q=int(a["attn_block"]), attn_block_k=int(a["attn_block"]),
        vocab_pad_multiple=int(a["vocab_pad_multiple"]))


def port_params(w: Dict, model) -> Dict:
    """The port's parameter tree over the same tensors; raises when the
    port's layout (``model.defs()``) has other names or shapes."""
    from repro_torch.models.api import iter_leaves

    params = {
        "embed": {"embedding": w["embedding"]},
        "final_norm": {"scale": w["final_norm"]},
        "blocks": {"layer0": {
            "norm_mixer": {"scale": w["attn_norm"]},
            "mixer": {k: w[k] for k in ("wq", "wk", "wv", "wo")},
            "norm_mlp": {"scale": w["mlp_norm"]},
            "mlp": {k: w[k] for k in ("router", "w_gate", "w_up", "w_down")},
        }},
    }
    want = {p: tuple(d.shape) for p, d in iter_leaves(model.defs())}
    have = {p: tuple(t.shape) for p, t in iter_leaves(params)}
    if want != have:
        raise ValueError(f"the port's parameter layout changed: {want} "
                         f"against the benchmark's {have}")
    return params
