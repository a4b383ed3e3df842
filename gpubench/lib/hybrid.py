"""A hybrid Mamba-2 / attention MoE configuration file (Hugging Face
``granitemoehybrid`` keys) as the port's model, and its weights: drawn
once from the seed on the device, in the reference's layout
(``reference/hybrid_decoder.py``), and handed to the port as views of the
same tensors."""
from __future__ import annotations

import math
from typing import Dict

from gpubench.reference import hybrid_decoder as ref

NORM_STD = 0.1      # norm scales and conv biases: normal with this std
D_STD = 0.1         # the D skip: normal around 1 with this std
# Mamba-2's own initial ranges: A = -exp(A_log) with exp(A_log) uniform
# in [1, 16], and dt_bias the inverse softplus of a dt log-uniform in
# [1e-3, 1e-1]
A_RANGE = (1.0, 16.0)
DT_RANGE = (1.0e-3, 1.0e-1)
# wq and wk are drawn so that the attention scores (q·k times
# attention_multiplier, for inputs of unit RMS) spread with this std, as a
# trained model's do: at 1/sqrt(fan-in) and the published scale of 1/128
# they would spread by about 0.09, and softmax over thousands of keys
# would be a causal mean of V whatever its scores
SCORE_STD = 2.0
# fan-in of each weight's normal draw (std 1/sqrt(fan-in)), in sizes
FAN_IN = {
    "router": "d", "w_gate": "d", "w_up": "d", "w_down": "ffn",
    "shared_gate": "d", "shared_up": "d", "shared_down": "shared_ffn",
    "w_zx": "d", "w_bcdt": "d", "conv_x": "conv", "conv_B": "conv",
    "conv_C": "conv", "w_out": "mamba_heads*mamba_head_dim",
    "wq": "d", "wk": "d", "wv": "d", "wo": "heads*head_dim",
}


def _fan(spec: Dict, expr: str) -> int:
    return math.prod(int(spec[k]) for k in expr.split("*"))


def padded_vocab(cfg: Dict) -> int:
    pad = int(cfg["assumed"]["vocab_pad_multiple"])
    return -(-int(cfg["vocab_size"]) // pad) * pad


def layer_layout(spec: Dict, kind: str) -> Dict[str, tuple]:
    """A layer's weights (name -> shape) in the reference's layout."""
    names = dict(ref.COMMON, **(ref.MAMBA if kind == "mamba"
                                else ref.ATTENTION))
    return {name: tuple(ref.size(spec, e) for e in shape)
            for name, shape in names.items()}


def qk_gain(spec: Dict) -> float:
    """The factor on wq's and wk's std: q and k elements then have std
    ``g`` for inputs of unit RMS, and the scores std
    ``attention_multiplier * sqrt(head_dim) * g**2`` = :data:`SCORE_STD`."""
    return (SCORE_STD / (spec["attention_multiplier"]
                         * spec["head_dim"] ** 0.5)) ** 0.5


def make_weights(cfg: Dict, seed: int, device: str, torch) -> Dict:
    """Float32 weights from a generator on ``device`` seeded with
    ``seed``, one draw a leaf, layer by layer: products normal with std
    1/sqrt(fan-in) (:data:`FAN_IN`), wq and wk with that std times
    :func:`qk_gain`, the embedding (padded rows included) with std
    1/sqrt(d); norm scales and conv biases normal with std
    :data:`NORM_STD`; D normal around 1 with std :data:`D_STD`; A_log and
    dt_bias from Mamba-2's initial ranges."""
    spec = ref.spec_of(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal(shape, std, mean=0.0):
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device)
        return t.mul_(std).add_(mean)

    def uniform(shape, lo, hi):
        t = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        return t.mul_(hi - lo).add_(lo)

    gain = qk_gain(spec)

    def draw(name, shape):
        if name in FAN_IN:
            std = _fan(spec, FAN_IN[name]) ** -0.5
            return normal(shape, std * (gain if name in ("wq", "wk")
                                        else 1.0))
        if name == "D_skip":
            return normal(shape, D_STD, 1.0)
        if name == "A_log":
            return uniform(shape, *A_RANGE).log_()
        if name == "dt_bias":
            dt = uniform(shape, *(math.log(v) for v in DT_RANGE)).exp_()
            return dt + torch.log(-torch.expm1(-dt))       # softplus⁻¹
        return normal(shape, NORM_STD)

    w = {"embedding": normal((padded_vocab(cfg), spec["d"]),
                             spec["d"] ** -0.5),
         "final_norm": normal((spec["d"],), NORM_STD), "layers": []}
    for kind in spec["layer_types"]:
        w["layers"].append({name: draw(name, shape) for name, shape
                            in layer_layout(spec, kind).items()})
    return w


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` of a ``granitemoehybrid`` configuration
    file: its published multipliers, NoPE, the conv bias, the gated norm
    over ``mamba_n_groups`` groups and the shared expert."""
    import torch

    from repro_torch.models.api import LayerSpec, ModelConfig

    if cfg["model_type"] != "granitemoehybrid" or cfg["mamba_proj_bias"] \
            or cfg["attention_bias"]:
        raise ValueError(f"{cfg['name']}: the port's hybrid model is "
                         "granitemoehybrid without projection biases")
    spec = ref.spec_of(cfg)
    a = cfg["assumed"]
    return ModelConfig(
        name=cfg["name"], family="hybrid",
        num_layers=len(spec["layer_types"]), d_model=spec["d"],
        num_heads=spec["heads"], num_kv_heads=spec["kv_heads"],
        head_dim=spec["head_dim"], d_ff=spec["ffn"],
        vocab_size=spec["vocab"],
        pattern=tuple(LayerSpec("mamba" if t == "mamba" else "attn", "moe")
                      for t in spec["layer_types"]),
        num_experts=spec["experts"], num_experts_per_token=spec["top_k"],
        moe_capacity_factor=spec["capacity_factor"],
        moe_group_rows=spec["group_rows"],
        moe_shared_ff=spec["shared_ffn"],
        ssm_state=spec["d_state"], mamba_head_dim=spec["mamba_head_dim"],
        mamba_expand=int(cfg["mamba_expand"]), mamba_conv=spec["conv"],
        mamba_conv_bias=bool(cfg["mamba_conv_bias"]),
        mamba_norm_groups=int(cfg["mamba_n_groups"]),
        embedding_multiplier=spec["embedding_multiplier"],
        attention_multiplier=spec["attention_multiplier"],
        residual_multiplier=spec["residual_multiplier"],
        logits_scaling=spec["logits_scaling"], use_rope=False,
        norm_eps=spec["rms_norm_eps"],
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        dtype=getattr(torch, cfg["torch_dtype"]), param_dtype=torch.float32,
        attn_block_q=int(a["attn_block"]), attn_block_k=int(a["attn_block"]),
        vocab_pad_multiple=int(a["vocab_pad_multiple"]))


SHARED = {"w_gate": "shared_gate", "w_up": "shared_up",
          "w_down": "shared_down"}


def port_params(w: Dict, model) -> Dict:
    """The port's parameter tree over the same tensors (each layer its own
    block of the pattern, stacked over one repetition); raises when the
    port's layout (``model.defs()``) has other names or shapes."""
    from repro_torch.models.api import iter_leaves

    def one(t):
        return t.unsqueeze(0)

    blocks = {}
    for i, lw in enumerate(w["layers"]):
        mixer = [n for n in lw if n in ref.MAMBA or n in ref.ATTENTION]
        blocks[f"layer{i}"] = {
            "norm_mixer": {"scale": one(lw["norm_mixer"])},
            "mixer": {n: one(lw[n]) for n in mixer},
            "norm_mlp": {"scale": one(lw["norm_mlp"])},
            "mlp": {**{n: one(lw[n]) for n in ("router", "w_gate", "w_up",
                                                "w_down")},
                    "shared": {n: one(lw[r]) for n, r in SHARED.items()}},
        }
    params = {"embed": {"embedding": w["embedding"]},
              "final_norm": {"scale": w["final_norm"]}, "blocks": blocks}
    want = {p: tuple(d.shape) for p, d in iter_leaves(model.defs())}
    have = {p: tuple(t.shape) for p, t in iter_leaves(params)}
    if want != have:
        raise ValueError(f"the port's parameter layout changed: {want} "
                         f"against the benchmark's {have}")
    return params
