"""The pattern-block transformer: forward, loss, prefill and decode.

A model is ``num_blocks`` repetitions of a *pattern block* (a tuple of
LayerSpecs); parameters are stacked on a leading ``layers`` axis, as in the
JAX package, and a Python loop over that axis replaces its ``lax.scan``.
Per-layer state (KV caches, Mamba states) is stacked the same way and
updated in place.  ``forward_with_aux`` and :meth:`Model.loss` carry
gradients (with ``cfg.remat`` each block is recomputed in the backward
pass); ``prefill`` and ``decode_step`` run without autograd.

Mixers: ``attn``, ``attn_local``, ``attn_bidir`` and ``mamba``, any of
them followed by cross-attention (``cross_attn``); MLPs: ``dense``,
``moe`` and ``none``.  An encoder-decoder model runs its encoder stack
(``encoder_pattern``) over ``frame_embeds`` and its decoder
cross-attends to the encoder output; a ``vision`` frontend prepends
projected ``prefix_embeds`` to the token embeddings, an ``audio`` one
projects the frames.

``Model(cfg, sharder=...)`` over a ``("data", "model")`` mesh (the
:class:`~repro_torch.parallel.sharding.Sharder` of
:func:`~repro_torch.parallel.sharding.make_sharder`) computes what the
model computes on one device: every rank passes the same global batch
and keeps its rows (the ``batch`` axis's layout: data parallelism); each
rank stores its blocks of the parameters in the JAX layout
(:meth:`Model.init` cuts them leaf by leaf), cut over the data axis too
(FSDP): each pattern block's parameters are gathered over the data axis
at the top of :func:`_apply_block` (inside the recomputed function under
``remat``, so the gathered weights live while their block runs), the
embedding, the final norms and the frontend projection at their own use.
Each layer runs tensor parallel over heads, KV heads, FFN, vocab,
experts and Mamba heads where the layout splits them, with the
all-reduces written out.  ``sharder=None`` keeps every single-device path
as it was.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core.errors import ValidationError
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.api import (LayerSpec, ModelConfig, ParamDef,
                                    init_params, iter_leaves, param_specs,
                                    stack_defs)
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (cross_entropy, embed_defs,
                                       embed_tokens, rmsnorm, rmsnorm_defs,
                                       unembed, vocab_shard)
from repro_torch.models.mamba import MambaState
from repro_torch.parallel.sharding import Sharder

MIXERS = ("attn", "attn_local", "attn_bidir", "mamba")
MLPS = ("dense", "moe", "none")
FRONTENDS = (None, "vision", "audio")


def check_supported(cfg: ModelConfig) -> None:
    """Raise :class:`ValidationError` for what the port does not run."""
    specs = cfg.pattern + (cfg.encoder_pattern if cfg.is_encoder_decoder
                           else ())
    for spec in specs:
        if spec.mixer not in MIXERS or spec.mlp not in MLPS:
            raise ValidationError(
                f"{cfg.name}: layer {spec} is not ported (mixers {MIXERS}, "
                f"MLPs {MLPS})")
    if cfg.frontend not in FRONTENDS:
        raise ValidationError(f"{cfg.name}: frontend {cfg.frontend!r} is "
                              f"not one of {FRONTENDS}")
    if cfg.is_encoder_decoder and (
            not cfg.encoder_pattern
            or cfg.num_encoder_layers % len(cfg.encoder_pattern)):
        raise ValidationError(
            f"{cfg.name}: {cfg.num_encoder_layers} encoder layers are not "
            f"whole repetitions of the encoder pattern {cfg.encoder_pattern}")
    if any(spec.mlp == "moe" for spec in specs):
        moe_lib.select_moe_mode(cfg)


def _sublayer_defs(cfg: ModelConfig, spec: LayerSpec):
    d: Dict[str, Any] = {"norm_mixer": rmsnorm_defs(cfg.d_model)}
    if spec.mixer == "mamba":
        d["mixer"] = mamba_lib.mamba_defs(cfg)
    else:
        d["mixer"] = attn_lib.attn_defs(cfg)
    if spec.cross_attn:
        d["norm_cross"] = rmsnorm_defs(cfg.d_model)
        d["cross"] = attn_lib.attn_defs(cfg, cross=True)
    if spec.mlp == "dense":
        d["norm_mlp"] = rmsnorm_defs(cfg.d_model)
        d["mlp"] = mlp_lib.mlp_defs(cfg)
    elif spec.mlp == "moe":
        d["norm_mlp"] = rmsnorm_defs(cfg.d_model)
        d["mlp"] = moe_lib.moe_defs(cfg)
    return d


def block_defs(cfg: ModelConfig, pattern: Tuple[LayerSpec, ...]):
    return {f"layer{i}": _sublayer_defs(cfg, s) for i, s in enumerate(pattern)}


def model_defs(cfg: ModelConfig):
    check_supported(cfg)
    defs: Dict[str, Any] = {
        "embed": embed_defs(cfg),
        "final_norm": rmsnorm_defs(cfg.d_model),
        "blocks": stack_defs(block_defs(cfg, cfg.pattern), cfg.num_blocks),
    }
    if cfg.is_encoder_decoder:
        defs["enc_blocks"] = stack_defs(
            block_defs(cfg, cfg.encoder_pattern),
            cfg.num_encoder_layers // len(cfg.encoder_pattern))
        defs["enc_final_norm"] = rmsnorm_defs(cfg.d_model)
    if cfg.frontend is not None:
        defs["frontend_proj"] = ParamDef(
            (cfg.d_model, cfg.d_model), ("embed", None), "normal")
    return defs


def _apply_block(cfg: ModelConfig, sharder: Sharder,
                 pattern: Tuple[LayerSpec, ...], params_block, x, positions,
                 segments, caches=None, enc_out=None, rows=None):
    """One pattern block; returns (x, new caches of the block, aux (2,)
    float32: the block's summed MoE [aux loss, z-loss]).  A layer with
    ``cross_attn`` attends, after its mixer, to ``enc_out`` (B, S_enc, d),
    non-causal; its K/V are projected from ``enc_out`` at every call.
    ``rows``: the global batch's row count (x holds this rank's rows).
    The block's parameters are FSDP-gathered here first
    (:meth:`Sharder.fsdp_gather`)."""
    rows = x.shape[0] if rows is None else rows
    params_block = sharder.fsdp_gather(params_block,
                                       block_defs(cfg, pattern), rows)
    aux = torch.zeros(2, dtype=torch.float32, device=x.device)
    new_caches: Dict[str, Any] = {}
    for i, spec in enumerate(pattern):
        sub = params_block[f"layer{i}"]
        h = rmsnorm(sub["norm_mixer"], x, cfg.norm_eps)
        cache_i = None if caches is None else caches[f"layer{i}"]
        if spec.mixer == "mamba":
            o, nc = mamba_lib.mamba_layer(sub["mixer"], h, cfg, sharder,
                                          state=cache_i)
        else:
            o, nc = attn_lib.attention_layer(
                sub["mixer"], h, cfg, sharder,
                causal=spec.mixer != "attn_bidir",
                window=cfg.window if spec.mixer == "attn_local" else None,
                positions=positions, segments=segments, cache=cache_i)
        if nc is not None:
            new_caches[f"layer{i}"] = nc
        x = x + o
        if spec.cross_attn:
            if enc_out is None:
                raise ValidationError(f"{cfg.name}: cross-attention needs "
                                      "the encoder output (enc_out)")
            h = rmsnorm(sub["norm_cross"], x, cfg.norm_eps)
            kv = attn_lib.make_cross_kv(sub["cross"], enc_out, cfg, sharder)
            o, _ = attn_lib.attention_layer(sub["cross"], h, cfg, sharder,
                                            causal=False, kv_override=kv)
            x = x + o
        if spec.mlp == "dense":
            h = rmsnorm(sub["norm_mlp"], x, cfg.norm_eps)
            x = x + mlp_lib.mlp(sub["mlp"], h, cfg, sharder)
        elif spec.mlp == "moe":
            h = rmsnorm(sub["norm_mlp"], x, cfg.norm_eps)
            o, moe_aux = moe_lib.moe_layer(sub["mlp"], h, cfg, sharder,
                                           batch=rows)
            aux = aux + torch.stack([moe_aux["moe_aux_loss"],
                                     moe_aux["moe_z_loss"]])
            x = x + o
    return x, new_caches, aux


def _index(tree, bi: int):
    if isinstance(tree, dict):
        return {key: _index(val, bi) for key, val in tree.items()}
    if isinstance(tree, (KVCache, MambaState)):
        return type(tree)(*(t[bi] for t in tree))
    return tree[bi]


def _needs_grad(x: torch.Tensor, stacked_params) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(
        leaf.requires_grad for _, leaf in iter_leaves(stacked_params)))


def _run_stack(cfg: ModelConfig, sharder: Sharder,
               pattern: Tuple[LayerSpec, ...], stacked_params, x, positions,
               segments, stacked_caches=None, enc_out=None, rows=None):
    """Run every block of ``pattern`` (the decoder's or the encoder's) in
    order; returns (x, the stacked caches, aux (2,) summed over the
    blocks).  Attention writes K/V into its block's cache views itself,
    and its new length is stored back here; a Mamba layer's new state (h
    and the three conv histories) is copied into its block's rows of the
    stacked float32 state.  With ``cfg.remat``, when autograd records the
    stack (training: no caches), each block runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass, as
    ``jax.checkpoint`` does in the JAX package; the recomputation issues
    the block's collectives again, in the same order on every rank."""
    aux = torch.zeros(2, dtype=torch.float32, device=x.device)
    num_blocks = next(iter_leaves(stacked_params))[1].shape[0]
    block_fn = _apply_block
    if cfg.remat and stacked_caches is None \
            and _needs_grad(x, stacked_params):
        block_fn = functools.partial(torch.utils.checkpoint.checkpoint,
                                     _apply_block, use_reentrant=False)
    for bi in range(num_blocks):
        caches = None if stacked_caches is None \
            else _index(stacked_caches, bi)
        x, new, a = block_fn(cfg, sharder, pattern,
                             _index(stacked_params, bi), x, positions,
                             segments, caches, enc_out, rows)
        aux = aux + a
        for name, nc in new.items():
            if isinstance(nc, KVCache):
                stacked_caches[name].length[bi] = nc.length
            else:
                for dst, src in zip(stacked_caches[name], nc):
                    dst[bi].copy_(src)
    return x, stacked_caches, aux


def make_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               sharder: Sharder, device) -> Dict[str, Any]:
    """:meth:`Model.init_cache` of a model of ``cfg`` under ``sharder``
    on ``device``, without building the model (``Model.__init__`` refuses
    a manual MoE mode with no mesh): ``sharder=Sharder()`` gives the
    global leaves, as the dry run's ``sds_cache`` takes them."""
    nb = cfg.num_blocks
    rows = batch // sharder.split("batch", batch).size
    kv = cfg.num_kv_heads \
        // sharder.split("kv_heads", cfg.num_kv_heads).size
    shape = (nb, rows, kv, max_len, cfg.head_dim)

    hm = cfg.mamba_heads // sharder.split(
        "mamba_heads", cfg.mamba_heads).size

    def one(spec: LayerSpec):
        if spec.mixer == "mamba":
            return mamba_lib.init_mamba_state(
                cfg, rows, torch.float32, device=device, layers=nb,
                heads=hm)
        return KVCache(
            torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(nb, dtype=torch.int32))

    return {f"layer{i}": one(s) for i, s in enumerate(cfg.pattern)}


class Model:
    """A thin class over a parameter dict: static config, sharder and
    device only.

    ``params`` is the nested dict of :meth:`init` (or of
    :func:`repro_torch.convert.model_params_from_arrays` followed by
    :func:`repro_torch.parallel.sharding.shard_params`), with the JAX
    package's structure and names; under a mesh each leaf is this rank's
    block.  Every entry point takes the global batch (every rank the
    same) and keeps this rank's rows: :meth:`forward` returns this rank's
    block of the logits (its rows, its vocab block), :meth:`loss` the
    global mean on every rank, :meth:`prefill` and :meth:`decode_step`
    the whole last-position logits on every rank; caches hold this rank's
    rows and KV heads.
    """

    def __init__(self, cfg: ModelConfig, *, sharder: Optional[Sharder] = None,
                 device="cuda"):
        check_supported(cfg)
        if any(spec.mlp == "moe" for spec in cfg.pattern):
            moe_lib.check_moe_mode(cfg, None if sharder is None
                                   else sharder.mesh)
        self.cfg = cfg
        self.sharder = sharder if sharder is not None else Sharder()
        self.device = torch.device(device)
        self._defs = model_defs(cfg)

    def defs(self):
        return model_defs(self.cfg)

    def _whole(self, params, name: str, rows: int):
        """``params[name]`` (a top-level leaf or subtree: the embedding,
        a final norm, the frontend projection) FSDP-gathered for a
        (micro)batch of ``rows`` rows, at its use."""
        return self.sharder.fsdp_gather(params[name], self._defs[name], rows)

    def specs(self):
        return param_specs(self.defs())

    def init(self, generator: torch.Generator):
        """Parameters drawn from ``generator`` as on one device, each leaf
        cut to this rank's block as soon as it is drawn."""
        local = self.sharder.local if self.sharder.mesh is not None else None
        return init_params(self.defs(), self.cfg.param_dtype, generator,
                           device=self.device, local=local)

    def _rows(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of a global batch input (``t`` itself when the
        batch is not split)."""
        if t is None or self.sharder.mesh is None:
            return t
        return self.sharder.local(t, ("batch",) + (None,) * (t.dim() - 1))

    def _scaled(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.tensor(self.cfg.d_model ** 0.5, dtype=self.cfg.dtype,
                                device=x.device)

    @staticmethod
    def _batch_input(batch, name: str) -> torch.Tensor:
        if name not in batch:
            raise ValidationError(f"the batch needs {name!r}")
        return batch[name]

    def _embed_inputs(self, params, batch) -> torch.Tensor:
        """(B, S, d) inputs of the decoder stack, scaled by √d_model: the
        token embeddings, after the projected ``prefix_embeds`` (B, P, d)
        for a ``vision`` frontend (S = P + tokens).  This rank's rows."""
        cfg = self.cfg
        rows = batch["tokens"].shape[0]
        x = embed_tokens(self._whole(params, "embed", rows),
                         self._rows(batch["tokens"]), cfg, self.sharder)
        if cfg.frontend == "vision":
            pe = self._rows(self._batch_input(batch, "prefix_embeds")) \
                .to(cfg.dtype)
            proj = self._whole(params, "frontend_proj", rows)
            x = torch.cat([pe @ proj.to(cfg.dtype), x], dim=1)
        return self._scaled(x)

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        return torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])

    def _encode(self, params, batch) -> torch.Tensor:
        """The encoder output (B, S_enc, d) of an encoder-decoder model:
        ``batch["frame_embeds"]`` (B, S_enc, d), projected by
        ``frontend_proj`` for an ``audio`` frontend (not scaled), through
        the encoder stack at rope positions 0..S_enc-1 and
        ``enc_final_norm``.  This rank's rows (what :meth:`decode_step`
        takes as ``enc_out``)."""
        cfg = self.cfg
        frames = self._batch_input(batch, "frame_embeds")
        rows = frames.shape[0]
        x = self._rows(frames).to(cfg.dtype)
        if cfg.frontend == "audio":
            x = x @ self._whole(params, "frontend_proj", rows).to(cfg.dtype)
        x, _, _ = _run_stack(cfg, self.sharder, cfg.encoder_pattern,
                             params["enc_blocks"], x, self._positions(x),
                             None, rows=rows)
        return rmsnorm(self._whole(params, "enc_final_norm", rows), x,
                       cfg.norm_eps)

    def _encoder_output(self, params, batch):
        return self._encode(params, batch) if self.cfg.is_encoder_decoder \
            else None

    def forward_with_aux(self, params, batch):
        """(logits (B, S, padded_vocab) float32, aux (2,) float32: the MoE
        [aux loss, z-loss] summed over the decoder's layers, zeros without
        MoE) of a batch: ``tokens`` (B, S_text); ``prefix_embeds`` for a
        vision frontend (S = P + S_text), ``frame_embeds`` for an
        encoder-decoder model; optional ``positions``, ``segments``.
        Under a mesh the logits are this rank's rows and vocab block."""
        cfg = self.cfg
        rows = batch["tokens"].shape[0]
        x = self._embed_inputs(params, batch)
        positions = self._rows(batch.get("positions"))
        if positions is None:
            positions = self._positions(x)
        enc_out = self._encoder_output(params, batch)
        x, _, aux = _run_stack(cfg, self.sharder, cfg.pattern,
                               params["blocks"], x, positions,
                               self._rows(batch.get("segments")),
                               enc_out=enc_out, rows=rows)
        return self._logits(params, x, rows), aux

    def _logits(self, params, x: torch.Tensor, rows: int) -> torch.Tensor:
        """The final norm and the unembedding of the decoder's output x
        (this rank's rows and vocab block)."""
        x = rmsnorm(self._whole(params, "final_norm", rows), x,
                    self.cfg.norm_eps)
        return unembed(self._whole(params, "embed", rows), x, self.cfg,
                       self.sharder)

    def forward(self, params, batch) -> torch.Tensor:
        """The logits of :meth:`forward_with_aux`."""
        return self.forward_with_aux(params, batch)[0]

    def loss(self, params, batch):
        """(total, {"ce", "moe_aux", "moe_z"}) of a batch with ``labels``
        (B, S), -1 where no loss is taken: the mean next-token cross
        entropy plus 0.01 x the MoE aux loss and 0.001 x its z-loss (0-d
        float32 tensors), as the JAX ``Model.loss``.  Under a mesh the
        mean is over every rank's tokens (vocab-parallel over the vocab's
        group, the NLL sum and the token count all-reduced over the
        batch's), the same on every rank."""
        logits, aux = self.forward_with_aux(params, batch)
        groups, lo, _ = vocab_shard(self.cfg, self.sharder)
        labels = self._batch_input(batch, "labels")
        ce = cross_entropy(
            logits, self._rows(labels), vocab_groups=groups, vocab_offset=lo,
            batch_groups=self.sharder.groups(
                self.sharder.split("batch", labels.shape[0]).axes))
        total = ce + 0.01 * aux[0] + 0.001 * aux[1]
        return total, {"ce": ce, "moe_aux": aux[0], "moe_z": aux[1]}

    def init_cache(self, batch: int, max_len: int):
        """Stacked per-block caches on the model's device for a global
        batch of ``batch`` rows: KV caches in the compute dtype for
        attention layers, a float32 ``MambaState`` for Mamba layers; under
        a mesh, this rank's rows, KV heads and Mamba heads
        (:meth:`cache_spec_axes`)."""
        return make_cache(self.cfg, batch, max_len, sharder=self.sharder,
                          device=self.device)

    def cache_spec_axes(self) -> Any:
        """Logical axes for every cache leaf (mirrors :meth:`init_cache`)."""
        def one(spec: LayerSpec):
            if spec.mixer.startswith("attn"):
                kv_axes = ("layers", "batch", "kv_heads", None, None)
                return KVCache(kv_axes, kv_axes, ("layers",))
            return MambaState(
                h=("layers", "batch", "mamba_heads", None, None),
                conv_x=("layers", "batch", None, "mamba_heads", None),
                conv_B=("layers", "batch", None, None),
                conv_C=("layers", "batch", None, None),
            )
        return {f"layer{i}": one(s) for i, s in enumerate(self.cfg.pattern)}

    def _whole_logits(self, logits: torch.Tensor, rows: int) -> torch.Tensor:
        """(B, 1, padded_vocab) on every rank from this rank's block."""
        if self.sharder.mesh is None:
            return logits
        return self.sharder.gather(logits, ("batch", None, "vocab"),
                                   (rows, logits.shape[1],
                                    self.cfg.padded_vocab))

    @torch.no_grad()
    def prefill(self, params, batch, cache):
        """Fill the caches from a prefix (in place: the vision prefix and
        the tokens; an encoder-decoder model encodes ``frame_embeds``
        inside, and its decode steps take :meth:`_encode`'s output);
        returns (cache, last-position logits (B, 1, padded_vocab), whole
        on every rank)."""
        cfg = self.cfg
        rows = batch["tokens"].shape[0]
        x = self._embed_inputs(params, batch)
        x, cache, _ = _run_stack(cfg, self.sharder, cfg.pattern,
                                 params["blocks"], x, self._positions(x),
                                 None, cache,
                                 self._encoder_output(params, batch), rows)
        return cache, self._whole_logits(
            self._logits(params, x[:, -1:], rows), rows)

    @torch.no_grad()
    def decode_step(self, params, token: torch.Tensor, cache, pos: int,
                    enc_out=None):
        """One decode step (cache updated in place).  token: (B, 1) int;
        pos: its position; ``enc_out``: :meth:`_encode`'s output, which an
        encoder-decoder model needs (its cross K/V are projected from it
        at every step).  Returns (cache, logits (B, 1, padded_vocab),
        whole on every rank)."""
        cfg = self.cfg
        if cfg.is_encoder_decoder and enc_out is None:
            raise ValidationError(f"{cfg.name}: an encoder-decoder decode "
                                  "step needs enc_out")
        rows = token.shape[0]
        token = self._rows(token)
        x = self._scaled(embed_tokens(self._whole(params, "embed", rows),
                                      token, cfg, self.sharder))
        positions = torch.full(token.shape, int(pos), dtype=torch.int64,
                               device=token.device)
        x, cache, _ = _run_stack(cfg, self.sharder, cfg.pattern,
                                 params["blocks"], x, positions, None, cache,
                                 enc_out, rows)
        return cache, self._whole_logits(self._logits(params, x, rows),
                                         rows)
