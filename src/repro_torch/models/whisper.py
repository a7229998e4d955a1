"""Whisper-style encoder-decoder backbone (whisper-large-v3).

Port of ``repro.models.whisper``.  The conv/mel frontend is a stub, as in
the reference: callers give precomputed frame embeddings (B, enc_ctx,
d_model).  Encoder: bidirectional self-attention + GELU MLP, sinusoidal
positions.  Decoder: causal self-attention + cross-attention + GELU MLP,
learned positions, the output tied to the embedding.  Serving projects the
per-layer cross-attention K/V from the encoder output once, at prefill.

:class:`WhisperModel` is an ``nn.Module`` holding the reference's tree:
``embedding`` (V, d), ``pos_embedding`` (max_seq_len, d), ``enc_layers``
and ``dec_layers`` (each leaf stacked on a leading layer axis),
``enc_norm`` and ``dec_norm``.  Its methods take ``params`` first, as
``CausalLM``'s do (the module, the reference's tree, or training's
per-layer views), and run the layers in a Python loop.  Over ranks (the
dry run's partitioner) the reference's constraint points stand at the
encoder's and the decoder's inputs and at the logits; 20 heads do not
split 16 ways, so each model rank attends every head of its rows.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import FAMILY_ENCDEC, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (cross_entropy, dtype_of, embed,
                                       layernorm, layernorm_init, lm_logits,
                                       normal_init, pdtype_of, prompt_end,
                                       sinusoidal_positions)
from repro_torch.models.params import (TreeModel, check_stacked,
                                       draw_stacked, layer_list, params_tree,
                                       set_tree)
from repro_torch.sharding import (remat_context, replicated, shard, unshard,
                                  whole)


class WhisperDecodeState(NamedTuple):
    self_caches: attn.KVCache   # (L, B, S_max, kv, hd)
    cross_k: torch.Tensor       # (L, B, enc_ctx, kv, hd)
    cross_v: torch.Tensor
    pos: torch.Tensor           # (B,) int32


class WhisperModel(TreeModel):
    """The encdec family on ``device`` (default CUDA)."""

    stacked_axes = {"enc_layers": 1, "dec_layers": 1}

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family != FAMILY_ENCDEC:
            raise ValueError(f"WhisperModel runs the encdec family, not "
                             f"{cfg.family!r}")
        super().__init__(cfg, device)

    # -- init ---------------------------------------------------------------
    def _enc_layer_init(self, generator: torch.Generator) -> dict:
        cfg, pdt, dev = self.cfg, pdtype_of(self.cfg), self.device
        return {
            "attn_norm": layernorm_init(cfg.d_model, pdt, dev),
            "attn": attn.attn_init(generator, cfg, dtype=pdt),
            "ffn_norm": layernorm_init(cfg.d_model, pdt, dev),
            "mlp": mlp_mod.gelu_mlp_init(generator, cfg, dtype=pdt),
        }

    def _dec_layer_init(self, generator: torch.Generator) -> dict:
        cfg, pdt, dev = self.cfg, pdtype_of(self.cfg), self.device
        return {
            "attn_norm": layernorm_init(cfg.d_model, pdt, dev),
            "attn": attn.attn_init(generator, cfg, dtype=pdt),
            "cross_norm": layernorm_init(cfg.d_model, pdt, dev),
            "cross": attn.attn_init(generator, cfg, dtype=pdt),
            "ffn_norm": layernorm_init(cfg.d_model, pdt, dev),
            "mlp": mlp_mod.gelu_mlp_init(generator, cfg, dtype=pdt),
        }

    def init_tree(self, generator: Optional[torch.Generator] = None
                  ) -> dict:
        """The weights :meth:`init` draws, as the reference's tree."""
        generator = self.check_generator(generator)
        cfg, pdt = self.cfg, pdtype_of(self.cfg)
        return {
            "embedding": normal_init(
                generator, (cfg.vocab_size, cfg.d_model), 0.02, pdt),
            "pos_embedding": normal_init(
                generator, (cfg.max_seq_len, cfg.d_model), 0.01, pdt),
            "enc_layers": draw_stacked(
                cfg.encoder_layers, lambda: self._enc_layer_init(generator)),
            "dec_layers": draw_stacked(
                cfg.num_layers, lambda: self._dec_layer_init(generator)),
            "enc_norm": layernorm_init(cfg.d_model, pdt, self.device),
            "dec_norm": layernorm_init(cfg.d_model, pdt, self.device),
        }

    def set_params(self, tree: dict) -> "WhisperModel":
        """Take the weights of a tree in the reference's layout, moved to
        the model's device; returns the module."""
        check_stacked(tree, self.stacked_axes,
                      {"enc_layers": (self.cfg.encoder_layers,),
                       "dec_layers": (self.cfg.num_layers,)})
        return set_tree(self, tree, self.device)

    # -- shared pieces -------------------------------------------------------
    def _parts(self, params):
        tree = params_tree(params)
        return (tree, layer_list(tree, "enc_layers"),
                layer_list(tree, "dec_layers"))

    def _embed(self, tree, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings plus the learned positions 0..S-1 (over ranks
        the slice of the FSDP-split table gathered over ``data``)."""
        x = embed(tree["embedding"], tokens, dtype_of(self.cfg))
        pe = unshard(tree["pos_embedding"][:tokens.shape[1]], "pod", "data")
        return shard(x + pe.to(x.dtype)[None], "batch", "seq", "embed")

    def _logits(self, tree, x: torch.Tensor) -> torch.Tensor:
        x = layernorm(tree["dec_norm"], x, self.cfg.norm_eps)
        return lm_logits(tree["embedding"].T, x)

    # -- encoder --------------------------------------------------------------
    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames: (B, enc_ctx, d_model) stub embeddings -> encoder states."""
        tree, enc_layers, _ = self._parts(params)
        return self._encode(tree, enc_layers, frames)

    def _encode(self, tree, enc_layers, frames):
        cfg = self.cfg
        x = frames.to(dtype_of(cfg))
        pos = sinusoidal_positions(x.shape[1], cfg.d_model, x.device)
        x = shard(x + replicated(pos.to(x.dtype), x)[None], "batch",
                  "frames", "embed")
        for lp in enc_layers:
            h = layernorm(lp["attn_norm"], x, cfg.norm_eps)
            a, _ = attn.attend(lp["attn"], h, cfg, rope=None, mode="train",
                               causal=False)
            x = x + a
            h = layernorm(lp["ffn_norm"], x, cfg.norm_eps)
            x = x + mlp_mod.gelu_mlp(lp["mlp"], h)
        return layernorm(tree["enc_norm"], x, cfg.norm_eps)

    # -- decoder --------------------------------------------------------------
    def _dec_layer(self, lp, x, enc, mode, cache, pos):
        cfg = self.cfg
        h = layernorm(lp["attn_norm"], x, cfg.norm_eps)
        a, new_cache = attn.attend(lp["attn"], h, cfg, rope=None, mode=mode,
                                   cache=cache, pos=pos)
        x = x + a
        h = layernorm(lp["cross_norm"], x, cfg.norm_eps)
        c, _ = attn.attend(lp["cross"], h, cfg, rope=None, kv_x=enc)
        x = x + c
        h = layernorm(lp["ffn_norm"], x, cfg.norm_eps)
        return x + mlp_mod.gelu_mlp(lp["mlp"], h), new_cache

    def _train_layer(self, lp, x, enc):
        return self._dec_layer(lp, x, enc, "train", None, None)[0]

    def forward(self, params, frames: torch.Tensor, tokens: torch.Tensor,
                remat: bool = True) -> torch.Tensor:
        """Teacher-forced decoder logits (B, S, V).  ``remat`` (the
        reference's ``nothing_saveable`` checkpoint of each decoder layer;
        the encoder keeps its activations, as there) keeps only each
        decoder layer's inputs for the backward pass; it changes no
        value."""
        tree, enc_layers, dec_layers = self._parts(params)
        enc = self._encode(tree, enc_layers, frames)
        x = self._embed(tree, tokens)
        remat = remat and torch.is_grad_enabled()
        for lp in dec_layers:
            if remat:
                # the layers draw no random numbers: no RNG state to keep
                x = checkpoint(self._train_layer, lp, x, enc,
                               use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=remat_context)
            else:
                x = self._train_layer(lp, x, enc)
        return self._logits(tree, x)

    def loss(self, params, batch, remat: bool = True) -> torch.Tensor:
        """Mean masked next-token NLL of ``batch`` (``frames``,
        ``tokens``, ``targets``, ``mask``)."""
        logits = self.forward(params, batch["frames"], batch["tokens"],
                              remat=remat)
        return cross_entropy(logits, batch["targets"], batch["mask"])

    # -- serving ---------------------------------------------------------------
    def prefill(self, params, frames: torch.Tensor, tokens: torch.Tensor,
                s_max: int) -> Tuple[torch.Tensor, WhisperDecodeState]:
        """Encode ``frames``, run the prompt, fill the self caches and
        project each layer's cross K/V.  Returns (last-token logits
        (B, 1, V), state)."""
        cfg = self.cfg
        dt = dtype_of(cfg)
        tree, enc_layers, dec_layers = self._parts(params)
        enc = self._encode(tree, enc_layers, frames)
        b, s = tokens.shape
        x = self._embed(tree, tokens)
        empty = attn.init_cache(cfg, b, s_max, cfg.num_kv_heads, dt,
                                device=x.device)
        ks, vs, cks, cvs = [], [], [], []
        for lp in dec_layers:
            x, cache = self._dec_layer(lp, x, enc, "prefill", empty, None)
            ks.append(cache.k)
            vs.append(cache.v)
            # cross-attention K/V precomputed once per layer
            _, ck, cv = attn._proj_qkv(lp["cross"], enc, cfg)
            cks.append(ck.to(dt))
            cvs.append(cv.to(dt))
        logits = self._logits(tree, x[:, -1:])
        return logits, WhisperDecodeState(
            self_caches=attn.KVCache(k=torch.stack(ks), v=torch.stack(vs)),
            cross_k=torch.stack(cks), cross_v=torch.stack(cvs),
            pos=prompt_end(b, s, x))

    def init_decode_state(self, batch: int, s_max: int) -> WhisperDecodeState:
        cfg = self.cfg
        h = cfg.resolved_head_dim
        z = dict(dtype=dtype_of(cfg), device=self.device)
        shape = (cfg.num_layers, batch, s_max, cfg.num_kv_heads, h)
        cross = (cfg.num_layers, batch, cfg.encoder_ctx, cfg.num_kv_heads, h)
        return WhisperDecodeState(
            self_caches=attn.KVCache(k=torch.zeros(shape, **z),
                                     v=torch.zeros(shape, **z)),
            cross_k=torch.zeros(cross, **z), cross_v=torch.zeros(cross, **z),
            pos=torch.zeros((batch,), dtype=torch.int32, device=self.device))

    def decode_step(self, params, state: WhisperDecodeState,
                    token: torch.Tensor, inplace: bool = False
                    ) -> Tuple[torch.Tensor, WhisperDecodeState]:
        """One decode step. token (B, 1) -> (logits (B,1,V), state).  Every
        row takes the learned position of row 0's ``pos``, as in the
        reference.  As the reference's, it leaves ``state`` as it was: the
        step's k/v go into copies of the self caches, so several steps may
        branch from one state.  ``inplace=True`` (for a caller that owns
        ``state`` and drops it) writes them into ``state``'s caches
        instead, and the returned state shares them."""
        cfg = self.cfg
        tree, _, dec_layers = self._parts(params)
        x = embed(tree["embedding"], token, dtype_of(cfg))
        pe = tree["pos_embedding"]
        # row 0's position on the device (no host sync), clamped as the
        # reference's gather clamps an index past the table; over ranks
        # the positions are gathered and the row read on every rank
        row0 = whole(state.pos)[:1].long().clamp(max=pe.shape[0] - 1)
        row = unshard(torch.index_select(pe, 0, replicated(row0, pe)), "pod",
                      "data")
        x = shard(x + row.to(x.dtype)[None], "batch", "seq", "embed")
        ck, cv = state.self_caches
        if not inplace:
            ck, cv = ck.clone(), cv.clone()
        mask = torch.ones((1, 1, 1, state.cross_k.shape[2]),
                          dtype=torch.bool, device=x.device)
        for i, lp in enumerate(dec_layers):
            h = layernorm(lp["attn_norm"], x, cfg.norm_eps)
            a, _ = attn.attend(lp["attn"], h, cfg, rope=None, mode="decode",
                               cache=attn.KVCache(ck[i], cv[i]),
                               pos=state.pos)
            x = x + a
            h = layernorm(lp["cross_norm"], x, cfg.norm_eps)
            q, _, _ = attn._proj_qkv(lp["cross"], h, cfg)
            c = attn._sdpa(q, state.cross_k[i], state.cross_v[i], mask, cfg)
            x = x + attn._wo(lp["cross"], c, cfg)
            h = layernorm(lp["ffn_norm"], x, cfg.norm_eps)
            x = x + mlp_mod.gelu_mlp(lp["mlp"], h)
        return self._logits(tree, x), state._replace(
            self_caches=attn.KVCache(ck, cv), pos=state.pos + 1)
