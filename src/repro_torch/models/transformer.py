"""Decoder-only transformer: dense GQA (llama/yi/qwen/mistral), MoE
(qwen3-moe/grok-1) and the M-RoPE VLM backbone (qwen2-vl).

Port of ``repro.models.transformer``.  :class:`CausalLM` is an
``nn.Module`` that holds its weights in the reference's layout:
``embedding`` (V, d), ``layers`` (one ``nn.ParameterDict`` a block, each
weight stacked on a leading ``layers`` axis: ``layers.attn.wq`` is
(L, d, H·hd)), ``final_norm`` and, untied, ``lm_head`` (d, V).  Weights
keep the reference's (in, out) orientation, so every projection is
``x @ W``.  The methods keep the reference's signatures: each takes
``params`` first, the weights it reads — what :meth:`CausalLM.init`
returns (the model itself), a module from
:func:`repro_torch.models.convert.params_from_jax`, or the reference's
tree of tensors (``models.params.params_tree``, what training
updates).  Each call unbinds the stacked weights once into per-layer
views (:func:`as_layers`) and runs the layers in a Python loop (``maybe_scan``
with ``scan_layers=False``).  Weights are stored in ``param_dtype`` and
cast to the compute dtype at each use, as the reference casts them inside
its jit.  A moe layer's FFN is ``models.moe.moe_ffn``, or
``models.moe_a2a.moe_ffn_whole`` over the active mesh's positions (lanes
of one device, or ranks) under ``moe_a2a.set_moe_impl("a2a")``, as in
the reference; its aux loss is the layer's.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import (FAMILY_DENSE, FAMILY_MOE, FAMILY_VLM,
                                ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import moe_a2a
from repro_torch.models.common import (cross_entropy, dtype_of, embed,
                                       lm_logits, mrope_angles, normal_init,
                                       pdtype_of, prompt_end, rmsnorm,
                                       rmsnorm_init, rope_angles,
                                       token_positions)
from repro_torch.models.params import (TreeModel, check_stacked,
                                       draw_stacked, frozen, layer_list,
                                       params_tree)
from repro_torch.sharding import remat_context


class DecodeState(NamedTuple):
    caches: attn.KVCache       # stacked (L, B, S, kv, hd)
    pos: torch.Tensor          # (B,) int32 next position to write


def _param_dict(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: frozen(v) for k, v in d.items()})


class LayerParams(NamedTuple):
    """What the methods read of ``params``: the embedding, one mapping of
    tensors per layer, the final norm and the untied head (or None)."""
    embedding: torch.Tensor
    layers: list
    final_norm: Mapping
    lm_head: Optional[torch.Tensor]


def as_layers(params) -> LayerParams:
    """``params`` (a module, the reference's tree, or a tree whose
    ``layers`` are already a list of per-layer trees, as training's
    gradient views are) as the methods read it: the stacked weights
    unbound once into per-layer views.  A :class:`LayerParams` comes back
    as it is."""
    if isinstance(params, LayerParams):
        return params
    tree = params_tree(params)
    return LayerParams(tree["embedding"], layer_list(tree, "layers"),
                       tree["final_norm"], tree.get("lm_head"))


class CausalLM(TreeModel):
    """A dense, MoE or VLM decoder on ``device`` (default CUDA)."""

    stacked_axes = {"layers": 1}

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family not in (FAMILY_DENSE, FAMILY_MOE, FAMILY_VLM):
            raise ValueError(f"CausalLM runs the dense, moe and vlm "
                             f"families, not {cfg.family!r}")
        super().__init__(cfg, device)

    # -- init ---------------------------------------------------------------
    def _layer_init(self, generator: torch.Generator) -> dict:
        cfg = self.cfg
        pdt = pdtype_of(cfg)
        p = {
            "attn_norm": rmsnorm_init(cfg.d_model, pdt, self.device),
            "attn": attn.attn_init(generator, cfg, dtype=pdt),
            "ffn_norm": rmsnorm_init(cfg.d_model, pdt, self.device),
        }
        if cfg.family == FAMILY_MOE:
            p["moe"] = moe_mod.moe_init(generator, cfg, pdt)
        else:
            p["mlp"] = mlp_mod.swiglu_init(generator, cfg, pdt)
        return p

    def init_tree(self, generator: Optional[torch.Generator] = None
                  ) -> dict:
        """The weights :meth:`init` draws, as the reference's tree
        (:func:`params_tree`'s layout) that no module holds.  Layer ``i``
        is drawn whole before layer ``i + 1`` and written into its row of
        the stacked leaves."""
        generator = self.check_generator(generator)
        cfg = self.cfg
        pdt = pdtype_of(cfg)
        tree = {"embedding": normal_init(
            generator, (cfg.vocab_size, cfg.d_model), 0.02, pdt)}
        tree["layers"] = draw_stacked(cfg.num_layers,
                                      lambda: self._layer_init(generator))
        tree["final_norm"] = rmsnorm_init(cfg.d_model, pdt, self.device)
        if not cfg.tie_embeddings:
            tree["lm_head"] = normal_init(
                generator, (cfg.d_model, cfg.vocab_size),
                cfg.d_model ** -0.5, pdt)
        return tree

    def set_params(self, tree: dict) -> "CausalLM":
        """Take the weights of a tree in the reference's layout (per-layer
        leaves stacked on a leading ``layers`` axis), moved to the model's
        device; returns the module."""
        check_stacked(tree, self.stacked_axes,
                      {"layers": (self.cfg.num_layers,)})

        def dev(t):
            return t.to(self.device)
        self.embedding = frozen(dev(tree["embedding"]))
        self.layers = nn.ModuleDict({
            bn: _param_dict({k: dev(v) for k, v in block.items()})
            for bn, block in tree["layers"].items()})
        self.final_norm = _param_dict({k: dev(v) for k, v in
                                       tree["final_norm"].items()})
        if not self.cfg.tie_embeddings:
            self.lm_head = frozen(dev(tree["lm_head"]))
        return self

    # -- shared pieces -------------------------------------------------------
    def _rope(self, positions: torch.Tensor):
        cfg = self.cfg
        if cfg.mrope:
            if positions.dim() == 2:         # (B,S) -> same stream 3x
                positions = positions[None].expand(3, *positions.shape)
            return mrope_angles(positions, cfg.resolved_head_dim,
                                cfg.rope_theta, cfg.mrope_sections)
        return rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return embed(params.embedding, tokens, dtype_of(self.cfg))

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        return lm_logits(params.embedding.T if self.cfg.tie_embeddings
                         else params.lm_head, x)

    def _layer_apply(self, p, x, rope, mode, cache, pos):
        cfg = self.cfg
        h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        a, new_cache = attn.attend(p["attn"], h, cfg, rope=rope, mode=mode,
                                   cache=cache, pos=pos)
        x = x + a
        h = rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
        if cfg.family == FAMILY_MOE:
            if moe_a2a.moe_impl() == "a2a":
                f, aux = moe_a2a.moe_ffn_whole(p["moe"], h, cfg)
            else:
                f, aux = moe_mod.moe_ffn(p["moe"], h, cfg)
        else:
            f = mlp_mod.swiglu(p["mlp"], h)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + f, new_cache, aux

    def _train_layer(self, lp, x, rope):
        x, _, aux = self._layer_apply(lp, x, rope, "train", None, None)
        return x, aux

    # -- train / full forward ------------------------------------------------
    def forward(self, params, tokens: torch.Tensor, positions=None,
                remat: bool = True, inputs_embeds=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full causal forward.  Returns (logits (B,S,V), aux_loss ()).
        ``remat`` (the reference's ``nothing_saveable`` checkpoint of each
        layer) keeps only each layer's input for the backward pass and
        runs the layer again there; it changes no value, and without
        gradients it does nothing."""
        params = as_layers(params)
        x = inputs_embeds if inputs_embeds is not None else self._embed(
            params, tokens)
        if positions is None:
            positions = token_positions(tokens)
        rope = self._rope(positions)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = remat and torch.is_grad_enabled()
        for lp in params.layers:
            if remat:
                # the layers draw no random numbers: no RNG state to keep
                x, a = checkpoint(self._train_layer, lp, x, rope,
                                  use_reentrant=False,
                                  preserve_rng_state=False,
                                  context_fn=remat_context)
            else:
                x, a = self._train_layer(lp, x, rope)
            aux = aux + a
        x = rmsnorm(params.final_norm, x, self.cfg.norm_eps)
        return self._logits(params, x), aux

    def loss(self, params, batch, remat: bool = True) -> torch.Tensor:
        """Mean masked next-token NLL of ``batch`` (``tokens``, ``targets``,
        ``mask``; optional ``positions``, ``inputs_embeds``) plus the aux
        loss."""
        logits, aux = self.forward(params, batch["tokens"],
                                   positions=batch.get("positions"),
                                   remat=remat,
                                   inputs_embeds=batch.get("inputs_embeds"))
        return cross_entropy(logits, batch["targets"], batch["mask"]) + aux

    # -- serving -------------------------------------------------------------
    def init_decode_state(self, batch: int, s_max: int) -> DecodeState:
        cfg = self.cfg
        shape = (cfg.num_layers, batch, s_max, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        z = dict(dtype=dtype_of(cfg), device=self.device)
        return DecodeState(
            caches=attn.KVCache(k=torch.zeros(shape, **z),
                                v=torch.zeros(shape, **z)),
            pos=torch.zeros((batch,), dtype=torch.int32, device=self.device))

    def prefill(self, params, tokens: torch.Tensor, s_max: int,
                positions=None, inputs_embeds=None
                ) -> Tuple[torch.Tensor, DecodeState]:
        """Run the prompt, fill caches. Returns (last-token logits, state)."""
        cfg = self.cfg
        params = as_layers(params)
        b, s = tokens.shape
        x = inputs_embeds if inputs_embeds is not None else self._embed(
            params, tokens)
        if positions is None:
            positions = token_positions(tokens)
        rope = self._rope(positions)
        empty = attn.init_cache(cfg, b, s_max, cfg.num_kv_heads,
                                dtype_of(cfg), device=x.device)
        ks, vs = [], []
        for lp in params.layers:
            x, cache, _ = self._layer_apply(lp, x, rope, "prefill", empty,
                                            None)
            ks.append(cache.k)
            vs.append(cache.v)
        x = rmsnorm(params.final_norm, x, cfg.norm_eps)
        logits = self._logits(params, x[:, -1:, :])
        return logits, DecodeState(
            caches=attn.KVCache(k=torch.stack(ks), v=torch.stack(vs)),
            pos=prompt_end(b, s, x))

    def decode_step(self, params, state: DecodeState, token: torch.Tensor,
                    inplace: bool = False
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """One decode step. token (B, 1) -> (logits (B,1,V), state).  As
        the reference's, it leaves ``state`` as it was: the step's k/v go
        into copies of the caches, so several steps may branch from one
        state.  ``inplace=True`` (for a caller that owns ``state`` and
        drops it, as ``ServeEngine`` does) writes them into ``state``'s
        caches instead, and the returned state shares them."""
        params = as_layers(params)
        x = self._embed(params, token)
        rope = self._rope(state.pos[:, None])
        ck, cv = state.caches
        if not inplace:
            ck, cv = ck.clone(), cv.clone()
        for i, lp in enumerate(params.layers):
            x, _, _ = self._layer_apply(lp, x, rope, "decode",
                                        attn.KVCache(ck[i], cv[i]),
                                        state.pos)
        x = rmsnorm(params.final_norm, x, self.cfg.norm_eps)
        logits = self._logits(params, x)
        return logits, DecodeState(caches=attn.KVCache(ck, cv),
                                   pos=state.pos + 1)
