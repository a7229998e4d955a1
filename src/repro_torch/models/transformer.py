"""Decoder-only transformer: dense GQA (llama/yi/qwen/mistral) and the
M-RoPE VLM backbone (qwen2-vl).

Port of ``repro.models.transformer``.  :class:`CausalLM` is an
``nn.Module`` that holds its weights: ``embedding`` (V, d), ``layers`` (one
``nn.ModuleDict`` of ``nn.ParameterDict`` blocks per layer, where the
reference stacks a leading ``layers`` axis and scans it), ``final_norm``
and, untied, ``lm_head`` (d, V).  Weights keep the reference's (in, out)
orientation, so every projection is ``x @ W``.  The methods keep the
reference's signatures: each takes ``params`` first, the module whose
weights it reads — what :meth:`CausalLM.init` returns (the model itself),
or a module from :func:`repro_torch.models.convert.params_from_jax`.  The
layer loop is a Python loop (``maybe_scan`` with ``scan_layers=False``).
Weights are stored in ``param_dtype`` and cast to the compute dtype at each
use, as the reference casts them inside its jit.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import nn

from repro_torch.config import (FAMILY_DENSE, FAMILY_MOE, FAMILY_VLM,
                                ModelConfig)
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (dtype_of, mrope_angles, normal_init,
                                       pdtype_of, rmsnorm, rmsnorm_init,
                                       rope_angles)


class DecodeState(NamedTuple):
    caches: attn.KVCache       # stacked (L, B, S, kv, hd)
    pos: torch.Tensor          # (B,) int32 next position to write


def _frozen(t: torch.Tensor) -> nn.Parameter:
    # serving needs no gradients; the training slice turns them on
    return nn.Parameter(t, requires_grad=False)


def _param_dict(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in d.items()})


class CausalLM(nn.Module):
    """A dense or VLM decoder on ``device`` (default CUDA).  Construction
    allocates no weights: :meth:`init` draws them, or
    ``models.convert.params_from_jax`` loads the reference's."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family == FAMILY_MOE:
            raise NotImplementedError(
                "the moe family (models/moe.py, moe_a2a.py) is not ported "
                "yet: ROADMAP.md §1 item 6")
        if cfg.family not in (FAMILY_DENSE, FAMILY_VLM):
            raise ValueError(f"CausalLM runs the dense and vlm families, "
                             f"not {cfg.family!r}")
        self.cfg = cfg
        self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        """Where the weights are (after ``init``, ``set_params`` or
        ``.to``), else where the constructor put the model."""
        if "embedding" in self._parameters:
            return self.embedding.device
        return self._device

    # -- init ---------------------------------------------------------------
    def _layer_init(self, generator: torch.Generator) -> dict:
        cfg = self.cfg
        pdt = pdtype_of(cfg)
        return {
            "attn_norm": rmsnorm_init(cfg.d_model, pdt, self.device),
            "attn": attn.attn_init(generator, cfg, dtype=pdt),
            "ffn_norm": rmsnorm_init(cfg.d_model, pdt, self.device),
            "mlp": mlp_mod.swiglu_init(generator, cfg, pdt),
        }

    def init(self, generator: torch.Generator) -> "CausalLM":
        """Draw every weight from ``generator`` (which must live on the
        model's device) and return the module: the ``params`` of the
        other methods."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        cfg = self.cfg
        pdt = pdtype_of(cfg)
        tree = {"embedding": normal_init(
            generator, (cfg.vocab_size, cfg.d_model), 0.02, pdt)}
        tree["layers"] = [self._layer_init(generator)
                          for _ in range(cfg.num_layers)]
        tree["final_norm"] = rmsnorm_init(cfg.d_model, pdt, self.device)
        if not cfg.tie_embeddings:
            tree["lm_head"] = normal_init(
                generator, (cfg.d_model, cfg.vocab_size),
                cfg.d_model ** -0.5, pdt)
        return self.set_params(tree)

    def set_params(self, tree: dict) -> "CausalLM":
        """Take the weights of a nested dict in :meth:`init`'s layout
        (``layers`` a list of per-layer dicts), moved to the model's
        device; returns the module."""
        def dev(t):
            return t.to(self.device)
        self.embedding = _frozen(dev(tree["embedding"]))
        self.layers = nn.ModuleList(
            nn.ModuleDict({name: _param_dict({k: dev(v) for k, v in
                                              block.items()})
                           for name, block in lp.items()})
            for lp in tree["layers"])
        self.final_norm = _param_dict({k: dev(v) for k, v in
                                       tree["final_norm"].items()})
        if not self.cfg.tie_embeddings:
            self.lm_head = _frozen(dev(tree["lm_head"]))
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
        return params.embedding[tokens.long()].to(dtype_of(self.cfg))

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        head = (params.embedding.T if self.cfg.tie_embeddings
                else params.lm_head)
        return x @ head.to(x.dtype)

    def _layer_apply(self, p, x, rope, mode, cache, pos):
        cfg = self.cfg
        h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        a, new_cache = attn.attend(p["attn"], h, cfg, rope=rope, mode=mode,
                                   cache=cache, pos=pos)
        x = x + a
        h = rmsnorm(p["ffn_norm"], x, cfg.norm_eps)
        f = mlp_mod.swiglu(p["mlp"], h)
        return x + f, new_cache, torch.zeros((), dtype=torch.float32,
                                             device=x.device)

    @staticmethod
    def _positions(tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        return torch.arange(s, device=tokens.device)[None].expand(b, s)

    # -- full forward --------------------------------------------------------
    def forward(self, params, tokens: torch.Tensor, positions=None,
                remat: bool = True, inputs_embeds=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full causal forward.  Returns (logits (B,S,V), aux_loss ()).
        ``remat`` is the reference's rematerialisation switch: it changes
        no value, and only a backward pass (the training slice) would use
        it."""
        del remat
        x = inputs_embeds if inputs_embeds is not None else self._embed(
            params, tokens)
        if positions is None:
            positions = self._positions(tokens)
        rope = self._rope(positions)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in params.layers:
            x, _, a = self._layer_apply(lp, x, rope, "train", None, None)
            aux = aux + a
        x = rmsnorm(params.final_norm, x, self.cfg.norm_eps)
        return self._logits(params, x), aux

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
        b, s = tokens.shape
        x = inputs_embeds if inputs_embeds is not None else self._embed(
            params, tokens)
        if positions is None:
            positions = self._positions(tokens)
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
            pos=torch.full((b,), s, dtype=torch.int32, device=x.device))

    def decode_step(self, params, state: DecodeState, token: torch.Tensor
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """One decode step. token (B, 1) -> (logits (B,1,V), state).  The
        step's k/v are written into ``state``'s caches in place; the
        returned state shares them, with ``pos + 1``."""
        x = self._embed(params, token)
        rope = self._rope(state.pos[:, None])
        ck, cv = state.caches
        for i, lp in enumerate(params.layers):
            x, _, _ = self._layer_apply(lp, x, rope, "decode",
                                        attn.KVCache(ck[i], cv[i]),
                                        state.pos)
        x = rmsnorm(params.final_norm, x, self.cfg.norm_eps)
        logits = self._logits(params, x)
        return logits, DecodeState(caches=state.caches, pos=state.pos + 1)
