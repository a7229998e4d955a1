"""Zamba2-style hybrid: Mamba2 trunk + ONE shared attention block applied
every ``hybrid_attn_every`` Mamba layers.

Port of ``repro.models.zamba2``.  Layer layout for num_layers=81,
attn_every=6:
    [6×mamba, shared-attn] × 11 groups  +  4 trailing mamba layers
(81 "layers" counts each shared-attn application).  The shared block is a
full transformer block over ``concat(hidden, initial_embedding)`` (2·d
wide — Zamba2's global skip), whose output is projected 2d→d into the
residual.  Weights are shared across applications; each application keeps
its own KV cache.

:class:`Zamba2Model` is an ``nn.Module`` holding the reference's tree:
``embedding`` (also the tied head), ``grouped`` (mamba leaves (G, E, ...)),
``tail`` (leaves (max(tail, 1), ...): one unused layer when there is no
tail, as in the reference), ``shared`` and ``final_norm``.  The groups and
layers run in Python loops.  Over ranks (the dry run's partitioner) the
reference's constraint points stand (the embedding, the gelu, the
logits), and the shared block's two row-parallel products are reduced at
an ``embed`` constraint of the port's, as the mamba block's output is.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import FAMILY_HYBRID, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (cross_entropy, dtype_of, embed,
                                       lm_logits, normal_init, pdtype_of,
                                       prompt_end, rmsnorm, rmsnorm_init,
                                       rope_angles, token_positions)
from repro_torch.models.params import (TreeModel, check_stacked,
                                       draw_stacked, layer_list, params_tree,
                                       set_tree)
from repro_torch.sharding import remat_context, shard


class HybridDecodeState(NamedTuple):
    ssm_grouped: ssm_mod.SSMState    # leaves (G, E, B, ...) grouped mamba
    ssm_tail: ssm_mod.SSMState       # leaves (T, B, ...) trailing mamba
    attn_caches: attn.KVCache        # (G, B, S_max, kv, hd)
    pos: torch.Tensor                # (B,)


def _layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, per_group, n_tail_mamba)."""
    per = cfg.hybrid_attn_every
    groups = cfg.num_layers // (per + 1)
    tail = cfg.num_layers - groups * (per + 1)
    return groups, per, tail


def _stack_states(states: list) -> ssm_mod.SSMState:
    return ssm_mod.SSMState(torch.stack([s.conv for s in states]),
                            torch.stack([s.ssm for s in states]))


class Zamba2Model(TreeModel):
    """The hybrid family on ``device`` (default CUDA)."""

    stacked_axes = {"grouped": 2, "tail": 1}

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family != FAMILY_HYBRID:
            raise ValueError(f"Zamba2Model runs the hybrid family, not "
                             f"{cfg.family!r}")
        super().__init__(cfg, device)
        # the shared attention block sees 2*d_model-wide inputs
        self.attn_cfg = dataclasses.replace(cfg, d_model=2 * cfg.d_model)

    # -- init ---------------------------------------------------------------
    def _mamba_init(self, generator: torch.Generator) -> dict:
        cfg, pdt = self.cfg, pdtype_of(self.cfg)
        return {"norm": rmsnorm_init(cfg.d_model, pdt, self.device),
                "mamba": ssm_mod.mamba2_init(generator, cfg, pdt)}

    def init_tree(self, generator: Optional[torch.Generator] = None
                  ) -> dict:
        """The weights :meth:`init` draws, as the reference's tree."""
        generator = self.check_generator(generator)
        cfg, pdt = self.cfg, pdtype_of(self.cfg)
        groups, per, tail = _layout(cfg)
        d2 = 2 * cfg.d_model

        def mamba():
            return self._mamba_init(generator)
        grouped = draw_stacked(groups * per, mamba)
        grouped = {bn: {k: t.reshape((groups, per) + t.shape[1:])
                        for k, t in block.items()}
                   for bn, block in grouped.items()}
        return {
            "embedding": normal_init(
                generator, (cfg.vocab_size, cfg.d_model), 0.02, pdt),
            "grouped": grouped,
            "tail": draw_stacked(max(tail, 1), mamba),
            "shared": {
                "attn_norm": rmsnorm_init(d2, pdt, self.device),
                "attn": attn.attn_init(generator, self.attn_cfg, dtype=pdt),
                "ffn_norm": rmsnorm_init(d2, pdt, self.device),
                "fc1": normal_init(generator, (d2, cfg.d_ff), d2 ** -0.5,
                                   pdt),
                "fc2": normal_init(generator, (cfg.d_ff, d2),
                                   cfg.d_ff ** -0.5, pdt),
                "out_proj": normal_init(generator, (d2, cfg.d_model),
                                        d2 ** -0.5, pdt),
            },
            "final_norm": rmsnorm_init(cfg.d_model, pdt, self.device),
        }

    def set_params(self, tree: dict) -> "Zamba2Model":
        """Take the weights of a tree in the reference's layout, moved to
        the model's device; returns the module."""
        groups, per, tail = _layout(self.cfg)
        check_stacked(tree, self.stacked_axes,
                      {"grouped": (groups, per), "tail": (max(tail, 1),)})
        return set_tree(self, tree, self.device)

    # -- shared pieces -------------------------------------------------------
    def _parts(self, params):
        tree = params_tree(params)
        return (tree, layer_list(tree, "grouped", 2),
                layer_list(tree, "tail"))

    def _embed(self, tree, tokens: torch.Tensor) -> torch.Tensor:
        return embed(tree["embedding"], tokens, dtype_of(self.cfg))

    def _logits(self, tree, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(tree["final_norm"], x, self.cfg.norm_eps)
        return lm_logits(tree["embedding"].T, x)

    def _shared_block(self, sp, x, x0, rope, mode, cache, pos):
        """Shared transformer block over concat(hidden, embedding) -> d."""
        eps = self.cfg.norm_eps
        y = torch.cat([x, x0], dim=-1)                     # (B, S, 2d)
        h = rmsnorm(sp["attn_norm"], y, eps)
        a, new_cache = attn.attend(sp["attn"], h, self.attn_cfg, rope=rope,
                                   mode=mode, cache=cache, pos=pos)
        y = y + a
        h = rmsnorm(sp["ffn_norm"], y, eps)
        f = h @ sp["fc1"].to(h.dtype)
        # jax.nn.gelu defaults to the tanh approximation
        f = shard(F.gelu(f.float(), approximate="tanh").to(h.dtype),
                  "batch", "seq", "mlp")
        # the row-parallel products' partial sums reduced once, where the
        # mamba block's and attention's are (over ranks; the reference
        # leaves the two to its partitioner)
        y = y + shard(f @ sp["fc2"].to(h.dtype), "batch", "seq", "embed")
        out = shard(y @ sp["out_proj"].to(y.dtype), "batch", "seq", "embed")
        return x + out, new_cache

    def _mamba(self, lp, x, mode, state=None):
        h = rmsnorm(lp["norm"], x, self.cfg.norm_eps)
        if mode == "step":
            y, new_state = ssm_mod.mamba2_step(lp["mamba"], h, self.cfg,
                                               state)
        else:
            y, new_state = ssm_mod.mamba2_forward(
                lp["mamba"], h, self.cfg, return_state=(mode == "prefill"))
        return x + y, new_state

    def _group(self, gp, sp, x, x0, rope, mode, empty):
        """One group: its mamba layers, then the shared block."""
        states = []
        for lp in gp:
            x, st = self._mamba(lp, x, mode)
            states.append(st)
        x, cache = self._shared_block(sp, x, x0, rope, mode, empty, None)
        return x, states, cache

    def _train_group(self, gp, sp, x, x0, rope):
        return self._group(gp, sp, x, x0, rope, "train", None)[0]

    # -- full forward ---------------------------------------------------------
    def forward(self, params, tokens: torch.Tensor, remat: bool = True,
                collect_state: bool = False, s_max: int = 0):
        """Logits (B, S, V), and with ``collect_state`` (ssm_grouped,
        ssm_tail, caches) for decoding into ``s_max`` cache slots.
        ``remat`` keeps only each group's input for the backward pass (the
        reference's ``nothing_saveable`` checkpoint of a group); it changes
        no value."""
        tree, grouped, tail = self._parts(params)
        x, states = self._run(tree, grouped, tail, tokens, remat,
                              collect_state, s_max)
        logits = self._logits(tree, x)
        return (logits, states) if collect_state else logits

    def _run(self, tree, grouped, tail_layers, tokens, remat: bool,
             collect_state: bool, s_max: int):
        cfg = self.cfg
        _, _, tail = _layout(cfg)
        b, s = tokens.shape
        x = self._embed(tree, tokens)
        x0 = x
        rope = rope_angles(token_positions(tokens),
                           cfg.resolved_head_dim, cfg.rope_theta)
        mode = "prefill" if collect_state else "train"
        empty = (attn.init_cache(self.attn_cfg, b, s_max, cfg.num_kv_heads,
                                 dtype_of(cfg), device=x.device)
                 if collect_state else None)
        remat = remat and not collect_state and torch.is_grad_enabled()
        g_states, caches = [], []
        for gp in grouped:
            if remat:
                # the layers draw no random numbers: no RNG state to keep
                x = checkpoint(self._train_group, gp, tree["shared"], x, x0,
                               rope, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=remat_context)
                continue
            x, states, cache = self._group(gp, tree["shared"], x, x0, rope,
                                           mode, empty)
            if collect_state:
                g_states.append(_stack_states(states))
                caches.append(cache)
        t_states = []
        if tail > 0:
            for lp in tail_layers:
                x, st = self._mamba(lp, x, mode)
                t_states.append(st)
        if not collect_state:
            return x, None
        if tail > 0:
            ssm_tail = _stack_states(t_states)
        else:
            one = ssm_mod.init_ssm_state(cfg, b, dtype_of(cfg), x.device)
            ssm_tail = ssm_mod.SSMState(*(t[None] for t in one))
        return x, (_stack_states(g_states), ssm_tail,
                   attn.KVCache(torch.stack([c.k for c in caches]),
                                torch.stack([c.v for c in caches])))

    def loss(self, params, batch, remat: bool = True) -> torch.Tensor:
        """Mean masked next-token NLL of ``batch`` (``tokens``,
        ``targets``, ``mask``)."""
        logits = self.forward(params, batch["tokens"], remat=remat)
        return cross_entropy(logits, batch["targets"], batch["mask"])

    # -- serving -------------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor, s_max: int
                ) -> Tuple[torch.Tensor, HybridDecodeState]:
        """Run the prompt, fill the caches. Returns (last-token logits,
        state)."""
        tree, grouped, tail = self._parts(params)
        b, s = tokens.shape
        x, (ssm_g, ssm_t, caches) = self._run(tree, grouped, tail, tokens,
                                              False, True, s_max)
        return self._logits(tree, x[:, -1:]), HybridDecodeState(
            ssm_grouped=ssm_g, ssm_tail=ssm_t, attn_caches=caches,
            pos=prompt_end(b, s, x))

    def init_decode_state(self, batch: int, s_max: int) -> HybridDecodeState:
        cfg = self.cfg
        groups, per, tail = _layout(cfg)
        one = ssm_mod.init_ssm_state(cfg, batch, dtype_of(cfg), self.device)
        cache1 = attn.init_cache(self.attn_cfg, batch, s_max,
                                 cfg.num_kv_heads, dtype_of(cfg),
                                 device=self.device)
        return HybridDecodeState(
            ssm_grouped=ssm_mod.SSMState(*(t.new_zeros((groups, per)
                                                       + t.shape)
                                           for t in one)),
            ssm_tail=ssm_mod.SSMState(*(t.new_zeros((max(tail, 1),)
                                                    + t.shape)
                                        for t in one)),
            attn_caches=attn.KVCache(*(t.new_zeros((groups,) + t.shape)
                                       for t in cache1)),
            pos=torch.zeros((batch,), dtype=torch.int32, device=self.device))

    def decode_step(self, params, state: HybridDecodeState,
                    token: torch.Tensor, inplace: bool = False
                    ) -> Tuple[torch.Tensor, HybridDecodeState]:
        """One decode step. token (B, 1) -> (logits (B,1,V), state).  As
        the reference's, it leaves ``state`` as it was: the new states and
        this step's k/v go into new tensors.  ``inplace=True`` (for a
        caller that owns ``state`` and drops it, as ``ServeEngine`` does)
        writes them into ``state``'s tensors instead, and the returned
        state shares them."""
        cfg = self.cfg
        _, _, tail = _layout(cfg)
        tree, grouped, tail_layers = self._parts(params)
        x = self._embed(tree, token)
        x0 = x
        rope = rope_angles(state.pos[:, None].float(), cfg.resolved_head_dim,
                           cfg.rope_theta)
        g_conv, g_ssm = state.ssm_grouped
        t_conv, t_ssm = state.ssm_tail
        ck, cv = state.attn_caches
        if not inplace:
            g_conv, g_ssm = torch.empty_like(g_conv), torch.empty_like(g_ssm)
            ck, cv = ck.clone(), cv.clone()
            if tail > 0:
                t_conv, t_ssm = (torch.empty_like(t_conv),
                                 torch.empty_like(t_ssm))
        old_g = state.ssm_grouped
        for g, gp in enumerate(grouped):
            for e, lp in enumerate(gp):
                x, new = self._mamba(lp, x, "step", ssm_mod.SSMState(
                    old_g.conv[g, e], old_g.ssm[g, e]))
                g_conv[g, e] = new.conv
                g_ssm[g, e] = new.ssm
            x, _ = self._shared_block(tree["shared"], x, x0, rope, "decode",
                                      attn.KVCache(ck[g], cv[g]), state.pos)
        if tail > 0:
            old_t = state.ssm_tail
            for i, lp in enumerate(tail_layers):
                x, new = self._mamba(lp, x, "step", ssm_mod.SSMState(
                    old_t.conv[i], old_t.ssm[i]))
                t_conv[i] = new.conv
                t_ssm[i] = new.ssm
        return self._logits(tree, x), HybridDecodeState(
            ssm_grouped=ssm_mod.SSMState(g_conv, g_ssm),
            ssm_tail=ssm_mod.SSMState(t_conv, t_ssm),
            attn_caches=attn.KVCache(ck, cv), pos=state.pos + 1)
