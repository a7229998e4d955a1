"""Mamba2 decoder-only LM (mamba2-2.7b) — attention-free, O(T) context.

Port of ``repro.models.mamba_lm``.  :class:`MambaLM` is an ``nn.Module``
holding the reference's tree: ``embedding`` (V, d, also the tied head),
``layers`` (``norm`` and ``mamba`` leaves stacked on a leading ``layers``
axis) and ``final_norm``.  Its methods take ``params`` first, as
``CausalLM``'s do (the module, the reference's tree, or training's
per-layer views), and run the layers in a Python loop.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import FAMILY_SSM, ModelConfig
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (cross_entropy, dtype_of, embed,
                                       lm_logits, normal_init, pdtype_of,
                                       prompt_end, rmsnorm, rmsnorm_init)
from repro_torch.models.params import (TreeModel, check_stacked,
                                       draw_stacked, layer_list, params_tree,
                                       set_tree)
from repro_torch.sharding import remat_context


class SSMDecodeState(NamedTuple):
    states: ssm_mod.SSMState     # leaves stacked (L, B, ...)
    pos: torch.Tensor            # (B,) int32


class MambaLM(TreeModel):
    """The ssm family on ``device`` (default CUDA)."""

    stacked_axes = {"layers": 1}

    def __init__(self, cfg: ModelConfig, device=None):
        if cfg.family != FAMILY_SSM:
            raise ValueError(f"MambaLM runs the ssm family, not "
                             f"{cfg.family!r}")
        super().__init__(cfg, device)

    # -- init ---------------------------------------------------------------
    def _layer_init(self, generator: torch.Generator) -> dict:
        cfg, pdt = self.cfg, pdtype_of(self.cfg)
        return {"norm": rmsnorm_init(cfg.d_model, pdt, self.device),
                "mamba": ssm_mod.mamba2_init(generator, cfg, pdt)}

    def init_tree(self, generator: Optional[torch.Generator] = None
                  ) -> dict:
        """The weights :meth:`init` draws, as the reference's tree."""
        generator = self.check_generator(generator)
        cfg, pdt = self.cfg, pdtype_of(self.cfg)
        return {
            "embedding": normal_init(
                generator, (cfg.vocab_size, cfg.d_model), 0.02, pdt),
            "layers": draw_stacked(cfg.num_layers,
                                   lambda: self._layer_init(generator)),
            "final_norm": rmsnorm_init(cfg.d_model, pdt, self.device),
        }

    def set_params(self, tree: dict) -> "MambaLM":
        """Take the weights of a tree in the reference's layout, moved to
        the model's device; returns the module."""
        check_stacked(tree, self.stacked_axes,
                      {"layers": (self.cfg.num_layers,)})
        return set_tree(self, tree, self.device)

    # -- shared pieces -------------------------------------------------------
    def _parts(self, params):
        tree = params_tree(params)
        return tree, layer_list(tree, "layers")

    def _embed(self, tree, tokens: torch.Tensor) -> torch.Tensor:
        return embed(tree["embedding"], tokens, dtype_of(self.cfg))

    def _logits(self, tree, x: torch.Tensor) -> torch.Tensor:
        x = rmsnorm(tree["final_norm"], x, self.cfg.norm_eps)
        return lm_logits(tree["embedding"].T, x)

    def _layer(self, lp, x, return_state: bool):
        h = rmsnorm(lp["norm"], x, self.cfg.norm_eps)
        y, st = ssm_mod.mamba2_forward(lp["mamba"], h, self.cfg,
                                       return_state=return_state)
        return x + y, st

    def _train_layer(self, lp, x):
        return self._layer(lp, x, False)[0]

    # -- train / full forward ------------------------------------------------
    def forward(self, params, tokens: torch.Tensor, remat: bool = True,
                collect_state: bool = False):
        """Logits (B, S, V), and with ``collect_state`` the per-layer
        states stacked (L, B, ...).  ``remat`` keeps only each layer's
        input for the backward pass (the reference's ``nothing_saveable``
        checkpoint); it changes no value."""
        tree, layers = self._parts(params)
        x, states = self._run(tree, layers, tokens, remat, collect_state)
        logits = self._logits(tree, x)
        return (logits, states) if collect_state else logits

    def _run(self, tree, layers, tokens, remat: bool, collect_state: bool):
        x = self._embed(tree, tokens)
        remat = remat and not collect_state and torch.is_grad_enabled()
        convs, ssms = [], []
        for lp in layers:
            if remat:
                # the layers draw no random numbers: no RNG state to keep
                x = checkpoint(self._train_layer, lp, x, use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=remat_context)
            else:
                x, st = self._layer(lp, x, collect_state)
                if collect_state:
                    convs.append(st.conv)
                    ssms.append(st.ssm)
        states = (ssm_mod.SSMState(torch.stack(convs), torch.stack(ssms))
                  if collect_state else None)
        return x, states

    def loss(self, params, batch, remat: bool = True) -> torch.Tensor:
        """Mean masked next-token NLL of ``batch`` (``tokens``,
        ``targets``, ``mask``)."""
        logits = self.forward(params, batch["tokens"], remat=remat)
        return cross_entropy(logits, batch["targets"], batch["mask"])

    # -- serving -------------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor, s_max: int = 0
                ) -> Tuple[torch.Tensor, SSMDecodeState]:
        """Run the prompt. Returns (last-token logits, state); ``s_max``
        is unused (the state does not grow)."""
        tree, layers = self._parts(params)
        b, s = tokens.shape
        x, states = self._run(tree, layers, tokens, False, True)
        return self._logits(tree, x[:, -1:]), SSMDecodeState(
            states=states, pos=prompt_end(b, s, x))

    def init_decode_state(self, batch: int, s_max: int = 0
                          ) -> SSMDecodeState:
        cfg = self.cfg
        one = ssm_mod.init_ssm_state(cfg, batch, dtype_of(cfg), self.device)
        return SSMDecodeState(
            states=ssm_mod.SSMState(*(t.new_zeros((cfg.num_layers,)
                                                  + t.shape) for t in one)),
            pos=torch.zeros((batch,), dtype=torch.int32, device=self.device))

    def decode_step(self, params, state: SSMDecodeState, token: torch.Tensor,
                    inplace: bool = False
                    ) -> Tuple[torch.Tensor, SSMDecodeState]:
        """One decode step. token (B, 1) -> (logits (B,1,V), state).  As
        the reference's, it leaves ``state`` as it was: the new states go
        into new tensors.  ``inplace=True`` (for a caller that owns
        ``state`` and drops it, as ``ServeEngine`` does) writes them into
        ``state``'s tensors instead, and the returned state shares them."""
        tree, layers = self._parts(params)
        x = self._embed(tree, token)
        conv, ssm = state.states
        if not inplace:
            conv, ssm = torch.empty_like(conv), torch.empty_like(ssm)
        for i, lp in enumerate(layers):
            h = rmsnorm(lp["norm"], x, self.cfg.norm_eps)
            y, new = ssm_mod.mamba2_step(
                lp["mamba"], h, self.cfg,
                ssm_mod.SSMState(state.states.conv[i], state.states.ssm[i]))
            conv[i] = new.conv
            ssm[i] = new.ssm
            x = x + y
        return self._logits(tree, x), SSMDecodeState(
            states=ssm_mod.SSMState(conv, ssm), pos=state.pos + 1)

