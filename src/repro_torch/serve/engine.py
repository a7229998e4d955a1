"""Minimal batched serving engine: prefill + greedy/sampled decode.

Port of ``repro.serve.engine``.  The reference jits prefill and decode and
runs the decode loop on the device through ``lax.scan``; here the prefill
is one eager call and the decode a Python loop of ``decode_step``\\ s, each
writing its k/v into the caches in place.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import ranks


def as_tokens(tokens, device) -> torch.Tensor:
    """Token ids (array or tensor) as an int64 tensor on ``device``."""
    t = tokens if isinstance(tokens, torch.Tensor) else \
        torch.from_numpy(np.asarray(tokens))
    return t.to(device=device, dtype=torch.int64)


class ServeEngine:
    """Generation over a model and its params, on the model's device."""

    def __init__(self, model, params, s_max: int = 256):
        ranks.refuse_counting("ServeEngine")
        self.model = model
        self.params = params
        self.s_max = s_max

    @torch.inference_mode()
    def generate(self, tokens, steps: int, temperature: float = 0.0,
                 seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, S) prompt -> (generated (B, steps) int32, last
        logits).  ``temperature`` 0 is greedy (argmax, first of ties);
        above 0 each step samples the softmax of logits / temperature from
        a ``torch.Generator`` seeded by ``seed`` (a sampled run repeats
        under one seed; it cannot repeat ``jax.random``'s draws)."""
        tokens = as_tokens(tokens, self.model.device)
        logits, state = self.model.prefill(self.params, tokens, self.s_max)
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=logits.device).manual_seed(seed)
        out = []
        for _ in range(steps):
            lg = logits[:, -1, :]
            if gen is None:
                nxt = torch.argmax(lg, dim=-1)
            else:
                probs = torch.softmax(lg.float() / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
            logits, state = self.model.decode_step(self.params, state,
                                                   nxt[:, None], inplace=True)
            out.append(nxt.to(torch.int32))
        if not out:
            return tokens.new_zeros((tokens.shape[0], 0),
                                    dtype=torch.int32), logits
        return torch.stack(out, dim=1), logits
