"""The reference's parameters in the port: :func:`params_from_jax`.

``repro``'s ``CausalLM.init`` returns a nested dict whose per-layer leaves
carry a leading ``layers`` axis (stacked for ``lax.scan``).  Given that tree
as numpy arrays (``jax.tree.map(np.asarray, params)``), this builds a port
:class:`~repro_torch.models.transformer.CausalLM` that holds the same
weights, so both packages compute with them.  Weights keep their (in, out)
orientation: both packages multiply ``x @ W``, so nothing is transposed.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.registry import build_model


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: Mapping, cfg: ModelConfig, device=None):
    """A port model of ``cfg`` on ``device`` (default CUDA) holding the
    weights of the reference's parameter tree ``tree`` (numpy leaves): the
    stacked ``layers`` axis is split into one module per layer.  Returns
    the model, which is the ``params`` its methods take."""
    layers = tree["layers"]
    n = cfg.num_layers
    for block in layers.values():
        for name, a in block.items():
            if np.shape(a)[0] != n:
                raise ValueError(f"layers/{name}: leading axis "
                                 f"{np.shape(a)[0]}, config has {n} layers")
    per_layer = [{bn: {k: _tensor(np.asarray(a)[i]) for k, a in b.items()}
                  for bn, b in layers.items()} for i in range(n)]
    out = {"embedding": _tensor(tree["embedding"]), "layers": per_layer,
           "final_norm": {k: _tensor(a)
                          for k, a in tree["final_norm"].items()}}
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"])
    return build_model(cfg, device=device).set_params(out)
