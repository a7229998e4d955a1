"""kNN-LM decoding with Speed-ANN retrieval (the paper's technique as a
first-class serving feature).

Port of ``repro.serve.knnlm``.  A datastore maps LM hidden states -> next
tokens (Khandelwal et al., 2020 formulation).  At each decode step the
current hidden state queries the Speed-ANN index; retrieval probabilities
p_knn(w) ∝ Σ_{(h,w') : w'=w} exp(-d(h, q)/τ) are interpolated with the LM
softmax:

    p(w) = λ · p_knn(w) + (1 − λ) · p_lm(w)

Building the datastore runs the model over a corpus and records
(final-hidden-state, next-token) pairs; the index is the port's
``AnnIndex`` on the model's device, so its build and its searches run
through the distance backend they name: ``build_backend="rowgather"`` and
``SearchParams(backend="rowgather" | "dma" | "dedup_gather")`` launch the
gather kernels on the card.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from repro_torch.ann import AnnIndex, IndexSpec, SearchParams
from repro_torch.core.config import SearchConfig
from repro_torch.models.common import rmsnorm, token_positions
from repro_torch.models.transformer import as_layers
from repro_torch.serve.engine import as_tokens


class KNNLMDatastore(NamedTuple):
    index: AnnIndex           # AnnIndex over hidden states
    values: torch.Tensor      # (N,) int32 next-token per datastore entry
    vocab_size: int

    @property
    def graph(self):
        """The index's PaddedCSR (back-compat accessor)."""
        return self.index.graph


@torch.inference_mode()
def build_datastore(model, params, token_batches, vocab_size: int,
                    degree: int = 16, metric: str = "l2", *,
                    build_batch: int = 32,
                    build_backend: str = "ref") -> KNNLMDatastore:
    """Run the model over batches, collect (hidden, next-token) pairs, and
    build the reference's index over them on the model's device.

    ``build_batch`` and ``build_backend`` are the only difference from
    ``repro``'s signature: they pass straight into the :class:`IndexSpec`
    (whose defaults they keep), where they tile the construction searches
    and pick their distance kernel.  The spec defines both as unable to
    change the graph (``tests/test_torch_knnlm.py`` shows they do not);
    on the card ``build_backend="rowgather"`` runs the build through the
    ``l2dist_rowgather`` kernel, and a tile of thousands cuts the rounds."""
    keys, vals = [], []
    for tokens in token_batches:
        tokens = as_tokens(tokens, model.device)
        h = _final_hidden(model, params, tokens)          # (B, S, d)
        keys.append(h[:, :-1].reshape(-1, h.shape[-1]).float())
        vals.append(tokens[:, 1:].reshape(-1).to(torch.int32))
    keys = torch.cat(keys)
    vals = torch.cat(vals)
    index = AnnIndex.build(keys, IndexSpec(
        builder="nsg", metric=metric, degree=degree, knn_k=degree,
        ef_construction=2 * degree, passes=1, build_batch=build_batch,
        build_backend=build_backend), device=model.device)
    return KNNLMDatastore(index=index, values=vals, vocab_size=vocab_size)


@torch.inference_mode()
def _final_hidden(model, params, tokens):
    """Final pre-logits hidden states: the layers in "train" mode over a
    bf16 embedding (the reference's cast, whatever ``cfg.dtype``), no
    logits."""
    cfg = model.cfg
    if hasattr(model, "_rope"):   # CausalLM
        params = as_layers(params)
        x = params.embedding[tokens.long()].to(torch.bfloat16)
        rope = model._rope(token_positions(tokens))
        for lp in params.layers:
            x, _, _ = model._layer_apply(lp, x, rope, "train", None, None)
        return rmsnorm(params.final_norm, x, cfg.norm_eps)
    raise NotImplementedError(type(model))


@torch.inference_mode()
def knnlm_logits(
    ds: KNNLMDatastore, hidden: torch.Tensor, lm_logits: torch.Tensor,
    cfg: Union[SearchConfig, SearchParams], lam: float = 0.25,
    tau: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Interpolate LM logits with Speed-ANN retrieval through the facade.

    hidden (B, d); lm_logits (B, V); ``cfg`` is a ``SearchParams`` (or a
    legacy ``SearchConfig``, whose per-query fields are lifted onto one).
    Returns (mixed log-probs (B, V), retrieved ids (B, k)).  p_knn is a
    ``scatter_add_`` into (B, V): on the card its additions land in no
    fixed order, so equal inputs agree to rounding, not bit for bit."""
    if isinstance(cfg, SearchConfig):
        cfg = SearchParams.from_search_config(cfg)
    ids, dists, _ = ds.index.search(hidden.float(), cfg)
    n = ds.graph.n_nodes
    safe = ids.long().clamp(max=n - 1)
    toks = ds.values[safe].long()                            # (B, k)
    valid = ids < n
    w = torch.where(valid, torch.softmax(
        torch.where(valid, -dists / tau, float("-inf")), dim=-1), 0.0)
    p_knn = torch.zeros((ids.shape[0], ds.vocab_size), dtype=torch.float32,
                        device=w.device).scatter_add_(1, toks, w)
    p_lm = torch.softmax(lm_logits.float(), dim=-1)
    mixed = lam * p_knn + (1.0 - lam) * p_lm
    return torch.log(torch.clamp(mixed, min=1e-20)), ids
