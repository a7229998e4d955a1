"""Deterministic synthetic token pipeline for LM training and kNN-LM
datastores (the port's copy of ``repro.data.tokens``, pure numpy: the same
seed gives the same arrays).

Shard-aware: each data-parallel host slice draws a disjoint, reproducible
stream (seeded by (seed, shard, step)), so restarts resume mid-epoch exactly
— required for checkpoint/restart fault tolerance.  A background prefetch
thread hides host-side generation latency.
"""
from __future__ import annotations

import queue as _queue
import threading
from typing import Iterator, NamedTuple

import numpy as np


class TokenStream(NamedTuple):
    vocab_size: int
    seq_len: int
    batch: int              # per-shard batch
    seed: int
    shard: int
    num_shards: int


def _batch_at(stream: TokenStream, step: int) -> dict:
    """Markov-ish synthetic tokens: structured enough that loss decreases."""
    rng = np.random.RandomState(
        (stream.seed * 1_000_003 + stream.shard * 7919 + step) % (2**31 - 1))
    b, s, v = stream.batch, stream.seq_len, stream.vocab_size
    # mixture of a few "topics" -> learnable bigram structure
    topic = rng.randint(0, 8, size=(b, 1))
    base = rng.randint(0, v, size=(b, s))
    drift = (np.arange(s)[None, :] * (topic + 1)) % v
    tokens = ((base // 4) * 4 + drift % 4) % v
    inputs = tokens[:, :-1].astype(np.int32)
    targets = tokens[:, 1:].astype(np.int32)
    return {"tokens": inputs, "targets": targets,
            "mask": np.ones_like(inputs, np.float32)}


def synthetic_batches(
    stream: TokenStream, start_step: int = 0, prefetch: int = 2,
) -> Iterator[dict]:
    """Iterator with background prefetch, resumable at ``start_step``."""
    q: _queue.Queue = _queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                q.put(_batch_at(stream, step), timeout=0.1)
                step += 1
            except _queue.Full:
                continue

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
