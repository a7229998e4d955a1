"""Opt-in bridge from host spans to the PyTorch profiler's timeline.

Port of ``repro.obs.jaxbridge``.  Under ``torch.profiler.profile()`` host
Python has no slice of its own on the device timeline; a
``torch.profiler.record_function`` range gives it one, so "the engine
dispatched bucket 8 here" lines up with the kernels that dispatch launched.
On a CUDA device the annotation also opens an NVTX range of the same name,
which CUDA-level tools show beside the kernels.

:func:`device_annotation` is the single entry point.  It is a no-op (a
shared ``nullcontext``) unless explicitly enabled, so the serving hot path
never touches the profiler machinery by default::

    with device_annotation("ann_dispatch/bucket8", enabled=obs.profile,
                           cuda=index.device.type == "cuda"):
        out = searcher(queries)
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext

import torch

__all__ = ["device_annotation", "have_profiler"]

_NULL = nullcontext()


def have_profiler() -> bool:
    """True if ``torch.profiler.record_function`` is available."""
    return hasattr(torch, "profiler") and hasattr(torch.profiler,
                                                  "record_function")


@contextmanager
def _annotated(name: str, cuda: bool):
    with torch.profiler.record_function(name):
        if cuda:
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


def device_annotation(name: str, enabled: bool = False, cuda: bool = False):
    """Context manager: ``torch.profiler.record_function(name)`` when
    ``enabled`` (plus an NVTX range when ``cuda``), else a no-op."""
    if not enabled:
        return _NULL
    return _annotated(name, cuda)
