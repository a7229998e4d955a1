"""Atomic, keep-k checkpoints in the reference's format (port of
``repro.checkpoint.ckpt``).

Layout: ``<dir>/step_<N:08d>/arrays.npz`` + ``manifest.json`` (step,
sorted keys, shapes, dtype names), one npz entry per leaf, keyed by its
``treepath.keystr_simple`` name.  Writes go to a temp dir and an atomic
rename, so a crash mid-save never corrupts the latest checkpoint.  The
keys, shapes and dtype names are the reference's, so each package loads
the other's checkpoints.  bfloat16 leaves are stored as the reference's
numpy stores them (2-byte raw values, npz dtype ``|V2``; manifest
``"bfloat16"``; ``npio.py``), which needs no ``ml_dtypes``.  A restored
leaf takes the dtype and device of the matching leaf of ``like``.

``CheckpointManager`` adds background-thread saves after a synchronous
snapshot to the host, and keep-last-k garbage collection.

Over ranks (a process group up): every rank gathers the whole value of
each DTensor leaf (the compressed step's residuals among them: every data
rank's rows, in lane order), rank 0 alone writes (synchronously) and the
others wait at a barrier; ``load_checkpoint(..., shardings=)`` places each
restored leaf by its ``sharding.RankSharding``, as the reference
device_puts against its shardings.  Restored without one, a leaf is the
whole value on every rank (the compressed step takes each rank's block of
residual rows from it).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from repro_torch import ranks as rank_mod
from repro_torch.npio import dtype_name, from_numpy, to_numpy
from repro_torch.sharding import place, whole
from repro_torch.treepath import (flatten_with_path, keystr_simple,
                                  tree_map, tree_map_with_path)

def _flatten(tree) -> Dict[str, Any]:
    return {keystr_simple(path): leaf
            for path, leaf in flatten_with_path(tree)}


def _host(x):
    """A leaf's whole value, copied to the host."""
    return whole(x).detach().to("cpu", copy=True)


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[dict] = None) -> str:
    """Atomic save: write to tmp, rename.  Over ranks every rank calls it;
    rank 0 writes and the others wait for it."""
    target = os.path.join(directory, f"step_{step:08d}")
    if rank_mod.is_up():
        host = tree_map(_host, tree)
        if rank_mod.rank() == 0:
            _write(target, step, host, extra)
        rank_mod.barrier()
        return target
    return _write(target, step, tree, extra)


def _write(target: str, step: int, tree, extra: Optional[dict]) -> str:
    flat = _flatten(tree)
    tmp = target + f".tmp.{os.getpid()}.{int(time.time() * 1e6)}"
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: to_numpy(v) for k, v in flat.items()}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: dtype_name(v) for k, v in flat.items()},
        "extra": extra or {},
        "treedef": None,
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(target):
        shutil.rmtree(target)
    os.replace(tmp, target)
    return target


def _steps(directory: str) -> list:
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and "tmp" not in d]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: int, like, shardings=None):
    """Restore into the structure of ``like``: each leaf read by its key in
    that leaf's dtype, and put on that leaf's device, or placed by the
    matching leaf of ``shardings`` (a tree of ``sharding.RankSharding``,
    as ``param_shardings`` gives; elastic restore onto a mesh of ranks)."""
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    by_key = {} if shardings is None else _flatten(shardings)

    def one(p, ref):
        key = keystr_simple(p)
        x = from_numpy(data[key]).to(dtype=ref.dtype)
        if key in by_key:
            return place(x, by_key[key])
        return x.to(device=_device_of(ref))

    with np.load(path) as data:
        return tree_map_with_path(one, like)


def _device_of(x):
    """The device of a leaf (a DTensor's part on this rank)."""
    return x.to_local().device if hasattr(x, "to_local") else x.device


class CheckpointManager:
    """Async saves + keep-last-k retention."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def wait(self):
        """Join the background save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, tree, extra: Optional[dict] = None):
        # snapshot to the host synchronously (a copy, also of CPU tensors
        # that the next step updates in place), write in the background
        host_tree = tree_map(_host, tree)
        self.wait()

        def work():
            _write(os.path.join(self.directory, f"step_{step:08d}"), step,
                   host_tree, extra)
            self._gc()

        if rank_mod.is_up():
            # rank 0 writes while the others wait: no collective may run
            # from a background thread
            if rank_mod.rank() == 0:
                work()
            rank_mod.barrier()
            return

        def background():
            try:
                work()
            except Exception as e:  # noqa: BLE001 — raised by wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=background, daemon=True)
            self._thread.start()
        else:
            work()

    def _gc(self):
        for s in sorted(_steps(self.directory))[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like):
        self.wait()
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return load_checkpoint(self.directory, step, like), step
