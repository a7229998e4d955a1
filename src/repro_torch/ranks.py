"""Ranks of a process group, one a card: the port's counterpart of
``jax.distributed.initialize``.

:func:`init_ranks` joins the process group that torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``) or an
explicit ``init_method`` names, and binds the rank to its device.  On the
card the backend is NCCL and rank ``LOCAL_RANK`` takes card
``LOCAL_RANK``; gloo is used only when the caller asks for the CPU or names
``backend="gloo"`` (ranks that share one card must: NCCL refuses two ranks
on one device).  Without CUDA and without ``device="cpu"`` it raises: it
never falls back to the CPU.

:class:`RankAxis` is one axis of a mesh laid over ranks
(``core.distributed.SearchMesh``): its process group, its size in ranks and
this rank's coordinate, with the collectives the port issues along it
(``all_reduce``, ``gather``, ``all_to_all``);
:func:`broadcast` sends a tensor from one rank to the whole group (the
serving engine's control messages).  They keep the lanes path's bits:

* nothing is sent as ``bool`` (NCCL has no bool type): uint8 and int32;
* a float is never summed by ``all_reduce`` (its result would depend on
  the ranks' order): float values are gathered and added in lane order by
  the caller; integer sums and float maxima are exact in any order;
* a gloo group carrying CUDA tensors stages them through host memory
  (:func:`transport` says so);
* nothing is pickled: a message is a header tensor, then its payload.

:func:`init_counting_ranks` is the dry run's group (``launch.dryrun``): one
rank of a job of 256 or 512 ranks, in a process of its own, over torch's
``fake`` backend, which moves no data and returns unwritten memory from
every collective.  DTensor traces that rank's program on the ``meta``
device as XLA compiles one device's SPMD module.  Under it
(:func:`counting`) the real entry points (serving, search, the build, the
trainer) raise at their start (:func:`refuse_counting`).
"""
from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)

# this rank's device, the group's timeout, and the default search mesh over
# the group (ann.index.default_search_mesh); dropped with the group
_STATE = {"device": None, "timeout": None, "search_mesh": None,
          "counting": False}


def init_ranks(device=None, backend: Optional[str] = None,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world: Optional[int] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the process group and return this rank's device.

    ``rank``/``world`` default to torchrun's ``RANK``/``WORLD_SIZE``, and
    ``init_method`` to ``env://``.  ``device``: None or ``"cuda"`` takes
    card ``LOCAL_RANK`` (default ``rank % device_count()``), ``"cuda:i"``
    card i, ``"cpu"`` the CPU.  ``backend``: NCCL on a card, gloo on the
    CPU, unless named.  A second call returns the device of the first."""
    if dist.is_initialized():
        if _STATE["device"] is None:
            raise RuntimeError("a process group is up that init_ranks did "
                               "not start: its ranks have no device")
        return _STATE["device"]
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_ranks puts each rank on a card and no CUDA device is "
            "available; pass device='cpu' for gloo ranks on the CPU")
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world = int(os.environ["WORLD_SIZE"]) if world is None else int(world)
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None
                               else rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"ranks run on a card or the CPU, not {dev}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("NCCL carries CUDA tensors only; gloo runs ranks "
                         "on the CPU")
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world, timeout=timeout,
                            **kw)
    _STATE.update(device=dev, timeout=timeout)
    return dev


def init_counting_ranks(world: int, rank: int = 0) -> torch.device:
    """Join a process group of ``world`` ranks as ``rank`` that moves no
    data (torch's ``fake`` backend, registered by
    ``torch.testing._internal.distributed.fake_pg``, with its
    ``FakeStore``): this process alone stands for the whole job, and each
    collective returns unwritten memory.  The rank's device is ``meta``.
    Only the dry run calls it, in a process of its own (a process holds
    one default group).  Raises when the backend cannot be had."""
    if dist.is_initialized():
        raise RuntimeError("a process group is up: the counting group "
                           "needs a process of its own")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run's counting group needs torch's "
                           "'fake' process-group backend, which this torch "
                           f"does not have ({e})") from e
    dist.init_process_group("fake", rank=int(rank), world_size=int(world),
                            store=FakeStore())
    dev = torch.device("meta")
    _STATE.update(device=dev, timeout=DEFAULT_TIMEOUT, counting=True)
    return dev


def counting() -> bool:
    """Whether the group up is :func:`init_counting_ranks`' (no data
    moves: nothing may compute on its results)."""
    return _STATE["counting"] and dist.is_initialized()


def refuse_counting(what: str) -> None:
    """Raise when the counting group is up: ``what`` is a real path, and
    the counting group's collectives return unwritten memory."""
    if counting():
        raise RuntimeError(
            f"{what} refuses the dry run's counting group "
            "(ranks.init_counting_ranks): its collectives move no data; "
            "only launch.dryrun traces under it")


def shutdown() -> None:
    """Leave the process group (every rank calls it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(device=None, timeout=None, search_mesh=None,
                  counting=False)


def is_up() -> bool:
    return dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def device() -> torch.device:
    """This rank's device (raises when no group is up)."""
    if _STATE["device"] is None:
        raise RuntimeError("no process group is up: call init_ranks first")
    return _STATE["device"]


def timeout() -> datetime.timedelta:
    """How long a collective of the group waits for its peers before it
    fails (``DEFAULT_TIMEOUT`` when no group is up)."""
    return _STATE["timeout"] or DEFAULT_TIMEOUT


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def _staged(t: torch.Tensor, group=None) -> bool:
    """Whether a payload goes through host memory: CUDA tensors on gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def transport() -> str:
    """How the group's payloads travel, for a run's report."""
    be = backend()
    if be is None:
        return "none: no process group"
    if be == "nccl":
        return "nccl: device to device"
    if _STATE["device"] is not None and _STATE["device"].type == "cuda":
        return "gloo: CUDA payloads staged through host memory"
    return "gloo: host memory"


def barrier() -> None:
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def _check_payload(t: torch.Tensor) -> None:
    if t.dtype == torch.bool:
        raise TypeError("send bool as uint8: NCCL has no bool type")


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` of rank ``src`` on every rank of the group, as a new tensor on
    ``t``'s device (the other ranks pass a tensor of the same shape and
    dtype to receive into); waits at most :func:`timeout`."""
    _check_payload(t)
    x = t.detach().to("cpu" if _staged(t) else t.device,
                      copy=True).contiguous()
    dist.broadcast(x, src=src)
    return x.to(t.device)


class RankAxis(NamedTuple):
    """One mesh axis laid over ranks: its process group, its size in ranks
    and this rank's coordinate along it."""
    group: object
    size: int
    coord: int

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``op`` ("sum" or "max") of ``t`` over the axis's ranks, as a new
        tensor on ``t``'s device.  Integer sums and maxima only, besides a
        float max: a float sum would depend on the ranks' order."""
        _check_payload(t)
        if op == "sum" and t.is_floating_point():
            raise TypeError("a float sum over ranks depends on their order: "
                            "gather the values and add them in lane order")
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        x = t.detach().to("cpu" if _staged(t, self.group) else t.device,
                          copy=True).contiguous()
        dist.all_reduce(x, op=red, group=self.group)
        return x.to(t.device)

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        _check_payload(t)
        x = t.detach().contiguous()
        if _staged(t, self.group):
            x = x.cpu()
        outs = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(outs, x, group=self.group)
        return torch.cat(outs, dim=dim).to(t.device)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` split into ``size`` equal blocks along dim 0, block j sent
        to the rank at coordinate j; returns the blocks received, in the
        senders' order along dim 0 (``jax.lax.all_to_all`` with
        ``split_axis = concat_axis = 0``)."""
        _check_payload(t)
        if t.shape[0] % self.size:
            raise ValueError(f"dim 0 of {tuple(t.shape)} does not split "
                             f"into {self.size} equal blocks")
        x = t.detach().contiguous()
        if _staged(t, self.group):
            x = x.cpu()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=self.group)
        return out.to(t.device)
