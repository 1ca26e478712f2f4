"""The data-parallel process group of the port (counterpart of
casmtr_tpu/parallel/mesh.py).

The JAX package trains under one ``jit`` over a batch sharded on a 1-D
``data`` mesh: XLA computes the step over the GLOBAL batch, so BatchNorm
statistics, the top-M match selection and the loss denominators are those
of the whole batch, and the gradient is the global loss's.  Here each
process holds one device and its rows of the global batch (rank r holds
rows [r*b, (r+1)*b), so the global order is the rank order), and the
places where the samples of a batch couple ask this module for the group:

* ``resnet_fpn.BatchNorm2d``: all-reduced sums of x and of the squared
  deviations (two passes), and in its backward the two gradient sums;
* ``ops.matching.select_topm`` (and so every extraction): one top-M over
  the gathered flat scores;
* ``ops.cascade_matching.keep_at_least_one`` and the d2d filter's min-max:
  their batch-wide reductions;
* ``train.loss``: counts and the mean inverse std all-reduced, detached;
* ``train.train_step``: the gumbel draw of the global batch, the summed
  gradients and scalars.

The coupling holds only inside ``global_batch()`` (the training step and a
data-parallel forward enter it); elsewhere, and without a group, every
function of the port computes what it computes in one process.  The
backend follows the device and the world: NCCL when every rank has a card
of its own, gloo for the CPU and for more ranks than cards (two ranks on
one card), whose collectives then stage the card's tensors through host
memory (``_stage``).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

TIMEOUT_S = 600   # a collective that waits longer fails the process
_coupled = [False]


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> torch.device:
    """Start the data-parallel group and return this rank's device.

    ``coordinator`` "host:port" of rank 0 with ``num_processes`` and
    ``process_id`` starts it over ``tcp://``; without one the launcher's
    ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` are read
    (``env://``, as torchrun sets them).  ``device`` None is the card
    (raises without CUDA), "cpu" the CPU; a card without an index becomes
    ``cuda:LOCAL_RANK`` (the rank when ``LOCAL_RANK`` is unset) modulo the
    cards present.  The backend is NCCL when the ranks are on cards and
    there are no more of them than cards, else gloo."""
    from casmtr_tpu_torch.serving import resolve_device
    dev = resolve_device(device)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--dist-coordinator needs --dist-num-processes "
                             "and --dist-process-id")
        init, world, rank = f"tcp://{coordinator}", num_processes, process_id
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise ValueError(f"--dist reads the launcher's {missing} "
                             "(torchrun sets them); or pass "
                             "--dist-coordinator host:port")
        init = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    backend = "gloo"
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
        if world <= cards:
            backend = "nccl"
    dist.init_process_group(
        backend, init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev


def group():
    """The data-parallel group (the default group), or None without one."""
    return dist.group.WORLD if (dist.is_available()
                                and dist.is_initialized()) else None


def world_size() -> int:
    return dist.get_world_size() if group() is not None else 1


def rank() -> int:
    return dist.get_rank() if group() is not None else 0


@contextlib.contextmanager
def global_batch():
    """Inside the block the samples of a batch couple across the group as
    one global batch (the JAX step over its sharded batch); a no-op
    without a group."""
    prev = _coupled[0]
    _coupled[0] = group() is not None
    try:
        yield
    finally:
        _coupled[0] = prev


def batch_group():
    """The group a batch couples over: inside ``global_batch()`` the
    data-parallel group, else None (the batch is the whole batch)."""
    return group() if _coupled[0] else None


def _stage(t: torch.Tensor) -> bool:
    """Whether a collective of ``t`` goes through host memory: gloo on the
    card's tensors (two ranks sharing one card)."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _all_reduce_(t: torch.Tensor, grp=None) -> torch.Tensor:
    """In-place all-reduce sum of ``t`` over ``grp`` (default the
    data-parallel group)."""
    if _stage(t):
        host = t.cpu()
        dist.all_reduce(host, group=grp)
        return t.copy_(host)
    dist.all_reduce(t, group=grp)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x, on every rank; the adjoint of a replicated
    sum is the all-reduced sum of the output gradients."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _all_reduce_(x.clone(), grp)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce_(dy.clone(), ctx.grp), None


def all_reduce_sum(x: torch.Tensor, grp=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``grp`` (default the
    data-parallel group), differentiable; ``x`` is left as it is."""
    return _AllReduceSum.apply(x, grp)


def all_gather_flat(x: torch.Tensor, grp=None) -> torch.Tensor:
    """The flat vectors ``x`` [n] of every rank (the same n on each),
    concatenated in rank order: [world * n]."""
    n = dist.get_world_size(grp)
    src = x.cpu() if _stage(x) else x
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src.contiguous(), group=grp)
    return torch.cat(out).to(x.device)


def all_reduce_grads(grads: Iterable[torch.Tensor]) -> None:
    """Sum the gradients of every rank in place: one flat bucket per dtype,
    one all-reduce each."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    with torch.profiler.record_function("dp:grad_all_reduce"):
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            _all_reduce_(flat)
            parts = flat.split([t.numel() for t in ts])
            torch._foreach_copy_(ts, [p.view_as(t) for p, t in zip(parts,
                                                                    ts)])


def shard_rows(batch: Dict, rnk: Optional[int] = None,
               world: Optional[int] = None) -> Dict:
    """This rank's rows of a global batch (the counterpart of
    ``shard_batch``): rows [r*b, (r+1)*b) of every array, b = B / world."""
    rnk = rank() if rnk is None else rnk
    world = world_size() if world is None else world
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f"{k}: batch {v.shape[0]} does not split over "
                             f"{world} ranks")
        b = v.shape[0] // world
        out[k] = v[rnk * b:(rnk + 1) * b]
    return out


def broadcast_state(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Every rank takes rank ``src``'s values of ``tensors`` (parameters,
    buffers, optimizer moments, in the same order on every rank): the
    counterpart of ``replicate_state``."""
    with torch.no_grad():
        for t in tensors:
            if _stage(t):
                host = t.cpu()
                dist.broadcast(host, src)
                t.copy_(host)
            else:
                dist.broadcast(t, src)
