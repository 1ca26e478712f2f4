"""Cross-process communication for metric and object aggregation
(counterpart of casmtr_tpu/parallel/comm.py).

Without an initialised ``torch.distributed`` process group the world is
one process and every function is the identity of the JAX module's single
process.  With one, arrays go through ``all_gather`` and Python objects
are pickled into uint8 payloads padded to the longest, gathered, and
unpickled (the JAX module's serialize + pad + all_gather scheme).  The
payloads travel on the group's device: the card under NCCL, the CPU under
gloo.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def _device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_arrays(x: np.ndarray) -> np.ndarray:
    """Gather a same-shape array from every process -> stacked [world, ...]."""
    x = np.asarray(x)
    if get_world_size() == 1:
        return x[None]
    t = torch.from_numpy(np.ascontiguousarray(x)).to(_device())
    out = [torch.empty_like(t) for _ in range(get_world_size())]
    dist.all_gather(out, t)
    return np.stack([o.cpu().numpy() for o in out])


def all_gather(obj: Any) -> List[Any]:
    """Gather arbitrary picklable objects from all processes."""
    world = get_world_size()
    if world == 1:
        return [obj]
    payload = np.frombuffer(pickle.dumps(obj), dtype=np.uint8)
    sizes = all_gather_arrays(np.asarray([payload.size], np.int64))[:, 0]
    padded = np.zeros(int(sizes.max()), np.uint8)
    padded[:payload.size] = payload
    gathered = all_gather_arrays(padded)
    return [pickle.loads(gathered[r, :int(sizes[r])].tobytes())
            for r in range(world)]


def gather(obj: Any, dst: int = 0) -> List[Any]:
    """Gather to one process (the others get []); an all_gather, as the
    JAX module's."""
    out = all_gather(obj)
    return out if get_rank() == dst else []


def reduce_dict(d: Dict[str, float], average: bool = True) -> Dict[str, float]:
    """Mean (or sum) of scalar dicts across processes, keys sorted."""
    keys = sorted(d)
    vals = np.asarray([float(d[k]) for k in keys], np.float64)
    stacked = all_gather_arrays(vals)
    red = stacked.mean(0) if average else stacked.sum(0)
    return dict(zip(keys, red.tolist()))
