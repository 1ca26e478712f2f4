"""Hand-written CUDA kernels for Hopper (sm_90a): build, load and launch counts.

The sources live in ``casmtr_tpu_torch/csrc``.  At first use they are
compiled with ``nvcc`` (one process per source, all started together, then
one link) into a shared library with a plain C interface, which ctypes
loads.  The library lands in ``casmtr_tpu_torch/_build/<digest>/``, keyed by
a hash of the sources and the flags, so a changed source builds anew and an
unchanged one is reused.  Nothing is built at import time.

Every kernel wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel, and nowhere else; ``reset_launch_counts`` zeroes them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("quadtree_fine.cu", "window_score.cu", "window_attention.cu",
           "quadtree_fine_bwd.cu", "window_score_bwd.cu",
           "window_attention_bwd.cu")
HEADERS = ("block_chunk.cuh", "chunk_attention.cuh", "clip_index.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libcasmtr_kernels.so"

LAUNCHES: Dict[str, int] = {
    "quadtree_fine_attention": 0,
    "window_patch_score": 0,
    "window_cross_attention": 0,
    "quadtree_fine_attention_bwd": 0,
    "window_patch_score_bwd": 0,
    "window_cross_attention_bwd": 0,
    "quadtree_fine_topk": 0,
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "casmtr_quadtree_fine_attention_f32": [_P] * 6 + [_I] * 9 + [_F, _P],
    "casmtr_window_patch_score_f32": [_P] * 4 + [_I] * 6 + [_P],
    "casmtr_window_cross_attention_f32": [_P] * 6 + [_I] * 9 + [_F, _P],
    "casmtr_quadtree_fine_attention_bwd_f32":
        [_P] * 10 + [_I] * 9 + [_F, _P],
    "casmtr_window_patch_score_bwd_f32": [_P] * 6 + [_I] * 6 + [_P],
    "casmtr_window_cross_attention_bwd_f32":
        [_P] * 10 + [_I] * 9 + [_F, _P],
    "casmtr_quadtree_fine_topk_f32": [_P] * 8 + [_I] * 10 + [_F, _P],
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_seconds: Optional[float] = None  # wall time of the build in this process


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for path in cand:
        if path and os.access(path, os.X_OK):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use on a machine with the CUDA toolkit")


def _build(out_dir: Path) -> None:
    """Compile every source in parallel, then link one shared library.
    Builds into a private directory and renames it into place, so a
    concurrent build of the same digest cannot see a half-written library."""
    nvcc = _nvcc()
    tmp = out_dir.with_name(f"{out_dir.name}.tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    procs = []
    for src in SOURCES:
        obj = tmp / (Path(src).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(src)
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
         *[str(tmp / (Path(s).stem + ".o")) for s in SOURCES]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    if out_dir.exists():          # another process finished the same build
        shutil.rmtree(tmp, ignore_errors=True)
    else:
        os.replace(tmp, out_dir)


def lib(fresh: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  ``fresh`` discards a
    library an earlier process built from the same sources and builds anew
    (only before the first load in this process)."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            out_dir = BUILD_ROOT / _digest()
            if fresh:
                shutil.rmtree(out_dir, ignore_errors=True)
            if not (out_dir / LIB_NAME).exists():
                t0 = time.perf_counter()
                _build(out_dir)
                build_seconds = time.perf_counter() - t0
            loaded = ctypes.CDLL(str(out_dir / LIB_NAME))
            for fn, argtypes in _SIGNATURES.items():
                getattr(loaded, fn).argtypes = argtypes
                getattr(loaded, fn).restype = ctypes.c_int
            _lib = loaded
        return _lib


def build_log() -> str:
    """The compiler's output (ptxas register and shared-memory use) of the
    library that ``lib()`` loaded."""
    return (BUILD_ROOT / _digest() / "build.log").read_text()


def clip_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The index rule of the JAX oracles' clipped gathers
    (``take_along_axis(..., mode="clip")``): a negative index counts once
    from the end, then the result is clamped into [0, n - 1].  The CUDA
    kernels apply the same rule."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def check_cuda(t: torch.Tensor, name: str, shape, dtype: torch.dtype,
               device: torch.device) -> None:
    """Raise ValueError unless ``t`` is a contiguous CUDA tensor of the given
    shape and dtype on ``device`` -- the only tensors the kernels take."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA (or CPU) tensor, got "
                         f"device {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, other operands on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def launch(fn_name: str, kernel: str, device: torch.device, *args) -> None:
    """Call the C launcher ``fn_name`` on ``device``'s current stream (the
    stream is appended as the last argument), raise on a non-zero
    cudaError_t, and count the launch under ``kernel``."""
    fn = getattr(lib(), fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t "
                           f"{err}")
    LAUNCHES[kernel] += 1
