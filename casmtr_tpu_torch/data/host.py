"""The host library of the input pipeline (``csrc/host/*.cpp``): JPEG
decoding, PNG unfiltering and image resampling in C++17 with a plain C
interface, loaded with ``ctypes.CDLL``.

It is built at first use, never at import, with the host compiler (``c++``)
into ``casmtr_tpu_torch/_build/<digest>/libcasmtr_host.so``, keyed by a hash
of the sources and the flags, as the CUDA library of ``ops/kernels`` is.
Unlike that library it builds and runs on any machine with a C++ compiler,
the CPU-only ones included.  A failed build raises with the compiler's
output.  The flags keep the float resize reproducible: no ``-march=native``,
no fast-math, no contraction into fused multiply-adds.

``ctypes.CDLL`` releases the GIL for the length of each call, so the
``DataLoader``'s threads decode and resize in parallel.  (A ``PyDLL`` would
hold it; do not switch.)
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
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc" / "host"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("jpeg_decode.cpp", "png_unfilter.cpp", "image_ops.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-ffp-contract=off")
LIB_NAME = "libcasmtr_host.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "casmtr_jpeg_header": ([_P, ctypes.c_size_t, _P, _P, _I], _I),
    "casmtr_jpeg_decode": ([_P, ctypes.c_size_t, _I, _P, _P, _I], _I),
    "casmtr_png_unfilter": ([_P, _I, _I, _I, _P, _P, _I], _I),
    "casmtr_resize_pad_normalize": ([_P] + [_I] * 6 + [_P, _P], None),
    "casmtr_resize_linear_u8": ([_P, _I, _I, _I, _P, _I, _I], None),
    "casmtr_resize_linear_f32": ([_P, _I, _I, _I, _P, _I, _I], None),
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
build_seconds: Optional[float] = None  # wall time of the build in this process


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _digest() / LIB_NAME


def _build(out_dir: Path) -> None:
    """Compile and link in a private directory, then rename it into place,
    so a concurrent build of the same digest never sees half a library."""
    compiler = shutil.which("c++") or shutil.which("g++")
    if compiler is None:
        raise RuntimeError("no C++ compiler (c++ or g++) on PATH: the host "
                           "library of casmtr_tpu_torch.data is built at "
                           "first use")
    tmp = out_dir.with_name(
        f"{out_dir.name}.tmp{os.getpid()}.{threading.get_ident()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    cmd = [compiler, *CXX_FLAGS, *(str(CSRC / s) for s in SOURCES),
           "-o", str(tmp / LIB_NAME)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"building the host library failed:\n"
                           f"{' '.join(cmd)}\n{res.stdout}")
    try:
        os.rename(tmp, out_dir)
    except OSError:
        # another process renamed its build of the same digest first
        if not (out_dir / LIB_NAME).exists():
            raise
        shutil.rmtree(tmp, ignore_errors=True)


def lib(fresh: bool = False) -> ctypes.CDLL:
    """The loaded host library, built on first call.  ``fresh`` discards a
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
            for fn, (argtypes, restype) in _SIGNATURES.items():
                getattr(loaded, fn).argtypes = argtypes
                getattr(loaded, fn).restype = restype
            _lib = loaded
        return _lib
