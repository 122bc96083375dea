"""Build and load the port's CUDA kernel library (``avr_tpu_torch/csrc``).

Route: each ``csrc/*.cu`` is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), the objects are linked into one shared
library with a plain C interface, and the library is loaded with
``ctypes``.  No source includes PyTorch's headers, so a build takes
seconds.  The library is named by a hash of the sources and flags and lives
in ``avr_tpu_torch/_build/`` (git-ignored), so a changed source is rebuilt
and an unchanged one is reused.

Nothing here runs at import: the first kernel launch builds and loads.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from avr_tpu_torch._paths import BUILD_DIR, CSRC

__all__ = ["launches", "reset_launches", "load_library", "kernel_fn", "check",
           "check_cuda_inputs", "ptr", "stream_ptr", "build_info"]

SOURCES = ("gather.cu", "resnetfc.cu", "resnetfc_hopper.cu", "resnetfc_wide.cu",
           "resnetfc_chain.cu", "march.cu", "integrate.cu", "rng.cu")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Launches per kernel wrapper: each wrapper adds one where it launches its
# kernel and nowhere else (the plain CPU path does not count).
launches: collections.Counter = collections.Counter()

_lib: Optional[ctypes.CDLL] = None
_fns: Dict[str, ctypes._CFuncPtr] = {}
build_info: Dict[str, object] = {}


def reset_launches() -> None:
    launches.clear()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the GPU host")


def _digest() -> str:
    # the kernels' sources and headers; the host's ray_gather.cpp is not built here
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in sorted({*SOURCES, *(n for n in os.listdir(CSRC) if n.endswith(".cuh"))}):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            cmd = [nvcc, *FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
        so_tmp = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(so_tmp), *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {target.name} failed:\n{link.stdout}")
        os.replace(so_tmp, target)
    (BUILD_DIR / (target.stem + ".log")).write_text(log)
    build_info.update(seconds=time.perf_counter() - t0, log=log, built=True)


def load_library() -> Dict[str, object]:
    """Build (if needed) and load the library now; returns :data:`build_info`."""
    _library()
    return build_info


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        target = BUILD_DIR / f"libavr_kernels_{_digest()}.so"
        if target.exists():
            build_info.update(seconds=0.0, built=False)
        else:
            _build(target)
        build_info["path"] = str(target)
        _lib = ctypes.CDLL(str(target))
    return _lib


def kernel_fn(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``name`` with its signature declared (every entry
    point returns the ``cudaError_t`` of its launch as an int)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_library(), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(name: str, err: int) -> None:
    """Raise on a refused or failed launch (``cudaGetLastError`` != 0)."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    launches[name] += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda_inputs(name: str, tensors: Dict[str, torch.Tensor],
                      device: torch.device) -> None:
    """Device and contiguity checks shared by the wrappers."""
    if device.type != "cuda":
        raise ValueError(f"{name}: the kernel runs on CUDA tensors, got {device}")
    for arg, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
