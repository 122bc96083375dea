"""ctypes bindings for the native (C++) input-pipeline kernels (port of
``avr_tpu/data/native.py``).

``avr_tpu_torch/csrc/ray_gather.cpp`` assembles a step's ray batch (the hot
loop of :func:`avr_tpu_torch.data.sampling.gather_rays`), on the calling
thread unless asked for one thread a scene, and decodes uint8 images to
[-1, 1].  The library is built at
first use with ``g++ -O3 -shared -fPIC -pthread`` into
``avr_tpu_torch/_build/``, named by a hash of its source and flags, and
moved into place by an atomic rename, so processes that build at once do
not race and a changed source is rebuilt.  A build or load failure raises
with the compiler's message: there is no quiet numpy fallback
(``gather_rays(impl="numpy")`` is the plain twin the tests compare with).

The ray indices are sampled in numpy on the Python side, so the native
gather and its numpy twin give the same arrays bit for bit for the same
generator state.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from avr_tpu_torch._paths import BUILD_DIR, CSRC

__all__ = ["load_native", "gather_rays_native", "decode_images"]

SOURCE = CSRC / "ray_gather.cpp"
CXXFLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")

_libs: Dict[Path, ctypes.CDLL] = {}  # by source path, loaded once a process
_lock = threading.Lock()


def _compiler() -> str:
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no C++ compiler (g++) found to build the native ray gather "
                       f"({SOURCE})")


def _build(source: Path, target: Path) -> None:
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        so_tmp = Path(tmp) / target.name
        cmd = [_compiler(), *CXXFLAGS, "-o", str(so_tmp), str(source)]
        res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the native ray gather failed ({' '.join(cmd)}):\n"
                               f"{res.stdout}")
        os.replace(so_tmp, target)


def load_native() -> ctypes.CDLL:
    """Build (if needed) and load the library from :data:`SOURCE`; raises
    with the compiler's or the loader's message if either fails."""
    source = Path(SOURCE)
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        digest = hashlib.sha256(" ".join(CXXFLAGS).encode() + source.read_bytes()).hexdigest()
        target = Path(BUILD_DIR) / f"libavr_native_{digest[:16]}.so"
        if not target.exists():
            _build(source, target)
        lib = ctypes.CDLL(str(target))
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.avr_gather_rays.restype = ctypes.c_int
        lib.avr_gather_rays.argtypes = [f32p, f32p, f32p, i64p, f32p, f32p, f32p,
                                        *[ctypes.c_int64] * 5]
        lib.avr_decode_images.restype = ctypes.c_int
        lib.avr_decode_images.argtypes = [u8p, f32p, ctypes.c_int64]
        _libs[source] = lib
        return lib


def gather_rays_native(batch: Dict[str, np.ndarray], rays_idx: np.ndarray,
                       num_threads: int = 1) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """The native twin of ``sampling.gather_rays`` for precomputed flat ray
    indices ``(SB, R)`` over ``NV * sl^2`` pixels.

    ``num_threads`` threads (at most one a scene) are started for the call;
    the default gathers on the calling thread: at a step's 4 x 1,024 and
    4 x 4,096 rays, starting a thread a scene cost more than it saved
    (``profiling/gather_timing.py`` on an H100 machine's host).
    """
    lib = load_native()
    images = np.ascontiguousarray(batch["images"], np.float32)
    SB, NV, sl2, _ = images.shape
    idx = np.ascontiguousarray(rays_idx, np.int64)
    if idx.ndim != 2 or idx.shape[0] != SB:
        raise ValueError(f"rays_idx {idx.shape} for {SB} scenes")
    if idx.size and (idx.min() < 0 or idx.max() >= NV * sl2):
        raise IndexError(f"ray indices outside [0, {NV * sl2})")
    R = idx.shape[1]
    x_pix = np.ascontiguousarray(batch["x_pix"], np.float32).reshape(SB, NV * sl2, 2)
    c2w = np.ascontiguousarray(batch["cam2world"], np.float32).reshape(SB, NV, 16)
    out_x = np.empty((SB, R, 2), np.float32)
    out_c = np.empty((SB, R, 16), np.float32)
    out_g = np.empty((SB, R, 3), np.float32)
    rc = lib.avr_gather_rays(x_pix, images.reshape(SB, NV * sl2, 3), c2w, idx, out_x, out_c,
                             out_g, SB, NV, sl2, R, num_threads)
    if rc != 0:
        raise RuntimeError(f"avr_gather_rays failed with code {rc} (SB={SB}, NV={NV}, "
                           f"sl2={sl2}, R={R})")
    model_input = {
        "x_pix": out_x,
        "cam2world": out_c.reshape(SB, R, 4, 4),
        "intrinsics": np.asarray(batch["intrinsics"][:, 0], np.float32),
    }
    return model_input, out_g


def decode_images(img_u8: np.ndarray) -> np.ndarray:
    """uint8 images -> float32 in [-1, 1] (``u8 / 127.5 - 1``, the dataset's
    normalisation), any shape."""
    lib = load_native()
    flat = np.ascontiguousarray(img_u8, np.uint8).reshape(-1)
    out = np.empty(flat.shape, np.float32)
    if flat.size and lib.avr_decode_images(flat, out, flat.size) != 0:
        raise RuntimeError("avr_decode_images failed")
    return out.reshape(np.shape(img_u8))

