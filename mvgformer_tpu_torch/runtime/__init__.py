"""Native host runtime: the C++ warp + ImageNet normalization of the input
pipeline, with a ctypes binding.

The port's own copy of `mvgformer_tpu/runtime/`. `warp.cpp` is built with
g++ at first use (never at import) into `build/native/` at the root of the
checkout, under a name that carries a hash of the source and the flags, so
an edit rebuilds. Without a compiler the warp falls back to cv2, imported
only then.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from mvgformer_tpu_torch.data.meta import IMAGE_MEAN, IMAGE_STD

SOURCE = Path(__file__).resolve().parent / "warp.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
             "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"warp-{key.hexdigest()[:16]}.so"


def _build(lib: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=240)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, lib)
    return True


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native warp library, or None."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        path = library_path()
        if not path.is_file() and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.warp_normalize_batch.restype = ctypes.c_int
        lib.warp_normalize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None


def warp_normalize_cv2(img_rgb: np.ndarray, affine_2x3: np.ndarray,
                       net_size) -> np.ndarray:
    """cv2 warp + ImageNet normalization of one uint8 RGB image: the
    fallback of the native warp."""
    import cv2

    warped = cv2.warpAffine(img_rgb,
                            np.asarray(affine_2x3, dtype=np.float32),
                            (int(net_size[0]), int(net_size[1])),
                            flags=cv2.INTER_LINEAR)
    out = warped.astype(np.float32) / 255.0
    return (out - IMAGE_MEAN) / IMAGE_STD


def warp_normalize_views(images: np.ndarray, affines: np.ndarray,
                         out_size, num_threads: int = 0) -> np.ndarray:
    """Warp + ImageNet-normalize a stack of views with the native code.

    images:  (V, H, W, 3) uint8 RGB (same size per view).
    affines: (V, 2, 3) forward source->destination affines.
    out_size: (W, H) destination size.
    Returns (V, dh, dw, 3) float32 normalized; through cv2 when the native
    library is unavailable.
    """
    lib = load_library()
    V, sh, sw, _ = images.shape
    dw, dh = int(out_size[0]), int(out_size[1])
    if lib is None:
        return np.stack([warp_normalize_cv2(images[v], affines[v], (dw, dh))
                         for v in range(V)])
    images = np.ascontiguousarray(images, dtype=np.uint8)
    aff = np.ascontiguousarray(affines, dtype=np.float32)
    dst = np.empty((V, dh, dw, 3), dtype=np.float32)
    mean = np.ascontiguousarray(IMAGE_MEAN, dtype=np.float32)
    std = np.ascontiguousarray(IMAGE_STD, dtype=np.float32)
    if num_threads <= 0:
        num_threads = min(os.cpu_count() or 1, max(V, 1))
    ret = lib.warp_normalize_batch(
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), V, sh, sw,
        aff.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), dh, dw,
        mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    if ret != 0:
        raise RuntimeError(f"warp_normalize_batch failed: {ret}")
    return dst
