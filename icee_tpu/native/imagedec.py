"""Native JPEG batch feeder: C++ libjpeg decode + threaded bilinear resize.

The reference decodes training images with PIL inside Python DataLoader
workers (``stylenet/data_loader.py:57-66``); this module is the native
host feeder — one ctypes call decodes and resizes a whole batch in C++
threads with no GIL.  Falls back to the PIL path (bit-identical decode, see
tolerance note below) when the toolchain or libjpeg is unavailable.

Parity: JPEG IDCT rounding may differ by ±1 LSB between libjpeg builds and
the resize is classic bilinear (PIL applies an antialias filter when
downscaling), so this is the throughput feeder for training input — the
serving/eval parity paths keep :func:`icee_tpu.data.transforms
.host_decode_resize` (PIL).  ``tests/test_native.py`` bounds the deviation.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "imagedec.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_LIB = os.path.join(_BUILD_DIR, "libicee_imagedec.so")
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        if not os.path.exists(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)
        ):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", prefix="icee_imagedec_",
                                       dir=_BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-pthread",
                     _SRC, "-ljpeg", "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, _LIB)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(_LIB)
        lib.decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ]
        lib.decode_resize_batch.restype = ctypes.c_int32
        _lib = lib
    except Exception:
        _build_failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def decode_resize_batch(jpegs: Sequence[bytes], size: int,
                        n_threads: int = 4,
                        force_pil: bool = False) -> np.ndarray:
    """Decode a batch of JPEG byte strings -> (n, size, size, 3) uint8.

    Failed decodes come back as black images (matching the C side);
    ``force_pil`` exercises the fallback in tests.
    """
    n = len(jpegs)
    out = np.empty((n, size, size, 3), np.uint8)
    lib = None if force_pil else _load()
    if lib is not None:
        bufs = (ctypes.c_void_p * n)()
        sizes = np.empty((n,), np.int64)
        # keep strong references so the buffers outlive the call
        holders = [np.frombuffer(j, np.uint8) for j in jpegs]
        for i, h in enumerate(holders):
            bufs[i] = h.ctypes.data_as(ctypes.c_void_p).value
            sizes[i] = h.size
        lib.decode_resize_batch(
            bufs, sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n), ctypes.c_int32(size), ctypes.c_int32(size),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int32(n_threads))
        return out
    import io

    from icee_tpu.data.transforms import host_decode_resize
    from PIL import Image

    for i, j in enumerate(jpegs):
        try:
            out[i] = host_decode_resize(Image.open(io.BytesIO(j)), size)
        except Exception:
            out[i] = 0
    return out


def decode_resize_paths(paths: Sequence[str], size: int,
                        n_threads: int = 4) -> np.ndarray:
    """File-path convenience wrapper over :func:`decode_resize_batch`."""
    bufs = []
    for p in paths:
        with open(p, "rb") as f:
            bufs.append(f.read())
    return decode_resize_batch(bufs, size, n_threads=n_threads)
