"""Native (C++) host routines, loaded through ctypes: COCO RLE mask decoding
(``maskops.cpp``, a copy of the JAX package's ``tpupose/native/``) and
cv2's fixed-point bilinear resize of uint8 images (``resize_u8_host.cpp``,
called by ``ops/resize.py::resize_u8_linear``).

Each library is built with ``g++ -O3 -shared -fPIC`` at first use into
``tpupose_torch/_build/`` under a name keyed by a hash of the source and
the flags, by an atomic rename (spawned loader workers may race the first
build).  The flags are portable (no ``-march=native``), so the build
directory can move between hosts.  There is no silent fallback: a failed
build raises with the compiler's message, and malformed input raises
``ValueError``.  The numpy decoders in ``data/coco_json.py`` and
``resize_u8_linear_plain`` are the plain versions the tests hold these
against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_NATIVE_DIR, "maskops.cpp")
RESIZE_SOURCE = os.path.join(_NATIVE_DIR, "resize_u8_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_NATIVE_DIR), "_build")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_opened = {}
_lib = None


def library_path(source: str) -> str:
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(GXX_FLAGS).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")


def _build(source: str, path: str) -> None:
    """Compile to a per-process temporary name, then rename it into place:
    a half-written library is never visible."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, source, "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {source} with g++ failed (exit "
                f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def open_library(source: str) -> ctypes.CDLL:
    """The library built from ``source``, built at first use; one handle
    per built file in the process."""
    path = library_path(source)
    with _lock:
        lib = _opened.get(path)
        if lib is None:
            if not os.path.exists(path):
                _build(source, path)
            lib = _opened[path] = ctypes.CDLL(path)
        return lib


def load_maskops() -> ctypes.CDLL:
    """The maskops library, built at first use."""
    global _lib
    if _lib is not None:
        return _lib
    lib = open_library(SOURCE)
    lib.rle_counts_to_mask.restype = ctypes.c_int
    lib.rle_counts_to_mask.argtypes = [
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.rle_decode.restype = ctypes.c_int
    lib.rle_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    _lib = lib
    return _lib


def load_resize_u8() -> ctypes.CDLL:
    """The host resize library, built at first use, its function typed."""
    lib = open_library(RESIZE_SOURCE)
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.resize_u8_linear_host.restype = i
    lib.resize_u8_linear_host.argtypes = [p, i, i, i, p, i, i,
                                          p, p, p, p, p, p]
    return lib


def rle_counts_to_mask_native(counts, h: int, w: int) -> np.ndarray:
    """Run-length counts (column-major, a 0-run first) -> (h, w) uint8
    mask; ``ValueError`` if a count is negative or the runs overflow the
    mask."""
    lib = load_maskops()
    c = np.ascontiguousarray(counts, np.int64)
    out = np.empty((h, w), np.uint8)
    rc = lib.rle_counts_to_mask(
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(c), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        raise ValueError(f"RLE counts do not fit a {h}x{w} mask")
    return out


def rle_decode_native(rle_str: str, h: int, w: int) -> np.ndarray:
    """COCO compressed RLE string -> (h, w) uint8 mask; ``ValueError`` on a
    malformed string."""
    lib = load_maskops()
    try:
        raw = rle_str.encode("ascii")
    except UnicodeEncodeError as e:
        raise ValueError("a compressed RLE string is ASCII") from e
    out = np.empty((h, w), np.uint8)
    max_counts = len(raw) + 8
    scratch = np.empty(max_counts, np.int64)
    rc = lib.rle_decode(
        raw, len(raw), h, w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        scratch.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), max_counts)
    if rc != 0:
        raise ValueError(f"malformed compressed RLE for a {h}x{w} mask")
    return out
