"""ctypes bindings to the native batch packer
(``molecular_dynamics_neural_operator_tpu/data/packing.py``).

``csrc/packing.cpp`` (the port's copy) is a host helper, not a kernel: it
is built with the host C++ compiler on first use, ``g++ -O3 -fPIC
-shared -std=c++17``, into the package's ``build/`` under a name that
carries a hash of the source and flags, and loaded with ctypes. Its
three functions give the same arrays as the numpy path of
``data/windows.py``. When there is no compiler or the build fails,
``available()`` is False, ``load_error()`` says why, each function
returns None and ``WindowDataset`` takes the numpy path, as in the JAX
package; the dataset logs which path it takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

PACKAGE = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE / "csrc" / "packing.cpp"
BUILD = PACKAGE / "build"
FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _target() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD / f"packing-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed for packing.cpp:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, so)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            so = _target()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            i64, p = ctypes.c_int64, ctypes.POINTER
            lib.pack_dense_batch.argtypes = [
                p(ctypes.c_int32), i64, p(i64), p(i64), i64, i64,
                p(ctypes.c_float)]
            lib.pack_dense_batch.restype = None
            lib.pack_padded_batch.argtypes = [
                p(ctypes.c_int32), i64, p(i64), p(i64), i64, i64,
                p(ctypes.c_int32), p(ctypes.c_float)]
            lib.pack_padded_batch.restype = i64
            lib.gather_windows.argtypes = [
                p(ctypes.c_float), i64, p(i64), i64, i64, p(ctypes.c_float)]
            lib.gather_windows.restype = None
            _lib = lib
        except Exception as exc:  # noqa: BLE001: the numpy path takes over
            _error = f"{type(exc).__name__}: {exc}"
        return _lib


def available() -> bool:
    """True once the library is built and loaded."""
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library is not available (None when it is)."""
    _load()
    return _error


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _csr(edges_flat, offsets, idx):
    return (np.ascontiguousarray(edges_flat, np.int32),
            np.ascontiguousarray(offsets, np.int64),
            np.ascontiguousarray(idx, np.int64))


def pack_dense_batch(edges_flat: np.ndarray, offsets: np.ndarray,
                     idx: np.ndarray, r: int) -> Optional[np.ndarray]:
    """(B, r, r) f32 contact maps of frames ``idx``: 1 at [src, dst] of
    each stored edge. None when the library is not available."""
    lib = _load()
    if lib is None:
        return None
    edges_flat, offsets, idx = _csr(edges_flat, offsets, idx)
    out = np.empty((len(idx), r, r), np.float32)
    lib.pack_dense_batch(
        _ptr(edges_flat, ctypes.c_int32), edges_flat.shape[1],
        _ptr(offsets, ctypes.c_int64), _ptr(idx, ctypes.c_int64),
        len(idx), r, _ptr(out, ctypes.c_float))
    return out


def pack_padded_batch(edges_flat: np.ndarray, offsets: np.ndarray,
                      idx: np.ndarray, e_max: int):
    """(edges (B, 2, e_max) int32, mask (B, e_max) f32) of frames ``idx``,
    each frame's stored edges front to back. Raises ``ValueError`` when a
    frame holds more than ``e_max`` edges, as the numpy path does. None
    when the library is not available."""
    lib = _load()
    if lib is None:
        return None
    edges_flat, offsets, idx = _csr(edges_flat, offsets, idx)
    edges = np.empty((len(idx), 2, e_max), np.int32)
    mask = np.empty((len(idx), e_max), np.float32)
    max_count = lib.pack_padded_batch(
        _ptr(edges_flat, ctypes.c_int32), edges_flat.shape[1],
        _ptr(offsets, ctypes.c_int64), _ptr(idx, ctypes.c_int64),
        len(idx), e_max, _ptr(edges, ctypes.c_int32),
        _ptr(mask, ctypes.c_float))
    if max_count > e_max:
        raise ValueError(
            f"stored edge count {max_count} exceeds max_edges {e_max}")
    return edges, mask


def gather_windows(positions: np.ndarray, idx: np.ndarray,
                   window: int) -> Optional[np.ndarray]:
    """(B, window, R, 3) f32: positions[idx[b] : idx[b] + window]. The
    caller keeps every idx[b] + window within the frames. None when the
    library is not available."""
    lib = _load()
    if lib is None:
        return None
    positions = np.ascontiguousarray(positions, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    r = positions.shape[1]
    out = np.empty((len(idx), window, r, 3), np.float32)
    lib.gather_windows(
        _ptr(positions, ctypes.c_float), r, _ptr(idx, ctypes.c_int64),
        len(idx), window, _ptr(out, ctypes.c_float))
    return out
