"""Builds the port's CUDA kernels on first use and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` (Hopper). All sources
compile at once, one ``nvcc`` process each. The libraries go to
``<package>/build/`` (listed in ``.gitignore``) under a name that carries
a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads at once. A failed build raises with the compiler's
output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
SOURCES = ("graph_encode", "edge_mlp", "conv_head", "train_conv_fwd",
           "train_conv_bwd", "fused_gkn")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-ldl")

_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def load_kernels() -> dict[str, ctypes.CDLL]:
    """Build what is missing (in parallel) and load every library."""
    if _libs:
        return _libs
    BUILD.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    jobs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    failed = []
    for name, (proc, tmp, so) in jobs.items():
        try:
            out, _ = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for p, _, _ in jobs.values():
                p.kill()
            raise
        _logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name, so in targets.items():
        _libs[name] = ctypes.CDLL(str(so))
    return _libs


def build_logs() -> dict[str, str]:
    """nvcc's output (ptxas register and shared-memory use) of the
    libraries this process built."""
    return dict(_logs)
