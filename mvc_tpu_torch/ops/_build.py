"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/mvc_tpu_torch/lib<name>-<hash>.so`` at the root
of the checkout (``build/`` is git-ignored).  The file name carries a hash
of the sources and flags, so an edited kernel is rebuilt and a built one is
reused.  Nothing is built when a module is imported: the CPU tests import
every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mvc_tpu_torch"
KERNELS = ("dual_greedy", "beam", "greedy")  # every csrc/<name>.cu
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class KernelBuildError(RuntimeError):
    """nvcc failed (or is missing); the message holds its output."""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise KernelBuildError(f"nvcc not found at {path} (set CUDA_HOME)")
    return path


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu; returns (target, tmp, process) or None
    when the library is already built."""
    target = _library_path(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, started) -> str:
    target, tmp, proc = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)        # atomic: concurrent builders race harmlessly
    return out


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named sources, one nvcc each, all started together.
    Returns each source's compiler output ('' when already built)."""
    names = list(names)
    started = {n: _start(n) for n in names}
    return {n: (_finish(n, s) if s is not None else "") for n, s in started.items()}


_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _loaded[name] = lib
        return lib

