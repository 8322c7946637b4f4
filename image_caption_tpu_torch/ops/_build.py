"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``image_caption_tpu_torch/_build/`` and loaded with ``ctypes``.  The
library's file name carries a hash of the source and the flags, so a
changed source is rebuilt.  A failed build raises with the compiler's
output; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("fused_attention", "fused_attention_bwd", "fused_bottleneck")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin or /usr/local/cuda/bin); the "
        "CUDA kernels build only where the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    source = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns each built
    source's compiler output (register and shared-memory use from
    ``-Xptxas -v``); a source already built maps to ''."""
    todo = {n: library_path(n) for n in names}
    logs = {n: "" for n, p in todo.items() if p.exists()}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return logs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for name, path in todo.items():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        for name, (proc, tmp, path) in procs.items():
            output, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for csrc/{name}.cu "
                    f"(exit {proc.returncode}):\n{output}")
            os.replace(tmp, path)     # atomic: a reader never sees half a .so
            logs[name] = output
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _loaded:
        build((name,))
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
