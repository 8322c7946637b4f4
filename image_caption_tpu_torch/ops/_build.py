"""Build and load the port's native libraries.

Each ``csrc/<name>.cu`` has a plain C interface.  At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``image_caption_tpu_torch/_build/`` and loaded with ``ctypes``.  The host
libraries ``csrc/ngram_rewards.cpp`` (the RL reward scorer) and
``csrc/image_loader.cpp`` (JPEG decode and letterbox, linked with
``-pthread -ljpeg``) are compiled the same way by ``g++``.  A library's
file name carries a hash of its source, of every ``csrc/*.cuh`` header
(CUDA sources only) and of its flags, so a changed source, header or flag
is rebuilt.  A failed build raises with the compiler's output; the
callers decide what that means (a kernel has no fallback).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
KERNELS = ("fused_attention", "fused_attention_bwd", "fused_bottleneck")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
# each host library's own flags: before the source, and the libraries it
# links after it
HOST_LIBS = {"ngram_rewards": ((), ()),
             "image_loader": (("-pthread",), ("-ljpeg",))}

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


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError(
        "g++ not found on PATH; the host libraries (csrc/*.cpp: the reward "
        "scorer, the image loader) need a host C++ compiler")


def source_path(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_LIBS else f"{name}.cu")


def library_path(name: str) -> Path:
    """``_build/lib<name>-<hash>.so``: the hash covers the source, the
    flags and, for a CUDA source, the bytes of every ``csrc/*.cuh``."""
    h = hashlib.sha256(source_path(name).read_bytes())
    if name in HOST_LIBS:
        flags, libs = HOST_LIBS[name]
        h.update(" ".join((*GXX_FLAGS, *flags, *libs)).encode())
    else:
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> List[str]:
    if name in HOST_LIBS:
        flags, libs = HOST_LIBS[name]
        return [_gxx(), *GXX_FLAGS, *flags, "-o", str(out),
                str(source_path(name)), *libs]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(source_path(name))]


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    compiler per source, all started together.  Returns each built
    source's compiler output (for a CUDA source, register and
    shared-memory use from ``-Xptxas -v``); a source already built maps to
    ''."""
    todo = {n: library_path(n) for n in names}
    logs = {n: "" for n, p in todo.items() if p.exists()}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return logs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name, path in todo.items():
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, path)
        for name, (proc, tmp, path) in procs.items():
            output, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{Path(proc.args[0]).name} failed for "
                    f"csrc/{source_path(name).name} "
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
    """The loaded library ``name``, built first if needed."""
    if name not in _loaded:
        build((name,))
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
