"""Host-side image loading: decode and letterbox to uint8 canvases.

The counterpart of the JAX package's ``vision/loader.py``, with the same
two interchangeable routes behind one batch API:

* **native**: ``csrc/image_loader.cpp`` (the port's copy of the JAX
  package's loader), built by ``g++`` at first use into ``_build/``
  (``ops/_build.py``) and bound with ctypes: libjpeg decode, a
  Pillow-bit-exact bilinear resample and the letterbox, on C++ threads
  outside the GIL.  Bit-identical to the PIL route
  (``tests/test_torch_native_loader.py``), so a dataset may be extracted
  half by one route and half by the other.
* **PIL**: per image, for every image when ``ICX_NATIVE_LOADER=0``, and
  for any image the native decoder rejects (non-JPEG, truncated, CMYK:
  it reports per-image ``ok`` flags).

If the native library cannot be built or loaded, a ``RuntimeWarning``
names the error and the PIL route loads everything; the two routes give
the same canvases, so this changes the loader's speed only.  A canvas is
the image resized with PIL's bilinear filter and centred on gray (114),
or, for the ultralytics rectangular letterbox, placed at the top-left
with the rect's size in its meta.
"""

from __future__ import annotations

import ctypes
import os
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops import _build
from .ops import letterbox_params, letterbox_params_rect

FILL = 114

_lib = None
_lib_checked = False


def _native_lib():
    """The native loader, built and loaded once; None when switched off by
    ``ICX_NATIVE_LOADER=0`` or when it cannot be built or loaded (with a
    ``RuntimeWarning`` that names the error)."""
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    _lib_checked = True
    if os.environ.get("ICX_NATIVE_LOADER", "1") == "0":
        return None
    try:
        lib = _build.load("image_loader")
        fn = lib.icx_load_letterboxed_batch
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = None
        _lib = lib
    except (OSError, RuntimeError, AttributeError) as exc:
        # OSError: an unloadable library; RuntimeError: the build failed
        # (no g++ or no jpeglib.h); AttributeError: the symbol is missing
        warnings.warn(f"the native image loader is unavailable ({exc}); "
                      "images load through PIL", RuntimeWarning,
                      stacklevel=2)
    return _lib


def native_available() -> bool:
    return _native_lib() is not None


def load_letterboxed(path: str, size: int = 640, rect: bool = False,
                     stride: int = 32
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode and letterbox one image with PIL -> (canvas [S, S, 3] uint8,
    meta, (h, w) float32); meta is [scale, top, left], or [scale, top,
    left, rect_h, rect_w] for the rectangular letterbox."""
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB")
        w, h = im.size
        if rect:
            r, nh, nw, top, left, rect_h, rect_w = letterbox_params_rect(
                h, w, size, stride)
        else:
            r, nh, nw, top, left = letterbox_params(h, w, size)
        resized = im.resize((nw, nh), Image.BILINEAR)
    canvas = np.full((size, size, 3), FILL, np.uint8)
    canvas[top:top + nh, left:left + nw] = np.asarray(resized, np.uint8)
    meta = (np.asarray([r, top, left, rect_h, rect_w], np.float32) if rect
            else np.asarray([r, top, left], np.float32))
    return canvas, meta, np.asarray([h, w], np.float32)


def load_letterboxed_batch(paths: Sequence[str], size: int = 640, *,
                           rect: bool = False, stride: int = 32,
                           nthreads: Optional[int] = None,
                           io_pool=None, return_ok: bool = False):
    """Decode and letterbox a batch -> (canvases [N, S, S, 3] uint8, metas
    [N, 3|5] f32, sizes [N, 2] f32[, ok [N] bool]).

    The native route decodes on ``nthreads`` C++ threads (default
    ``os.cpu_count()``) and hands what it rejects to PIL; the PIL route
    maps the images over ``io_pool`` (an executor) when given.
    ``return_ok=True`` isolates failures: an unreadable image yields a gray
    canvas, an identity meta and ``ok=False``.  Otherwise it raises."""
    n = len(paths)
    meta_dim = 5 if rect else 3

    def blank():
        meta = np.zeros((meta_dim,), np.float32)
        meta[0] = 1.0
        if rect:
            meta[3:] = size
        return (np.full((size, size, 3), FILL, np.uint8), meta,
                np.asarray([size, size], np.float32))

    def load_pil(p):
        try:
            return load_letterboxed(p, size, rect=rect, stride=stride), True
        except Exception:   # any decode failure: PIL raises many kinds
            if not return_ok:
                raise
            return blank(), False

    if n == 0:
        out = (np.zeros((0, size, size, 3), np.uint8),
               np.zeros((0, meta_dim), np.float32),
               np.zeros((0, 2), np.float32))
        return out + (np.zeros((0,), bool),) if return_ok else out
    mapper = io_pool.map if io_pool is not None else map
    lib = _native_lib()
    if lib is None:
        loaded = list(mapper(load_pil, paths))
        out = (np.stack([c for (c, _, _), _ in loaded]),
               np.stack([m for (_, m, _), _ in loaded]),
               np.stack([z for (_, _, z), _ in loaded]))
        return out + (np.asarray([k for _, k in loaded]),) if return_ok \
            else out

    canvases = np.zeros((n, size, size, 3), np.uint8)
    metas = np.zeros((n, 5), np.float32)
    sizes = np.zeros((n, 2), np.float32)
    ok = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.icx_load_letterboxed_batch(
        arr, n, size, int(rect), stride,
        nthreads or os.cpu_count() or 8,
        canvases.ctypes.data_as(ctypes.c_void_p),
        metas.ctypes.data_as(ctypes.c_void_p),
        sizes.ctypes.data_as(ctypes.c_void_p),
        ok.ctypes.data_as(ctypes.c_void_p))
    failed = np.nonzero(ok == 0)[0]
    good = np.ones((n,), bool)
    for i, ((c, m, z), k) in zip(failed, mapper(
            load_pil, [paths[i] for i in failed])):
        canvases[i], sizes[i] = c, z
        metas[i, :m.shape[0]] = m
        good[i] = k
    if return_ok:
        return canvases, metas[:, :meta_dim], sizes, good
    return canvases, metas[:, :meta_dim], sizes
