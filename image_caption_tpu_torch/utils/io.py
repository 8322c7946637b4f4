"""Pickles, hickle-compatible arrays and ``.npy`` arrays.

The reference caches features as hickle (HDF5) arrays and metadata as
pickles (``core/utils.py:17-64``).  ``load_hkl``/``open_hkl``/``save_hkl``
speak that format through ``h5py``: hickle v3/v4 store a single numpy array
as an HDF5 dataset, named ``data`` or ``data_0``, at the root or under a
``data`` group; ``save_hkl`` writes a root-level ``data`` dataset.  ``h5py``
is imported inside the functions, so the package imports on a machine
without it.  A feature file may also be a plain ``.npy`` array, which needs
no ``h5py`` (``data/dataset.load_split`` reads either).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import numpy as np


def load_pickle(path: str) -> Any:
    """Unpickle a file the data pipeline wrote (pickle runs code: trusted
    files only)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(data: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(data, f, pickle.HIGHEST_PROTOCOL)


def _first_dataset(h5node):
    """Depth-first search for the first HDF5 dataset (hickle layout probe)."""
    import h5py
    if isinstance(h5node, h5py.Dataset):
        return h5node
    for key in ("data", "data_0"):
        if key in h5node:
            found = _first_dataset(h5node[key])
            if found is not None:
                return found
    for key in h5node:
        found = _first_dataset(h5node[key])
        if found is not None:
            return found
    return None


def load_hkl(path: str) -> np.ndarray:
    import h5py
    with h5py.File(path, "r") as f:
        ds = _first_dataset(f)
        if ds is None:
            raise ValueError(f"no dataset found in {path}")
        return np.asarray(ds[...])


class HklDataset:
    """Lazily sliced view over a hickle/HDF5 array, for splits too large to
    hold in RAM.  Supports slices, ints and arbitrary (unsorted, repeated)
    integer arrays: h5py fancy indexing needs increasing unique indices, so
    gathers go through a unique/inverse mapping.  Not thread-safe."""

    def __init__(self, path: str, dtype=None):
        import h5py
        self._file = h5py.File(path, "r")
        ds = _first_dataset(self._file)
        if ds is None:
            self._file.close()
            raise ValueError(f"no dataset found in {path}")
        self._ds = ds
        self._dtype = np.dtype(dtype) if dtype is not None else ds.dtype

    @property
    def shape(self):
        return self._ds.shape

    @property
    def dtype(self):
        return self._dtype

    def __len__(self) -> int:
        return self._ds.shape[0]

    def __getitem__(self, idx) -> np.ndarray:
        if isinstance(idx, (int, np.integer, slice)):
            out = self._ds[idx]
        else:
            idx = np.asarray(idx)
            uniq, inverse = np.unique(idx, return_inverse=True)
            out = self._ds[uniq.tolist()][inverse]
        return np.asarray(out, dtype=self._dtype)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._ds[...], dtype=dtype or self._dtype)

    def close(self) -> None:
        self._file.close()


def open_hkl(path: str, dtype=None) -> HklDataset:
    """Open a feature file for streamed (sliced) reads."""
    return HklDataset(path, dtype=dtype)


def save_hkl(array: np.ndarray, path: str,
             compression: Optional[str] = "gzip") -> None:
    """Write one array as a hickle-readable HDF5 file, one chunk per row so
    that streamed row gathers touch one chunk per image."""
    import h5py
    array = np.asarray(array)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    chunks = (1,) + array.shape[1:] if array.ndim >= 2 and len(array) \
        else None
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=array, compression=compression,
                         chunks=chunks)


def save_array(array: np.ndarray, path: str) -> None:
    """A feature file by its suffix: ``.npy`` through numpy, anything else
    as hickle (``save_hkl``)."""
    if path.endswith(".npy"):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.save(path, np.asarray(array))
    else:
        save_hkl(array, path)
