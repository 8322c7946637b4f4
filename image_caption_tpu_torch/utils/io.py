"""Pickle and hickle-compatible array reading.

The reference caches features as hickle (HDF5) arrays and metadata as
pickles (``core/utils.py:17-64``).  ``load_hkl``/``open_hkl`` read that
format through ``h5py``: hickle v3/v4 store a single numpy array as an HDF5
dataset, named ``data`` or ``data_0``, at the root or under a ``data`` group.
``h5py`` is imported inside the functions, so the package imports on a
machine without it.
"""

from __future__ import annotations

import pickle
from typing import Any

import numpy as np


def load_pickle(path: str) -> Any:
    """Unpickle a file the data pipeline wrote (pickle runs code: trusted
    files only)."""
    with open(path, "rb") as f:
        return pickle.load(f)


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
