"""CSV ingestion — counterpart of ``data/csv.py``.

The reference reads CSVs through Spark (``examples/mnist.py`` loads
MNIST CSVs into a DataFrame).  Here ingestion happens on the host: the
port's own native C++ parser (``data/native/fastcsv.cpp``, built with
``g++`` at first use and loaded through ``ctypes``) scans the file once
into an opaque handle, then parses rows multi-threaded straight into a
numpy-preallocated float32 matrix (no extra copy).

The fallback, when the library cannot be built or loaded or the native
reader raises, is numpy, not pandas as in the JAX package: the card's
host has no pandas, and a pandas ``ImportError`` there would hide the
native reader's own error.  It is audible (one stderr warning per
process) and reads as the pandas fallback reads: blank lines skipped,
an empty field NaN, a short row padded with NaN; a row with more fields
than the first line is cut to it, as the native reader cuts it.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np

from dist_keras_tpu_torch.data.dataset import Dataset


def _native_lib():
    from dist_keras_tpu_torch.data.native import load_fastcsv
    return load_fastcsv()


_native_warned = False


def _warn_native_once(why):
    """One stderr warning per process when the native reader is missing
    or fails and the numpy fallback takes over."""
    global _native_warned
    if _native_warned:
        return
    _native_warned = True
    print(f"[dk.data] WARNING: native CSV reader {why} - falling back to "
          "numpy", file=sys.stderr, flush=True)


def read_numeric_csv(path, has_header=True, dtype=np.float32):
    """Parse an all-numeric CSV into (matrix, column_names)."""
    lib = _native_lib()
    if lib is None:
        _warn_native_once("unavailable (fastcsv.cpp did not build or load)")
    else:
        try:
            return _read_native(lib, path, has_header, dtype)
        # dklint: ignore[broad-except] audible full-fidelity numpy fallback
        except Exception as e:
            _warn_native_once(f"failed ({e!r})")
    return _read_numpy(path, has_header, dtype)


def _read_native(lib, path, has_header, dtype):
    with open(path, "rb") as f:
        header = f.readline() if has_header else b""
    names = ([c.strip() for c in header.decode().strip().split(",")]
             if has_header else None)

    rows = ctypes.c_longlong()
    cols = ctypes.c_longlong()
    handle = lib.fastcsv_scan(str(path).encode(), int(has_header),
                              ctypes.byref(rows), ctypes.byref(cols))
    if not handle:
        raise IOError(f"fastcsv_scan failed on {path}")
    out = np.empty((rows.value, cols.value), dtype=np.float32)
    if rows.value == 0 or cols.value == 0:
        lib.fastcsv_release(handle)
    else:
        # extract frees the handle (success or failure)
        rc = lib.fastcsv_extract(
            handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            rows.value, cols.value)
        if rc != 0:
            raise IOError(f"fastcsv_extract failed rc={rc} on {path}")
    if names is None:
        names = [f"c{i}" for i in range(cols.value)]
    return out.astype(dtype, copy=False), names


def _read_numpy(path, has_header, dtype):
    """The fallback reader: every field through numpy's float parse."""
    with open(path) as f:
        lines = f.read().splitlines()
    names = None
    if has_header:
        header, lines = (lines[0] if lines else ""), lines[1:]
        names = [c.strip() for c in header.strip().split(",")]
    rows = [[v.strip() or "nan" for v in line.split(",")]
            for line in lines if line.strip(" \t\r")]
    width = (len(names) if names is not None
             else len(rows[0]) if rows else 0)
    rows = [r[:width] + ["nan"] * (width - len(r)) for r in rows]
    text = np.array(rows, dtype=str).reshape(len(rows), width)
    out = text.astype(np.float64).astype(dtype)
    if names is None:
        names = [f"c{i}" for i in range(width)]
    return out, names


def read_csv(path, features=None, label=None, features_col="features",
             label_col="label", has_header=True):
    """CSV -> Dataset.

    ``features``: list of column names (default: all but ``label``).
    ``label``: label column name (default: last column).
    """
    mat, names = read_numeric_csv(path, has_header=has_header)
    if label is None:
        label = names[-1]
    if features is None:
        features = [n for n in names if n != label]
    fidx = [names.index(c) for c in features]
    lidx = names.index(label)
    return Dataset({
        features_col: mat[:, fidx],
        label_col: mat[:, lidx],
    })
