"""Native CSV reader loader — the port's own copy of
``dist_keras_tpu/data/native``: builds ``fastcsv.cpp`` (beside this
file) with ``g++`` at first use.

The binding is a plain C ABI consumed through ``ctypes`` (see
``data/csv.py``).  The library lands in ``dist_keras_tpu_torch/_build/``
(ignored by git) as ``libfastcsv-<hash>.so``, the hash taken over the
source and the compiler flags as ``ops/_build.py`` keys the kernels, so
a source fix is never shadowed by a stale binary; the compiler's output
is kept beside it.  Only this package's source is ever built or loaded:
never a ``fastcsv-*.so`` of the JAX package.  A failed build degrades:
:func:`load_fastcsv` returns None and ``csv.py`` falls back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "fastcsv.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path():
    """Where the library built from ``fastcsv.cpp`` lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libfastcsv-{h.hexdigest()[:16]}.so"


def build_fastcsv(force=False):
    """Compile ``fastcsv.cpp`` into :func:`library_path`; -> the path,
    or None when ``g++`` is missing or fails (its output is kept in the
    ``.log`` beside the library's path)."""
    so = library_path()
    if so.exists() and not force:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        so.with_suffix(".log").write_text(f"{cmd}: {e!r}\n")
        return None
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, so)   # atomic: a reader never sees half a file
    return so


def load_fastcsv():
    """-> the ``ctypes`` library (building it if needed), or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        # dklint: ignore[blocking-under-lock] the lock serializes the
        # one-time g++ build (bounded by its 120 s timeout): a
        # concurrent caller parks behind the compile, never races it
        so = build_fastcsv()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        lib.fastcsv_scan.restype = ctypes.c_void_p
        lib.fastcsv_scan.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong)]
        lib.fastcsv_extract.restype = ctypes.c_int
        lib.fastcsv_extract.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_longlong, ctypes.c_longlong]
        lib.fastcsv_release.restype = None
        lib.fastcsv_release.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
