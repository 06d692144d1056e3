"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded with ``ctypes``: a file that
does not include PyTorch's headers builds in seconds, where
``torch.utils.cpp_extension.load`` takes minutes.  Libraries land in
``dist_keras_tpu_torch/_build/`` (ignored by git) under a name that
carries the hash of the sources and flags, so a library is rebuilt only
when its source (or a shared header) changes; the compiler's output
(ptxas's register and spill lines) is kept beside it, read by
:func:`build_log`.  Nothing builds at import:
the first launch of a kernel builds it, and :func:`build` builds several
at once, one ``nvcc`` process per source, all started together.

A failed build raises :class:`KernelBuildError` with the compiler's
output.  Every C entry point returns ``cudaGetLastError()`` after its
launch; :func:`check` turns a non-zero code into ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LIBS = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """``nvcc`` failed, or is missing; carries the compiler output."""


def nvcc_path():
    """``nvcc`` from ``CUDA_HOME``, then ``PATH``, then the toolkit's
    default install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise KernelBuildError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "kernels are built from dist_keras_tpu_torch/csrc on first use")


def _digest(name):
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name):
    """Where the library built from ``csrc/<name>.cu`` lives."""
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def _log_path(name):
    return library_path(name).with_suffix(".log")


def build_log(name):
    """The compiler output of the library built from ``csrc/<name>.cu``."""
    return _log_path(name).read_text()


def build(names):
    """Build every library in ``names`` that is missing, one ``nvcc``
    per source, all in parallel.  -> {name: (seconds, compiler log)}
    for the ones built now (empty when all were built already)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and _log_path(name).exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out, time.perf_counter())
    built, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        _log_path(name).write_text(log)
        os.replace(tmp, out)   # atomic: a reader never sees half a file
        built[name] = (time.perf_counter() - t0, log)
    if failed:
        raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
    return built


def load(name, signatures):
    """The ``ctypes`` handle of ``csrc/<name>.cu``, built if needed.

    ``signatures`` maps each C entry point to its ``argtypes``; every
    entry point returns an ``int`` CUDA error code."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            # dklint: ignore[blocking-under-lock] the build is the critical
            # section: _LOCK makes first use build each library once, and every
            # other acquirer needs the library being built
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.dk_error_string.argtypes = [ctypes.c_int]
            lib.dk_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(lib, code, what):
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.dk_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg}) at launch")


def stream_handle(device):
    """The current CUDA stream of ``device`` as a ``c_void_p``."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
