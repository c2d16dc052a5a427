"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<stem>.cu`` has a plain C interface and is compiled by ``nvcc``
on its own into a shared library for Hopper (``sm_90a``), then loaded with
``ctypes``.  No PyTorch header is involved, so a build takes seconds, not
minutes.  Libraries land in ``build/repro_torch_kernels/`` at the root of
the checkout, named by a hash of their sources (shared headers included)
and flags, so an unchanged source is never rebuilt and an edited one never
loads a stale library.

The first kernel call builds every missing library at once, one ``nvcc``
process per source, all started together.  A failed build raises
:class:`~repro_torch.errors.KernelBuildError`; nothing falls back to a
kernel's PyTorch twin.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from repro_torch.errors import KernelBuildError
from repro_torch.tracing import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("bvss_pull", "bvss_push", "frontier_finalize", "bvss_spmm",
           "bvss_spmm_w", "bvss_spmm_t", "bvss_spmm_minplus", "bit_spmm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else the toolkit that
    PyTorch found (``CUDA_HOME``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelBuildError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "kernels cannot be built")


def library_path(stem: str) -> Path:
    """Where ``csrc/<stem>.cu`` builds to: keyed by the bytes of the source,
    of every shared header in ``csrc/`` and of the flags."""
    h = hashlib.sha256((CSRC / f"{stem}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def build_all() -> None:
    """Compile every source whose library is missing, in parallel, inside
    a ``kernels.build`` span (none when everything was already built)."""
    todo = [s for s in SOURCES if not library_path(s).exists()]
    if todo:
        with span("kernels.build"):
            _compile(todo)


def _compile(todo: list[str]) -> None:
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for stem in todo:
        out = library_path(stem)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            for _, started, _, _ in jobs:
                started.kill()
                started.wait()
            raise KernelBuildError(f"cannot run {compiler}: {e}") from e
        jobs.append((stem, proc, tmp, out))
    failures = []
    for stem, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{stem}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise KernelBuildError("nvcc failed for " + "\n".join(failures))


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            build_all()
            try:
                with span("kernels.load"):
                    lib = ctypes.CDLL(str(library_path(stem)))
            except OSError as e:
                raise KernelBuildError(
                    f"cannot load the {stem} kernel library: {e}") from e
            _libs[stem] = lib
        return lib


def bind(stem: str, name: str, argtypes: list) -> ctypes._CFuncPtr:
    """Entry point ``name`` of ``csrc/<stem>.cu`` with its C signature set
    (pointers and the stream as ``c_void_p``, sizes as ``c_longlong``)."""
    fn = _fns.get((stem, name))
    if fn is None:
        fn = getattr(library(stem), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(stem, name)] = fn
    return fn


def check(stem: str, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError()``)."""
    if err != 0:
        msg_fn = getattr(library(stem), f"{stem}_error_string")
        msg_fn.argtypes = [ctypes.c_int]
        msg_fn.restype = ctypes.c_char_p
        raise KernelBuildError(
            f"{what} launch failed: CUDA error {err} "
            f"({msg_fn(err).decode()})")


def count(entry) -> None:
    """Add one launch to ``entry.launches``.  Under a lock: the request
    queue's pump thread launches kernels beside the caller's thread, and
    ``+=`` on an attribute is not atomic."""
    with _count_lock:
        entry.launches += 1
