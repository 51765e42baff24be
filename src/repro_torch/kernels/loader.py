"""Build, load and count the hand-written CUDA kernels (no reference twin:
the JAX package had Pallas compile its kernels).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (every pointer and
the stream as ``c_void_p``).  The libraries go into ``kernels/build/``, which
``.gitignore`` lists, named by a hash of their source, so a library is reused
until its source changes.  The first use builds all four at once, one
``nvcc`` process per source, started together.  A failed build raises with
the compiler's output; nothing falls back.

``LAUNCHES`` counts kernel launches by kernel name, and ``ENTRY_LAUNCHES``
the same launches by C entry point (a kernel's entries: the bitonic kernel's
sort and merge, for instance).  Each wrapper adds one where it launches its
kernel and nowhere else; ``reset_launch_counts`` zeroes both, so a caller
can show that a run went through the kernels.  ``BUILDS`` counts the
libraries ``build_all`` compiled, by source (the rebuild detector's input,
``obs.KernelWatch``).

``TIMING`` is the observability hook (``kernels.ops.set_observability``):
``None`` when observability is off, when it is on a list that each launch
appends ``(kernel, entry, start, end)`` to — two CUDA events recorded on
the launch's stream right before and right after the C call, so the launch
gains no synchronisation.  ``kernels.ops.flush_kernel_timings`` reads the
pairs once the device has passed them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("pq_adt", "pq_lookup", "bitonic_topk", "l2_rerank")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {name: 0 for name in ("pq_adt", "pq_lookup", "bitonic_sort_pairs",
                                 "l2_rerank")}
ENTRY_LAUNCHES: dict = {}
BUILDS = {name: 0 for name in KERNELS}
TIMING = None            # None, or [(kernel, entry, start, end)] (see above)

_libs: dict = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ENTRY_LAUNCHES.clear()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): cannot build "
                           "the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((_CSRC / f"{name}.cu").read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> dict:
    """Compile every kernel library that is missing, all in parallel.
    Returns {name: ptxas report} for the libraries built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in KERNELS if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = _lib_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, _lib_path(name))
            BUILDS[name] += 1
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel source ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        if not _lib_path(name).exists():
            build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def launch(lib_name: str, entry: str, counter: str, device, *args) -> None:
    """Call C entry ``entry`` of library ``lib_name`` on ``device`` with
    ``args`` — ``ctypes`` values: ``c_void_p`` for pointers and the stream,
    ``c_int`` for sizes — raise if it reports an error, else count one
    launch of ``counter``."""
    import torch

    lib = library(lib_name)
    fn = getattr(lib, entry)
    fn.argtypes = [type(a) for a in args]
    fn.restype = ctypes.c_int
    timing = TIMING
    with torch.cuda.device(device):
        if timing is None:
            err = fn(*args)
        else:
            s = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(s)
            err = fn(*args)
            end.record(s)
    if err:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{entry} failed to launch: {msg} (error {err})")
    if timing is not None:
        timing.append((counter, entry, start, end))
    LAUNCHES[counter] += 1
    ENTRY_LAUNCHES[entry] = ENTRY_LAUNCHES.get(entry, 0) + 1


def check(t, name: str, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank
    ``ndim`` — what every kernel takes as a raw pointer."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got "
                         f"one on {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous tensor")


def c_int(x: int) -> ctypes.c_int:
    return ctypes.c_int(int(x))


def ptr(t) -> ctypes.c_void_p:
    """The tensor's device address; null for an absent optional input."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
