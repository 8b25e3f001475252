"""Build and load the port's CUDA kernels.

All ``tecogan_tpu_torch/csrc/*.cu`` files are compiled by ``nvcc`` into one
shared library with a plain C interface, at first use, for Hopper
(``sm_90a``): one ``nvcc`` per source, all started together, then one
link. The library goes to ``tecogan_tpu_torch/_build/<hash>/``, keyed by a
hash of the sources and the flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. It is loaded with
``ctypes``: every entry point takes its pointers and the CUDA stream as
``void*`` and returns the ``cudaError_t`` of ``cudaGetLastError()`` after
its launches, which :func:`check` turns into an exception.

``nvcc`` is found through ``$CUDA_HOME/bin``, then ``PATH``, then
``/usr/local/cuda/bin``. Nothing here runs at import time. :func:`build`
and :func:`library` hold one lock: two threads of a process (a serving
bucket warmed in the background beside a serving tick) never build at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
_LIB_NAME = "libtecogan_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# Entry point -> argtypes; every entry point returns cudaError_t as int.
_SIGNATURES = {
    # (x, out, B, H, W, C, filter, alpha, stream)
    "tt_upsample4_f32": (_P, _P, _I, _I, _I, _I, _I, _F, _P),
    "tt_upsample4_bf16": (_P, _P, _I, _I, _I, _I, _I, _F, _P),
    # (g, dx, B, H, W, C, filter, alpha, stream); H, W are dx's sizes
    "tt_upsample4_bwd_f32": (_P, _P, _I, _I, _I, _I, _I, _F, _P),
    "tt_upsample4_bwd_bf16": (_P, _P, _I, _I, _I, _I, _I, _F, _P),
    # (x, buf_a, buf_b, w1, b1, w2, b2, B, H, W, N, stream)
    "tt_resblock_chain_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # (x, buf_a, buf_b, w1, b1, w2, b2, B, H, W, N, seg_rows, grid, stream)
    "tt_resblock_chain_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # (int* blocks): resident blocks per SM of the bfloat16 chain kernel
    "tt_resblock_chain_bf16_blocks_per_sm": (_P,),
    # (int* cluster_size, int* clusters): the float32 chain kernel's cluster
    # size and its clusters that can be resident on the card at once
    "tt_resblock_chain_f32_clusters": (_P, _P),
    # (surface, pitch, luma_rows, left, top, width, height, y_coeff, y_offset,
    # v2r, u2b, u2g, v2g, out, stream): NV12 -> RGB24 of the display area
    "tt_nv12_rgb": (_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    # (y, bias, out, B, H, W, C, stream); H, W are out's sizes, y has one more
    "tt_bias_relu_crop_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
    "tt_bias_relu_crop_bf16": (_P, _P, _P, _I, _I, _I, _I, _P),
    # (lr, image, flow, out, B, H, W, stream); H, W are image's
    "tt_warp_pack_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    "tt_warp_pack_bf16": (_P, _P, _P, _P, _I, _I, _I, _P),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _digest() / _LIB_NAME


_LOCK = threading.RLock()


def build(verbose: bool = False) -> Path:
    """Compile the sources unless a library for them exists; returns its
    path. ``verbose`` adds ``-Xptxas -v`` (registers, shared memory and
    spills per kernel) and prints the compiler's output."""
    with _LOCK:
        return _compile(verbose)


def _compile(verbose: bool) -> Path:
    out = library_path()
    if out.exists() and not verbose:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    ptxas = ("-Xptxas", "-v") if verbose else ()
    jobs = []  # nvcc reads an input's kind from its suffix: objects end in .o
    for src in _sources():
        obj = out.with_name(f"{src.stem}.{pid}.o")
        cmd = [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    outputs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in jobs]
    tmp = out.with_name(f"{out.name}.{pid}.tmp")
    link = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    try:
        for cmd, text, rc in outputs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(link)}"
                               f"\n{proc.stdout}\n{proc.stderr}")
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    if verbose:
        print("".join(text for _, text, _ in outputs), flush=True)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    with _LOCK:
        return _load()


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_compile(False)))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tt_error_string.argtypes = (ctypes.c_int,)
    lib.tt_error_string.restype = ctypes.c_char_p
    return lib


def build_and_load(verbose: bool = False) -> float:
    """Build (if needed) and load the library; returns the seconds taken."""
    t0 = time.perf_counter()
    build(verbose=verbose)
    library()
    return time.perf_counter() - t0


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = library().tt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
