"""Zstandard decompression (RFC 8878) through the port's own decoder,
``csrc/tecozstd.cpp``.

The JAX package's orbax checkpoints compress their OCDBT B-tree nodes and
their zarr chunks with zstd (``train/orbax_io.py``). Neither the GPU
machine nor Python 3.12's standard library has a zstd decoder, so the
port carries one: host C++17, built on first use with ``$CXX`` (else
``g++``) into the git-ignored ``tecogan_tpu_torch/_build/tecozstd-<hash>/``
through ``data/video_native.py:build_shared`` and bound with ctypes. A
failed build raises :class:`~tecogan_tpu_torch.data.video_native.VideoBuildError`
with the compiler's output; there is no Python fallback.

:func:`decompress` is the only entry point.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

_SOURCES = ("tecozstd.cpp",)
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17")
_LDFLAGS = ("-shared",)
_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}  # compiler -> library


class ZstdError(ValueError):
    """A zstd stream the decoder refuses: corrupt, truncated, larger than
    its frame says, or needing a dictionary."""


def load_library() -> ctypes.CDLL:
    """The decoder for ``$CXX`` (else g++), built on first use."""
    from tecogan_tpu_torch.data import video_native as vn

    compiler = vn._compiler()
    with _LOCK:
        lib = _LOADED.get(compiler)
        if lib is None:
            path = vn.build_shared(
                vn.shared_library_path("tecozstd", _SOURCES, _CXXFLAGS, _LDFLAGS, compiler),
                _SOURCES, _CXXFLAGS, _LDFLAGS, compiler)
            lib = ctypes.CDLL(str(path))
            lib.tz_last_error.restype, lib.tz_last_error.argtypes = ctypes.c_char_p, []
            lib.tz_decompress.restype = ctypes.c_int
            lib.tz_decompress.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t)]
            lib.tz_free.restype, lib.tz_free.argtypes = None, [ctypes.c_void_p]
            _LOADED[compiler] = lib
        return lib


def decompress(data: bytes) -> bytes:
    """The content of every frame in ``data``, concatenated (skippable
    frames skipped). Raises :class:`ZstdError` on anything it refuses."""
    lib = load_library()
    out, size = ctypes.c_void_p(), ctypes.c_size_t()
    if lib.tz_decompress(bytes(data), len(data), ctypes.byref(out), ctypes.byref(size)):
        raise ZstdError(f"zstd: {lib.tz_last_error().decode(errors='replace')}")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.tz_free(out)
