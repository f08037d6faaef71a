"""ctypes bindings for the native IO runtime (native/splatloc_io.cpp).

The PNG readers, the PLY reader and writer and the threaded frame
prefetcher of ``splatloc_tpu.data.native_io``, copied (the port imports
nothing of the JAX package): the dataset loaders and ``scene/ply.py`` call
the readers and the writer; ``FramePrefetcher`` has no caller, as in the
JAX package. ``native/`` is a C library of the repository, not a module of
the JAX package, so the port loads the same ``libsplatloc_io.so``. It is
built on first use if missing (g++ with libpng); every reader and writer
has a pure-Python fallback, so the port works without the native layer —
it is the fast path, not a dependency.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libsplatloc_io.so"))
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH):
            src = os.path.join(_NATIVE_DIR, "splatloc_io.cpp")
            if not os.path.exists(src):
                return None
            try:
                subprocess.run(
                    ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", src,
                     "-lpng", "-lz", "-lpthread", "-o", _LIB_PATH],
                    check=True, capture_output=True, timeout=120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.sl_png_read_rgb8.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                         ctypes.c_int, ctypes.c_int]
        lib.sl_png_read_u16.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_int]
        lib.sl_ply_read_header.restype = ctypes.c_longlong
        lib.sl_ply_read_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
            ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        lib.sl_ply_read_f32.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                        ctypes.c_void_p, ctypes.c_longlong]
        lib.sl_ply_write_f32.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                         ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_longlong]
        lib.sl_loader_create.restype = ctypes.c_void_p
        lib.sl_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int]
        lib.sl_loader_get.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p, ctypes.c_void_p]
        lib.sl_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def png_read_rgb(path: str, width: int, height: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.sl_png_read_rgb8(path.encode(), out.ctypes.data, width, height)
    return out if rc == 0 else None


def png_read_depth16(path: str, width: int, height: int) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    out = np.empty((height, width), np.uint16)
    rc = lib.sl_png_read_u16(path.encode(), out.ctypes.data, width, height)
    return out if rc == 0 else None


def ply_read_f32(path: str):
    """-> (names list, data [N, P] float32) or None."""
    lib = _load()
    if lib is None:
        return None
    n_props = ctypes.c_int()
    offset = ctypes.c_longlong()
    buf = ctypes.create_string_buffer(8192)
    n = lib.sl_ply_read_header(path.encode(), ctypes.byref(n_props), buf,
                               len(buf), ctypes.byref(offset))
    if n < 0:
        return None
    names = buf.value.decode().strip().split("\n")
    data = np.empty((n, n_props.value), np.float32)
    rc = lib.sl_ply_read_f32(path.encode(), offset.value, data.ctypes.data,
                             n * n_props.value)
    return (names, data) if rc == 0 else None


def ply_write_f32(path: str, names: list[str], data: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, np.float32)
    names_nl = ("\n".join(names) + "\n").encode()
    rc = lib.sl_ply_write_f32(path.encode(), names_nl, len(names),
                              data.ctypes.data, data.shape[0])
    return rc == 0


class FramePrefetcher:
    """Threaded read-ahead RGB-D decoding (the native data-loader runtime):
    ``n_threads`` workers decode up to ``read_ahead`` frames past the last
    one asked for. Frames should be consumed roughly in order; the
    read-ahead window advances with consumption. Raises RuntimeError where
    the native library is unavailable."""

    def __init__(self, rgb_paths, depth_paths, width, height,
                 n_threads: int = 4, read_ahead: int = 8):
        lib = _load()
        if lib is None:
            raise RuntimeError("native IO unavailable")
        self._lib = lib
        self.width, self.height = width, height
        n = len(rgb_paths)
        rgb_arr = (ctypes.c_char_p * n)(*[p.encode() for p in rgb_paths])
        dep_arr = (ctypes.c_char_p * n)(*[p.encode() for p in depth_paths])
        self._handle = lib.sl_loader_create(rgb_arr, dep_arr, n, width,
                                            height, n_threads, read_ahead)
        self._n = n

    def get(self, idx: int):
        """(rgb [H, W, 3] uint8, depth [H, W] uint16) of frame ``idx``."""
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        dep = np.empty((self.height, self.width), np.uint16)
        rc = self._lib.sl_loader_get(self._handle, idx, rgb.ctypes.data,
                                     dep.ctypes.data)
        if rc != 0:
            raise IOError(f"frame {idx} failed to decode")
        return rgb, dep

    def close(self):
        if self._handle:
            self._lib.sl_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
