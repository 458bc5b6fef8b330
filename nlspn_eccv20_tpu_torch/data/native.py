"""ctypes bindings for the native data-loading core ``native/dataloader.cc``
(counterpart of ``nlspn_eccv20_tpu/data/native.py``; the C++ source is the
JAX package's, framework-neutral, and is read, never edited).

It gives threaded 16-bit depth-PNG decoding, RGB decoding with the ImageNet
normalisation fused in, and seeded sparse sampling. ``build`` compiles the
source with ``native/Makefile``'s flags into ``build/native/`` (or a
directory the caller names) under an exclusive ``fcntl.flock`` on that
directory's lock file, into a temporary file that ``os.replace`` then moves
into place: processes that build at the same time never load a half-written
library. Its name carries a hash of the source, the flags and the host
CPU (``-march=native``), so an edited source, or a copy of the directory
on another machine, builds anew.

Where the toolchain or libpng/libjpeg is missing, ``available()`` is False
and ``unavailable_reason()`` says why; the KITTI loader then decodes with
PIL, as the JAX package does. Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from typing import Dict, List, Optional

import numpy as np

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(REPO_ROOT, "native", "dataloader.cc")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")
# native/Makefile's CXXFLAGS and LDLIBS
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native"]
LDLIBS = ["-lpng", "-ljpeg", "-lz", "-lpthread"]

_FLOAT_P = ctypes.POINTER(ctypes.c_float)


def _cpu_identity() -> bytes:
    """The host CPU's model and feature flags: ``-march=native`` builds for
    them, so a library built on another machine is not this one's."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.machine().encode()
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(keep[:2])


def library_path(out_dir: str = BUILD_DIR) -> str:
    """The library's path: named by a hash of the source, the flags and the
    host CPU."""
    digest = hashlib.sha1(" ".join(CXXFLAGS + LDLIBS).encode())
    digest.update(_cpu_identity())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(out_dir, f"libnlspn_data-{digest.hexdigest()[:12]}.so")


def build(out_dir: str = BUILD_DIR, timeout: float = 120.0) -> str:
    """Compile ``native/dataloader.cc`` into ``out_dir`` unless its library
    is there already; returns the library's path. Raises ``OSError`` (no
    compiler) or ``subprocess.CalledProcessError`` (the compiler's
    output in ``stderr``)."""
    out = library_path(out_dir)
    if os.path.exists(out):
        return out
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):          # built while this process waited
            return out
        fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".so.tmp")
        os.close(fd)
        try:
            subprocess.run(["g++", *CXXFLAGS, "-shared", "-o", tmp, SOURCE,
                            *LDLIBS], check=True, capture_output=True,
                           text=True, timeout=timeout)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


class NativeLibrary:
    """The loaded library; each method checks its buffers' sizes and the
    C functions' return codes."""

    def __init__(self, path: str):
        lib = ctypes.CDLL(path)
        lib.nl_png_dims.argtypes = [ctypes.c_char_p,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.POINTER(ctypes.c_int)]
        lib.nl_png_dims.restype = ctypes.c_int
        for fn in (lib.nl_decode_depth_png, lib.nl_decode_rgb_norm):
            fn.argtypes = [ctypes.c_char_p, _FLOAT_P, ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
        for fn in (lib.nl_decode_depth_batch, lib.nl_decode_rgb_batch):
            fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                           _FLOAT_P, ctypes.c_int, ctypes.c_int, ctypes.c_int]
            fn.restype = ctypes.c_int
        lib.nl_sparse_sample.argtypes = [_FLOAT_P, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_uint64]
        lib.nl_sparse_sample.restype = ctypes.c_int
        self.path = path
        self._lib = lib

    def png_dims(self, path: str):
        h, w = ctypes.c_int(), ctypes.c_int()
        if self._lib.nl_png_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)):
            raise IOError(f"cannot read PNG header: {path}")
        return h.value, w.value

    def decode_depth_png(self, path: str) -> np.ndarray:
        """16-bit KITTI depth PNG -> float32 (H, W) meters."""
        h, w = self.png_dims(path)
        out = np.empty((h, w), np.float32)
        rc = self._lib.nl_decode_depth_png(path.encode(),
                                           out.ctypes.data_as(_FLOAT_P), h, w)
        if rc:
            raise IOError(f"depth PNG decode failed (rc={rc}): {path}")
        return out

    def decode_rgb_norm(self, path: str, h: int, w: int) -> np.ndarray:
        """8-bit RGB PNG/JPEG -> float32 (H, W, 3), ImageNet-normalised."""
        out = np.empty((h, w, 3), np.float32)
        rc = self._lib.nl_decode_rgb_norm(path.encode(),
                                          out.ctypes.data_as(_FLOAT_P), h, w)
        if rc:
            raise IOError(f"RGB decode failed (rc={rc}): {path}")
        return out

    def _batch(self, fn, paths: List[str], shape, num_threads: int, what: str):
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        out = np.empty((len(paths),) + shape, np.float32)
        bad = fn(arr, len(paths), out.ctypes.data_as(_FLOAT_P), shape[0],
                 shape[1], num_threads)
        if bad:
            raise IOError(f"{bad}/{len(paths)} {what} decodes failed")
        return out

    def decode_depth_batch(self, paths: List[str], h: int, w: int,
                           num_threads: int = 0) -> np.ndarray:
        """Threaded batch decode -> float32 (N, H, W)."""
        return self._batch(self._lib.nl_decode_depth_batch, paths, (h, w),
                           num_threads, "depth")

    def decode_rgb_batch(self, paths: List[str], h: int, w: int,
                         num_threads: int = 0) -> np.ndarray:
        """Threaded batch decode and normalise -> float32 (N, H, W, 3)."""
        return self._batch(self._lib.nl_decode_rgb_batch, paths, (h, w, 3),
                           num_threads, "RGB")

    def sparse_sample(self, dep: np.ndarray, num_sample: int,
                      seed: int) -> np.ndarray:
        """Keep ``num_sample`` random valid pixels of a (H, W[, 1]) plane."""
        out = np.array(dep, np.float32, order="C", copy=True)
        self._lib.nl_sparse_sample(out.ctypes.data_as(_FLOAT_P), out.size,
                                   num_sample, ctypes.c_uint64(seed))
        return out


_libs: Dict[str, NativeLibrary] = {}
_failures: Dict[str, str] = {}
_lock = threading.Lock()


def load(out_dir: str = BUILD_DIR) -> Optional[NativeLibrary]:
    """The library built into ``out_dir`` (built on first use), or None
    where it cannot be built or loaded; one attempt per directory and
    process."""
    with _lock:
        if out_dir in _libs or out_dir in _failures:
            return _libs.get(out_dir)
        try:
            _libs[out_dir] = NativeLibrary(build(out_dir))
        except subprocess.CalledProcessError as e:
            tail = (e.stderr or "").strip().splitlines()[-3:]
            _failures[out_dir] = f"g++ failed: {' | '.join(tail)}"
        except (OSError, subprocess.TimeoutExpired) as e:
            _failures[out_dir] = f"{type(e).__name__}: {e}"
        return _libs.get(out_dir)


def available(out_dir: str = BUILD_DIR) -> bool:
    return load(out_dir) is not None


def unavailable_reason(out_dir: str = BUILD_DIR) -> Optional[str]:
    """Why the library could not be built or loaded (None if it was)."""
    load(out_dir)
    return _failures.get(out_dir)


def decode_depth_png(path: str) -> np.ndarray:
    return load().decode_depth_png(path)
