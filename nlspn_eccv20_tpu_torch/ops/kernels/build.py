"""Build the hand-written CUDA kernels and load them with ctypes.

Each ``nlspn_eccv20_tpu_torch/csrc/<name>.cu`` has a plain C interface and
is compiled on its own by ``nvcc`` for Hopper (``sm_90a``) into
``build/lib<name>-<hash>.so`` at the repository root (``BUILD_DIR``; a
persistent cache elsewhere with ``utils/compile_cache.py``), at first use. The hash
is that of the source and the flags, so an edited source builds anew and an
unchanged one is loaded as it is. ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them.

Nothing is compiled or loaded when this module is imported: the CPU tests
import every module on a machine that has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, List

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def kernel_names() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``, named by the hash of the source,
    the shared headers of ``csrc/`` and the flags."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def nvcc_command(name: str, out: str) -> List[str]:
    return [find_nvcc(), *NVCC_FLAGS, "-o", out,
            os.path.join(CSRC_DIR, f"{name}.cu")]


def build_all(names: Iterable[str] = ()) -> Dict[str, str]:
    """Compile the named sources (all of ``csrc/`` by default) in parallel.

    Returns {name: ptxas report}. A source whose library already exists is
    skipped. Raises with nvcc's output if any build fails.
    """
    names = list(names) or kernel_names()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = tempfile.NamedTemporaryFile(dir=BUILD_DIR, suffix=".so",
                                          delete=False).name
        procs[name] = (subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.

    ``signatures`` maps each C entry point to its ``argtypes``, or to
    ``(argtypes, restype)``; an entry without a restype returns an ``int``
    (a ``cudaError_t``).
    """
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build_all([name])
        lib = ctypes.CDLL(path)
        for fn, sig in signatures.items():
            argtypes, restype = sig if isinstance(sig, tuple) else (sig, ctypes.c_int)
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib


def check_launch(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with cudaError_t {err}")


def check_tensor(t, what: str, shape=None, device=None, dtype=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (float32
    by default) and ``shape`` (None entries match any size) on ``device``
    and on the current device, where the kernels launch (each data-parallel
    rank makes its own card current)."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.device.index != torch.cuda.current_device():
        raise ValueError(f"{what}: on {t.device}, but the kernels launch on the "
                         f"current device cuda:{torch.cuda.current_device()}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if shape is not None and (t.dim() != len(shape) or any(
            s is not None and s != n for s, n in zip(shape, t.shape))):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {shape}")
