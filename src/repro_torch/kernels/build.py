"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded
with ``ctypes``.  Libraries are named by the hash of their source (and
the shared header), so an edited source is rebuilt and a stale library
is never loaded.  They land in ``build/cuda/`` at the checkout's root.

:class:`CudaKernel` is one C entry point of such a library: it checks
the ``cudaError_t`` the entry point returns and counts its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Sequence

import torch

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "CudaKernel",
           "build_all", "load_library", "require_cuda_f32",
           "require_cuda_tensor", "aligned_16", "smem_optin",
           "current_stream"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG)),
                         "build", "cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# every library under csrc/, one per kernel package
SOURCES = ("wami_debayer", "wami_grayscale", "wami_gradient", "wami_steep",
           "wami_warp", "wami_change_det", "flash_attention", "ssd_scan",
           "ssd_scan_bwd", "mamba_gate_norm", "mamba_causal_conv")
_HEADERS = ("kernel_export.cuh", "wami_common.cuh", "tf32_mma.cuh",
            "ssd_common.cuh")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (on PATH or /usr/local/cuda)")


def _lib_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + _HEADERS:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start_build(name: str) -> "tuple[subprocess.Popen, str, str]":
    out = _lib_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(proc: subprocess.Popen, tmp: str, out: str) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{os.path.basename(out)}:\n{log}")
    os.replace(tmp, out)     # atomic: a concurrent loader sees old or new


def build_all(names: Sequence[str] = SOURCES) -> List[str]:
    """Compile every library of ``names`` that is not built yet, with one
    ``nvcc`` per source, all started together; returns the paths."""
    with _lock:
        pending = [n for n in names if not os.path.exists(_lib_path(n))]
        builds = [_start_build(n) for n in pending]
        errors = []
        for b in builds:             # wait for every nvcc before raising
            try:
                _finish_build(*b)
            except RuntimeError as exc:
                errors.append(str(exc))
        if errors:
            raise RuntimeError("\n".join(errors))
    return [_lib_path(n) for n in names]


def require_cuda_f32(name: str, t, shape: Sequence[int]) -> None:
    """Validate a kernel argument before its pointer is passed: a
    contiguous float32 CUDA tensor of ``shape``."""
    require_cuda_tensor(name, t, shape, (torch.float32,))


def require_cuda_tensor(name: str, t, shape: Sequence[int],
                        dtypes: Sequence[torch.dtype],
                        device=None) -> None:
    """A contiguous CUDA tensor of ``shape`` and one of ``dtypes``, on
    ``device`` when one is given; raises ``ValueError`` otherwise."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected {' or '.join(map(str, dtypes))}"
                         f", got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def aligned_16(t: torch.Tensor) -> torch.Tensor:
    """``t`` where it starts on the 16-byte grid (a kernel reads it in
    16-byte words), else a copy of it, which does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def smem_optin(device) -> int:
    """The opt-in shared memory per block of ``device``'s card, in bytes
    (232,448 on an H100): the most a kernel may stage."""
    return int(torch.cuda.get_device_properties(device)
               .shared_memory_per_block_optin)


def current_stream(device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``,
    as the Python int the C entry points take."""
    return torch.cuda.current_stream(device).cuda_stream


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                _finish_build(*_start_build(name))
            lib = _libs[name] = ctypes.CDLL(path)
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
        return lib


class CudaKernel:
    """One C entry point of a ``csrc`` library, with its launch count.

    The entry point launches on the stream it is given and returns
    ``cudaGetLastError()``; :meth:`launch` raises on a non-zero code and
    otherwise adds one to ``launches``.  Arguments are the Python values
    of ``argtypes``: ``ctypes.c_void_p`` for device pointers and the
    stream, ``ctypes.c_int`` for sizes and knobs, ``ctypes.c_float`` for
    float scalars.
    """

    def __init__(self, library: str, symbol: str,
                 argtypes: Iterable[type]):
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._count_lock = threading.Lock()
        self._fn = None

    def _entry(self):
        if self._fn is None:
            lib = load_library(self.library)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        code = self._entry()(*args)
        if code != 0:
            msg = self._lib.kernel_error_string(code).decode()
            raise RuntimeError(f"{self.symbol} failed to launch: "
                               f"cudaError {code} ({msg})")
        with self._count_lock:
            self.launches += 1
