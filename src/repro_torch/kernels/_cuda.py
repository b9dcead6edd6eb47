"""Build and load the port's CUDA kernels.

``csrc/secure_agg.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``, at the
first launch (never at import: a CPU-only machine imports every module).
The library lands in ``build/kernels/`` at the repository root, named by
the hash of its source and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.

Each C entry point returns ``cudaGetLastError()`` after its launch;
`launch` raises when that is not 0.  A failed build or load raises too:
nothing falls back to the plain PyTorch path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "secure_agg.cu"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no FMA contraction: every float expression rounds where
              # the plain PyTorch version rounds
              "-fmad=false")

_P = ctypes.c_void_p
_SIGNATURES = {
    # (u, out, mask, P, N, seed, alpha, stream)
    "masked_rolling_update_f32": (_P, _P, _P, ctypes.c_int, ctypes.c_int64,
                                  ctypes.c_uint32, ctypes.c_float, _P),
    # (u, out, mask, P, N, seed, scale, stream)
    "masked_field_wsum_f32": (_P, _P, _P, ctypes.c_int, ctypes.c_int64,
                              ctypes.c_uint32, ctypes.c_float, _P),
    # (u, out, norms, mask, P, N, seed, clip, sigma, stream)
    "clip_noise_f32": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_uint32, ctypes.c_float, ctypes.c_float, _P),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit (CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsecure_agg_{digest[:16]}.so"


def build() -> Path:
    """Compile the kernels' library unless this source is already built;
    returns its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point `name` on `device`'s current stream; raise on a
    nonzero CUDA error code."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def check_rows(x: torch.Tensor, what: str = "updates", max_rows: int = 16):
    """(P, N) float32 contiguous CUDA rows with 1 <= P <= max_rows."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{what} must be float32, got {x.dtype}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= max_rows:
        raise ValueError(f"{what} must be (P, N) with 1 <= P <= {max_rows}, "
                         f"got shape {tuple(x.shape)}")
    if x.shape[1] >= 2 ** 32:
        raise ValueError("the column counter is 32 bits: N < 2^32")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return x.shape


def mask_arg(mask, P: int, device) -> torch.Tensor | None:
    """(P,) float32 contiguous participation on `device`, or None."""
    if mask is None:
        return None
    return torch.as_tensor(mask, device=device).to(
        torch.float32).reshape(P).contiguous()
