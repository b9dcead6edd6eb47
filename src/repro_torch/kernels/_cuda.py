"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface and loaded with
``ctypes``, at the first launch of one of its kernels (never at import:
a CPU-only machine imports every module).  A library lands in
``build/kernels/`` at the repository root, named by the hash of its
source, the shared ``csrc/*.cuh`` headers and its flags, so an edited
source or header is rebuilt and an unchanged one is loaded as it is.
Flags are per source: ``secure_agg.cu`` is built without FMA
contraction, so its float expressions round where the plain PyTorch
version rounds; the attention and recurrence kernels need no such flag.

Each C entry point returns a CUDA error code (``cudaGetLastError()``
after its launch); `launch` raises when that is not 0.  A failed build or
load raises too: nothing falls back to the plain PyTorch path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# source name -> (extra nvcc flags, {C entry point: argtypes without the
# trailing stream})
SOURCES = {
    "secure_agg": (
        # no FMA contraction: every float expression rounds where the
        # plain PyTorch version rounds
        ("-fmad=false",),
        {
            # (u, out, mask, P, N, seed, alpha, accumulator workspace)
            "masked_rolling_update_f32": (_P, _P, _P, _I, _L,
                                          ctypes.c_uint32, ctypes.c_float,
                                          _P),
            # (u, out, mask, P, N, seed, scale, accumulator workspace)
            "masked_field_wsum_f32": (_P, _P, _P, _I, _L, ctypes.c_uint32,
                                      ctypes.c_float, _P),
            # (u, out, norms, mask, P, N, seed, clip, sigma)
            "clip_noise_f32": (_P, _P, _P, _P, _I, _L, ctypes.c_uint32,
                               ctypes.c_float, ctypes.c_float),
            # (shares, params, out, P, N, alpha, params dtype code)
            "rolling_update_f32": (_P, _P, _P, _I, _L, ctypes.c_float, _I),
            # (shares, out, P, N)
            "field_wsum_u32": (_P, _P, _I, _L),
        }),
    "flash_attention": (
        (),
        {
            # (q, k, v, o, bf16, B, Hq, Hkv, Sq, Skv, hd,
            #  q/k/v/o strides of (b, h, s) x 4, causal, window, scale)
            "flash_attention_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I) + (_L,) * 12
                                   + (_I, _I, ctypes.c_float),
        }),
    "wkv6": (
        (),
        {
            # (r, k, v, w, u, s0, y, s_final, bf16, w_bf16, B, T, H, hd,
            #  r/k/v/w strides of (b, t, h) x 4)
            "wkv6_fwd": (_P,) * 8 + (_I,) * 6 + (_L,) * 12,
        }),
    "ssm_scan": (
        (),
        {
            # (a, bx, B, C, h0, y, h_last, workspace, its bytes, bf16,
            #  Bz, T, di, N, a/bx/B/C strides of (b, t) x 4)
            "ssm_scan_fwd": (_P,) * 8 + (_L,) + (_I,) * 5 + (_L,) * 8,
        }),
}
# C entry points that launch nothing and take no stream: {name: (source,
# argtypes, return type)}
QUERIES = {
    # (Bz, T, di, N) -> bytes of ssm_scan_fwd's workspace, -1 out of range
    "ssm_scan_workspace_bytes": ("ssm_scan", (_I,) * 4, _L),
    # (P, N, domain: 0 float, 1 int) -> bytes of the P > 16 masked
    # kernels' accumulator workspace, 0 where shared memory holds them
    "masked_wide_workspace_bytes": ("secure_agg", (_I, _L, _I), _L),
}
_OWNER = {fn: src for src, (_, sigs) in SOURCES.items() for fn in sigs}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: no CUDA toolkit (CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


def nvcc_flags(name: str) -> tuple:
    return BASE_FLAGS + SOURCES[name][0]


def library_path(name: str) -> Path:
    text = source_path(name).read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):  # the sources' shared headers
        text += header.read_bytes()
    digest = hashlib.sha256(text + " ".join(nvcc_flags(name)).encode()
                            ).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _start(name: str):
    """Start nvcc for `name` unless it is built: (path, tmp, proc) or
    (path, None, None)."""
    path = library_path(name)
    if path.exists():
        return path, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(source_path(name))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return path, tmp, proc


def _finish(name: str, path: Path, tmp, proc) -> Path:
    if proc is None:
        return path
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu ({proc.returncode}):"
                           f"\n{out}\n{err}")
    os.replace(tmp, path)
    return path


def build(name: str) -> Path:
    """Compile source `name` unless it is already built; its path."""
    return _finish(name, *_start(name))


def build_all() -> Dict[str, Tuple[Path, float]]:
    """Compile every source that is not built yet, one nvcc each, all
    started together; {name: (library path, seconds its build took, 0 if
    it was built already)}."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SOURCES}
    took = {name: 0.0 for name in SOURCES}
    running = {name for name, (_, _, proc) in started.items() if proc}
    while running:
        for name in list(running):
            if started[name][2].poll() is not None:
                took[name] = time.perf_counter() - t0
                running.discard(name)
        time.sleep(0.05)
    return {name: (_finish(name, *s), took[name])
            for name, s in started.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in SOURCES[name][1].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes) + [_P]
                f.restype = ctypes.c_int
            for fn, (src, argtypes, restype) in QUERIES.items():
                if src == name:
                    f = getattr(lib, fn)
                    f.argtypes = list(argtypes)
                    f.restype = restype
            _libs[name] = lib
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point `name` on `device`'s current stream; raise on a
    nonzero CUDA error code."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(_OWNER[name]), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")


def query(name: str, *args) -> int:
    """The value of C entry point `name` of QUERIES, which launches
    nothing."""
    return getattr(library(QUERIES[name][0]), name)(*args)


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


# The fused kernels hold a column's rows in registers up to this P; past
# it the same entry points launch their P > 16 kernels: the masked pair
# walks the rows in tiles, its accumulators in shared memory or, where
# they do not fit, in a workspace (`wide_accumulators`); the DP kernel
# takes the rows in groups, their constants staged by each block.
FUSED_MAX_ROWS = 16
ANY_P = 2 ** 31 - 1


def _grad_tracked(t: torch.Tensor) -> bool:
    """Whether autograd, or a ``torch.func`` grad transform at any level
    under a ``vmap``, would track `t`: each functorch wrapper is looked
    through down to the plain tensor."""
    while True:
        if torch.is_grad_enabled() and t.requires_grad:
            return True
        if not torch._C._functorch.is_functorch_wrapped_tensor(t):
            return False
        t = torch._C._functorch.get_unwrapped(t)


def refuse_transforms(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise before a forward-only kernel launches on inputs it cannot
    serve: a launch writes its output through raw pointers, so that output
    would be cut off from autograd (the gradient would silently skip the
    kernel), and a ``torch.func`` wrapper has no storage to point at."""
    if any(_grad_tracked(t) for t in tensors):
        raise RuntimeError(
            f"{kernel}: no backward kernel exists, and a gradient cannot "
            f"flow through this launch; differentiate through the plain "
            f"path instead (impl=\"ref\", or the trainer's impl=\"auto\", "
            f"which picks the plain paths), or run without grad")
    if any(torch._C._functorch.is_functorch_wrapped_tensor(t)
           for t in tensors):
        raise RuntimeError(
            f"{kernel}: the kernel has no torch.func batching rule; call "
            f"it outside torch.func.vmap, or use impl=\"ref\"")


def check_rows(x: torch.Tensor, what: str = "updates",
               dtype: torch.dtype = torch.float32):
    """(P, N) contiguous CUDA rows of `dtype` with 1 <= P < 2^31."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{what} must be {dtype}, got {x.dtype}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= ANY_P:
        raise ValueError(f"{what} must be (P, N) with 1 <= P <= {ANY_P}, "
                         f"got shape {tuple(x.shape)}")
    if x.shape[1] >= 2 ** 32:
        raise ValueError("the column counter is 32 bits: N < 2^32")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return x.shape


def wide_accumulators(P: int, N: int, domain: int,
                      device) -> torch.Tensor | None:
    """The accumulator workspace of a masked kernel's launch past
    FUSED_MAX_ROWS rows (domain 0 float, 1 int), or None where its
    accumulators fit in shared memory (or P <= FUSED_MAX_ROWS)."""
    if P <= FUSED_MAX_ROWS:
        return None
    nbytes = query("masked_wide_workspace_bytes", P, N, domain)
    if nbytes == 0:
        return None
    return torch.empty((nbytes,), dtype=torch.uint8, device=device)


def mask_arg(mask, P: int, device) -> torch.Tensor | None:
    """(P,) float32 contiguous participation on `device`, or None."""
    if mask is None:
        return None
    return torch.as_tensor(mask, device=device).to(
        torch.float32).reshape(P).contiguous()
