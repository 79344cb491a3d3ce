"""Build and load the hand-written CUDA kernels of ``csrc/``.

All ``csrc/*.cu`` files compile with ``nvcc`` for ``sm_90a`` into ONE shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so the build takes seconds). The build happens at first use, into
``diffusionkit_tpu_torch/_build/`` (gitignored), under a name keyed by a
hash of the sources: an edited source rebuilds, an unchanged one is reused.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# C entry points and their argument types; each returns a cudaError_t.
_SIGNATURES = {
    "dk_mod_ln_bf16": [_P, _P, _P, _P, _I, _I, _I, _L, _F, _P],
    "dk_mod_ln_f32": [_P, _P, _P, _P, _I, _I, _I, _L, _F, _P],
    "dk_flash_attn_bf16": [_P, _P, _P, _P, _I, _I, _I, _I] + [_L] * 12 + [_F, _P],
}

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libdk_kernels_{source_hash()}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    Writes to a temporary name and renames, so another process never
    loads a half-written library. The compiler's register/shared-memory
    report goes to ``<library>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, CSRC.glob("*.cu"))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.dk_error_string.argtypes = [_I]
        lib.dk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().dk_error_string(err).decode()
        raise RuntimeError(f"{name} failed with CUDA error {err}: {msg}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
