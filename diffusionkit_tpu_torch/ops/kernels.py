"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` for ``sm_90a``, all
started together, and the objects link into ONE shared library with a plain
C interface, loaded with ``ctypes`` (no PyTorch headers, so the build takes
seconds). The build happens at first use, into
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    "dk_flash_attn_bhsd_bf16": [_P, _P, _P, _P, _I, _I, _I, _I] + [_L] * 12 + [_F, _P],
    "dk_flash_attn_stats_bf16": [_P] * 6 + [_I] * 6 + [_L] * 12 + [_F, _P],
    "dk_flash_attn_wide_bf16": [_P] * 7 + [_I] * 3 + [_L] * 12 + [_F, _I, _I, _I, _P],
    "dk_flash_attn_f32": [_P, _P, _P, _P, _I, _I, _I, _I] + [_L] * 12 + [_F, _P],
    "dk_flash_attn_bhsd_f32": [_P, _P, _P, _P, _I, _I, _I, _I] + [_L] * 12 + [_F, _P],
    "dk_flash_attn_stats_f32": [_P] * 6 + [_I] * 6 + [_L] * 12 + [_F, _P],
    "dk_int4_matmul_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _P, _P],
    "dk_int8_matmul_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _P, _P],
    "dk_int4_matmul_sm90_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P],
    "dk_int8_matmul_sm90_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P],
    "dk_int4_matmul_bf16_f32out": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _P, _P],
    "dk_int8_matmul_bf16_f32out": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _P, _P],
    "dk_int4_matmul_sm90_bf16_f32out": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P],
    "dk_int8_matmul_sm90_bf16_f32out": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P],
    "dk_int4_matmul_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P],
    "dk_int8_matmul_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P],
    "dk_gelu_quantize_bf16": [_P, _P, _P, _I, _I, _I, _P],
    "dk_gelu_quantize_f32": [_P, _P, _P, _I, _I, _I, _P],
    "dk_w8_matmul_bf16": [_P] * 6 + [_I, _I, _I, _P],
    "dk_w8_matmul_f32": [_P] * 6 + [_I, _I, _I, _P],
    "dk_w8_gemv": [_P, _I] + [_P] * 5 + [_I] * 5 + [_P],
    "dk_int8_dot": [_P, _P, _P, _I, _I, _I, _P],
    "dk_dequant_w8": [_P] * 5 + [_I, _I, _I, _P],
    "dk_mod_ln_quant_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _F, _P],
    "dk_mod_ln_quant_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _F, _P],
    "dk_quantize_bf16": [_P, _P, _P, _I, _I, _P],
    "dk_quantize_f32": [_P, _P, _P, _I, _I, _P],
    "dk_quantize_two_pass_bf16": [_I, _I, _P, _P, _P, _P, _I, _I, _P],
    "dk_quantize_two_pass_f32": [_I, _I, _P, _P, _P, _P, _I, _I, _P],
    "dk_tile_gelu_quantize": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "dk_w4a8_matmul": [_P] * 7 + [_I, _P] + [_I] * 5 + [_L, _I, _P, _P],
    "dk_w4a8_matmul_sm90": [_P] * 7 + [_I] + [_P] * 3 + [_I, _P, _I, _P] + [_I] * 5 + [_L, _F, _P],
    "dk_gptq_group": [_P, _P, _L, _L, _P, _P, _P, _P, _I, _I, _I, _F, _P],
}

_lib: Optional[ctypes.CDLL] = None


class KernelError(RuntimeError):
    """A kernel that does not build, load or launch."""


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
    raise KernelError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def _start(cmd) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _wait(cmd, proc: subprocess.Popen) -> str:
    """Wait for one nvcc command; its output, or raise with it on failure."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    return out


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    One nvcc per source, all started at once, then one link. Writes to
    temporary names and renames, so another process never loads a
    half-written library. The compiler's register/shared-memory report goes
    to ``<library>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, _start(cmd)))
    tmp = out.with_name(f"{tag}.so.tmp")
    try:
        # Every job is waited for, even after one has failed.
        logs, failed = [], None
        for cmd, _, proc in jobs:
            try:
                logs.append(_wait(cmd, proc))
            except KernelError as e:
                failed = failed or e
        if failed:
            raise failed
        link = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        logs.append(_wait(link, _start(link)))
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelError(f"loading {path} failed: {e}") from e
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
        raise KernelError(f"{name} failed with CUDA error {err}: {msg}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
