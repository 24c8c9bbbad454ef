"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain C
interface under <repo>/build/kernels/, named by a hash of the source and of
every header in csrc/ so an edited kernel or header rebuilds. Libraries are loaded with ctypes; every C entry point
returns cudaGetLastError() and `check` raises when it is not 0. Nothing is
built or loaded at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
SOURCES = ("conv2d", "flash_attention", "flash_attention_bwd", "warp", "warp_bwd")

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:12]}.so"


def build_all() -> dict:
    """Compile every source that has no up-to-date library, one nvcc process
    per source, all started together. Returns {name: ptxas log}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    logs = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def tolerance(want: torch.Tensor) -> tuple:
    """(rtol, atol) within which a kernel's output must match its plain
    version's output `want`, element by element: |got - want| <= atol +
    rtol * |want|. Both compute in fp32 and round once to the output type, so
    a bf16 output may land one bf16 ulp (at most 2^-7 |want|) away; atol,
    1e-5 of the largest |want|, covers fp32 summation-order noise."""
    rtol = 2 ** -7 if want.dtype == torch.bfloat16 else 1e-5
    return rtol, 1e-5 * want.float().abs().max().item()


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {err}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def dtype_code(t: torch.Tensor) -> int:
    """0 = float32, 1 = bfloat16 (the element types the kernels take)."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")


def launch_counts() -> dict:
    """This process's launch counters of every kernel wrapper,
    {"<wrapper>.<counter>": n}: what a rank started by parallel.dist.launch
    reports to the process that started it."""
    from . import conv2d, flash_attention, warp

    out = {}
    for mod in (conv2d, flash_attention, warp):
        for fn in vars(mod).values():
            if callable(fn) and getattr(fn, "__module__", None) == mod.__name__:
                for k, v in vars(fn).items():
                    if k.startswith("launches"):
                        out[f"{fn.__name__}.{k}"] = v
    return out
