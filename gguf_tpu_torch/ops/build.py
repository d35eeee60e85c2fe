"""Build the port's native code at first use and bind it with ctypes.

Each `gguf_tpu_torch/csrc/<name>.cu` (a CUDA kernel) exposes a plain C
interface and is compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so <name>.cu

and each `gguf_tpu_torch/csrc/<name>.c` (the host-side GGUF quantizer
core) with the C compiler named explicitly, so that a `CC` set in the
environment (which may lack OpenMP) is not used:

    gcc -O2 -fPIC -shared -fopenmp -o build/lib<name>-<hash>.so <name>.c -lm

into `gguf_tpu_torch/build/`, keyed by a hash of the source, the shared
headers and the flags, so an edited source rebuilds and an unchanged one
loads in milliseconds.
No `--use_fast_math`: the KV-cache quantizer must divide and round exactly
as the reference does. A missing compiler or a failed build raises;
nothing falls back. The compiler's report (for nvcc the ptxas registers,
spills and shared memory) is kept beside the library as
`<name>-<hash>.log`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GCC_FLAGS = ("-O2", "-fPIC", "-shared", "-fopenmp")

_libs: dict = {}
_lock = threading.Lock()


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            "gguf_tpu_torch/csrc at first use and need the CUDA toolkit")
    return path


def find_gcc() -> str:
    path = shutil.which("gcc")
    if path is None:
        raise RuntimeError("gcc not found: the port's GGUF quantizer core is "
                           "built from gguf_tpu_torch/csrc at first use")
    return path


def _is_c(name: str) -> bool:
    """csrc/<name>.c (host code, gcc) rather than csrc/<name>.cu."""
    return os.path.exists(os.path.join(CSRC_DIR, name + ".c"))


def library_path(name: str) -> str:
    """Where the built library for csrc/<name>.cu (or .c) lives, keyed by
    the hash of the source, the shared headers and the flags."""
    if _is_c(name):
        flags, files = GCC_FLAGS, [name + ".c"]
    else:
        flags, files = NVCC_FLAGS, [name + ".cu"] + sorted(
            f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    h = hashlib.sha256(" ".join(flags).encode())
    for fname in files:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + f.read())
    key = h.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{key}.so")


def build(name: str) -> str:
    """Compile csrc/<name>.cu (or .c) unless the hash-keyed library
    exists."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    if _is_c(name):
        src = os.path.join(CSRC_DIR, name + ".c")
        cmd = [find_gcc(), *GCC_FLAGS, "-o", tmp, src, "-lm"]
    else:
        src = os.path.join(CSRC_DIR, name + ".cu")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        with open(out[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"{cmd[0]} failed on {src}:\n{proc.stderr}")
        os.replace(tmp, out)   # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str, signatures: dict, restype=ctypes.c_int) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu (or .c); `signatures`
    maps each C entry point to its argtypes. Every CUDA entry point
    returns the cudaError_t of its launch as an int (`restype`)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr() -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
