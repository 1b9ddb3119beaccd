"""Builds the port's native code on first use.

* `csrc/bvh_builder.cpp` (host, g++) -> `build/hikari_tpu_torch/libhikari_bvh.so`;
* each CUDA source `csrc/<name>.cu` (nvcc, sm_90a) ->
  `build/hikari_tpu_torch/lib<name>.so`, a plain C ABI loaded with ctypes
  (no PyTorch headers, so a build takes seconds, not minutes).

A library is rebuilt when it is older than its source or `csrc/common.cuh`.
Each build writes to a private temporary name and renames it into place, so
concurrent processes (test workers) never load a half-written file.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hikari_tpu_torch")

CUDA_SOURCES = ("prepass_fused", "light_fused", "denoise_fused",
                "reproj_gather", "spatial_fused", "warp", "trace",
                "trace_bvh", "texture")

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no contraction of a*b+c into FMA: the kernels then round like their
    # plain PyTorch versions, which run one operation at a time
    "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def _stale(out: str, deps) -> bool:
    if not os.path.exists(out):
        return True
    t = os.path.getmtime(out)
    return any(os.path.getmtime(d) > t for d in deps)


def _cuda_paths(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    return src, out, (src, os.path.join(CSRC, "common.cuh"))


def _start(cmd, out: str):
    stem, ext = os.path.splitext(out)
    tmp = f"{stem}.{os.getpid()}.{threading.get_ident()}.tmp{ext}"
    proc = subprocess.Popen(cmd + ["-o", tmp], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def _finish(proc, tmp: str, out: str, what: str) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"build of {what} failed "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    with open(out + ".log", "w") as f:
        f.write(log)
    return log


def build_cuda(names=CUDA_SOURCES) -> dict:
    """Compile the stale CUDA libraries, one nvcc process per source, all
    started together. Returns {name: compiler log} for what it built."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    for name in names:
        src, out, deps = _cuda_paths(name)
        if _stale(out, deps):
            running[name] = _start([nvcc_path(), *_NVCC_FLAGS, src], out)
    logs = {}
    for name, (proc, tmp) in running.items():
        logs[name] = _finish(proc, tmp, _cuda_paths(name)[1], f"{name}.cu")
    return logs


def load_cuda(name: str) -> ctypes.CDLL:
    """The ctypes handle of lib<name>.so, building it first when stale (at
    the first call; later calls take no lock)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_cuda((name,))
            lib = ctypes.CDLL(_cuda_paths(name)[1])
            _libs[name] = lib
        return lib


def build_host_library(src_name: str, lib_name: str) -> str:
    """g++ build of a host C++ source in csrc/; returns the library path."""
    src = os.path.join(CSRC, src_name)
    out = os.path.join(BUILD_DIR, lib_name)
    if _stale(out, (src,)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        proc, tmp = _start(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                            src], out)
        _finish(proc, tmp, out, src_name)
    return out
