"""Build directory and nvcc driver for the hand-written CUDA kernels.

Kernels build at first use into `gatekeeper_tpu_torch/_build/` (listed in
.gitignore): nvcc compiles each csrc/*.cu with a plain C interface into a
shared library, which the wrapper loads with ctypes.
"""

from __future__ import annotations

import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build_dir() -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    return BUILD_DIR


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = "/usr/local/cuda/bin/nvcc"
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "host with the CUDA toolkit")
    return path


def build_so(name: str) -> tuple[str, str]:
    """Compile csrc/<name>.cu into _build/lib<name>.so (rebuilt when the
    source is newer). Returns (path, ptxas report; empty when cached)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    out = os.path.join(build_dir(), f"lib{name}.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out, ""
    # build to a temp path + atomic rename: two processes racing the first
    # build must never load a half-written library
    tmp = f"{out}.build-{os.getpid()}"
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out, proc.stderr
