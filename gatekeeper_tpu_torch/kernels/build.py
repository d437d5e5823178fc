"""Build directory and nvcc driver for the hand-written CUDA kernels.

Kernels build at first use into `gatekeeper_tpu_torch/_build/` (listed in
.gitignore): nvcc compiles each csrc/*.cu with a plain C interface into a
shared library, which the wrapper loads with ctypes.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# every csrc/<name>.cu, one shared library each
CUDA_SOURCES = ("pair_compact", "regex_scan", "join_member", "rows_update")

# kernels compiled in this process: nvcc builds here, and Triton's
# compiles of K2 (clause_triton.launch), counted by note_compiles
compiles = 0
# the same count per thread (thread_compiles), and per thread the waits
# for a kernel lock another thread held, perhaps compiling (note_wait): a
# host-clock sample across a change of its own thread's thread_stamp()
# may have timed a compile, not the device, and TorchDriver's cost model
# drops it; a compile on the driver's background warm thread leaves the
# serving thread's samples alone unless the serving thread waited on it
_thread = threading.local()
# guards `compiles`, the wrappers' `launches` counters, the libraries'
# loads (LOAD_LOCK) and the per-source build locks
_lock = threading.Lock()
LOAD_LOCK = threading.Lock()
_build_locks: dict = {}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def note_compiles(n: int) -> None:
    """Count n kernel compiles made by the calling thread."""
    global compiles
    if n:
        with _lock:
            compiles += n
        _thread.compiles = thread_compiles() + n


def thread_compiles() -> int:
    """The kernel compiles the calling thread has made."""
    return getattr(_thread, "compiles", 0)


def note_wait() -> None:
    """The calling thread waited for a kernel lock another thread held
    (held): that thread may have been compiling."""
    _thread.waits = getattr(_thread, "waits", 0) + 1


def thread_stamp() -> tuple:
    """(compiles, waits) of the calling thread: a sample taken across a
    change of it may span a compile."""
    return thread_compiles(), getattr(_thread, "waits", 0)


@contextlib.contextmanager
def held(lock):
    """Hold a kernel lock (a source's build, a K2 kernel's launch); a
    wait for it, while another thread holds it, is noted on the calling
    thread (note_wait)."""
    if not lock.acquire(blocking=False):
        lock.acquire()
        note_wait()
    try:
        yield
    finally:
        lock.release()


def count_launch(wrapper) -> None:
    """One launch of a kernel wrapper's kernel (`wrapper.launches`; the
    driver's warm thread launches beside the serving thread)."""
    with _lock:
        wrapper.launches += 1


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
    with _lock:
        lock = _build_locks.setdefault(name, threading.Lock())
    # one build of a source at a time in this process (the temp path is
    # per process)
    with held(lock):
        if os.path.exists(out) and \
                os.path.getmtime(out) >= os.path.getmtime(src):
            return out, ""
        # build to a temp path + atomic rename: two processes racing the
        # first build must never load a half-written library
        note_compiles(1)
        tmp = f"{out}.build-{os.getpid()}"
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
        return out, proc.stderr


def build_all(names=CUDA_SOURCES) -> dict[str, str]:
    """Compile several csrc/<name>.cu at once (all of them by default),
    one nvcc each, all started together. Returns name -> ptxas report
    (empty when cached)."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        reports = pool.map(lambda n: build_so(n)[1], names)
        return dict(zip(names, reports))
