"""gatekeeper_tpu_torch: the policy engine on PyTorch and CUDA.

The port of `gatekeeper_tpu` (JAX) to an NVIDIA Hopper card. The host
front half (Rego ingest, the Program IR, feature extraction, matching,
message materialization) is carried over module by module; the device
filter runs through hand-written kernels (kernels/, csrc/). Entry points
evaluate on the card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"

# Lockset tracing (GATEKEEPER_TPU_LOCKTRACE=1) arms HERE, before any
# submodule import constructs a lock — so child processes, which
# inherit the env var, trace their locks exactly like the parent does.
# A no-op when unarmed, and when another lockset tracer is installed
# already (threading.Lock is then its wrapper, from a module named
# utils.locktrace: the JAX package's, which a process imports beside
# this one): one tracer a process, so no lock is wrapped twice and one
# dump is written at exit.
import os as _os

if _os.environ.get("GATEKEEPER_TPU_LOCKTRACE", "") not in ("", "0",
                                                           "false"):
    import threading as _threading

    if not getattr(_threading.Lock, "__module__", "").endswith(
            ".utils.locktrace"):
        from .utils import locktrace as _locktrace

        _locktrace.install()
