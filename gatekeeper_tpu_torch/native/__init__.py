"""Native runtime components (C extensions).

flatten: the extraction flattener (ir/features.py's ingest hot path).
Built on demand from flatten.c with the system compiler into this
package directory; every consumer falls back to the pure-Python path
when no compiler or prebuilt artifact is available, so the framework
stays importable anywhere. Disable with GATEKEEPER_TPU_NATIVE=0."""

from __future__ import annotations

import logging
import os
import subprocess
import sysconfig
from typing import Optional

log = logging.getLogger("gatekeeper_tpu_torch.native")

_DIR = os.path.dirname(__file__)
_flatten = None
_tried = False


def _build() -> Optional[str]:
    src = os.path.join(_DIR, "flatten.c")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = os.path.join(_DIR, "_flatten" + suffix)
    if os.path.exists(out) and \
            os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    cc = os.environ.get("CC", "cc")
    include = sysconfig.get_path("include")
    # build to a temp path + atomic rename: two processes racing the
    # first build must never import a half-written artifact
    tmp = out + f".build-{os.getpid()}"
    cmd = [cc, "-O2", "-shared", "-fPIC", f"-I{include}", src, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.info("native flatten build unavailable (%s); using the "
                 "Python extractor", e)
        return None
    if proc.returncode != 0:
        log.warning("native flatten build failed; using the Python "
                    "extractor:\n%s", proc.stderr[-2000:])
        return None
    os.replace(tmp, out)
    return out


def flatten_ext():
    """The _flatten extension module, or None (Python fallback)."""
    global _flatten, _tried
    if _tried:
        return _flatten
    _tried = True
    if os.environ.get("GATEKEEPER_TPU_NATIVE", "1") == "0":
        return None
    path = _build()
    if path is None:
        return None
    # package-qualified spec load: no sys.path mutation, and no collision
    # with any other module that happens to be named "_flatten"
    import importlib.util

    try:
        spec = importlib.util.spec_from_file_location(
            __name__ + "._flatten", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _flatten = mod
    except ImportError as e:
        log.warning("native flatten import failed (%s); using the Python "
                    "extractor", e)
        _flatten = None
    return _flatten
