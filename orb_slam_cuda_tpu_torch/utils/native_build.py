"""Build a host-side C++ source of the repository into a shared library
at first use, for ctypes.

The library goes to `build/native/` at the repository root, named after
the source's stem and a hash of its text and the flags, so a changed
source or flag set builds anew and a library built elsewhere is never
opened. `g++ -O3 -shared -fPIC` without `-march`: the library must run on
the machine that builds it and on any other. A failed build raises:
nothing falls back to another implementation.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
BUILD_DIR = os.path.join(ROOT, "build", "native")
COMPILER = "g++"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def build(source: str, what: str, flags=FLAGS, build_dir: str = BUILD_DIR, compiler: str = COMPILER) -> str:
    """Compile `source` if its library is not there yet; returns the
    library's path. `what` names the library in error messages."""
    with open(source, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(source))[0]
    out = os.path.join(build_dir, f"lib{stem}_{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [compiler, *flags, source, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{what}: cannot run {compiler!r}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{what}: {' '.join(cmd)} failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out
