"""Build a host-side C++ source of the repository into a shared library
at first use, for ctypes.

The library goes to `build/native/` at the repository root, named after
the source's stem and a hash of its text, of the headers it includes
with `#include "..."` (found next to the file that includes them, and
theirs in turn) and of the flags, so a changed source, header or flag
set builds anew and a library built elsewhere is never opened.
`g++ -O3 -shared -fPIC` without `-march`: the library must run on the
machine that builds it and on any other. A failed build raises:
nothing falls back to another implementation.
"""

from __future__ import annotations

import hashlib
import os
import re
import subprocess

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
BUILD_DIR = os.path.join(ROOT, "build", "native")
COMPILER = "g++"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def sources(source: str) -> list:
    """`source` and the headers it includes with `#include "..."` that lie
    next to the including file, theirs in turn, each once, in the order
    first met."""
    seen, todo = [], [os.path.abspath(source)]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as f:
            text = f.read()
        here = os.path.dirname(path)
        todo += [p for p in (os.path.join(here, m.decode()) for m in _INCLUDE.findall(text)) if os.path.isfile(p)]
    return seen


def build(source: str, what: str, flags=FLAGS, build_dir: str = BUILD_DIR, compiler: str = COMPILER) -> str:
    """Compile `source` if its library is not there yet; returns the
    library's path. `what` names the library in error messages."""
    digest = hashlib.sha256()
    for path in sources(source):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(flags).encode())
    tag = digest.hexdigest()[:12]
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
