"""ctypes bridge to the native DBoW2 text parser (native/vocab_loader.cpp
at the repository root).

The text parse dominates the load of a ~1M-word vocabulary. This module
compiles the scanner itself, at first use, with
`g++ -O3 -shared -fPIC` (no -march: the library must run on the machine
that builds it and on any other) into `build/native/` beside the
repository's other build outputs, and loads that file. A library built
elsewhere is never opened, and a failed build or load raises: nothing here
falls back to another parser.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils import native_build

SOURCE = os.path.join(native_build.ROOT, "native", "vocab_loader.cpp")
BUILD_DIR = native_build.BUILD_DIR
COMPILER = native_build.COMPILER
FLAGS = native_build.FLAGS

_lib = None


class _VocabData(ctypes.Structure):
    _fields_ = [
        ("k", ctypes.c_int32),
        ("depth", ctypes.c_int32),
        ("n_nodes", ctypes.c_int64),
        ("parents", ctypes.POINTER(ctypes.c_int32)),
        ("is_leaf", ctypes.POINTER(ctypes.c_uint8)),
        ("desc", ctypes.POINTER(ctypes.c_uint8)),
        ("weights", ctypes.POINTER(ctypes.c_double)),
    ]


def build() -> str:
    """Compile the scanner if its library is not there yet; returns the
    library's path. The name carries a hash of the source and the flags."""
    return native_build.build(SOURCE, "native vocabulary parser", FLAGS, BUILD_DIR, COMPILER)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.vocab_load.restype = ctypes.POINTER(_VocabData)
        lib.vocab_load.argtypes = [ctypes.c_char_p]
        lib.vocab_free.argtypes = [ctypes.POINTER(_VocabData)]
        _lib = lib
    return _lib


def parse_orbvoc_text(path: str):
    """-> (k, depth, parents (n,), is_leaf (n,), desc_bytes (n,32),
    weights (n,)) as numpy arrays, via the native scanner."""
    lib = _load()
    ptr = lib.vocab_load(os.fspath(path).encode())
    if not ptr:
        raise IOError(f"native vocabulary parse failed for {path!r}")
    v = ptr.contents
    n = v.n_nodes
    try:
        parents = np.ctypeslib.as_array(v.parents, (n,)).copy()
        is_leaf = np.ctypeslib.as_array(v.is_leaf, (n,)).copy().astype(bool)
        desc = np.ctypeslib.as_array(v.desc, (n, 32)).copy()
        weights = np.ctypeslib.as_array(v.weights, (n,)).copy()
        k, depth = int(v.k), int(v.depth)
    finally:
        lib.vocab_free(ptr)
    return k, depth, parents, is_leaf, desc, weights
