"""Build the port's host libraries (``csrc/<name>.cpp``) at first use.

Each source exposes a plain C interface and is compiled by ``g++`` into
``build/lib<name>-<hash>.so`` beside this file (the hash is of the source
and the flags, so an edited source rebuilds), renamed into place
atomically so that concurrent processes agree, then loaded with
``ctypes``.  FMA contraction is off and no ``-march`` is given, so every
machine's build computes the same floats.  Where ``g++`` is missing or the
build fails, ``load_library`` raises; nothing here runs at import time.
The JAX package's libraries (its ``csrc/``, built by CMake) are neither
built nor loaded here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-ffp-contract=off"]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(os.path.join(CSRC, f"{name}.cpp"), "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_library(name: str, out_path: str) -> None:
    """Compile ``csrc/<name>.cpp`` into ``out_path``; raises RuntimeError
    where ``g++`` is missing or fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the host library {name} cannot be built")
    res = subprocess.run([gxx, *GXX_FLAGS, "-o", out_path, os.path.join(CSRC, f"{name}.cpp")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for {name}:\n{res.stderr}")


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>``, built first where it is missing."""
    with _lock:
        if name not in _loaded:
            target = library_path(name)
            if not os.path.isfile(target):
                os.makedirs(BUILD_DIR, exist_ok=True)
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
                os.close(fd)
                try:
                    build_library(name, tmp)
                    os.replace(tmp, target)  # atomic: concurrent builds agree
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            _loaded[name] = ctypes.CDLL(target)
        return _loaded[name]
