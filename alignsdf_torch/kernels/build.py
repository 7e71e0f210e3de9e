"""Build the hand-written CUDA kernels into shared libraries, at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` beside this file
(the hash is of the source and of the shared ``csrc/*.cuh`` headers, so an
edited kernel or header rebuilds), then loaded with ``ctypes``.  ``build_all`` starts one ``nvcc`` per source, all at once.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for source in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, source), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, concurrently.
    Returns name -> ptxas report (empty for a library already built)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if os.path.isfile(target):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, target)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
        else:
            os.replace(tmp, target)  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it if needed."""
    if name not in _loaded:
        build_all([name])
        _loaded[name] = ctypes.CDLL(library_path(name))
    return _loaded[name]
