"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each source under ``csrc/`` becomes one shared library with a plain C
interface, compiled for ``sm_90a`` into the git-ignored ``_build/`` and
keyed by a hash of the source and the flags, so an edited source builds
anew and an unchanged one is reused. ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the port's CUDA kernels cannot be built")
    return found


def library_path(source: str) -> str:
    """Where the library of `source` (a file name under csrc/) lives."""
    with open(os.path.join(CSRC_DIR, source), "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}_{key.hexdigest()[:16]}.so")


def build_all(sources: Sequence[str]) -> Dict[str, str]:
    """Compile every source not built yet, all at once; returns
    {source: library path}."""
    paths = {src: library_path(src) for src in sources}
    procs = []
    for src, lib in paths.items():
        if os.path.exists(lib):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs.append((src, lib, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} with code "
                          f"{proc.returncode}:\n{out}")
        else:
            os.replace(tmp, lib)    # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def all_sources() -> list:
    """The file names of every kernel source under csrc/, sorted."""
    return sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def build(source: str) -> str:
    """Compile one source unless it was built already; returns the path of
    its shared library."""
    return build_all([source])[source]
