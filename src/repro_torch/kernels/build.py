"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file has a plain C interface and is compiled by its
own ``nvcc`` process (all started together) into a shared library for
``sm_90a``, then loaded with ``ctypes``.  Libraries land in
``kernels/_build/`` (git-ignored), named by a hash of their source, the
``csrc/*.cu`` files it includes, the shared ``csrc/*.cuh`` headers and
the flags, so a changed source or header rebuilds and an unchanged one is
reused.
Nothing is built at import time: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("fused_expert.cu", "flash_decode.cu", "flash_decode_paged.cu",
           "quant_matmul.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    for inc in re.findall(rb'#include "(\w+\.cu)"', text):
        text += (CSRC / inc.decode()).read_bytes()
    text += " ".join(NVCC_FLAGS).encode()
    for header in sorted(CSRC.glob("*.cuh")):
        text += header.read_bytes()
    tag = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{tag}.so"


def build_log(source: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``source``, or '' if it was not built here."""
    log = library_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(sources=SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all in parallel.  Raises with the compiler output on any
    failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, out, tmp, proc in procs:
        text, _ = proc.communicate()
        out.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} (rc {proc.returncode}):\n"
                          f"{text[-4000:]}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)            # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return {src: library_path(src) for src in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source`` (building all sources first if any
    library is missing)."""
    if source not in _LIBS:
        paths = build_all()
        _LIBS[source] = ctypes.CDLL(str(paths[source]))
    return _LIBS[source]


class LaunchCounter:
    """Count of a wrapper's kernel launches (incremented only where the
    wrapper launches its CUDA kernel, never on its plain path)."""

    def __init__(self):
        self.n = 0

    def reset(self) -> None:
        self.n = 0


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
