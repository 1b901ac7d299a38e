"""Build-at-first-use loader for the port's CUDA kernels.

Each kernel source under a ``csrc/`` directory has a plain C interface.
It is compiled with ``nvcc`` for Hopper (``sm_90a``), with the shared
device headers of ``kernels/csrc/`` on its include path, into a shared
library under ``build/kernels/`` at the repository root, keyed on a hash
of the source, every header under ``kernels/`` and the flags, and loaded
with ``ctypes``.  Nothing is compiled when a module is imported: only a
wrapper's first launch on a CUDA tensor calls :func:`load`, and
:func:`build_all` compiles several sources at once (one ``nvcc`` process
each, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# per kernel: compiler output (ptxas registers / spills), kept beside the
# library so that a library built by an earlier process has it too
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH); the kernels build with nvcc")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _library_path(name: str, source: Path) -> Path:
    """The library built from ``source``: its name carries a hash of the
    source, of every header a source can include (all ``*.cuh`` under
    ``kernels/``, by path and content) and of the flags, so an edited
    header builds anew."""
    key = hashlib.sha256(source.read_bytes())
    for header in sorted(KERNELS_DIR.rglob("*.cuh")):
        key.update(str(header.relative_to(KERNELS_DIR)).encode())
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def build_all(sources: Sequence[Tuple[str, Path]]) -> None:
    """Compile every ``(name, source)`` whose library is not built yet,
    all ``nvcc`` processes running at once; raise if any fails."""
    jobs = []
    for name, source in sources:
        so = _library_path(name, source)
        if so.exists():
            log = so.with_suffix(".log")
            if log.exists():
                BUILD_LOG[name] = log.read_text()
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{so.stem}.{os.getpid()}.so"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-I",
                                 str(KERNELS_DIR / "csrc"), "-o", str(tmp),
                                 str(source)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, source, so, tmp, proc))
    failed = []
    for name, source, so, tmp, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {source}:\n{err}")
            continue
        BUILD_LOG[name] = out + err
        so.with_suffix(".log").write_text(out + err)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, source: Path) -> ctypes.CDLL:
    """Compile ``source`` (once per content hash) and load it."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all([(name, source)])
    lib = ctypes.CDLL(str(_library_path(name, source)))
    _LIBS[name] = lib
    return lib
