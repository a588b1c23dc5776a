"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled on its
own into a shared library under ``build/kernels/`` at the repo root (listed
in ``.gitignore``). The library name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

COMMON_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
# Per-source extra flags. reprojection.cu: no FMA contraction, so every
# product and sum rounds as the plain PyTorch version's elementwise ops do.
# correlation.cu sums its dots in another order than the plain version in
# any case, so it keeps nvcc's default contraction; decoder_pad.cu forms no
# product that a contraction could fuse with a sum.
SOURCES: Dict[str, tuple] = {
    "reprojection.cu": ("-fmad=false",),
    "correlation.cu": (),
    "decoder_pad.cu": (),
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH,
    else under ``$CUDA_HOME``, ``$CUDA_PATH`` or ``/usr/local/cuda``."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / name
    if not path.exists():
        raise RuntimeError(f"{name} not found on PATH or at {path}")
    return str(path)


def library_path(source: str) -> Path:
    flags = COMMON_FLAGS + SOURCES[source]
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


def build_all(sources: Sequence[str] | None = None) -> float:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together. Returns the wall seconds taken;
    raises with the compiler's output if any build fails."""
    sources = list(SOURCES) if sources is None else list(sources)
    start = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cuda_tool("nvcc"), *COMMON_FLAGS, *SOURCES[source], "-o", str(tmp),
               str(CSRC / source)]
        procs.append((source, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failures = []
    for source, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{source} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))
    return time.perf_counter() - start


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if it is missing."""
    lib = _LOADED.get(source)
    if lib is None:
        path = library_path(source)
        if not path.exists():
            build_all([source])
        lib = ctypes.CDLL(str(path))
        _LOADED[source] = lib
    return lib
