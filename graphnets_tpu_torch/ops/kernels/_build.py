"""Build and load the port's CUDA kernels.

Every ``graphnets_tpu_torch/csrc/<name>.cu`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so <name>.cu

into ``build/`` at the root of the checkout (listed in ``.gitignore``), and
loaded with ``ctypes``.  The file name carries a hash of the sources and
flags, so an edited kernel is rebuilt.  Each library exposes plain C entry
points that take every pointer and the stream as ``void*`` and return
``cudaGetLastError()`` after the launch; :func:`check` raises on a non-zero
code.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def kernel_names() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _library(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (all by default) that have no library
    yet, one ``nvcc`` per source, all started together.  Returns the
    compiler's output (``ptxas`` register and spill counts) per kernel,
    kept beside each library, also for those built before; raises if any
    build fails."""
    names = kernel_names() if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    logs = {}
    for name in names:
        out = _library(name)
        if out.exists():
            # Built before: the report of that build, kept beside it.
            report = out.with_suffix(".log")
            if report.exists():
                logs[name] = report.read_text()
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failed = []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library(name)))
            lib.gn_error_string.argtypes = [ctypes.c_int]
            lib.gn_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.gn_error_string(err).decode()})")
