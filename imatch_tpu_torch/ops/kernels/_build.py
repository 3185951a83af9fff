"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``imatch_tpu_torch/csrc/<name>.cu`` is compiled on first use into its
own shared library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

and loaded with ``ctypes``. The file name carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited kernel is
rebuilt and a stale library is never loaded. ``build/`` sits at the
repository root and is ignored by git.
Several sources build in parallel (one nvcc process each, all started
together). A failed build raises with nvcc's stderr; there is no fallback.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("flash_attention", "int4_tile_max", "quantize", "tile_max", "tile_max_t")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelBuildError(
            "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA "
            "kernels can only be built where the CUDA toolkit is installed"
        )
    return path


def library_path(name: str) -> Path:
    """The library's path; its hash covers the source, every shared header
    under csrc/ and the flags."""
    parts = [(CSRC / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source whose library is missing, one nvcc
    process per source, all started together. Returns nvcc's stderr
    (ptxas's register and shared-memory report) for each source it
    compiled; sources already built are left out."""
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append(
            (
                name,
                out,
                tmp,
                subprocess.Popen(
                    cmd,
                    stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE,
                    text=True,
                ),
            )
        )
    reports: Dict[str, str] = {}
    failures = []
    for name, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu:\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
        reports[name] = stderr
    if failures:
        raise KernelBuildError("\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not library_path(name).exists():
                build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            err = getattr(lib, f"{name}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a C entry point returned a CUDA error: a refused launch
    never runs, and a later synchronize would not report it."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")
