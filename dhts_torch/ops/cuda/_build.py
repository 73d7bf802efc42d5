"""Build and load the port's CUDA sources with ``nvcc`` alone.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header; it is compiled at first use into a shared library named by the
SHA-256 of its source, the headers of ``csrc/`` it includes and the flags,
under ``dhts_torch/ops/cuda/build/``, and loaded with ``ctypes``. There is
no lock file: the library is written under a temporary name and moved into
place with ``os.replace``, so a concurrent or interrupted build never
leaves a half-written library behind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

# Hopper only; no --use_fast_math (a flipped Riemann case or hard gate
# changes events) and no FMA contraction, so each kernel repeats the IEEE
# rounding of its plain PyTorch version op for op
NVCC_FLAGS = ("-O3", "-gencode", "arch=compute_90a,code=sm_90a",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-fmad=false")

_INCLUDE = re.compile(r'\s*#\s*include\s+"([^"]+)"')

# seconds each library took to build in this process (0.0 when cached)
build_seconds: dict[str, float] = {}
_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """The ``nvcc`` on PATH, else the one under CUDA_HOME or
    /usr/local/cuda; raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def _included(src: Path, csrc: Path, seen: set) -> list[Path]:
    """``src`` and every header under ``csrc`` that it includes with
    ``#include "..."``, recursively, each once, in the order included."""
    if src in seen or not src.exists():
        return []
    seen.add(src)
    files = [src]
    for line in src.read_text().splitlines():
        m = _INCLUDE.match(line)
        if m:
            files += _included(csrc / m.group(1), csrc, seen)
    return files


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the library of ``<csrc>/<name>.cu`` goes, named by the content
    of the source, of every header of ``csrc`` it includes, and of the
    flags: an edited header names a new library."""
    src = Path(csrc) / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    h = hashlib.sha256()
    for f in _included(src, Path(csrc), set()):
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, timeout: float = 600.0) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    out = library_path(name)
    if out.exists():
        build_seconds.setdefault(name, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):"
                           f"\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds[name] = time.perf_counter() - t0
    (BUILD_DIR / f"{out.stem}.ptxas.txt").write_text(proc.stderr)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def build_cpu_emulation(name: str, out_dir, timeout: float = 300.0) -> Path:
    """Compile ``csrc/<name>.cu`` with the host C++ compiler against
    ``csrc/cpu_emulation.h`` (one fiber per CUDA thread, switched at
    ``__syncthreads``), so the kernel's own code runs on a machine without a
    GPU. For tests: it checks the kernel's logic, not the card's compiler."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no host C++ compiler (g++/c++) on PATH")
    out = Path(out_dir) / f"lib{name}_emulated.so"
    cmd = [cxx, "-std=c++20", "-O2", "-ffp-contract=off",
           "-DDHTS_CPU_EMULATION", "-x", "c++", "-shared", "-fPIC",
           "-pthread", "-o", str(out), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"host build of {name} failed:\n{proc.stderr}")
    return out
