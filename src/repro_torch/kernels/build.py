"""Build the port's CUDA sources into shared libraries with a plain C
interface (bound with ``ctypes``), at first use.

Each source under ``csrc/`` compiles on its own with ``nvcc`` for
``sm_90a`` into ``build/kernels/<hash>/`` at the root of the checkout (a
directory ``.gitignore`` lists); the hash covers the source, every header
under ``csrc/`` (``*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged tree is reused.
Nothing here runs at import time."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
# --split-compile 0: nvcc runs its optimisation passes on every core (the
# backward's many template instances are the build's long pole)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME: the "
                       "port's CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to (whether or not it exists yet)."""
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / f"lib{src.stem}.so"


def library(source: str) -> Path:
    """Build ``csrc/<source>`` unless its library exists; return the
    library's path.  The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it in ``build.log``.  A failed
    build raises with the compiler's errors."""
    lib = library_path(source)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    (lib.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} (exit "
                           f"{res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def build_all(sources: list[str]) -> list[Path]:
    """Build several sources at once, one ``nvcc`` per source."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as ex:
        return list(ex.map(library, sources))
