"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``: a file
that includes PyTorch's headers takes minutes to compile, one with a C
interface takes seconds. Sources build at first use, or all at once (one
``nvcc`` per source, started together) through :func:`build_all`. Libraries
land in ``build/kernels/`` at the repository root, named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. ``nvcc``'s resource report (``-Xptxas -v``) is kept beside each
library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return str(path)


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str) -> Tuple[subprocess.Popen, Path, Path]:
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, log


def _finish(name: str, proc: subprocess.Popen, tmp: Path, log: Path) -> None:
    output, _ = proc.communicate()
    log.write_text(output)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{output}")
    os.replace(tmp, _target(name))


def build_all() -> float:
    """Compile every source that has no up-to-date library, in parallel.
    Returns the seconds spent."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = [(name, *_start(name)) for name in sources()
               if not _target(name).exists()]
    errors = []
    for name, proc, tmp, log in started:
        try:
            _finish(name, proc, tmp, log)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (registers, shared memory, spills) for ``name``."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _finish(name, *_start(name))
        lib = ctypes.CDLL(str(target))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
