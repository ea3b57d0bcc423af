"""Builds the port's CUDA sources with ``nvcc`` and loads them with ``ctypes``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``build/repro_torch_kernels/<name>-<hash>.so`` at the root of the checkout,
keyed by a hash of the sources and flags.  Nothing is compiled at import:
the first launch of a kernel builds its library.  Each compile writes a
temporary file and renames it into place, so two processes that build at
the same time both end with a whole library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 900

_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of the CUDA sources, one library each."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (default: all) that are not built yet.

    One ``nvcc`` per source, all started together.  Returns
    ``{name: {"seconds", "log", "built"}}``; raises RuntimeError with the
    compiler's output when a source does not compile, after every compile
    has ended.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    result = {}
    running = {}                       # name -> (process, temporary, start)
    try:
        for name in (sources() if names is None else names):
            if library_path(name).is_file():
                result[name] = {"seconds": 0.0, "log": "", "built": False}
                continue
            fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so",
                                       dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, tmp, time.perf_counter())
        failed = []
        for name, (proc, tmp, t0) in running.items():
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                failed.append(f"CUDA build of {name} failed (nvcc exit "
                              f"{proc.returncode}):\n{log}")
                continue
            os.replace(tmp, library_path(name))
            result[name] = {"seconds": time.perf_counter() - t0, "log": log,
                            "built": True}
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, tmp, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            Path(tmp).unlink(missing_ok=True)
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
