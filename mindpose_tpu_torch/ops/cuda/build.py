"""Build the package's native sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (sm_90a) into ``build/mindpose_tpu_torch/`` beside the
package, at first use, then loaded with ``ctypes`` (``load_library``). The
host C++ sources, ``csrc/<name>.cpp``, take the same road through ``g++``
with the JAX package's flags (``load_host_library``). A library's file name
carries a hash of its source and flags, so an edited source is rebuilt and a
built one is reused. Nothing here runs when a module is imported: the CPU
tests import every module on machines that have no ``nvcc``.
"""
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["BuiltLibrary", "load_library", "load_host_library", "CSRC_DIR", "BUILD_DIR"]

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "mindpose_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # ptxas reports registers, shared memory and spills per kernel
    "-Xptxas", "-v",
)
# the JAX package's g++ flags for csrc/coco_native.cpp (mindpose_tpu/utils/native.py)
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # time spent in the compiler; 0.0 when the file was already built
    log: str  # the compiler's output for this build (nvcc's: the ptxas report)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def _compiled(source: Path, compiler: str, flags: tuple) -> BuiltLibrary:
    """Compile ``source`` with ``compiler`` and ``flags`` if needed, and load it."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(flags).encode())
    path = BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:16]}.so"
    log_path = path.with_suffix(".log")
    seconds = 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a private name and rename, so a process building the same
        # library at the same time never loads a half-written file
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        start = time.perf_counter()
        try:
            proc = subprocess.run([compiler, *flags, "-o", tmp, str(source)],
                                  capture_output=True, text=True)
        except OSError as e:
            os.unlink(tmp)
            raise RuntimeError(f"{compiler} could not run on {source}: {e}") from e
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            os.unlink(tmp)
            name = os.path.basename(compiler)
            raise RuntimeError(f"{name} failed on {source}:\n{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    log = log_path.read_text() if log_path.exists() else ""
    return BuiltLibrary(ctypes.CDLL(str(path)), path, seconds, log)


@functools.cache
def load_library(name: str) -> BuiltLibrary:
    """Compile ``csrc/<name>.cu`` if needed and load it (once per process)."""
    return _compiled(CSRC_DIR / f"{name}.cu", _nvcc(), NVCC_FLAGS)


@functools.cache
def load_host_library(name: str) -> BuiltLibrary:
    """Compile the host source ``csrc/<name>.cpp`` with ``g++`` if needed and
    load it (once per process)."""
    return _compiled(CSRC_DIR / f"{name}.cpp", shutil.which("g++") or "g++", HOST_FLAGS)
