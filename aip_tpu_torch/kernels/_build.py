"""Build ``csrc/*.cu`` with nvcc into shared libraries and load them with ctypes.

Each source becomes ``build/aip_tpu_torch/<name>-<hash>.so`` under the
checkout (``AIP_TPU_TORCH_BUILD`` overrides the directory), compiled for
``sm_90a`` with a plain C interface: no PyTorch headers, so a build takes
seconds. The hash of the source and of the shared headers (``csrc/*.cuh``)
names the library, so an edited source or header is rebuilt and an
unchanged one is loaded as it is.

Builds and loads are safe across threads: one lock a source serialises its
build and load (different sources still build in parallel), and the
temporary file carries the process and thread ids.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_locks: dict[str, threading.Lock] = {}
_locks_guard = threading.Lock()


def build_dir() -> Path:
    default = CSRC.parent.parent / "build" / "aip_tpu_torch"
    return Path(os.environ.get("AIP_TPU_TORCH_BUILD", default))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels of aip_tpu_torch are built with it at first use")


def _target(name: str) -> Path:
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"{name}-{digest}.so"


def _lock(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns nvcc's
    ptxas report, or "" when the library was there."""
    with _lock(name):
        return _build_locked(name)


def _build_locked(name: str) -> str:
    target = _target(name)
    if target.is_file():
        return ""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc exited {proc.returncode} on {name}.cu:\n{proc.stdout}")
    os.replace(tmp, target)
    return proc.stdout


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        with _lock(name):
            lib = _loaded.get(name)
            if lib is None:
                _build_locked(name)
                lib = _loaded[name] = ctypes.CDLL(str(_target(name)))
    return lib
