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

Every wrapper launches through the same few helpers: ``bind`` (a library
with its entry points' argument types), ``check`` (the refusals every
kernel shares: a CUDA tensor on the inputs' card, of its dtype and shape,
contiguous and aligned), ``launch`` (the device guard, the current stream
as the last argument, a launch error as ``RuntimeError``) and one registry
of launch counts (``add_count``, ``read_counts``, ``reset_counts``), which
counts outside any profiler too (``utils.profiling.count`` records only
under one).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

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


def bind(name: str, **signatures) -> ctypes.CDLL:
    """``library(name)`` with each entry point's ``argtypes`` set from
    ``signatures`` (entry point name -> argument types) and its ``restype``
    int, the CUDA error code every entry point returns."""
    lib = library(name)
    for entry, argtypes in signatures.items():
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(t: torch.Tensor, name: str, dtype, shape, device=None, align: int = 1) -> None:
    """Refuse a tensor a kernel cannot read: ValueError unless it is a CUDA
    tensor (on ``device`` when given), of ``shape`` (an int: the number of
    dimensions; a tuple: the sizes, None for any), contiguous and
    ``align``-byte aligned; TypeError unless of ``dtype`` (one or a tuple)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, the kernel's other inputs on {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: the kernel takes {' or '.join(map(str, dtypes))}, "
                        f"got {t.dtype}")
    fits = (t.ndim == shape if isinstance(shape, int) else
            t.ndim == len(shape) and all(s is None or s == n for s, n in zip(shape, t.shape)))
    if not fits or not t.is_contiguous() or t.data_ptr() % align:
        want = (f"{shape}-d" if isinstance(shape, int)
                else "[" + ", ".join("*" if s is None else str(s) for s in shape) + "]")
        raise ValueError(f"{name} must be a contiguous, {align}-byte aligned {want} tensor, "
                         f"got {tuple(t.shape)}")


def launch(fn, device: torch.device, *args) -> None:
    """Call the entry point ``fn`` on ``device`` with ``args`` (a tensor
    passes its data pointer) and the device's current stream appended.
    Raises RuntimeError when it returns a CUDA error."""
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {err}")


_counts: dict[str, int] = {}


def add_count(key: str, n: int = 1) -> None:
    """Add ``n`` to the count under ``key`` (a wrapper's launches, or another
    tally of its own)."""
    _counts[key] = _counts.get(key, 0) + n


def read_counts(*keys: str) -> dict[str, int]:
    """The counts under ``keys``, 0 for a key never counted."""
    return {key: _counts.get(key, 0) for key in keys}


def reset_counts(*keys: str) -> None:
    for key in keys:
        _counts[key] = 0
