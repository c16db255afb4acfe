"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` compiles, at its first use in a process, into a
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/zerospeech_tts_tpu_torch/<name>-<hash>.so

and is loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
The file name carries a hash of the source, the shared headers and the
flags, so an edited kernel rebuilds and an unchanged one is reused. Every C
entry point launches on the stream it is given, allocates nothing, and
returns ``cudaGetLastError()``; :func:`check` turns a non-zero code into an
exception.

Nothing here runs at import: the CPU tests import every module of the port
on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zerospeech_tts_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # name -> nvcc wall time (0.0 when cached)
build_log: dict[str, str] = {}  # name -> ptxas register/shared-memory report


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the port's "
            "kernels are compiled from csrc/ at their first use on a CUDA tensor"
        )
    return found


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built if missing)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [src, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    so = BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"
    build_seconds[name] = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: concurrent first uses never load a partial file
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.zs_error_string.restype = ctypes.c_char_p
    lib.zs_error_string.argtypes = [ctypes.c_int]
    _libs[name] = lib
    return lib


def bind(lib: ctypes.CDLL, fn: str, n_ptr: int, n_int: int, n_float: int = 0, stream: bool = True):
    """A C entry point taking ``n_ptr`` pointers, ``n_int`` ints,
    ``n_float`` floats and (unless ``stream`` is False) the stream,
    returning an int (a cudaError_t for a launch)."""
    f = getattr(lib, fn)
    f.restype = ctypes.c_int
    f.argtypes = (
        [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
        + [ctypes.c_float] * n_float + ([ctypes.c_void_p] if stream else [])
    )
    return f


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.zs_error_string(err).decode()})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, what: str, shape: tuple, dtype=torch.float32, device=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype/shape
    (and on ``device`` when given)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
