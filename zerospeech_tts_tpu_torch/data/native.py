"""ctypes binding of the native corpus decoder ``native/wav_reader.cpp``
(the port's counterpart of ``zerospeech_tts_tpu/data/native.py``).

``load_and_trim`` decodes and trims one utterance in two native calls; it
equals :func:`zerospeech_tts_tpu_torch.dsp.wavio.load_wav` followed by
``trim_silence`` on the corpus's wavs (tests hold the two to each other).
The C++ file is built as it stands, at its first use in a process, with
``g++ -O3 -shared -fPIC`` into the port's build directory, keyed by a
digest of the source and the flags (a changed source rebuilds). A failed
build or a failed decode raises: nothing decodes another way.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from zerospeech_tts_tpu_torch.ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "wav_reader.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
MAX_SECONDS = 600  # the decode buffer: longer files fail to decode

_lib: ctypes.CDLL | None = None


def build() -> Path:
    """The shared library built from ``native/wav_reader.cpp`` (built if
    missing). Raises RuntimeError when there is no C++ compiler or it
    fails."""
    if not SOURCE.exists():
        raise RuntimeError(f"{SOURCE} is missing: the native wav decoder is built from it")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"wav_reader-{digest}.so"
    if so.exists():
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, c++ or $CXX) to build native/wav_reader.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{cxx} failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent first use never loads a partial file
    return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.wr_decode.restype = ctypes.c_int
        lib.wr_decode.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                                  ctypes.c_int]
        lib.wr_trim.restype = ctypes.c_int
        lib.wr_trim.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
                                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
                                ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    return _lib


def load_wav_native(path: str | Path, sr: int) -> np.ndarray:
    """Decode to mono float32 at ``sr``; raises ValueError on a file it
    cannot decode (corrupt, unsupported, or longer than MAX_SECONDS)."""
    lib = _load()
    buf = np.empty(sr * MAX_SECONDS, dtype=np.float32)
    n = lib.wr_decode(str(path).encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      buf.shape[0], sr)
    if n < 0:
        raise ValueError(f"native wav decode failed ({n}) for {path}")
    return buf[:n].copy()


def trim_native(y: np.ndarray, top_db: float, frame_length: int = 2048,
                hop_length: int = 512) -> np.ndarray:
    """``y`` without its leading and trailing frames more than ``top_db``
    below the peak frame RMS (librosa.effects.trim semantics)."""
    lib = _load()
    y = np.ascontiguousarray(y, dtype=np.float32)
    s, e = ctypes.c_int64(), ctypes.c_int64()
    lib.wr_trim(y.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), y.shape[0], top_db, frame_length,
                hop_length, ctypes.byref(s), ctypes.byref(e))
    return y[s.value : e.value]


def load_and_trim(path: str | Path, sr: int, top_db: float | None) -> np.ndarray:
    """Native decode, then the native trim unless ``top_db`` is None."""
    y = load_wav_native(path, sr)
    return y if top_db is None else trim_native(y, top_db)
