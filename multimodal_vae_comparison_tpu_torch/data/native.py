"""ctypes bindings for the native host data kernels (``native/mmvae_io.cpp``).

Counterpart of the JAX package's ``data/native.py``, with the same API:
``gather``, ``gather_normalize``, ``one_hot_text`` and ``available``.  These
run on the host, where batches are assembled (row gather, fused uint8 ->
float32 normalize, character one-hot), in C++ with OpenMP, and every one
falls back to numpy when the library cannot be built or loaded.

``native/`` is the repo's shared host C++ source.  The port compiles it with
``$CXX`` or ``g++`` at first use, never at import, into
``build/torch_kernels/`` under a name keyed by a hash of the source and
flags, so an edited source is rebuilt; it writes nothing into ``native/``.
A failed build or load is reported on stderr.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from multimodal_vae_comparison_tpu_torch.ops.kernels._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "mmvae_io.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-fopenmp", "-Wall")

_lock = threading.Lock()
_lib = None   # None: not tried yet; False: unavailable; else the CDLL


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libmmvae_io_{digest}.so"


def _compile(out: Path) -> bool:
    """Build the library into ``out`` with ``$CXX`` (split as make would)
    or g++; where that compiler has no OpenMP runtime, build it serial (the
    results are the same).  On failure say why on stderr and return False."""
    cxx = shlex.split(os.environ.get("CXX", "")) or [shutil.which("g++") or "c++"]
    if not SOURCE.exists():
        return False
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    errors = []
    for flags in (CXX_FLAGS, tuple(f for f in CXX_FLAGS if f != "-fopenmp")):
        try:
            subprocess.run([*cxx, *flags, "-o", str(tmp), str(SOURCE)], check=True,
                           capture_output=True, text=True, timeout=120)
        except subprocess.CalledProcessError as e:
            errors.append(e.stderr.strip()[-2000:])
            continue
        except (OSError, subprocess.SubprocessError) as e:
            print(f"[native] cannot run {' '.join(cxx)} ({type(e).__name__}: {e}); host "
                  "batching falls back to numpy", file=sys.stderr)
            return False
        if errors:
            print(f"[native] {' '.join(cxx)} built the library without OpenMP: "
                  f"{errors[0].splitlines()[-1] if errors[0] else 'no -fopenmp'}",
                  file=sys.stderr)
        os.replace(tmp, out)
        return True
    print(f"[native] {' '.join(cxx)} failed; host batching falls back to numpy:\n"
          + "\n".join(errors), file=sys.stderr)
    return False


def _load() -> None:
    global _lib
    with _lock:
        if _lib is not None:
            return
        path = library_path()
        if not path.exists() and not _compile(path):
            _lib = False
            return
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            print(f"[native] cannot load {path} ({e}); host batching falls back to "
                  "numpy", file=sys.stderr)
            _lib = False
            return
        c_i64 = ctypes.c_int64
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.gather_f32.argtypes = [f32p, i64p, c_i64, c_i64, f32p]
        lib.gather_f32.restype = None
        lib.gather_u8.argtypes = [u8p, i64p, c_i64, c_i64, u8p]
        lib.gather_u8.restype = None
        lib.gather_u8_to_f32.argtypes = [u8p, i64p, c_i64, c_i64, ctypes.c_float, f32p]
        lib.gather_u8_to_f32.restype = None
        lib.one_hot_text.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                                     c_i64, c_i64, c_i64, f32p, u8p]
        lib.one_hot_text.restype = None
        lib.mmvae_io_version.argtypes = []
        lib.mmvae_io_version.restype = ctypes.c_int
        _lib = lib


def available() -> bool:
    """True when the C++ kernels are built and loadable."""
    _load()
    return bool(_lib) and _lib.mmvae_io_version() >= 1


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _check_bounds(idx: np.ndarray, n_src: int):
    """The C kernels are raw memcpys: raise numpy's IndexError instead of
    reading out of bounds (and refuse the negative indices numpy accepts,
    so both paths behave alike)."""
    if len(idx) and (int(idx.min()) < 0 or int(idx.max()) >= n_src):
        raise IndexError(
            f"gather index out of range for source of length {n_src}: "
            f"min={int(idx.min())} max={int(idx.max())}")


def gather(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[i] = src[idx[i]]: native memcpy gather for f32/bool/u8 rows,
    numpy fancy-indexing otherwise."""
    _load()
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    _check_bounds(idx, len(src))
    if not _lib:
        return src[idx]
    n = len(idx)
    row = int(np.prod(src.shape[1:], dtype=np.int64))
    out_shape = (n,) + src.shape[1:]
    if src.dtype == np.float32:
        out = np.empty(out_shape, np.float32)
        _lib.gather_f32(_ptr(src, ctypes.c_float), _ptr(idx, ctypes.c_int64),
                        n, row, _ptr(out, ctypes.c_float))
        return out
    if src.dtype in (np.uint8, np.bool_):
        view = src.view(np.uint8)
        out = np.empty(out_shape, np.uint8)
        _lib.gather_u8(_ptr(view, ctypes.c_uint8), _ptr(idx, ctypes.c_int64),
                       n, row, _ptr(out, ctypes.c_uint8))
        return out.view(src.dtype)
    return src[idx]


def gather_normalize(src: np.ndarray, idx: np.ndarray,
                     scale: float = 1.0 / 255.0) -> np.ndarray:
    """Fused out[i] = src[idx[i]] * scale for uint8 image rows -> float32."""
    _load()
    src = np.ascontiguousarray(src)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    _check_bounds(idx, len(src))
    if not _lib or src.dtype != np.uint8:
        return src[idx].astype(np.float32) * np.float32(scale)
    n = len(idx)
    row = int(np.prod(src.shape[1:], dtype=np.int64))
    out = np.empty((n,) + src.shape[1:], np.float32)
    _lib.gather_u8_to_f32(_ptr(src, ctypes.c_uint8), _ptr(idx, ctypes.c_int64), n, row,
                          ctypes.c_float(scale), _ptr(out, ctypes.c_float))
    return out


def one_hot_text(texts: Sequence[str], seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Batch 27-symbol char one-hot + masks; bit-matches
    ``text.encode_text_batch``."""
    _load()
    if not _lib:
        from multimodal_vae_comparison_tpu_torch.data.text import encode_text_batch
        return encode_text_batch(list(texts), seq_len)
    encoded: List[bytes] = [t.encode("utf8") for t in texts]
    n = len(encoded)
    stride = max(1, max((len(b) for b in encoded), default=1))
    buf = np.zeros((n, stride), np.uint8)
    lengths = np.zeros((n,), np.int32)
    for i, b in enumerate(encoded):
        buf[i, :len(b)] = np.frombuffer(b, np.uint8)
        lengths[i] = len(b)
    out = np.zeros((n, seq_len, 27), np.float32)
    masks = np.zeros((n, seq_len), np.uint8)
    _lib.one_hot_text(buf.ctypes.data_as(ctypes.c_char_p), _ptr(lengths, ctypes.c_int32),
                      n, stride, seq_len, _ptr(out, ctypes.c_float),
                      _ptr(masks, ctypes.c_uint8))
    return out, masks.astype(bool)
