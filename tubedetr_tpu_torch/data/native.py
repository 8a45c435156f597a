"""ctypes bindings of the host staging library (counterpart of ``tubedetr_tpu/data/native.py``).

``tubedetr_tpu_torch/native/staging.cc`` is built at first use with the JAX
package's flags (``g++ -O3 -shared -fPIC -std=c++17 -pthread``) into
``tubedetr_tpu_torch/build/libstaging.so`` and loaded with one worker pool
per process:

* ``resize_normalize_clip(frames_u8, a_h, a_w)``: the sparse separable
  resize of a sampled transform, /255 and the ImageNet normalization;
* ``stage_clip(frames_u8, pad_h, pad_w)``: normalize into a padded buffer;
* ``gather_strided(clip_f32, stride)``: the slow stream, contiguous.

This is host C++ for the data workers, not a device kernel. A build that
fails raises; nothing falls back. The numpy versions beside each function
are the plain versions, chosen only by ``plain=True``. The loader calls
the pool from several threads at once: the library's queue takes
concurrent submissions, and a ctypes call releases the GIL.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading

import numpy as np

from tubedetr_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PATH = os.path.join(_PKG, "native", "staging.cc")
SO_PATH = os.path.join(_PKG, "build", "libstaging.so")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lib = None
_pool = None
_lock = threading.Lock()

_u8p = ctypes.POINTER(ctypes.c_uint8)
_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_int = ctypes.c_int


def build(src: str = SRC_PATH, so: str = SO_PATH) -> str:
    """Compile ``src`` into ``so`` unless ``so`` is newer; returns ``so``.
    The library is written beside ``so`` and renamed into place, so
    processes that build at once never load a half-written file. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, src, "-o", tmp], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {src} failed:\n{proc.stderr[-4000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def get_lib():
    """The loaded library, built at first use, and its worker pool (one a
    process, a thread a core)."""
    global _lib, _pool
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build(SRC_PATH, SO_PATH))
        lib.staging_pool_create.restype = ctypes.c_void_p
        lib.staging_pool_create.argtypes = [_int]
        lib.staging_pool_destroy.restype = None
        lib.staging_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.stage_clip.restype = None
        lib.stage_clip.argtypes = [ctypes.c_void_p, _u8p, _f32p, _int, _int, _int, _int, _int,
                                   _f32p, _f32p]
        lib.gather_strided.restype = None
        lib.gather_strided.argtypes = [ctypes.c_void_p, _f32p, _f32p, _int, _int, _int]
        lib.resize_normalize_clip.restype = None
        lib.resize_normalize_clip.argtypes = [
            ctypes.c_void_p, _u8p, _f32p, _int, _int, _int, _int, _int,
            _i32p, _i32p, _f32p, _i32p, _i32p, _f32p, _f32p, _f32p, _int,
        ]
        _pool = lib.staging_pool_create(max(1, os.cpu_count() or 1))
        _lib = lib
        return _lib


def _mean_std():
    return np.asarray(IMAGENET_MEAN, np.float32), np.asarray(IMAGENET_STD, np.float32)


def _frames(frames_u8: np.ndarray) -> np.ndarray:
    if frames_u8.dtype != np.uint8 or frames_u8.ndim != 4 or frames_u8.shape[3] != 3:
        raise ValueError(f"expected (t, h, w, 3) uint8 frames, got {frames_u8.dtype} {frames_u8.shape}")
    return np.ascontiguousarray(frames_u8)


def stage_clip(frames_u8: np.ndarray, pad_h: int, pad_w: int, plain: bool = False) -> np.ndarray:
    """(t, h, w, 3) uint8 -> (t, pad_h, pad_w, 3) float32 normalized, 0 in the pad."""
    frames_u8 = _frames(frames_u8)
    t, h, w, _ = frames_u8.shape
    if h > pad_h or w > pad_w:
        raise ValueError(f"frames {h}x{w} exceed the pad {pad_h}x{pad_w}")
    mean, std = _mean_std()
    if plain:
        out = np.zeros((t, pad_h, pad_w, 3), np.float32)
        out[:, :h, :w] = (frames_u8.astype(np.float32) / 255.0 - mean) / std
        return out
    lib = get_lib()
    out = np.empty((t, pad_h, pad_w, 3), np.float32)
    lib.stage_clip(_pool, frames_u8.ctypes.data_as(_u8p), out.ctypes.data_as(_f32p),
                   t, h, w, pad_h, pad_w, mean.ctypes.data_as(_f32p), std.ctypes.data_as(_f32p))
    return out


def _csr(mat: np.ndarray):
    """Dense interpolation matrix -> (indptr, indices, data) CSR arrays."""
    nz_rows, nz_cols = np.nonzero(mat)
    indptr = np.zeros(mat.shape[0] + 1, np.int32)
    np.add.at(indptr, nz_rows + 1, 1)
    return (np.ascontiguousarray(np.cumsum(indptr, dtype=np.int32)),
            np.ascontiguousarray(nz_cols.astype(np.int32)),
            np.ascontiguousarray(mat[nz_rows, nz_cols].astype(np.float32)))


def resize_normalize_clip(frames_u8: np.ndarray, ah: np.ndarray, aw: np.ndarray,
                          normalize: bool = True, plain: bool = False) -> np.ndarray:
    """(t, h, w, 3) uint8 -> (t, out_h, out_w, 3) float32: ``A_h @ img @
    A_w^T`` over the nonzeros of the operators, /255 and, with
    ``normalize``, the ImageNet mean and std."""
    frames_u8 = _frames(frames_u8)
    ah, aw = np.asarray(ah), np.asarray(aw)
    t, h, w, _ = frames_u8.shape
    if ah.shape[1] != h or aw.shape[1] != w:
        raise ValueError(f"operators {ah.shape} x {aw.shape} do not fit frames {h}x{w}")
    out_h, out_w = ah.shape[0], aw.shape[0]
    mean, std = _mean_std()
    if plain:
        x = np.einsum("oh,nhwc,pw->nopc", ah.astype(np.float32),
                      frames_u8.astype(np.float32) / 255.0, aw.astype(np.float32), optimize=True)
        return ((x - mean) / std if normalize else x).astype(np.float32)
    lib = get_lib()
    ah_csr, aw_csr = _csr(ah), _csr(aw)
    out = np.empty((t, out_h, out_w, 3), np.float32)
    lib.resize_normalize_clip(
        _pool, frames_u8.ctypes.data_as(_u8p), out.ctypes.data_as(_f32p), t, h, w, out_h, out_w,
        ah_csr[0].ctypes.data_as(_i32p), ah_csr[1].ctypes.data_as(_i32p),
        ah_csr[2].ctypes.data_as(_f32p), aw_csr[0].ctypes.data_as(_i32p),
        aw_csr[1].ctypes.data_as(_i32p), aw_csr[2].ctypes.data_as(_f32p),
        mean.ctypes.data_as(_f32p), std.ctypes.data_as(_f32p), 1 if normalize else 0,
    )
    return out


def gather_strided(clip_f32: np.ndarray, stride: int, plain: bool = False) -> np.ndarray:
    """(t, H, W, 3) float32 -> (ceil(t / stride), H, W, 3) contiguous slow stream."""
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    if plain:
        return np.ascontiguousarray(clip_f32[::stride])
    clip_f32 = np.ascontiguousarray(clip_f32, dtype=np.float32)
    t = clip_f32.shape[0]
    lib = get_lib()
    out = np.empty((-(-t // stride),) + clip_f32.shape[1:], np.float32)
    lib.gather_strided(_pool, clip_f32.ctypes.data_as(_f32p), out.ctypes.data_as(_f32p),
                       t, stride, int(np.prod(clip_f32.shape[1:])))
    return out
