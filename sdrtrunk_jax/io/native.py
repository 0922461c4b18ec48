"""ctypes bindings for the native ingest runtime (native/iq_runtime.c):
lock-free SPSC IQ ring buffer with drop-on-overflow + USB sample-format
converters. Builds the shared library on demand (cc is in the image);
falls back to NumPy implementations when no compiler is available.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["IqRingBuffer", "convert_u8_iq", "convert_s16_iq",
           "convert_packed12_iq", "native_available"]

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libiqruntime.so"
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    try:
        if not _LIB_PATH.exists():
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(str(_LIB_PATH))
    except (OSError, subprocess.CalledProcessError):
        _build_failed = True
        return None
    lib.iq_ring_create.restype = ctypes.c_void_p
    lib.iq_ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
    lib.iq_ring_destroy.argtypes = [ctypes.c_void_p]
    for name in ("iq_ring_available", "iq_ring_capacity",
                 "iq_ring_dropped"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_void_p]
    lib.iq_ring_overflowed.restype = ctypes.c_int
    lib.iq_ring_overflowed.argtypes = [ctypes.c_void_p]
    lib.iq_ring_write.restype = ctypes.c_size_t
    lib.iq_ring_write.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_size_t]
    lib.iq_ring_read.restype = ctypes.c_size_t
    lib.iq_ring_read.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_float),
                                 ctypes.c_size_t]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


class IqRingBuffer:
    """SPSC complex-sample ring with reference-matching drop-on-overflow
    (OverflowableTransferQueue analog). Uses the native library when
    available, NumPy otherwise (same semantics, single-threaded)."""

    def __init__(self, capacity: int, reset_threshold: int | None = None):
        self.capacity = capacity
        reset = reset_threshold if reset_threshold is not None \
            else capacity // 2
        lib = _load()
        self._lib = lib
        if lib is not None:
            self._ring = lib.iq_ring_create(capacity, reset)
        else:
            self._buf = np.zeros((0, 2), np.float32)
            self._dropped = 0
            self._overflow = False
            self._reset = reset

    def __del__(self):
        if getattr(self, "_lib", None) is not None and \
                getattr(self, "_ring", None):
            self._lib.iq_ring_destroy(self._ring)
            self._ring = None

    @staticmethod
    def _as_pairs(iq: np.ndarray) -> np.ndarray:
        if np.iscomplexobj(iq):
            return np.stack([iq.real, iq.imag], axis=-1).astype(np.float32)
        return np.ascontiguousarray(iq, np.float32).reshape(-1, 2)

    def write(self, iq: np.ndarray) -> int:
        pairs = self._as_pairs(iq)
        n = pairs.shape[0]
        if self._lib is not None:
            ptr = pairs.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            return int(self._lib.iq_ring_write(self._ring, ptr, n))
        space = self.capacity - self._buf.shape[0]
        todo = min(n, space)
        if todo < n:
            self._dropped += n - todo
            self._overflow = True
        self._buf = np.concatenate([self._buf, pairs[:todo]])
        return todo

    def read(self, max_samples: int) -> np.ndarray:
        """-> float32 (n, 2) I/Q pairs (the host->device wire format)."""
        if self._lib is not None:
            out = np.empty((max_samples, 2), np.float32)
            ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            got = int(self._lib.iq_ring_read(self._ring, ptr, max_samples))
            return out[:got]
        got = min(max_samples, self._buf.shape[0])
        out, self._buf = self._buf[:got], self._buf[got:]
        if self._buf.shape[0] < self._reset:
            self._overflow = False
        return out

    @property
    def available(self) -> int:
        if self._lib is not None:
            return int(self._lib.iq_ring_available(self._ring))
        return self._buf.shape[0]

    @property
    def dropped(self) -> int:
        if self._lib is not None:
            return int(self._lib.iq_ring_dropped(self._ring))
        return self._dropped

    @property
    def overflowed(self) -> bool:
        if self._lib is not None:
            return bool(self._lib.iq_ring_overflowed(self._ring))
        return self._overflow


def _convert(native_name, np_fallback):
    def fn(data: bytes | np.ndarray) -> np.ndarray:
        raw = np.frombuffer(data, np.uint8) if isinstance(data, bytes) \
            else np.asarray(data)
        lib = _load()
        if lib is None:
            return np_fallback(raw)
        cfn = getattr(lib, native_name)
        if native_name == "convert_u8_iq":
            n = len(raw)
            out = np.empty(n, np.float32)
            cfn.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                            ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
            cfn(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
            return out
        if native_name == "convert_s16_iq":
            vals = raw.view(np.int16) if raw.dtype == np.uint8 else \
                raw.astype(np.int16)
            n = len(vals)
            out = np.empty(n, np.float32)
            cfn.argtypes = [ctypes.POINTER(ctypes.c_int16),
                            ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
            cfn(vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
            return out
        # packed 12-bit: 2 values per 3 bytes
        n = (len(raw) // 3) * 2
        out = np.empty(n, np.float32)
        cfn.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                        ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
        cfn(raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        return out
    return fn


def _np_u8(raw):
    return ((raw.astype(np.float32) - 127.5) / 127.5)


def _np_s16(raw):
    vals = raw.view(np.int16) if raw.dtype == np.uint8 else raw
    return vals.astype(np.float32) / 32768.0


def _np_packed12(raw):
    n = (len(raw) // 3) * 2
    out = np.empty(n, np.float32)
    b = raw[: (len(raw) // 3) * 3].reshape(-1, 3).astype(np.uint16)
    a = (b[:, 0] << 4) | (b[:, 1] >> 4)
    c = ((b[:, 1] & 0x0F) << 8) | b[:, 2]
    out[0::2] = (a.astype(np.float32) - 2048.0) / 2048.0
    out[1::2] = (c.astype(np.float32) - 2048.0) / 2048.0
    return out


convert_u8_iq = _convert("convert_u8_iq", _np_u8)
convert_s16_iq = _convert("convert_s16_iq", _np_s16)
convert_packed12_iq = _convert("convert_packed12_iq", _np_packed12)
