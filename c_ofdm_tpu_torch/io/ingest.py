"""Python binding for the native ingest runtime (``native/ingest.cpp``;
counterpart of ``c_ofdm_tpu/io/ingest.py``, the same ctypes signatures).

Replaces the reference's SDR double-buffer thread (`rx.cpp:48-66`): a C++
producer thread pulls int16-IQ buffers from a file/fd/synthetic source into a
slot ring; ``pop()`` drains one buffer as float32 IQ ready for device upload.

The library is compiled from ``native/ingest.cpp`` at first use, with g++ and
the flags of ``native/Makefile``, into ``c_ofdm_tpu_torch/_build/``; the file
name carries a hash of the source, the flags and the host CPU's feature list
(``-march=native`` makes the binary specific to the CPU that built it).  The
prebuilt ``native/libingest.so`` is never loaded.  Nothing here runs at import
time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent.parent / "native" / "ingest.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"
# native/Makefile:3-4 (CXXFLAGS, LDFLAGS)
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared", "-pthread")

SRC_FILE_REPLAY = 0
SRC_FD_STREAM = 1
SRC_SYNTH_ZERO = 2


class IngestStats(ctypes.Structure):
    _fields_ = [
        ("buffers_produced", ctypes.c_uint64),
        ("buffers_consumed", ctypes.c_uint64),
        ("bytes_ingested", ctypes.c_uint64),
        ("producer_waits", ctypes.c_uint64),
        ("consumer_waits", ctypes.c_uint64),
    ]


def _cpu_features() -> bytes:
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for), or b"" where /proc/cpuinfo is unreadable."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return b""
    keep = [ln for ln in text.splitlines()
            if ln.startswith(("model name", "flags", "Features"))]
    return "\n".join(sorted(set(keep))).encode()


def library_path() -> Path:
    """Where the library built from ``native/ingest.cpp`` lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
                            + _cpu_features()).hexdigest()
    return BUILD / f"libingest-{digest[:16]}.so"


def build() -> Path:
    """Compile ``native/ingest.cpp`` unless a library of the same source,
    flags and CPU exists.  A missing g++ or a failed build raises."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: c_ofdm_tpu_torch builds its "
                           "native ingest library from native/ingest.cpp at "
                           "first use")
    BUILD.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)        # atomic: a concurrent build never sees half
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The loaded ingest library, built if needed; loaded once per
    process."""
    lib = ctypes.CDLL(str(build()))
    lib.ingest_create.restype = ctypes.c_void_p
    lib.ingest_create.argtypes = [ctypes.c_int32, ctypes.c_char_p,
                                  ctypes.c_int64, ctypes.c_int32]
    lib.ingest_pop_f32.restype = ctypes.c_int32
    lib.ingest_pop_f32.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int32]
    lib.ingest_pop_i16.restype = ctypes.c_int32
    lib.ingest_pop_i16.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_int16),
                                   ctypes.c_int32]
    lib.ingest_stats.argtypes = [ctypes.c_void_p, ctypes.POINTER(IngestStats)]
    lib.ingest_destroy.argtypes = [ctypes.c_void_p]
    lib.convert_i16_to_f32.argtypes = [ctypes.POINTER(ctypes.c_int16),
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int64]
    return lib


class NativeIngest:
    """Double-buffered native ingest source.

    samples_per_buf: complex samples per pop (reference: rx_buf_size frames).
    """

    def __init__(self, kind: int, source: str, samples_per_buf: int,
                 n_slots: int = 4):
        self._lib = load_library()
        self.samples_per_buf = samples_per_buf
        self._ring = self._lib.ingest_create(
            kind, source.encode(), samples_per_buf, n_slots)
        if not self._ring:
            raise OSError(f"ingest_create failed for {source!r}")

    def pop_f32(self, timeout_ms: int = 1000,
                out: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
        """One buffer as interleaved float32 IQ [2*samples] or None on EOF.
        ``out``, if given, is a C-contiguous float32 array of 2*samples
        elements (e.g. a pinned host tensor's ``.numpy()``) filled in place."""
        if out is None:
            out = np.empty(self.samples_per_buf * 2, dtype=np.float32)
        elif (out.dtype != np.float32 or out.size != self.samples_per_buf * 2
              or not out.flags.c_contiguous):
            raise ValueError("pop_f32: out must be C-contiguous float32 of "
                             f"{self.samples_per_buf * 2} elements")
        rc = self._lib.ingest_pop_f32(
            self._ring, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            timeout_ms)
        if rc == 1:
            return out
        if rc == 0:
            return None
        raise TimeoutError("ingest pop timed out")

    def pop_complex64(self, timeout_ms: int = 1000) -> Optional[np.ndarray]:
        raw = self.pop_f32(timeout_ms)
        if raw is None:
            return None
        return raw.view(np.complex64)

    def pop_i16(self, timeout_ms: int = 1000) -> Optional[np.ndarray]:
        out = np.empty(self.samples_per_buf * 2, dtype=np.int16)
        rc = self._lib.ingest_pop_i16(
            self._ring, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            timeout_ms)
        if rc == 1:
            return out
        if rc == 0:
            return None
        raise TimeoutError("ingest pop timed out")

    def stats(self) -> IngestStats:
        s = IngestStats()
        self._lib.ingest_stats(self._ring, ctypes.byref(s))
        return s

    def close(self):
        if self._ring:
            self._lib.ingest_destroy(self._ring)
            self._ring = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def convert_i16_to_f32(src: np.ndarray) -> np.ndarray:
    """Standalone native int16 -> float32 (Frame.hpp:472-516 counterpart)."""
    lib = load_library()
    src = np.ascontiguousarray(src, dtype=np.int16)
    dst = np.empty(src.size, dtype=np.float32)
    lib.convert_i16_to_f32(src.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                           dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           src.size)
    return dst.reshape(src.shape)
