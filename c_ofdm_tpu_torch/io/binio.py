"""Reference-compatible binary I/O (a copy of ``c_ofdm_tpu/io/binio.py``,
numpy only; ``tests/test_torch_io.py`` pins it against the original).

File layouts match `io/io.hpp:15-79`: complex arrays are interleaved
re,im pairs of the element type (float64 for analysis dumps, int16 for SDR
staging); plain double arrays are raw float64.  These are the formats of the
committed golden artifacts (`data/*.bin`) and of the reference's Python
tooling (`python_code/ofdm.py:8-54`), so artifacts dumped here feed the same
plots.
"""

from __future__ import annotations

import numpy as np


def read_complex64f(path: str) -> np.ndarray:
    """Interleaved float64 re,im -> complex128 (e.g. data.bin, constell.bin)."""
    d = np.fromfile(path, dtype=np.float64)
    return d[0::2] + 1j * d[1::2]


def read_complex_int16(path: str) -> np.ndarray:
    """Interleaved int16 re,im -> complex64 (e.g. source.bin)."""
    d = np.fromfile(path, dtype=np.int16).astype(np.float32)
    return (d[0::2] + 1j * d[1::2]).astype(np.complex64)


def read_doubles(path: str) -> np.ndarray:
    return np.fromfile(path, dtype=np.float64)


def write_complex64f(path: str, arr: np.ndarray) -> None:
    arr = np.asarray(arr, dtype=np.complex128)
    out = np.empty(arr.size * 2, dtype=np.float64)
    out[0::2] = arr.real.reshape(-1)
    out[1::2] = arr.imag.reshape(-1)
    out.tofile(path)


def write_complex_int16(path: str, arr: np.ndarray) -> None:
    """complex (already scaled) -> interleaved int16, truncation toward zero
    like the C++ cast (`OFDM/Frame.cpp:252`)."""
    arr = np.asarray(arr)
    out = np.empty(arr.size * 2, dtype=np.int16)
    out[0::2] = np.trunc(arr.real.reshape(-1)).astype(np.int16)
    out[1::2] = np.trunc(arr.imag.reshape(-1)).astype(np.int16)
    out.tofile(path)


def write_doubles(path: str, arr: np.ndarray) -> None:
    np.asarray(arr, dtype=np.float64).tofile(path)


def dump_rx_artifacts(dirpath: str, *, capture=None, t2_corr=None,
                      chan_est=None, constellation=None, tx_int16=None) -> None:
    """Dump the reference loopback's five artifacts (`main.cpp:74-78`) in the
    exact formats its tooling expects."""
    import os
    os.makedirs(dirpath, exist_ok=True)
    if tx_int16 is not None:
        write_complex_int16(os.path.join(dirpath, "source.bin"), tx_int16)
    if capture is not None:
        write_complex64f(os.path.join(dirpath, "data.bin"), capture)
    if t2_corr is not None:
        write_doubles(os.path.join(dirpath, "t2_sin_corr.bin"), t2_corr)
    if chan_est is not None:
        write_complex64f(os.path.join(dirpath, "phases.bin"), chan_est)
    if constellation is not None:
        write_complex64f(os.path.join(dirpath, "constell.bin"), constellation)
