"""MT19937 + libstdc++-compatible byte draw (a frozen copy of the port's
``utils/mt19937.py``, so that the benchmark's reference imports nothing of
the program).

The reference modem seeds its preamble with ``std::mt19937(pr_seed)``
through ``std::uniform_int_distribution<int>(0,255)``
(`OFDM/Frame.cpp:269-273`); these are the preamble bytes the traffic's
frames carry and the reference receiver demodulates against.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = np.uint32(0x9908B0DF)
_UPPER = np.uint32(0x80000000)
_LOWER = np.uint32(0x7FFFFFFF)


def _init_state(seed: int) -> np.ndarray:
    """Knuth-style initialization shared by std::mt19937 and init_genrand."""
    mt = np.empty(_N, dtype=np.uint64)
    mt[0] = seed & 0xFFFFFFFF
    for i in range(1, _N):
        prev = int(mt[i - 1])
        mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF
    return mt.astype(np.uint32)


def _twist(mt: np.ndarray) -> np.ndarray:
    """One full in-place twist, serial-exact (later entries consume fresh ones)."""
    mt = mt.copy()
    for i in range(_N):
        y = (mt[i] & _UPPER) | (mt[(i + 1) % _N] & _LOWER)
        val = mt[(i + _M) % _N] ^ (y >> np.uint32(1))
        if y & np.uint32(1):
            val ^= _MATRIX_A
        mt[i] = val
    return mt


def _temper(mt: np.ndarray) -> np.ndarray:
    y = mt.copy()
    y ^= y >> np.uint32(11)
    y ^= (y << np.uint32(7)) & np.uint32(0x9D2C5680)
    y ^= (y << np.uint32(15)) & np.uint32(0xEFC60000)
    y ^= y >> np.uint32(18)
    return y


def mt19937_uint32(seed: int, count: int) -> np.ndarray:
    """First ``count`` raw 32-bit outputs of std::mt19937(seed)."""
    mt = _init_state(seed)
    out = np.empty(count, dtype=np.uint32)
    produced = 0
    while produced < count:
        mt = _twist(mt)
        tempered = _temper(mt)
        take = min(_N, count - produced)
        out[produced:produced + take] = tempered[:take]
        produced += take
    return out


def uniform_bytes(seed: int, count: int) -> np.ndarray:
    """``count`` draws of libstdc++ ``uniform_int_distribution<int>(0,255)`` over
    ``std::mt19937(seed)``: downscale by ``(2^32-1)//256`` with rejection."""
    scaling = (2**32 - 1) // 256
    past = 256 * scaling
    out: list[int] = []
    drawn = 0
    chunk = max(count + 8, 16)
    while len(out) < count:
        raw = mt19937_uint32(seed, drawn + chunk)[drawn:]
        drawn += chunk
        accepted = raw[raw < past] // scaling
        out.extend(int(v) for v in accepted)
    return np.array(out[:count], dtype=np.uint8)
