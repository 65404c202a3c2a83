"""Device milliseconds a call in cuBLAS GEMM and GEMV kernels (the
partial-DFT products of ``ops/fft.py::complex_matmul`` and the other
products), from the trace."""

import re

from portbench import peaks


def read(rec):
    s = peaks.kernel_seconds(
        rec, lambda n: re.search("gemm|gemv", n, re.IGNORECASE) is not None)
    return None if s is None else 1e3 * s
