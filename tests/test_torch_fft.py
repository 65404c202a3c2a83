"""CPU parity of the port's FFT layer (``ops/fft.py``, ``ops/dft.py`` and the
full-spectrum branches of ``ops/chanest.py``, ``ops/cfo.py`` and
``ops/sync.py``) against the JAX package, on the same numpy-seeded inputs.

Tolerances, each with its reason:

* complex128 transforms within atol 1e-10·n (as tests/test_jax_ops.py holds
  ``ct_dft`` against ``jnp.fft``): exact DFTs summed in other orders;
* K4's plain version against ``dft_pallas`` (interpret mode, as
  tests/test_pallas_fft.py runs it) within 1e-5·max|Y|: both are float32
  dots of the same float32 twiddle planes, summed in another order;
* the radix kernel's plain version ``dft_radix_ref`` against
  ``dft_pallas`` and the float64 DFT within 1e-5·max|Y| too: float32
  radix-8 passes with float32 twiddles, a few ulps per pass;
* the twiddle table exactly: both sides round the same float64 values;
* the bf16 backends in complex128 within 1e-10·n too: both packages round
  the same operands to the same bfloat16 values and sum in float64;
* slices, reshapes and gathers of bins exactly.

The matmul backends are compared up to n = 512: their full 8192-point
basis is a 1 GiB float64 host matrix in either package.  The pallas backend
takes the ``xla`` branch for complex128 in both packages; its complex64
path (K4's plain version here) is held against ``dft_pallas``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import ModemConfig as JModemConfig
from c_ofdm_tpu.models import frame as jframe
from c_ofdm_tpu.ops import cfo as jcfo
from c_ofdm_tpu.ops import chanest as jchanest
from c_ofdm_tpu.ops import fft as jfft
from c_ofdm_tpu.ops import sync as jsync
from c_ofdm_tpu.ops.pallas_fft import _dft_planes, dft_pallas

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.models import frame as tframe
from c_ofdm_tpu_torch.ops import cfo as tcfo
from c_ofdm_tpu_torch.ops import chanest as tchanest
from c_ofdm_tpu_torch.ops import dft as tdft
from c_ofdm_tpu_torch.ops import fft as tfft
from c_ofdm_tpu_torch.ops import sync as tsync

torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOL128 = 1e-9
# stock, and a 1k geometry with 16 pilots
GEOMETRIES = [{}, dict(fft_size=1024, num_data_subc=512, num_pilot_subc=16,
                       cp_size=256, num_symb=4)]
FULL_SPECTRUM = ("xla", "ct", "ct_bf16", "pallas")


def _crandn(rng, shape, dtype=np.complex128):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _t(a):
    return torch.from_numpy(np.array(a))    # a writable copy


def _specs(backend, dtype_name="c128", **kw):
    jdt, tdt = {"c64": (jnp.complex64, torch.complex64),
                "c128": (jnp.complex128, torch.complex128)}[dtype_name]
    js = jframe.make_frame_spec(JModemConfig(**kw), dtype=jdt,
                                fft_backend=backend)
    ts = make_frame_spec(ModemConfig(**kw), tdt, device=CPU,
                         fft_backend=backend)
    return js, ts


# ------------------------------------------------------------ K4 (ops/dft)


@pytest.mark.parametrize("n", [256, 512])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("scaled", [False, True])
def test_dft_plain_version_matches_dft_pallas(n, sign, scaled):
    scale = 1.0 / np.sqrt(n) if scaled else 1.0
    x = _crandn(np.random.default_rng(n + sign), (8, n), np.complex64)
    want = np.asarray(dft_pallas(jnp.asarray(x), sign=sign, scale=scale))
    got = tdft.dft_ref(_t(x), sign, scale)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    ref = (np.fft.fft(x.astype(np.complex128)) if sign < 0
           else np.fft.ifft(x.astype(np.complex128)) * n) * scale
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_dft_leading_dims_and_wrapper_on_cpu():
    """Leading dims (2, 3, 256) against dft_pallas; on CPU tensors the
    wrapper is the plain version (no launch), also for strided and
    conjugated views; other devices raise."""
    rng = np.random.default_rng(0)
    x = _crandn(rng, (2, 3, 256), np.complex64)
    want = np.asarray(dft_pallas(jnp.asarray(x)))
    before = tdft.dft.launches
    got = tdft.dft(_t(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    sig = _t(_crandn(rng, (4, 3, 320), np.complex64))
    view = sig[..., 64:]                       # rows of stride 320
    assert torch.equal(tdft.dft(view, +1), tdft.dft_ref(view.contiguous(), +1))
    assert torch.equal(tdft.dft(view.conj()),
                       tdft.dft_ref(view.conj().resolve_conj()))
    assert tdft.dft.launches == before
    assert tdft.dft.radix_launches == tdft.dft.dense_launches == 0
    w = tdft.dft_planes(256, -1, 1.0, CPU)
    assert w is tdft.dft_planes(256, -1, 1.0, CPU)        # built once
    for sign, scale in ((-1, 1.0), (1, 1 / 16)):
        np.testing.assert_array_equal(
            tdft.dft_planes(256, sign, scale, CPU).numpy(),
            np.stack(_dft_planes(256, sign, scale)))
    with pytest.raises(ValueError, match="no kernel"):
        tdft.dft(torch.zeros((2, 8), dtype=torch.complex64, device="meta"))


@pytest.mark.parametrize("n,route", [
    (8, "dense"), (16, "radix"), (500, "mixed"), (512, "radix"),
    (8192, "radix"), (16384, "cluster"), (1536, "mixed"), (600, "mixed"),
    (448, "mixed"), (6144, "mixed"), (509, "bluestein"), (4093, "bluestein"),
    (8191, "chirp"), (0, "dense"), (12288, "cluster"), (13122, "cluster"),
    (24576, "cluster"), (32768, "cluster"), (65536, "cluster"),
    (19683, "cluster"), (39366, "cluster"), (65537, "chirp"),
    (131072, "cluster"), (82944, "cluster"), (117649, "fourstep"),
    (262144, "fourstep"), (11, "dense"), (4099, "chirp"),
    (131071, "chirp"), (165888, "fourstep"), (60025, "fourstep"),
    (1 << 25, "fourstep"), (1 << 26, "fourstep"), ((1 << 25) - 1, "chirp"),
    ((1 << 25) + 1, None), (7 ** 9, None), (1 << 27, None)])
def test_dft_route_by_size(n, route):
    """The kernel is chosen by n alone: the radix FFT for every power of two
    from 16 to 8192, the mixed-radix FFT for every other 7-smooth n from 16
    to 8192, the cluster FFT for every 7-smooth n from 8193 to 131072 with
    a split n = c·L (c from 3 to 16; L <= 8192), the four-step FFT for
    every other 7-smooth n with a split N1·N2 (both from 16 to 8192),
    Bluestein for every other n from 16 to 4096, the chirp route (Bluestein
    over those FFTs) for every other n up to 2^25, the dense product below
    16 points (n = 0 too: an empty launch), and none past that; each plain
    pass version refuses the sizes its kernel does not take (the mixed one
    takes the radix route's too, the four-step one the cluster route's and
    every radix or mixed n >= 256, the chirp one every n from 4097 to
    2^25), and so does a launch forced onto such a kernel."""
    assert tdft._route(n) == route
    x = torch.zeros((1, 1), dtype=torch.complex64).expand(1, n)
    if route != "radix":
        with pytest.raises(ValueError, match="power of two"):
            tdft.dft_radix_ref(x)
        with pytest.raises(ValueError, match="does not take"):
            tdft._launch(x, -1, 1.0, "radix")
    if route in ("cluster", "fourstep", "bluestein", "chirp", "dense", None):
        with pytest.raises(ValueError, match="7-smooth"):
            tdft.dft_mixed_ref(x)
    if route != "cluster":
        with pytest.raises(ValueError, match="7-smooth from 8193"):
            tdft.dft_cluster_ref(x)
        with pytest.raises(ValueError, match="does not take"):
            tdft._launch(x, -1, 1.0, "cluster")
    if not (route in ("radix", "mixed", "cluster", "fourstep") and n >= 256):
        with pytest.raises(ValueError, match="split n = N1"):
            tdft.dft_fourstep_ref(x)
        with pytest.raises(ValueError, match="does not take"):
            tdft._launch(x, -1, 1.0, "fourstep")
    if route != "bluestein":
        with pytest.raises(ValueError, match="is not from"):
            tdft.dft_bluestein_ref(x)
        with pytest.raises(ValueError, match="does not take"):
            tdft._launch(x, -1, 1.0, "bluestein")
    if not 4096 < n <= 1 << 25:
        with pytest.raises(ValueError, match="dft_chirp_ref: n="):
            tdft.dft_chirp_ref(x)
        with pytest.raises(ValueError, match="does not take"):
            tdft._launch(x, -1, 1.0, "chirp")
    if n == 0:
        assert tdft.dft(x).shape == x.shape
    if route is None:
        with pytest.raises(ValueError, match=f"no route takes n={n}"):
            tdft.dft(x)


def test_forced_route_is_scoped():
    """_forced_route names a route for the block only, nests, and refuses a
    name that is no route."""
    assert tdft._forced is None
    with tdft._forced_route("dense"):
        with tdft._forced_route("mixed"):
            assert tdft._forced == "mixed"
        assert tdft._forced == "dense"
    assert tdft._forced is None
    with pytest.raises(ValueError, match="no route"):
        with tdft._forced_route("fast"):
            pass
    assert tdft._forced is None


def test_fft_twiddles_rounded_once():
    """exp(sign·2πi·k/n) in float64, rounded once to complex64; cached."""
    for n in (16, 512, 8192):
        for sign in (-1, 1):
            tw = tdft.fft_twiddles(n, sign, CPU)
            want = np.exp(sign * 2j * np.pi * np.arange(n) / n)
            assert tw.dtype == torch.complex64 and tw.shape == (n,)
            np.testing.assert_array_equal(tw.numpy(), want.astype(np.complex64))
            assert tw is tdft.fft_twiddles(n, sign, CPU)
    # every entry is the float64 value's nearest float32, component-wise
    tw = tdft.fft_twiddles(8192, 1, CPU).numpy()
    want = np.exp(2j * np.pi * np.arange(8192) / 8192)
    for got, ref in ((tw.real, want.real), (tw.imag, want.imag)):
        assert (np.abs(got - ref)
                <= np.spacing(np.abs(ref).astype(np.float32)) / 2).all()


def _swizzle(i):
    """csrc/dft.cu's swz: the shared-memory slot of block point i."""
    return i ^ ((i >> 3) & 15)


def test_radix_exchange_swizzle_and_banks():
    """The radix kernel's shared-memory layout (csrc/dft.cu: blocks of
    max(256, n/8) threads, n/8 per row, rows packed, swz of the block
    index): a bijection on every block, and at n = 512 every exchange access
    of a warp (8-byte words: one half-warp per wavefront, bank pair = slot
    mod 16) touches 16 distinct bank pairs per half-warp."""
    for lg in range(4, 14):
        n = 1 << lg
        size = max(256, n // 8) // (n // 8) * n
        assert sorted(_swizzle(i) for i in range(size)) == list(range(size))
    n, t_n = 512, 64
    tid = np.arange(256)
    lr, t = tid // t_n, tid % t_n
    accesses = []
    ns = 1
    for i, radix in enumerate(tdft._radices(n)):
        nb = 8 // radix
        if i > 0:                       # reads: point t + k·n/8
            accesses += [lr * n + t + k * t_n for k in range(8)]
        if ns * radix < n:              # writes: expand(j, Ns, R) + r·Ns
            for k in range(8):
                j = t + (k % nb) * t_n
                accesses.append(lr * n + (j // ns) * ns * radix + j % ns
                                + (k // nb) * ns)
        ns *= radix
    assert len(accesses) == 4 * 8       # 2 exchanges, 8 reads + 8 writes
    for acc in accesses:
        slots = np.array([_swizzle(int(i)) for i in acc])
        for half in slots.reshape(-1, 16):
            assert len(set(half % 16)) == 16


@pytest.mark.parametrize("n", [16, 64, 256, 512, 1024, 8192])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("scaled", [False, True])
def test_dft_radix_ref_matches_dft_pallas_and_float64(n, sign, scaled):
    """The radix kernel's passes in plain PyTorch, on a strided view (rows
    of stride n + 64, as the receiver's CP-stripped symbols), against
    dft_pallas (interpret mode) and the float64 DFT."""
    scale = 1.0 / np.sqrt(n) if scaled else 1.0
    rows = 3 if n == 8192 else 6
    wide = _crandn(np.random.default_rng(n - sign), (rows, n + 64),
                   np.complex64)
    x = wide[:, 64:]
    view = _t(wide)[:, 64:]
    assert view.stride() == (n + 64, 1)
    got = tdft.dft_radix_ref(view, sign, scale)
    assert got.dtype == torch.complex64 and got.shape == x.shape
    ref = (np.fft.fft(x.astype(np.complex128)) if sign < 0
           else np.fft.ifft(x.astype(np.complex128)) * n) * scale
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    want = np.asarray(dft_pallas(jnp.asarray(x), sign=sign, scale=scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# ------------------------------------- K4's mixed and Bluestein routes


_MIXED_N = (500, 600, 1536, 6144, 448)
_BLUESTEIN_N = (509, 1021, 4093)


@pytest.mark.parametrize("n", _MIXED_N + _BLUESTEIN_N)
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("scaled", [False, True])
def test_dft_mixed_and_bluestein_refs_match_float64(n, sign, scaled):
    """dft_mixed_ref (the mixed kernel's passes) and dft_bluestein_ref (the
    Bluestein kernel's chirp, filter and m-point passes) on a strided view
    (rows of stride n + 40) against the float64 DFT: within 1e-5·max|Y|,
    and within 4x the error of dft_ref (the 4-GEMM plain version) on the
    same input.  The n x n planes dft_ref builds are dropped after."""
    scale = 1.0 / np.sqrt(n) if scaled else 1.0
    wide = _crandn(np.random.default_rng(n + 3 * sign), (3, n + 40),
                   np.complex64)
    view = _t(wide)[:, 40:]
    assert view.stride() == (n + 40, 1)
    ref_fn = tdft.dft_mixed_ref if n in _MIXED_N else tdft.dft_bluestein_ref
    assert tdft._route(n) == ("mixed" if n in _MIXED_N else "bluestein")
    got = ref_fn(view, sign, scale)
    assert got.dtype == torch.complex64 and got.shape == view.shape
    x64 = wide[:, 40:].astype(np.complex128)
    want = (np.fft.fft(x64) if sign < 0 else np.fft.ifft(x64) * n) * scale
    try:
        plain = tdft.dft_ref(view, sign, scale).numpy()
    finally:
        tdft.dft_planes.cache_clear()
        tfft._dft_matrix_np.cache_clear()
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max()
    assert err <= 4 * np.abs(plain - want).max()


@pytest.mark.parametrize("n", [500, 1536, 448, 509, 1021])
@pytest.mark.parametrize("sign", [-1, 1])
def test_dft_mixed_and_bluestein_refs_match_dft_pallas(n, sign):
    """The routes' plain versions against the JAX package's dft_pallas
    (interpret mode) within 1e-5·max|Y|, leading dims kept."""
    scale = 1.0 / n if sign > 0 else 1.0
    x = _crandn(np.random.default_rng(n - sign), (2, 2, n), np.complex64)
    ref_fn = (tdft.dft_mixed_ref if tdft._route(n) == "mixed"
              else tdft.dft_bluestein_ref)
    got = ref_fn(_t(x), sign, scale)
    want = np.asarray(dft_pallas(jnp.asarray(x), sign=sign, scale=scale))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_new_routes_on_cpu_run_dft_ref():
    """On CPU tensors dft is dft_ref on the radix, mixed and Bluestein
    routes, and dft_cluster_ref on the cluster one (building no n x n
    planes), with no launch counted (tests/test_torch_fourstep.py: the
    four-step and chirp routes)."""
    before = (tdft.dft.launches, tdft.dft.mixed_launches,
              tdft.dft.cluster_launches, tdft.dft.bluestein_launches,
              tdft.dft.dense_launches)
    rng = np.random.default_rng(21)
    for n in (500, 509):
        x = _t(_crandn(rng, (3, n), np.complex64))
        assert torch.equal(tdft.dft(x, +1, 0.5), tdft.dft_ref(x, +1, 0.5))
    planes = tdft.dft_planes.cache_info()
    x = _t(_crandn(rng, (2, 16384), np.complex64))
    assert torch.equal(tdft.dft(x, +1, 0.5),
                       tdft.dft_cluster_ref(x, +1, 0.5))
    assert tdft.dft_planes.cache_info() == planes
    assert (tdft.dft.launches, tdft.dft.mixed_launches,
            tdft.dft.cluster_launches, tdft.dft.bluestein_launches,
            tdft.dft.dense_launches) == before


def test_mixed_plans_and_twiddle_table():
    """The mixed plan is 8s, then the power of two's remainder, then 3s, 5s
    and 7s, multiplying to n; the kernel's twiddle table is the n-point
    table's values (float64, rounded once) gathered r-major per pass."""
    assert tdft._mixed_radices(1536) == (8, 8, 8, 3)
    assert tdft._mixed_radices(500) == (4, 5, 5, 5)
    assert tdft._mixed_radices(6144) == (8, 8, 8, 4, 3)
    assert tdft._mixed_radices(448) == (8, 8, 7)
    assert tdft._mixed_radices(7776) == (8, 4, 3, 3, 3, 3, 3)
    for n in (18, 500, 600, 1536, 6144, 7168, 8000, 6561):
        plan = tdft._mixed_radices(n)
        assert np.prod(plan) == n and set(plan) <= {2, 3, 4, 5, 7, 8}
        assert len(plan) <= 16      # 4 bits a radix in a 64-bit word
    n, sign = 1536, 1
    tw = tdft.mixed_twiddles(n, sign, CPU).numpy()
    full = tdft.fft_twiddles(n, sign, CPU).numpy()
    off, ns = 0, 1
    for radix in tdft._mixed_radices(n):
        if ns > 1:
            block = tw[off:off + (radix - 1) * ns].reshape(radix - 1, ns)
            step = n // (ns * radix)
            for r in range(1, radix):
                np.testing.assert_array_equal(block[r - 1],
                                              full[np.arange(ns) * r * step])
            off += (radix - 1) * ns
        ns *= radix
    assert off == tw.size == 7 * 8 + 7 * 64 + 2 * 512


def test_bluestein_tables_rounded_once():
    """The chirp exp(sign·πi·(k² mod 2n)/n) with k² mod 2n exact in int64,
    and the filter's m-point spectrum, each computed in float64 and rounded
    once to complex64; m the least power of two >= 2n - 1 (at least 64)."""
    assert [tdft._bluestein_m(n) for n in (17, 509, 1021, 4093, 4096)] == [
        64, 1024, 2048, 8192, 8192]
    for n, sign in ((509, -1), (4093, 1)):
        m = tdft._bluestein_m(n)
        k = np.arange(n, dtype=np.int64)
        c = np.exp(sign * 1j * np.pi * ((k * k) % (2 * n)) / n)
        chirp = tdft.bluestein_chirp(n, sign, CPU).numpy()
        np.testing.assert_array_equal(chirp, c.astype(np.complex64))
        # the same values as the unreduced k² where float64 still holds it
        np.testing.assert_allclose(c[:50], np.exp(sign * 1j * np.pi
                                                  * k[:50] ** 2 / n),
                                   rtol=0, atol=1e-12)
        h = np.zeros(m, np.complex128)
        h[:n] = c.conj()
        h[m - n + 1:] = c.conj()[1:][::-1]
        np.testing.assert_array_equal(
            tdft.bluestein_filter(n, sign, CPU).numpy(),
            np.fft.fft(h).astype(np.complex64))
        assert tdft.bluestein_filter(n, sign, CPU) is tdft.bluestein_filter(
            n, sign, CPU)


def test_odd_radix_constants_match_the_kernel_source():
    """csrc/dft.cu's radix-3/5/7 constants (``root``) are the float32
    roundings of cos and sin(2πq/R) in float64, as _odd_roots computes."""
    import re
    from pathlib import Path
    src = (Path(tdft.__file__).resolve().parent.parent / "csrc"
           / "dft.cu").read_text()
    found = re.findall(r"case (\d) \* 8 \+ (\d): return make_float2\("
                       r"([-0-9.e]+)f, ([-0-9.e]+)f\);", src)
    assert len(found) == 2 + 4 + 6
    for radix, q, c, sn in found:
        cos, sin = tdft._odd_roots(int(radix))
        assert np.float32(c) == np.float32(cos[int(q)])
        assert np.float32(sn) == np.float32(sin[int(q)])
        want = np.exp(2j * np.pi * int(q) / int(radix))
        assert np.float32(c) == np.float32(want.real)
        assert np.float32(sn) == np.float32(want.imag)


def test_composite_butterfly_constants_match_the_kernel_source():
    """csrc/dft.cu's factorisations of the composite butterflies (``Split``)
    are _BUTTERFLY_FACTORS, and its rotation constants (``turn``, with
    ``root`` for R = 3, 5, 7) are the float32 roundings of cos and
    sin(2πq/R) in float64 (_root) for every q/R in lowest terms that those
    factorisations rotate by, other than 1/2, 1/4 and 3/4 (exact)."""
    import math
    import re
    from pathlib import Path
    src = (Path(tdft.__file__).resolve().parent.parent / "csrc"
           / "dft.cu").read_text()
    split = re.findall(r"template <> struct Split<(\d+)> \{ static constexpr "
                       r"int A = (\d+), B = (\d+); \};", src)
    assert {int(c): (int(a), int(b)) for c, a, b in split} == \
        tdft._BUTTERFLY_FACTORS
    table = {(int(r), int(q)): (np.float32(c), np.float32(sn))
             for r, q, c, sn in re.findall(
                 r"case (\d+) \* 16 \+ (\d+): return make_float2\("
                 r"([-0-9.e]+)f, ([-0-9.e]+)f\);", src)}
    for r, q, c, sn in re.findall(r"case (\d) \* 8 \+ (\d): return "
                                  r"make_float2\(([-0-9.e]+)f, ([-0-9.e]+)f"
                                  r"\);", src):
        table[int(r), int(q)] = (np.float32(c), np.float32(sn))
    needed = set()
    for c, (a, b) in tdft._BUTTERFLY_FACTORS.items():
        assert a * b == c
        for m2 in range(b):
            for k1 in range(a):
                j = m2 * k1 % c
                g = math.gcd(j, c)
                if j and c // g not in (2, 4):
                    needed.add((c // g, j // g))
    assert needed <= set(table)
    for (r, q), (c, sn) in table.items():
        assert math.gcd(r, q) == 1
        want = np.exp(2j * np.pi * q / r)
        assert (c, sn) == (np.float32(want.real), np.float32(want.imag))
        assert (c, sn) == tuple(np.float32(v) for v in tdft._root(r, q))


def _mixed_accesses(n):
    """The shared-memory slots each pass of the mixed kernel touches per
    warp (csrc/dft.cu: ceil(n/8) threads per row, max(1, 256 / T) rows per
    block, two swizzled buffers of n rounded up to 16 points per row):
    reads of j + r·n/R after the first pass, writes of expand(j, Ns, R) +
    r·Ns before the last, butterflies j = t + b·T."""
    t_n = -(-n // 8)
    rows = max(1, 256 // t_n)
    stride = -(-n // 16) * 16
    tid = np.arange(rows * t_n)
    lr, t = tid // t_n, tid % t_n
    plan = tdft._mixed_radices(n)
    out, ns = [], 1
    for i, radix in enumerate(plan):
        nb = n // radix
        for b in range(-(-8 // radix)):
            j = t + b * t_n
            live = j < nb
            for r in range(radix):
                if i > 0:
                    out.append((lr * 2 * stride + _swizzle(j + r * nb))[live])
                if i + 1 < len(plan):
                    d = (j // ns) * ns * radix + j % ns + r * ns
                    out.append((lr * 2 * stride + _swizzle(d))[live])
        ns *= radix
    return out


@pytest.mark.parametrize("n", [1536, 6144])
def test_mixed_exchange_swizzle_and_banks(n):
    """The mixed kernel's shared-memory exchanges at the 1536-point (LTE)
    and 6144-point plans: the swizzle is a bijection on each padded row,
    and every warp access touches 16 distinct bank pairs per half-warp."""
    stride = -(-n // 16) * 16
    assert sorted(_swizzle(i) for i in range(stride)) == list(range(stride))
    for acc in _mixed_accesses(n):
        for h in range(0, len(acc) - len(acc) % 16, 16):
            assert len(set(acc[h:h + 16] % 16)) == 16


# -------------------------------------------------------------- backends


_SIZES = [(b, n) for b in tfft.BACKENDS for n in (64, 512, 8192)
          if not (b in tfft.MATMUL_BACKENDS and n == 8192)]


@pytest.mark.parametrize("backend,n", _SIZES)
def test_fft_backends_match_jax_c128(backend, n):
    x = _crandn(np.random.default_rng(n), (3, n))
    for jfn, tfn, ref in ((jfft.fft_fwd, tfft.fft_fwd, np.fft.fft(x)),
                          (jfft.ifft_unnorm, tfft.ifft_unnorm,
                           np.fft.ifft(x) * n)):
        want = np.asarray(jfn(jnp.asarray(x), backend))
        got = tfn(_t(x), backend)
        assert got.dtype == torch.complex128
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-10 * n)
        if not backend.endswith("bf16"):
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=1e-10 * n)


@pytest.mark.parametrize("n", [64, 512])
def test_pallas_backend_c64_matches_jax(n):
    """complex64 under pallas: K4's plain version against the JAX pallas
    branch (dft_pallas in interpret mode), both directions."""
    x = _crandn(np.random.default_rng(n), (5, n), np.complex64)
    for jfn, tfn in ((jfft.fft_fwd, tfft.fft_fwd),
                     (jfft.ifft_unnorm, tfft.ifft_unnorm)):
        want = np.asarray(jfn(jnp.asarray(x), "pallas"))
        got = tfn(_t(x), "pallas")
        assert got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_ct_dft_and_bf16_products():
    """ct_dft equals the numpy FFT; it refuses sizes that are not powers of
    two with ValueError; complex_matmul(bf16=True) equals the product of
    the bfloat16-rounded operands in float64 (complex64 input, float32 sums)
    and the JAX bf16 product."""
    rng = np.random.default_rng(7)
    for n in (2, 128, 8192):
        x = _crandn(rng, (2, n))
        np.testing.assert_allclose(tfft.ct_dft(_t(x), -1).numpy(),
                                   np.fft.fft(x), rtol=0, atol=1e-10 * n)
        np.testing.assert_allclose(tfft.ct_dft(_t(x), +1).numpy(),
                                   np.fft.ifft(x) * n, rtol=0, atol=1e-10 * n)
    with pytest.raises(ValueError, match="power-of-two"):
        tfft.ct_dft(torch.zeros((1, 500), dtype=torch.complex64), -1)
    x = _crandn(rng, (4, 3, 256), np.complex64)
    w = _crandn(rng, (256, 40))
    got = tfft.complex_matmul(_t(x), tfft.basis_pair(w, CPU, torch.float32),
                              bf16=True).numpy()

    def bf(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            torch.bfloat16).to(torch.float64).numpy()

    xr, xi = bf(x.real), bf(x.imag)
    wr, wi = bf(w.real.astype(np.float32)), bf(w.imag.astype(np.float32))
    exact = (xr @ wr - xi @ wi) + 1j * (xr @ wi + xi @ wr)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5 * np.abs(exact).max())
    want = np.asarray(jfft.complex_matmul(jnp.asarray(x), w, bf16=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert np.abs(got - x @ w).max() > 1e-3 * np.abs(exact).max()  # rounded


def test_dft_basis_host_and_device_paths():
    """Below 2^23 elements dft_basis is the float64 numpy rows rounded once;
    at or above it the device path (int32 phase index, one cos/sin pass)
    matches the numpy rows in float64 and the JAX device path in float32;
    past 32768 points it raises ValueError."""
    rng = np.random.default_rng(8)
    rows = rng.choice(512, 40, replace=False)
    small = tfft.dft_basis(512, rows, +1, scale=0.5, transpose=True,
                           device=CPU, rdt=torch.float64)
    np.testing.assert_array_equal(
        small.numpy(), tfft.basis_pair((tfft.dft_rows(512, rows, +1) * 0.5).T,
                                       CPU, torch.float64).numpy())
    n = 8192
    rows = np.arange(n // 8) * 7 + 3                  # n * rows = 2^23
    assert n * rows.size == tfft.DEVICE_BASIS_MIN_ELEMS
    big = tfft.dft_basis(n, rows, -1, scale=0.25, device=CPU,
                         rdt=torch.float64)
    # numpy's rows take cos/sin of phases up to 2π·7163 rad (~5e-12 of
    # float64 rounding); the device path reduces r*k mod n exactly first
    want = tfft.dft_rows(n, rows, -1) * 0.25
    np.testing.assert_allclose(big[0].numpy(), want.real, rtol=0, atol=1e-10)
    np.testing.assert_allclose(big[1].numpy(), want.imag, rtol=0, atol=1e-10)
    big32 = tfft.dft_basis(n, rows, -1, transpose=True, device=CPU,
                           rdt=torch.float32)
    jr, ji = jfft.dft_basis(n, rows, -1, transpose=True, rdt=jnp.float32)
    np.testing.assert_allclose(big32[0].numpy(), np.asarray(jr), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(big32[1].numpy(), np.asarray(ji), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="int32"):
        tfft.dft_basis(65536, np.arange(128), device=CPU, rdt=torch.float32)


@pytest.mark.parametrize("rdt", [torch.float32, torch.float64])
def test_dft_basis_device_path_in_blocks(rdt):
    """The device path builds its rows in blocks of 2^23 / n (1024 at n =
    8192: here two whole blocks and a partial one) written into one
    [2, R, n] result, bit for bit the one-pass cos/sin of the whole phase
    index; ``transpose`` is a view of that result."""
    n = 8192
    rows = np.arange(2500) * 5 - 77
    got = tfft.dft_basis(n, rows, -1, scale=0.5, transpose=True, device=CPU,
                         rdt=rdt)
    assert got.shape == (2, n, rows.size) and got.stride() == (
        rows.size * n, 1, n)
    r = torch.as_tensor(rows % n, dtype=torch.int32)
    k = torch.arange(n, dtype=torch.int32)
    ang = (torch.remainder(r[:, None] * k[None, :], n).to(rdt)
           * torch.tensor(-2 * np.pi / n, dtype=rdt))
    s = torch.tensor(0.5, dtype=rdt)
    want = torch.stack([torch.cos(ang) * s, torch.sin(ang) * s])
    assert torch.equal(got, want.transpose(1, 2))


def test_check_backend_names():
    for b in tfft.BACKENDS:
        tfft.check_backend(b)
    for bad in ("fftw", "MATMUL", "", "pallas_bf16"):
        with pytest.raises(ValueError, match="fft_backend"):
            tfft.check_backend(bad)
        with pytest.raises(ValueError):
            tfft.fft_fwd(torch.zeros(8, dtype=torch.complex64), bad)


# ------------------------------------------------------ bins and symbols


@pytest.mark.parametrize("kw", GEOMETRIES)
def test_bin_assembly_and_split_match_jax_and_gathers(kw):
    js, ts = _specs("xla", **kw)
    cfg = js.cfg
    assert ts.structured
    rng = np.random.default_rng(9)
    data = _crandn(rng, (2, 3, cfg.num_data_subc))
    fj = np.asarray(jchanest.tx_assemble_freq(js, jnp.asarray(data)))
    ft = tchanest.tx_assemble_freq(ts, _t(data)).numpy()
    np.testing.assert_array_equal(fj, ft)
    lookup = np.concatenate([np.full((2, 3, 1), cfg.pilot_ampl), data,
                             np.zeros((2, 3, 1))], axis=-1)
    np.testing.assert_array_equal(ft, lookup[..., tchanest._tx_bin_maps(ts)])
    np.testing.assert_array_equal(tchanest._tx_bin_maps(ts),
                                  jchanest._tx_bin_maps(js))
    freq = _crandn(rng, (2, 3, cfg.fft_size))
    pj, dj = jchanest.rx_split_bins(js, jnp.asarray(freq))
    pt, dt = tchanest.rx_split_bins(ts, _t(freq))
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    np.testing.assert_array_equal(pt.numpy(), freq[..., ts.pilot_bins])
    np.testing.assert_array_equal(dt.numpy(), freq[..., ts.data_bins])


def _permuted(js, ts):
    """The same specs with the data bins in another order: a non-canonical
    layout, which takes the gather branches."""
    perm = np.random.default_rng(10).permutation(js.data_bins)
    jp = dataclasses.replace(js, data_bins=perm.astype(np.int32))
    arrays = {k: getattr(ts, k) for k in tframe.ARRAY_FIELDS}
    arrays["data_bins"] = perm.astype(np.int32)
    tp = tframe.frame_spec_from_arrays(
        dataclasses.asdict(ts.cfg), arrays, device=CPU, dtype=ts.dtype,
        fft_backend=ts.fft_backend)
    assert not tp.structured and not jchanest._structured(jp)
    return jp, tp


@pytest.mark.parametrize("layout", ["canonical", "permuted"])
@pytest.mark.parametrize("backend", tfft.BACKENDS)
def test_symbol_transforms_match_jax(backend, layout):
    """ofdm_modulate and bins_transform (complex128) under every backend:
    partial DFT for the matmul backends, full spectrum plus slices (the
    canonical layout) or gathers (a permuted one) for the others."""
    js, ts = _specs(backend)
    if layout == "permuted":
        js, ts = _permuted(js, ts)
    cfg = js.cfg
    rng = np.random.default_rng(11)
    points = _crandn(rng, (3, cfg.num_symb * cfg.num_data_subc))
    tj = np.asarray(jchanest.ofdm_modulate(js, jnp.asarray(points),
                                           cfg.num_symb))
    tt = tchanest.ofdm_modulate(ts, _t(points), cfg.num_symb).numpy()
    np.testing.assert_allclose(tj, tt, rtol=0, atol=ATOL128)
    syms = tj[..., cfg.cp_size:] + 0.01 * _crandn(rng, tj[..., cfg.cp_size:].shape)
    pj, dj = jchanest.bins_transform(js, jnp.asarray(syms))
    pt, dt = tchanest.bins_transform(ts, _t(syms))
    np.testing.assert_allclose(np.asarray(pj), pt.numpy(), rtol=0, atol=ATOL128)
    np.testing.assert_allclose(np.asarray(dj), dt.numpy(), rtol=0, atol=ATOL128)


@pytest.mark.parametrize("backend", FULL_SPECTRUM + ("matmul",))
def test_pilot_freq_shift_matches_jax(backend):
    """The coarse CFO: the full fftshifted spectrum under xla and ct*
    (torch.fft whatever the spec's backend), the full-precision partial
    product under the others; complex128 and complex64."""
    for dtype_name, atol in (("c128", 1e-12), ("c64", 1e-7)):
        js, ts = _specs(backend, dtype_name)
        assert ("cfo_basis" in ts.tensors) == (backend in ("matmul", "pallas"))
        cfg = js.cfg
        rng = np.random.default_rng(12)
        k = np.arange(cfg.preamble_len)
        sig = (np.tile(js.preamble_time, (4, 1))
               * np.exp(2j * np.pi * np.array([[0.0], [3e-4], [-2e-3],
                                               [7e-3]]) * k)
               + 0.05 * _crandn(rng, (4, cfg.preamble_len)))
        sig = sig.astype(np.complex128 if dtype_name == "c128"
                         else np.complex64)
        want = np.asarray(jcfo.pilot_freq_shift(js, jnp.asarray(sig)))
        got = tcfo.pilot_freq_shift(ts, _t(sig)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_t2_fft_track_matches_jax():
    """t2_ratio_track(backend="fft"): the full per-block FFT track."""
    js, ts = _specs("xla")
    cfg = js.cfg
    rng = np.random.default_rng(13)
    cap = 0.1 * _crandn(rng, (2, 20 * cfg.t2sin_size + 17))
    cap[:, 5 * cfg.t2sin_size:6 * cfg.t2sin_size] += js.t2_burst
    want = np.asarray(jsync.t2_ratio_track(js, jnp.asarray(cap), "fft"))
    got = tsync.t2_ratio_track(ts, _t(cap), "fft").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL128)
    part = tsync.t2_ratio_track(ts, _t(cap)).numpy()
    np.testing.assert_allclose(got, part, rtol=0, atol=1e-9)
    jb, jf = jsync.find_t2sin(js, jnp.asarray(cap[0]), backend="fft")
    tb, tf = tsync.find_t2sin(ts, _t(cap), backend="fft")
    assert int(tb[0]) == int(jb) == 5 * cfg.t2sin_size and bool(tf[0])
    with pytest.raises(ValueError, match="partial"):
        tsync.t2_ratio_track(ts, _t(cap), "dense")
