"""K4's cluster route (the DFT past 8192 points) and the port at DVB-T2's
16K and 32K FFT sizes, on the CPU.

``dft_cluster_ref`` (the cluster kernel's four steps in plain PyTorch, which
``dft`` runs on CPU tensors at these sizes) is held against the float64 DFT
and, at the powers of two, against the JAX package's own large-n DFT
``c_ofdm_tpu.ops.fft.ct_dft``.  ``dft_pallas`` (the Pallas kernel in
interpret mode) is not run here: at n = 12288-131072 its twiddle planes
alone are 1.2-137 GB, and the complex128 matrix it builds them from on
the host twice that.  The cluster kernel's c-point butterflies (c = 3 to
16, odd and composite) are held against the float64 DFT one by one.

Geometries: the repo's wideband layout (half the bins carry data, 1/128 of
them pilots, 2 symbols, QAM64) at DVB-T2's 16K and 32K FFT sizes with its
1/8 guard interval (ETSI EN 302 755).  The port under ``fft_backend=
"pallas"`` (K4's plain version) against the JAX package under ``xla``.

Tolerances: the plain version within 2e-6·max|Y| of the float64 DFT and of
``ct_dft`` (float32 FFTs of ~1.7e-7·max|Y| error each); transmit within
2e-6·max|x| (two float32 inverse DFTs); positions, ``found`` and decoded
bytes exactly, the bytes equal to the payloads.  ``torch.set_num_threads(1)``;
the JAX runs are made once per module (~40 s, most of it compiles).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import ModemConfig as JModemConfig
from c_ofdm_tpu.models import frame as jframe
from c_ofdm_tpu.models import rx as jrx
from c_ofdm_tpu.models import tx as jtx
from c_ofdm_tpu.ops import fft as jfft

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.models import rx as trx
from c_ofdm_tpu_torch.models import tx as ttx
from c_ofdm_tpu_torch.ops import dft

torch.set_num_threads(1)

DVBT2 = {
    "16k": dict(fft_size=16384, num_data_subc=8192, num_pilot_subc=64,
                cp_size=2048, num_symb=2, pr_sin_len=1024, mod_type=6),
    "32k": dict(fft_size=32768, num_data_subc=16384, num_pilot_subc=128,
                cp_size=4096, num_symb=2, pr_sin_len=2048, mod_type=6),
}
# the CFO each geometry decodes at in both packages (at 32K a CFO of 1e-5,
# a third of a subcarrier, mis-decodes every frame in both: ROADMAP Queue 3)
CFO = {"16k": 1e-5, "32k": 2e-6}
B = 2


def _crandn(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _dft64(x, sign, scale):
    x = x.astype(np.complex128)
    y = np.fft.fft(x) if sign < 0 else np.fft.ifft(x) * x.shape[-1]
    return y * scale


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", [12288, 16384, 32768, 65536, 19683, 39366,
                               82944, 131072])
def test_dft_cluster_ref_matches_float64_and_ct_dft(n, sign, scaled):
    """dft_cluster_ref within 2e-6·max|Y| of the float64 DFT, and at the
    powers of two of the JAX package's ct_dft (two-stage Cooley-Tukey)."""
    rng = np.random.default_rng(n + sign)
    x = _crandn(rng, (3, n))
    scale = n ** -0.5 if scaled else 1.0
    got = dft.dft_cluster_ref(torch.from_numpy(x), sign, scale).numpy()
    want = _dft64(x, sign, scale)
    assert got.dtype == np.complex64 and got.shape == x.shape
    tol = 2e-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    if n & (n - 1) == 0:
        ct = np.asarray(jfft.ct_dft(jnp.asarray(x), sign)) * scale
        np.testing.assert_allclose(got, ct, rtol=0, atol=tol)


def test_cluster_split_and_twiddles():
    """The split n = c·L takes the least c from 3 to 16 with L <= 4096,
    else the least with L <= 8192; the table between the steps is
    exp(sign·2πi·r·k1/n) (r = 1 .. c - 1, k1 < L) computed in float64 and
    rounded once."""
    assert dft._cluster_split(16384) == (4, 4096)
    assert dft._cluster_split(32768) == (8, 4096)
    assert dft._cluster_split(65536) == (16, 4096)
    assert dft._cluster_split(12288) == (3, 4096)
    assert dft._cluster_split(13122) == (6, 2187)
    assert dft._cluster_split(19683) == (9, 2187)
    assert dft._cluster_split(39366) == (6, 6561)
    assert dft._cluster_split(82944) == (12, 6912)
    assert dft._cluster_split(98304) == (12, 8192)
    assert dft._cluster_split(131072) == (16, 8192)
    assert dft._cluster_split(15625) == (5, 3125)
    assert dft._cluster_split(16807) == (7, 2401)
    for n in (8192, 65537, 117649, 262144):
        assert dft._cluster_split(n) is None
    for n, c, sign in ((32768, 8, 1), (82944, 12, -1), (19683, 9, 1)):
        tw = dft.cluster_twiddles(n, c, sign, torch.device("cpu")).numpy()
        r = np.arange(1, c)[:, None]
        k1 = np.arange(n // c)
        want = np.exp(sign * 2j * np.pi * r * k1 / n).astype(np.complex64)
        np.testing.assert_array_equal(tw, want.reshape(-1))


@pytest.mark.parametrize("c", dft.CLUSTER_SPLITS)
def test_cluster_butterfly_matches_float64(c):
    """The cluster kernel's c-point butterfly in plain PyTorch (_dft_small:
    the radix-2/4/8 and 3/5/7 butterflies, composite c as two factors with
    the rotations between them) within 2e-7·max|Y| of the float64 DFT,
    both signs."""
    rng = np.random.default_rng(c)
    u = _crandn(rng, (c, 64))
    w = np.exp(2j * np.pi * np.outer(np.arange(c), np.arange(c)) / c)
    for sign in (-1, 1):
        got = torch.stack(dft._dft_small(list(torch.from_numpy(u)), sign))
        want = (w if sign > 0 else w.conj()) @ u.astype(np.complex128)
        assert got.dtype == torch.complex64
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-7 * np.abs(want).max())


def test_cluster_sizes_on_cpu_run_the_plain_version():
    """A CPU tensor at a size of the cluster route runs dft_cluster_ref
    (rows of any stride), builds no n x n twiddle planes and counts no
    launch; a launch on the cluster route refuses, before anything runs, a
    size the route does not take."""
    rng = np.random.default_rng(3)
    planes = dft.dft_planes.cache_info()
    counts = (dft.dft.launches, dft.dft.cluster_launches)
    sig = torch.from_numpy(_crandn(rng, (2, 3 * 18432)))
    view = sig.reshape(2, 3, 18432)[..., 2048:]     # the RX symbol view
    assert torch.equal(dft.dft(view), dft.dft_cluster_ref(view.contiguous()))
    x = torch.from_numpy(_crandn(rng, (2, 65536)))
    assert torch.equal(dft.dft(x, +1, 0.25), dft.dft_cluster_ref(x, +1, 0.25))
    assert dft.dft_planes.cache_info() == planes
    assert (dft.dft.launches, dft.dft.cluster_launches) == counts
    for n in (8192, 117649, 65537):
        with pytest.raises(ValueError, match="does not take"):
            dft._launch(torch.zeros((1, n), dtype=torch.complex64), -1, 1.0,
                        "cluster")


def _captures(frames, rng, cfo, extra=1024, amp=40.0, snr_db=30.0):
    """Each frame at a random offset in [1, extra] of a capture of frame_len
    + extra samples, with CFO, amplitude and AWGN; returns (complex64
    captures, offsets)."""
    b, n = frames.shape
    offs = rng.integers(1, extra + 1, b)
    caps = np.zeros((b, n + extra), np.complex128)
    for i in range(b):
        caps[i, offs[i]:offs[i] + n] = frames[i]
    k = np.arange(n + extra)
    std = np.sqrt((np.abs(frames) ** 2).mean() * amp ** 2
                  * 10 ** (-snr_db / 10) / 2)
    caps = (caps * amp * np.exp(2j * np.pi * cfo * k)
            + std * (rng.standard_normal(caps.shape)
                     + 1j * rng.standard_normal(caps.shape)))
    return caps.astype(np.complex64), offs


@functools.cache
def _jax_run(name):
    """The JAX package under xla: payloads, transmitted frames, impaired
    captures with their offsets, and receive_batch's results on them."""
    cfg = JModemConfig(**DVBT2[name])
    js = jframe.make_frame_spec(cfg, dtype=jnp.complex64, fft_backend="xla")
    rng = np.random.default_rng(cfg.fft_size)
    payload = rng.integers(0, 256, (B, cfg.frame_bytes), dtype=np.uint8)
    frames = np.asarray(jtx.transmit(js, jnp.asarray(payload)))
    caps, offs = _captures(frames.astype(np.complex128), rng, CFO[name])
    res, sync = jax.jit(jrx.receive_batch, static_argnums=(0,))(
        js, jnp.asarray(caps))
    return payload, frames, caps, offs, jax.device_get((res, sync))


@pytest.mark.parametrize("name", sorted(DVBT2))
def test_dvbt2_geometry_pallas_matches_jax_xla(name):
    """transmit and receive_batch at B = 2 under pallas (every complex64
    FFT through K4's cluster route: its plain version here): TX within
    2e-6·max|x| of the JAX package under xla; on impaired captures
    frame_start, t2_begin, pr_begin, found and the bytes exactly the JAX
    package's, the offsets the planted ones and the bytes the payloads;
    the clean frames decode to the payloads."""
    payload, fj, caps, offs, (rj, sj) = _jax_run(name)
    ts = make_frame_spec(ModemConfig(**DVBT2[name]), torch.complex64,
                         device="cpu", fft_backend="pallas")
    assert dft._route(ts.cfg.fft_size) == "cluster"
    planes = dft.dft_planes.cache_info()
    ft = ttx.transmit(ts, torch.from_numpy(payload)).numpy()
    assert ft.dtype == np.complex64 and ft.shape == fj.shape
    np.testing.assert_allclose(ft, fj, rtol=0, atol=2e-6 * np.abs(fj).max())
    rt, st = trx.receive_batch(ts, torch.from_numpy(caps))
    for field in ("frame_start", "t2_begin", "pr_begin", "found"):
        np.testing.assert_array_equal(getattr(st, field).numpy(),
                                      np.asarray(getattr(sj, field)),
                                      err_msg=field)
    assert st.found.numpy().all()
    np.testing.assert_array_equal(st.frame_start.numpy(), offs)
    np.testing.assert_array_equal(rt.mac_bytes.numpy(),
                                  np.asarray(rj.mac_bytes))
    np.testing.assert_array_equal(rt.mac_bytes.numpy(), payload)
    clean, _ = trx.receive_batch(ts, torch.from_numpy(ft))
    np.testing.assert_array_equal(clean.mac_bytes.numpy(), payload)
    assert dft.dft_planes.cache_info() == planes
