"""The port's channel simulator (``c_ofdm_tpu_torch/channel/sim.py``)
against the JAX package's ``apply_channel`` on the CPU.

``jax.random`` streams cannot be reproduced with ``torch.Generator``, so the
initial phases and the AWGN draws are made in JAX exactly as
``c_ofdm_tpu/channel/sim.py:47,61,92`` makes them (split the key, uniform
phases in [0, 2π), normal re/im pairs) and handed to the port as ``phi0``
and ``noise``.  Tolerances: complex128 within 1e-9; complex64 within 1e-5 of
max|x| (the AWGN scale is a float32 mean over the whole batch, which XLA and
PyTorch reduce in different orders, so it differs by a few ulps).

The int16 round trip rounds with ``jnp.round`` in JAX and ``torch.round`` in
the port: both round half to even, so equal inputs quantize equally.  In
complex64 the inputs differ by those few ulps, and a value that lies that
close to a rounding boundary may land one LSB (1/quantize_mult) apart: the
test allows that only where the two packages' unquantized outputs round to
different integers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import ModemConfig as JModemConfig, make_frame_spec
from c_ofdm_tpu.channel import sim as jsim
from c_ofdm_tpu.models import tx as jtx

from c_ofdm_tpu_torch.channel import sim as tsim

torch.set_num_threads(1)

CFG = JModemConfig()
FL = CFG.frame_len
QUIET = 300.0        # dB: the AWGN stage (always on) well below float64 ulps
STAGES = {
    "multipath": dict(snr_db=QUIET, multipath=(0.15 + 0.1j, -0.05j)),
    "cfo": dict(snr_db=QUIET, cfo=3e-4),
    "timing": dict(snr_db=QUIET, timing_offset=1234, capture_len=FL + 1734),
    "crop": dict(snr_db=QUIET, timing_offset=700, capture_len=FL - 300),
    "sco+20": dict(snr_db=QUIET, sco_ppm=20.0, capture_len=FL + 100),
    "sco-20": dict(snr_db=QUIET, sco_ppm=-20.0),
    "awgn": dict(snr_db=10.0),
    "quantize": dict(snr_db=QUIET, quantize_mult=200, amplitude=80.0),
    "all": dict(snr_db=15.0, cfo=-2e-4, timing_offset=400,
                capture_len=FL + 900, multipath=(0.15 + 0.1j,),
                amplitude=80.0, quantize_mult=200, sco_ppm=20.0),
}
DT = {"c64": (np.complex64, jnp.float32, torch.complex64),
      "c128": (np.complex128, jnp.float64, torch.complex128)}


@pytest.fixture(scope="module")
def frames():
    """Three stock frames (float64 IQ) of random payloads."""
    spec = make_frame_spec(CFG, dtype=jnp.complex128)
    payload = np.random.default_rng(0).integers(
        0, 256, (3, CFG.frame_bytes), dtype=np.uint8)
    return np.asarray(jtx.transmit(spec, jnp.asarray(payload)))


def _jax_draws(key, lead, total, rdtype):
    """The phases and normal pairs apply_channel draws from ``key``."""
    k_noise, k_phase = jax.random.split(key)
    phi0 = jax.random.uniform(k_phase, lead, dtype=rdtype, minval=0.0,
                              maxval=2 * np.pi)
    nr = jax.random.normal(k_noise, (*lead, total, 2), dtype=rdtype)
    return torch.from_numpy(np.array(phi0)), torch.from_numpy(np.array(nr))


def _both(kw, x, dtype, seed=7):
    """(JAX output, port output) of the same parameters and draws."""
    np_dt, rdt, tdt = DT[dtype]
    x = x.astype(np_dt)
    key = jax.random.PRNGKey(seed)
    xj = np.asarray(jsim.apply_channel(jsim.ChannelParams(**kw), key,
                                       jnp.asarray(x)))
    phi0, noise = _jax_draws(key, x.shape[:-1], xj.shape[-1], rdt)
    xt = tsim.apply_channel(tsim.ChannelParams(**kw), torch.from_numpy(x),
                            phi0=phi0, noise=noise)
    assert xt.dtype == tdt and xt.shape == xj.shape
    return xj, xt.numpy()


def _assert_matches(kw, x, dtype):
    xj, xt = _both(kw, x, dtype)
    if dtype == "c128":
        np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-9)
        return
    tol = 1e-5 * np.abs(xj).max()
    off = np.abs(xt - xj) > tol
    if not kw.get("quantize_mult"):
        assert not off.any(), np.abs(xt - xj).max() / np.abs(xj).max()
        return
    # a sample may differ only by one LSB, and only where the unquantized
    # outputs of the two packages round to different integers
    m = kw["quantize_mult"]
    uj, ut = _both(dict(kw, quantize_mult=0), x, dtype)
    for part in (np.real, np.imag):
        d = np.abs(part(xt) - part(xj))
        flip = d > tol
        assert np.allclose(d[flip], 1.0 / m, rtol=1e-3)
        straddle = np.round(part(uj) * m) != np.round(part(ut) * m)
        assert not (flip & ~straddle).any()
    assert off.mean() < 1e-3


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("stage", sorted(STAGES))
def test_apply_channel_matches_jax(frames, stage, dtype):
    _assert_matches(STAGES[stage], frames, dtype)


@pytest.mark.parametrize("dtype", sorted(DT))
def test_leading_batch_axis(frames, dtype):
    x = np.stack([frames[:2], frames[1:]])             # [2, 2, frame_len]
    _assert_matches(STAGES["all"], x, dtype)
    _assert_matches(STAGES["sco-20"], x[:, 0], dtype)  # [2, frame_len]
    _assert_matches(STAGES["cfo"], frames[0], dtype)   # one frame [frame_len]


def test_generator_path_is_reproducible(frames):
    """With a torch.Generator (no explicit draws) one seed gives one
    output, another seed another, of the JAX package's shape; the AWGN
    power follows snr_db relative to the frames' power times amplitude²."""
    params = tsim.ChannelParams(**STAGES["all"])
    x = torch.from_numpy(frames.astype(np.complex64))

    def run(seed, p=params):
        return tsim.apply_channel(
            p, x, generator=torch.Generator().manual_seed(seed))

    a, b, c = run(1), run(1), run(2)
    assert a.shape == (3, FL + 900) and a.dtype == torch.complex64
    assert torch.equal(a, b) and not torch.equal(a, c)
    quiet = dataclasses.replace(params, snr_db=QUIET, quantize_mult=0)
    noisy = dataclasses.replace(quiet, snr_db=10.0)
    noise = run(3, noisy) - run(3, quiet)
    want = (x.abs() ** 2).mean() * 80.0 ** 2 * 10 ** (-10.0 / 10)
    got = noise.abs().pow(2).mean()
    assert abs(float(got / want) - 1.0) < 0.03
