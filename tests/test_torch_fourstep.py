"""K4's four-step and chirp routes, and the port at the 0.37 kHz numerology
sampled at 61.44 Msps (a 165888-point FFT), on the CPU.

``dft_fourstep_ref`` (the four-step kernels' two launches in plain
PyTorch: N1-point DFTs down the columns, the twiddles, N2-point DFTs along
the rows) and ``dft_chirp_ref`` (Bluestein's algorithm with its m-point
FFTs on the plain version of m's route) are what ``dft`` runs on CPU
tensors at those routes' sizes; they are held here against the float64
DFT, and at 4099 against the JAX package's ``dft_pallas`` in interpret
mode (its twiddle planes are 134 MB there; past that they are not built).

Geometry: LTE 5G broadcast's 0.37 kHz subcarrier spacing (3GPP TS 36.211
Rel-16) kept at the AD9361's full 61.44 Msps instead of decimated to
30.72: a 165888-point FFT (2^11·3^4, past the cluster route's 131072)
with an 18432-sample CP, 48000 data + 600 pilot subcarriers, 2 QAM64
symbols, ``pr_sin_len`` 4096.  An oversampled capture, not a 3GPP FFT
size.  The port under ``fft_backend="pallas"`` (the four-step route's
plain version) against the JAX package under ``xla`` at B = 2.

Tolerances: each plain version within 2e-6·max|Y| of the float64 DFT (a
float32 FFT errs by ~2-3e-7·max|Y|: two mixed-radix FFTs of N1 and N2
points and a twiddle product, or two such m-point FFTs and the chirp
products); against ``dft_pallas`` within 1e-5·max|Y| (its float32 dots
of float32 planes err by up to ~1e-6·max|Y| at 4099); transmit within
2e-6·max|x| (two float32 inverse DFTs); tables exactly; positions,
``found`` and decoded bytes exactly, the bytes equal to the payloads.
``torch.set_num_threads(1)``; the JAX run is made once per module.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import ModemConfig as JModemConfig
from c_ofdm_tpu.models import frame as jframe
from c_ofdm_tpu.models import rx as jrx
from c_ofdm_tpu.models import tx as jtx
from c_ofdm_tpu.ops.pallas_fft import dft_pallas

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.io import trace
from c_ofdm_tpu_torch.models import rx as trx
from c_ofdm_tpu_torch.models import tx as ttx
from c_ofdm_tpu_torch.models.modem import FlagshipStep
from c_ofdm_tpu_torch.ops import dft
from portbench.reference import receiver as ref_receiver
from portbench.reference.config import ModemConfig as RefModemConfig
from portbench.traffic import generate

torch.set_num_threads(1)

CPU = torch.device("cpu")
WIDE = dict(fft_size=165888, num_data_subc=48000, num_pilot_subc=600,
            cp_size=18432, num_symb=2, pr_sin_len=4096, mod_type=6)
B = 2
CFO = 1e-6          # 61 Hz at 61.44 Msps, 0.17 of a subcarrier
EXTRA = 4096        # captures are frame_len + EXTRA samples
TOL = 2e-6


def _crandn(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _dft64(x, sign, scale):
    x = x.astype(np.complex128)
    y = np.fft.fft(x) if sign < 0 else np.fft.ifft(x) * x.shape[-1]
    return y * scale


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("sign", [-1, 1])
@pytest.mark.parametrize("n", [117649, 165888, 262144, 4099, 8209, 131071])
def test_plain_versions_match_float64(n, sign, scaled):
    """dft_fourstep_ref (117649 = 49 x 2401, 165888 = 64 x 2592, 262144 =
    64 x 4096) and dft_chirp_ref (primes 4099, 8209 and 131071, m = 8232
    and 16464 on the cluster route, 262144 on the four-step one) on a
    strided view within 2e-6·max|Y| of the float64 DFT."""
    route = dft._route(n)
    assert route == ("fourstep" if n in (117649, 165888, 262144)
                     else "chirp")
    rng = np.random.default_rng(n + 3 * sign)
    wide = _crandn(rng, (2, n + 40))
    view = torch.from_numpy(wide)[:, 40:]
    scale = n ** -0.5 if scaled else 1.0
    plain = dft.dft_fourstep_ref if route == "fourstep" else dft.dft_chirp_ref
    got = plain(view, sign, scale).numpy()
    want = _dft64(wide[:, 40:], sign, scale)
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("sign", [-1, 1])
def test_chirp_at_4099_matches_dft_pallas(sign):
    """At 4099 (a prime past the Bluestein kernel's 4096) dft_chirp_ref and
    the port's dft on a CPU tensor, which runs it, against the JAX
    package's dft_pallas (interpret mode) within 1e-5·max|Y|, leading dims
    kept, no launch counted."""
    x = _crandn(np.random.default_rng(4099 + sign), (2, 1, 4099))
    scale = 1.0 / 4099 if sign > 0 else 1.0
    want = np.asarray(dft_pallas(jnp.asarray(x), sign=sign, scale=scale))
    before = dft.dft.launches
    for got in (dft.dft_chirp_ref(torch.from_numpy(x), sign, scale),
                dft.dft(torch.from_numpy(x), sign, scale)):
        assert got.shape == x.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    assert dft.dft.launches == before


def test_splits_lengths_and_block_shapes():
    """The four-step split takes the largest N1 of the register column
    kernel (N1 = A·B <= 64) with both factors 7-smooth from 16 to 8192,
    else the least N1 above 64; the chirp route's m is the least 7-smooth
    length >= 2n - 1 an FFT route takes; launch 1 runs the register kernel
    at its N1, else blocks of 16 to 64 columns wherever N1 allows; launch 2
    writes up to 4 rows k1 together; every block fits in 1024 threads and
    the card's shared memory."""
    assert dft._fourstep_split(165888) == (64, 2592)
    assert dft._fourstep_split(117649) == (49, 2401)
    assert dft._fourstep_split(262144) == (64, 4096)
    assert dft._fourstep_split(60025) == (49, 1225)
    assert dft._fourstep_split(82944) == (64, 1296)       # cluster's size
    assert dft._fourstep_split(390625) == (125, 3125)
    assert dft._fourstep_split(8192 ** 2) == (8192, 8192)
    for n in (65537, 8192 ** 2 * 2, 7 ** 9, 255):
        assert dft._fourstep_split(n) is None
    assert [dft._chirp_m(n) for n in (4099, 8191, 8209, 65537, 131071)] == [
        8232, 16384, 16464, 131220, 262144]
    assert [dft._route(dft._chirp_m(n)) for n in (4099, 131071)] == [
        "cluster", "fourstep"]
    assert dft._chirp_m(1 << 25) == 1 << 26
    assert dft._fourstep_shape(64, 2592) == (0, 4)        # the 165888 step
    assert dft._fourstep_shape(96, 8192) == (16, 1)       # 786432
    for n in (165888, 117649, 262144, 60025, 131220, 390625, 14348907,
              1 << 26):
        n1, n2 = dft._fourstep_split(n)
        cols, group = dft._fourstep_shape(n1, n2)
        assert (cols == 0) == (n1 in dft._FOURSTEP_REG)
        assert cols == 0 or (cols >= 16) == (n1 <= 512)
        for size, rows in ((n1, cols), (n2, group)):
            assert rows == 0 or dft._block_fits(size, rows)
        assert n1 % group == 0 and group <= dft.FOURSTEP_GROUP


def test_column_kernels_cover_the_four_step_sizes():
    """Of the 7-smooth n on the four-step route, each takes the register
    column kernel exactly where an N1 of ``_FOURSTEP_REG`` splits it with
    N2 <= 8192, else the shared-memory one: so every n past 64 x 8192 =
    524288 takes the shared-memory kernel (390625 = 5^8 and 118098 =
    2·3^10 below it too); every register N1 is picked by some n on the
    route, so no register instance is dead."""
    picked = set()
    for n in dft._smooth_upto(dft.FOURSTEP_MAX_N):
        if dft._route(n) != "fourstep":
            continue
        n1, n2 = dft._fourstep_split(n)
        assert n1 * n2 == n and 16 <= n2 <= 8192
        fits = any(n % a == 0 and n // a <= 8192 for a in dft._FOURSTEP_REG)
        assert (n1 in dft._FOURSTEP_REG) == fits, n
        assert fits or n1 > 64
        picked.add(n1)
    assert max(dft._FOURSTEP_REG) == 64     # so none past 64 x 8192
    for n in (390625, 118098, 64 * 8192 * 3 // 2):
        assert dft._fourstep_split(n)[0] > 64
    assert set(dft._FOURSTEP_REG) <= picked


@pytest.mark.parametrize("n1", sorted(dft._FOURSTEP_REG))
def test_register_column_transform_matches_float64(n1):
    """_dft_regs (the register column kernel's N1 = A·B: A-point
    butterflies, the rotations from the N1-point table, B-point
    butterflies) within 1e-6·max|Y| of the float64 DFT of each row, both
    signs."""
    u = _crandn(np.random.default_rng(n1), (64, n1))
    for sign in (-1, 1):
        got = dft._dft_regs(torch.from_numpy(u), sign).numpy()
        want = _dft64(u, sign, 1.0)
        assert got.dtype == np.complex64
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


def test_fourstep_and_chirp_tables_rounded_once():
    """The four-step table is the n-point table's values at j2·k1 (k1 > 0
    major), and the chirp route's filter the float64 m-point spectrum of
    the conjugate chirp, each rounded once to complex64; cached."""
    for n, sign in ((165888, 1), (117649, -1)):
        n1, n2 = dft._fourstep_split(n)
        tw = dft.fourstep_twiddles(n, n1, sign, CPU).numpy()
        idx = (np.arange(1, n1)[:, None] * np.arange(n2)).reshape(-1)
        np.testing.assert_array_equal(tw, dft._twiddles_np(n, sign)[idx])
        assert tw.shape == ((n1 - 1) * n2,)
    n, sign = 4099, -1
    m = dft._chirp_m(n)
    c = dft._chirp_np(n, sign).conj()
    h = np.zeros(m, np.complex128)
    h[:n] = c
    h[m - n + 1:] = c[1:][::-1]
    got = dft.chirp_filter(n, sign, CPU)
    np.testing.assert_array_equal(got.numpy(),
                                  np.fft.fft(h).astype(np.complex64))
    assert got is dft.chirp_filter(n, sign, CPU)


def test_cpu_dispatch_runs_the_new_plain_versions():
    """A CPU tensor at a four-step or chirp size runs that route's plain
    version (rows of any stride), builds no n x n twiddle planes and counts
    no launch; a launch forced onto either route refuses, before anything
    runs, a size the route does not take."""
    rng = np.random.default_rng(5)
    planes = dft.dft_planes.cache_info()
    counts = (dft.dft.launches, dft.dft.fourstep_launches,
              dft.dft.chirp_launches)
    sig = torch.from_numpy(_crandn(rng, (2, 3 * 121000)))
    view = sig.reshape(2, 3, 121000)[..., 3351:]        # 117649 points
    assert torch.equal(dft.dft(view), dft.dft_fourstep_ref(view.contiguous()))
    x = torch.from_numpy(_crandn(rng, (2, 8209)))
    assert torch.equal(dft.dft(x, +1, 0.25), dft.dft_chirp_ref(x, +1, 0.25))
    assert dft.dft_planes.cache_info() == planes
    assert (dft.dft.launches, dft.dft.fourstep_launches,
            dft.dft.chirp_launches) == counts
    for route, n in (("fourstep", 65537), ("fourstep", 200),
                     ("chirp", 4096), ("chirp", (1 << 25) + 1)):
        with pytest.raises(ValueError, match="does not take"):
            dft._launch(torch.zeros((1, 1), dtype=torch.complex64)
                        .expand(1, n), -1, 1.0, route)


@pytest.mark.parametrize("n", [(1 << 25) + 1, 7 ** 9, 1 << 27])
def test_dft_refuses_past_2_25_before_building_anything(n):
    """Past 2^25 points (a non-7-smooth n, or a 7-smooth one with no split
    into two factors of at most 8192) no route takes n: dft raises
    ValueError naming n, on the CPU and on any other device, before it
    builds a table or allocates an output."""
    assert dft._route(n) is None
    x = torch.zeros((1, 1), dtype=torch.complex64).expand(2, n)  # no storage
    planes = dft.dft_planes.cache_info()
    for dev_x in (x, torch.empty((2, n), dtype=torch.complex64,
                                 device="meta")):
        with pytest.raises(ValueError, match=f"n={n}"):
            dft.dft(dev_x)
    assert dft.dft_planes.cache_info() == planes


# ------------------------------------------------- the 165888 geometry


def _impaired(frames, rng, amp=10.0, snr_db=30.0):
    """Each frame at a random offset in [0, EXTRA] of a capture of
    frame_len + EXTRA samples, with CFO, amplitude and AWGN; returns
    (complex64 captures, offsets)."""
    b, n = frames.shape
    offs = rng.integers(0, EXTRA + 1, b)
    caps = np.zeros((b, n + EXTRA), np.complex128)
    for i in range(b):
        caps[i, offs[i]:offs[i] + n] = frames[i]
    k = np.arange(n + EXTRA)
    std = np.sqrt((np.abs(frames) ** 2).mean() * amp ** 2
                  * 10 ** (-snr_db / 10) / 2)
    caps = (caps * amp * np.exp(2j * np.pi * CFO * k)
            + std * (rng.standard_normal(caps.shape)
                     + 1j * rng.standard_normal(caps.shape)))
    return caps.astype(np.complex64), offs


@functools.cache
def _jax_run():
    """The JAX package under xla: payloads, transmitted frames, impaired
    captures with their offsets, and receive_batch's results on them."""
    js = jframe.make_frame_spec(JModemConfig(**WIDE), dtype=jnp.complex64,
                                fft_backend="xla")
    rng = np.random.default_rng(165888)
    payload = rng.integers(0, 256, (B, js.cfg.frame_bytes), dtype=np.uint8)
    frames = np.asarray(jtx.transmit(js, jnp.asarray(payload)))
    caps, offs = _impaired(frames.astype(np.complex128), rng)
    res, sync = jax.jit(jrx.receive_batch, static_argnums=(0,))(
        js, jnp.asarray(caps))
    return payload, frames, caps, offs, jax.device_get((res, sync))


@functools.cache
def _spec():
    return make_frame_spec(ModemConfig(**WIDE), torch.complex64,
                           device="cpu", fft_backend="pallas")


def test_wide_geometry_and_route():
    """The configuration's frame and K4's route at its FFT size: the
    four-step route at 64 x 2592, past the cluster route's 131072."""
    cfg = _spec().cfg
    assert (cfg.frame_len, cfg.frame_bytes, cfg.preamble_len) == (
        553216, 72000, 184320)
    assert dft._route(cfg.fft_size) == "fourstep"
    assert dft._cluster_split(cfg.fft_size) is None


def test_wide_step_pallas_matches_jax_xla():
    """transmit at B = 2 under pallas within 2e-6·max|x| of the JAX package
    under xla; receive_batch on impaired captures (offsets in [0, 4096],
    CFO 1e-6, 30 dB): frame_start, t2_begin, pr_begin, found and the bytes
    exactly the JAX package's, each frame one sample before its planted
    offset (as the JAX package places it) and the bytes the payloads; the
    port's clean frames decode to the payloads; no n x n twiddle planes
    built."""
    payload, fj, caps, offs, (rj, sj) = _jax_run()
    planes = dft.dft_planes.cache_info()
    ft = ttx.transmit(_spec(), torch.from_numpy(payload))
    assert ft.dtype == torch.complex64 and ft.shape == fj.shape
    np.testing.assert_allclose(ft.numpy(), fj, rtol=0,
                               atol=2e-6 * np.abs(fj).max())
    rt, st = trx.receive_batch(_spec(), torch.from_numpy(caps))
    for field in ("frame_start", "t2_begin", "pr_begin", "found"):
        np.testing.assert_array_equal(getattr(st, field).numpy(),
                                      np.asarray(getattr(sj, field)),
                                      err_msg=field)
    assert st.found.numpy().all()
    # both packages place each impaired frame one sample before its
    # planted offset at this geometry (the JAX package's own timing)
    np.testing.assert_array_equal(st.frame_start.numpy(), offs - 1)
    np.testing.assert_array_equal(rt.mac_bytes.numpy(),
                                  np.asarray(rj.mac_bytes))
    np.testing.assert_array_equal(rt.mac_bytes.numpy(), payload)
    clean, s = trx.receive_batch(_spec(), ft)
    assert s.found.numpy().all() and not s.frame_start.numpy().any()
    np.testing.assert_array_equal(clean.mac_bytes.numpy(), payload)
    assert dft.dft_planes.cache_info() == planes


# ----------------------------- the benchmark's lte_bcast_0p37khz_61m


PORTBENCH = Path(__file__).resolve().parent.parent / "portbench"
# the configuration's modem keys (portbench/configs/lte_bcast_0p37khz_61m.json:
# WIDE's geometry with timing at the matched filter's peak)
CELL_MODEM = json.loads((PORTBENCH / "configs" / "lte_bcast_0p37khz_61m.json")
                        .read_text())["modem"]
# widest |port - reference| allowed on a soft value: the cell's limit
# (portbench/limits/lte_bcast_61m_batch_b8.json, 1.1e-4), set between the
# port's widest gap on the card (4.08e-5 over 12 seeds) and the plain
# reference's narrowest in TF32 (3.04e-4); here the port reads 2.9e-5,
# TF32 3.3e-4
CELL_GAP = json.loads((PORTBENCH / "limits" / "lte_bcast_61m_batch_b8.json")
                      .read_text())["soft_gap"]


def test_cell_configuration_decodes_against_the_reference():
    """The benchmark's ``lte_bcast_0p37khz_61m`` through
    ``FlagshipStep.receive`` under pallas in complex64 (the cell's
    precision; K4's four-step route's plain version): two frames of the
    benchmark's float64 transmit, impaired as the cell's traffic is
    (offsets in [0, 4096], CFO 1e-6, amplitude 10, 30 dB), then one zero
    row.  With the filter's peak timing both frames lie at their planted
    offsets (the auto rule puts them one sample early, as the test above
    pins) with the payloads' bytes and none is found in the zero row; the
    recorder counts ``fourstep_rows`` 3 rows x 3 symbols for the call.
    The soft values lie within the cell's limit of the benchmark's float64
    reference demodulating the same wire samples at the planted starts,
    and the reference in TF32 (the cell's control) does not."""
    cfg = ModemConfig(**CELL_MODEM)
    assert cfg.peak_refine and cfg.fft_size == WIDE["fft_size"]
    assert all(getattr(cfg, k) == v for k, v in WIDE.items())
    ref_cfg = RefModemConfig(**CELL_MODEM)
    rng = np.random.default_rng(61440000)
    payload = rng.integers(0, 256, (B, cfg.frame_bytes), dtype=np.uint8)
    frames = generate.transmit(ref_cfg, torch.from_numpy(payload)).numpy()
    caps, offs = _impaired(frames, rng)
    caps = np.concatenate([caps, np.zeros_like(caps[:1])])
    step = FlagshipStep(make_frame_spec(cfg, torch.complex64, device="cpu",
                                        fft_backend="pallas"))
    trace.enable()
    try:
        res, st = step.receive(torch.from_numpy(caps))
        rows = trace.drain()["counts"]["fourstep_rows"]
    finally:
        trace.disable()
        trace.drain()
    assert rows == caps.shape[0] * (cfg.num_pr_symb + cfg.num_symb)
    assert st.found.tolist() == [True, True, False]
    np.testing.assert_array_equal(st.frame_start[:B].numpy(), offs)
    np.testing.assert_array_equal(res.mac_bytes[:B].numpy(), payload)
    want_frames = torch.from_numpy(np.stack(
        [caps[b, o:o + cfg.frame_len] for b, o in enumerate(offs)]
    ).astype(np.complex128))
    want, _ = ref_receiver.demodulate(ref_cfg, want_frames)
    gap = (res.constellation[:B].to(torch.complex128) - want).abs().max()
    assert gap < CELL_GAP, float(gap)
    low, _ = ref_receiver.demodulate(ref_cfg, want_frames, tf32=True)
    control = (low.to(torch.complex128) - want).abs().max()
    assert control > CELL_GAP, float(control)
