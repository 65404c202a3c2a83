"""The port's float64 oracle (``c_ofdm_tpu_torch/oracle/reference.py``)
against the JAX package's (``c_ofdm_tpu/oracle/reference.py``), function by
function on synthetic impaired frames, and the port's complex128 receiver
against its own oracle.

Integers and bytes exactly, floats within 1e-12.  The golden captures of the
reference are not in the repository, so the full-chain check runs on a
frame made here (``Mac`` → ``transmit`` → ``apply_channel``, all of the
port) in place of the recorded one.
"""

import numpy as np
import pytest
import torch

from c_ofdm_tpu.config import ModemConfig as JModemConfig
from c_ofdm_tpu.oracle import reference as jref

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.channel.sim import ChannelParams, apply_channel
from c_ofdm_tpu_torch.mac.mac import Mac
from c_ofdm_tpu_torch.models import rx as trx
from c_ofdm_tpu_torch.models import tx as ttx
from c_ofdm_tpu_torch.oracle import reference as tref

torch.set_num_threads(1)

# stock, and a two-symbol-preamble QAM64 geometry with 16 pilots
CONFIGS = {"stock": {}, "p2_q64": dict(num_pr_symb=2, mod_type=6,
                                       num_pilot_subc=16)}
OFFSET = 1000


def _case(name):
    """(port cfg, JAX cfg, data): a capture holding one frame at OFFSET
    with CFO 1.5e-4, amplitude 30 and AWGN at 35 dB, plus the pieces of
    it that the RX functions take."""
    kw = CONFIGS[name]
    cfg, jcfg = ModemConfig(**kw), JModemConfig(**kw)
    rng = np.random.default_rng(len(name))
    mac_bytes = rng.integers(0, 256, cfg.frame_bytes, dtype=np.uint8)
    frame = tref.tx_frame(cfg, mac_bytes)
    n = OFFSET + cfg.frame_len + 700
    cap = np.zeros(n, np.complex128)
    cap[OFFSET:OFFSET + cfg.frame_len] = frame * 30.0
    cap *= np.exp(2j * np.pi * 1.5e-4 * np.arange(n))
    std = np.sqrt((np.abs(frame) ** 2).mean() * 900 * 10 ** -3.5 / 2)
    cap += std * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    sig = cap[OFFSET + cfg.t2sin_size: OFFSET + cfg.frame_len]
    pre = sig[:cfg.preamble_len]
    msg = sig[cfg.preamble_len:].reshape(cfg.num_symb, cfg.ofdm_len)
    bpsk = tref.modulate(mac_bytes[:cfg.num_data_subc // 4], 1)
    sym = rng.integers(0, 1 << cfg.mod_type, 64)
    pts = (tref.constellation(cfg.mod_type)[sym]
           + 0.05 * (rng.standard_normal(64) + 1j * rng.standard_normal(64)))
    phase = np.cumsum(rng.uniform(-4.0, 4.0, 200))
    data = dict(cap=cap, sig=sig, pre=pre, syms=msg[:, cfg.cp_size:],
                bpsk=bpsk, sym=sym, pts=pts,
                phase=phase, mac=mac_bytes, frame=cap[OFFSET:OFFSET
                                                      + cfg.frame_len])
    return cfg, jcfg, data


# name -> (cfg, data) -> positional arguments; "cfg" stands for the
# package's own config object
CALLS = {
    "subcarrier_maps": lambda d: ("cfg",),
    "constellation": lambda d: (6,),
    "bytes_to_symbols": lambda d: (d["mac"], 6),
    "symbols_to_bytes": lambda d: (d["sym"], "mod"),
    "modulate": lambda d: (d["mac"], 4),
    "hard_demod": lambda d: (d["pts"], "mod"),
    "demodulate_bytes": lambda d: (d["pts"], "mod"),
    "ofdm_modulate": lambda d: ("cfg", d["bpsk"], 2),
    "ofdm_demodulate": lambda d: ("cfg", d["syms"]),
    "preamble_bytes": lambda d: ("cfg",),
    "preamble_points": lambda d: ("cfg",),
    "preamble_time": lambda d: ("cfg",),
    "matched_filter": lambda d: ("cfg",),
    "t2sin_burst": lambda d: ("cfg",),
    "t2_detect_mask": lambda d: ("cfg",),
    "tx_frame": lambda d: ("cfg", d["mac"]),
    "to_int16": lambda d: ("cfg", d["cap"]),
    "t2_ratio_track": lambda d: ("cfg", d["cap"], 37),
    "find_t2sin": lambda d: ("cfg", d["cap"], 0),
    "preamble_corr_track": lambda d: ("cfg", d["cap"], 768),
    "find_preamble": lambda d: ("cfg", d["cap"], 768),
    "pilot_freq_shift": lambda d: ("cfg", d["sig"]),
    "apply_freq_shift": lambda d: (d["sig"], 1.5e-4),
    "cp_freq_correct": lambda d: ("cfg", d["sig"]),
    "common_phase_correct": lambda d: ("cfg", d["sig"]),
    "unwrap_one_step": lambda d: (d["phase"],),
    "chan_est_lq": lambda d: ("cfg", d["pre"]),
    "chan_est_full": lambda d: ("cfg", d["pre"]),
    "rx_frame": lambda d: ("cfg", d["frame"]),
    "rx_capture": lambda d: ("cfg", d["cap"]),
}


def _assert_same(got, want, what):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{what}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if np.issubdtype(want.dtype, np.inexact):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def test_every_oracle_function_is_covered():
    public = {n for n in dir(jref) if not n.startswith("_")
              and callable(getattr(jref, n))
              and n not in ("ModemConfig", "uniform_bytes")}
    assert public == set(CALLS)
    assert all(callable(getattr(tref, n)) for n in CALLS)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", sorted(CALLS))
def test_oracle_function_matches_jax(name, config):
    cfg, jcfg, data = _case(config)
    args = CALLS[name](data)

    def bind(own_cfg):
        names = {"cfg": own_cfg, "mod": cfg.mod_type}
        return [names[a] if isinstance(a, str) else a for a in args]

    want = getattr(jref, name)(*bind(jcfg))
    got = getattr(tref, name)(*bind(cfg))
    _assert_same(got, want, name)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_oracle_decodes_the_synthetic_capture(config):
    cfg, _, data = _case(config)
    mac_bytes, _, _, t2_begin, pr_begin = tref.rx_capture(cfg, data["cap"])
    assert pr_begin - cfg.t2sin_size == OFFSET
    assert t2_begin <= OFFSET + cfg.t2sin_size
    np.testing.assert_array_equal(mac_bytes, data["mac"])
    silent = np.zeros(cfg.ring_len, dtype=np.complex128)
    assert tref.find_t2sin(cfg, silent, 0) == -1
    assert tref.find_preamble(cfg, silent, 0) == -10
    assert tref.rx_capture(cfg, silent) is None


def test_receive_capture_matches_own_oracle():
    """The port's complex128 receive_capture against its own float64
    oracle's rx_capture on a MAC frame sent through ``transmit`` and
    ``apply_channel`` (timing 2345, CFO 2e-4, amplitude 40, 30 dB): the same
    t2_begin and pr_begin, the same MAC bytes, decoded by ``Mac``, and the
    constellation and channel estimate within 1e-9."""
    cfg = ModemConfig()
    spec = make_frame_spec(cfg, torch.complex128, device="cpu")
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    payload = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, mac.payload, dtype=np.uint8))
    frame = ttx.transmit(spec, mac.write(payload, 41))
    params = ChannelParams(snr_db=30.0, cfo=2e-4, timing_offset=2345,
                           capture_len=cfg.frame_len + 4000, amplitude=40.0)
    cap = apply_channel(params, frame,
                        generator=torch.Generator().manual_seed(6))
    res, s = trx.receive_capture(spec, cap)
    mac_bytes, const, chan, t2_begin, pr_begin = tref.rx_capture(
        cfg, cap.numpy())
    assert (int(s.t2_begin), int(s.pr_begin)) == (t2_begin, pr_begin)
    assert int(s.frame_start) == 2345 and bool(s.found)
    np.testing.assert_array_equal(res.mac_bytes.numpy(), mac_bytes)
    np.testing.assert_allclose(res.constellation.numpy(), const, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(res.chan_est.numpy(), chan, rtol=0, atol=1e-9)
    fr = mac.read_soft(res.constellation.real + res.constellation.imag)
    assert bool(fr.valid) and int(fr.seq) == 41
    assert torch.equal(fr.payload, payload)
