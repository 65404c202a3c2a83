"""The streaming receiver off the stock geometry: the same impaired stream
through both packages' ``process_buffer``, gated and dense.

The geometries and streams are those of ``tests/test_geometry_sweep.py``
(its ``_sample_cfg`` draws, its ``_impaired_stream`` with the JAX ``Mac``
and ``transmit``).  Per geometry: positions, ``valid`` and the bytes of the
valid slots equal between the packages in both sync modes, and the port's
``Mac.write`` gives the wire bytes of the JAX ``Mac``.  Dense mode is
compared at every geometry, including those where the JAX sweep does not
hold it to the planted truth (a pilot-heavy lattice makes its matched
filter non-discriminative): the two packages must still agree.

By default 7 of the sweep's 20 geometries run, chosen to cover a
two-symbol preamble, mod_type 1, 2, 4, 6 and 8 and 4, 8 and 16 pilots;
``TORCH_GEOM_FULL=1`` runs all 20.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import make_frame_spec as jmake_frame_spec
from c_ofdm_tpu.models import streaming as jst
from test_geometry_sweep import SEED, _impaired_stream, _sample_cfg

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.mac.mac import Mac
from c_ofdm_tpu_torch.models import streaming as tst

torch.set_num_threads(1)

N_CONFIGS = 20
DEFAULT = (2, 3, 4, 7, 13, 17, 19)


def _sweep():
    """The sweep's geometries, drawn as test_geometry_sweep._cfgs draws
    them (same seed, same de-duplication)."""
    rng = np.random.default_rng(SEED)
    seen, out = set(), []
    while len(out) < N_CONFIGS:
        cfg = _sample_cfg(rng)
        key = (cfg.fft_size, cfg.num_data_subc, cfg.num_pilot_subc,
               cfg.cp_size, cfg.num_symb, cfg.t2sin_size, cfg.pr_sin_len,
               cfg.mod_type)
        if key not in seen:
            seen.add(key)
            out.append(cfg)
    return out


CONFIGS = _sweep()


def _id(i):
    c = CONFIGS[i]
    return (f"{i}_fft{c.fft_size}_d{c.num_data_subc}_p{c.num_pilot_subc}"
            f"_cp{c.cp_size}_s{c.num_symb}_t{c.t2sin_size}_m{c.pr_sin_len}"
            f"_q{c.mod_type}_P{c.num_pr_symb}")


def _slots(out):
    v = np.asarray(out.valid)
    return (v.tolist(), np.asarray(out.positions)[v].tolist(),
            np.asarray(out.mac_bytes)[v].tolist())


def test_default_set_covers_the_geometry_space():
    picked = [CONFIGS[i] for i in DEFAULT]
    assert {c.num_pr_symb for c in picked} == {1, 2}
    assert {c.mod_type for c in picked} == {1, 2, 4, 6, 8}
    assert {c.num_pilot_subc for c in picked} == {4, 8, 16}


@pytest.mark.parametrize(
    "index", range(N_CONFIGS) if os.environ.get("TORCH_GEOM_FULL") == "1"
    else DEFAULT, ids=_id)
def test_process_buffer_matches_jax(index):
    jcfg = CONFIGS[index]
    js = jmake_frame_spec(jcfg, dtype=jnp.complex64)
    cfg = ModemConfig(**dataclasses.asdict(jcfg))
    ts = make_frame_spec(cfg, torch.complex64, device="cpu")
    seed = jcfg.fft_size * 1000 + jcfg.mod_type
    sig, wire = _impaired_stream(js, np.random.default_rng(seed))

    # the stream's first draw is the payloads: the port's Mac writes them
    # to the same wire bytes
    mac = Mac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    payloads = np.random.default_rng(seed).integers(
        0, 256, (len(wire), mac.payload), dtype=np.uint8)
    got = mac.write(torch.from_numpy(payloads), torch.arange(len(wire)))
    np.testing.assert_array_equal(got.numpy(), wire)

    max_frames = cfg.rx_buf_size + 1
    for mode in ("gated", "dense"):
        _, oj = jst.process_buffer(js, jst.init_state(js), jnp.asarray(sig),
                                   max_frames, mode)
        _, ot = tst.process_buffer(ts, tst.init_state(ts),
                                   torch.from_numpy(sig), max_frames, mode)
        sj, st = _slots(oj), _slots(ot)
        assert st[0] == sj[0], f"{mode}: valid differs"
        assert st[1] == sj[1], f"{mode}: positions differ"
        assert st[2] == sj[2], f"{mode}: bytes of the valid slots differ"
        if mode == "gated":
            assert st[2] == wire.tolist(), "gated: payload != planted"
