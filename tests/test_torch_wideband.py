"""The port's chain under every fft_backend, and the wideband 8k-QAM64
geometry, on the CPU against the JAX package.

* The flagship ``transmit`` and ``receive_batch`` under pallas, xla, ct,
  ct_bf16 and matmul_bf16 (complex64), and xla, ct and pallas (complex128,
  where pallas takes the xla branch in both packages), on the mixed batch of
  tests/test_torch_chain.py.  The JAX run of each (backend, dtype) is made
  once per module and shared by its tests (the JAX pallas receive runs the
  DFT kernel in interpret mode, ~12 s for 6 frames).
* One wideband ``ct`` loopback at B = 1 (the geometry and channel of
  tests/test_configs.py::test_ct_backend_wideband_impaired).
* Streaming buffers under xla and pallas at rx_buf_size 4.

Tolerances: sync fields and bytes on found rows exactly; constellation,
channel estimate and CFO within 1e-9 in complex128 and 1e-4 in complex64
(two float32 receive paths, as tests/test_torch_chain.py holds them).  The
bf16 backends' complex64 receive is held to 4e-3: the two packages' float32
recovery stages differ in the last bits, and an operand that close to a
bfloat16 rounding tie rounds to the neighbouring bfloat16 value (2^-8
relative) in one package only; measured max differences on this batch
1.30e-3 (ct_bf16, two rounded GEMMs) and 1.9e-4 (matmul_bf16).  TX frames
within 1e-5 in complex64 and 1e-9 in complex128 (the TX operands are the
same in both packages, so the bf16 backends round them alike).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import ModemConfig as JModemConfig
from c_ofdm_tpu.channel.sim import ChannelParams, apply_channel
from c_ofdm_tpu.models import frame as jframe
from c_ofdm_tpu.models import rx as jrx
from c_ofdm_tpu.models import streaming as jst
from c_ofdm_tpu.models import tx as jtx

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.models import rx as trx
from c_ofdm_tpu_torch.models import streaming as tst
from c_ofdm_tpu_torch.models import tx as ttx
from c_ofdm_tpu_torch.ops import dft

from test_torch_chain import _assert_sync_equal, _mixed_batch
from test_torch_streaming import _assert_same, _assert_truth, _stream

torch.set_num_threads(1)

DT = {"c64": (jnp.complex64, torch.complex64, np.complex64, 1e-4),
      "c128": (jnp.complex128, torch.complex128, np.complex128, 1e-9)}
CHAIN_CASES = [(b, "c64") for b in ("pallas", "xla", "ct", "ct_bf16",
                                    "matmul_bf16")] + [
    (b, "c128") for b in ("xla", "ct", "pallas")]
# bench.py's wideband geometry (tests/test_configs.py's 8k config)
WIDEBAND = dict(fft_size=8192, num_data_subc=4096, num_pilot_subc=32,
                cp_size=1024, num_symb=2, pr_sin_len=512, mod_type=6)

_jit_receive_batch = jax.jit(jrx.receive_batch, static_argnums=(0,))


@functools.cache
def _specs(backend, dtype_name, **kw):
    jdt, tdt = DT[dtype_name][:2]
    # the JAX Pallas frame gather is complex64 only
    extract = "pallas" if dtype_name == "c64" else "xla"
    js = jframe.make_frame_spec(JModemConfig(**kw), dtype=jdt,
                                fft_backend=backend, extract_backend=extract)
    ts = make_frame_spec(ModemConfig(**kw), tdt, device="cpu",
                         fft_backend=backend)
    return js, ts


@pytest.fixture(scope="module")
def jax_chain():
    """(backend, dtype_name) -> the JAX run on the mixed batch, made once:
    (payload, frames, captures, planted offsets, JAX RxResult, SyncResult)."""
    runs = {}

    def get(backend, dtype_name):
        if (backend, dtype_name) not in runs:
            js, _ = _specs(backend, dtype_name)
            np_dtype = DT[dtype_name][2]
            rng = np.random.default_rng(2)
            caps, offs, payload = _mixed_batch(js, rng, np_dtype)
            frames = np.asarray(jtx.transmit(js, jnp.asarray(payload)))
            rj, sj = _jit_receive_batch(js, jnp.asarray(caps))
            runs[backend, dtype_name] = (payload, frames, caps, offs, rj, sj)
        return runs[backend, dtype_name]
    return get


@pytest.mark.parametrize("backend,dtype_name", CHAIN_CASES)
def test_transmit_matches_jax(backend, dtype_name, jax_chain):
    _, ts = _specs(backend, dtype_name)
    payload, frames, *_ = jax_chain(backend, dtype_name)
    before = dft.dft.launches
    got = ttx.transmit(ts, torch.from_numpy(payload))
    assert dft.dft.launches == before           # CPU: the plain version
    assert got.dtype == DT[dtype_name][1]
    atol = 1e-5 if dtype_name == "c64" else 1e-9
    np.testing.assert_allclose(got.numpy(), frames, rtol=0, atol=atol)


@pytest.mark.parametrize("backend,dtype_name", CHAIN_CASES)
def test_receive_batch_matches_jax(backend, dtype_name, jax_chain):
    """Sync fields exact, bytes exact on found rows and equal to the
    planted payloads, constellation within the dtype's tolerance."""
    _, ts = _specs(backend, dtype_name)
    payload, _, caps, offs, rj, sj = jax_chain(backend, dtype_name)
    rt, st = trx.receive_batch(ts, torch.from_numpy(caps))
    _assert_sync_equal(sj, st)
    found = st.found.numpy()
    assert found.tolist() == [True] * 5 + [False]
    np.testing.assert_array_equal(st.frame_start.numpy()[:5], offs)
    np.testing.assert_array_equal(rt.mac_bytes.numpy()[:5], payload)
    np.testing.assert_array_equal(np.asarray(rj.mac_bytes)[found],
                                  rt.mac_bytes.numpy()[found])
    atol = 4e-3 if backend.endswith("bf16") else DT[dtype_name][3]
    for name in ("constellation", "chan_est", "cfo"):
        np.testing.assert_allclose(np.asarray(getattr(rj, name))[found],
                                   getattr(rt, name).numpy()[found],
                                   rtol=0, atol=atol, err_msg=name)


def test_wideband_ct_loopback_matches_jax():
    """The 8k-QAM64 geometry under ct, complex64, B = 1: a frame through
    the JAX channel simulator (30 dB, CFO 1e-5, offset 701, amplitude 10),
    received by both packages: sync exact, payload exact, constellation
    within 1e-4.  The port's spec holds no partial-DFT basis under ct."""
    js, ts = _specs("ct", "c64", **WIDEBAND)
    assert not {"rx_basis", "tx_basis", "cfo_basis"} & set(ts.tensors)
    cfg = js.cfg
    rng = np.random.default_rng(82)
    payload = rng.integers(0, 256, cfg.frame_bytes, dtype=np.uint8)
    frame = jtx.transmit(js, jnp.asarray(payload))
    np.testing.assert_allclose(
        ttx.transmit(ts, torch.from_numpy(payload)).numpy(),
        np.asarray(frame), rtol=0, atol=1e-5)
    params = ChannelParams(snr_db=30.0, cfo=1e-5, timing_offset=701,
                           capture_len=cfg.frame_len + 4096, amplitude=10.0)
    cap = np.asarray(apply_channel(params, jax.random.PRNGKey(0), frame),
                     dtype=np.complex64)
    rj, sj = jrx.receive_capture_jit(js, jnp.asarray(cap))
    rt, st = trx.receive_capture(ts, torch.from_numpy(cap))
    _assert_sync_equal(sj, st)
    assert bool(st.found) and int(st.frame_start) == 701
    np.testing.assert_array_equal(rt.mac_bytes.numpy(), payload)
    np.testing.assert_array_equal(np.asarray(rj.mac_bytes), payload)
    np.testing.assert_allclose(np.asarray(rj.constellation),
                               rt.constellation.numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_streaming_buffers_match_jax(backend):
    """Two gated buffers (rx_buf_size 4, complex64) under a full-spectrum
    backend: every output and state field as tests/test_torch_streaming.py
    holds them, and every planted frame decoded."""
    js, ts = _specs(backend, "c64", rx_buf_size=4)
    blocks, truth = _stream(js, seed=91, S=2)
    blocks = blocks.astype(np.complex64)
    jstate, tstate = jst.init_state(js), tst.init_state(ts)
    jouts, touts = [], []
    for blk in blocks:
        jstate, jo = jst.process_buffer(js, jstate, jnp.asarray(blk))
        tstate, to = tst.process_buffer(ts, tstate, torch.from_numpy(blk))
        jouts.append((jo, jstate))
        touts.append((to, tstate))
    _assert_same(jouts, touts, "c64")
    _assert_truth(js, touts, truth, 2)
