"""The port's flagship slice end to end on the CPU, against the JAX package:
``transmit`` then ``receive_batch`` on the same numpy-seeded inputs.

Tolerances: complex128 arithmetic within atol 1e-9; complex64 is held to
decision parity (bytes, found, t2_begin, pr_begin and frame_start exactly
equal; constellation within atol 1e-4, as tests/test_jax_chain.py does for
two complex64 receive paths).  The JAX receiver's frame gather runs the
Pallas kernel in interpret mode (``extract_backend="pallas"``), except in
complex128, where that kernel (complex64 only) would round the capture.
"""

import os
import re
import subprocess
import sys
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

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.models import rx as trx
from c_ofdm_tpu_torch.models import tx as ttx
from c_ofdm_tpu_torch.models.modem import FlagshipStep
from c_ofdm_tpu_torch.ops import extract

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
ATOL128 = 1e-9
ATOL64 = 1e-4
DT = {"c64": (jnp.complex64, torch.complex64, np.complex64),
      "c128": (jnp.complex128, torch.complex128, np.complex128)}
# stock config, and raised thresholds that switch peak_refine on
CONFIGS = {"stock": {}, "peak_refine": dict(pr_level=0.6)}

_jit_receive_batch = jax.jit(jrx.receive_batch, static_argnums=(0,))


def _specs(dtype_name, extract_backend="pallas", **kw):
    jdt, tdt, _ = DT[dtype_name]
    js = jframe.make_frame_spec(JModemConfig(**kw), dtype=jdt,
                                fft_backend="matmul",
                                extract_backend=extract_backend)
    ts = make_frame_spec(ModemConfig(**kw), tdt, device="cpu")
    return js, ts


def _mixed_batch(js, rng, np_dtype):
    """Six captures of frame_len + 1024 samples and the planted truth:
    two clean frames at offset 0, three frames at random offsets with
    amplitude 40, CFO 1e-4 cycles/sample and AWGN at 30 dB SNR, and one
    all-zero row."""
    cfg = js.cfg
    n = cfg.frame_len + 1024
    payload = rng.integers(0, 256, (5, cfg.frame_bytes), dtype=np.uint8)
    frames = np.asarray(jtx.transmit(js, jnp.asarray(payload)),
                        dtype=np.complex128)
    offs = np.concatenate([[0, 0], rng.integers(1, 1025, 3)])
    caps = np.zeros((6, n), np.complex128)
    for b in range(5):
        caps[b, offs[b]:offs[b] + cfg.frame_len] = frames[b]
    k = np.arange(n)
    std = np.sqrt(float((np.abs(frames) ** 2).mean()) * 40.0 ** 2 * 1e-3 / 2)
    caps[2:5] = (caps[2:5] * 40.0 * np.exp(2j * np.pi * 1e-4 * k)
                 + std * (rng.standard_normal((3, n))
                          + 1j * rng.standard_normal((3, n))))
    return caps.astype(np_dtype), offs, payload


def _assert_sync_equal(sj, st):
    for name in ("frame_start", "t2_begin", "pr_begin", "found"):
        np.testing.assert_array_equal(np.asarray(getattr(sj, name)),
                                      getattr(st, name).numpy(), err_msg=name)


@pytest.mark.parametrize("dtype_name", ["c64", "c128"])
def test_transmit_matches_jax(dtype_name):
    js, ts = _specs(dtype_name)
    rng = np.random.default_rng(1)
    payload = rng.integers(0, 256, (4, js.cfg.frame_bytes), dtype=np.uint8)
    fj = np.asarray(jtx.transmit(js, jnp.asarray(payload)))
    ft = ttx.transmit(ts, torch.from_numpy(payload))
    assert ft.dtype == DT[dtype_name][1] and ft.shape == (4, js.cfg.frame_len)
    atol = ATOL128 if dtype_name == "c128" else 1e-5
    np.testing.assert_allclose(fj, ft.numpy(), rtol=0, atol=atol)
    # burst + preamble are the same constants, exactly
    fixed = js.cfg.t2sin_size + js.cfg.preamble_len
    np.testing.assert_array_equal(fj[:, :fixed], ft.numpy()[:, :fixed])
    # int16 staging: the cast truncates, so float rounding may flip isolated
    # samples by 1 LSB (the bound tests/test_jax_chain.py uses for JAX TX
    # against the reference's own source.bin)
    ij = np.asarray(jtx.to_int16(js, jnp.asarray(fj)))
    it = ttx.to_int16(ts, ft).numpy()
    diff = np.abs(ij.astype(np.int32) - it.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).sum() <= ij.size * 0.005
    np.testing.assert_array_equal(
        np.asarray(jtx.from_int16(js, jnp.asarray(ij))),
        ttx.from_int16(ts, torch.from_numpy(ij.copy())).numpy())


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_receive_batch_matches_jax_c64(config):
    """The slice's acceptance check: the port's receive_batch equals the
    JAX receive_batch (matmul backend, Pallas extract in interpret mode) in
    frame_start, found and mac_bytes on a mixed batch, and both recover the
    planted truth."""
    js, ts = _specs("c64", **CONFIGS[config])
    caps, offs, payload = _mixed_batch(js, np.random.default_rng(2),
                                       np.complex64)
    rj, sj = _jit_receive_batch(js, jnp.asarray(caps))
    rt, st = trx.receive_batch(ts, torch.from_numpy(caps))
    _assert_sync_equal(sj, st)
    found = st.found.numpy()
    assert found.tolist() == [True] * 5 + [False]
    np.testing.assert_array_equal(st.frame_start.numpy()[:5], offs)
    np.testing.assert_array_equal(np.asarray(rj.mac_bytes)[found],
                                  rt.mac_bytes.numpy()[found])
    np.testing.assert_array_equal(rt.mac_bytes.numpy()[:5], payload)
    np.testing.assert_allclose(np.asarray(rj.constellation)[found],
                               rt.constellation.numpy()[found],
                               rtol=0, atol=ATOL64)


def test_receive_batch_matches_jax_c128():
    js, ts = _specs("c128", extract_backend="xla")
    caps, offs, payload = _mixed_batch(js, np.random.default_rng(3),
                                       np.complex128)
    rj, sj = _jit_receive_batch(js, jnp.asarray(caps))
    rt, st = trx.receive_batch(ts, torch.from_numpy(caps))
    _assert_sync_equal(sj, st)
    found = st.found.numpy()
    assert found.tolist() == [True] * 5 + [False]
    np.testing.assert_array_equal(rt.mac_bytes.numpy()[:5], payload)
    for name in ("constellation", "chan_est", "cfo"):
        np.testing.assert_allclose(np.asarray(getattr(rj, name))[found],
                                   getattr(rt, name).numpy()[found],
                                   rtol=0, atol=ATOL128, err_msg=name)


def test_receive_capture_and_demod_frame_match_jax():
    js, ts = _specs("c128", extract_backend="xla")
    caps, offs, _ = _mixed_batch(js, np.random.default_rng(4), np.complex128)
    rj, sj = jrx.receive_capture_jit(js, jnp.asarray(caps[3]))
    rt, st = trx.receive_capture(ts, torch.from_numpy(caps[3]))
    assert st.frame_start.shape == () and rt.mac_bytes.dim() == 1
    _assert_sync_equal(sj, st)
    assert int(st.frame_start) == offs[3]
    np.testing.assert_array_equal(np.asarray(rj.mac_bytes), rt.mac_bytes.numpy())
    np.testing.assert_allclose(np.asarray(rj.constellation),
                               rt.constellation.numpy(), rtol=0, atol=ATOL128)
    frames = caps[:2, :js.cfg.frame_len]
    dj = jrx.demod_frames_jit(js, jnp.asarray(frames))
    dt = trx.demod_frame(ts, torch.from_numpy(frames))
    np.testing.assert_array_equal(np.asarray(dj.mac_bytes), dt.mac_bytes.numpy())
    np.testing.assert_allclose(np.asarray(dj.constellation),
                               dt.constellation.numpy(), rtol=0, atol=ATOL128)
    full = trx.demod_frame(ts, torch.from_numpy(frames), estimator="full")
    np.testing.assert_array_equal(full.mac_bytes.numpy(), dt.mac_bytes.numpy())


def test_flagship_step_matches_jax_step():
    """FlagshipStep (payload -> transmit -> receive_batch) against the JAX
    flagship step of bench.py / __graft_entry__.py, complex64."""
    js, ts = _specs("c64")
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, (4, js.cfg.frame_bytes), dtype=np.uint8)
    rj, sj = _jit_receive_batch(js, jtx.transmit(js, jnp.asarray(payload)))
    before = extract.extract_windows.launches
    rt, st = FlagshipStep(ts)(torch.from_numpy(payload))
    assert extract.extract_windows.launches == before   # CPU: plain version
    _assert_sync_equal(sj, st)
    assert bool(st.found.all()) and not st.frame_start.any()
    np.testing.assert_array_equal(rt.mac_bytes.numpy(), payload)
    np.testing.assert_array_equal(np.asarray(rj.mac_bytes), payload)


def test_flagship_buffers_follow_module_to():
    spec = make_frame_spec(ModemConfig(), torch.complex64, device="cpu")
    step = FlagshipStep(spec)
    assert dict(step.named_buffers()).keys() == spec.tensors.keys()
    assert step.bound_spec().device == torch.device("cpu")
    step.to("meta")
    bound = step.bound_spec()
    assert bound.device.type == "meta"
    assert all(t.device.type == "meta" for t in bound.tensors.values())
    assert spec.device == torch.device("cpu")     # the spec itself is untouched


def test_unported_branches_raise():
    with pytest.raises(ValueError, match="fft_backend"):
        make_frame_spec(ModemConfig(), device="cpu", fft_backend="fftw")
    with pytest.raises(ValueError):
        make_frame_spec(ModemConfig(), device="cpu", extract_backend="pallas")
    with pytest.raises(ValueError):
        make_frame_spec(ModemConfig(), torch.float32, device="cpu")


def test_port_never_imports_jax():
    """The port's package imports torch and numpy only: no source file
    imports jax, and building + running the flagship step and a streaming
    buffer, a pallas-backend step, the MAC codec and the channel simulator
    in a fresh interpreter leaves jax and the JAX package out of
    sys.modules."""
    pattern = re.compile(r"^\s*(import jax|from jax|import c_ofdm_tpu\b|"
                         r"from c_ofdm_tpu\b|from c_ofdm_tpu\.)", re.M)
    sources = sorted((REPO / "c_ofdm_tpu_torch").rglob("*.py"))
    assert sources
    for path in sources + [REPO / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "import c_ofdm_tpu_torch\n"
        "from c_ofdm_tpu_torch.models.modem import FlagshipStep\n"
        "from c_ofdm_tpu_torch.models.streaming import StreamingReceiver\n"
        "from c_ofdm_tpu_torch.ops import _kernels, extract\n"
        "step = FlagshipStep(c_ofdm_tpu_torch.make_frame_spec(device='cpu'))\n"
        "res, s = step(torch.zeros((2, step.spec.cfg.frame_bytes),"
        " dtype=torch.uint8))\n"
        "assert bool(s.found.all())\n"
        "spec = c_ofdm_tpu_torch.make_frame_spec("
        "c_ofdm_tpu_torch.ModemConfig(rx_buf_size=2), device='cpu')\n"
        "out = StreamingReceiver(spec, channels=2).feed(torch.zeros("
        "(2, 2 * spec.cfg.frame_len), dtype=torch.complex64))\n"
        "assert not bool(out.valid.any())\n"
        "pspec = c_ofdm_tpu_torch.make_frame_spec(device='cpu',"
        " fft_backend='pallas')\n"
        "res, s = FlagshipStep(pspec)(torch.zeros((2, pspec.cfg.frame_bytes),"
        " dtype=torch.uint8))\n"
        "assert bool(s.found.all())\n"
        "from c_ofdm_tpu_torch.channel.sim import ChannelParams, "
        "apply_channel\n"
        "from c_ofdm_tpu_torch.mac.mac import Mac\n"
        "from c_ofdm_tpu_torch.oracle import reference\n"
        "mac = Mac(frame_bytes=pspec.cfg.frame_bytes)\n"
        "wire = mac.write(torch.zeros((2, mac.payload), dtype=torch.uint8), 1)\n"
        "cap = apply_channel(ChannelParams(), c_ofdm_tpu_torch.models.tx."
        "transmit(pspec, wire))\n"
        "assert bool(mac.read_bytes(wire).valid.all())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'c_ofdm_tpu'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
