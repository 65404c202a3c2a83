"""The JAX package's streaming soak (tests/test_streaming_soak.py) through
the port: the same 1200-buffer stream (small geometry, frames at random
gaps, CFO 1e-4, +12 ppm sample clock, 30 dB), built by that test's own
``_planted_stream`` with the JAX ``Mac`` and ``transmit``, fed buffer by
buffer to the port's ``process_buffer`` and read back with the port's
``Mac.read_soft``.

Held, as the JAX soak holds itself: every planted frame decoded exactly
once, in order, CRC-valid, with its payload and its MAC seq, which starts
below the uint32 wrap and crosses it mid-run; ``frames_seen`` grows by the
valid slots of each buffer.  Under the port's default ``matmul`` backend
and under ``pallas`` (K4's plain version on the CPU).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu.models import frame as jframe
from test_streaming_soak import CFG, N_BUFFERS, _planted_stream

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.mac.mac import Mac
from c_ofdm_tpu_torch.models import streaming

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def stream():
    spec = jframe.make_frame_spec(CFG, dtype=jnp.complex64)
    return _planted_stream(spec, np.random.default_rng(20260821))


@pytest.mark.parametrize("backend", ["matmul", "pallas"])
def test_soak_1200_buffers_exactly_once(stream, backend):
    buffers, payloads, seqs, _ = stream
    assert buffers.shape[0] == N_BUFFERS
    fields = {k: v for k, v in vars(CFG).items() if not k.startswith("_")}
    spec = make_frame_spec(ModemConfig(**fields), torch.complex64,
                           device="cpu", fft_backend=backend)
    mac = Mac(frame_bytes=CFG.frame_bytes, spread=CFG.mod_type)
    state = streaming.init_state(spec)
    got_payload, got_seq, seen = [], [], 0
    for b in range(N_BUFFERS):
        state, out = streaming.process_buffer(
            spec, state, torch.from_numpy(buffers[b]), CFG.rx_buf_size + 1)
        v = out.valid
        if bool(v.any()):
            frames = mac.read_soft(out.diag[v])
            assert bool(frames.valid.all()), f"CRC-invalid frame in buffer {b}"
            got_payload.append(frames.payload.numpy())
            got_seq.append(frames.seq.numpy())
        assert int(state.frames_seen) == seen + int(v.sum())
        seen = int(state.frames_seen)
    got_seq = np.concatenate(got_seq)
    assert got_seq.shape[0] == len(seqs)
    np.testing.assert_array_equal(got_seq, seqs.astype(np.int64))
    np.testing.assert_array_equal(np.concatenate(got_payload), payloads)
    assert seqs[0] > seqs[-1]           # the wrap happened inside the run
