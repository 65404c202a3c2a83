"""BASELINE config #4 (tests/test_baseline_configs.py::
test_config4_64_parallel_streams_one_chip) through the port: 64 frames of
the stock config, complex64, through the JAX package's ``apply_channel``
(CFO 2.5e-3 cycles/sample, 28 dB, its own PRNG draws), then both packages'
``demod_frames_jit`` on the same captures.

Held: the port's bytes equal the JAX package's and the payloads, exactly;
the per-frame coarse CFO within 1e-9 of the JAX package's (float32 values
near 2.5e-3, whose ulp is 2.3e-10: a few ulps of two float32 receive paths)
and within 1e-3 of the injected value, as the JAX test holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import ModemConfig as JModemConfig
from c_ofdm_tpu.channel.sim import ChannelParams, apply_channel
from c_ofdm_tpu.models import frame as jframe
from c_ofdm_tpu.models import rx as jrx
from c_ofdm_tpu.models import tx as jtx

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.models import rx as trx

torch.set_num_threads(1)

B = 64
CFO = 2.5e-3


@pytest.mark.parametrize("backend", ["xla", "matmul"])
def test_config4_64_streams_match_jax(backend):
    js = jframe.make_frame_spec(JModemConfig(), dtype=jnp.complex64,
                                fft_backend=backend)
    ts = make_frame_spec(ModemConfig(), torch.complex64, device="cpu",
                         fft_backend=backend)
    payload = np.random.default_rng(64).integers(
        0, 256, (B, js.cfg.frame_bytes), dtype=np.uint8)
    frames = jtx.transmit(js, jnp.asarray(payload))
    cap = apply_channel(ChannelParams(snr_db=28.0, cfo=CFO, amplitude=1.0),
                        jax.random.PRNGKey(0), frames)
    rj = jrx.demod_frames_jit(js, cap)
    rt = trx.demod_frames_jit(ts, torch.from_numpy(np.array(cap)))
    np.testing.assert_array_equal(rt.mac_bytes.numpy(),
                                  np.asarray(rj.mac_bytes))
    np.testing.assert_array_equal(rt.mac_bytes.numpy(), payload)
    np.testing.assert_allclose(rt.cfo.numpy(), np.asarray(rj.cfo), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(rt.cfo.numpy(), CFO, rtol=0, atol=1e-3)
