"""The port's sharded receiver and channel-sharded stream in real worlds of
ranks: processes spawned by ``c_ofdm_tpu_torch.parallel.launch.run_world``
on the CPU, joined in a gloo group, each rank on its own block with the
halo moved by ``torch.distributed``.  Held against the JAX package's
``make_sharded_receiver`` and ``make_sharded_streaming`` on meshes of the
same shapes built from the conftest's 8 virtual CPU devices.

Each world is spawned once per module (the ranks run the port's own
targets, ``launch.receive_rank`` / ``launch.stream_rank``, which import no
jax) and every scenario of ``tests/test_sharded.py`` rides in it as its own
channels: boundary straddlers with a silent channel, the capture-tail rule,
and independent channels.  Tolerances as in ``tests/test_torch_parallel.py``
(complex64): positions, valid, num_found exact, mac_bytes exact on the
valid slots, diag and cfo within 1e-4 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu.models import streaming as jst
from c_ofdm_tpu.parallel import ingest as jingest
from c_ofdm_tpu.parallel import mesh as jmesh
from c_ofdm_tpu.parallel import sharded as jsharded

from c_ofdm_tpu_torch.models import streaming
from c_ofdm_tpu_torch.parallel import launch

from test_torch_cuda import NO_LAUNCHES
from test_torch_parallel import (CFG, _specs, as_numpy, assert_same,
                                 build_capture, decoded)

torch.set_num_threads(1)

N_TIME = 2
BLOCK = 4 * CFG.frame_len
TOTAL = N_TIME * BLOCK
MAX_FRAMES = 6
FL = CFG.frame_len
# per scenario: (starts, seed, cfo) of each of its two channels; None is a
# silent channel
STRADDLE = [8000, BLOCK - FL // 3, BLOCK + 8000]
SCENARIOS = {
    "straddlers": [(STRADDLE, 0, 1e-4), None],
    "tail": [([8000, TOTAL - FL], 5, 1e-4),
             ([8000, TOTAL - FL + 2048], 6, 1e-4)],
    "independent": [([500, 2 * FL + 3000, 5 * FL + 100], 1, 1e-4),
                    ([500, 2 * FL + 3000, 5 * FL + 100], 2, -2e-4)],
}
WORLDS = {"2x2": (2, 2), "1x2": (1, 2)}


@pytest.fixture(scope="module")
def captures():
    """[6, TOTAL] complex64, two channels per scenario in SCENARIOS order,
    and each channel's (planted starts, payloads)."""
    rows, truth = [], []
    for chans in SCENARIOS.values():
        for ch in chans:
            if ch is None:
                rows.append(np.zeros(TOTAL))
                truth.append(([], None))
                continue
            starts, seed, cfo = ch
            sig, pl = build_capture(len(starts), TOTAL, starts, seed=seed,
                                    cfo=cfo)
            rows.append(sig)
            truth.append((starts, pl))
    return np.stack(rows).astype(np.complex64), truth


@pytest.fixture(scope="module")
def jax_outs(captures):
    """JAX make_sharded_receiver's global view and its sharded capture on
    each world's mesh shape: {world: (mesh, out, {device id: shard})}."""
    caps, _ = captures
    js, _ = _specs("c64")
    res = {}
    for name, (nc, nt) in WORLDS.items():
        jm = jmesh.make_modem_mesh(nc, nt, devices=jax.devices()[:nc * nt])
        arr = jingest.make_global_capture(jm, caps)
        out = as_numpy(jsharded.make_sharded_receiver(js, jm, MAX_FRAMES)(arr))
        shards = {s.device.id: np.asarray(s.data)
                  for s in arr.addressable_shards}
        res[name] = (jm, out, shards)
    return res


@pytest.fixture(scope="module")
def port_outs(captures):
    """Each world spawned once: every rank's result of receive_rank."""
    caps, _ = captures
    return {name: launch.run_world(
        nc * nt, "c_ofdm_tpu_torch.parallel.launch:receive_rank",
        backend="gloo", device="cpu",
        args=(CFG, torch.complex64, "matmul", caps, nc, nt, MAX_FRAMES))
        for name, (nc, nt) in WORLDS.items()}


@pytest.mark.parametrize("world", list(WORLDS))
def test_gathered_output_matches_jax(world, jax_outs, port_outs):
    """Every rank gathers the same global view, equal to JAX's."""
    _, jout, _ = jax_outs[world]
    ranks = port_outs[world]
    for r, res in enumerate(ranks):
        for k, v in res["out"].items():
            np.testing.assert_array_equal(v, ranks[0]["out"][k],
                                          err_msg=f"rank {r}: {k}")
    assert ranks[0]["out"]["valid"].shape == (6, N_TIME, MAX_FRAMES)
    assert_same(jout, ranks[0]["out"], "c64", world)


@pytest.mark.parametrize("world", list(WORLDS))
def test_ranks_sit_where_jax_devices_sit(world, jax_outs, port_outs):
    """Rank r sits at (r // n_time, r % n_time), where the JAX mesh has
    device r, and its make_global_capture block is device r's shard; on the
    CPU no kernel is launched."""
    jm, _, shards = jax_outs[world]
    for r, res in enumerate(port_outs[world]):
        c, t = res["coords"]
        assert (c, t) == divmod(r, N_TIME)
        assert jm.devices[c, t].id == r
        np.testing.assert_array_equal(res["block"], shards[r])
        assert res["launches"] == NO_LAUNCHES


def _global_starts(out, c):
    pos = out["positions"][c] + (np.arange(N_TIME) * BLOCK)[:, None]
    return sorted((pos[out["valid"][c]] - CFG.t2sin_size).tolist())


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scenario_decodes_the_planted_frames(world, scenario, captures,
                                             port_outs):
    """tests/test_sharded.py's scenarios: every planted frame whose span fits
    the capture decodes exactly once, at its start, with its payload and a
    valid CRC; a silent channel and a frame cut off by the capture end give
    nothing."""
    _, truth = captures
    out = port_outs[world][0]["out"]
    first = 2 * list(SCENARIOS).index(scenario)
    for c in (first, first + 1):
        starts, payloads = truth[c]
        want = [s for s in starts if s + FL <= TOTAL]
        got = _global_starts(out, c)
        assert len(got) == len(want), (c, got, want)
        assert np.abs(np.asarray(got) - np.asarray(want)).max(initial=0) <= 1
        frames = decoded(out, c)
        assert sorted(frames) == list(range(len(want)))
        for seq, (pl, ok) in frames.items():
            assert ok and np.array_equal(pl, payloads[seq])
    if scenario == "straddlers":
        # the boundary frame is decoded by the left block, from the halo
        valid = out["valid"][first]
        assert valid[0].sum() == 2 and valid[1].sum() == 1


def test_a_failing_rank_fails_the_world():
    """A rank that raises fails run_world with its traceback: here the
    mesh's ValueError in a world of 2 asked for n_channel = 3."""
    caps = np.zeros((3, BLOCK), np.complex64)
    with pytest.raises(RuntimeError, match="not divisible by n_channel=3"):
        launch.run_world(2, "c_ofdm_tpu_torch.parallel.launch:receive_rank",
                         backend="gloo", device="cpu",
                         args=(CFG, torch.complex64, "matmul", caps, 3, 0,
                               2))


# ---- the channel-sharded stream -----------------------------------------

STREAM_C = 4
BUF = 6 * FL


@pytest.fixture(scope="module")
def stream_blocks():
    """tests/test_sharded.py's stream: per channel a frame in buffer 0, one
    straddling the buffer boundary and one in buffer 1; [2, C, BUF]."""
    starts = [500, BUF - FL // 2, BUF + 2 * FL]
    sigs = [build_capture(3, 2 * BUF, starts, seed=100 + c)[0]
            for c in range(STREAM_C)]
    return (np.stack(sigs).reshape(STREAM_C, 2, BUF).transpose(1, 0, 2)
            .astype(np.complex64))


def test_channel_sharded_stream_matches_jax_and_unsharded(stream_blocks):
    """A {channel: 2, time: 1} world of 2 ranks, 2 channels each, over two
    buffers: every buffer's gathered output and the final state equal JAX
    make_sharded_streaming on 2 devices and the port's unsharded
    process_buffer over all 4 channels."""
    js, ts = _specs("c64")
    max_frames = 8
    ranks = launch.run_world(
        2, "c_ofdm_tpu_torch.parallel.launch:stream_rank", backend="gloo",
        device="cpu", args=(CFG, torch.complex64, "matmul", stream_blocks,
                            2, 1, max_frames))
    jm = jmesh.make_modem_mesh(2, 1, devices=jax.devices()[:2])
    jstep = jsharded.make_sharded_streaming(js, jm, max_frames)
    jstate = jst.init_state(js, channels=STREAM_C)
    tstate = streaming.init_state(ts, channels=STREAM_C)
    for b, blk in enumerate(stream_blocks):
        jstate, jout = jstep(jstate, jnp.asarray(blk))
        tstate, tout = streaming.process_buffer(ts, tstate,
                                                torch.from_numpy(blk),
                                                max_frames)
        for res in ranks:
            assert_same(as_numpy(jout), res["outs"][b], "c64", f"buf {b}")
            assert_same(as_numpy(tout), res["outs"][b], "c64", f"buf {b}")
    for res in ranks:
        st = res["state"]
        for name in ("next_min_pos", "frames_seen", "carry_valid"):
            np.testing.assert_array_equal(st[name],
                                          np.asarray(getattr(jstate, name)))
            np.testing.assert_array_equal(st[name],
                                          getattr(tstate, name).numpy())
        jc = np.asarray(jstate.carry)
        np.testing.assert_array_equal(st["carry"], jc[..., 0] + 1j * jc[..., 1])
        np.testing.assert_array_equal(st["carry"], tstate.carry.numpy())
        assert st["frames_seen"].tolist() == [3] * STREAM_C
        assert res["launches"] == NO_LAUNCHES
