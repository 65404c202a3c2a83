"""The port's ``parallel/`` layer in one process, on the CPU, against the JAX
package's ``c_ofdm_tpu/parallel`` on the conftest's 8 virtual CPU devices:
the mesh layout and its errors, ``_local_receive`` (the per-rank body of the
sharded receiver) in both sync modes with a valid and a zeroed halo, the
world-of-one receiver with ``ingest``'s placement, and ``global_positions``.

Captures are MAC frames through the JAX ``transmit`` at numpy-seeded
positions, CFO and AWGN (``tests/test_sharded.py``'s ``_build_capture``).
Tolerances, as ``tests/test_torch_streaming.py`` holds the streaming
receiver: positions, valid and num_found exact; mac_bytes exact on every
slot in complex128 and on the valid slots in complex64 (an invalid slot
demodulates the window at 0, whose hard decisions on noise flip at float32
rounding); diag and cfo within 1e-9 in complex128 and 1e-4 on the valid
slots in complex64.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from c_ofdm_tpu import ModemConfig as JModemConfig
from c_ofdm_tpu.mac.mac import Mac as JMac
from c_ofdm_tpu.models import frame as jframe
from c_ofdm_tpu.models import tx as jtx
from c_ofdm_tpu.parallel import ingest as jingest
from c_ofdm_tpu.parallel import mesh as jmesh
from c_ofdm_tpu.parallel import sharded as jsharded

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.mac.mac import Mac
from c_ofdm_tpu_torch.models import streaming
from c_ofdm_tpu_torch.parallel import ingest, mesh, sharded

torch.set_num_threads(1)

CFG = ModemConfig()
ATOL128 = 1e-9
ATOL64 = 1e-4
DT = {"c64": (jnp.complex64, torch.complex64, np.complex64),
      "c128": (jnp.complex128, torch.complex128, np.complex128)}
BLOCK = 4 * CFG.frame_len
MAX_FRAMES = 6


@functools.cache
def _specs(dtype_name):
    jdt, tdt, _ = DT[dtype_name]
    return (jframe.make_frame_spec(JModemConfig(), dtype=jdt,
                                   fft_backend="matmul"),
            make_frame_spec(CFG, tdt, device="cpu"))


def build_capture(n_frames, total_len, starts, seed=0, cfo=1e-4,
                  snr_db=26.0):
    """One channel's capture (complex128) with MAC frames planted at
    ``starts``, and the planted payloads: tests/test_sharded.py's
    ``_build_capture``, frames from the JAX package."""
    js, _ = _specs("c64")
    cfg = js.cfg
    mac = JMac(frame_bytes=cfg.frame_bytes, spread=cfg.mod_type)
    rng = np.random.default_rng(seed)
    payloads = rng.integers(0, 256, (n_frames, mac.payload), dtype=np.uint8)
    wire = mac.write(jnp.asarray(payloads),
                     jnp.arange(n_frames, dtype=jnp.uint32))
    frames = np.asarray(jtx.transmit(js, wire))
    sig = np.zeros(total_len, dtype=np.complex128)
    for f, s in zip(frames, starts):
        sig[s:s + cfg.frame_len] += f[:max(0, min(cfg.frame_len,
                                                  total_len - s))]
    sig = sig * np.exp(2j * np.pi * cfo * np.arange(total_len)) * 60.0
    noise_pow = (np.abs(frames) ** 2).mean() * 3600 * 10 ** (-snr_db / 10)
    sig += (rng.standard_normal(total_len)
            + 1j * rng.standard_normal(total_len)) * np.sqrt(noise_pow / 2)
    return sig, payloads


def decoded(out, c, mac=None):
    """read_soft of every valid slot of channel c of a global view
    [C, n_time, K, ...] (numpy fields): {seq: (payload, crc valid)}."""
    mac = mac or Mac(frame_bytes=CFG.frame_bytes, spread=CFG.mod_type)
    valid = out["valid"][c]
    fr = mac.read_soft(torch.from_numpy(out["diag"][c][valid]))
    return {int(s): (p, bool(v)) for s, p, v in
            zip(fr.seq.numpy(), fr.payload.numpy(), fr.valid.numpy())}


def assert_same(jout, tout, dtype_name, tag=""):
    """A JAX StreamOut against the port's (both as dicts of numpy arrays)."""
    valid = tout["valid"]
    for name in ("positions", "valid", "num_found"):
        np.testing.assert_array_equal(jout[name], tout[name],
                                      err_msg=f"{tag} {name}")
    jm, tm = jout["mac_bytes"], tout["mac_bytes"]
    if dtype_name == "c64":
        jm, tm = jm[valid], tm[valid]
    np.testing.assert_array_equal(jm, tm, err_msg=f"{tag} mac_bytes")
    for name in ("diag", "cfo"):
        want, got = jout[name], tout[name]
        if dtype_name == "c128":
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL128,
                                       err_msg=f"{tag} {name}")
        else:
            np.testing.assert_allclose(got[valid], want[valid], rtol=0,
                                       atol=ATOL64, err_msg=f"{tag} {name}")


def as_numpy(out):
    return {k: np.asarray(v) for k, v in out._asdict().items()}


# ---- mesh ---------------------------------------------------------------

@pytest.mark.parametrize("n_channel,n_time", [(1, 0), (2, 4), (4, 1), (3, 0)])
def test_mesh_grid_matches_jax(n_channel, n_time):
    """The port's rank grid is the JAX mesh's device grid on 8 devices (rank
    r plays device r), and a shape JAX refuses raises the same ValueError."""
    devices = jax.devices()[:8]
    try:
        jm = jmesh.make_modem_mesh(n_channel, n_time, devices=devices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.mesh_grid(n_channel, n_time, len(devices))
        assert str(got.value) == str(e)
        return
    grid = mesh.mesh_grid(n_channel, n_time, len(devices))
    np.testing.assert_array_equal(
        grid, np.vectorize(lambda d: d.id)(jm.devices))
    assert jm.axis_names == (mesh.CHANNEL_AXIS, mesh.TIME_AXIS)
    for r, (c, t) in enumerate(np.ndindex(*grid.shape)):
        assert grid[c, t] == r and divmod(r, grid.shape[1]) == (c, t)


@pytest.mark.parametrize("n_channel,n_time", [(1, 0), (1, 1), (2, 0), (1, 2)])
def test_world_of_one_mesh(n_channel, n_time):
    """Without a process group the world is one rank: (1, 0) and (1, 1) give
    the 1x1 mesh at (0, 0), the others the JAX mesh's errors on one
    device."""
    try:
        jm = jmesh.make_modem_mesh(n_channel, n_time,
                                   devices=jax.devices()[:1])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh.make_modem_mesh(n_channel, n_time, device="cpu")
        assert str(got.value) == str(e)
        return
    m = mesh.make_modem_mesh(n_channel, n_time, device="cpu")
    assert (m.n_channel, m.n_time, m.c, m.t) == (*jm.devices.shape, 0, 0)
    assert m.group is None and not m.staged and m.size == 1
    assert m.device == torch.device("cpu")


def test_mesh_device_is_required_and_checked():
    with pytest.raises(TypeError):
        mesh.make_modem_mesh(1, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_modem_mesh(1, 1, device="cuda")


def test_world_of_one_halo_is_zeros_and_invalid():
    m = mesh.make_modem_mesh(1, 1, device="cpu")
    heads = torch.ones((3, CFG.frame_len), dtype=torch.complex64)
    halo, ok = sharded.exchange_halo(m, heads)
    assert ok is False
    assert torch.equal(halo, torch.zeros_like(heads))


# ---- _local_receive -----------------------------------------------------

@functools.cache
def _local_capture():
    """Two channels over a block and one frame of halo: frames inside the
    block, one straddling into the halo, one starting on the halo's first
    sample (owned by the right neighbour) and one at the block start."""
    total = BLOCK + CFG.frame_len
    rows = [build_capture(3, total, [0, 9000, BLOCK - CFG.frame_len // 3],
                          seed=21)[0],
            build_capture(3, total, [3000, BLOCK - CFG.frame_len - 5,
                                     BLOCK], seed=22, cfo=-2e-4)[0]]
    return np.stack(rows)


@functools.cache
def _jax_local(dtype_name, sync_mode):
    js, _ = _specs(dtype_name)
    return jax.jit(jax.vmap(
        lambda b, h, v: jsharded._local_receive(js, b, h, v, MAX_FRAMES,
                                                sync_mode),
        in_axes=(0, 0, None)))


@pytest.mark.parametrize("dtype_name", ["c64", "c128"])
@pytest.mark.parametrize("sync_mode", ["gated", "dense"])
@pytest.mark.parametrize("halo_valid", [True, False])
def test_local_receive_matches_jax(dtype_name, sync_mode, halo_valid):
    _, ts = _specs(dtype_name)
    npdt = DT[dtype_name][2]
    cap = _local_capture().astype(npdt)
    block, halo = cap[:, :BLOCK], cap[:, BLOCK:]
    if not halo_valid:
        halo = np.zeros_like(halo)
    jout = as_numpy(_jax_local(dtype_name, sync_mode)(
        jnp.asarray(block), jnp.asarray(halo), jnp.asarray(halo_valid)))
    tout = as_numpy(sharded._local_receive(
        ts, torch.from_numpy(block), torch.from_numpy(halo), halo_valid,
        MAX_FRAMES, sync_mode))
    assert_same(jout, tout, dtype_name)
    # the straddler decodes with a real halo and is dropped without one;
    # the frame starting in the halo is never this block's
    want = [3, 2] if halo_valid else [2, 2]
    assert tout["num_found"].tolist() == want


def test_local_receive_rejects_a_bad_sync_mode():
    _, ts = _specs("c64")
    x = torch.zeros((1, BLOCK), dtype=torch.complex64)
    with pytest.raises(ValueError, match="sync_mode"):
        sharded._local_receive(ts, x, x[:, :CFG.frame_len], True, 2, "nope")


# ---- the world-of-one receiver and ingest --------------------------------

def test_world_of_one_receiver_matches_jax():
    """make_global_capture / capture_sharding place the whole capture in a
    world of one, and the receiver's gathered output equals JAX
    make_sharded_receiver on a 1x1 mesh of one CPU device."""
    js, ts = _specs("c64")
    total = 2 * BLOCK
    starts = [3000, BLOCK - CFG.frame_len // 3, BLOCK + 9000]
    rows = [build_capture(3, total, starts, seed=s)[0] for s in (31, 32)]
    caps = np.stack(rows).astype(np.complex64)
    jm = jmesh.make_modem_mesh(1, 1, devices=jax.devices()[:1])
    jarr = jingest.make_global_capture(jm, caps)
    jout = as_numpy(jsharded.make_sharded_receiver(js, jm, MAX_FRAMES)(jarr))

    m = mesh.make_modem_mesh(1, 1, device="cpu")
    sh = ingest.capture_sharding(m)
    assert sh.axes == ("channel", "time") and sh.parts == (1, 1)
    assert sh.index(caps.shape) == (slice(0, 2), slice(0, total))
    block = ingest.make_global_capture(m, caps)
    assert torch.equal(block, torch.from_numpy(caps))
    recv = sharded.make_sharded_receiver(ts, m, MAX_FRAMES)
    local = recv(block)
    assert local.valid.shape == (2, 1, MAX_FRAMES)
    tout = as_numpy(sharded.gather_outputs(m, local))
    assert_same(jout, tout, "c64")
    assert tout["num_found"].tolist() == [[3], [3]]
    np.testing.assert_array_equal(
        np.asarray(jsharded.global_positions(js, jsharded.streaming.StreamOut(
            **{k: jnp.asarray(v) for k, v in jout.items()}), total)),
        sharded.global_positions(ts, streaming.StreamOut(
            **{k: torch.from_numpy(v) for k, v in tout.items()}),
            total).numpy())


def test_receiver_rejects_a_short_block():
    _, ts = _specs("c64")
    recv = sharded.make_sharded_receiver(
        ts, mesh.make_modem_mesh(device="cpu"), 2)
    with pytest.raises(ValueError, match="block"):
        recv(torch.zeros((1, CFG.frame_len - 1), dtype=torch.complex64))


def test_global_positions_on_a_hand_built_output():
    _, ts = _specs("c64")
    pos = torch.tensor([[[5, 7], [3, -1], [0, 9]]], dtype=torch.int32)
    valid = torch.tensor([[[True, False], [True, False], [False, True]]])
    out = streaming.StreamOut(None, None, pos, valid, None, None)
    got = sharded.global_positions(ts, out, 100)
    assert got.tolist() == [[[5, -1], [103, -1], [-1, 209]]]


def test_ingest_in_a_larger_world():
    """In a world of more than one rank the local block is checked against
    the global shape's shard, which is required (the JAX package's
    ValueError), and placed on the mesh's device."""
    m = mesh.ModemMesh(n_channel=2, n_time=2, c=1, t=0,
                       device=torch.device("cpu"))
    block = torch.zeros((3, 50), dtype=torch.complex64)
    with pytest.raises(ValueError, match="global_shape is required"):
        ingest.make_global_capture(m, block)
    with pytest.raises(ValueError, match="shard"):
        ingest.make_global_capture(m, block, (6, 120))
    with pytest.raises(ValueError, match="equal parts"):
        ingest.make_global_capture(m, block, (6, 101))
    assert ingest.make_global_capture(m, block, (6, 100)) is not None
    assert ingest.capture_sharding(m).index((6, 100)) == (slice(3, 6),
                                                          slice(0, 50))
    assert ingest.channel_sharding(m).index((6, 100)) == (slice(3, 6),)
    with pytest.raises(ValueError, match="global_channels is required"):
        ingest.make_global_channel_array(m, block)
    with pytest.raises(ValueError, match="shard"):
        ingest.make_global_channel_array(m, block, 4)
    state = ingest.make_global_stream_state(
        m, streaming.init_state(_specs("c64")[1], channels=3), 6)
    assert state.carry.shape == (3, CFG.frame_len)
    assert state.frames_seen.shape == (3,)
