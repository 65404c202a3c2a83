"""The port's MAC codec (``c_ofdm_tpu_torch/mac/mac.py``) and max-log soft
demap (``ops/modulation.py::soft_llrs``) against the JAX package on the CPU.

Integers and bytes are held exactly (the port returns ``seq`` and ``crc16``
as int64, the JAX package as uint32 / uint16: the values are compared).
``soft_llrs``: within 1e-9 in complex128; in complex64 within 1e-5·max|LLR|
and sign-exact wherever JAX's |LLR| exceeds 1e-4·max|LLR|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from c_ofdm_tpu import ModemConfig as JModemConfig
from c_ofdm_tpu.mac import mac as jmac
from c_ofdm_tpu.ops import modulation as jmod

from c_ofdm_tpu_torch import ModemConfig
from c_ofdm_tpu_torch.mac import mac as tmac
from c_ofdm_tpu_torch.ops import modulation as tmod

torch.set_num_threads(1)

MODS = (1, 2, 4, 6, 8)
B = 3


def _macs(mod, crc=True):
    """Both packages' Mac at the stock geometry with ``mod_type`` = mod,
    built as bench.py builds it (frame_bytes of the config, spread =
    mod_type)."""
    cfg = ModemConfig(mod_type=mod)
    assert cfg.frame_bytes == JModemConfig(mod_type=mod).frame_bytes
    args = dict(frame_bytes=cfg.frame_bytes, spread=mod, crc=crc)
    return jmac.Mac(**args), tmac.Mac(**args)


def _assert_frames_equal(fj, ft):
    for name in tmac.MacFrame._fields:
        want = np.asarray(getattr(fj, name))
        got = getattr(ft, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=name)


def _payload_seq(rng, mac, lead=(B,)):
    payload = rng.integers(0, 256, (*lead, mac.payload), dtype=np.uint8)
    seq = rng.integers(0, 2**32, lead, dtype=np.uint64).astype(np.uint32)
    return payload, seq


def _write_both(jm, tm, payload, seq):
    wj = np.array(jm.write(jnp.asarray(payload), jnp.asarray(seq)))
    wt = tm.write(torch.from_numpy(payload),
                  torch.from_numpy(seq.astype(np.int64)))
    assert wt.dtype == torch.uint8
    np.testing.assert_array_equal(wt.numpy(), wj)
    return wj


@pytest.mark.parametrize("crc", [True, False])
@pytest.mark.parametrize("mod", MODS)
def test_write_and_reads_match_jax(mod, crc):
    """``write`` bytes, then ``read_bytes`` (with bit flips, ties included
    at even spread), ``read_soft`` and ``read_llr``: every MacFrame field
    equal to JAX, on frames that decode and frames that do not."""
    jm, tm = _macs(mod, crc)
    assert (tm.logical_bytes, tm.payload) == (256, 248)
    rng = np.random.default_rng(10 + mod)
    payload, seq = _payload_seq(rng, tm)
    wire = _write_both(jm, tm, payload, seq)
    assert wire.shape == (B, 256 * mod)

    bits = np.unpackbits(wire, axis=-1)
    flips = rng.random(bits.shape) < 0.02
    flips[0] = False                                  # one clean row
    hard = np.packbits(bits ^ flips, axis=-1)
    fj = jm.read_bytes(jnp.asarray(hard))
    ft = tm.read_bytes(torch.from_numpy(hard))
    _assert_frames_equal(fj, ft)
    assert bool(ft.valid[0]) and ft.seq[0] == int(seq[0])
    np.testing.assert_array_equal(ft.payload[0].numpy(), payload[0])

    # one soft metric per logical bit, sign from the logical frame
    lbits = np.unpackbits(wire, axis=-1)[..., ::mod]
    diag = ((1.0 - 2.0 * (lbits == 0)) * np.abs(rng.standard_normal(
        lbits.shape)) + 0.3 * rng.standard_normal(lbits.shape))
    diag[0] = np.where(lbits[0] == 1, 1.0, -1.0)
    _assert_frames_equal(jm.read_soft(jnp.asarray(diag)),
                         tm.read_soft(torch.from_numpy(diag)))

    # one LLR per wire bit, [B, nsym, mod]; positive favours bit 0
    llr = ((1.0 - 2.0 * bits) * np.abs(rng.standard_normal(bits.shape))
           + 0.8 * rng.standard_normal(bits.shape)).reshape(B, -1, mod)
    fj = jm.read_llr(jnp.asarray(llr))
    ft = tm.read_llr(torch.from_numpy(llr))
    _assert_frames_equal(fj, ft)


def test_magic_tail_accepted_and_corruption_rejected():
    jm, tm = _macs(4, crc=False)
    rng = np.random.default_rng(1)
    payload, seq = _payload_seq(rng, tm)
    wire = _write_both(jm, tm, payload, seq)
    fr = tm.read_bytes(torch.from_numpy(wire))
    assert fr.valid.all()
    crc_jm, crc_tm = _macs(1, crc=True)
    payload1, seq1 = _payload_seq(rng, crc_tm)
    w1 = _write_both(crc_jm, crc_tm, payload1, seq1).copy()
    w1[1, 100] ^= 0x40
    w1[2, 3] ^= 0x01                                  # in the seq field
    for mac_j, mac_t, w in ((jm, tm, wire), (crc_jm, crc_tm, w1)):
        _assert_frames_equal(mac_j.read_bytes(jnp.asarray(w)),
                             mac_t.read_bytes(torch.from_numpy(w)))
    fr1 = crc_tm.read_bytes(torch.from_numpy(w1))
    assert fr1.valid.tolist() == [True, False, False]
    # the MAGIC tail sits on the wire at logical bytes 6..7
    one = tmac.Mac(frame_bytes=1024, spread=1, crc=False).write(
        torch.from_numpy(rng.integers(0, 256, 1016, dtype=np.uint8)), 9)
    assert one[6:8].tolist() == [0x7E, 0x57]
    assert bool(tmac.Mac(frame_bytes=1024, spread=1).read_bytes(one).valid)


@pytest.mark.parametrize("mod", [2, 6])
def test_leading_batch_axes(mod):
    jm, tm = _macs(mod)
    rng = np.random.default_rng(2)
    payload, seq = _payload_seq(rng, tm, lead=(2, 3))
    wire = _write_both(jm, tm, payload, seq)
    assert wire.shape == (2, 3, tm.frame_bytes)
    fj = jm.read_bytes(jnp.asarray(wire))
    ft = tm.read_bytes(torch.from_numpy(wire))
    _assert_frames_equal(fj, ft)
    assert ft.valid.shape == (2, 3) and bool(ft.valid.all())
    np.testing.assert_array_equal(ft.payload.numpy(), payload)
    # a scalar seq broadcasts over every leading axis, as a Python int or a
    # 0-d tensor
    wj = np.asarray(jm.write(jnp.asarray(payload), jnp.uint32(7)))
    np.testing.assert_array_equal(tm.write(torch.from_numpy(payload), 7), wj)
    np.testing.assert_array_equal(
        tm.write(torch.from_numpy(payload), torch.tensor(7)), wj)
    # seq is taken mod 2**32, as the JAX package's uint32 cast does
    big = tm.read_bytes(tm.write(torch.from_numpy(payload[0, :1]), 2**32 + 5))
    assert big.seq.tolist() == [5]


def _crc_table_walk(data: np.ndarray) -> int:
    crc = 0xFFFF
    for byte in data:
        crc = ((crc << 8) & 0xFFFF) ^ int(
            tmac._CRC_TABLE[((crc >> 8) ^ int(byte)) & 0xFF])
    return crc


def test_crc16_matrix_form_matches_table_walk():
    """The GF(2) matrix form on random lengths 1-300 against the byte-serial
    table walk (the JAX package's scan), and against JAX's crc16 itself."""
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(tmac._CRC_TABLE, jmac._CRC_TABLE)
    lengths = [1, 2, 8, 254, 300] + rng.integers(1, 301, 7).tolist()
    for n in lengths:
        data = rng.integers(0, 256, (4, n), dtype=np.uint8)
        got = tmac.crc16(torch.from_numpy(data))
        assert got.dtype == torch.int64 and got.shape == (4,)
        assert got.tolist() == [_crc_table_walk(row) for row in data], n
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jmac.crc16(jnp.asarray(data))))
    # the check value of CRC-16/CCITT-FALSE
    check = torch.tensor(list(b"123456789"), dtype=torch.uint8)
    assert int(tmac.crc16(check)) == 0x29B1


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def test_crc16_op_count_does_not_grow_with_length():
    """One matrix product whatever the byte count: the operations crc16 runs
    on a [256, n] batch are the same for n = 64 and n = 254 (the stock CRC
    body), counted by a dispatch mode after the per-n matrix is cached."""
    counts = {}
    for n in (64, 254):
        data = torch.randint(0, 256, (256, n), dtype=torch.uint8)
        tmac.crc16(data)                              # builds M_n once
        with _CountOps() as mode:
            tmac.crc16(data)
        counts[n] = mode.ops
    assert counts[64] == counts[254]
    assert len(counts[254]) <= 20, counts[254]


def test_bad_geometries_raise():
    with pytest.raises(ValueError, match="divisible"):
        tmac.Mac(frame_bytes=1023, spread=4)
    with pytest.raises(ValueError, match="too small"):
        tmac.Mac(frame_bytes=32, spread=4)
    for kw in (dict(frame_bytes=1023, spread=4), dict(frame_bytes=32,
                                                      spread=4)):
        with pytest.raises(ValueError):
            jmac.Mac(**kw)


@pytest.mark.parametrize("dtype", ["c64", "c128"])
@pytest.mark.parametrize("mod", MODS)
def test_soft_llrs_match_jax(mod, dtype):
    jdt, tdt = {"c64": (jnp.complex64, torch.complex64),
                "c128": (jnp.complex128, torch.complex128)}[dtype]
    rng = np.random.default_rng(20 + mod)
    sym = rng.integers(0, 1 << mod, (2, 64))
    sigma = 0.2 / (1 << (mod // 2))                   # ~1/7 of the grid step
    pts = (tmod.constellation(mod)[sym]
           + sigma * (rng.standard_normal(sym.shape)
                    + 1j * rng.standard_normal(sym.shape)))
    pts = pts.astype(np.complex64 if dtype == "c64" else np.complex128)
    nvar = 0.05
    lj = np.asarray(jmod.soft_llrs(jnp.asarray(pts, dtype=jdt), mod, nvar))
    lt = tmod.soft_llrs(torch.from_numpy(pts).to(tdt), mod, nvar)
    assert lt.shape == (2, 64, mod) and lt.dtype == tmod.real_dtype(tdt)
    lt = lt.numpy()
    top = np.abs(lj).max()
    if dtype == "c128":
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-9)
    else:
        np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-5 * top)
        sure = np.abs(lj) > 1e-4 * top
        np.testing.assert_array_equal(np.sign(lt[sure]), np.sign(lj[sure]))
    # hard decisions of the LLRs are the symbols' bits, MSB first
    bits = (sym[..., None] >> np.arange(mod - 1, -1, -1)) & 1
    assert ((lt < 0) == bits).mean() > 0.9
