"""The port's streaming CLI (``tx`` -> file -> ``rx``) against the JAX
apps on the CPU, on the same payload and stream files.

The JAX apps run once per module, in one subprocess (their ``jax.config``
changes stay out of this worker): ``tx`` of the payload, then ``rx`` of its
stream under every drain, chunk size, format and native ingest, and ``rx`` of
the port's own ``tx`` file.  The port's apps run in-process with ``--device
cpu``.  Tolerances: ``tx`` within 1 LSB on at most 0.5% of samples (two
float32 IDFTs rounded apart, as in tests/test_torch_chain.py); ``rx`` bytes,
positions, seqs, CRC flags and tallies exact, ``cfo`` within 1e-5.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from c_ofdm_tpu_torch import ModemConfig, make_frame_spec
from c_ofdm_tpu_torch.apps import rxstream, txstream
from c_ofdm_tpu_torch.mac.mac import Mac
from c_ofdm_tpu_torch.models import streaming
from c_ofdm_tpu_torch.models import tx as ttx

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CFG = ModemConfig()
# 21 frames with 30 000-sample gaps: ~3.1 buffers of the stock 41-frame
# ring, so frames ride the carry and --chunk 2 ends on a zero-padded group
PAYLOAD = (b"Streaming parity between the JAX apps and the port. " * 120)[:5000]
GAP = 30000
MODES = {
    "full": [],
    "metadata_chunk1": ["--drain", "metadata", "--chunk", "1"],
    "metadata_chunk2": ["--drain", "metadata", "--chunk", "2"],
    "f64": ["--format", "f64"],
    "native": ["--native-ingest"],
}

_JAX_SCRIPT = r"""
import jax
jax.config.update('jax_platforms', 'cpu')
import json, sys
import numpy as np
from c_ofdm_tpu import ModemConfig
from c_ofdm_tpu.apps import rxstream, txstream
d, modes = sys.argv[1], json.loads(sys.argv[2])
assert txstream.main(['--in', d + '/payload.bin', '--out', d + '/jax_stream.bin',
                      '--gap', sys.argv[3]]) == 0
raw = np.fromfile(d + '/jax_stream.bin', dtype=np.int16)
# the f64 format is data.bin's layout: already scaled down by mult
(raw / float(ModemConfig().mult)).tofile(d + '/jax_stream_f64.bin')
for name, extra in modes.items():
    src = d + ('/jax_stream_f64.bin' if name == 'f64' else '/jax_stream.bin')
    assert rxstream.main(['--in', src, '--out', d + '/jax_' + name + '.bin',
                          '--metrics', d + '/jax_' + name + '.jsonl',
                          '--log', d + '/jax_' + name + '_LOG.txt',
                          '--summary-json', d + '/jax_' + name + '.json']
                         + extra) == 0
assert rxstream.main(['--in', d + '/port_stream.bin', '--out',
                      d + '/jax_on_port.bin', '--metrics',
                      d + '/jax_on_port.jsonl']) == 0
"""


def _port_rx(d, name, src, extra):
    argv = ["--in", str(src), "--out", str(d / f"port_{name}.bin"),
            "--metrics", str(d / f"port_{name}.jsonl"),
            "--log", str(d / f"port_{name}_LOG.txt"),
            "--summary-json", str(d / f"port_{name}.json"),
            "--device", "cpu"] + extra
    assert rxstream.main(argv) == 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' outputs, built once: the port's tx file first (the
    JAX rx reads it too), then the JAX subprocess, then the port's rx of
    the JAX stream in every mode."""
    d = tmp_path_factory.mktemp("apps_stream")
    (d / "payload.bin").write_bytes(PAYLOAD)
    assert txstream.main(["--in", str(d / "payload.bin"), "--out",
                          str(d / "port_stream.bin"), "--gap", str(GAP),
                          "--device", "cpu"]) == 0
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d), json.dumps(MODES),
         str(GAP)], capture_output=True, text=True, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    for name, extra in MODES.items():
        src = d / ("jax_stream_f64.bin" if name == "f64" else "jax_stream.bin")
        _port_rx(d, name, src, extra)
    _port_rx(d, "on_port", d / "port_stream.bin", [])
    return d


def _rows(path):
    return [json.loads(ln) for ln in Path(path).read_text().splitlines()]


def _summary(path):
    return json.loads(Path(path).read_text())


def test_tx_within_one_lsb_of_jax(runs):
    a = np.fromfile(runs / "jax_stream.bin", dtype=np.int16).astype(np.int32)
    b = np.fromfile(runs / "port_stream.bin", dtype=np.int16).astype(np.int32)
    assert a.shape == b.shape
    n_frames = -(-len(PAYLOAD) // Mac(frame_bytes=CFG.frame_bytes,
                                      spread=CFG.mod_type).payload)
    assert a.size == 2 * n_frames * (CFG.frame_len + GAP)
    diff = np.abs(a - b)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.005


@pytest.mark.parametrize("mode", ["full", "f64", "native"])
def test_rx_decoded_bytes_equal_jax(runs, mode):
    got = (runs / f"port_{mode}.bin").read_bytes()
    assert got == (runs / f"jax_{mode}.bin").read_bytes()
    assert PAYLOAD in got


@pytest.mark.parametrize("mode", ["full", "f64", "native"])
def test_rx_metrics_rows_equal_jax(runs, mode):
    got, want = _rows(runs / f"port_{mode}.jsonl"), _rows(
        runs / f"jax_{mode}.jsonl")
    assert len(got) == len(want) >= 21
    for g, w in zip(got, want):
        for k in ("buf", "slot", "pos", "seq", "crc_ok"):
            assert g[k] == w[k], (k, g, w)
        assert abs(g["cfo"] - w["cfo"]) <= 1e-5
    assert all(r["crc_ok"] for r in got)


def test_rx_log_matches_jax(runs):
    got = [dict(t.split(":", 1) for t in ln.split())
           for ln in (runs / "port_full_LOG.txt").read_text().splitlines()]
    want = [dict(t.split(":", 1) for t in ln.split())
            for ln in (runs / "jax_full_LOG.txt").read_text().splitlines()]
    assert len(got) == len(want) == _summary(runs / "port_full.json")["buffers"]
    # buffer i's results are read back in iteration i + 1's row (the last
    # buffer's in the last row), so row 0 carries no MAC/DET/FR_IN_BUF
    assert list(got[0]) == ["ITER", "RX_STEP"]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("ITER", "DET", "FR_IN_BUF"):
            assert g.get(k) == w.get(k)
    assert list(got[-1]) == ["ITER", "RX_STEP", "MAC", "DET", "FR_IN_BUF"]
    assert int(got[-1]["DET"]) == _summary(runs / "port_full.json")["frames"]


@pytest.mark.parametrize("mode", list(MODES))
def test_rx_summary_equals_jax(runs, mode):
    got, want = _summary(runs / f"port_{mode}.json"), _summary(
        runs / f"jax_{mode}.json")
    assert got.keys() == want.keys()
    for k in ("drain", "buffers", "frames", "crc_failures", "max_seq",
              "payload_checksum_u32"):
        assert got.get(k) == want.get(k), k
    assert got["crc_failures"] == 0 and got["frames"] >= 21


def test_metadata_tallies_equal_full_drain(runs):
    """--chunk 1 and --chunk 2 tally what the full drain decodes: the same
    frames, max seq and uint32 checksum over the CRC-clean payloads, and
    an empty --out."""
    rows = _rows(runs / "port_full.jsonl")
    payloads = np.frombuffer((runs / "port_full.bin").read_bytes(),
                             dtype=np.uint8).reshape(len(rows), -1)
    ok = np.array([r["crc_ok"] for r in rows])
    checksum = int(payloads[ok].astype(np.int64).sum()) & 0xFFFFFFFF
    for mode in ("metadata_chunk1", "metadata_chunk2"):
        s = _summary(runs / f"port_{mode}.json")
        assert s["frames"] == len(rows) and s["crc_failures"] == 0
        assert s["max_seq"] == max(r["seq"] for r in rows) == len(rows) - 1
        assert s["payload_checksum_u32"] == checksum
        assert (runs / f"port_{mode}.bin").stat().st_size == 0


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_port_tx_file_decodes(runs, reader):
    name = "port_on_port" if reader == "port" else "jax_on_port"
    got = (runs / f"{name}.bin").read_bytes()
    assert got[:len(PAYLOAD)] == PAYLOAD
    rows = _rows(runs / f"{name}.jsonl")
    assert all(r["crc_ok"] for r in rows)
    assert [r["seq"] for r in rows] == list(range(len(rows)))


def test_checkpoint_split_decodes_every_frame_once(tmp_path):
    """A stream split mid-way between two receivers (save_state, then
    load_state in a fresh one): every frame decodes exactly once, in order,
    with exact payloads, frames straddling the split included."""
    spec = make_frame_spec(CFG, torch.complex64, device="cpu")
    mac = Mac(frame_bytes=CFG.frame_bytes, spread=CFG.mod_type)
    rng = np.random.default_rng(3)
    n_frames = 6
    payloads = rng.integers(0, 256, (n_frames, mac.payload), dtype=np.uint8)
    wire = mac.write(torch.from_numpy(payloads), torch.arange(n_frames))
    raw = ttx.to_int16(spec, ttx.transmit(spec, wire)).numpy()
    buf_len = CFG.rx_buf_size * CFG.frame_len
    stream = np.zeros((2 * buf_len, 2), dtype=np.int16)
    pos = buf_len - 3 * CFG.frame_len      # the last frames straddle the split
    for row in raw:
        stream[pos:pos + CFG.frame_len] = row.reshape(-1, 2)
        pos += CFG.frame_len + 11
    rx1 = streaming.StreamingReceiver(spec, max_frames=10)
    out1 = rx1.feed(torch.from_numpy(stream[:buf_len]))
    ckpt = str(tmp_path / "state")
    streaming.save_state(ckpt, rx1.state)
    rx2 = streaming.StreamingReceiver(spec, max_frames=10)
    rx2.state = streaming.load_state(ckpt, device="cpu")
    out2 = rx2.feed(torch.from_numpy(stream[buf_len:]))
    seqs = []
    for out in (out1, out2):
        fr = mac.read_soft(out.diag)
        for k in torch.nonzero(out.valid).flatten().tolist():
            assert bool(fr.valid[k])
            seqs.append(int(fr.seq[k]))
            assert np.array_equal(fr.payload[k].numpy(), payloads[seqs[-1]])
    assert seqs == list(range(n_frames))
    assert int(out1.num_found) >= 1 and int(out2.num_found) >= 1


def test_rx_dense_sync_mode_decodes_what_gated_does(runs):
    """--sync-mode dense (the detector-independent matched filter over
    every ring lag) decodes the same frames as the gated default."""
    _port_rx(runs, "dense", runs / "jax_stream.bin", ["--sync-mode", "dense"])
    assert (runs / "port_dense.bin").read_bytes() == \
        (runs / "port_full.bin").read_bytes()
    got, want = _rows(runs / "port_dense.jsonl"), _rows(
        runs / "port_full.jsonl")
    assert [(r["pos"], r["seq"]) for r in got] == \
        [(r["pos"], r["seq"]) for r in want]


def test_rx_profile_writes_a_chrome_trace(runs, tmp_path):
    """--profile DIR writes torch.profiler's chrome trace of the run."""
    _port_rx(runs, "profiled", runs / "jax_stream.bin",
             ["--drain", "metadata", "--profile", str(tmp_path / "prof")])
    trace = json.loads((tmp_path / "prof" / "rxstream_trace.json")
                       .read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("mm" in n for n in names)
    assert _summary(runs / "port_profiled.json")["frames"] == \
        _summary(runs / "port_full.json")["frames"]
