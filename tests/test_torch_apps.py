"""The port's other apps and its dispatcher on the CPU: ``loopback`` against
the JAX app on one capture, ``ber-sweep``, ``dashboard``, ``plots``,
``ingest-bench``, ``scaling-bench`` (in gloo worlds of CPU ranks) and
``python -m c_ofdm_tpu_torch``.

The JAX apps run once per module, in one subprocess: ``loopback --dump D1
--f64`` writes a simulated capture (it stands in for the absent golden
capture), then ``loopback --replay D1/data.bin --f64 --dump DJ`` and the
JAX ``dashboard`` on a metrics file.  The port replays the same capture
with ``--device cpu``.  Tolerances: the printed FRAME, t2_begin, pr_begin,
cfo and ACCURACY lines equal; EVM within 0.01% of itself; the complex128
artifacts within 1e-9; ``source.bin`` (the TX frame as int16) within 1 LSB.
"""

import contextlib
import importlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from c_ofdm_tpu_torch import __main__ as cli
from c_ofdm_tpu_torch.apps import (ber_sweep, dashboard, ingest_bench,
                                   loopback, plots)
from c_ofdm_tpu_torch.io import binio
from c_ofdm_tpu_torch.ops import extract

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
METRICS = [
    {"buf": 0, "slot": 0, "pos": 6272, "seq": 0, "cfo": 1.5e-4, "crc_ok": True},
    {"buf": 0, "slot": 1, "pos": 12788, "seq": 1, "cfo": 1e-4, "crc_ok": True},
    {"buf": 1, "slot": 0, "pos": 7000, "seq": 3, "cfo": -2e-5, "crc_ok": False},
]

_JAX_SCRIPT = r"""
import jax
jax.config.update('jax_platforms', 'cpu')
jax.config.update('jax_enable_x64', True)
import contextlib, io, json, sys
from c_ofdm_tpu.apps import dashboard, loopback
d = sys.argv[1]
res = {}
for name, argv in (('dump', ['--dump', d + '/D1', '--f64']),
                   ('replay', ['--replay', d + '/D1/data.bin', '--f64',
                               '--dump', d + '/DJ'])):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = loopback.main(argv)
    res[name] = [rc, buf.getvalue()]
print(json.dumps(res), flush=True)
# the JAX dashboard writes to the sys.stdout of its import time, so its
# line is taken from the process's stdout, after the JSON line
dashboard.main(['--metrics', d + '/m.jsonl'])
"""


def _main_stdout(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("apps")
    (d / "m.jsonl").write_text("\n".join(json.dumps(r) for r in METRICS))
    proc = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d)],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    *_, res, dash = proc.stdout.splitlines()
    res = json.loads(res)
    res["dashboard"] = dash + "\n"
    return d, res


@pytest.fixture(scope="module")
def port_replay(jax_runs):
    d, _ = jax_runs
    return _main_stdout(loopback, ["--replay", str(d / "D1" / "data.bin"),
                                   "--f64", "--dump", str(d / "DT"),
                                   "--device", "cpu"])


def _lines(text):
    return {ln.split()[0].rstrip(":"): ln for ln in text.splitlines()}


@pytest.mark.parametrize("key", ["FRAME", "t2_begin", "ACCURACY", "Bit-level"])
def test_loopback_replay_lines_equal_jax(jax_runs, port_replay, key):
    _, res = jax_runs
    rc, out = port_replay
    assert rc == res["replay"][0] == 0
    assert _lines(out)[key] == _lines(res["replay"][1])[key]


def test_loopback_replay_evm_within_jax(jax_runs, port_replay):
    _, res = jax_runs
    pat = re.compile(r"EVM: ([0-9.]+)% rms \((-?[0-9.]+) dB\)")
    got = pat.search(port_replay[1])
    want = pat.search(res["replay"][1])
    assert abs(float(got.group(1)) - float(want.group(1))) <= 0.01
    assert abs(float(got.group(2)) - float(want.group(2))) <= 0.1
    assert "ACCURACY: 1.0" in port_replay[1]


@pytest.mark.parametrize("name", ["constell.bin", "phases.bin",
                                  "t2_sin_corr.bin", "data.bin"])
def test_loopback_replay_artifacts_match_jax(jax_runs, port_replay, name):
    d, _ = jax_runs
    read = (binio.read_doubles if name == "t2_sin_corr.bin"
            else binio.read_complex64f)
    got, want = read(str(d / "DT" / name)), read(str(d / "DJ" / name))
    assert got.shape == want.shape and got.size > 0
    assert np.abs(got - want).max() <= 1e-9


def test_loopback_replay_source_within_one_lsb(jax_runs, port_replay):
    d, _ = jax_runs
    got = np.fromfile(d / "DT" / "source.bin", dtype=np.int16).astype(int)
    want = np.fromfile(d / "DJ" / "source.bin", dtype=np.int16).astype(int)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


@pytest.mark.parametrize("f64", [False, True])
def test_loopback_simulated_channel(tmp_path, f64):
    """The port's own channel draw (torch.Generator seeded 0) at 28 dB
    decodes exactly in complex64 and complex128, and dumps all five
    artifacts; on CPU tensors K1 is never launched."""
    before = extract.extract_windows.launches
    rc, out = _main_stdout(loopback, ["--snr-db", "28", "--dump",
                                      str(tmp_path), "--device", "cpu"]
                           + (["--f64"] if f64 else []))
    assert rc == 0, out
    assert "ACCURACY: 1.0" in out and "CRC OK" in out
    assert extract.extract_windows.launches == before
    for name in ("source.bin", "data.bin", "t2_sin_corr.bin", "phases.bin",
                 "constell.bin"):
        assert (tmp_path / name).stat().st_size > 0


def test_loopback_without_a_frame_returns_1(tmp_path):
    binio.write_complex64f(str(tmp_path / "zeros.bin"), np.zeros(20000))
    rc, out = _main_stdout(loopback, ["--replay", str(tmp_path / "zeros.bin"),
                                      "--device", "cpu"])
    assert rc == 1 and out == ""


def test_ber_sweep(tmp_path):
    """tests/test_analysis_apps.py:29-40's checks on the port's app."""
    out = tmp_path / "ber.jsonl"
    rc, text = _main_stdout(ber_sweep, ["--mods", "4", "--snrs", "12:29:8",
                                        "--frames", "4", "--out", str(out),
                                        "--device", "cpu"])
    assert rc == 0
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(rows) == 3 and text.count("\n") == 3
    by_snr = {r["snr_db"]: r for r in rows}
    assert by_snr[28.0]["evm_rms"] < by_snr[12.0]["evm_rms"]
    assert by_snr[28.0]["ber"] == 0.0


def test_ber_sweep_soft(tmp_path):
    """tests/test_analysis_apps.py:43-55: soft combining no worse than the
    hard majority vote at the noisy point."""
    out = tmp_path / "soft.jsonl"
    rc, _ = _main_stdout(ber_sweep, ["--mods", "4", "--snrs", "9:20:9",
                                     "--frames", "8", "--soft", "--out",
                                     str(out), "--device", "cpu"])
    assert rc == 0
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert len(rows) == 2
    noisy = min(rows, key=lambda x: x["snr_db"])
    assert noisy["ber_hard"] > 0, "SNR point too clean to compare"
    assert noisy["ber_soft"] <= noisy["ber_hard"]


def test_ber_sweep_png(tmp_path):
    png = tmp_path / "ber.png"
    rc, _ = _main_stdout(ber_sweep, ["--mods", "4", "--snrs", "28:29:8",
                                     "--frames", "2", "--png", str(png),
                                     "--device", "cpu"])
    assert rc == 0 and png.stat().st_size > 0


def test_dashboard_prints_what_jax_prints(jax_runs, tmp_path):
    d, res = jax_runs
    rc, out = _main_stdout(dashboard, ["--metrics", str(d / "m.jsonl")])
    assert rc == 0 and out == res["dashboard"]
    assert out.startswith("frames=3 crc_ok=2")
    png = tmp_path / "d.png"
    assert dashboard.main(["--metrics", str(d / "m.jsonl"), "--png",
                           str(png)]) == 0
    assert png.stat().st_size > 0


def test_plots_writes_a_png(jax_runs, tmp_path):
    d, _ = jax_runs
    out = tmp_path / "ofdm.png"
    assert plots.main(["--dir", str(d / "DJ"), "--out", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_ingest_bench_prints_its_metric_line():
    rc, out = _main_stdout(ingest_bench, ["--buffers", "8"])
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metric"] == "ingest_samples_per_s"
    assert line["unit"] == "samples/s" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / (246656 / 0.0444), 3)


def test_dispatcher(capsys):
    assert cli.main([]) == 0
    assert "usage: python -m c_ofdm_tpu_torch" in capsys.readouterr().out
    assert cli.main(["nosuch"]) == 2
    assert list(cli.APPS) == ["loopback", "tx", "rx", "ingest-bench",
                              "ber-sweep", "plots", "dashboard",
                              "scaling-bench"]
    for name, (target, _) in cli.APPS.items():
        mod = importlib.import_module(f"c_ofdm_tpu_torch.{target}")
        assert callable(mod.main)


def test_scaling_bench_prints_the_jax_apps_line():
    """scaling-bench in gloo worlds of 1 and 2 CPU ranks: its last line has
    the JAX app's keys (c_ofdm_tpu/apps/scaling_bench.py:99-104) and the
    devices the JAX app reports for --devices 2."""
    rc, out = _main_stdout(cli, ["scaling-bench", "--device", "cpu",
                                 "--devices", "2", "--reps", "1"])
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0
    assert list(line) == ["metric", "samples_per_s", "efficiency_vs_linear",
                          "devices"]
    assert line["metric"] == "sharded_rx_scaling"
    assert line["devices"] == [1, 2]
    assert list(line["samples_per_s"]) == ["1", "2"]
    assert all(v > 0 for v in line["samples_per_s"].values())
    assert line["efficiency_vs_linear"]["1"] == 1.0


def test_dispatcher_runs_an_app(jax_runs):
    d, res = jax_runs
    rc, out = _main_stdout(cli, ["dashboard", "--metrics",
                                 str(d / "m.jsonl")])
    assert rc == 0 and out == res["dashboard"]


@pytest.mark.parametrize("app,argv", [
    ("tx", ["--in", "x.bin"]),
    ("rx", ["--in", "x.bin"]),
    ("loopback", []),
    ("ber-sweep", ["--frames", "1"]),
    ("ingest-bench", ["--buffers", "1", "--to-device"]),
    ("scaling-bench", ["--devices", "1"]),
])
def test_cuda_without_a_card_raises(app, argv):
    """Every app that computes defaults to the card and raises, naming the
    flag, where there is none; none carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device|--to-device"):
        cli.main([app] + argv)
