"""Every file BENCHMARK.json names loads by its name; a new mix is found
without a code edit; the benchmark's names and units keep the contract's
character sets."""

import json
import re

import pytest

from portbench import harness
from portbench.reference.config import ModemConfig

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_loads(config):
    bench = harness.Bench.load()
    conf = bench.config(config)
    cfg = ModemConfig(**conf["modem"])
    assert cfg.frame_len > 0 and conf["fft_backend"] and conf["source"]
    from c_ofdm_tpu_torch import ModemConfig as ProgramConfig
    assert ProgramConfig(**conf["modem"]).frame_len == cfg.frame_len


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_load(cell):
    bench = harness.Bench.load()
    work = bench.workload(cell)
    mix = bench.mix(work["traffic"])
    assert mix["entry"] in ("stream", "batch")
    assert harness.entry_class(mix["entry"]) is not None
    assert bench.limits(cell)["soft_gap"] > 0
    for trace in (False, True):
        assert bench.metrics(cell, trace)


@pytest.mark.parametrize(
    "metric", [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
def test_metric_reader_loads(metric):
    read = harness.Bench.load().reader(metric)
    assert callable(read)


def test_names_and_units():
    names = [c["name"] for c in SPEC["configs"]] + [
        w["name"] for w in SPEC["workloads"]] + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"])
               for m in SPEC["end_to_end"] + SPEC["per_layer"])
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    reports = {m["name"]: set(m.get("workloads", cells))
               for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= reports[m["moves"]]
    for cell in cells:
        mine = [n for n, w in reports.items() if cell in w]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m.get("workloads", cells) for m in SPEC["per_layer"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_throwaway_mix_found_without_edit(tmp_path):
    """A mix and limits written to a new folder serve a new cell by name."""
    (tmp_path / "mixes").mkdir()
    (tmp_path / "limits").mkdir()
    mix = harness.load_json(harness.PORTBENCH / "mixes"
                            / "batch_b256_x1024.json")
    mix["frames"] = 3
    (tmp_path / "mixes" / "throwaway.json").write_text(json.dumps(mix))
    (tmp_path / "limits" / "throwaway_cell.json").write_text(
        json.dumps({"soft_gap": 1.0}))
    spec = dict(SPEC, workloads=SPEC["workloads"] + [
        {"name": "throwaway_cell", "config": "pluto_c_ofdm",
         "traffic": "throwaway", "chips": 1, "why": "test"}])
    bench = harness.Bench(spec, search=(tmp_path, harness.PORTBENCH))
    assert bench.mix("throwaway")["frames"] == 3
    assert bench.limits("throwaway_cell")["soft_gap"] == 1.0
    assert [m["name"] for m in bench.metrics("throwaway_cell", False)] == [
        m["name"] for m in SPEC["end_to_end"] if "workloads" not in m]
    with pytest.raises(FileNotFoundError):
        bench.mix("no_such_mix")


def test_readers_without_a_trace_return_nothing():
    bench = harness.Bench.load()
    rec = {"trace": None, "call_device_s": [], "stage_s": [], "calls": 0,
           "due": 0, "cfg": ModemConfig(),
           "mix": harness.load_json(harness.PORTBENCH / "mixes"
                                    / "batch_b256_x1024.json")}
    for m in SPEC["per_layer"]:
        assert bench.reader(m["name"])(rec) is None
