"""BENCHMARK.json against the benchmark's contract, and every cell's
files found by name."""

import json
import re

import pytest

from port_bench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|"
                   r"_dim$|_rank$|per_tok|filters|units|channels)", re.I)
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 2 + 14 * 24 * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + ALL_METRICS, ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], ALL_METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_entries_have_only_the_contracts_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_end_to_end_metrics_are_the_three():
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "train_samples_per_s", "step_ms.p95", "setup_s"]
    assert {m["name"]: m for m in BENCH["end_to_end"]}["setup_s"][
        "bound"] <= 0.25


def test_cells_in_order_and_chips():
    assert CELLS == ["vit-b16.train-224", "adag-mnist-cnn.stacked4",
                     "vit-b16.train-1024", "vit-b16.dp4",
                     "vit-b16.train-224-b256"]
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert four == ["vit-b16.dp4"]
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cells_files_are_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.traffic["kind"] in ("vit_train", "adag")
    assert harness.kind(c).run
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert {m["name"] for m in c.end_to_end} == {
        "train_samples_per_s", "step_ms.p95", "setup_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        reader = harness.load_reader(m["name"])
        assert reader.COMBINE in ("rank0", "max", "mean")


def test_every_config_is_used_and_its_file_is_its_own():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        data = json.loads((harness.ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and data["source"] == \
            c["source"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metrics_move_a_reported_metric(metric):
    assert metric["moves"] == "train_samples_per_s"
    assert metric["workloads"] and set(metric["workloads"]) <= set(CELLS)
    assert (harness.BENCH / "metrics" / f"{metric['name']}.py").exists()


def test_metrics_of_one_layer_name_it_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_a_rooflines_and_an_mfu_share_are_percent():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "roofline" in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in BENCH["per_layer"])


TRAFFIC_KEYS = {
    "vit_train": {"kind", "image_size", "batch_per_rank", "ranks",
                  "reference_chunk", "why"},
    "adag": {"kind", "workers", "window", "batch", "rows", "why"},
}


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_mixes_hold_the_traffic_and_no_harness_setting(cell):
    c = harness.load_cell(cell)
    assert set(c.traffic) == TRAFFIC_KEYS[c.traffic["kind"]]
