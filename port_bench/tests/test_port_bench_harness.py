"""Runs of the harness on the CPU at small sizes (the look for a card
skipped): the result line, the import check, and ``correct`` coming out
false with the timed path broken underneath."""

import json
import os
import shutil
import subprocess
import sys
import time
import types

import pytest

from port_bench import harness
from port_bench import run as bench_run
from port_bench.tests.tiny import TINY, shorten

KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]
SEED = 2**33 + 17


@pytest.fixture(autouse=True)
def _short_windows(monkeypatch):
    shorten(monkeypatch)


def _cell(name, **traffic):
    c = harness.load_cell(name)
    tiny = TINY[c.traffic["kind"]]
    return harness.load_cell(name, {"config": tiny["config"], "traffic": {
        **tiny["traffic"], **traffic}})


def _measure(name, trace=False, module="port_bench", **traffic):
    cell = _cell(name, **traffic)
    run = harness.Run(cell, SEED, 0.3, trace, "cpu", time.time())
    line, notes, found = bench_run.measure(run, module)
    assert found == []
    assert notes[-len(line["compared"]):] == [
        f"compared {k} {c['value']!r} limit {c['limit']!r}"
        for k, c in line["compared"].items()]
    return line


@pytest.mark.parametrize("name", ["vit-b16.train-224",
                                  "adag-mnist-cnn.stacked4"])
def test_the_last_line_has_the_contracts_keys(name):
    line = _measure(name)
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"train_samples_per_s", "step_ms.p95",
                                    "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert json.loads(json.dumps(line)) == line


@pytest.mark.parametrize("name", ["vit-b16.train-224",
                                  "adag-mnist-cnn.stacked4"])
def test_a_traced_run_reports_per_layer_metrics(name):
    line = _measure(name, trace=True)
    assert list(line) == KEYS[:5] + ["breakdown", "compared"]
    cell = _cell(name)
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "step.mfu" in line["metrics"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("trace", [False, True])
def test_two_ranks_meet_and_agree(trace):
    line = _measure("vit-b16.dp4", trace=trace, ranks=2)
    assert line["correct"] is True and line["device"]["count"] == 2
    if trace:
        got = line["metrics"]
        assert got["allreduce.mb_per_step"]["value"] > 0
        assert got["allreduce.exposed_ms_per_step"]["value"] > 0
        # no device operation on the CPU: the device readers stay silent
        assert "tp_step.launches_per_step" not in got


# -- correct comes out false with the timed path broken ----------------------

def _broken(name, **traffic):
    line = _measure(name, **traffic)
    assert line["correct"] is False
    return {k: c["value"] / c["limit"] for k, c in line["compared"].items()}


def test_a_vit_step_that_returns_its_state_unchanged(monkeypatch):
    from dist_keras_tpu_torch.parallel import transformer_tp

    monkeypatch.setattr(transformer_tp, "apply_updates",
                        lambda params, updates: params)
    assert _broken("vit-b16.train-224")["change_gap"] > 1


def test_a_vit_step_on_half_its_batch(monkeypatch):
    from dist_keras_tpu_torch.parallel import transformer_tp

    whole = transformer_tp.loss_and_grads

    def half(params, x, y, cfg, **kw):
        n = x.shape[0] // 2
        return whole(params, x[:n], y[:n], cfg, **kw)

    monkeypatch.setattr(transformer_tp, "loss_and_grads", half)
    assert _broken("vit-b16.train-224")["grad_gap"] > 1


def test_the_exchange_between_ranks_left_out():
    cell = _cell("vit-b16.dp4", ranks=2)
    run = harness.Run(cell, SEED, 0.3, False, "cpu", time.time())
    line, _, _ = bench_run.measure(run, "port_bench.tests.faulty_rank")
    assert line["correct"] is False
    assert line["compared"]["grad_gap"]["value"] > \
        line["compared"]["grad_gap"]["limit"]


def test_an_adag_step_that_returns_its_state_unchanged(monkeypatch):
    from dist_keras_tpu_torch.trainers import step

    monkeypatch.setattr(step, "apply_updates",
                        lambda params, updates: params)
    assert _broken("adag-mnist-cnn.stacked4")["change_gap"] > 1


def test_an_adag_step_on_half_its_batch(monkeypatch):
    from dist_keras_tpu_torch.trainers import step

    whole = step.make_loss_fn

    def make(*args, **kw):
        loss_of = whole(*args, **kw)

        def half(params, x, y, generator=None):
            n = x.shape[0] // 2
            return loss_of(params, x[:n], y[:n], generator)

        return half

    monkeypatch.setattr(step, "make_loss_fn", make)
    assert _broken("adag-mnist-cnn.stacked4")["grad_gap"] > 1


# -- what a run loads, and when it refuses to run -----------------------------

def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["dist_keras_tpu_torch.ops", "dist_keras_tpu_torchx", "jaxtyping",
         "numpy"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "dist_keras_tpu.models", "flax", "jaxlib.xla"]) == [
        "dist_keras_tpu", "flax", "jax", "jaxlib"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import json, sys, time\n"
        "from port_bench import harness, run\n"
        "from port_bench.tests.tiny import TINY\n"
        "for name in ('vit-b16.train-224', 'adag-mnist-cnn.stacked4'):\n"
        "    kind = harness.load_cell(name).traffic['kind']\n"
        "    cell = harness.load_cell(name, TINY[kind])\n"
        "    r = harness.Run(cell, 5, 0.2, True, 'cpu', time.time())\n"
        "    line, notes, found = run.measure(r)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "dist_keras_tpu_torch" in names and "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "dist_keras_tpu"}


def test_the_harness_reports_jax_when_it_is_loaded(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    cell = _cell("adag-mnist-cnn.stacked4")
    run = harness.Run(cell, SEED, 0.2, False, "cpu", time.time())
    _, _, found = bench_run.measure(run)
    assert found == ["jax"]


def _cli(cwd, name="vit-b16.train-224"):
    return subprocess.run(
        [sys.executable, "-m", "port_bench", "--workload", name, "--seed",
         str(SEED), "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for name in ("vit-b16.train-224", "vit-b16.dp4"):
        out = _cli(harness.ROOT, name)
        assert out.returncode != 0 and out.stdout == ""
        assert "needs" in out.stderr


def test_without_the_program_the_command_prints_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_the_command_needs_its_arguments():
    out = subprocess.run([sys.executable, "-m", "port_bench", "--seed", "1"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == ""
