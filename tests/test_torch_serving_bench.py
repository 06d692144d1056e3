"""The port's offered-load serving benchmark
(``dist_keras_tpu_torch/serving/bench.py``) on ``device="cpu"``: each
bench function runs about a second and returns a record with exactly the
JAX package's keys, every offered request accounted for; the CLI prints
that record as its last line."""

import json

import pytest

from dist_keras_tpu.serving import bench as jax_bench
from dist_keras_tpu_torch.serving import bench

FUNCS = ["run_serving_benchmark", "run_decode_benchmark",
         "run_survivability_benchmark"]


@pytest.fixture(scope="module")
def jax_keys():
    """The JAX records' keys (short runs: only the keys are compared)."""
    return {name: set(getattr(jax_bench, name)(duration_s=0.3))
            for name in FUNCS}


@pytest.mark.parametrize("name", FUNCS)
def test_record_has_the_jax_keys(name, jax_keys):
    rec = getattr(bench, name)(duration_s=1.0, device="cpu")
    assert set(rec) == jax_keys[name]
    assert rec["errors"] == 0
    if name == "run_serving_benchmark":
        assert rec["completed"] == rec["submitted"] > 0
        assert rec["retrace_count"] <= rec["retrace_bound"]
    elif name == "run_decode_benchmark":
        assert rec["mode"] == "decode"
        assert rec["completed"] == rec["submitted"] > 0
        assert rec["tokens"] == 12 * rec["completed"]
        assert 0 < rec["kv_occupancy_peak"] <= 1
    else:
        assert rec["mode"] == "decode_survivability"
        assert rec["quarantines"] == 1 and rec["replicas_dead"] == 1
        assert rec["kv_leaked_pages"] == 0
        assert rec["completed"] == rec["submitted"]


def test_cli_prints_the_record_last(capsys):
    assert bench.main(["--decode", "--seconds", "0.5", "--rps", "20",
                       "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(last)
    assert rec["mode"] == "decode" and rec["offered_rps"] == 20.0
