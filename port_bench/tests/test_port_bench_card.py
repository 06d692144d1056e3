"""Tests that need the card (marked ``cuda``; they skip without one).

The control: the plain reference put in the program's place and computed
in fp8 (``reference/precision.py``), at each cell's own size, on three
seeds.  ``correct`` has to come out false on it: at least one of the
cell's numbers past its limit, on every seed.  Then one short run of a
cell through the command, which has to come out correct.
"""

import json
import subprocess
import sys

import pytest

from port_bench import harness
from port_bench.reference import cnn, vit
from port_bench.reference.numbers import gaps
from port_bench.reference.precision import FP8

CELLS = ["vit-b16.train-224", "adag-mnist-cnn.stacked4",
         "vit-b16.train-1024", "vit-b16.dp4", "vit-b16.train-224-b256"]
SEEDS = [3000000001, 3000000002, 3000000003]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_fp8_control_is_not_correct(card, name, seed):
    cell = harness.load_cell(name)
    ref_mod = vit if cell.traffic["kind"] == "vit_train" else cnn
    ref = ref_mod.check_numbers(cell.config, cell.traffic, seed, card)
    ctl = ref_mod.check_numbers(cell.config, cell.traffic, seed, card,
                                prec=FP8)
    g = gaps(ctl, ref)
    assert any(g[k] > limit for k, limit in cell.limits.items()), g


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench", "--workload",
         "vit-b16.train-224", "--seed", "4294967311", "--seconds", "2",
         "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
