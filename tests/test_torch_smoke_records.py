"""``chip_smoke.py``'s role processes print records (``SERVE_DONE {json}``,
``PS_WORKER_DONE {json}``, ``PS_FINAL``) that the parent parses out of a
log they share with a thread printing launch counters every 0.2 s.  Each
record must reach the log whole, on a line of its own, also when the
standard output is unbuffered (``PYTHONUNBUFFERED``), where ``print``
writes the text and its newline apart."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys, threading
sys.path.insert(0, {root!r})
import chip_smoke

stop = threading.Event()

def beat():
    while not stop.is_set():
        chip_smoke.write_record("SERVE_KERNELS " + json.dumps({{"k": 0}}))

t = threading.Thread(target=beat, daemon=True)
t.start()
rec = {{"kv_used": 0, "leaked": 0, "completed": 12, "cancelled": 1}}
for i in range({n}):
    chip_smoke.write_record("SERVE_DONE " + json.dumps({{**rec, "i": i}}))
stop.set()
t.join()
"""


@pytest.mark.parametrize("unbuffered", ["1", ""])
def test_records_stay_whole_beside_a_printing_thread(tmp_path, unbuffered):
    n = 3000
    log = tmp_path / "role.log"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONUNBUFFERED"}
    if unbuffered:
        env["PYTHONUNBUFFERED"] = unbuffered
    with open(log, "w") as f:
        subprocess.run([sys.executable, "-c",
                        CHILD.format(root=str(ROOT), n=n)],
                       stdout=f, stderr=subprocess.STDOUT, env=env,
                       check=True, timeout=120)
    out = log.read_text()
    done = re.findall(r"^SERVE_DONE (.*)$", out, re.M)
    assert [json.loads(d)["i"] for d in done] == list(range(n))
    for line in out.splitlines():
        assert re.fullmatch(r"(SERVE_DONE|SERVE_KERNELS) \{.*\}", line), line
