"""``/statusz`` — one build/config/liveness snapshot for every server.

The serving front end (``serving/server.py``) and the standalone
Prometheus exporter (``observability/prometheus.py``) both answer
``GET /statusz`` with exactly this document, so an operator (or the
future router tier) reads ONE shape regardless of which port answered:

- ``build`` — python/platform/pid, plus torch's version, the CUDA
  version it was built for and the card's name when the process has
  loaded torch (checked via ``sys.modules`` — this module must stay
  importable from the report CLI without dragging torch in; the name is
  read only once CUDA is up, so a status page never initialises it).
  This block is the one deliberate difference from the JAX package's
  copy, which reports jax's version;
- ``knobs`` — the effective value of every registered ``DK_*`` knob
  (parsed, defaults applied) plus whether the env actually set it: the
  "what configuration is this process REALLY running" answer that env
  dumps and launch scripts only approximate;
- ``spans`` — the open-span path per live thread
  (``spans.open_spans()``): a wedged process shows WHERE it is wedged;
- ``flight`` — recorder ring stats (capacity / retained / dumps);
- ``slz`` — the SLO plane: armed-or-not, each objective's last burn
  rates per window and firing flags (``slo.status_doc()``);
- ``uptime_s`` since this module first rendered (process-start proxy).
"""

from __future__ import annotations

import json
import os
import sys
import time

from dist_keras_tpu_torch.observability import events, flight, slo, spans
from dist_keras_tpu_torch.utils import knobs

_t0 = time.time()


def _torch_build():
    torch = sys.modules.get("torch")
    if torch is None:
        return {"torch": None, "cuda": None, "device": None}
    cuda = torch.cuda
    return {"torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": (cuda.get_device_name(cuda.current_device())
                       if cuda.is_initialized() else None)}


def status_doc(extra=None):
    """-> the JSON-ready status document (``extra`` merges in a
    server-specific section, e.g. the serving engine's stats)."""
    import platform

    knob_rows = {}
    for name, knob in knobs.KNOBS.items():
        try:
            value = knobs.get(name)
        except ValueError:  # on_error="raise" knobs with malformed env
            value = "<malformed>"
        knob_rows[name] = {"value": value,
                           "set": knobs.raw(name) is not None}
    doc = {
        "build": {
            "python": sys.version.split()[0],
            "platform": platform.platform(),
            "pid": os.getpid(),
            **_torch_build(),
        },
        "rank": events.rank(),
        "obs_dir": events.obs_dir(),
        "uptime_s": round(time.time() - _t0, 1),
        "knobs": knob_rows,
        "spans": spans.open_spans(),
        "flight": flight.recorder().stats(),
        "slz": slo.status_doc(),
    }
    if extra:
        doc.update(extra)
    return doc


def render(extra=None):
    """The shared ``/statusz`` body — both HTTP servers serve these
    exact bytes (plus their own ``extra`` section)."""
    return json.dumps(status_doc(extra=extra), indent=1, default=str,
                      sort_keys=False)
