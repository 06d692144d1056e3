"""dklint over the port — counterpart of ``dist_keras_tpu/analysis/``.

A stdlib-only AST invariant checker: it reads the port's sources and the
README, never imports the analyzed code and never touches the card.  It
checks the fault-point / knob / event / metric / span / SLO registries
against their call sites and the README tables (``registries``),
signal-handler purity and the never-throws observability entry points
(``purity``), seam hygiene — audited broad excepts, typed-error raises,
pure compiled step functions, stale waivers (``hygiene`` and the
``unused-waiver`` sweep) — and the concurrency invariants
(``concurrency`` over the ``threads`` registry): the thread-root
inventory, the lock-order graph, the shared-state audit, bounded
cross-thread waits and no blocking call under a registered lock.

The passes are the JAX analyzer's, with two differences in ``hygiene``:
the typed-error scope matches path components (the JAX one's substring
test puts ``ops/`` under ``ps/``'s contract), and ``jit-impure`` also
reads ``torch.compile``.  ``RULES`` is the JAX dict word for word, so
one README rules table serves both analyzers.

Run it as ``python -m dist_keras_tpu_torch.analysis`` (see ``__main__``);
``tests/test_torch_dklint.py`` holds it to the JAX analyzer and
self-checks the port's tree with the shipped (empty) baseline.
Programmatic entry: :func:`run_analysis` over any package root.
"""

from dist_keras_tpu_torch.analysis.core import (
    RULES,
    Finding,
    apply_baseline,
    load_baseline,
    run_analysis,
    rules_table,
    write_baseline,
)

__all__ = ["RULES", "Finding", "run_analysis", "rules_table",
           "load_baseline", "write_baseline", "apply_baseline"]
