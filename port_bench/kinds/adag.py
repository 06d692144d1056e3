"""The paper's ADAG on its MNIST CNN: ``trainers.ADAG(...).train`` with
the workers stacked on one card (``trainers/step.py``
``make_worker_step``), bf16 compute, Keras adam.

Set-up makes the weights and the epoch's rows from the seed on the card
(the program takes them as a model and a ``Dataset`` on the host), and
builds one trainer, whose dropout generator is seeded from the run's
seed (:func:`port_bench.reference.inputs.dropout_seed`), so that the
reference can draw the same masks.  That trainer's first ``train``
call runs one epoch, one communication window and its merge: the check
reads its losses, the stacked adam state after the first global step
and the center it returns.  Two timed calls (one epoch, then a few)
size the window: one ``train`` call of as many epochs as fill about
``--seconds``.  A global step is one stacked step of every worker; its
end is marked on the step's stream, so the merge after each window's
last step falls in the next step's interval.
"""

from __future__ import annotations

import gc
import time
import types

from port_bench import harness
from port_bench.reference import cnn as reference
from port_bench.reference import inputs
from port_bench.reference.flops import cnn_train_flops
from port_bench.reference.numbers import CHECK_STEPS, norms
from port_bench.trace import traced

B1 = 0.9   # Keras adam's first-moment decay
CALIBRATE_EPOCHS = 3   # the longer of the two calls that size the window
MIN_EPOCHS = 2         # the window's least epochs
TRACE_EPOCHS = 4       # the profiled call's epochs


class Probe:
    """What the harness reads at each global step: a mark on the step's
    stream while ``clock`` is set, and the carry after the first step
    while ``first`` is being kept."""

    def __init__(self):
        self.clock, self.keep, self.first = None, False, None

    def after(self, carry):
        if self.clock is not None:
            self.clock.mark()
        if self.keep and self.first is None:
            self.first = carry


def instrumented(trainer_cls, probe):
    """``trainer_cls`` with each worker step followed by ``probe``."""

    class Instrumented(trainer_cls):
        def _make_worker_step(self, model, loss_fn, tx):
            step, opt_init = super()._make_worker_step(model, loss_fn, tx)

            def probed(carry, batch):
                carry, loss = step(carry, batch)
                probe.after(carry)
                return carry, loss

            return probed, opt_init

    return Instrumented


def _weighted(tree):
    """[(key, tensor)] of a Sequential's per-layer param list, keys
    ``<j>.kernel`` / ``<j>.bias`` counting the layers with weights."""
    out = []
    for layer in [p for p in tree if p]:
        j = len(out) // 2
        out += [(f"{j}.{k}", layer[k]) for k in ("kernel", "bias")]
    return out


def prepare(run):
    """Set-up up to and including the check's call -> its state: the
    trainer, its data and probe, the check's numbers (``program``)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from dist_keras_tpu_torch.data import Dataset
    from dist_keras_tpu_torch.models import mnist_cnn
    from dist_keras_tpu_torch.models.layers import Dropout
    from dist_keras_tpu_torch.trainers import ADAG

    cfg, tr = run.cell.config, run.cell.traffic
    s = types.SimpleNamespace()
    s.dev = dev = torch.device(run.device)
    s.cuda = dev.type == "cuda"
    model = mnist_cnn(num_classes=cfg["num_classes"],
                      input_shape=tuple(cfg["input_shape"]))
    for layer in model.layers:
        if isinstance(layer, Dropout):
            layer.rate = cfg["dropout"]
    weights0 = inputs.cnn_weights(cfg, run.seed, dev)
    model.set_weights([w.cpu().numpy() for w in weights0])
    x, y = inputs.cnn_rows(cfg, tr["rows"], run.seed, dev)
    s.ds = Dataset({"features": x.cpu().numpy(), "label": y.cpu().numpy(),
                    "label_encoded": F.one_hot(y, cfg["num_classes"])
                    .float().cpu().numpy()})
    del x, y
    s.probe = probe = Probe()
    s.trainer = instrumented(ADAG, probe)(
        model, num_workers=tr["workers"],
        communication_window=tr["window"], worker_optimizer="adam",
        batch_size=tr["batch"], num_epoch=1, label_col="label_encoded",
        seed=inputs.dropout_seed(run.seed),
        compute_dtype=getattr(torch, cfg["compute_dtype"]), device=dev)
    s.steps_per_epoch = tr["rows"] // tr["workers"] // tr["batch"]
    s.samples_per_epoch = s.steps_per_epoch * tr["workers"] * tr["batch"]

    # the check: the first call, one epoch = one window and its merge
    probe.keep = True
    center = s.trainer.train(s.ds)
    probe.keep = False
    hist = np.asarray(s.trainer.get_history())   # (workers, 1, 1, window)
    mu = probe.first[1]["mu"]
    program = {"loss": {f"w{w}/{i}": float(hist[w, 0, 0, i])
                        for w in range(tr["workers"])
                        for i in range(CHECK_STEPS)},
               "grad": {}}
    for key, t in _weighted(mu):
        for w in range(tr["workers"]):
            program["grad"][f"w{w}/{key}"] = norms(
                [(key, t[w])], 1.0 / (1.0 - B1))[key]
    before = dict(zip(reference.leaf_names(cfg), weights0))
    program["change"] = norms([
        (k, t.detach().to(dev) - before[k])
        for k, t in _weighted(center.params)])
    probe.first = None
    s.program = program
    return s


def run(run):
    import numpy as np
    import torch

    cfg, tr = run.cell.config, run.cell.traffic
    s = prepare(run)
    dev, cuda, trainer, ds, probe = s.dev, s.cuda, s.trainer, s.ds, s.probe
    program, steps_per_epoch = s.program, s.steps_per_epoch
    samples_per_epoch = s.samples_per_epoch
    del s

    # size the window from two timed calls: a call costs its set-up (the
    # rows laid out and copied to the card) once and then each epoch
    walls = []
    for epochs in (1, CALIBRATE_EPOCHS):
        trainer.num_epoch = epochs
        harness.synchronize(dev)
        t0 = time.perf_counter()
        trainer.train(ds)
        harness.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    t_epoch = (walls[1] - walls[0]) / (CALIBRATE_EPOCHS - 1)
    per_call = max(0.0, walls[0] - t_epoch)
    epochs = max(MIN_EPOCHS,
                 round((run.seconds - per_call) / t_epoch))

    # the window: one train() call
    setup_s = time.time() - run.t_start
    trainer.num_epoch = epochs
    probe.clock = harness.StepClock(dev)
    probe.clock.mark()
    t0 = time.perf_counter()
    trainer.train(ds)
    harness.synchronize(dev)
    window_s = time.perf_counter() - t0
    step_ms = probe.clock.intervals_ms()
    probe.clock = None
    hist = np.asarray(trainer.get_history())
    record = {"rank": 0, "steps": len(step_ms),
              "samples": epochs * samples_per_epoch,
              "window_s": window_s, "step_ms": step_ms, "setup_s": setup_s,
              "failed": int((~np.isfinite(hist)).sum()),
              "program": program, "reference": None,
              "platform": "gpu" if cuda else "cpu",
              "device_kind": (torch.cuda.get_device_name(dev) if cuda
                              else "cpu")}

    if run.trace:
        trainer.num_epoch = TRACE_EPOCHS
        steps = TRACE_EPOCHS * steps_per_epoch
        view = traced(lambda: trainer.train(ds), steps, lambda: {
            "samples_per_s": record["samples"] / window_s,
            "train_flops_per_sample": cnn_train_flops(cfg)}, cuda)
        record.update(per_layer=harness.per_layer_values(run.cell, view),
                      busy_s=view.busy_s, trace_window_s=view.window_s,
                      trace_steps=steps,
                      trace_read_s=view.facts["trace_read_s"],
                      breakdown=view.breakdown())
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                   if cuda else 0)

    del trainer, ds
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    record["reference"] = reference.check_numbers(cfg, tr, run.seed, dev)
    return record
