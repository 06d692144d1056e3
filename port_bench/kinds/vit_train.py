"""ViT training through the port's TP step (``parallel/transformer_tp.py``
``make_tp_train_step``): non-causal, bf16 compute over f32 master params,
adam; across ranks ``make_tp_mesh(dp=ranks)``, one rank a card.

Set-up makes the weights and a pool of global batches from the seed on
the card, builds the step once, and drives that one step object through
the check's first steps (batches 0, 1, 2: every row differs), which also
builds the kernels and warms every shape.  A few timed steps size the
window to about ``--seconds``; the window then runs that many steps,
marking each step's end on its stream.  Across ranks the all-reduce's
counters are read over that window, not under the profiler.  The
check's numbers are read from the program's own state: the losses,
adam's first moment after one step, and the params after the check's
steps against the seed's.
"""

from __future__ import annotations

import gc
import time
import types

from port_bench import harness
from port_bench.reference import inputs
from port_bench.reference import vit as reference
from port_bench.reference.flops import vit_train_flops
from port_bench.reference.numbers import (
    CHECK_STEPS,
    change_norms,
    flat,
    norms,
)
from port_bench.trace import traced

B1 = 0.9   # adam's first-moment decay (the port's adam default)
KERNELS = ("flash_fwd", "flash_bwd")   # the libraries the step loads
POOL_BATCHES = 4      # global batches made at set-up, cycled by the window
CALIBRATE_STEPS = 5   # timed steps that size the window
MIN_STEPS = 10        # the window's least steps
TRACE_SECONDS = 1.0   # about how long the profiled window runs


def _agree(values, world, device):
    """Rank 0's ``values`` (ints) on every rank."""
    if world == 1:
        return values
    import torch
    import torch.distributed as dist

    t = torch.tensor(values, dtype=torch.int64, device=device)
    dist.broadcast(t, src=0)
    return [int(v) for v in t.tolist()]


def prepare(run):
    """Set-up up to and including the check's steps -> its state: the
    step object, the params and adam state it reached, the batch pool,
    the check's numbers (``program``)."""
    import torch

    from dist_keras_tpu_torch.models.transformer import transformer_config
    from dist_keras_tpu_torch.ops.optimizers import adam
    from dist_keras_tpu_torch.parallel.transformer_tp import (
        local_block,
        make_tp_train_step,
    )

    cfg, tr = run.cell.config, run.cell.traffic
    s = types.SimpleNamespace()
    s.dims = dims = inputs.vit_dims({**cfg, **tr})
    dev, mesh = torch.device(run.device), None
    if run.world > 1:
        from dist_keras_tpu_torch.comm import backend as comm
        from dist_keras_tpu_torch.parallel.mesh import make_tp_mesh

        comm.initialize(device=run.device if dev.type == "cpu" else None)
        dev = comm.rank_device()
        mesh = make_tp_mesh(dp=run.world, tp=1, sp=1)
    s.dev, s.cuda = dev, dev.type == "cuda"
    port_cfg = transformer_config(
        input_dim=dims["input_dim"], seq_len=dims["seq_len"],
        d_model=dims["d"], n_heads=dims["heads"], n_layers=dims["layers"],
        d_ff=dims["ff"], n_classes=dims["classes"])
    tx = adam(cfg["learning_rate"])
    factory, _ = make_tp_train_step(
        port_cfg, optimizer=tx,
        compute_dtype=getattr(torch, cfg["compute_dtype"]),
        device=dev, mesh=mesh)
    s.batch = batch = tr["batch_per_rank"]
    s.pool = []
    for i in range(POOL_BATCHES):
        x, y = inputs.vit_batch(dims, batch * run.world, run.seed, i, dev)
        s.pool.append((local_block(x, mesh).clone(),
                       local_block(y, mesh).clone()))
        del x, y

    # the check: the window's step object through its first steps
    params0 = inputs.vit_params(dims, run.seed, dev)
    opt = tx.init(params0)
    s.step = factory(params0, opt)
    p, losses = params0, []
    for i in range(CHECK_STEPS):
        p, opt, loss = s.step(p, opt, *s.pool[i])
        losses.append(loss)
        if i == 0:
            first_mu = opt["mu"]
    s.program = {"loss": {str(i): float(v) for i, v in enumerate(losses)},
                 "grad": norms(flat(first_mu), 1.0 / (1.0 - B1)),
                 "change": change_norms(params0, p)}
    s.p, s.opt = p, opt
    return s


def run(run):
    import torch

    tr = run.cell.traffic
    s = prepare(run)
    if run.world > 1:
        import torch.distributed as dist

        from dist_keras_tpu_torch.comm import backend as comm
        from dist_keras_tpu_torch.parallel import collectives
    dims, dev, cuda, batch = s.dims, s.dev, s.cuda, s.batch
    p, opt, step, pool = s.p, s.opt, s.step, s.pool
    program = s.program
    del s

    # size the window from a few timed steps
    n_pool = len(pool)
    for j in range(2):
        p, opt, loss = step(p, opt, *pool[j % n_pool])
    harness.synchronize(dev)
    t0 = time.perf_counter()
    for j in range(CALIBRATE_STEPS):
        p, opt, loss = step(p, opt, *pool[j % n_pool])
    harness.synchronize(dev)
    t_step = (time.perf_counter() - t0) / CALIBRATE_STEPS
    n, m = _agree([max(MIN_STEPS, round(run.seconds / t_step)),
                   max(3, round(TRACE_SECONDS / t_step))],
                  run.world, dev)
    if run.world > 1:
        dist.barrier()
        collectives.reduce_stats(reset=True, op="all_reduce")
    harness.synchronize(dev)

    # the window
    setup_s = time.time() - run.t_start
    clock = harness.StepClock(dev)
    window_losses = []
    clock.mark()
    t0 = time.perf_counter()
    for j in range(n):
        p, opt, loss = step(p, opt, *pool[j % n_pool])
        clock.mark()
        window_losses.append(loss)
    harness.synchronize(dev)
    window_s = time.perf_counter() - t0
    step_ms = clock.intervals_ms()
    allreduce = (collectives.reduce_stats(op="all_reduce")
                 if run.world > 1 else None)
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    record = {"rank": run.rank, "steps": n, "samples": n * batch,
              "window_s": window_s, "step_ms": step_ms, "setup_s": setup_s,
              "failed": failed, "program": program, "reference": None,
              "platform": "gpu" if cuda else "cpu",
              "device_kind": (torch.cuda.get_device_name(dev) if cuda
                              else "cpu")}

    if run.trace:
        def steps():
            nonlocal p, opt
            for j in range(m):
                p, opt, _ = step(p, opt, *pool[j % n_pool])

        def facts():
            return {"samples_per_s": n * batch / window_s,
                    "train_flops_per_sample": vit_train_flops(dims),
                    "attention_shape": (batch, dims["seq_len"],
                                        dims["heads"],
                                        dims["d"] // dims["heads"]),
                    "window_steps": n, "allreduce": allreduce}

        view = traced(steps, m, facts, cuda)
        record.update(per_layer=harness.per_layer_values(run.cell, view),
                      busy_s=view.busy_s, trace_window_s=view.window_s,
                      trace_steps=m, trace_read_s=view.facts["trace_read_s"],
                      breakdown=view.breakdown())
    record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                   if cuda else 0)

    # free the program's state, then the reference on rank 0
    del p, opt, step, pool, window_losses, loss
    if run.world > 1:
        dist.barrier()
        comm.shutdown()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if run.rank == 0:
        record["reference"] = reference.check_numbers(
            run.cell.config, tr, run.seed, dev)
    return record
