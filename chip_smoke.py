#!/usr/bin/env python3
"""Drive the PyTorch port (``dist_keras_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and carried on):

1. the card (``nvidia-smi`` name and power limit), CUDA version, and
   TF32 switched off for matmuls and cuDNN so f32 means f32;
2. build every kernel of the serving and training paths from ``csrc/``,
   print ptxas's register and spill lines (a tensor-core kernel that
   spills fails), and count the tensor-core instructions (``HMMA``/
   ``HGMMA`` in ``cuobjdump -sass``) of each instantiation of the flash
   forward (K1), the flash backward (K2, K3) and the one-pass backward
   (K4), each in bf16 and in f32 (split TF32): none may be zero; the paged-decode kernel (K5) prints its registers
   and may not spill either;
3. the flash-forward kernel against ``flash_attention_reference`` (out
   and lse) at the prefill shapes, non-causal, offsets, dead rows,
   ragged T and D=32/64, each in f32 and in bf16, and the training
   shape in bf16; out is held both in absolute terms and row by row,
   relative to each row's largest entry, lse to 1e-4 in both dtypes;
   then a uniform-score probe (K = 0, causal, offsets, ragged T) whose
   lse must be log(#visible keys) to 1e-5 (-1e30 on dead rows);
3b. the flash-backward kernels (dq; dk/dv) against
   ``flash_bwd_reference`` at the training shape, non-causal, offsets
   with dead rows, ragged T, D=32/64, a nonzero lse cotangent, each in
   f32 and in bf16 (both on the tensor cores); then
   ``torch.autograd.grad`` through the kernels against autograd through
   plain attention;
3c. the one-pass backward (K4) on the same cases: against
   ``fused_bwd_reference``, bit for bit against itself across two
   launches, and bit for bit against K2 + K3 on the same inputs in both
   dtypes (the same ``mma.sync`` chains, K4 being K3's block with K2's
   dQ chain handed between kv tiles);
4. the paged-decode kernel (split-KV) against ``paged_attention_reference``
   and the plain split model at the decode-ladder slot counts, lengths
   0 / partial page / page boundary / full extent, with the plan's
   n_split and with n_split forced to 1, 2 and one chunk per split;
   two launches bit for bit; launches on two streams at once; the
   plan's grid holds at least one block per SM at S=1 and S=8;
5. the full-width transformer served behind ``ServingServer``:
   concurrent ``POST /generate`` requests (one streamed) over all three
   prefill rungs, every reply 200 and token-equal to a greedy oracle
   that runs the full forward with PLAIN attention on the same card;
   each kernel launched at least once; no KV page leaked after drain;
6. timing at the engine's shapes: each kernel, its plain version, the
   library yardstick where one exists (timed here only — the port never
   calls it), and the engine's tokens/s and TTFT p50; K5 at every decode
   rung at full length, over input sets rotated so that each call reads
   device memory, not the L2; one decode step's wall, device time and
   its device time by kernel (K5, cuBLAS, the rest);
7. training at full width (the ``bench_transformer_tp`` config, bf16,
   causal): one step's loss and every gradient through the kernels
   against the same step with plain attention (bf16, then f32); 10
   adam steps through ``make_tp_train_step``, every loss finite and
   each attention kernel launched once per layer per step; tokens/s,
   one step's host wall beside its device time; then ``remat="mlp"``
   against ``remat=False`` at the long-context example's size;
7b. training with ``DK_FUSED_BWD=1`` (events under a temporary
   ``DK_OBS_DIR``): ``graduate`` returns ``exact`` (err 0.0) in bf16 at
   both phase-7 sizes, and one step per size runs K4 once per layer and
   K2/K3 never, bit-equal to the knob-off step; the bf16 step's wall,
   device time and profile at the training size; then one full-width f32
   step, likewise exact, K4 only and bit-equal, with its wall/device/idle
   and profile; no ``fused_bwd_rejected`` is written;
8. timing at the training shape: the four attention kernels in bf16,
   each held again against its plain version on the timed inputs, their
   plain versions' times, and
   scaled_dot_product_attention's forward and backward as the library
   yardsticks; then K4 against K2 + K3's summed time, and bit for bit
   against their results, at this shape and at B=2, T=8192; K1 against
   SDPA's forward at B=2, T=8192 (bf16) and at the training shape in
   f32; then K2, K3 and K4 in f32 at the training shape against their
   plain versions and beside SDPA's f32 backward, K4 bit for bit against
   K2 + K3.

9. the paper's training loop: ``SingleTrainer`` on the MNIST MLP at
   ``tests/test_examples.py``'s full tier on the card, scored through
   ``ModelPredictor`` -> ``LabelIndexTransformer`` ->
   ``AccuracyEvaluator`` (accuracy >= 0.90); the same trainer with sgd
   in f32 on the card and on the CPU from the same weights (loss history
   and params within 1e-4); samples/s at ``bench_single_mnist_mlp``'s
   shape (batch 512, bf16, adam), with one step's wall, device time and
   device operations; one bf16 epoch of ``mnist_cnn`` (finite, falling
   loss).  No hand-written kernel lies on this path: their counters,
   zeroed before it, stay 0.
10. the windowed trainers, W workers stacked on the card: the windowed
   gates of ``tests/test_examples.py`` at its full tier (ADAG and
   DOWNPOUR on the MNIST CNN >= 0.90, AEASGD and EAMSGD on Higgs AUC >=
   0.85, DynSGD on CIFAR-10 against its SingleTrainer control); ADAG on
   the MNIST CNN (dropout 0), sgd in f32, card against CPU from the
   same weights for 3 windows, step by step from the CPU's state
   (losses and the center after each merge within 1e-4), with the
   free-running runs' gap printed beside the CPU's own gap from a
   one-ulp nudge; the stacked
   step against W single steps; ADAG's and DynSGD's dispatches under
   ``set_sync_debug_mode("error")``; samples/s at
   ``bench_adag_mnist_cnn``'s shape (batch 2048, 4 workers, window 12,
   bf16, adam) with one global step's wall, device time, device
   operations and idle share.  The hand-written kernels' counters,
   zeroed before it, stay 0.

12. checkpoints and resume on the card: a full ADAG training state of
   CUDA tensors (the MNIST CNN's center, 4 stacked workers, their
   stacked adam state, the device generator's state, a bf16 leaf)
   through save and restore onto CUDA templates, bit for bit, chunked
   and differential (a re-save of the unchanged state writes no chunk
   byte); ``ckpt.save_stall_s`` against ``ckpt.write_s`` for states of
   64 and 256 MB made on the card with ``DK_CKPT_ASYNC`` on (the stall
   well under the write) and off (the stall the whole write); under
   deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` is set at
   import), SingleTrainer on the MNIST MLP and ADAG on the MNIST CNN
   with dropout: two uninterrupted runs bit-equal (the control), a run
   that sends itself a real SIGTERM under ``handle_preemption=True``
   exits ``Preempted`` (143) with a verified saved step, and a fresh
   trainer resumed from it ends bit-equal to the uninterrupted run, the
   resumed ADAG through its phase-10 gate; ADAG samples/s at
   ``bench_adag_mnist_cnn``'s shape without saves and with
   ``checkpoint_every_windows`` (3 saves per run).  The hand-written
   kernels' counters, zeroed before it, stay 0.

13. parameter-server mode: a ``PSServer`` process and
   ``PSWorkerTrainer`` processes on the card (each started fresh, never
   forked).  13a is ``gates.py``'s PS gate: on the blobs MLP (sgd 0.05,
   window 4) one of two workers is SIGKILLed mid-run and a replacement
   joins, the survivors' models reach the DynSGD floor 0.80, SIGTERM
   drains the server (exit 143) to a final checkpoint that verifies and
   restores to the sha it printed, ``report.summarize`` attributes the
   lapse, the joins and per-worker commits; then 4 chaos seeds over
   ``ps.pull`` / ``ps.commit`` / ``ps.join`` each end completed or typed
   with a verified step.  13b: ``mnist_mlp()`` at full width, one server
   and 4 worker processes sharing the card (window 12, adam 1e-3, batch
   64, 6 epochs of the phase-9 gate set, each shuffling with its own
   seed): the final center's held-out accuracy >= 0.90, uncompressed and
   with ``DK_PS_COMPRESS=int8`` (wire ratio >= 2); samples/s summed over
   the workers from the first join to the last commit, commits/s, the
   staleness histogram, one window's wall split (steps, delta and copy,
   encode, commit, merge) and each worker's device idle share over one
   window cycle; one worker on the card against one on the CPU, 3
   windows, within 1e-4.  The hand-written kernels' counters, zeroed
   before it, stay 0.

14. the serving fabric: 14a, a ``RouterServer`` in this process over two
   backend processes (``--serve-role``: the phase-5 model in a
   ``DecodeEngine`` behind a ``ServingServer``, started fresh, never
   forked) sharing the card and one ``DK_OBS_DIR``; the routed against
   the direct p50 / p99 of ``/generate`` over the prompt set; concurrent
   clients, each request with its own ``traceparent`` (some streamed,
   some with ``deadline_s`` / ``x-dk-priority``), while one backend is
   SIGKILLed: every answer 200 and oracle-equal, a typed 503 with
   ``Retry-After``, or a stream's ``backend_stream_lost`` record, no
   transport error; the dead backend evicted within
   ``DK_ROUTE_STALE_S``, restarted on its port (``decode.step`` slowed)
   and re-admitted; a hedged ``/generate`` whose slow primary loses and
   is cancelled, its KV pages back at zero; ``/statusz``, ``/tracez`` and
   the Prometheus scrape at 200 on every backend and the router; the
   SIGTERM drain leaving no KV page; one stitched trace (client ->
   ``route.forward`` -> ``serve.generate`` -> the replica stage) per
   answered request; K1 and K5 launched on the backends, K2-K4 never.
   14b: a ``BlueGreenEngine`` of two ``ServingEngine``s over
   ``mnist_mlp()`` under continuous submit load, fed by a
   ``CheckpointWatcher``: two cutovers, each serving the plain forward of
   the new params, a corrupt step skipped, no request lost; then the
   ``ReplicaAutoscaler`` over a hand-fed ``serve.pending`` ring, tick
   for tick as the JAX gate.  14c: a backend with ``DK_SLO`` and a tight
   ``DK_SLO_TTFT_S`` sheds ``priority="batch"`` as ``shed_batch`` while
   interactive requests stay oracle-equal; the scrape's exemplars resolve
   to retained traces; its SIGTERM drain leaves a flight dump the report
   CLI's ``--dumps`` reads.  14d: ``serving/bench.py``'s decode,
   survivability and predict records on the card.

15. the data path: 15a, ``examples/mnist.py``'s ``load_mnist`` sets
   (8192 + 2048 synthetic MNIST rows) written with ``to_csv`` and read
   back with ``Dataset.from_csv`` through the port's native reader
   (built from its own source into ``_build/``, no fallback warning; the
   matrix equal to ``np.loadtxt``'s; the parse MB/s), the reference's
   transformer chain, ``ADAG(mnist_cnn(), 4 workers, window 12)``
   streamed one window a chunk, ``ModelPredictor`` ->
   ``LabelIndexTransformer`` -> ``AccuracyEvaluator`` (>= 0.90), the
   streamed run bit-equal to the resident one under deterministic
   algorithms.  15b, ``bench_adag_streamed``'s MLP (1,048,576 uint8 rows
   x 8, hidden 6 x 4096, batch 512, window 8, one worker, sgd, bf16, 2
   epochs): resident and ``stream_chunk_windows=32``, a warm-up and the
   median of 3 each (in turns), the streamed / resident samples/s
   against ``bench.py``'s 0.9 (recorded, not gated),
   ``max_memory_allocated`` of each, at most two chunks on the card,
   every dispatch and feed ``get`` under ``set_sync_debug_mode("error")``;
   a ``max_resident_bytes`` budget under the epoch (streaming on, the
   feed's chunks on the card under the budget); ``bench_adag_mnist_cnn``'s
   shape resident against one window a chunk (peak device bytes,
   samples/s, ``perf.phase.data`` against ``perf.phase.step`` per
   chunk), and one ``torch.profiler`` capture over two of its chunk
   boundaries: the share of the pinned HtoD copies under compute
   kernels.  15c, ``StreamingPredictor`` over a ``SocketSource`` fed by a
   producer thread with 15a's held-out rows: equal to ``ModelPredictor``
   (1e-5 of the largest logit), in arrival order, every batch at the
   fixed shape, one ``stream.fetch`` fault armed through ``DK_FAULTS``
   retried, rows/s.  15d, under a temporary ``DK_OBS_DIR`` with
   ``DK_OBS_SAMPLE_S``: a streamed ADAG run's ``chunk`` events
   (``streamed``), ``perf.phase`` histograms, ``perf.h2d_bytes`` equal to
   the feed's bytes, one ``train.run`` root span, ``report.txt``, the
   sampler's samples, ``comm_overlap`` / ``comm_blocked``; a
   ``step.loss`` NaN through ``DK_FAULTS`` halting a run.  The
   hand-written kernels' counters, zeroed before it, stay 0.

16. the workers across processes: two rank processes (``--mp-role``,
   started fresh, never forked) join a ``torch.distributed`` group
   through a ``file://`` rendezvous and share the card under gloo (the
   backend rule: NCCL only when every rank has a card of its own), each
   printing its backend and device.  16a: ADAG on the MNIST CNN (dropout
   0, 4 workers, window 12, 2 windows) split 2 ranks x 2 workers
   against the 4-worker run in this process on the same rows and
   weights, and against a witness: the same ADAG merged by hand in this
   process, its workers stacked 2 + 2 as the ranks stack them.  Sgd in
   f64 and f32 and adam in f32: every split center within 1e-5 of the
   largest weight of the witness's, the two ranks' centers bit-equal,
   and with f64 compute within 1e-5 of the 4-worker run too; the f32
   runs' distance to the 4-worker run, and the witness's own 2 + 2
   against 4, printed (the stacked step rounds by batch shape, and
   adam's +-lr first steps turn that into lr-sized gaps).  16b:
   ``bench_adag_mnist_cnn``'s shape (batch 2048, window 12,
   adam, bf16), runs of about 6 s: samples/s of 2 ranks x 2 workers and
   of one process x 4 workers in turns, medians of 3 (recorded, not
   gated), the merge's all-reduce per window (collectives, bytes,
   blocked ms), an overlapped run's ``comm_overlap`` / ``comm_blocked``,
   and each rank's device idle share under ``torch.profiler``.  16c:
   phase 10's ADAG gate split over the two ranks (accuracy >= 0.90).
   16d: under ``DK_COORD_DIR``, deterministic algorithms and a temporary
   ``DK_OBS_DIR``: two ``SingleTrainer`` ranks, then ADAG 2 x 2, each run
   uninterrupted, then with a SIGTERM to rank 0 at the end of epoch 2
   (both ranks ``Preempted`` with code 143 at the agreed step, one
   committed step, a ``preempt`` flight dump per rank; the second
   process exit is 143), then resumed: each rank's weights bit-equal to
   its uninterrupted run.  The hand-written kernels' counters, zeroed in
   every process, stay 0.

17. the MoE transformer, expert and sequence parallelism: 17a,
   ``bench_transformer_tp``'s widths with 8 experts a block (capacity
   factor 1.25), B=16, causal, bf16 compute, f32 masters, adam(1e-3):
   one step's loss and grads through the kernels against the same step
   with plain attention, in f32 (each run routing its own tokens) and in
   bf16 with the kernels' routing replayed in the plain run (the free
   bf16 pair printed beside it, with the tokens it routed otherwise);
   ``switch_moe_dense``'s index dispatch bit-equal to the one-hot plain
   version at N=2048 in f32; 10 steps of ``make_moe_train_step``, K1, K2
   and K3 once per layer per step; tokens/s, the step's wall beside its
   device time and the dense step's in the same call, its profile, and
   one MoE layer's device time by kernel.  17b, two rank processes
   (``--mp-role``) sharing the card under gloo:
   ``make_moe_ep_train_step`` with 4 experts a rank, 2 sequences a rank,
   f32, sgd, 3 steps, every rank's params within 1e-5 of the largest
   weight of a witness (the same steps in the rank's process with every
   rank's block through the dense mixture, grads summed), the ranks'
   replicated leaves bit-equal; the exchange's calls, bytes and blocked
   ms a step; samples/s beside one process alone.  17c, the same ranks:
   ``ring_attention`` at B=16, T=2048 (1024 a rank), H=6, D=128, causal,
   bf16 and f32, forward and grads against ``flash_attention_with_lse``
   on the whole sequence; ``make_tp_train_step(mesh=make_tp_mesh(sp=2))``
   at ``TRAIN_MODEL``'s widths, B=16, f32, sgd: loss and grads against
   the one-card step (``STEP_F32_TOL``), the params after 3 steps too,
   the ranks' params bit-equal; tokens/s at sp=2 beside sp=1 and the
   ring's blocked ms a step.  K1-K3 launch on 17a's and 17b/c's main
   paths, and the kernels' ``launches`` include them.
18. The transformer across ranks, two ``--mp-role`` ranks sharing the
   card under gloo, at ``TRAIN_MODEL``'s widths, B=16, f32, each split
   run against one process in the same call (``SPLIT_TOL``): 18a the TP
   step at tp=2 (3 heads and half the FFN a rank; *f* / *g* around
   each half), sgd: loss, grads and the params after 2 steps, the
   replicated leaves bit-equal, and one bf16 step against plain
   attention (``STEP_BF16_TOL``); 18b FSDP over the 2 ranks (8 rows a
   rank, every big leaf and its adam moments sharded), adam: the losses
   and the moments after step 1 against the whole batch, and with them
   the params after 2 steps against one process taking the ranks' step
   (each rank's rows apart, summed in rank order), sgd: the params after
   2 steps, each rank's persistent bytes against one process's;
   18c the pipeline over 2 stages (2 layers a stage), 8 microbatches of
   2, sgd, 1F1B then interleaved at v=2: loss, grads, params, the stash
   peak.  Each prints its rate split against one process, the
   collectives' calls, MB and blocked ms, and K1-K3 launches per rank;
   the kernels' ``launches`` include them.

Each phase's seconds are printed as the next one starts, and all of them
after phase 18.  The full run cuts 15b's repeats and run lengths
(``PROOF15``: one resident and one streamed MLP run of one epoch, a
shorter CNN pair), 16b's turns (``PROOF16``: one run of ~1 s each) and
13b's runs (``PROOF13_EPOCHS``: 3 epochs each) so that it stays well
inside the time limit; every check still runs.

``python3 chip_smoke.py --phase12`` runs only phases 1 and 12;
``--phase13`` only phases 1 and 13; ``--phase14`` only phases 1 and 14;
``--phase15`` only phases 1 and 15 (at its full sizes); ``--phase16``
only phases 1 and 16 (at its full sizes); ``--phase17`` only phases 1
and 17; ``--phase18`` only phases 1 and 18.
``python3 chip_smoke.py --paged-timing-of CHECKOUT`` runs only phase 6's
K5 timing, on the ``dist_keras_tpu_torch`` of another checkout, so that
two trees' K5 can be timed on the same inputs in one run.

The line before the last is a JSON object of per-kernel numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np

# phase 12's resume checks run under deterministic algorithms, and
# cuBLAS's deterministic mode needs its workspace pinned before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ROOT = Path(__file__).resolve().parent
MODEL = dict(input_dim=32, seq_len=2048, d_model=768, n_heads=6,
             n_layers=4, d_ff=3072, n_classes=32)
PREFILL_LADDER = (64, 256, 1024)
DECODE_LADDER = (1, 4, 8)
PAGE_SIZE = 16
MAX_NEW = 32
PROMPT_LENS = (5, 40, 64, 100, 200, 256, 700, 1000)
STREAMED = 3          # index of the request sent with "stream": true
F32_TOL = 1e-4
BF16_TOL = 2e-2       # relative to the largest entry of the plain result
LSE_TOL = 1e-4        # lse is f32 arithmetic on exact products in both dtypes
PROBE_TOL = 1e-5      # the uniform-score probe's lse against log(#visible)
TRAIN_MODEL = dict(input_dim=32, seq_len=2048, d_model=768, n_heads=6,
                   n_layers=4, d_ff=3072, n_classes=2)   # bench_transformer_tp
TRAIN_BATCH = 16
TRAIN_STEPS = 10
LONG_SEQ, LONG_BATCH = 8192, 2      # examples/long_context.py defaults
STEP_BF16_TOL = 3e-2        # per-leaf relative norm error, kernel vs plain
STEP_F32_TOL = 1e-3
REMAT_TOL = 1e-5
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_FLOPS_S = {"float32": 67e12,     # f32 outside the tensor cores
                # f32 products as three TF32 ones (hi*hi + hi*lo + lo*hi)
                # on the tensor cores: 495 / 3, the rate the f32 K1 can reach
                "float32_split_tf32": 495e12 / 3,
                "bfloat16": 989e12}   # bf16 tensor cores, dense


class PhaseClock:
    """Prints each phase's title as it starts and its seconds as the next
    one starts; :meth:`summary` prints them all and the total."""

    def __init__(self):
        self.t0 = self.mark = time.perf_counter()
        self.name, self.rows = None, []

    def _stop(self):
        if self.name is not None:
            dt = time.perf_counter() - self.mark
            self.rows.append((self.name, dt))
            print(f"  phase {self.name} took {dt:.1f} s")
        self.name = None

    def start(self, title):
        self._stop()
        print(f"phase {title}")
        self.name, self.mark = title.split(":")[0], time.perf_counter()

    def summary(self):
        self._stop()
        print("phase seconds: " + ", ".join(
            f"{n} {dt:.1f}" for n, dt in self.rows)
            + f"; phases {self.rows[0][0]}-{self.rows[-1][0]} "
            f"{time.perf_counter() - self.t0:.1f} s")


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    require(out, "nvidia-smi printed no card")
    return out[0].strip()


def time_ms(fn, reps=20, trials=7, sleep_ms=10):
    """Median over ``trials`` of the mean device time of ``reps``
    back-to-back calls, from CUDA events.  A sleep kernel (``sleep_ms``,
    longer than the host needs to enqueue the calls) ahead of the start
    event keeps the card busy meanwhile, so the events see the calls'
    device time, not the Python wrappers' launch cost."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(sleep_ms * 2e6))   # cycles at <= 2 GHz
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def bound_ms(nbytes, flops, dtype="float32"):
    """The least time the card could take for work moving ``nbytes`` and
    doing ``flops`` in ``dtype``: -> (ms, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS_S[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ptxas_usage(log):
    """{function: (registers, spill store bytes, spill load bytes)} from
    the ``-Xptxas=-v`` lines of a build log."""
    usage, fn, spill = {}, None, (0, 0)
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for", 1)[1].strip()
        elif fn and "spill stores" in line:
            spill = tuple(int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
        elif fn and "Used" in line and "registers" in line:
            usage[fn] = (int(re.search(r"Used (\d+) registers",
                                       line).group(1)), *spill)
            fn = None
    return usage


def tensor_core_counts(build, lib, kernel):
    """HMMA/HGMMA instructions in each SASS function of ``lib`` whose
    name contains ``kernel`` -> {function: count}."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(build.library_path(lib))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            fn = name if kernel in name else None
            if fn:
                counts[fn] = 0
        elif fn and ("HMMA" in line or "HGMMA" in line):
            counts[fn] += 1
    return counts


# -- phase 3: flash forward ------------------------------------------------
def check_flash(fa, rng, dev):
    import torch

    edges = [
        # (B, Tq, Tk, H, D, causal, q_offset, kv_offset)
        (2, 256, 256, 6, 128, False, 0, 0),
        (1, 128, 256, 6, 128, True, 192, 0),
        (1, 128, 128, 6, 128, True, 0, 64),      # dead rows
        (1, 1000, 1000, 6, 128, True, 0, 0),     # ragged
        (2, 77, 130, 4, 64, False, 0, 0),        # ragged
        (1, 93, 93, 8, 32, True, 0, 0),
    ]
    cases = [
        # (B, Tq, Tk, H, D, causal, q_offset, kv_offset, dtype)
        (1, 64, 64, 6, 128, True, 0, 0, torch.float32),
        (1, 256, 256, 6, 128, True, 0, 0, torch.float32),
        (1, 1024, 1024, 6, 128, True, 0, 0, torch.float32),
        *[(*e, torch.float32) for e in edges],
        (1, 1024, 1024, 6, 128, True, 0, 0, torch.bfloat16),
        *[(*e, torch.bfloat16) for e in edges],
        (TRAIN_BATCH, TRAIN_MODEL["seq_len"], TRAIN_MODEL["seq_len"],
         TRAIN_MODEL["n_heads"], TRAIN_MODEL["d_model"]
         // TRAIN_MODEL["n_heads"], True, 0, 0, torch.bfloat16),  # training
    ]
    for b, tq, tk, h, d, causal, qo, ko, dtype in cases:
        q = torch.from_numpy(rng.standard_normal((b, tq, h, d),
                                                 np.float32)).to(dev, dtype)
        k = torch.from_numpy(rng.standard_normal((b, tk, h, d),
                                                 np.float32)).to(dev, dtype)
        v = torch.from_numpy(rng.standard_normal((b, tk, h, d),
                                                 np.float32)).to(dev, dtype)
        out, lse = fa.flash_fwd(q, k, v, causal, d ** -0.5, qo, ko)
        ref, ref_lse = fa.flash_attention_reference(
            q, k, v, causal=causal, q_offset=qo, kv_offset=ko)
        torch.cuda.synchronize()
        err = max_abs_err(out, ref)
        rerr = row_rel_err(out, ref)
        lerr = float((lse - ref_lse).abs().max())
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        name = (f"B={b} Tq={tq} Tk={tk} H={h} D={d} causal={causal} "
                f"q_off={qo} kv_off={ko} {str(dtype)[6:]}")
        print(f"  flash_fwd {name}: out max_abs_err={err:.3e} "
              f"row-relative={rerr:.3e} (tol {tol:g}) lse max_abs_err="
              f"{lerr:.3e} (tol {LSE_TOL:g})")
        require(err <= tol and rerr <= tol and lerr <= LSE_TOL,
                f"flash_fwd disagrees with its plain version at {name}")
        if ko > qo:
            dead = ko - qo
            require(float(out[:, :dead].abs().max()) == 0.0,
                    "flash_fwd: dead rows are not exact zeros")
        del out, ref, lse, ref_lse
    check_uniform_probe(fa, rng, dev)


def check_uniform_probe(fa, rng, dev):
    """K = 0 makes every score 0, so each row's lse is exactly
    log(#visible keys) (-1e30 where none is visible) and its output the
    mean of the visible V rows: a mask that is off by one key moves the
    lse by at least 1/Tk."""
    import torch

    cases = [
        # (B, Tq, Tk, H, D, q_offset, kv_offset), all causal
        (1, 1000, 1000, 6, 128, 0, 0),
        (1, 300, 300, 6, 128, 0, 64),    # dead rows, then partial tiles
        (2, 77, 130, 4, 64, 100, 0),
        (1, 93, 93, 8, 32, 5, 0),
        (1, 200, 150, 2, 128, 37, 90),
    ]
    for b, tq, tk, h, d, qo, ko in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.from_numpy(rng.standard_normal((b, tq, h, d),
                                                     np.float32)).to(dev, dtype)
            k = torch.zeros((b, tk, h, d), dtype=dtype, device=dev)
            v = torch.from_numpy(rng.standard_normal((b, tk, h, d),
                                                     np.float32)).to(dev, dtype)
            out, lse = fa.flash_fwd(q, k, v, True, d ** -0.5, qo, ko)
            ref, _ = fa.flash_attention_reference(q, k, v, causal=True,
                                                  q_offset=qo, kv_offset=ko)
            n = (qo + torch.arange(tq, device=dev) - ko + 1).clamp(0, tk)
            want = torch.where(n > 0, torch.log(n.clamp_min(1).double()),
                               -1e30).float()
            torch.cuda.synchronize()
            perr = float((lse - want).abs().max())
            rerr = row_rel_err(out, ref)
            tol = F32_TOL if dtype == torch.float32 else BF16_TOL
            name = (f"B={b} Tq={tq} Tk={tk} H={h} D={d} q_off={qo} "
                    f"kv_off={ko} {str(dtype)[6:]}")
            print(f"  flash_fwd K=0 probe {name}: lse vs log(#visible) "
                  f"max_abs_err={perr:.3e} (tol {PROBE_TOL:g}), out "
                  f"row-relative={rerr:.3e} (tol {tol:g})")
            require(perr <= PROBE_TOL and rerr <= tol,
                    f"flash_fwd fails the uniform-score probe at {name}")
            dead = int((n == 0).sum())
            if dead:
                require(float(out[:, :dead].abs().max()) == 0.0,
                        "flash_fwd: dead rows are not exact zeros")


def max_abs_err(got, want):
    return float((got.float() - want.float()).abs().max())


def rel_err(got, want):
    """max |got - want| over max |want|, in f32."""
    want = want.float()
    return float((got.float() - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def row_rel_err(got, want):
    """The largest, over rows, of a row's max |got - want| over its max
    |want|.  Causal attention's late rows average many values and are
    small (|out| ~ 0.03 at T=2048), so a limit relative to each row's own
    scale catches a wrong late kv tile that an absolute limit, or one
    relative to the largest entry, would pass.  Rows that are exactly 0
    in ``want`` (dead rows) count as 0 when ``got`` is 0 there too."""
    want = want.float()
    err = (got.float() - want).abs().amax(-1)
    return float((err / want.abs().amax(-1).clamp_min(1e-30)).max())


def bwd_inputs(fa, rng, dev, b, tq, tk, h, d, causal, qo, ko, dtype, g_lse):
    """q, k, v, dO and the forward's lse, and dl = g_lse - rowsum(dO*O)
    as the autograd function forms it."""
    import torch

    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape, np.float32)).to(dev, dtype)
    q, k, v, do = mk(b, tq, h, d), mk(b, tk, h, d), mk(b, tk, h, d), \
        mk(b, tq, h, d)
    out, lse = fa.flash_fwd(q, k, v, causal, d ** -0.5, qo, ko)
    dl = -(do.float() * out.float()).sum(-1).transpose(1, 2)
    if g_lse:
        dl = dl + torch.from_numpy(
            rng.standard_normal((b, h, tq), np.float32)).to(dev)
    return q, k, v, do, lse, dl.contiguous()


# -- phase 3b: flash backward ----------------------------------------------
def bwd_cases():
    """The backward kernels' cases (phases 3b and 3c): (B, Tq, Tk, H, D,
    causal, q_offset, kv_offset, dtype, g_lse)."""
    import torch

    shapes = [
        (16, 2048, 2048, 6, 128, True, 0, 0, False),
        (2, 512, 768, 6, 128, False, 0, 0, False),
        (1, 256, 256, 6, 128, True, 0, 96, False),   # dead rows
        (1, 256, 512, 6, 128, True, 256, 0, True),   # Tq != Tk
        (1, 1000, 1000, 6, 128, True, 0, 0, False),  # ragged
        (2, 300, 300, 8, 64, True, 0, 0, False),
        (2, 300, 300, 8, 32, True, 0, 0, False),
        (1, 1024, 1024, 6, 128, True, 0, 0, True),
    ]
    return [(*c[:8], dtype, c[8]) for c in shapes
            for dtype in (torch.bfloat16, torch.float32)]


def case_name(b, tq, tk, h, d, causal, qo, ko, dtype, g_lse):
    return (f"B={b} Tq={tq} Tk={tk} H={h} D={d} causal={causal} "
            f"q_off={qo} kv_off={ko} g_lse={'random' if g_lse else 0} "
            f"{str(dtype)[6:]}")


def check_flash_bwd(fa, rng, dev):
    import torch

    for case in bwd_cases():
        b, tq, tk, h, d, causal, qo, ko, dtype, g_lse = case
        q, k, v, do, lse, dl = bwd_inputs(fa, rng, dev, b, tq, tk, h, d,
                                          causal, qo, ko, dtype, g_lse)
        scale = d ** -0.5
        dq = fa.flash_bwd_dq(q, k, v, do, lse, dl, causal, scale, qo, ko)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, dl, causal, scale, qo,
                                  ko)
        want = fa.flash_bwd_reference(q, k, v, do, lse, dl, causal, scale,
                                      qo, ko)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip((dq, dk, dv), want)]
        del want
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        name = case_name(*case)
        print(f"  flash_bwd {name}: relative max_abs_err dq={errs[0]:.3e} "
              f"dk={errs[1]:.3e} dv={errs[2]:.3e} (tol {tol:g})")
        require(max(errs) <= tol,
                f"flash_bwd disagrees with its plain version at {name}")
        require(all(x.dtype == dtype for x in (dq, dk, dv)),
                "flash_bwd: outputs not in the input dtype")
        if ko > qo:
            require(float(dq[:, :ko - qo].abs().max()) == 0.0,
                    "flash_bwd: dead rows' dq is not exact zeros")


# -- phase 3c: the one-pass backward ----------------------------------------
def bit_equal(got, want):
    """The same dtypes and torch.equal on each pair (+0 equals -0)."""
    import torch

    return all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))


def check_fused_bwd(fa, fu, rng, dev):
    """K4 against fused_bwd_reference (phase 3b's tolerances), twice
    bitwise equal, and bit for bit against K2 + K3 on the same inputs in
    both dtypes."""
    import torch

    for case in bwd_cases():
        b, tq, tk, h, d, causal, qo, ko, dtype, g_lse = case
        q, k, v, do, lse, dl = bwd_inputs(fa, rng, dev, b, tq, tk, h, d,
                                          causal, qo, ko, dtype, g_lse)
        args = (q, k, v, do, lse, dl, causal, d ** -0.5, qo, ko)
        got = fu.fused_bwd(*args)
        again = fu.fused_bwd(*args)
        two = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
        want = fu.fused_bwd_reference(*args)
        torch.cuda.synchronize()
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        del want
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        same, det = bit_equal(got, two), bit_equal(got, again)
        vs_two = max(rel_err(g, w) for g, w in zip(got, two))
        name = case_name(*case)
        print(f"  fused_bwd {name}: relative max_abs_err dq={errs[0]:.3e} "
              f"dk={errs[1]:.3e} dv={errs[2]:.3e} (tol {tol:g}); bit-equal "
              f"to K2+K3 {same} (relative difference {vs_two:.3e}); to "
              f"itself {det}")
        require(max(errs) <= tol,
                f"fused_bwd disagrees with its plain version at {name}")
        require(same, f"fused_bwd is not bit-equal to K2+K3 at {name}")
        require(det, f"fused_bwd differs between two launches at {name}")
        if ko > qo:
            require(float(got[0][:, :ko - qo].abs().max()) == 0.0,
                    "fused_bwd: dead rows' dq is not exact zeros")
        del got, again, two


def check_flash_grad(fa, rng, dev):
    """torch.autograd.grad through the kernels (FlashAttentionCore)
    against autograd through the plain attention_with_lse, with a
    nonzero lse cotangent."""
    import torch

    from dist_keras_tpu_torch.ops.attention import attention_with_lse

    b, t, h, d = 2, 1024, 6, 128
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, t, h, d), np.float32)).to(dev, dtype).requires_grad_()
            for _ in range(3))
        w = torch.from_numpy(rng.standard_normal((b, t, h, d),
                                                 np.float32)).to(dev)

        def loss(fn):
            out, lse = fn(q, k, v, causal=True)
            return (out.float() * w).sum() + torch.sin(lse).sum()

        before = (fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches)
        got = torch.autograd.grad(loss(fa.flash_attention_with_lse),
                                  (q, k, v))
        require((fa.flash_bwd_dq_launches, fa.flash_bwd_dkv_launches)
                == (before[0] + 1, before[1] + 1),
                "the autograd function did not launch K2 and K3 once each")
        want = torch.autograd.grad(loss(
            lambda *a, **kw: attention_with_lse(*a, p_dtype=dtype, **kw)),
            (q, k, v))
        errs = [rel_err(g, x) for g, x in zip(got, want)]
        print(f"  autograd B={b} T={t} H={h} D={d} causal "
              f"{str(dtype)[6:]}: relative max_abs_err dq={errs[0]:.3e} "
              f"dk={errs[1]:.3e} dv={errs[2]:.3e} (tol {tol:g})")
        require(max(errs) <= tol,
                "the flash autograd function disagrees with autograd "
                "through plain attention")


# -- phase 4: paged decode -------------------------------------------------
def paged_inputs(rng, dev, s, lengths, h=6, d=128, max_pages=128,
                 distinct=False):
    """q, pools, page table and lengths; ``distinct`` gives every slot
    pages of its own, as the engine's allocator does (else page ids are
    drawn with replacement)."""
    import torch

    pool = s * max_pages + 1
    mk = lambda *shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape, np.float32)).to(dev)
    q = mk(s, h, d)
    kp = mk(h, pool, PAGE_SIZE, d)
    vp = mk(h, pool, PAGE_SIZE, d)
    ids = (rng.permutation(pool)[:s * max_pages].reshape(s, max_pages)
           if distinct else rng.integers(0, pool, size=(s, max_pages)))
    pt = torch.from_numpy(ids.astype(np.int32)).to(dev)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, pt, ln


def check_paged(da, rng, dev):
    """K5 against its plain version at the decode rungs with the plan's
    n_split and with n_split forced to 1, 2 and the cap; against the
    plain split model; bit for bit against itself; and on two streams at
    once."""
    import torch

    full = 128 * PAGE_SIZE
    n_sm = da.sm_count(dev)
    cap = -(-full // da.CHUNK)
    picks = [0, 5, PAGE_SIZE, full, 1000, 33, full - 1, PAGE_SIZE + 1]
    for s in DECODE_LADDER:
        for lengths in ([1000] if s == 1 else picks[:s], [full] * s):
            q, kp, vp, pt, ln = paged_inputs(rng, dev, s, lengths)
            ref = da.paged_attention_reference(q, kp, vp, pt, ln)
            plan = da.split_plan(s, q.shape[1], 128, PAGE_SIZE, n_sm)
            for n_split in (None, 1, 2, cap):
                got = da.paged_attention_kernel(q, kp, vp, pt, ln,
                                                n_split=n_split)
                again = da.paged_attention_kernel(q, kp, vp, pt, ln,
                                                  n_split=n_split)
                torch.cuda.synchronize()
                n = plan if n_split is None else n_split
                err = float((got - ref).abs().max())
                split_err = float((got - da.paged_attention_split_reference(
                    q, kp, vp, pt, ln, n)).abs().max())
                same = torch.equal(got, again)
                print(f"  paged_decode S={s} lengths={lengths} n_split={n}"
                      f"{' (plan)' if n_split is None else ''} grid "
                      f"{q.shape[1]}x{s}x{n}: max_abs_err={err:.3e}, "
                      f"against the split model {split_err:.3e} (tol "
                      f"{F32_TOL:g}); two launches bit-equal {same}")
                require(err <= F32_TOL and split_err <= F32_TOL,
                        f"paged_decode disagrees with its plain version at "
                        f"S={s} n_split={n}")
                require(same, f"paged_decode is not deterministic at S={s} "
                              f"n_split={n}")
                for i, length in enumerate(lengths):
                    if length == 0:
                        require(float(got[i].abs().max()) == 0.0,
                                "paged_decode: a length-0 slot is not exact "
                                "zeros")
            if lengths == [full] * s and s in (1, DECODE_LADDER[-1]):
                blocks = q.shape[1] * s * plan
                require(blocks >= n_sm, f"the plan launches {blocks} blocks "
                                        f"for {n_sm} SMs at S={s}")
    check_paged_streams(da, rng, dev)


def check_paged_streams(da, rng, dev):
    """Launches on two streams at once, each with its own tickets and
    workspace: both give the plain version's result."""
    import torch

    full = 128 * PAGE_SIZE
    cases = [paged_inputs(rng, dev, 8, [full, 0, 1000, 33, full, 5, 17, 16]),
             paged_inputs(rng, dev, 4, [full] * 4)]
    refs = [da.paged_attention_reference(*c) for c in cases]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(8):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(da.paged_attention_kernel(*cases[i]))
    torch.cuda.synchronize()
    errs = [max(float((o - refs[i]).abs().max()) for o in outs[i])
            for i in range(2)]
    print(f"  paged_decode on two streams at once (8 launches each): "
          f"max_abs_err {errs[0]:.3e} / {errs[1]:.3e} (tol {F32_TOL:g})")
    require(max(errs) <= F32_TOL,
            "paged_decode disagrees with its plain version on two streams")


# -- phase 5: serving ------------------------------------------------------
def oracle_generate(params, prompt, max_new, attention, apply_block,
                    layer_norm):
    """Greedy tokens from a full forward over the growing sequence with
    plain attention, and the smallest top-2 logit margin seen."""
    import torch

    toks, out, margin = list(prompt), [], float("inf")
    dev = params["proj"].device
    for _ in range(max_new):
        x = torch.tensor(toks, device=dev)
        h = (params["proj"][x] + params["pos"][:len(toks)])[None]
        for blk in params["blocks"]:
            h = apply_block(blk, h, attention, True)
        hf = layer_norm(params["ln_f"], h)[0, -1]
        logits = hf @ params["head"]["kernel"] + params["head"]["bias"]
        top = torch.topk(logits, 2).values
        margin = min(margin, float(top[0] - top[1]))
        nxt = int(torch.argmax(logits))
        out.append(nxt)
        toks.append(nxt)
    return out, margin


def post_generate(addr, body):
    host, port = addr
    req = urllib.request.Request(
        f"http://{host}:{port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=600) as resp:
        text = resp.read().decode()
        status = resp.status
    if body.get("stream"):
        lines = [json.loads(x) for x in text.splitlines() if x.strip()]
        require(lines and lines[-1].get("done"), "stream lacks its final line")
        return status, {"generated": [x["token"] for x in lines[:-1]],
                        "finish": lines[-1].get("finish"),
                        "ttft_s": lines[-1].get("ttft_s")}
    return status, json.loads(text)


def serve(rng, fa, da, dev):
    import torch

    from dist_keras_tpu_torch.models.transformer import (
        Transformer,
        apply_block,
        layer_norm,
        transformer_config,
    )
    from dist_keras_tpu_torch.ops.attention import attention
    from dist_keras_tpu_torch.serving import DecodeEngine, ServingServer

    model = Transformer(transformer_config(**MODEL), seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    engine = DecodeEngine(model, prefill_ladder=PREFILL_LADDER,
                          decode_ladder=DECODE_LADDER, page_size=PAGE_SIZE,
                          device=dev, max_new_default=MAX_NEW)
    print(f"  model {MODEL} params={n_params} pool pages="
          f"{engine.num_pages} page_size={PAGE_SIZE}")
    server = ServingServer(engine, port=0, request_timeout_s=600)
    addr = server.start()
    prompts = [rng.integers(0, MODEL["input_dim"], size=n).tolist()
               for n in PROMPT_LENS]
    try:
        # warm-up: one short request through the same path (allocator,
        # cuBLAS handles, kernel libraries loaded) before counting
        status, _ = post_generate(addr, {"tokens": prompts[0],
                                         "max_new_tokens": 2})
        require(status == 200, f"warm-up /generate answered {status}")
        fa.flash_fwd_launches = 0
        da.paged_decode_launches = 0
        results = [None] * len(prompts)

        def call(i):
            body = {"tokens": prompts[i], "max_new_tokens": MAX_NEW}
            if i == STREAMED:
                body["stream"] = True
            results[i] = post_generate(addr, body)

        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(prompts))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": fa.flash_fwd_launches,
                    "paged_decode": da.paged_decode_launches}
        print(f"  launches on the main path: {launches}")
        require(all(r is not None for r in results),
                "a /generate request never returned")
        stats = engine.stats()
        server.drain(timeout_s=600)
        kv = engine.kv_stats()
        engine.assert_no_leaks()
    finally:
        server.close()

    params = model.params
    margins, ttfts, n_tokens = [], [], 0
    with torch.inference_mode():
        for i, ((status, doc), prompt) in enumerate(zip(results, prompts)):
            require(status == 200, f"request {i} answered {status}")
            want, margin = oracle_generate(params, prompt, MAX_NEW,
                                           attention, apply_block,
                                           layer_norm)
            margins.append(margin)
            print(f"  request {i}: prompt_len={len(prompt)} "
                  f"{'streamed ' if i == STREAMED else ''}"
                  f"finish={doc['finish']} ttft_s={doc['ttft_s']:.4f} "
                  f"oracle_equal={doc['generated'] == want} "
                  f"min_top2_margin={margin:.4e}")
            require(doc["generated"] == want,
                    f"request {i}: served tokens differ from the oracle")
            ttfts.append(doc["ttft_s"])
            n_tokens += len(doc["generated"])
    print(f"  smallest top-2 logit margin the oracle saw: {min(margins):.4e}")
    require(launches["flash_fwd"] > 0, "flash_fwd never launched")
    require(launches["paged_decode"] > 0, "paged_decode never launched")
    require(kv["used_pages"] == 0, f"KV pages in use after drain: {kv}")
    require(stats["retrace_count"] <= stats["retrace_bound"],
            f"shape count {stats['retrace_count']} over its bound")
    print(f"  shapes dispatched {stats['shapes_dispatched']} "
          f"(bound {stats['retrace_bound']})")
    return engine, launches, {"tokens": n_tokens, "wall_s": wall,
                              "ttft_p50_s": float(np.median(ttfts))}


# -- phase 6: timing -------------------------------------------------------
def time_kernels(fa, da, rng, dev, gpu):
    import torch
    import torch.nn.functional as F

    rows = []
    b, t, h, d = 1, PREFILL_LADDER[-1], MODEL["n_heads"], \
        MODEL["d_model"] // MODEL["n_heads"]
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d),
                                                    np.float32)).to(dev)
               for _ in range(3))
    scale = d ** -0.5
    out, _ = fa.flash_fwd(q, k, v, True, scale, 0, 0)
    ref, _ = fa.flash_attention_reference(q, k, v, causal=True)
    err = float((out - ref).abs().max())
    ms = time_ms(lambda: fa.flash_fwd(q, k, v, True, scale, 0, 0))
    plain = time_ms(lambda: fa.flash_attention_reference(q, k, v,
                                                         causal=True))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    pairs = t * (t + 1) // 2
    nbytes = 4 * b * t * h * d * 4 + b * h * t * 4
    bnd, by = bound_ms(nbytes, 4 * d * b * h * pairs, "float32_split_tf32")
    rows.append({"name": "flash_fwd", "route": "cuda",
                 "source": "dist_keras_tpu_torch/csrc/flash_fwd_f32.cuh",
                 "replaces":
                     "dist_keras_tpu/ops/pallas/flash_attention.py:131",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain,
                 "bound_ms": bnd, "bound_by": by, "library_ms": lib,
                 "shape": f"B={b} T={t} H={h} D={d} causal f32"})

    rows.append(time_paged_rungs(da, rng, dev, gpu)[DECODE_LADDER[-1]])
    for r in rows:
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        print(f"  {r['name']} [{r['shape']}] on {gpu}: {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {lib}, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


L2_BYTES = 50e6     # the H100's L2


def time_paged_rungs(da, rng, dev, gpu):
    """K5 at each decode rung with every slot at full length (2048
    positions), and at the decode step's shape, with its bound and its
    plain version's time.  Slots hold pages of their own, as the engine's
    allocator gives them, and the timed calls rotate over enough input
    sets (at least two, at least three times the L2 in all) that each
    call reads its K/V from device memory, not from the L2.  Calls only
    ``paged_attention_kernel(q, kp, vp, pt, ln)``, so it times an older
    tree's kernel too (``--paged-timing-of``).  -> {S: JSON row} of the
    full-length rungs."""
    import torch

    h, d = MODEL["n_heads"], MODEL["d_model"] // MODEL["n_heads"]
    full = 128 * PAGE_SIZE
    rows = {}
    # each rung at full length, then the decode step's shape (phase 6's
    # "decode step": S=8 at position 1000, 1001 positions per slot)
    for s, n in [(s, full) for s in DECODE_LADDER] + [(DECODE_LADDER[-1],
                                                      1001)]:
        lengths = [n] * s
        kv_bytes = 2 * h * s * n * d * 4
        n_sets = max(2, -(-int(3 * L2_BYTES) // kv_bytes))
        sets = [paged_inputs(rng, dev, s, lengths, h=h, d=d, distinct=True)
                for _ in range(n_sets)]
        err = max(float((da.paged_attention_kernel(*a)
                          - da.paged_attention_reference(*a)).abs().max())
                  for a in sets)
        require(err <= F32_TOL, f"paged_decode disagrees with its plain "
                                f"version at S={s}")
        turn = iter(range(1 << 62))
        ms = time_ms(lambda: da.paged_attention_kernel(
            *sets[next(turn) % n_sets]), reps=10 * n_sets)
        plain = time_ms(lambda: da.paged_attention_reference(
            *sets[next(turn) % n_sets]), reps=2 * n_sets, trials=5)
        pt = sets[0][3]
        nbytes = kv_bytes + 2 * s * h * d * 4 + pt.numel() * 4 + s * 4
        bnd, by = bound_ms(nbytes, 4 * h * d * s * n)
        print(f"  paged_decode [S={s} lengths={n}] on {gpu}: {ms:.4f} ms "
              f"({kv_bytes / ms / 1e9:.3f} TB/s of K/V), plain {plain:.4f} "
              f"ms, bound {bnd:.4f} ms ({by}); {n_sets} input sets of "
              f"{kv_bytes / 1e6:.1f} MB of K/V in turn, so each call reads "
              f"from device memory, not the L2")
        del sets
        if n != full:
            continue
        rows[s] = {"name": "paged_decode", "route": "cuda",
                   "source": "dist_keras_tpu_torch/csrc/paged_decode.cu",
                   "replaces":
                       "dist_keras_tpu/ops/pallas/decode_attention.py:100",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain,
                   "bound_ms": bnd, "bound_by": by, "library_ms": None,
                   "shape": f"S={s} H={h} D={d} page_size={PAGE_SIZE} "
                            f"max_pages=128 lengths={full} f32"}
    # beside the bytes: the launch and the combine alone (every slot
    # empty), and the rate of a plain read of 200 MB (torch.sum)
    s = DECODE_LADDER[-1]
    empty = paged_inputs(rng, dev, s, [0] * s, h=h, d=d, distinct=True)
    fixed = time_ms(lambda: da.paged_attention_kernel(*empty))
    big = torch.ones(50 * 2 ** 20, device=dev)
    read = time_ms(lambda: big.sum(), reps=10)
    print(f"  paged_decode [S={s} lengths=0] on {gpu}: {fixed:.4f} ms (launch "
          f"and combine, no K/V); torch.sum over {big.numel() * 4 / 1e6:.0f} "
          f"MB: {read:.4f} ms = {big.numel() * 4 / read / 1e9:.3f} TB/s")
    return rows


def time_step(engine, dev, gpu):
    """One full decode step of the served model (S=8 slots at position
    1000): host wall per step, as the engine's scheduler sees it, beside
    the device time of the same step; their gap is the card's idle
    share."""
    import torch

    s, ps = DECODE_LADDER[-1], PAGE_SIZE
    pos = 1000
    pmax = engine.max_pages_per_seq
    tables = torch.arange(s * pmax, dtype=torch.int32,
                          device=dev).view(s, pmax)
    args = (torch.arange(s, device=dev) % engine.vocab,
            torch.full((s,), pos, device=dev), tables,
            tables[:, pos // ps].long(),
            torch.full((s,), pos % ps, device=dev),
            torch.full((s,), pos + 1, dtype=torch.int32, device=dev))
    rep = engine._replicas[0]

    def step():
        return engine._decode_fn(engine._params, rep.kp, rep.vp, *args)

    with torch.inference_mode():
        device_ms = time_ms(step, reps=10, trials=5, sleep_ms=200)
        step().cpu()
        t0 = time.perf_counter()
        for _ in range(20):
            step().cpu()
        wall_ms = (time.perf_counter() - t0) / 20 * 1e3
        n_prof = 10
        groups = profile_kernels(lambda: [step() for _ in range(n_prof)],
                                 {"paged_decode": ("paged_decode_kernel",)})
        groups = {k: v / n_prof for k, v in groups.items()}
    print(f"  decode step [S={s} position {pos}] on {gpu}: wall "
          f"{wall_ms:.3f} ms, device {device_ms:.3f} ms, card idle "
          f"{max(0.0, 1 - device_ms / wall_ms):.0%} of the step")
    print_profile(f"decode step [S={s} position {pos}], mean of {n_prof}",
                  groups, gpu)


# -- phase 7: training -----------------------------------------------------
def plain_block(q, k, v, causal=False):
    """The ring of one block with PLAIN attention (autograd through
    attention_with_lse, p rounded to the input dtype as the kernels do)."""
    from dist_keras_tpu_torch.ops.attention import attention_with_lse

    return attention_with_lse(q, k, v, causal=causal, p_dtype=v.dtype)[0]


def train_data(rng, dev, batch, seq):
    import torch

    x = torch.from_numpy(rng.standard_normal(
        (batch, seq, TRAIN_MODEL["input_dim"]), np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, TRAIN_MODEL["n_classes"], batch)
                         ).to(dev)
    return x, y


def compare_grads(label, got, want, tol):
    """Loss and per-leaf relative norm error of two (loss, grads)."""
    from dist_keras_tpu_torch.utils.pytree import tree_leaves

    (loss, grads), (wloss, wgrads) = got, want
    errs = [float((g - w).norm() / w.norm().clamp_min(1e-30))
            for g, w in zip(tree_leaves(grads), tree_leaves(wgrads))]
    lerr = abs(float(loss) - float(wloss)) / abs(float(wloss))
    print(f"  {label}: loss {float(loss):.6f} vs {float(wloss):.6f} "
          f"(relative {lerr:.3e}); {len(errs)} gradient leaves, largest "
          f"relative norm error {max(errs):.3e} (tol {tol:g})")
    require(lerr <= tol and max(errs) <= tol, f"{label}: disagree")
    require(all(np.isfinite(e) for e in errs), f"{label}: non-finite grads")


def train(fa, fu, rng, dev, gpu):
    import torch

    from dist_keras_tpu_torch.models.transformer import transformer_config
    from dist_keras_tpu_torch.parallel import make_tp_train_step
    from dist_keras_tpu_torch.parallel.transformer_tp import loss_and_grads
    from dist_keras_tpu_torch.utils.pytree import tree_leaves

    cfg = transformer_config(**TRAIN_MODEL)
    factory, init_fn = make_tp_train_step(
        cfg, causal=True, compute_dtype=torch.bfloat16, device=dev)
    params, _ = init_fn(0)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"  model {TRAIN_MODEL} batch {TRAIN_BATCH} causal bf16 compute, "
          f"{n_params} f32 master params, adam(1e-3)")
    x, y = train_data(rng, dev, TRAIN_BATCH, TRAIN_MODEL["seq_len"])
    for dtype, tol in ((torch.bfloat16, STEP_BF16_TOL),
                       (torch.float32, STEP_F32_TOL)):
        kw = dict(causal=True, compute_dtype=dtype)
        got = loss_and_grads(params, x, y, cfg, **kw)
        want = loss_and_grads(params, x, y, cfg, attn_fn=plain_block, **kw)
        compare_grads(f"one step, kernels vs plain attention, "
                      f"{str(dtype)[6:]}", got, want, tol)
        del got, want
    del params
    torch.cuda.empty_cache()

    launches = run_steps(fa, fu, factory, init_fn, x, y, gpu)
    per_step = TRAIN_STEPS * TRAIN_MODEL["n_layers"]
    require(launches == {"flash_fwd": per_step, "flash_bwd_dq": per_step,
                         "flash_bwd_dkv": per_step, "flash_bwd_fused": 0},
            f"expected {per_step} launches of K1, K2 and K3 (one per layer "
            f"per step) and none of K4, got {launches}")
    return launches, x, y


def run_steps(fa, fu, factory, init_fn, x, y, gpu):
    """10 adam steps from init_fn(0) with the launch counts zeroed just
    before and read just after; then
    tokens/s, one step's wall beside its device time, and its profile.
    -> launches."""
    import torch

    params, opt_state = init_fn(0)
    step = factory(params, opt_state)
    torch.cuda.synchronize()
    fa.flash_fwd_launches = 0
    fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = 0
    fu.fused_bwd_launches = 0
    losses = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        params, opt_state, loss = step(params, opt_state, x, y)
        losses.append(loss)
    losses = [float(v) for v in losses]
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fa.flash_fwd_launches,
                "flash_bwd_dq": fa.flash_bwd_dq_launches,
                "flash_bwd_dkv": fa.flash_bwd_dkv_launches,
                "flash_bwd_fused": fu.fused_bwd_launches}
    print(f"  {TRAIN_STEPS} adam steps: losses "
          f"{[round(v, 5) for v in losses]}")
    print(f"  launches on the main path: {launches}")
    require(all(np.isfinite(losses)), "a training loss is not finite")
    tokens = TRAIN_BATCH * TRAIN_MODEL["seq_len"] * TRAIN_STEPS
    print(f"  training: {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tokens/s on {gpu}")
    time_train_step(lambda: step(params, opt_state, x, y),
                    f"train step [B={TRAIN_BATCH} "
                    f"T={TRAIN_MODEL['seq_len']}]", gpu)
    return launches


def time_train_step(one_step, label, gpu):
    """One training step's host wall beside its device time (the card's
    idle share), then its profile."""
    device_ms = time_ms(one_step, reps=3, trials=3, sleep_ms=400)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        float(one_step()[2])
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls))
    print(f"  {label} on {gpu}: wall {wall_ms:.3f} ms, device "
          f"{device_ms:.3f} ms, card idle "
          f"{max(0.0, 1 - device_ms / wall_ms):.0%} of the step")
    profile_step(one_step, gpu)


def profile_step(one_step, gpu):
    """Device time of one training step by kernel, from torch.profiler:
    the attention kernels, cuBLAS products, and the rest."""
    kernels = {"flash_fwd": ("flash_fwd_f32_kernel", "flash_fwd_bf16_kernel"),
               "flash_bwd_dq": ("flash_bwd_dq_f32_kernel",
                                "flash_bwd_dq_bf16_kernel"),
               "flash_bwd_dkv": ("flash_bwd_dkv_f32_kernel",
                                 "flash_bwd_dkv_bf16_kernel"),
               "flash_bwd_fused": ("flash_bwd_fused_f32_kernel",
                                   "flash_bwd_fused_bf16_kernel")}
    print_profile("train step", profile_kernels(one_step, kernels), gpu)


def profile_kernels(one_step, kernels):
    """Device time of one call of ``one_step`` by kernel, from
    torch.profiler: {group: microseconds} for each group of ``kernels``
    ({group: kernel-name fragments}), cuBLAS products, and the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_step()
        torch.cuda.synchronize()
    groups = dict.fromkeys(kernels, 0.0)
    groups.update({"cuBLAS products": 0.0, "other kernels": 0.0})
    for ev in prof.key_averages():
        name, us = ev.key, ev.self_device_time_total
        for kernel, fns in kernels.items():
            if any(fn in name for fn in fns):
                groups[kernel] += us
                break
        else:
            gemm = any(tag in name for tag in ("nvjet", "gemm", "gemv",
                                                 "cutlass"))
            groups["cuBLAS products" if gemm else "other kernels"] += us
    return groups


def print_profile(label, groups, gpu):
    total = sum(groups.values())
    require(total > 0, f"the profiler saw no device time in a {label}")
    shares = ", ".join(f"{k} {v / 1e3:.3f} ms ({v / total:.1%})"
                       for k, v in groups.items())
    print(f"  {label} device time by kernel (torch.profiler) on {gpu}: "
          f"{total / 1e3:.3f} ms = {shares}")


def check_remat(rng, dev):
    """remat="mlp" against remat=False at the long-context example's size,
    both on the kernels: the same loss and grads (the MLP recompute is the
    same arithmetic)."""
    import torch

    from dist_keras_tpu_torch.models.transformer import transformer_config
    from dist_keras_tpu_torch.parallel import make_tp_train_step
    from dist_keras_tpu_torch.parallel.transformer_tp import loss_and_grads

    cfg = transformer_config(**dict(TRAIN_MODEL, seq_len=LONG_SEQ))
    _, init_fn = make_tp_train_step(cfg, device=dev)
    params, _ = init_fn(0)
    x, y = train_data(rng, dev, LONG_BATCH, LONG_SEQ)
    res = {}
    for remat in (False, "mlp"):
        torch.cuda.reset_peak_memory_stats()
        res[remat] = loss_and_grads(params, x, y, cfg, causal=True,
                                    compute_dtype=torch.bfloat16,
                                    remat=remat)
        print(f"  remat={remat!r} B={LONG_BATCH} T={LONG_SEQ}: peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    compare_grads(f"remat='mlp' vs remat=False, B={LONG_BATCH} "
                  f"T={LONG_SEQ} bf16", res["mlp"], res[False], REMAT_TOL)


# -- phase 7b: training through the DK_FUSED_BWD route ----------------------
def fused_step(fa, fu, params, x, y, cfg, dtype):
    """One step's (loss, grads) with the knob off, then on, the launch
    counts zeroed just before each step and read just after.
    -> (knob-on launches, knob-on bit-equal to knob-off, knob-off
    launches)."""
    import torch

    from dist_keras_tpu_torch.parallel.transformer_tp import loss_and_grads
    from dist_keras_tpu_torch.utils.pytree import tree_leaves

    def counted(knob):
        if knob:
            os.environ["DK_FUSED_BWD"] = "1"
        else:
            os.environ.pop("DK_FUSED_BWD", None)
        torch.cuda.synchronize()
        fa.flash_bwd_dq_launches = fa.flash_bwd_dkv_launches = 0
        fu.fused_bwd_launches = 0
        res = loss_and_grads(params, x, y, cfg, causal=True,
                             compute_dtype=dtype)
        torch.cuda.synchronize()
        return res, {"flash_bwd_fused": fu.fused_bwd_launches,
                     "flash_bwd_dq": fa.flash_bwd_dq_launches,
                     "flash_bwd_dkv": fa.flash_bwd_dkv_launches}

    off, off_launches = counted(False)
    on, launches = counted(True)
    same = bit_equal([on[0], *tree_leaves(on[1])],
                     [off[0], *tree_leaves(off[1])])
    print(f"  one step B={x.shape[0]} T={x.shape[1]} {str(dtype)[6:]}, "
          f"DK_FUSED_BWD=1: launches {launches}; loss {float(on[0]):.6f} "
          f"and {len(tree_leaves(on[1]))} gradient leaves bit-equal to the "
          f"knob-off step: {same}")
    return launches, same, off_launches


def rejections(obs):
    kinds = [json.loads(line)["kind"] for f in Path(obs).glob("events-*")
             for line in f.read_text().splitlines() if line.strip()]
    return kinds.count("fused_bwd_rejected"), len(kinds)


def train_fused(fa, fu, rng, dev, gpu, x, y):
    """DK_FUSED_BWD=1.  bf16 at phase 7's two sizes: ``graduate`` is exact
    (K4 is K2 + K3 bit for bit), the step runs K4 only, bit-equal to the
    knob-off step; at the training size also one adam step's wall,
    device time and profile.  f32 at the training size: likewise, with
    the step's wall, device time and profile, knob on and knob off.  No ``fused_bwd_rejected``
    is written.  -> the bf16 training-size step's launches."""
    import tempfile

    import torch

    from dist_keras_tpu_torch.models.transformer import transformer_config
    from dist_keras_tpu_torch.observability import events
    from dist_keras_tpu_torch.parallel import make_tp_train_step

    h = TRAIN_MODEL["n_heads"]
    d = TRAIN_MODEL["d_model"] // h
    layers = TRAIN_MODEL["n_layers"]
    only_k4 = {"flash_bwd_fused": layers, "flash_bwd_dq": 0,
               "flash_bwd_dkv": 0}
    obs_dir = tempfile.TemporaryDirectory(prefix="dk_obs_")
    obs = obs_dir.name
    saved = {k: os.environ.get(k) for k in ("DK_FUSED_BWD", "DK_OBS_DIR")}
    os.environ["DK_OBS_DIR"] = obs
    events.reset()
    fu.clear_verdicts()
    b, t = TRAIN_BATCH, TRAIN_MODEL["seq_len"]
    try:
        sizes = ((b, t, x, y),
                 (LONG_BATCH, LONG_SEQ) + train_data(rng, dev, LONG_BATCH,
                                                     LONG_SEQ))
        for dtype in (torch.bfloat16, torch.float32):
            for sb, st, xs, ys in sizes if dtype == torch.bfloat16 \
                    else sizes[:1]:
                verdict = fu.graduate(sb * h, st, st, d, dtype, True)
                print(f"  graduate B={sb} T={st} (bh={sb * h}) "
                      f"{str(dtype)[6:]} causal: {verdict.status}, rel err "
                      f"{verdict.err}")
                require(verdict.status == "exact" and verdict.err == 0.0,
                        f"K4 did not graduate at B={sb} T={st} "
                        f"{str(dtype)[6:]}: {verdict.reason}")
                cfg = transformer_config(**dict(TRAIN_MODEL, seq_len=st))
                factory, init_fn = make_tp_train_step(
                    cfg, causal=True, compute_dtype=dtype, device=dev)
                params, opt_state = init_fn(0)
                launches, same, off = fused_step(fa, fu, params, xs, ys,
                                                 cfg, dtype)
                require(launches == only_k4,
                        f"the graduated route launched {launches}")
                require(same, f"the knob-on step differs from the knob-off "
                              f"step at B={sb} T={st} {str(dtype)[6:]}")
                if (sb, st) == (b, t):
                    if dtype == torch.bfloat16:
                        bf16_launches = launches
                    else:   # the f32 kernels' launches in one f32 step
                        f32_launches = {
                            "flash_bwd_fused_f32": launches[
                                "flash_bwd_fused"],
                            "flash_bwd_dq_f32": off["flash_bwd_dq"],
                            "flash_bwd_dkv_f32": off["flash_bwd_dkv"]}
                    step = factory(params, opt_state)
                    time_train_step(
                        lambda: step(params, opt_state, xs, ys),
                        f"train step {str(dtype)[6:]} DK_FUSED_BWD=1 "
                        f"[B={sb} T={st}]", gpu)
                    if dtype == torch.float32:   # beside it, K2 + K3
                        os.environ.pop("DK_FUSED_BWD")
                        time_train_step(
                            lambda: step(params, opt_state, xs, ys),
                            f"train step float32 knob off [B={sb} "
                            f"T={st}]", gpu)
                        os.environ["DK_FUSED_BWD"] = "1"
                    del step
                del params, opt_state
                torch.cuda.empty_cache()
        n_rej, n_events = rejections(obs)
        print(f"  events under DK_OBS_DIR: {n_rej} fused_bwd_rejected of "
              f"{n_events}")
        require(n_rej == 0, f"the graduated route wrote {n_rej} "
                            f"fused_bwd_rejected events")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        events.reset()
        obs_dir.cleanup()
    return bf16_launches, f32_launches


# -- phase 8: timing at the training shape ----------------------------------
def time_train_kernels(fa, fu, rng, dev, gpu):
    import torch
    import torch.nn.functional as F

    b, t, h = TRAIN_BATCH, TRAIN_MODEL["seq_len"], TRAIN_MODEL["n_heads"]
    d = TRAIN_MODEL["d_model"] // h
    dtype = torch.bfloat16
    scale = d ** -0.5
    q, k, v, do, lse, dl = bwd_inputs(fa, rng, dev, b, t, t, h, d, True, 0,
                                      0, dtype, False)
    args = (q, k, v, do, lse, dl, True, scale, 0, 0)
    n, es = b * t * h * d, 2
    rows_bh = b * h * t * 4               # one f32 value per row
    pairs = b * h * t * (t + 1) // 2
    shape = f"B={b} T={t} H={h} D={d} causal bf16"

    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    g = do.transpose(1, 2)
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=10, trials=5)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), g, retain_graph=True), reps=10, trials=5)

    out, _ = fa.flash_fwd(q, k, v, True, scale, 0, 0)
    ref, _ = fa.flash_attention_reference(q, k, v, causal=True)
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    want = fa.flash_bwd_reference(*args)
    fused = fu.fused_bwd(*args)
    fused_want = fu.fused_bwd_reference(*args)
    rows = []
    for name, err, rel, run, plain, nbytes, flops, lib in (
            ("flash_fwd_bf16", max_abs_err(out, ref), row_rel_err(out, ref),
             lambda: fa.flash_fwd(q, k, v, True, scale, 0, 0),
             lambda: fa.flash_attention_reference(q, k, v, causal=True),
             4 * n * es + rows_bh, 4 * d * pairs, sdpa_fwd),
            ("flash_bwd_dq", max_abs_err(dq, want[0]), rel_err(dq, want[0]),
             lambda: fa.flash_bwd_dq(*args),
             lambda: fa.flash_bwd_dq_reference(*args),
             5 * n * es + 2 * rows_bh, 6 * d * pairs, sdpa_bwd),
            ("flash_bwd_dkv",
             max(max_abs_err(dk, want[1]), max_abs_err(dv, want[2])),
             max(rel_err(dk, want[1]), rel_err(dv, want[2])),
             lambda: fa.flash_bwd_dkv(*args),
             lambda: fa.flash_bwd_dkv_reference(*args),
             6 * n * es + 2 * rows_bh, 8 * d * pairs, sdpa_bwd),
            ("flash_bwd_fused",
             max(max_abs_err(g, w) for g, w in zip(fused, fused_want)),
             max(rel_err(g, w) for g, w in zip(fused, fused_want)),
             lambda: fu.fused_bwd(*args),
             lambda: fu.fused_bwd_reference(*args),
             7 * n * es + 2 * rows_bh, 10 * d * pairs, sdpa_bwd)):
        measure = ("row-relative" if name == "flash_fwd_bf16"
                   else "relative to the largest entry")
        print(f"  {name} [{shape}]: max_abs_err {err:.3e}, {measure} "
              f"{rel:.3e} (tol {BF16_TOL:g})")
        require(rel <= BF16_TOL,
                f"{name} disagrees with its plain version at {shape}")
        ms = time_ms(run, reps=10, trials=5)
        plain_ms = time_ms(plain, reps=3, trials=3)
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        source, replaces = {
            "flash_fwd_bf16": ("flash_fwd_bf16.cuh",
                               "flash_attention.py:131"),
            "flash_bwd_dq": ("flash_bwd_bf16.cuh", "flash_attention.py:285"),
            "flash_bwd_dkv": ("flash_bwd_bf16.cuh",
                              "flash_attention.py:320"),
            "flash_bwd_fused": ("flash_bwd_bf16.cuh",
                                "fused_bwd_experimental.py:78")}[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"dist_keras_tpu_torch/csrc/{source}",
                     "replaces": f"dist_keras_tpu/ops/pallas/{replaces}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd, "bound_by": by, "library_ms": lib,
                     "shape": shape})
    for r in rows:
        lib = ("scaled_dot_product_attention backward (dq, dk, dv "
               "together)" if r["name"] != "flash_fwd_bf16"
               else "scaled_dot_product_attention")
        print(f"  {r['name']} [{r['shape']}] on {gpu}: {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} "
              f"ms ({lib}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"max_abs_err {r['max_abs_err']:.3e}")
    ms = {r["name"]: r["ms"] for r in rows}
    fused_vs_two(ms["flash_bwd_fused"], ms["flash_bwd_dq"],
                 ms["flash_bwd_dkv"], shape, gpu, fused, (dq, dk, dv))
    del q, k, v, do, lse, dl, args, qt, kt, vt, g, sdpa_out, out, ref
    del dq, dk, dv, want, fused, fused_want
    torch.cuda.empty_cache()
    b, t = LONG_BATCH, LONG_SEQ
    q, k, v, do, lse, dl = bwd_inputs(fa, rng, dev, b, t, t, h, d, True, 0,
                                      0, dtype, False)
    args = (q, k, v, do, lse, dl, True, scale, 0, 0)
    fused = fu.fused_bwd(*args)
    two = (fa.flash_bwd_dq(*args), *fa.flash_bwd_dkv(*args))
    errs = [rel_err(g, w) for g, w in zip(two, fa.flash_bwd_reference(*args))]
    print(f"  flash_bwd_dq / flash_bwd_dkv [B={b} T={t} H={h} D={d} causal "
          f"bf16]: relative max_abs_err dq={errs[0]:.3e} dk={errs[1]:.3e} "
          f"dv={errs[2]:.3e} (tol {BF16_TOL:g})")
    require(max(errs) <= BF16_TOL, f"flash_bwd disagrees with its plain "
                                   f"version at B={b} T={t}")
    fused_vs_two(time_ms(lambda: fu.fused_bwd(*args), reps=5, trials=5),
                 time_ms(lambda: fa.flash_bwd_dq(*args), reps=5, trials=5),
                 time_ms(lambda: fa.flash_bwd_dkv(*args), reps=5, trials=5),
                 f"B={b} T={t} H={h} D={d} causal bf16", gpu, fused, two)
    del fused, two
    out, _ = fa.flash_fwd(q, k, v, True, scale, 0, 0)
    ref, _ = fa.flash_attention_reference(q, k, v, causal=True)
    rel = row_rel_err(out, ref)
    require(rel <= BF16_TOL, f"flash_fwd disagrees with its plain version "
                             f"at B={b} T={t}")
    del out, ref
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    k1 = time_ms(lambda: fa.flash_fwd(q, k, v, True, scale, 0, 0), reps=10,
                 trials=5)
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=10, trials=5)
    bnd, _ = bound_ms(4 * b * t * h * d * 2 + b * h * t * 4,
                      4 * d * b * h * t * (t + 1) // 2, "bfloat16")
    print(f"  flash_fwd_bf16 vs scaled_dot_product_attention [B={b} T={t} "
          f"H={h} D={d} causal bf16] on {gpu}: {k1:.4f} ms vs {sdpa:.4f} ms "
          f"({k1 / sdpa:.3f}x), bound {bnd:.4f} ms, row-relative {rel:.3e}")
    del q, k, v, do, lse, dl, args, qt, kt, vt
    torch.cuda.empty_cache()
    time_f32_train_fwd(fa, rng, dev, gpu)
    torch.cuda.empty_cache()
    return rows + time_f32_train_bwd(fa, fu, rng, dev, gpu)


def time_f32_train_fwd(fa, rng, dev, gpu):
    """K1 in f32 (split TF32) at the training shape against SDPA's f32
    forward (TF32 off) and its plain version."""
    import torch
    import torch.nn.functional as F

    b, t, h = TRAIN_BATCH, TRAIN_MODEL["seq_len"], TRAIN_MODEL["n_heads"]
    d = TRAIN_MODEL["d_model"] // h
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d),
                                                    np.float32)).to(dev)
               for _ in range(3))
    out, lse = fa.flash_fwd(q, k, v, True, d ** -0.5, 0, 0)
    ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
    err, rerr = max_abs_err(out, ref), row_rel_err(out, ref)
    lerr = max_abs_err(lse, ref_lse)
    del out, lse, ref, ref_lse
    shape = f"B={b} T={t} H={h} D={d} causal f32"
    print(f"  flash_fwd [{shape}]: out max_abs_err {err:.3e} row-relative "
          f"{rerr:.3e} (tol {F32_TOL:g}), lse {lerr:.3e} (tol {LSE_TOL:g})")
    require(err <= F32_TOL and rerr <= F32_TOL and lerr <= LSE_TOL,
            f"flash_fwd disagrees with its plain version at {shape}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    k1 = time_ms(lambda: fa.flash_fwd(q, k, v, True, d ** -0.5, 0, 0),
                 reps=5, trials=5)
    sdpa = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), reps=5, trials=5)
    plain = time_ms(lambda: fa.flash_attention_reference(q, k, v,
                                                         causal=True),
                    reps=2, trials=3)
    pairs = b * h * t * (t + 1) // 2
    bnd, _ = bound_ms(4 * b * t * h * d * 4 + b * h * t * 4, 4 * d * pairs,
                      "float32_split_tf32")
    print(f"  flash_fwd vs scaled_dot_product_attention [{shape}] on {gpu}: "
          f"{k1:.4f} ms vs {sdpa:.4f} ms ({k1 / sdpa:.3f}x), plain "
          f"{plain:.4f} ms, bound {bnd:.4f} ms (split-TF32 rate)")


def time_f32_train_bwd(fa, fu, rng, dev, gpu):
    """K2, K3 and K4 in f32 (split-TF32 tensor-core kernels) at the
    training shape, each held against its plain version, beside SDPA's
    f32 backward (TF32 off) as the library yardstick; bounds at the
    split-TF32 rate (the JSON rows) and at the f32 FMA rate.
    -> JSON rows."""
    import torch
    import torch.nn.functional as F

    b, t, h = TRAIN_BATCH, TRAIN_MODEL["seq_len"], TRAIN_MODEL["n_heads"]
    d = TRAIN_MODEL["d_model"] // h
    shape = f"B={b} T={t} H={h} D={d} causal f32"
    q, k, v, do, lse, dl = bwd_inputs(fa, rng, dev, b, t, t, h, d, True, 0,
                                      0, torch.float32, False)
    args = (q, k, v, do, lse, dl, True, d ** -0.5, 0, 0)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                  for x in (q, k, v))
    sdpa_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    g = do.transpose(1, 2)
    sdpa_bwd = time_ms(lambda: torch.autograd.grad(
        sdpa_out, (qt, kt, vt), g, retain_graph=True), reps=5, trials=5)
    del qt, kt, vt, sdpa_out, g
    torch.cuda.empty_cache()
    n, es = b * t * h * d, 4
    rows_bh = b * h * t * 4
    pairs = b * h * t * (t + 1) // 2
    dq = fa.flash_bwd_dq(*args)
    dk, dv = fa.flash_bwd_dkv(*args)
    fused = fu.fused_bwd(*args)
    rows, times = [], {}
    for name, got, run, plain, nbytes, flops, source, replaces in (
            ("flash_bwd_dq_f32", (dq,), lambda: fa.flash_bwd_dq(*args),
             lambda: fa.flash_bwd_dq_reference(*args),
             5 * n * es + 2 * rows_bh, 6 * d * pairs, "flash_bwd_f32.cuh",
             "flash_attention.py:285"),
            ("flash_bwd_dkv_f32", (dk, dv), lambda: fa.flash_bwd_dkv(*args),
             lambda: fa.flash_bwd_dkv_reference(*args),
             6 * n * es + 2 * rows_bh, 8 * d * pairs, "flash_bwd_f32.cuh",
             "flash_attention.py:320"),
            ("flash_bwd_fused_f32", fused, lambda: fu.fused_bwd(*args),
             lambda: fu.fused_bwd_reference(*args),
             7 * n * es + 2 * rows_bh, 10 * d * pairs, "flash_bwd_f32.cuh",
             "fused_bwd_experimental.py:78")):
        want = plain()
        want = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(x, w) for x, w in zip(got, want))
        rel = max(rel_err(x, w) for x, w in zip(got, want))
        del want
        require(rel <= F32_TOL, f"{name} disagrees with its plain version "
                                f"at {shape}: {rel:.3e}")
        ms = time_ms(run, reps=5, trials=5)
        plain_ms = time_ms(plain, reps=2, trials=3)
        torch.cuda.empty_cache()
        bnd, by = bound_ms(nbytes, flops, "float32_split_tf32")
        fma, fma_by = bound_ms(nbytes, flops, "float32")
        times[name] = ms
        rows.append({"name": name, "route": "cuda",
                     "source": f"dist_keras_tpu_torch/csrc/{source}",
                     "replaces": f"dist_keras_tpu/ops/pallas/{replaces}",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd, "bound_by": by,
                     "library_ms": sdpa_bwd, "shape": shape})
        print(f"  {name} [{shape}] on {gpu}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {sdpa_bwd:.4f} ms "
              f"(scaled_dot_product_attention f32 backward, dq, dk, dv "
              f"together; {ms / sdpa_bwd:.2f}x), bound {bnd:.4f} ms ({by}, "
              f"split-TF32 rate) / {fma:.4f} ms ({fma_by}, f32 FMA rate), "
              f"max_abs_err {err:.3e}, relative to the largest entry "
              f"{rel:.3e} (tol {F32_TOL:g})")
    fused_vs_two(times["flash_bwd_fused_f32"], times["flash_bwd_dq_f32"],
                 times["flash_bwd_dkv_f32"], shape, gpu, fused, (dq, dk, dv))
    return rows


def fused_vs_two(k4, k2, k3, shape, gpu, fused, two):
    """Print K4's time against K2 + K3's and require their results to be
    the same bits."""
    same = bit_equal(fused, two)
    print(f"  flash_bwd_fused vs flash_bwd_dq + flash_bwd_dkv [{shape}] on "
          f"{gpu}: {k4:.4f} ms vs {k2:.4f} + {k3:.4f} = {k2 + k3:.4f} ms "
          f"({k4 / (k2 + k3):.3f}x); results bit-equal {same}")
    require(same, f"fused_bwd is not bit-equal to K2+K3 at {shape}")



# -- phase 9: the paper's training loop (SingleTrainer) ---------------------
GATE_ROWS, GATE_TEST_ROWS = 4096, 1024   # test_examples.py's full tier
GATE_EPOCHS, GATE_ACC = 6, 0.90
PARITY_ROWS, PARITY_EPOCHS = 1024, 3
CARD_CPU_TOL = 1e-4   # sgd in f32 (TF32 off), card against CPU, relative
BENCH_BATCH, BENCH_STEPS = 512, 120      # bench_single_mnist_mlp's shape
BENCH_SECONDS, BENCH_RUNS = 10.0, 3
CNN_ROWS = 2048


def kernel_counts(fa, fu, da):
    """The hand-written kernels' launch counters, by module attribute."""
    return {"flash_fwd": fa.flash_fwd_launches,
            "flash_bwd_dq": fa.flash_bwd_dq_launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv_launches,
            "flash_bwd_fused": fu.fused_bwd_launches,
            "paged_decode": da.paged_decode_launches}


def zero_kernel_counts(fa, fu, da):
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = fu.fused_bwd_launches = 0
    da.paged_decode_launches = 0


def write_record(line):
    """``line`` and its newline in a single write to the standard output,
    so no other output of the process (another thread, a C++ warning on
    the shared log) lands inside it, and a SIGKILL cannot cut it.
    ``print`` is not enough: with an unbuffered standard output it writes
    the text and the newline apart, and a thread's record can fall
    between them."""
    sys.stdout.flush()
    os.write(1, f"{line}\n".encode())


def write_kernel_counts(prefix, fa, fu, da):
    """One ``<prefix> {json}`` line, by :func:`write_record`."""
    write_record(f"{prefix} {json.dumps(kernel_counts(fa, fu, da))}")


def mnist_sets(rows=None, test_rows=None):
    """The gate's data, as ``tests/test_examples.py``'s ``_prep_mnist``
    builds it (MinMax to ``fn``, one-hot to ``le``, images to ``fi``):
    ``rows`` / ``test_rows`` (default the full tier's) synthetic rows."""
    from dist_keras_tpu_torch.data import (
        MinMaxTransformer,
        OneHotTransformer,
        ReshapeTransformer,
    )
    from dist_keras_tpu_torch.data.synthetic import synthetic_mnist

    def prep(ds):
        ds = MinMaxTransformer(0.0, 1.0, 0.0, 255.0, input_col="features",
                               output_col="fn").transform(ds)
        ds = OneHotTransformer(10, input_col="label",
                               output_col="le").transform(ds)
        return ReshapeTransformer(input_col="fn", output_col="fi",
                                  shape=(28, 28, 1)).transform(ds)

    return (prep(synthetic_mnist(rows or GATE_ROWS, seed=0)),
            prep(synthetic_mnist(test_rows or GATE_TEST_ROWS, seed=1)))


def train_loop(fa, fu, da, gpu):
    """Phase 9: ``SingleTrainer`` on the MNIST MLP through the gate, the
    card against the CPU, samples/s at ``bench_single_mnist_mlp``'s
    shape with one step's profile, and one bf16 epoch of the CNN."""
    import torch

    from dist_keras_tpu_torch.data import (
        AccuracyEvaluator,
        LabelIndexTransformer,
        ModelPredictor,
    )
    from dist_keras_tpu_torch.models import mnist_cnn, mnist_mlp
    from dist_keras_tpu_torch.trainers import SingleTrainer

    t0 = time.perf_counter()
    train, test = mnist_sets()
    print(f"  data: {GATE_ROWS} + {GATE_TEST_ROWS} synthetic MNIST rows in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    zero_kernel_counts(fa, fu, da)

    # 1. the gate, on the card (test_examples.py's test_single_mnist_mlp)
    t = SingleTrainer(mnist_mlp(), worker_optimizer="adam",
                      optimizer_kwargs={"learning_rate": 1e-3},
                      batch_size=64, num_epoch=GATE_EPOCHS,
                      features_col="fn", label_col="le")
    require(t.device.type == "cuda", f"SingleTrainer runs on {t.device}")
    trained = t.train(train, shuffle=True)
    pred = ModelPredictor(trained, features_col="fn").predict(test)
    pred = LabelIndexTransformer(input_col="prediction").transform(pred)
    acc = AccuracyEvaluator(prediction_col="prediction_index",
                            label_col="label").evaluate(pred)
    hist = np.asarray(t.get_history())
    require(np.isfinite(hist).all(), "the gate run's losses are not finite")
    print(f"  gate single_mnist_mlp (full tier, {len(hist)} steps, adam): "
          f"accuracy {acc:.4f} (threshold {GATE_ACC}), loss {hist[0]:.4f} "
          f"-> {hist[-1]:.4f}, training {t.get_training_time():.3f} s on "
          f"{gpu}")
    require(acc >= GATE_ACC, f"single_mnist_mlp accuracy {acc} < {GATE_ACC}")

    # 2. the card against the CPU: sgd, f32, the same initial weights
    model, runs = mnist_mlp(seed=1), {}
    for dev in ("cuda", "cpu"):
        t = SingleTrainer(model, worker_optimizer="sgd",
                          optimizer_kwargs={"learning_rate": 0.05},
                          batch_size=64, num_epoch=PARITY_EPOCHS,
                          features_col="fn", label_col="le", device=dev)
        m = t.train(train.take(PARITY_ROWS), shuffle=True)
        runs[dev] = np.asarray(t.get_history()), m.get_weights()
    (hc, wc), (hh, wh) = runs["cuda"], runs["cpu"]
    loss_err = float(np.max(np.abs(hc - hh) / np.abs(hh)))
    param_err = max(float(np.abs(a - b).max() / np.abs(b).max())
                    for a, b in zip(wc, wh))
    print(f"  card against CPU ({len(hh)} sgd steps, f32, TF32 off): loss "
          f"history max rel err {loss_err:.3e}, final params max err "
          f"{param_err:.3e} of each leaf's largest entry (held to "
          f"{CARD_CPU_TOL}) on {gpu}")
    require(loss_err <= CARD_CPU_TOL and param_err <= CARD_CPU_TOL,
            "the card's SingleTrainer run disagrees with the CPU's")

    # 3. samples/s at bench_single_mnist_mlp's config
    bench_samples_per_s(gpu)

    # 4. one bf16 epoch of the CNN: Conv2D, MaxPool2D, Flatten and
    # Dropout on cuDNN and the device generator
    t = SingleTrainer(mnist_cnn(), worker_optimizer="adam", batch_size=64,
                      num_epoch=1, features_col="fi", label_col="le",
                      compute_dtype=torch.bfloat16)
    t.train(train.take(CNN_ROWS), shuffle=True)
    h = np.asarray(t.get_history())
    head, tail = float(h[:8].mean()), float(h[-8:].mean())
    print(f"  mnist_cnn, one bf16 epoch ({len(h)} steps of 64): mean loss "
          f"of the first 8 steps {head:.4f}, of the last 8 {tail:.4f} on "
          f"{gpu}")
    require(np.isfinite(h).all() and tail < head,
            "the CNN epoch's loss is not finite and decreasing")
    counts = kernel_counts(fa, fu, da)
    print(f"  hand-written kernels launched by phase 9: {counts} (none is "
          f"on this path)")
    require(not any(counts.values()),
            f"phase 9 launched a hand-written kernel: {counts}")


def bench_samples_per_s(gpu):
    """``bench_single_mnist_mlp``'s shape (batch 512, 120 steps per epoch,
    bf16 compute, adam): a warm-up epoch, then the median of 3 runs of as
    many epochs as fill about 10 s; samples over
    ``get_training_time()``, as ``bench.py`` counts them.  Then one
    step's host wall beside its device time and a profile."""
    import torch

    from dist_keras_tpu_torch.data import Dataset
    from dist_keras_tpu_torch.models import mnist_mlp
    from dist_keras_tpu_torch.trainers import SingleTrainer

    rng = np.random.default_rng(0)
    n = BENCH_BATCH * BENCH_STEPS
    y = rng.integers(0, 10, n)
    ds = Dataset({"features": rng.normal(size=(n, 784)).astype(np.float32),
                  "label": y,
                  "label_encoded": np.eye(10, dtype=np.float32)[y]})

    def run(epochs):
        t = SingleTrainer(mnist_mlp(), worker_optimizer="adam",
                          batch_size=BENCH_BATCH, num_epoch=epochs,
                          label_col="label_encoded",
                          compute_dtype=torch.bfloat16)
        t.train(ds)
        h = np.asarray(t.get_history())
        require(h.size == epochs * BENCH_STEPS and np.isfinite(h).all(),
                "the bench run's losses are not finite")
        return h.size * BENCH_BATCH / t.get_training_time()

    warm = run(1)
    epochs = max(1, int(BENCH_SECONDS * warm / n))
    sps = [run(epochs) for _ in range(BENCH_RUNS)]
    med = float(np.median(sps))
    print(f"  bench_single_mnist_mlp shape (batch {BENCH_BATCH}, "
          f"{BENCH_STEPS} steps/epoch, bf16, adam): {med:.1f} samples/s "
          f"(median of {BENCH_RUNS} runs of {epochs} epochs: "
          f"{', '.join(f'{v:.1f}' for v in sps)}; warm-up epoch "
          f"{warm:.1f}) = {BENCH_BATCH / med * 1e3:.4f} ms per step on {gpu}")
    profile_mlp_step(ds, gpu)


def profile_mlp_step(ds, gpu):
    """One SingleTrainer step at the bench shape, as the trainer builds
    it: host wall per step over a chained run, and that wall split into
    the loss and gradients and the optimizer's update; device time per
    step from CUDA events over 4 back-to-back steps (more would fill the
    card's launch queue while the sleep kernel holds it, and the events
    would then time the host); the step under ``set_sync_debug_mode
    ("error")``, so a host sync inside it fails the run; the device
    operations per step and the host time by op (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dist_keras_tpu_torch.models import mnist_mlp
    from dist_keras_tpu_torch.ops.losses import get_loss
    from dist_keras_tpu_torch.ops.optimizers import apply_updates, get_optimizer
    from dist_keras_tpu_torch.trainers import step as st

    dev = torch.device("cuda")
    model, loss_fn, tx = (mnist_mlp(), get_loss("categorical_crossentropy"),
                          get_optimizer("adam"))
    step, opt_init = st.make_model_step(model, loss_fn, tx, torch.bfloat16)
    params = [{k: v.detach().to(dev) for k, v in p.items()}
              for p in model.params]
    opt_state = opt_init(params)
    carry = (params, opt_state, torch.Generator(device=dev).manual_seed(0))
    batch = (torch.from_numpy(ds["features"][:BENCH_BATCH]).to(dev),
             torch.from_numpy(ds["label_encoded"][:BENCH_BATCH]).to(dev))
    loss_of = st.make_loss_fn(model.apply, loss_fn, torch.bfloat16)
    _, grads = st._value_and_grad(loss_of, params, *batch, carry[2])

    def chain(k):
        c, losses = carry, torch.empty(k, device=dev)
        for j in range(k):
            c, loss = step(c, batch)
            losses[j] = loss   # as the trainer's dispatch loop writes it
        return losses

    def host_ms(fn, k=200):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(k):
                fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / k * 1e3)
        return float(np.median(walls))

    wall_ms = host_ms(lambda: chain(1))
    grad_ms = host_ms(lambda: st._value_and_grad(loss_of, params, *batch,
                                                 carry[2]))
    opt_ms = host_ms(lambda: apply_updates(
        params, tx.update(grads, opt_state, params)[0]))
    device_ms = time_ms(lambda: step(carry, batch), reps=4, trials=7,
                        sleep_ms=100)
    torch.cuda.set_sync_debug_mode("error")
    try:
        chain(5)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    k = 20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chain(k)
        torch.cuda.synchronize()
    events = prof.key_averages()
    ops = [e for e in events if e.device_type == DeviceType.CUDA]
    n_ops = sum(e.count for e in ops)
    busy_us = sum(e.self_device_time_total for e in ops)
    require(n_ops > 0 and busy_us > 0,
            "the profiler saw no device work in the MLP step")
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    print(f"  MLP step (batch {BENCH_BATCH}, bf16, adam) on {gpu}: wall "
          f"{wall_ms:.4f} ms (loss and gradients {grad_ms:.4f} ms, adam's "
          f"update {opt_ms:.4f} ms), device {device_ms:.4f} ms (CUDA "
          f"events), card idle {max(0.0, 1 - device_ms / wall_ms):.0%} of "
          f"the step; no host sync in 5 steps (sync debug mode 'error'); "
          f"{n_ops / k:.1f} device operations and "
          f"{busy_us / k / 1e3:.4f} ms of kernels per step (torch.profiler)")
    print("  host time by op under the profiler, per step: " + "; ".join(
        f"{e.key} x{e.count / k:g} {e.self_cpu_time_total / k:.1f} us"
        for e in host))


# -- phase 10: the windowed trainers (W workers stacked on one card) --------
CIFAR_ROWS, CIFAR_TEST_ROWS = 2048, 512          # test_examples.py full tier
HIGGS_ROWS, HIGGS_TEST_ROWS = 8192, 2048
GATE_AUC = 0.85
ADAG_WORKERS, ADAG_WINDOW = 4, 12
PARITY_WINDOWS = 3
STACK_TOL = 1e-4      # the stacked step against W single steps, relative
ADAG_BENCH_BATCH, ADAG_BENCH_STEPS = 2048, 48   # bench_adag_mnist_cnn
ADAG_BENCH_SECONDS = 8.0


def mnist_cnn_flops_per_sample(model):
    """Training FLOPs per sample of a Sequential of Conv2D / MaxPool2D /
    Flatten / Dense / Dropout, from its shapes: 2 per multiply-add of the
    forward's convs and dense products, times 3 for forward + backward."""
    import torch

    from dist_keras_tpu_torch.models.layers import Conv2D, Dense

    shape, macs = tuple(model.input_shape), 0
    for layer, p in zip(model.layers, model.params):
        _, out = layer.init(torch.Generator(), shape)
        if isinstance(layer, Conv2D):
            kh, kw, cin, cout = p["kernel"].shape
            macs += int(np.prod(out)) * kh * kw * cin
        elif isinstance(layer, Dense):
            macs += int(np.prod(p["kernel"].shape))
        shape = out
    return 6 * macs


def tree_err(got, want):
    """-> (max abs error over all leaves over the largest entry of
    ``want``, the largest per-leaf error over that leaf's largest
    entry), the trees' leaves moved to the CPU.  The first is the model
    scale a trainer's check is held to: a zero-initialised bias is, for
    its first steps, only the sum of its updates, so its own relative
    error is its f32 gradient's (~1e-3 for a conv layer, printed in
    phase 10), not the port's."""
    from dist_keras_tpu_torch.utils.pytree import tree_leaves

    pairs = [(a.detach().cpu().double(), b.detach().cpu().double())
             for a, b in zip(tree_leaves(got), tree_leaves(want))]
    top = max(float(b.abs().max()) for _, b in pairs)
    return (max(float((a - b).abs().max()) for a, b in pairs) / top,
            max(float((a - b).abs().max() / b.abs().max()) for a, b in pairs))


def no_dropout_cnn(seed):
    """``mnist_cnn`` with its dropout rate set to 0: a device generator
    draws other masks on the card than on the CPU, so the parity runs
    leave dropout out."""
    from dist_keras_tpu_torch.models import mnist_cnn
    from dist_keras_tpu_torch.models.layers import Dropout

    m = mnist_cnn(seed=seed)
    for layer in m.layers:
        if isinstance(layer, Dropout):
            layer.rate = 0.0
    return m


def accuracy(model, test, col, device=None):
    from dist_keras_tpu_torch.data import (
        AccuracyEvaluator,
        LabelIndexTransformer,
        ModelPredictor,
    )

    pred = ModelPredictor(model, features_col=col,
                          device=device).predict(test)
    pred = LabelIndexTransformer(input_col="prediction").transform(pred)
    return AccuracyEvaluator(prediction_col="prediction_index",
                             label_col="label").evaluate(pred)


def windowed_gates(train, test, gpu):
    """The windowed gates of ``tests/test_examples.py`` at its full tier,
    on the card: ADAG and DOWNPOUR on the MNIST CNN, AEASGD and EAMSGD
    on the Higgs classifier, DynSGD on the CIFAR-10 convnet against its
    SingleTrainer control."""
    from dist_keras_tpu_torch.data import (
        AUCEvaluator,
        MinMaxTransformer,
        ModelPredictor,
        OneHotTransformer,
        ReshapeTransformer,
        StandardScaleTransformer,
    )
    from dist_keras_tpu_torch.data.synthetic import (
        synthetic_cifar10,
        synthetic_higgs,
    )
    from dist_keras_tpu_torch.models import (
        cifar10_convnet,
        higgs_mlp,
        mnist_cnn,
    )
    from dist_keras_tpu_torch.trainers import (
        ADAG,
        AEASGD,
        DOWNPOUR,
        EAMSGD,
        DynSGD,
        SingleTrainer,
    )

    def report(name, metric, value, threshold, t, detail=""):
        hist = np.asarray(t.get_history())
        require(np.isfinite(hist).all(), f"{name}: non-finite losses")
        print(f"  gate {name} (full tier): {metric} {value:.4f} (threshold "
              f"{threshold:.4f}), history {hist.shape}, training "
              f"{t.get_training_time():.3f} s{detail} on {gpu}")
        require(value >= threshold, f"{name} {metric} {value} < {threshold}")

    t = ADAG(mnist_cnn(), num_workers=ADAG_WORKERS,
             communication_window=ADAG_WINDOW, worker_optimizer="adam",
             optimizer_kwargs={"learning_rate": 3e-3}, batch_size=64,
             num_epoch=GATE_EPOCHS, features_col="fi", label_col="le")
    require(t.device.type == "cuda", f"ADAG runs on {t.device}")
    adag = t.train(train, shuffle=True)
    report("adag_mnist_cnn_w12", "accuracy", accuracy(adag, test, "fi"),
           GATE_ACC, t)

    spe = GATE_ROWS // (8 * 32)
    t = DOWNPOUR(mnist_cnn(), num_workers=8, communication_window=2,
                 worker_optimizer="sgd",
                 optimizer_kwargs={"learning_rate": 0.01,
                                   "warmup_steps": 4 * spe},
                 batch_size=32, num_epoch=20, features_col="fi",
                 label_col="le")
    trained = t.train(train, shuffle=True)
    report("downpour_mnist_cnn_8w", "accuracy",
           accuracy(trained, test, "fi"), GATE_ACC, t)

    def higgs(n, seed):
        ds = synthetic_higgs(n, seed=seed)
        ds = StandardScaleTransformer(input_col="features",
                                      output_col="fs").transform(ds)
        return OneHotTransformer(2, input_col="label",
                                 output_col="le").transform(ds)

    htrain, htest = higgs(HIGGS_ROWS, 0), higgs(HIGGS_TEST_ROWS, 1)
    for cls, extra in ((AEASGD, {}), (EAMSGD, {"momentum": 0.9})):
        t = cls(higgs_mlp(), num_workers=4, communication_window=16,
                rho=1.0, learning_rate=0.2, worker_optimizer="adam",
                optimizer_kwargs={"learning_rate": 1e-3}, batch_size=64,
                num_epoch=10, features_col="fs", label_col="le", **extra)
        trained = t.train(htrain, shuffle=True)
        pred = ModelPredictor(trained, features_col="fs").predict(htest)
        auc = AUCEvaluator(score_col="prediction",
                           label_col="label").evaluate(pred)
        report(f"{cls.__name__.lower()}_higgs", "auc", auc, GATE_AUC, t)

    def cifar(n, seed):
        ds = synthetic_cifar10(n, seed=seed)
        ds = MinMaxTransformer(0.0, 1.0, 0.0, 255.0, input_col="features",
                               output_col="fn").transform(ds)
        ds = OneHotTransformer(10, input_col="label",
                               output_col="le").transform(ds)
        return ReshapeTransformer(input_col="fn", output_col="fi",
                                  shape=(32, 32, 3)).transform(ds)

    ctrain, ctest = cifar(CIFAR_ROWS, 0), cifar(CIFAR_TEST_ROWS, 1)
    workers, epochs = 8, 16
    e_control = max(1, epochs // (workers + 1))
    common = dict(worker_optimizer="adam", batch_size=32,
                  features_col="fi", label_col="le")
    control = SingleTrainer(cifar10_convnet(),
                            optimizer_kwargs={"learning_rate": 1e-3},
                            num_epoch=e_control, **common)
    acc_control = accuracy(control.train(ctrain, shuffle=True), ctest, "fi")
    t = DynSGD(cifar10_convnet(), num_workers=workers,
               communication_window=5,
               optimizer_kwargs={"learning_rate": 2e-3}, num_epoch=epochs,
               **common)
    acc = accuracy(t.train(ctrain, shuffle=True), ctest, "fi")
    detail = (f", staleness-normalized control {acc_control:.4f} ({epochs} "
              f"vs {e_control} epochs)")
    report("dynsgd_cifar10_vs_control", "accuracy", acc, acc_control - 0.02,
           t, detail)
    report("dynsgd_cifar10_above_chance", "accuracy", acc, 2.5 * 0.10, t)
    return adag


def adag_card_against_cpu(train, gpu, card_device="cuda"):
    """ADAG on the MNIST CNN (dropout 0), sgd in f32, TF32 off, card
    against CPU from the same weights for PARITY_WINDOWS windows.

    Held to CARD_CPU_TOL, step by step with f64 compute
    (``compute_dtype``; the weights, the updates and the loss stay f32):
    each step of the trainer's stacked step, and each window's ADAG
    merge, runs on both devices from the CPU's state; the step's losses
    (relative), the workers' params after it and the center after each
    merge (at the model's scale, ``tree_err``) are compared.  Printed,
    not held: the same with f32 compute, whose conv gradients carry
    their own ~1e-3 error (below); the two devices' free-running
    ``ADAG.train`` runs, beside
    the CPU's own run from weights nudged by one f32 ulp — this CNN's
    trajectory amplifies a one-ulp change a thousandfold within a window
    (relu at exactly 0 on the blank background, zero-initialised biases),
    so two f32 implementations part at that floor whatever their
    algebra; and the first step's stacked gradient against f64 on the
    CPU (a conv kernel's gradient sums ~50,000 products that cancel to a
    few thousandths of their size, so each f32 conv implementation lands
    ~1e-3 from the exact value)."""
    import torch
    from torch.func import grad_and_value, vmap

    from dist_keras_tpu_torch.trainers import ADAG
    from dist_keras_tpu_torch.trainers import step as st
    from dist_keras_tpu_torch.utils.pytree import (
        tree_leaves,
        tree_map,
        tree_merge_floats,
        tree_stack,
    )

    model = no_dropout_cnn(seed=1)
    data = train.take(ADAG_WORKERS * ADAG_WINDOW * 64).shuffle(seed=0)

    def trainer(dev, m=model, epochs=PARITY_WINDOWS):
        return ADAG(m, num_workers=ADAG_WORKERS,
                    communication_window=ADAG_WINDOW, worker_optimizer="sgd",
                    optimizer_kwargs={"learning_rate": 0.05}, batch_size=64,
                    num_epoch=epochs, features_col="fi", label_col="le",
                    device=dev)

    # 1. step by step from the CPU's state: f64 compute held, f32 printed
    dev = torch.device(card_device)

    def card(tree):
        return tree_map(lambda x: x.to(dev), tree)

    def forced(compute):
        trs = {"card": trainer(dev), "cpu": trainer("cpu")}
        steps = {}
        for name, t in trs.items():
            t.compute_dtype = compute
            m, loss_fn, tx = t._resolve()
            steps[name] = t._make_worker_step(m, loss_fn, tx)
        center = trs["cpu"]._device_params(model.params)
        local = tree_stack(center, ADAG_WORKERS)
        opt = tree_stack(steps["cpu"][1](center), ADAG_WORKERS)
        gens = {"cpu": torch.Generator(),
                "card": torch.Generator(device=dev)}
        loss_err = local_err = center_err = 0.0
        for _ in range(PARITY_WINDOWS):
            for j in range(ADAG_WINDOW):
                batch = (torch.from_numpy(xs[:, j]),
                         torch.from_numpy(ys[:, j]))
                (new_local, new_opt, _), loss = steps["cpu"][0](
                    (local, opt, gens["cpu"]), batch)
                (local_c, _, _), loss_c = steps["card"][0](
                    (card(local), card(opt), gens["card"]), card(batch))
                loss_err = max(loss_err, float(
                    ((loss_c.cpu() - loss).abs() / loss.abs()).max()))
                local_err = max(local_err, tree_err(local_c, new_local)[0])
                local, opt = new_local, new_opt
            new_center, new_local = trs["cpu"].merge(center, local)
            new_center_c, _ = trs["card"].merge(card(center), card(local))
            center_err = max(center_err,
                             tree_err(new_center_c, new_center)[0])
            center = tree_merge_floats(new_center, center)
            local = tree_merge_floats(new_local, local)
        return loss_err, local_err, center_err

    xs, ys = trainer("cpu")._shards(data)
    held, f32 = forced(torch.float64), forced(None)

    # 2. free-running, and the CPU against itself from a one-ulp nudge
    def free(d, m=model):
        t = trainer(d, m)
        out = t.train(data)
        return np.asarray(t.get_history()), out.get_weights()

    def apart(a, b):
        (ha, wa), (hb, wb) = a, b
        return (float(np.max(np.abs(ha - hb) / np.abs(hb))),
                max(float(np.abs(x - y).max() / np.abs(y).max())
                    for x, y in zip(wa, wb)))

    runs = {"card": free(dev), "cpu": free("cpu")}
    nudged = no_dropout_cnn(seed=1)
    nudged.set_weights([np.nextafter(w, np.float32(np.inf))
                        for w in model.get_weights()])
    card_cpu, floor = (apart(runs["card"], runs["cpu"]),
                       apart(free("cpu", nudged), runs["cpu"]))

    # 3. the first step's stacked gradient against f64
    loss_of = st.make_loss_fn(model.apply, trainer("cpu")._resolve()[1])

    def grads(d, dtype):
        p = tree_stack([{k: v.detach().to(d, dtype) for k, v in q.items()}
                        for q in model.params], ADAG_WORKERS)
        g, _ = vmap(grad_and_value(loss_of))(
            p, torch.from_numpy(xs[:, 0]).to(d, dtype),
            torch.from_numpy(ys[:, 0]).to(d, dtype))
        return [x.double().cpu() for x in tree_leaves(g)]

    exact = grads("cpu", torch.float64)

    def off(d):
        return max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(grads(d, torch.float32), exact))

    print(f"  ADAG card against CPU (mnist_cnn without dropout, "
          f"{ADAG_WORKERS} workers, {PARITY_WINDOWS} windows of "
          f"{ADAG_WINDOW}, sgd on f32 weights, TF32 off) on {gpu}: step by "
          f"step from the CPU's state, with f64 compute: losses max rel err "
          f"{held[0]:.3e}, workers' params after each step max err "
          f"{held[1]:.3e} and center after each merge {held[2]:.3e} of "
          f"their largest entry (held to {CARD_CPU_TOL}); with f32 compute: "
          f"{f32[0]:.3e}, {f32[1]:.3e} and {f32[2]:.3e} (not held)")
    print(f"    free-running ADAG.train: loss history max rel err "
          f"{card_cpu[0]:.3e}, final center max err {card_cpu[1]:.3e} of "
          f"each leaf's largest entry; the CPU against itself from weights "
          f"one f32 ulp up: {floor[0]:.3e} and {floor[1]:.3e} (not held); "
          f"first step's stacked gradient against f64 on the CPU, max err "
          f"of each leaf's largest entry: card f32 (cuDNN) "
          f"{off(dev):.3e}, CPU f32 {off('cpu'):.3e}")
    require(max(held) <= CARD_CPU_TOL,
            "the card's ADAG steps and merges disagree with the CPU's")


def stacked_against_single(train, dev, gpu):
    """``make_worker_step`` on 4 stacked workers against 4 separate
    ``make_model_step`` steps on ``dev``: the MNIST CNN (dropout 0), sgd
    on f32 weights, three steps; losses and params (at the model's
    scale, ``tree_err``) held to STACK_TOL with f64 compute, printed with
    f32 compute (the grouped and the single conv's gradients each carry
    their own f32 error, ~1e-3 of the gradient)."""
    import torch

    from dist_keras_tpu_torch.ops.losses import get_loss
    from dist_keras_tpu_torch.ops.optimizers import get_optimizer
    from dist_keras_tpu_torch.trainers import step as st
    from dist_keras_tpu_torch.utils.pytree import tree_index, tree_stack

    model = no_dropout_cnn(seed=2)
    loss_fn = get_loss("categorical_crossentropy")
    tx = get_optimizer("sgd", learning_rate=0.05)
    xs, ys = train.worker_shards(ADAG_WORKERS, 64, "fi", "le")
    xs, ys = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
    params = [{k: v.detach().to(dev) for k, v in p.items()}
              for p in model.params]
    n = ADAG_WORKERS

    def compare(compute):
        wstep, wopt = st.make_worker_step(model, loss_fn, tx, compute)
        sstep, sopt = st.make_model_step(model, loss_fn, tx, compute)
        g = torch.Generator(device=dev).manual_seed(0)
        carry = (tree_stack(params, n), tree_stack(wopt(params), n), g)
        singles = [(params, sopt(params), g) for _ in range(n)]
        loss_err = 0.0
        for t in range(3):
            carry, loss = wstep(carry, (xs[:, t], ys[:, t]))
            for i in range(n):
                singles[i], li = sstep(singles[i], (xs[i, t], ys[i, t]))
                loss_err = max(loss_err, float(abs(loss[i] - li) / abs(li)))
        errs = [tree_err(tree_index(carry[0], i), singles[i][0])
                for i in range(n)]
        return (loss_err, max(e[0] for e in errs), max(e[1] for e in errs))

    held, f32 = compare(torch.float64), compare(None)
    print(f"  stacked step ({n} workers, mnist_cnn without dropout, sgd on "
          f"f32 weights) against {n} single steps, 3 steps, on {gpu}: f64 "
          f"compute: loss max rel err {held[0]:.3e}, params max err "
          f"{held[1]:.3e} of their largest entry (held to {STACK_TOL}); f32 "
          f"compute: {f32[0]:.3e} and {f32[1]:.3e} ({f32[2]:.3e} of each "
          f"leaf's largest entry; not held)")
    require(held[0] <= STACK_TOL and held[1] <= STACK_TOL,
            "the stacked step disagrees with the single steps")


def no_sync_in_dispatch(train, gpu):
    """ADAG and DynSGD train with every dispatch (the windows' steps and
    merges, DynSGD's staggered commits) under ``set_sync_debug_mode
    ("error")``: a host sync inside fails the run.  The chunk boundary's
    drain and loss fetch stay outside, as they should."""
    import torch

    from dist_keras_tpu_torch.trainers import ADAG, DynSGD
    from dist_keras_tpu_torch.trainers import dynsgd as dmod
    from dist_keras_tpu_torch.trainers import windowed as wmod

    def guarded(run):
        def run_chunked(tr, xs, ys, *, dispatch, **kw):
            def strict(*args):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    return dispatch(*args)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            return run(tr, xs, ys, dispatch=strict, **kw)
        return run_chunked

    rows = ADAG_WORKERS * ADAG_WINDOW * 64
    saved = wmod.run_chunked, dmod.run_chunked
    wmod.run_chunked, dmod.run_chunked = map(guarded, saved)
    try:
        for cls, kw in ((ADAG, {}), (DynSGD, {"communication_window": 5})):
            t = cls(no_dropout_cnn(seed=3), num_workers=ADAG_WORKERS,
                    worker_optimizer="adam", batch_size=64, num_epoch=2,
                    features_col="fi", label_col="le",
                    compute_dtype=torch.bfloat16, **kw)
            t.train(train.take(rows))
            require(np.isfinite(np.asarray(t.get_history())).all(),
                    f"{cls.__name__}'s losses are not finite")
    finally:
        wmod.run_chunked, dmod.run_chunked = saved
    print(f"  no host sync in ADAG's 2 windows of {ADAG_WINDOW} steps and "
          f"merges or in DynSGD's {2 * ADAG_WINDOW} steps and staggered "
          f"commits (sync debug mode 'error', bf16, adam) on {gpu}")


def bench_adag(gpu):
    """``bench_adag_mnist_cnn``'s shape (batch 2048, 48 steps per epoch
    over 4 workers: window 12 once per epoch, bf16 compute, adam): a
    warm-up run, then the median of 3 runs of as many epochs as fill
    about ADAG_BENCH_SECONDS; samples over ``get_training_time()``, as
    ``bench.py`` counts them (one card).  Then one global step (4
    workers x 2048) profiled."""
    import torch

    from dist_keras_tpu_torch.data import Dataset
    from dist_keras_tpu_torch.models import mnist_cnn
    from dist_keras_tpu_torch.trainers import ADAG

    rng = np.random.default_rng(0)
    n = ADAG_BENCH_BATCH * ADAG_BENCH_STEPS
    y = rng.integers(0, 10, n)
    ds = Dataset({"features": rng.normal(size=(n, 28, 28, 1)).astype(
        np.float32), "label": y,
        "label_encoded": np.eye(10, dtype=np.float32)[y]})

    def run(epochs):
        t = ADAG(mnist_cnn(), num_workers=ADAG_WORKERS,
                 communication_window=ADAG_WINDOW, worker_optimizer="adam",
                 batch_size=ADAG_BENCH_BATCH, num_epoch=epochs,
                 label_col="label_encoded", compute_dtype=torch.bfloat16)
        t.train(ds)
        h = np.asarray(t.get_history())
        require(h.shape == (ADAG_WORKERS, epochs, 1, ADAG_WINDOW)
                and np.isfinite(h).all(),
                f"the bench run's history {h.shape} is not finite")
        return h.size * ADAG_BENCH_BATCH / t.get_training_time()

    warm = run(2)
    epochs = max(2, int(ADAG_BENCH_SECONDS * warm / n))
    sps = [run(epochs) for _ in range(BENCH_RUNS)]
    med = float(np.median(sps))
    fps = mnist_cnn_flops_per_sample(mnist_cnn())
    step_samples = ADAG_WORKERS * ADAG_BENCH_BATCH
    bound, by = bound_ms(0, fps * step_samples, "bfloat16")
    print(f"  bench_adag_mnist_cnn shape (batch {ADAG_BENCH_BATCH}, "
          f"{ADAG_WORKERS} workers, window {ADAG_WINDOW}, bf16, adam): "
          f"{med:.1f} samples/s (median of {BENCH_RUNS} runs of {epochs} "
          f"epochs: {', '.join(f'{v:.1f}' for v in sps)}; warm-up "
          f"{warm:.1f}) = {step_samples / med * 1e3:.4f} ms per global step "
          f"of {step_samples} samples on {gpu}")
    print(f"  mnist_cnn: {mnist_cnn().count_params} parameters, "
          f"{fps / 1e6:.2f} MFLOP per trained sample, "
          f"{fps * step_samples / 1e12:.4f} TFLOP per global step; bound "
          f"{bound:.4f} ms per global step ({by}, bf16 dense peak)")
    profile_worker_step(ds, gpu)


def profile_worker_step(ds, gpu):
    """One ADAG global step at the bench shape, as the trainer builds it
    (``make_worker_step`` on 4 stacked workers, bf16, adam): host wall
    per step over a chained run; device time from CUDA events over 2
    back-to-back steps; the device operations, kernel time and the top
    kernels per step over one window and its merge (torch.profiler).
    Then, as a yardstick, one model's plain step over all the global
    step's rows (``make_model_step``, batch 4 x 2048)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dist_keras_tpu_torch.models import mnist_cnn
    from dist_keras_tpu_torch.ops.losses import get_loss
    from dist_keras_tpu_torch.ops.optimizers import get_optimizer
    from dist_keras_tpu_torch.trainers import step as st
    from dist_keras_tpu_torch.trainers.windowed import ADAG
    from dist_keras_tpu_torch.utils.pytree import (
        tree_merge_floats,
        tree_stack,
    )

    dev = torch.device("cuda")
    model = mnist_cnn()
    step, opt_init = st.make_worker_step(
        model, get_loss("categorical_crossentropy"), get_optimizer("adam"),
        torch.bfloat16)
    center = [{k: v.detach().to(dev) for k, v in p.items()}
              for p in model.params]
    n, b = ADAG_WORKERS, ADAG_BENCH_BATCH
    carry = (tree_stack(center, n), tree_stack(opt_init(center), n),
             torch.Generator(device=dev).manual_seed(0))
    x = torch.from_numpy(ds["features"][:n * b]).to(dev).reshape(
        n, b, 28, 28, 1)
    y = torch.from_numpy(ds["label_encoded"][:n * b]).to(dev).reshape(
        n, b, 10)
    merger = ADAG(model, num_workers=n, communication_window=ADAG_WINDOW)

    def window():
        c, losses = carry, []
        for _ in range(ADAG_WINDOW):
            c, loss = step(c, (x, y))
            losses.append(loss)
        new_center, new_local = merger.merge(center, c[0])
        return (tree_merge_floats(new_center, center),
                tree_merge_floats(new_local, c[0]), torch.stack(losses, 1))

    def host_ms(fn, k=24):
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(k):
                fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) / k * 1e3)
        return float(np.median(walls))

    def kernels(fn, k):
        """-> (device operations, ms of kernels, top kernels) per call of
        ``fn`` over ``k`` calls, from the profiler."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        n_ops = sum(e.count for e in ops) / k
        busy = sum(e.self_device_time_total for e in ops) / k / 1e3
        require(n_ops > 0 and busy > 0, "the profiler saw no device work")
        top = sorted(ops, key=lambda e: -e.self_device_time_total)[:10]
        return n_ops, busy, [(e.key, e.count / k,
                              e.self_device_time_total / k) for e in top]

    wall_ms = host_ms(lambda: step(carry, (x, y)))
    window_ms = host_ms(window, k=2) / ADAG_WINDOW
    # two steps (~600 launches) fit the launch queue behind the sleep
    device_ms = time_ms(lambda: step(carry, (x, y)), reps=2, trials=7,
                        sleep_ms=100)
    n_ops, busy_ms, top = kernels(window, ADAG_WINDOW)
    print(f"  ADAG global step ({n} workers x {b}, mnist_cnn, bf16, adam) "
          f"on {gpu}: wall {wall_ms:.4f} ms ({window_ms:.4f} ms per step "
          f"over a window and its merge), device {device_ms:.4f} ms (CUDA "
          f"events), card idle {max(0.0, 1 - device_ms / wall_ms):.0%} of "
          f"the step; {n_ops:.1f} device operations and {busy_ms:.4f} ms of "
          f"kernels per step over one window (torch.profiler)")
    print("  top kernels per step: " + "; ".join(
        f"{key[:72]} x{count:g} {us:.1f} us" for key, count, us in top))
    # the same work as one model's step over all n x b rows: what the
    # stacked lowering costs beyond the plain eager step
    one, one_opt = st.make_model_step(
        model, get_loss("categorical_crossentropy"), get_optimizer("adam"),
        torch.bfloat16)
    one_carry = (center, one_opt(center), carry[2])
    xb, yb = x.reshape(n * b, 28, 28, 1), y.reshape(n * b, 10)
    one_device = time_ms(lambda: one(one_carry, (xb, yb)), reps=2,
                         trials=7, sleep_ms=100)
    one_ops, one_busy, _ = kernels(lambda: one(one_carry, (xb, yb)), 1)
    print(f"  one model's step over the same {n * b} rows (make_model_step, "
          f"bf16, adam) on {gpu}: device {one_device:.4f} ms (CUDA events), "
          f"{one_ops:.1f} device operations and {one_busy:.4f} ms of "
          f"kernels (torch.profiler)")


def train_windowed(fa, fu, da, gpu):
    """Phase 10: the windowed trainers on W workers stacked on the card —
    the windowed gates, ADAG card against CPU, the stacked step against
    single steps, no host sync in a dispatch, and samples/s with one
    global step's profile at ``bench_adag_mnist_cnn``'s shape.  -> the
    ADAG gate's trained model and the gate's held-out rows (phase 11
    serves them)."""
    import torch

    t0 = time.perf_counter()
    train, test = mnist_sets()
    print(f"  data: {GATE_ROWS} + {GATE_TEST_ROWS} synthetic MNIST rows in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    zero_kernel_counts(fa, fu, da)
    # deterministic cuDNN algorithms: a gate's value is then the same in
    # every run on one machine (the default ones add in varying orders)
    torch.backends.cudnn.deterministic = True
    try:
        adag = windowed_gates(train, test, gpu)
    finally:
        torch.backends.cudnn.deterministic = False
    adag_card_against_cpu(train, gpu)
    stacked_against_single(train, torch.device("cuda"), gpu)
    no_sync_in_dispatch(train, gpu)
    bench_adag(gpu)
    counts = kernel_counts(fa, fu, da)
    print(f"  hand-written kernels launched by phase 10: {counts} (none is "
          f"on this path)")
    require(not any(counts.values()),
            f"phase 10 launched a hand-written kernel: {counts}")
    print(f"  phase 10 wall {time.perf_counter() - t0:.1f} s")
    return adag, test


# -- phase 11: the rest of serving on the card ------------------------------
SERVE_LADDER = (1, 8, 32, 128)
SERVE_CLIENTS, SERVE_MAX_ROWS = 8, 64
SERVE_TOL = 1e-5      # relative to each row's largest logit (f32, TF32 off)
KILL_AFTER = 8        # tokens request 0 streams before replica 0 is killed
SHED_WATERMARK = 0.01


def post_json(addr, path, body, headers=None):
    """-> (status, headers, doc) of one POST, typed errors included."""
    host, port = addr
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def ragged_requests(n, rng):
    """[start, stop) row ranges of 1..SERVE_MAX_ROWS rows covering n."""
    out, i = [], 0
    while i < n:
        k = int(rng.integers(1, SERVE_MAX_ROWS + 1))
        out.append((i, min(n, i + k)))
        i += k
    return out


def post_rows(addr, x, spans, clients=SERVE_CLIENTS, swap=None):
    """Post the row ranges ``spans`` of ``x`` from ``clients`` threads;
    ``swap()`` runs once half of them are answered.  -> (per-range
    (status, predictions), per-request seconds, wall seconds)."""
    results = [None] * len(spans)
    lat = [None] * len(spans)
    done = [0]
    lock = threading.Lock()

    def client(c):
        for j in range(c, len(spans), clients):
            a, b = spans[j]
            t0 = time.perf_counter()
            status, _, doc = post_json(addr, "/predict",
                                       {"rows": x[a:b].tolist()})
            lat[j] = time.perf_counter() - t0
            results[j] = (status, doc.get("predictions"))
            with lock:
                done[0] += 1
                fire = swap is not None and done[0] == len(spans) // 2
            if fire:
                swap()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    return results, lat, time.perf_counter() - t0


def logits_err(got, want):
    """Largest error relative to each row's largest logit."""
    return float((np.abs(got - want).max(1)
                  / np.abs(want).max(1)).max())


def payload_host_cost(x, spans, gpu):
    """The host's share of one /predict round: the same requests' rows
    as JSON text and back into arrays, on one thread of this machine's
    CPU (what the clients and handlers above do under one GIL)."""
    t0 = time.perf_counter()
    bodies = [json.dumps({"rows": x[a:b].tolist()}) for a, b in spans]
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    docs = [json.loads(b) for b in bodies]
    t_dec = time.perf_counter() - t0
    t0 = time.perf_counter()
    for doc in docs:
        [np.asarray(r, dtype=np.float32) for r in doc["rows"]]
    t_arr = time.perf_counter() - t0
    total = t_enc + t_dec + t_arr
    print(f"  the payload on the host CPU, one thread: {x.size} floats as "
          f"{sum(map(len, bodies)) / 1e6:.1f} MB of JSON; json.dumps "
          f"{t_enc:.3f} s, json.loads {t_dec:.3f} s, rows to arrays "
          f"{t_arr:.3f} s: {total:.3f} s, {total / len(x) * 1e3:.3f} ms "
          f"per row (host of {gpu})")


def serve_predict(model, test, fa, fu, da, gpu, device=None):
    """11a: ``/predict`` on the trained MNIST CNN behind ``ServingServer``
    with two replicas sharing the card: ragged requests from 8 clients,
    every reply 200 and equal to ``ModelPredictor`` on the same card, a
    typed 503 on overload, a hot swap mid-traffic, drain then 503."""
    from dist_keras_tpu_torch.data import (
        AccuracyEvaluator,
        LabelIndexTransformer,
        ModelPredictor,
    )
    from dist_keras_tpu_torch.models import mnist_cnn
    from dist_keras_tpu_torch.serving import ServingEngine, ServingServer

    t_phase = time.perf_counter()
    n_params = sum(int(np.prod(w.shape)) for w in model.get_weights())
    x = np.asarray(test["fi"], np.float32)
    labels = np.asarray(test["label"])
    predictor = ModelPredictor(model, features_col="fi", device=device)
    ref = np.asarray(predictor.predict(test)["prediction"])
    acc_ref = AccuracyEvaluator(
        prediction_col="prediction_index", label_col="label").evaluate(
        LabelIndexTransformer(input_col="prediction").transform(
            predictor.predict(test)))
    spans = ragged_requests(len(x), np.random.default_rng(11))
    zero_kernel_counts(fa, fu, da)
    engine = ServingEngine(model, replicas=2, batch_ladder=SERVE_LADDER,
                           device=device)
    server = ServingServer(engine, port=0, request_timeout_s=600)
    addr = server.start()
    try:
        post_rows(addr, x, spans[:8])                  # warm-up
        results, lat, wall = post_rows(addr, x, spans)
        require(all(r is not None and r[0] == 200 for r in results),
                f"/predict replies: {[r and r[0] for r in results]}")
        got = np.concatenate([np.asarray(r[1], np.float32)
                              for r in results])
        err = logits_err(got, ref)
        acc = float((got.argmax(1) == labels).mean())
        st = engine.stats()
        print(f"  mnist_cnn ({n_params} f32 params, examples/mnist.py "
              f"widths), {st['replicas']} replicas on "
              f"{sorted(set(st['devices']))}, ladder {SERVE_LADDER}")
        print(f"  {len(x)} rows in {len(spans)} requests of 1-"
              f"{SERVE_MAX_ROWS} rows from {SERVE_CLIENTS} clients: "
              f"{len(x) / wall:.1f} rows/s, request p50 "
              f"{np.percentile(lat, 50) * 1e3:.2f} ms p99 "
              f"{np.percentile(lat, 99) * 1e3:.2f} ms (wall {wall:.3f} s) "
              f"on {gpu}")
        print(f"  served against ModelPredictor on the card: max err "
              f"{err:.3e} of each row's largest logit (held to "
              f"{SERVE_TOL:g}), argmax equal "
              f"{bool((got.argmax(1) == ref.argmax(1)).all())}, accuracy "
              f"{acc:.4f} vs {acc_ref:.4f}")
        print(f"  batches {st['batches']} by replica "
              f"{st['batches_by_replica']}, shapes {st['shapes_dispatched']}"
              f" (retrace_count {st['retrace_count']} <= "
              f"{st['retrace_bound']}), fill ratio mean "
              f"{st['fill_ratio']['mean']:.3f}")
        require(err <= SERVE_TOL, f"served logits off by {err}")
        require((got.argmax(1) == ref.argmax(1)).all(),
                "served argmax differs from ModelPredictor's")
        require(abs(acc - acc_ref) < 1e-9,
                f"served accuracy {acc} != evaluator's {acc_ref}")
        require(st["retrace_count"] <= 4, f"shape count {st}")
        require(min(st["batches_by_replica"]) > 0,
                f"a replica served nothing: {st['batches_by_replica']}")
        payload_host_cost(x, spans, gpu)

        # the hot swap: zero dropped, and the predictions switch
        other = mnist_cnn(seed=1)
        ref2 = np.asarray(ModelPredictor(other, features_col="fi",
                                         device=device)
                          .predict(test)["prediction"])
        results, _, _ = post_rows(
            addr, x, spans, swap=lambda: engine.set_params(other.params))
        require(all(r is not None and r[0] == 200 for r in results),
                "a request was dropped across the hot swap")
        status, _, doc = post_json(addr, "/predict",
                                   {"rows": x[:64].tolist()})
        after = np.asarray(doc["predictions"], np.float32)
        err2 = logits_err(after, ref2[:64])
        print(f"  hot swap mid-traffic: {len(results)} requests all 200, "
              f"reloads {engine.reload_count}; after it, err against the "
              f"new weights {err2:.3e}, against the old "
              f"{logits_err(after, ref[:64]):.3e}")
        require(status == 200 and err2 <= SERVE_TOL,
                f"predictions after the swap are not the new model's "
                f"({err2})")

        # drain: everything delivered, then typed 503s
        out = engine.drain(timeout_s=600)
        status, hdrs, doc = post_json(addr, "/predict",
                                      {"rows": x[:2].tolist()})
        print(f"  drain: {out}; then /predict {status} {doc.get('reason')}")
        require(out["errored"] == 0 and status == 503
                and doc.get("reason") == "draining"
                and hdrs.get("Retry-After") == "1",
                f"drain then /predict: {out}, {status} {doc}")
    finally:
        server.close()

    small = ServingEngine(model, replicas=1, batch_ladder=(1,),
                          max_latency_s=5.0, max_queue=1, device=device)
    server = ServingServer(small, port=0, request_timeout_s=600)
    addr = server.start()
    try:
        status, hdrs, doc = post_json(addr, "/predict",
                                      {"rows": x[:4].tolist()})
    finally:
        server.close()
    print(f"  overload (max_queue=1): {status} {doc.get('reason')} "
          f"Retry-After {hdrs.get('Retry-After')}")
    require(status == 503 and doc.get("reason") == "queue_full",
            f"overload answered {status} {doc}")
    counts = kernel_counts(fa, fu, da)
    print(f"  hand-written kernels launched by 11a: {counts} (none is on "
          f"this path: cuBLAS / cuDNN)")
    require(not any(counts.values()),
            f"11a launched a hand-written kernel: {counts}")
    print(f"  11a wall {time.perf_counter() - t_phase:.1f} s on {gpu}")


def top2_margins(params, tokens, attention, apply_block, layer_norm):
    """Top-2 logit margin at every position of one full forward over
    ``tokens`` with plain attention (position p predicts token p + 1)."""
    import torch

    dev = params["proj"].device
    x = torch.tensor(tokens, device=dev)
    h = (params["proj"][x] + params["pos"][:len(tokens)])[None]
    for blk in params["blocks"]:
        h = apply_block(blk, h, attention, True)
    logits = (layer_norm(params["ln_f"], h)[0] @ params["head"]["kernel"]
              + params["head"]["bias"])
    top = torch.topk(logits, 2, dim=-1).values
    return (top[:, 0] - top[:, 1]).cpu().numpy()


def run_prompts(engine, prompts, on_token=None):
    gens = [engine.submit_generate(p, max_new_tokens=MAX_NEW,
                                   on_token=(on_token(i) if on_token
                                             else None))
            for i, p in enumerate(prompts)]
    return [g.result(timeout=600) for g in gens]


def decode_survivability(rng, fa, fu, da, gpu, dev, model_cfg=None,
                         prompt_lens=PROMPT_LENS):
    """11b: ``DecodeEngine(replicas=2)`` on the card at phase 5's widths:
    a replica killed mid-decode (replayed token-equal to the undisturbed
    run, K1 and K5 launched by the replay), step faults absorbed and
    past the retry, deadlines at the door and mid-decode, brownout
    shedding, resize, self_check, and ``x-dk-*`` headers through the
    server."""
    import torch

    from dist_keras_tpu_torch.models.transformer import (
        Transformer,
        apply_block,
        layer_norm,
        transformer_config,
    )
    from dist_keras_tpu_torch.ops.attention import attention
    from dist_keras_tpu_torch.resilience import faults
    from dist_keras_tpu_torch.serving import (
        DecodeEngine,
        Overloaded,
        ServingServer,
    )

    t_phase = time.perf_counter()
    cfg = model_cfg or MODEL
    model = Transformer(transformer_config(**cfg), seed=0, device=dev)
    engine = DecodeEngine(model, replicas=2, prefill_ladder=PREFILL_LADDER,
                          decode_ladder=DECODE_LADDER, page_size=PAGE_SIZE,
                          device=dev, max_new_default=MAX_NEW,
                          shed_watermark=SHED_WATERMARK)
    prompts = [rng.integers(0, cfg["input_dim"], size=n).tolist()
               for n in prompt_lens]
    faults.clear()
    try:
        base = run_prompts(engine, prompts)      # undisturbed (warms too)
        want = {tuple(p): d["generated"] for p, d in zip(prompts, base)}

        seen = [[] for _ in prompts]
        at_kill = {}

        def on_token(i):
            def cb(t):
                seen[i].append(t)
                if i == 0 and len(seen[0]) == KILL_AFTER:
                    at_kill["flash_fwd"] = fa.flash_fwd_launches
                    at_kill["paged_decode"] = da.paged_decode_launches
                    at_kill["emitted"] = [len(s) for s in seen]
                    at_kill["t"] = time.perf_counter()
                    engine.kill_replica(0)
            return cb

        zero_kernel_counts(fa, fu, da)
        t0 = time.perf_counter()
        docs = run_prompts(engine, prompts, on_token)
        wall = time.perf_counter() - t0
        counts = kernel_counts(fa, fu, da)
        st = engine.stats()
        recovered = [i for i, d in enumerate(docs) if d["recoveries"]]
        margins = []
        with torch.inference_mode():
            for i in recovered:
                m = top2_margins(model.params, docs[i]["tokens"], attention,
                                 apply_block, layer_norm)
                margins.append(float(m[len(prompts[i]) - 1:].min()))
        equal = [d["generated"] == want[tuple(p)]
                 for p, d in zip(prompts, docs)]
        replay_k1 = counts["flash_fwd"] - at_kill.get("flash_fwd", 0)
        replay_k5 = counts["paged_decode"] - at_kill.get("paged_decode", 0)
        print(f"  model {cfg} f32, page_size {PAGE_SIZE}, 2 replicas on "
              f"{dev} (a stream each), {engine.num_pages} pages each")
        print(f"  kill_replica(0) after request 0 streamed {KILL_AFTER} "
              f"tokens (tokens streamed by then {at_kill.get('emitted')}): "
              f"quarantines {st['quarantines']}, recovered "
              f"{st['recovered']} (requests {recovered}), replicas "
              f"{st['replicas']}, {sum(len(d['generated']) for d in docs)} "
              f"tokens in {wall:.3f} s, replay to the end "
              f"{time.perf_counter() - at_kill.get('t', t0):.3f} s on {gpu}")
        gapless = [s == d["generated"] for s, d in zip(seen, docs)]
        print(f"  token-equal to the undisturbed run: {equal}; streams "
              f"resumed without a gap {gapless}")
        print(f"  smallest top-2 logit margin on the recovered sequences "
              f"(from the last prompt position on): "
              f"{min(margins) if margins else None}")
        print(f"  launches on the main path (kill run): {counts}; after the "
              f"kill: flash_fwd +{replay_k1}, paged_decode +{replay_k5}")
        require(all(equal), f"recovered docs differ from the undisturbed "
                            f"ones (margins {margins})")
        require(all(gapless),
                "a stream skipped or repeated a token across the replay")
        require(st["quarantines"] == 1 and recovered,
                f"the kill recovered nothing: {st}")
        if dev.type == "cuda":
            require(counts["flash_fwd"] > 0 and counts["paged_decode"] > 0,
                    f"a kernel of the path never launched: {counts}")
            require(replay_k1 > 0 and replay_k5 > 0,
                    f"the replay launched no K1 / K5: +{replay_k1} "
                    f"+{replay_k5}")

        engine.resize(2)                         # a survivor again
        p = prompts[1]
        with faults.armed("decode.step", times=1):
            doc = engine.submit_generate(p, max_new_tokens=MAX_NEW).result(
                timeout=600)
        q0 = engine.stats()["quarantines"]
        print(f"  decode.step fault absorbed by step_retries: token-equal "
              f"{doc['generated'] == want[tuple(p)]}, recoveries "
              f"{doc['recoveries']}, quarantines {q0}")
        require(doc["generated"] == want[tuple(p)] and not doc["recoveries"]
                and q0 == 1, "the in-place retry did not absorb the fault")
        with faults.armed("decode.step", times=2):
            doc = engine.submit_generate(p, max_new_tokens=MAX_NEW).result(
                timeout=600)
        st = engine.stats()
        print(f"  decode.step fault past the retry: quarantines "
              f"{st['quarantines']}, recoveries {doc['recoveries']}, "
              f"token-equal {doc['generated'] == want[tuple(p)]}, errors "
              f"{st['errors']}")
        require(doc["generated"] == want[tuple(p)] and doc["recoveries"] == 1
                and st["quarantines"] == 2 and st["errors"] == 0,
                f"past-retry recovery failed: {st}")

        est = engine._ewma_prefill + MAX_NEW * engine._ewma_step
        try:
            engine.submit_generate(p, max_new_tokens=MAX_NEW,
                                   deadline_s=est / 100)
            raise SmokeFailure("an infeasible deadline was admitted")
        except Overloaded as e:
            require(e.reason == "deadline_infeasible", f"{e.reason}")
        deadline = 2 * est
        doc = engine.submit_generate(
            p, max_new_tokens=MAX_NEW, deadline_s=deadline,
            on_token=lambda _t: time.sleep(deadline / 8)).result(
            timeout=600)
        kv = engine.kv_stats()
        print(f"  deadlines (EWMAs prefill {engine._ewma_prefill * 1e3:.3f} "
              f"ms, step {engine._ewma_step * 1e3:.3f} ms): {est / 100:.2e} s "
              f"refused deadline_infeasible; {deadline:.4f} s with a slow "
              f"consumer -> finish {doc['finish']} after "
              f"{len(doc['generated'])} tokens, pages in use "
              f"{kv['used_pages']} on {gpu}")
        require(doc["finish"] == "deadline" and kv["used_pages"] == 0
                and doc["generated"] == want[tuple(p)][:len(doc["generated"])],
                f"mid-decode expiry: {doc['finish']}, {kv}")

        # a long interactive request, read slowly, holds its pages
        def slow_consumer(_t):
            time.sleep(0.01)

        hold = engine.submit_generate(prompts[-1], max_new_tokens=MAX_NEW,
                                      on_token=slow_consumer)
        occ = engine.kv_stats()["occupancy"]
        try:
            engine.submit_generate(p, max_new_tokens=2, priority="batch")
            raise SmokeFailure("a batch request was admitted in brownout")
        except Overloaded as e:
            require(e.reason == "shed_batch", f"{e.reason}")
        inter = engine.submit_generate(p, max_new_tokens=2)
        hold.result(timeout=600)
        inter.result(timeout=600)
        print(f"  brownout at occupancy {occ:.4f} >= watermark "
              f"{SHED_WATERMARK}: batch shed (shed {engine.stats()['shed']}, "
              f"rejected {engine.stats()['rejected']}), interactive admitted")

        engine.resize(3)
        docs3 = run_prompts(engine, prompts[:4])
        engine.resize(1)
        docs1 = run_prompts(engine, prompts[:2])
        st = engine.stats()
        equal = [d["generated"] == want[tuple(q)]
                 for q, d in zip(prompts[:4] + prompts[:2], docs3 + docs1)]
        print(f"  resize(3) then resize(1): live replicas {st['replicas']}, "
              f"token-equal {equal}")
        require(st["replicas"] == 1 and all(equal), "resize changed a doc")

        server = ServingServer(engine, port=0, request_timeout_s=600)
        addr = server.start()
        try:
            code, hdrs, doc = post_json(
                addr, "/generate", {"tokens": p, "max_new_tokens": 8},
                headers={"x-dk-deadline-s": f"{est / 100:.3e}"})
            hold = engine.submit_generate(prompts[-1], max_new_tokens=MAX_NEW,
                                          on_token=slow_consumer)
            code2, _, doc2 = post_json(
                addr, "/generate", {"tokens": p, "max_new_tokens": 8,
                                    "priority": "batch"})
            code3, _, doc3 = post_json(
                addr, "/generate", {"tokens": p, "max_new_tokens": 8},
                headers={"x-dk-priority": "batch",
                         "x-dk-deadline-s": "600"})
            hold.result(timeout=600)
        finally:
            server.close()      # drains the engine
        print(f"  through ServingServer: x-dk-deadline-s -> {code} "
              f"{doc.get('reason')} (Retry-After {hdrs.get('Retry-After')});"
              f" body priority batch -> {code2} {doc2.get('reason')}; header"
              f" priority batch -> {code3} {doc3.get('reason')}")
        require((code, doc.get("reason")) == (503, "deadline_infeasible")
                and (code2, doc2.get("reason")) == (503, "shed_batch")
                and (code3, doc3.get("reason")) == (503, "shed_batch"),
                "deadline / priority did not reach admission")
        leaked = engine.self_check()
        engine.assert_no_leaks()
        st = engine.stats()
        print(f"  self_check leaked {leaked}, kv_leaked {st['kv_leaked']}, "
              f"assert_no_leaks holds after drain; shapes "
              f"{st['shapes_dispatched']} (bound {st['retrace_bound']})")
        require(leaked == 0 and st["kv_leaked"] == 0, "KV pages leaked")
        require(st["retrace_count"] <= st["retrace_bound"], f"{st}")
    finally:
        faults.clear()
        engine.close(drain=False)
    print(f"  11b wall {time.perf_counter() - t_phase:.1f} s on {gpu}")
    return counts


# -- phase 12: checkpoints and resume on the card ---------------------------
STALL_MB = (64, 256)            # bench.py's bench_ckpt_async_save sizes
STALL_REPS = 3
CKPT_BENCH_EPOCHS, CKPT_EVERY_WINDOWS = 12, 4   # 3 cadence saves per run
PREEMPT_EPOCH = 3               # SIGTERM at this epoch's end (of 6)


def bits_equal(a, b):
    """Two tensors (or numpy arrays) with the same bits."""
    import torch

    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.view(view[t.element_size()]) for t in (a, b))
    return torch.equal(a.cpu(), b.cpu())


def tree_differ(got, want):
    """-> the paths whose leaves differ in structure or bits (empty when
    the two trees are bit-equal)."""
    from dist_keras_tpu_torch.checkpoint import _flatten

    g, w = _flatten(got)[0], _flatten(want)[0]
    if [p for p, _ in g] != [p for p, _ in w]:
        return ["<structure>"]
    return [p for (p, a), (_, b) in zip(g, w) if not bits_equal(a, b)]


def checkpoint_round_trip(gpu):
    """A full ADAG training state of CUDA tensors — the MNIST CNN's
    center, its 4 stacked workers, their stacked adam state and the
    device generator's state — through save and restore onto a CUDA
    template, bit for bit, chunked and differential."""
    import tempfile

    import torch

    from dist_keras_tpu_torch.checkpoint import Checkpointer
    from dist_keras_tpu_torch.models import mnist_cnn
    from dist_keras_tpu_torch.ops.optimizers import get_optimizer
    from dist_keras_tpu_torch.utils.pytree import (
        tree_leaves,
        tree_map,
        tree_stack,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    center = [{k: v.to(dev) for k, v in p.items()}
              for p in mnist_cnn(seed=3).params]
    local = tree_map(lambda x: x + torch.randn(
        x.shape, generator=gen, device=dev).to(x.dtype),
        tree_stack(center, ADAG_WORKERS))
    opt = tree_stack(get_optimizer("adam").init(center), ADAG_WORKERS)
    opt = {"count": opt["count"] + 5,
           "mu": tree_map(lambda x: torch.randn(
               x.shape, generator=gen, device=dev), opt["mu"]),
           "nu": tree_map(lambda x: torch.rand(
               x.shape, generator=gen, device=dev), opt["nu"])}
    state = {"center": center, "local": local, "opt_state": opt,
             "rng": gen.get_state(),
             "bf16": torch.randn(4096, device=dev).to(torch.bfloat16)}
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    template = tree_map(torch.empty_like, state)
    for name, env in (("chunked", {"DK_CKPT_CHUNK_MB": "1"}),
                      ("differential", {"DK_CKPT_CHUNK_MB": "1",
                                        "DK_CKPT_DIFF": "1"})):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            with tempfile.TemporaryDirectory() as d:
                ck = Checkpointer(d)
                ck.save(1, state).wait(timeout_s=120)
                ck.save(2, state).wait(timeout_s=120)   # diff: all skipped
                stats = ck.last_diff_stats
                step, got = ck.restore(template=template)
                on_card = all(x.device == y.device for x, y in zip(
                    tree_leaves(got), tree_leaves(state)))
                verified = ck.verify(2)
                differ = tree_differ(got, state)
                ok = (step == 2 and verified == "ok" and on_card
                      and not differ)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        print(f"  round trip {name}: {nbytes / 2**20:.1f} MB of CUDA "
              f"tensors (center, 4 stacked workers, stacked adam state, "
              f"generator state, a bf16 leaf) restored onto CUDA "
              f"templates bit for bit: {ok}"
              + (f"; second save wrote {stats['bytes_written']} B, skipped "
                 f"{stats['skipped']} of {stats['chunks']} chunks"
                 if stats else "") + f" on {gpu}")
        require(ok, f"the {name} round trip is not bit-exact: step {step}, "
                    f"verify {verified}, on the templates' devices "
                    f"{on_card}, leaves that differ {differ[:6]}")
        if stats:
            require(stats["bytes_written"] == 0,
                    "a differential re-save of an unchanged state wrote "
                    "chunk bytes")


def save_stall(gpu):
    """``ckpt.save_stall_s`` (the caller's wall in ``save``) against
    ``ckpt.write_s`` (the writer's wall) for states of 64 and 256 MB made
    on the card, with ``DK_CKPT_ASYNC`` on and off; each save is waited
    for before the next.  -> the rows printed."""
    import tempfile

    import torch

    from dist_keras_tpu_torch.checkpoint import Checkpointer
    from dist_keras_tpu_torch.observability import metrics

    rows = []
    dev = torch.device("cuda")
    for mb in STALL_MB:
        n = mb * 2**20 // 4 // 8
        state = {f"w{i}": torch.randn(n, device=dev) for i in range(8)}
        torch.cuda.synchronize()
        for async_on in ("1", "0"):
            os.environ["DK_CKPT_ASYNC"] = async_on
            stalls, writes = [], []
            with tempfile.TemporaryDirectory() as d:
                ck = Checkpointer(d, max_to_keep=2)
                for rep in range(STALL_REPS + 1):
                    metrics.histogram("ckpt.save_stall_s").reset()
                    metrics.histogram("ckpt.write_s").reset()
                    # the training loop's boundary: the state was just
                    # produced by kernels still running
                    state = {k: v * 1.0 for k, v in state.items()}
                    ck.save(rep, state).wait(timeout_s=300)
                    snap = metrics.snapshot()["histograms"]
                    if rep:   # the first save warms the pinned pool
                        stalls.append(snap["ckpt.save_stall_s"]["max"])
                        writes.append(snap["ckpt.write_s"]["max"])
            os.environ.pop("DK_CKPT_ASYNC", None)
            stall, write = float(np.median(stalls)), float(np.median(writes))
            rows.append((mb, async_on, stall, write))
            print(f"  save {mb} MB (8 f32 leaves on the card), DK_CKPT_ASYNC="
                  f"{async_on}: ckpt.save_stall_s median {stall * 1e3:.2f} "
                  f"ms, ckpt.write_s median {write * 1e3:.2f} ms "
                  f"({mb / write / 1024:.2f} GB/s written and hashed) over "
                  f"{STALL_REPS} saves on {gpu}")
        del state
        torch.cuda.empty_cache()
    for mb in STALL_MB:
        (a_stall, a_write), (s_stall, s_write) = [
            (st, wr) for m, _, st, wr in rows if m == mb]
        require(a_stall < 0.5 * a_write,
                f"{mb} MB async save stalled {a_stall:.3f} s, not well "
                f"under its write {a_write:.3f} s")
        require(s_stall >= s_write,
                f"{mb} MB synchronous save stalled {s_stall:.3f} s, less "
                f"than its write {s_write:.3f} s")
    return rows


def deterministic(on):
    """Deterministic algorithms for the resume checks (cuBLAS's workspace
    is pinned by CUBLAS_WORKSPACE_CONFIG, set before CUDA starts)."""
    import torch

    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


def preempt_and_resume(name, make, data, gpu, check=None):
    """Two uninterrupted runs (the control: bit-equal), then a run with
    ``handle_preemption=True`` that sends itself a real SIGTERM at the end
    of epoch PREEMPT_EPOCH and exits ``Preempted`` with a verified saved
    step, then a fresh trainer resumed from that step: its weights and
    its losses equal the uninterrupted run's, bit for bit."""
    import signal
    import tempfile
    import warnings

    from dist_keras_tpu_torch.checkpoint import Checkpointer
    from dist_keras_tpu_torch.resilience import preemption
    from dist_keras_tpu_torch.resilience.preemption import Preempted

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        runs = []
        for _ in range(2):
            t = make()
            m = t.train(data, shuffle=True)
            runs.append((t, m))
        (ta, ma), (tb, mb) = runs
        control = all(bits_equal(a, b) for a, b in zip(
            ma.get_weights(), mb.get_weights())) and bits_equal(
            np.asarray(ta.get_history()), np.asarray(tb.get_history()))

        def sigterm(trainer, epoch, logs):
            if epoch == PREEMPT_EPOCH:
                os.kill(os.getpid(), signal.SIGTERM)

        with tempfile.TemporaryDirectory() as d:
            t1 = make(checkpoint_dir=d, handle_preemption=True,
                      callbacks=[sigterm])
            code = saved = None
            try:
                t1.train(data, shuffle=True)
            except Preempted as e:
                code, saved = e.code, e.saved_step
            preemption.clear()
            verified = (saved is not None
                        and Checkpointer(d).verify(saved) == "ok")
            t2 = make(checkpoint_dir=d, resume=True)
            resumed = t2.train(data, shuffle=True)
    nondet = sorted({str(w.message).split(".")[0] for w in caught
                     if "deterministic" in str(w.message)})
    h_full = np.asarray(ta.get_history())
    h_res = np.asarray(t2.get_history())
    flat = (h_full.reshape(h_full.shape[0], -1) if h_full.ndim > 1
            else h_full)
    flat_res = (h_res.reshape(h_res.shape[0], -1) if h_res.ndim > 1
                else h_res)
    tail = flat[..., flat.shape[-1] - flat_res.shape[-1]:]
    equal = all(bits_equal(a, b) for a, b in zip(
        resumed.get_weights(), ma.get_weights())) and bits_equal(
        flat_res, tail)
    print(f"  {name}: two uninterrupted runs bit-equal: {control}; SIGTERM "
          f"at epoch {PREEMPT_EPOCH} -> Preempted code {code}, saved step "
          f"{saved} verified {verified}; resumed in a fresh trainer from "
          f"step {saved}: weights and the {flat_res.shape[-1]} resumed "
          f"losses per worker bit-equal to the uninterrupted run: {equal} "
          f"on {gpu}")
    if nondet:
        print(f"    ops without a deterministic CUDA path: {nondet}")
    require(control, f"{name}: two uninterrupted runs differ on the card")
    require(code == 143 and verified,
            f"{name}: the SIGTERM gave code {code}, saved step {saved}")
    require(equal, f"{name}: the resumed run differs from the "
                   f"uninterrupted one")
    if check is not None:
        check(resumed, t2)


def adag_with_saves(gpu):
    """ADAG samples/s at ``bench_adag_mnist_cnn``'s shape, without saves
    and with ``checkpoint_every_windows=CKPT_EVERY_WINDOWS`` (async
    saves), alternated twice; samples over ``get_training_time()``, which
    includes the end-of-run drain of the last save."""
    import tempfile

    import torch

    from dist_keras_tpu_torch.data import Dataset
    from dist_keras_tpu_torch.models import mnist_cnn
    from dist_keras_tpu_torch.trainers import ADAG

    rng = np.random.default_rng(0)
    n = ADAG_BENCH_BATCH * ADAG_BENCH_STEPS
    y = rng.integers(0, 10, n)
    ds = Dataset({"features": rng.normal(size=(n, 28, 28, 1)).astype(
        np.float32), "label": y,
        "label_encoded": np.eye(10, dtype=np.float32)[y]})

    def run(saves):
        with tempfile.TemporaryDirectory() as d:
            kw = ({"checkpoint_dir": d,
                   "checkpoint_every_windows": CKPT_EVERY_WINDOWS}
                  if saves else {})
            t = ADAG(mnist_cnn(), num_workers=ADAG_WORKERS,
                     communication_window=ADAG_WINDOW,
                     worker_optimizer="adam", batch_size=ADAG_BENCH_BATCH,
                     num_epoch=CKPT_BENCH_EPOCHS, label_col="label_encoded",
                     compute_dtype=torch.bfloat16, **kw)
            t.train(ds)
            steps = t._checkpointer.all_steps() if saves else []
        h = np.asarray(t.get_history())
        require(np.isfinite(h).all(), "the ADAG bench run is not finite")
        return h.size * ADAG_BENCH_BATCH / t.get_training_time(), steps

    run(False)   # warm-up
    out, kept = {False: [], True: []}, []
    for saves in (False, True, True, False):
        sps, steps = run(saves)
        out[saves].append(sps)
        kept = steps or kept
    off, on = float(np.median(out[False])), float(np.median(out[True]))
    print(f"  ADAG at bench_adag_mnist_cnn's shape ({CKPT_BENCH_EPOCHS} "
          f"windows, bf16, adam): {off:.1f} samples/s without saves "
          f"({', '.join(f'{v:.1f}' for v in out[False])}), {on:.1f} with "
          f"checkpoint_every_windows={CKPT_EVERY_WINDOWS} "
          f"({', '.join(f'{v:.1f}' for v in out[True])}; steps kept "
          f"{kept}) = {100 * (off - on) / off:.2f}% slower on {gpu}")
    require(kept and kept[-1] == CKPT_BENCH_EPOCHS,
            f"the final cadence save is missing: {kept}")
    return off, on


def checkpoints_and_resume(fa, fu, da, gpu):
    """Phase 12: the round trip, the save stall, SingleTrainer (MNIST
    MLP) and ADAG (MNIST CNN, with dropout) preempted by a real SIGTERM
    and resumed bit-equal under deterministic algorithms, the resumed
    ADAG through its phase-10 gate, ADAG with cadence saves; no
    hand-written kernel launched."""
    import torch

    from dist_keras_tpu_torch.models import mnist_cnn, mnist_mlp
    from dist_keras_tpu_torch.trainers import ADAG, SingleTrainer

    t0 = time.perf_counter()
    zero_kernel_counts(fa, fu, da)
    checkpoint_round_trip(gpu)
    save_stall(gpu)
    train, test = mnist_sets()
    deterministic(True)
    try:
        preempt_and_resume(
            "SingleTrainer mnist_mlp (adam, 6 epochs of the phase-9 gate)",
            lambda **kw: SingleTrainer(
                mnist_mlp(), worker_optimizer="adam",
                optimizer_kwargs={"learning_rate": 1e-3}, batch_size=64,
                num_epoch=GATE_EPOCHS, features_col="fn", label_col="le",
                **kw), train, gpu)

        def gate(model, t):
            acc = accuracy(model, test, "fi")
            print(f"  resumed ADAG through the phase-10 gate "
                  f"adag_mnist_cnn_w12: accuracy {acc:.4f} (threshold "
                  f"{GATE_ACC}) on {gpu}")
            require(acc >= GATE_ACC,
                    f"the resumed ADAG's accuracy {acc} < {GATE_ACC}")

        preempt_and_resume(
            "ADAG mnist_cnn with dropout (4 workers, window 12, adam, "
            "the phase-10 gate)",
            lambda **kw: ADAG(
                mnist_cnn(), num_workers=ADAG_WORKERS,
                communication_window=ADAG_WINDOW, worker_optimizer="adam",
                optimizer_kwargs={"learning_rate": 3e-3}, batch_size=64,
                num_epoch=GATE_EPOCHS, features_col="fi", label_col="le",
                **kw), train, gpu, check=gate)
    finally:
        deterministic(False)
    torch.cuda.empty_cache()
    adag_with_saves(gpu)
    counts = kernel_counts(fa, fu, da)
    print(f"  hand-written kernels launched by phase 12: {counts} (none is "
          f"on this path)")
    require(not any(counts.values()),
            f"phase 12 launched a hand-written kernel: {counts}")
    print(f"  phase 12 wall {time.perf_counter() - t0:.1f} s on {gpu}")


# -- phase 13: parameter-server mode (a server process, worker processes on
# the card) ------------------------------------------------------------------
PS_ACC_FLOOR = 0.80        # gates.py's _PS_ACC_FLOOR, the pinned DynSGD floor
PS_BLOBS = dict(hidden=(16,), input_dim=8, num_classes=2)
PS_CHAOS_SEEDS = 4
PS_TIMEOUT_S = 180         # the longest any one process of the phase may run
PS_WORKERS, PS_WINDOW = 4, 12
PS_PHASES = ("ps_steps", "ps_delta", "ps_encode", "ps_commit", "ps_merge")


def tree_sha(tree):
    """The sha256 of a numpy tree (keys sorted, paths and bytes): the
    drained server prints it, the checkpoint must restore to it."""
    import hashlib

    h = hashlib.sha256()

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            h.update("/".join(path).encode())
            h.update(np.asarray(t).tobytes())

    walk(tree, ())
    return h.hexdigest()


def blobs_columns():
    """The PS gate's set (``gates.py``): 512 rows of two gaussian blobs in
    8 dimensions, one-hot labels."""
    rng = np.random.default_rng(0)
    n, d = 512, 8
    y = rng.integers(0, 2, size=n)
    centers = np.stack([np.full(d, -1.0), np.full(d, 1.0)])
    x = (centers[y] + rng.normal(size=(n, d))).astype(np.float32)
    return {"features": x, "label": y,
            "label_encoded": np.eye(2, dtype=np.float32)[y]}


def ps_role(cfg):
    """A process of phase 13, started by :class:`PSProcs`: the server
    (``"server"``) or one worker (``"worker"``).  Its launch counters of
    K1-K5, zeroed before it starts, are printed as ``PS_KERNELS {json}``
    however it ends (a SIGKILL aside)."""
    sys.path.insert(0, str(ROOT))
    from dist_keras_tpu_torch.ops import decode_attention as da
    from dist_keras_tpu_torch.ops import flash_attention as fa
    from dist_keras_tpu_torch.ops import fused_bwd_experimental as fu

    zero_kernel_counts(fa, fu, da)
    try:
        if cfg["role"] == "server":
            return ps_server_role(cfg)
        return ps_worker_role(cfg, lambda: kernel_counts(fa, fu, da))
    finally:
        write_kernel_counts("PS_KERNELS", fa, fu, da)


def ps_server_role(cfg):
    """The center-variable server: binds a free port and publishes
    ``host:port`` atomically; SIGTERM drains it through the preemption
    path (final checkpoint, waited), it prints ``PS_FINAL clock sha`` and
    exits 143."""
    from dist_keras_tpu_torch.models import mnist_mlp
    from dist_keras_tpu_torch.ps import PSServer
    from dist_keras_tpu_torch.resilience.preemption import Preempted

    work = cfg["work"]
    srv = PSServer(params=mnist_mlp(seed=0, **cfg["arch"]).params, port=0,
                   window=cfg["window"], ckpt_dir=os.path.join(work, "ck"),
                   ckpt_every_commits=cfg["ckpt_every"])
    srv.install_signal_drain(poll_s=0.02)
    host, port = srv.address
    tmp = os.path.join(work, ".addr.tmp")
    with open(tmp, "w") as f:
        f.write(f"{host}:{port}")
    os.replace(tmp, os.path.join(work, "addr"))
    try:
        srv.run_forever()
    except Preempted:
        clock, center = srv.center.state()
        write_record(f"PS_FINAL {clock} {tree_sha(center)}")
        raise
    return 0


def wait_address(run, server=None, log=""):
    """The ``host:port`` the server of ``run`` published (it binds a free
    port), waited for up to 90 s; a dead ``server`` process fails it."""
    path = Path(run) / "addr"
    t0 = time.perf_counter()
    while not path.exists():
        require(server is None or server.poll() is None,
                f"the server of {run} died: {log}")
        require(time.perf_counter() - t0 < 90,
                f"the server of {run} published no address in 90 s")
        time.sleep(0.01)
    return path.read_text().strip()


def ps_worker_role(cfg, counts):
    """One ``PSWorkerTrainer`` on ``cfg["device"]``: trains, then prints
    ``PS_WORKER_DONE {json}`` (its commits, bytes, samples, the
    ``perf.phase.ps_*`` window split, accuracy on its own rows when
    asked; with ``profile``, the device time of its whole run under
    ``torch.profiler``); a typed failure prints ``TYPED`` and exits 2.
    ``counts()`` reads its K1-K5 launch counters."""
    import contextlib

    from dist_keras_tpu_torch.data import Dataset
    from dist_keras_tpu_torch.models import mnist_mlp
    from dist_keras_tpu_torch.observability import metrics
    from dist_keras_tpu_torch.ps import PSError, PSWorkerTrainer
    from dist_keras_tpu_torch.resilience.faults import FaultInjected

    ds = Dataset(blobs_columns() if cfg["data"] == "blobs"
                 else dict(np.load(cfg["data"])))
    addr = wait_address(cfg["run"])
    t = PSWorkerTrainer(
        mnist_mlp(seed=0, **cfg["arch"]), server_addr=addr,
        communication_window=cfg["window"],
        worker_optimizer=cfg["opt"],
        optimizer_kwargs={"learning_rate": cfg["lr"]},
        batch_size=cfg["batch"], num_epoch=cfg["epochs"],
        features_col=cfg["x"], label_col=cfg["y"], seed=cfg["seed"],
        device=cfg["device"])
    gate = cfg.get("gate")
    if gate:
        # CUDA up and the data loaded: wait until every worker is, so the
        # workers train side by side from their first join
        import torch

        torch.zeros(1, device=t.device).add_(1)
        Path(f"{gate}.{cfg['rank']}").touch()
        t0 = time.perf_counter()
        while not os.path.exists(gate):
            require(time.perf_counter() - t0 < 120, "no start signal")
            time.sleep(0.005)
    ready = cfg.get("ready")
    if ready:
        def pacing(trainer, epoch, logs):
            # publish the lease id once committed and the launch counters
            # at every epoch's end, and stretch the run so the parent's
            # SIGKILL lands mid-training
            for path, text in ((ready + ".kernels", json.dumps(counts())),
                               (ready, str(trainer.worker_id))):
                with open(path + ".tmp", "w") as f:
                    f.write(text)
                os.replace(path + ".tmp", path)
            time.sleep(0.05)

        t.callbacks.append(pacing)
    prof = None
    if cfg.get("profile"):
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
    try:
        with prof or contextlib.nullcontext():
            model = t.train(ds, shuffle=cfg["shuffle"])
    except (FaultInjected, PSError, OSError) as e:
        write_record(f"TYPED {type(e).__name__}: {e}")
        return 2
    hists = metrics.snapshot()["histograms"]
    out = {"rank": cfg["rank"], "wid": t.worker_id,
           "device": str(t.device), "commits": len(t.commit_log),
           "staleness": [s for _, s, _ in t.commit_log],
           "stale_rejections": t.stale_rejections,
           "bytes": t.commit_bytes,
           "samples": len(t.get_history()) * cfg["batch"],
           "loss_head": float(np.mean(t.get_history()[:8])),
           "loss_tail": float(np.mean(t.get_history()[-8:])),
           "phases_ms": {p: hists[f"perf.phase.{p}"]["total"] * 1e3
                         / hists[f"perf.phase.{p}"]["count"]
                         for p in PS_PHASES},
           "windows_ms": sum(hists[f"perf.phase.{p}"]["total"]
                             for p in PS_PHASES) * 1e3,
           "commit_ms": {q: hists["perf.phase.ps_commit"][q] * 1e3
                         for q in ("p50", "p95", "max")}}
    if prof is not None:
        from torch.autograd import DeviceType

        ops = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        out["busy_ms"] = sum(e.self_device_time_total for e in ops) / 1e3
        out["ops"] = sum(e.count for e in ops)
    if cfg.get("eval"):
        out["acc"] = accuracy(model, ds, cfg["x"], device=cfg["device"])
    write_record("PS_WORKER_DONE " + json.dumps(out))
    return 0


class RoleProcs:
    """A phase's processes, each a fresh ``python3 chip_smoke.py <flag>
    JSON`` (never a fork of this process, which has started CUDA), its
    output in a file under ``work``.  Each prints its K1-K5 launch
    counters as ``<prefix> {json}`` lines, the last of which counts;
    :meth:`close` kills any still running."""

    ENV_DROP = ("DK_COORD", "DK_FAULTS", "DK_OBS", "DK_CKPT", "DK_ALERT",
                "DK_PS", "DK_SLO", "DK_TRACE", "DK_ROUTE")

    def __init__(self, work, flag, prefix, timeout_s):
        self.work = Path(work)
        self.flag, self.prefix, self.timeout_s = flag, prefix, timeout_s
        self.procs = []
        self.kernels = {}      # K1-K5 launches summed over the processes
        self.counted = []      # the labels whose launches are in it
        self.env = {k: v for k, v in os.environ.items()
                    if not k.startswith(self.ENV_DROP)}

    def spawn(self, label, cfg, **env):
        log = open(self.work / f"{label}.log", "w")
        p = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), self.flag,
             json.dumps(cfg)], stdout=log, stderr=subprocess.STDOUT,
            env={**self.env, **env}, cwd=str(ROOT))
        log.close()
        p.label = label
        self.procs.append(p)
        return p

    def output(self, p):
        return (self.work / f"{p.label}.log").read_text()

    def add_kernels(self, label, counts):
        for k, n in counts.items():
            self.kernels[k] = self.kernels.get(k, 0) + n
        self.counted.append(label)

    def count(self, p):
        """Adds the last launch counters ``p`` printed (a flat JSON
        object, found wherever the line starts in the shared log)."""
        out = self.output(p)
        found = re.findall(rf"{self.prefix} (\{{[^{{}}\n]*\}})", out)
        require(found, f"{p.label}: printed no launch counters: "
                       f"{out[-400:]}")
        self.add_kernels(p.label, json.loads(found[-1]))

    def finish(self, p):
        """Waits for ``p`` (killed as a HANG after ``timeout_s``), counts
        its launches, -> its output."""
        try:
            p.wait(timeout=self.timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            raise SmokeFailure(f"{p.label}: HANG (killed at "
                               f"{self.timeout_s} s): "
                               f"{self.output(p)[-400:]}")
        self.count(p)
        return self.output(p)

    def kill(self, p):
        p.kill()
        p.wait()
        self.count(p)

    def terminate(self, p):
        """SIGTERM -> the drain: exit 143, -> its output."""
        import signal

        p.send_signal(signal.SIGTERM)
        out = self.finish(p)
        require(p.returncode == 143, f"{p.label} exited {p.returncode}, "
                                     f"wanted 143 (SIGTERM drain): "
                                     f"{out[-400:]}")
        return out

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


class PSProcs(RoleProcs):
    """Phase 13's server and worker processes (``--ps-role``)."""

    def __init__(self, work):
        super().__init__(work, "--ps-role", "PS_KERNELS", PS_TIMEOUT_S)

    def server(self, run, arch, window, ckpt_every, **env):
        os.makedirs(run, exist_ok=True)
        return self.spawn(f"server_{Path(run).name}", {
            "role": "server", "work": str(run), "arch": arch,
            "window": window, "ckpt_every": ckpt_every},
            DK_COORD_RANK="0", **env)

    def wait_files(self, paths, procs):
        """Waits until every one of ``paths`` exists (the workers of
        ``procs`` waiting at their gates) — fails if one of ``procs``
        died, or after 120 s."""
        t0 = time.perf_counter()
        while not all(os.path.exists(f) for f in paths):
            require(all(p.poll() is None for p in procs)
                    and time.perf_counter() - t0 < 120,
                    "a worker died or hung before training: " + "; ".join(
                        self.output(p)[-300:] for p in procs))
            time.sleep(0.01)

    def stop(self, server):
        """The server's drain -> {"clock", "sha"}."""
        out = self.terminate(server)
        m = re.search(r"^PS_FINAL (\d+) ([0-9a-f]{64})$", out, re.M)
        require(m, f"{server.label}: no PS_FINAL line: {out[-400:]}")
        return {"clock": int(m.group(1)), "sha": m.group(2)}


def worker_result(procs, p):
    out = procs.finish(p)
    m = re.search(r"^PS_WORKER_DONE (.*)$", out, re.M)
    require(p.returncode == 0 and m,
            f"{p.label}: rc={p.returncode}: {out.strip()[-400:]}")
    return json.loads(m.group(1))


def ps_check(run, final, label, obs_dir=None, killed_wid=None, min_joins=0):
    """The drained server's latest promoted step is its final clock,
    verifies ``ok`` and restores bit-equal to the sha it printed; with
    ``obs_dir`` the report attributes the killed worker's lapse, the
    joins and per-worker commits.  -> the restored center."""
    from dist_keras_tpu_torch.checkpoint import Checkpointer
    from dist_keras_tpu_torch.observability import report

    ck = Checkpointer(os.path.join(run, "ck"), rank=0, world=1)
    latest = ck.latest_step()
    require(latest == final["clock"],
            f"{label}: latest promoted step {latest} != drained clock "
            f"{final['clock']}")
    require(ck.verify(latest) == "ok", f"{label}: step {latest} did not "
                                       f"verify ok")
    step, state = ck.restore(step=latest)
    require(step == latest and int(np.asarray(state["clock"])) == latest,
            f"{label}: restore({latest}) gave step {step}")
    sha = tree_sha(state["center"])
    require(sha == final["sha"], f"{label}: restored center sha {sha[:12]} "
                                 f"!= drained {final['sha'][:12]}")
    if obs_dir is not None:
        s = report.summarize(report.read_events(obs_dir))["ps"]
        lapsed = [lp["wid"] for lp in s["lapses"]]
        require(killed_wid is None or killed_wid in lapsed,
                f"{label}: killed worker {killed_wid} not attributed in "
                f"lapses {lapsed}")
        require(len(s["joins"]) >= min_joins,
                f"{label}: {len(s['joins'])} joins attributed, wanted "
                f"{min_joins}")
        require(sum(s["commits_by_worker"].values()) >= 1,
                f"{label}: no per-worker commits attributed")
    return state["center"]


def ps_gate(procs, work, gpu, device):
    """13a: ``gates.py``'s ``run_ps_gate`` with the workers on the card."""
    run = os.path.join(work, "main")
    obs = os.path.join(run, "obs")
    os.makedirs(obs, exist_ok=True)
    t0 = time.perf_counter()
    server = procs.server(run, PS_BLOBS, 4, 4, DK_OBS_DIR=obs,
                          DK_PS_LEASE_S="1.0")
    common = {"role": "worker", "run": run, "data": "blobs",
              "arch": PS_BLOBS, "window": 4, "opt": "sgd", "lr": 0.05,
              "batch": 16, "x": "features", "y": "label_encoded",
              "device": device, "shuffle": False, "eval": True}

    def worker(rank, epochs, seed):
        return procs.spawn(f"gate_worker_{rank}", {
            **common, "rank": rank, "epochs": epochs, "seed": seed,
            "ready": os.path.join(run, f"ready_{rank}")},
            DK_OBS_DIR=obs, DK_COORD_RANK=str(rank))

    w1, w2 = worker(1, 8, 1), worker(2, 8, 2)
    ready = Path(run) / "ready_2"
    while not ready.exists():
        require(w2.poll() is None and time.perf_counter() - t0 < 120,
                f"worker 2 never became ready to kill: "
                f"{procs.output(w2)[-400:]}")
        time.sleep(0.02)
    killed_wid = ready.read_text().strip()
    w2.kill()
    w2.wait()
    # the killed worker's launches up to its last epoch's end
    procs.add_kernels(w2.label, json.loads(
        Path(run, "ready_2.kernels").read_text()))
    w3 = worker(3, 4, 3)
    done = [worker_result(procs, w) for w in (w1, w3)]
    for r in done:
        require(r["device"].startswith(device),
                f"worker {r['rank']} trained on {r['device']}")
        require(r["acc"] >= PS_ACC_FLOOR,
                f"worker {r['rank']}: accuracy {r['acc']} below the pinned "
                f"DynSGD floor {PS_ACC_FLOOR}")
    time.sleep(2.5)   # the killed worker's lease (1 s) lapses, the reaper logs it
    final = procs.stop(server)
    ps_check(run, final, "13a", obs_dir=obs, killed_wid=killed_wid,
             min_joins=3)
    print(f"  13a kill and rejoin: worker 2 ({killed_wid}) SIGKILLed after "
          f"its first epoch, worker 3 joined at a later clock; accuracies "
          + ", ".join(f"worker {r['rank']} {r['acc']:.4f} ({r['commits']} "
                      f"commits, staleness max {max(r['staleness'])})"
                      for r in done)
          + f" (floor {PS_ACC_FLOOR}); SIGTERM -> 143, final step "
          f"{final['clock']} verified and restored to sha "
          f"{final['sha'][:12]}; the lapse, 3+ joins and per-worker commits "
          f"attributed by report.summarize; "
          f"{time.perf_counter() - t0:.1f} s on {gpu}")

    # the chaos sweep, the seeds side by side: every run ends completed or
    # typed with a verified promoted step, none hangs
    t0 = time.perf_counter()
    runs = [os.path.join(work, f"chaos_{seed}")
            for seed in range(PS_CHAOS_SEEDS)]
    servers = [procs.server(r, PS_BLOBS, 4, 4) for r in runs]
    workers = [procs.spawn(f"chaos_worker_{seed}", {
        **common, "run": runs[seed], "rank": 1, "epochs": 2,
        "seed": seed, "eval": False}, DK_COORD_RANK="1",
        DK_FAULTS_SEED=str(7000 + seed),
        DK_FAULTS_POINTS="ps.pull,ps.commit,ps.join", DK_FAULTS_RATE="1.0")
        for seed in range(PS_CHAOS_SEEDS)]
    verdicts = []
    for seed, (w, s, r) in enumerate(zip(workers, servers, runs)):
        out = procs.finish(w)
        require(w.returncode in (0, 2), f"chaos seed {seed}: worker died "
                                        f"UNTYPED (rc={w.returncode}): "
                                        f"{out[-400:]}")
        typed = re.search(r"^(TYPED \w+)", out, re.M)
        require(typed if w.returncode == 2 else "PS_WORKER_DONE" in out,
                f"chaos seed {seed}: exited {w.returncode} neither typed "
                f"nor completed: {out[-400:]}")
        final = procs.stop(s)
        ps_check(r, final, f"chaos seed {seed}")
        verdicts.append("completed" if w.returncode == 0
                        else typed.group(1))
        verdicts[-1] += f" (promoted step {final['clock']} verified)"
    print(f"  13a chaos sweep, {PS_CHAOS_SEEDS} seeds over ps.pull, "
          f"ps.commit, ps.join at DK_FAULTS_RATE=1.0: "
          + "; ".join(f"seed {i}: {v}" for i, v in enumerate(verdicts))
          + f"; none hung; {time.perf_counter() - t0:.1f} s on {gpu}")


def ps_mnist_spawn(procs, work, data, device, compress=None,
                   profile=False, epochs=GATE_EPOCHS):
    """13b's processes: one server and PS_WORKERS workers sharing the
    card, ``mnist_mlp()`` at full width, window 12, adam 1e-3, batch 64,
    ``epochs`` epochs of the phase-9 gate set, each worker shuffling with
    its own seed; with ``profile``, one epoch with each worker's whole
    run under ``torch.profiler``.  The workers wait at the run's gate
    (:func:`ps_start`)."""
    tag = "profiled" if profile else compress or "f32"
    run = os.path.join(work, f"mnist_{tag}")
    obs = os.path.join(run, "obs")
    os.makedirs(obs, exist_ok=True)
    server = procs.server(run, {}, PS_WINDOW, 48, DK_OBS_DIR=obs)
    env = {"DK_PS_COMPRESS": compress} if compress else {}
    gate = os.path.join(run, "go")
    workers = [procs.spawn(f"mnist_{tag}_worker_{i}", {
        "role": "worker", "rank": i + 1, "run": run, "data": data,
        "arch": {}, "window": PS_WINDOW, "opt": "adam", "lr": 1e-3,
        "batch": 64, "epochs": 1 if profile else epochs, "x": "fn",
        "y": "le", "seed": i, "device": device, "shuffle": True,
        "gate": gate, "profile": profile},
        DK_COORD_RANK=str(i + 1), **env) for i in range(PS_WORKERS)]
    return {"tag": tag, "run": run, "obs": obs, "server": server,
            "workers": workers, "gate": gate, "epochs": epochs}


def ps_start(procs, r):
    """Opens 13b run ``r``'s gate once all its workers wait there, waits
    for them and drains its server.  -> the workers' results, the
    restored center."""
    procs.wait_files([f"{r['gate']}.{rank}" for rank in
                      range(1, PS_WORKERS + 1)], r["workers"])
    Path(r["gate"]).touch()
    res = [worker_result(procs, w) for w in r["workers"]]
    final = procs.stop(r["server"])
    return res, ps_check(r["run"], final, f"13b {r['tag']}")


def ps_mnist(procs, r, test, gpu, device):
    """Runs 13b run ``r`` (:func:`ps_start`); prints and checks its
    numbers.  -> them."""
    import torch

    from dist_keras_tpu_torch.models import mnist_mlp
    from dist_keras_tpu_torch.observability import report

    tag, obs = r["tag"], r["obs"]
    res, center = ps_start(procs, r)
    model = mnist_mlp()
    model.set_params([{k: torch.from_numpy(np.array(v)) for k, v in
                       p.items()} for p in center])
    acc = accuracy(model, test, "fn", device=device)
    evs = report.read_events(obs)
    s = report.summarize(evs)["ps"]
    t_join = min(e["t"] for e in evs if e["kind"] == "ps_worker_join")
    t_last = max(e["t"] for e in evs if e["kind"] == "ps_commit")
    span = t_last - t_join
    commits = sum(s["commits_by_worker"].values())
    samples = sum(r["samples"] for r in res)
    raw = sum(r["bytes"]["raw"] for r in res)
    wire = sum(r["bytes"]["wire"] for r in res)
    split = {p: float(np.mean([r["phases_ms"][p] for r in res]))
             for p in PS_PHASES}
    print(f"  13b mnist_mlp, {PS_WORKERS} worker processes on the card, "
          f"window {PS_WINDOW}, adam 1e-3, batch 64, {r['epochs']} epochs, "
          f"{tag}: center accuracy {acc:.4f} on the {len(test)} held-out "
          f"rows (threshold {GATE_ACC}); {samples} samples in {span:.3f} s "
          f"from the first join to the last commit = {samples / span:.1f} "
          f"samples/s summed over the workers, {commits} commits = "
          f"{commits / span:.2f} commits/s; staleness histogram "
          f"{dict(sorted(s['staleness_hist'].items()))}; commit payload "
          f"{raw} B raw, {wire} B on the wire (ratio {raw / wire:.3f}) on "
          f"{gpu}")
    print(f"    one window's wall, mean over the workers (perf.phase.ps_*): "
          + ", ".join(f"{p[3:]} {v:.3f} ms" for p, v in split.items())
          + f" = {sum(split.values()):.3f} ms; commit round trip p50 / p95 "
          f"/ max per worker: " + ", ".join(
              "{p50:.2f} / {p95:.2f} / {max:.2f} ms".format(**r["commit_ms"])
              for r in res))
    require(acc >= GATE_ACC, f"13b {tag}: center accuracy {acc} < "
                             f"{GATE_ACC}")
    require(len(res) == PS_WORKERS and commits == sum(
        r["commits"] for r in res), f"13b {tag}: commits do not add up")
    return {"acc": acc, "sps": samples / span, "ratio": raw / wire,
            "window_ms": sum(split.values())}


def ps_idle(procs, r, window_ms, gpu):
    """Runs 13b's profiled run ``r`` (:func:`ps_start`), apart from the
    runs that give samples/s and the window split, and prints each
    worker's device idle share over its window cycles: 1 - the device
    time of its whole run (the data's upload to the card included) /
    the wall of its ``perf.phase.ps_*`` spans; and its device time a
    cycle against ``window_ms``, the unprofiled f32 run's window."""
    res, _ = ps_start(procs, r)
    for w in res:
        require(w["busy_ms"] > 0 or not w["device"].startswith("cuda"),
                f"worker {w['rank']}: the profiler saw no device work")
        n = w["commits"] + w["stale_rejections"]
        print(f"    worker {w['rank']} ({w['wid']}, {w['device']}), 1 "
              f"epoch under torch.profiler: {n} window cycles, wall "
              f"{w['windows_ms']:.3f} ms ({w['windows_ms'] / n:.3f} ms a "
              f"cycle), device busy {w['busy_ms']:.3f} ms in {w['ops']} "
              f"operations: idle "
              f"{max(0.0, 1 - w['busy_ms'] / w['windows_ms']):.1%}; "
              f"{w['busy_ms'] / n:.3f} ms busy a cycle against the "
              f"unprofiled f32 window's {window_ms:.3f} ms: idle "
              f"{max(0.0, 1 - w['busy_ms'] / n / window_ms):.1%} on {gpu}")


def ps_card_against_cpu(train, gpu, device):
    """One worker on the card and one on the CPU from the same weights
    (``mnist_mlp(seed=1)``, sgd, f32, no dropout), each alone against its
    own server (staleness 0), 3 windows of 12: the losses and the center
    after each commit held window by window."""
    from dist_keras_tpu_torch.models import mnist_mlp
    from dist_keras_tpu_torch.ps import PSClient, PSServer, PSWorkerTrainer

    class Recorder(PSClient):
        def __init__(self, addr):
            super().__init__(addr)
            self.centers = []

        def commit(self, *a, **kw):
            resp = super().commit(*a, **kw)
            self.centers.append(resp["center"])
            return resp

    data = train.take(PS_WINDOW * PARITY_WINDOWS * 64)
    model, runs = mnist_mlp(seed=1), {}
    for dev in (device, "cpu"):
        srv = PSServer(params=model.params, port=0, window=PS_WINDOW)
        srv.start()
        try:
            rec = Recorder("%s:%d" % srv.address)
            t = PSWorkerTrainer(
                model, client=rec, communication_window=PS_WINDOW,
                worker_optimizer="sgd",
                optimizer_kwargs={"learning_rate": 0.05}, batch_size=64,
                num_epoch=1, features_col="fn", label_col="le",
                device=dev)
            t.train(data)
            runs[dev] = np.asarray(t.get_history()), rec.centers
        finally:
            srv.close()
    (hc, cc), (hh, ch) = runs[device], runs["cpu"]
    require(len(cc) == len(ch) == PARITY_WINDOWS,
            f"card against CPU: {len(cc)} / {len(ch)} windows")
    errs = []
    for k in range(PARITY_WINDOWS):
        w = slice(k * PS_WINDOW, (k + 1) * PS_WINDOW)
        loss = float(np.max(np.abs(hc[w] - hh[w]) / np.abs(hh[w])))
        center = max(float(np.abs(a[key] - b[key]).max()
                           / np.abs(b[key]).max())
                     for a, b in zip(cc[k], ch[k]) for key in b)
        errs.append((loss, center))
    print(f"  13b card against CPU ({PARITY_WINDOWS} windows of "
          f"{PS_WINDOW} sgd steps, f32, TF32 off, one worker each): per "
          f"window, losses' max rel err / center's max err of each leaf's "
          f"largest entry: "
          + ", ".join(f"{a:.3e} / {b:.3e}" for a, b in errs)
          + f" (held to {CARD_CPU_TOL}) on {gpu}")
    require(all(a <= CARD_CPU_TOL and b <= CARD_CPU_TOL for a, b in errs),
            "the card's PS worker disagrees with the CPU's")


def ps_mode(fa, fu, da, gpu, device="cuda", epochs=GATE_EPOCHS):
    """Phase 13: the PS gate on the card (kill and rejoin, drain,
    attribution, chaos), then ``mnist_mlp()`` at full width with 4 worker
    processes sharing the card (uncompressed and int8, ``epochs`` epochs
    each, and a profiled run for the idle share), and card against CPU;
    no hand-written kernel launched in any of its processes."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    def mnist_data():
        train, test = mnist_sets()
        path = os.path.join(work, "mnist.npz")
        np.savez(path, fn=train["fn"], le=train["le"], label=train["label"])
        return train, test, path

    t0 = time.perf_counter()
    zero_kernel_counts(fa, fu, da)
    work = tempfile.mkdtemp(prefix="dk_ps_phase13_")
    procs = PSProcs(work)
    try:
        with ThreadPoolExecutor(1) as pool:
            sets = pool.submit(mnist_data)   # 13b's rows, made during 13a
            print("phase 13a: the PS gate on the card")
            ps_gate(procs, work, gpu, device)
            train, test, data = sets.result()
        print("phase 13b: mnist_mlp at full width, 4 workers sharing the "
              "card")
        # one run after the other, so no run's processes share the host
        # with another's
        plain = ps_mnist(procs, ps_mnist_spawn(procs, work, data, device,
                                               epochs=epochs),
                         test, gpu, device)
        int8 = ps_mnist(procs, ps_mnist_spawn(procs, work, data, device,
                                              compress="int8",
                                              epochs=epochs),
                        test, gpu, device)
        require(int8["ratio"] >= 2.0,
                f"int8 commit payload ratio {int8['ratio']} < 2")
        print(f"  13b int8 against f32: {int8['sps']:.1f} against "
              f"{plain['sps']:.1f} samples/s, accuracy {int8['acc']:.4f} "
              f"against {plain['acc']:.4f}, wire ratio {int8['ratio']:.3f} "
              f"on {gpu}")
        # the profiled run's processes start while the card-against-CPU
        # check runs here, and train after it, at their gate
        profiled = ps_mnist_spawn(procs, work, data, device, profile=True)
        ps_card_against_cpu(train, gpu, device)
        print("  13b device idle share, a run of its own (the runs above "
              "are not profiled):")
        ps_idle(procs, profiled, plain["window_ms"], gpu)
    finally:
        procs.close()
        shutil.rmtree(work, ignore_errors=True)
    counts = kernel_counts(fa, fu, da)
    procs.add_kernels("phase 13's own process", counts)
    print(f"  hand-written kernels launched by phase 13, summed over its "
          f"{len(procs.counted)} processes (this one, every server and "
          f"worker; the SIGKILLed worker up to its last epoch's end): "
          f"{procs.kernels} (none is on this path)")
    require(len(procs.counted) == len(procs.procs) + 1,
            f"{len(procs.procs) + 1 - len(procs.counted)} of phase 13's "
            f"processes reported no launch counters")
    require(not any(procs.kernels.values()),
            f"phase 13 launched a hand-written kernel: {procs.kernels}")
    print(f"  phase 13 wall {time.perf_counter() - t0:.1f} s on {gpu}")


# -- phase 14: the serving fabric ------------------------------------------
FABRIC_KNOBS = {"DK_ROUTE_PROBE_S": "0.05", "DK_ROUTE_STALE_S": "2.0",
                "DK_ROUTE_FAILS": "2", "DK_ROUTE_READMIT_CHECKS": "2"}
FABRIC_ROUNDS = 3          # passes over the prompt set the 14a clients send
FABRIC_CLIENTS = 8
FABRIC_KILL_AFTER = 6      # answered requests before backend 1 is SIGKILLed
FABRIC_TIMING_PASSES = 6   # direct and routed passes over the prompt set
HEDGE_SLOW_S = 0.5         # decode.step delay on the restarted backend 1
SERVE_ROLE_TIMEOUT_S = 240  # the longest any one process of the phase may run
SLO_ENV = {"DK_SLO": "1", "DK_SLO_TTFT_S": "1e-6", "DK_OBS_SAMPLE_S": "0.2",
           "DK_TRACE_RETAIN": "1", "DK_TRACE_RETAIN_SLOW_S": "0.01"}
# gates.py's router gate, autoscale mode: the serve.pending values fed
# before each tick, and the (action, replicas) the JAX package's
# ReplicaAutoscaler answers tick by tick (tests/test_torch_autoscale.py
# holds the port to the same sequence)
GATE_RING = ((1.0, 3.0, 6.0, 9.0, 10.0)
             + (3.0, 7.0, 2.5, 6.0, 3.5, 7.5)
             + (8.0, 9.0, 10.0, 11.0, 12.0)
             + (1.0, 1.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
             + (0.0, 0.0, 0.0, 0.0))
GATE_TICKS = ([(None, 1)] * 3 + [("up", 2)] + [(None, 2)] * 8
              + [("up", 3)] + [(None, 3)] * 5 + [("down", 2)]
              + [(None, 2)] * 3 + [("down", 1)] + [(None, 1)] * 6)
GATE_KW = dict(floor=1, ceiling=3, depth_high=8.0, samples=4,
               clear_checks=3, cooldown_checks=1, step=1)
BENCH_DECODE_S, BENCH_SURV_S, BENCH_PREDICT_S = 8.0, 6.0, 4.0


def serve_role(cfg):
    """A decode backend of phase 14, started by :class:`FabricProcs`: the
    full-width model (seed 0) in a ``DecodeEngine`` behind a
    ``ServingServer`` on ``cfg["port"]`` (0: a free one, published to a
    file); SIGTERM drains it (exit 143, ``SERVE_DONE {json}`` with its KV
    pages in use and leaked).  Its K1-K5 launch counters print as
    ``SERVE_KERNELS {json}`` every 0.2 s and at its end, so a SIGKILLed
    backend's last line still counts."""
    sys.path.insert(0, str(ROOT))
    from dist_keras_tpu_torch.models.transformer import (
        Transformer,
        transformer_config,
    )
    from dist_keras_tpu_torch.ops import decode_attention as da
    from dist_keras_tpu_torch.ops import flash_attention as fa
    from dist_keras_tpu_torch.ops import fused_bwd_experimental as fu
    from dist_keras_tpu_torch.resilience.preemption import Preempted
    from dist_keras_tpu_torch.serving import DecodeEngine, ServingServer

    zero_kernel_counts(fa, fu, da)
    stop = threading.Event()

    def counters():
        write_kernel_counts("SERVE_KERNELS", fa, fu, da)

    def beat():
        while not stop.wait(0.2):
            counters()

    dev = cfg["device"]
    model = Transformer(transformer_config(**cfg["model"]), seed=0,
                        device=dev)
    engine = DecodeEngine(model, prefill_ladder=tuple(cfg["prefill"]),
                          decode_ladder=tuple(cfg["decode"]),
                          page_size=cfg["page_size"],
                          max_new_default=cfg["max_new"], device=dev)
    srv = ServingServer(engine, port=cfg["port"],
                        request_timeout_s=SERVE_ROLE_TIMEOUT_S)
    srv.install_signal_drain(poll_s=0.02)
    threading.Thread(target=beat, daemon=True).start()
    host, port = srv.address
    path = Path(cfg["work"]) / f"addr_{cfg['label']}"
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(f"{host}:{port}")
    os.replace(tmp, path)
    try:
        srv.run_forever()
    except Preempted:
        st = engine.stats()
        write_record("SERVE_DONE " + json.dumps({
            "kv_used": engine.kv_stats()["used_pages"],
            "leaked": engine.self_check(), "completed": st["completed"],
            "cancelled": st["cancelled"], "shed": st["shed"],
            "errors": st["errors"]}))
        raise
    finally:
        stop.set()
        counters()
    return 0


class FabricProcs(RoleProcs):
    """Phase 14's decode backends (``--serve-role``)."""

    def __init__(self, work, device, model_cfg):
        super().__init__(work, "--serve-role", "SERVE_KERNELS",
                         SERVE_ROLE_TIMEOUT_S)
        self.device = device
        self.model_cfg = model_cfg

    def backend(self, label, port=0, **env):
        (self.work / f"addr_{label}").unlink(missing_ok=True)
        return self.spawn(label, {
            "label": label, "work": str(self.work), "port": port,
            "device": self.device, "model": self.model_cfg,
            "prefill": PREFILL_LADDER, "decode": DECODE_LADDER,
            "page_size": PAGE_SIZE, "max_new": MAX_NEW}, **env)

    def address(self, p):
        path = self.work / f"addr_{p.label}"
        t0 = time.perf_counter()
        while not path.exists():
            require(p.poll() is None,
                    f"{p.label} died: {self.output(p)[-600:]}")
            require(time.perf_counter() - t0 < SERVE_ROLE_TIMEOUT_S,
                    f"{p.label} published no address")
            time.sleep(0.02)
        return path.read_text().strip()

    def drain(self, p):
        """The backend's drain -> its ``SERVE_DONE`` record."""
        out = self.terminate(p)
        m = re.search(r"^SERVE_DONE (.*)$", out, re.M)
        require(m, f"{p.label}: no SERVE_DONE line")
        return json.loads(m.group(1))


def http_call(addr, path, body=None, headers=None,
              timeout=SERVE_ROLE_TIMEOUT_S):
    """-> (status, headers, text): an HTTP error status is an answer; a
    transport failure raises."""
    host, port = addr.rsplit(":", 1)
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})},
        method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def classify_generate(status, headers, text, want, stream):
    """A /generate answer through the fabric -> "ok" (200, oracle-equal
    tokens), "typed" (503 with Retry-After and an error document) or
    "lost" (a stream's final ``backend_stream_lost`` record); anything
    else fails."""
    if status == 503:
        doc = json.loads(text)
        require("error" in doc and headers.get("Retry-After") is not None,
                f"an untyped 503: {headers} {text[:200]}")
        return "typed"
    require(status == 200, f"/generate answered {status}: {text[:200]}")
    if stream:
        lines = [json.loads(x) for x in text.splitlines() if x.strip()]
        require(lines and lines[-1].get("done"), "a stream without its end")
        if "error" in lines[-1]:
            require(lines[-1]["error"] == "backend_stream_lost"
                    and lines[-1].get("retryable") is True,
                    f"a stream ended with {lines[-1]}")
            return "lost"
        got = [x["token"] for x in lines[:-1]]
    else:
        got = json.loads(text)["generated"]
    require(got == want, f"tokens differ from the oracle: {got} != {want}")
    return "ok"


def kv_of(addr):
    doc = json.loads(http_call(addr, "/metricsz")[2])["engine"]
    return doc["kv"]["used_pages"], doc["outstanding"], doc["cancelled"]


def introspection_routes(addr, label, device):
    """/statusz, /tracez and the Prometheus scrape, each 200; /statusz
    names torch, and the card where the process runs on one."""
    out = {}
    for path in ("/statusz", "/tracez", "/metricsz?format=prometheus"):
        status, headers, text = http_call(addr, path)
        require(status == 200, f"{label} {path} answered {status}")
        out[path] = text
    build = json.loads(out["/statusz"])["build"]
    require(build["torch"] and (build["device"] or device == "cpu"),
            f"{label} /statusz build block: {build}")
    return out


def percentile_ms(xs, q):
    return float(np.percentile(np.asarray(xs) * 1e3, q))


def serving_fabric(fa, fu, da, gpu, device="cuda", model_cfg=MODEL,
                   prompt_lens=PROMPT_LENS, benches=True):
    """Phase 14.  -> the K1-K5 launches its backends made in 14a."""
    import shutil
    import tempfile

    import torch

    from dist_keras_tpu_torch.checkpoint import MANIFEST_NAME, Checkpointer
    from dist_keras_tpu_torch.data.dataset import Dataset
    from dist_keras_tpu_torch.models import mnist_mlp
    from dist_keras_tpu_torch.models.transformer import (
        Transformer,
        apply_block,
        layer_norm,
        transformer_config,
    )
    from dist_keras_tpu_torch.observability import (
        events,
        flight,
        metrics,
        report,
        spans,
        timeseries,
        trace_export,
    )
    from dist_keras_tpu_torch.ops.attention import attention
    from dist_keras_tpu_torch.serving import (
        BlueGreenEngine,
        CheckpointWatcher,
        ReplicaAutoscaler,
        RouterServer,
        ServingEngine,
    )
    from dist_keras_tpu_torch.serving import bench as serving_bench
    from dist_keras_tpu_torch.trainers import SingleTrainer
    from dist_keras_tpu_torch.utils.pytree import tree_map

    t_phase = time.perf_counter()
    dev = torch.device(device)
    work = Path(tempfile.mkdtemp(prefix="dk_fabric_phase14_"))
    obs, obs_slo = work / "obs", work / "obs_slo"
    procs = FabricProcs(work, device, model_cfg)
    saved_env = {k: os.environ.get(k) for k in
                 [*FABRIC_KNOBS, "DK_OBS_DIR", "DK_COORD_RANK"]}
    zero_kernel_counts(fa, fu, da)
    srv = None
    try:
        # the backends come up while the parent computes the oracle
        b0 = procs.backend("b0", DK_OBS_DIR=str(obs), DK_COORD_RANK="0")
        b1 = procs.backend("b1", DK_OBS_DIR=str(obs), DK_COORD_RANK="1")
        c = procs.backend("slo", DK_OBS_DIR=str(obs_slo), DK_COORD_RANK="2",
                        **SLO_ENV)
        rng = np.random.default_rng(14)
        prompts = [rng.integers(0, model_cfg["input_dim"], size=n).tolist()
                   for n in prompt_lens]
        model = Transformer(transformer_config(**model_cfg), seed=0,
                            device=dev)
        with torch.inference_mode():
            oracle = [oracle_generate(model.params, p, MAX_NEW, attention,
                                      apply_block, layer_norm)[0]
                      for p in prompts]
        del model
        a0, a1, ac = (procs.address(p) for p in (b0, b1, c))
        print(f"  backends up in {time.perf_counter() - t_phase:.1f} s "
              f"(oracle computed meanwhile): {a0}, {a1}, slo {ac}")

        # -- 14a: the fabric over /generate --------------------------------
        print("phase 14a: RouterServer over two /generate backends")
        os.environ.update(FABRIC_KNOBS)
        os.environ["DK_OBS_DIR"] = str(obs)
        os.environ["DK_COORD_RANK"] = "7"
        for mod in (events, flight, spans, timeseries):
            mod.reset()
        srv = RouterServer([a0, a1], port=0)
        raddr = "%s:%d" % srv.start()
        for a in (a0, a1):   # warm each backend directly
            status, _, _ = http_call(a, "/generate", {
                "tokens": prompts[0], "max_new_tokens": 2})
            require(status == 200, f"warm-up on {a} answered {status}")
        # each prompt direct and routed back to back, the order
        # alternating by pass: the difference is read per pair, and per
        # router path (the plain forward until route.forward_s holds 20
        # samples, then the hedge-eligible one, which rides the
        # backend's stream)
        direct, routed, ttft, per_token = [], [], [], []
        diff = {"plain": {}, "hedge-eligible": {}}
        for k in range(FABRIC_TIMING_PASSES):
            for n, p, want in zip(prompt_lens, prompts, oracle):
                body = {"tokens": p, "max_new_tokens": MAX_NEW}
                pair = {}
                for addr in ((a0, raddr) if k % 2 == 0 else (raddr, a0)):
                    if addr == raddr:
                        path = ("plain" if srv._hedge_delay() is None
                                else "hedge-eligible")
                    t0 = time.perf_counter()
                    out = http_call(addr, "/generate", body)
                    pair[addr] = time.perf_counter() - t0
                    require(classify_generate(*out, want, False) == "ok",
                            "a timed /generate was not oracle-equal")
                    if addr == a0:
                        doc = json.loads(out[2])
                        ttft.append(doc["ttft_s"])
                        per_token.append((pair[a0] - doc["ttft_s"])
                                         / max(1, doc["steps"]))
                direct.append(pair[a0])
                routed.append(pair[raddr])
                diff[path].setdefault(n, []).append(pair[raddr] - pair[a0])
        print(f"  /generate over the prompt set {list(prompt_lens)}, "
              f"{MAX_NEW} tokens, one at a time, {FABRIC_TIMING_PASSES} "
              f"passes, direct and routed back to back ({len(direct)} "
              f"each): direct p50 {percentile_ms(direct, 50):.3f} ms / max "
              f"{max(direct) * 1e3:.3f} ms; routed p50 "
              f"{percentile_ms(routed, 50):.3f} ms / max "
              f"{max(routed) * 1e3:.3f} ms on {gpu}")
        for path, by_len in diff.items():
            pairs = [d for ds in by_len.values() for d in ds]
            require(pairs, f"no timed request took the {path} path")
            print(f"  routed minus direct on the {path} path, paired per "
                  f"prompt and pass ({len(pairs)} pairs): median "
                  f"{percentile_ms(pairs, 50):.3f} ms, p25 "
                  f"{percentile_ms(pairs, 25):.3f} / p75 "
                  f"{percentile_ms(pairs, 75):.3f} ms, min "
                  f"{min(pairs) * 1e3:.3f} / max {max(pairs) * 1e3:.3f} "
                  f"ms; median per prompt length "
                  f"{ {n: round(percentile_ms(ds, 50), 3) for n, ds in by_len.items()} }")
        print(f"  direct, where the time goes: TTFT (queue + prefill) p50 "
              f"{percentile_ms(ttft, 50):.2f} ms / max "
              f"{max(ttft) * 1e3:.2f} ms; after it, "
              f"{percentile_ms(per_token, 50):.3f} ms a decode step (p50; "
              f"the host's wall, HTTP and JSON included)")

        jobs = [(i, r) for r in range(FABRIC_ROUNDS)
                for i in range(len(prompts))]
        results, errors = [], []
        lock = threading.Lock()
        answered = threading.Event()

        def client(k):
            for n, (i, r) in enumerate(jobs):
                if n % FABRIC_CLIENTS != k:
                    continue
                stream = (n % 5 == 3)
                body = {"tokens": prompts[i], "max_new_tokens": MAX_NEW,
                        "stream": stream}
                headers = {}
                if n % 3 == 1:
                    body["deadline_s"] = 120.0
                if n % 4 == 2:
                    headers["x-dk-priority"] = "interactive"
                with spans.span("serve.client"):
                    ctx = spans.capture()
                    headers["traceparent"] = spans.traceparent(ctx)
                    try:
                        out = http_call(raddr, "/generate", body, headers)
                        verdict = classify_generate(*out, oracle[i], stream)
                    except Exception as e:   # noqa: BLE001 - reported
                        with lock:
                            errors.append(f"{type(e).__name__}: {e}")
                        continue
                with lock:
                    results.append((ctx.trace_id, verdict, stream))
                    if sum(v == "ok" for _, v, _ in results) \
                            >= FABRIC_KILL_AFTER:
                        answered.set()

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(FABRIC_CLIENTS)]
        t_load = time.perf_counter()
        for t in threads:
            t.start()
        require(answered.wait(SERVE_ROLE_TIMEOUT_S),
                f"no {FABRIC_KILL_AFTER} answers before the kill: {errors}")
        port1 = int(a1.rsplit(":", 1)[1])
        t_kill = time.perf_counter()
        procs.kill(b1)
        stale_s = float(FABRIC_KNOBS["DK_ROUTE_STALE_S"])
        while {b["addr"]: b for b in srv.pool.snapshot()}[a1]["live"]:
            require(time.perf_counter() - t_kill < 30,
                    "the killed backend was never evicted")
            time.sleep(0.005)
        evict_s = time.perf_counter() - t_kill
        for t in threads:
            t.join(timeout=SERVE_ROLE_TIMEOUT_S)
        load_s = time.perf_counter() - t_load
        require(not any(t.is_alive() for t in threads), "a client hung")
        require(not errors, f"transport errors at the clients: {errors}")
        verdicts = [v for _, v, _ in results]
        print(f"  {len(jobs)} concurrent requests from {FABRIC_CLIENTS} "
              f"clients in {load_s:.2f} s, backend 1 SIGKILLed after "
              f"{FABRIC_KILL_AFTER} answers: {verdicts.count('ok')} x 200 "
              f"oracle-equal, {verdicts.count('typed')} typed 503, "
              f"{verdicts.count('lost')} backend_stream_lost; evicted "
              f"{evict_s * 1e3:.1f} ms after the kill (DK_ROUTE_STALE_S "
              f"{stale_s})")
        require(len(results) == len(jobs), "a request got no answer")
        require(evict_s <= stale_s, f"eviction took {evict_s:.3f} s")

        b1r = procs.backend("b1r", port=port1, DK_OBS_DIR=str(obs),
                          DK_COORD_RANK="1",
                          DK_FAULTS=f"decode.step@0x100000000:action=delay,"
                                    f"value={HEDGE_SLOW_S}")
        procs.address(b1r)
        t_up = time.perf_counter()
        while srv.pool.live_count() < 2:
            require(time.perf_counter() - t_up < SERVE_ROLE_TIMEOUT_S,
                    "the restarted backend was never re-admitted")
            time.sleep(0.01)
        print(f"  backend 1 restarted on port {port1}: re-admitted "
              f"{(time.perf_counter() - t_up) * 1e3:.1f} ms after it "
              f"listened (DK_ROUTE_READMIT_CHECKS "
              f"{FABRIC_KNOBS['DK_ROUTE_READMIT_CHECKS']}); evictions "
              f"{srv.pool.evictions}, readmissions {srv.pool.readmissions}")
        require(srv.pool.evictions >= 1 and srv.pool.readmissions >= 1,
                "the pool recorded no eviction or no re-admission")

        # a hedged /generate through the router's HTTP entry, from a
        # client span: the slow restarted backend is forced as the
        # primary, the hedge budget admits the hedge on its own
        delay = srv._hedge_delay()
        require(delay is not None, "hedging is not armed")
        budget = srv._hedge_budget
        earned = 0   # 14a's hedges may have spent it: one-token requests
        while budget.tokens() + budget.ratio < 1.0:   # earn it back
            require(earned < 20, "the hedge budget earns nothing")
            out = http_call(raddr, "/generate", {"tokens": prompts[0],
                                                 "max_new_tokens": 1})
            require(out[0] == 200, f"a one-token /generate answered "
                                   f"{out[0]}")
            earned += 1
        tokens0 = budget.tokens()
        hedges = metrics.counter("route.hedges")
        wins = metrics.counter("route.hedge_wins")
        h0, w0 = hedges.value, wins.value
        real_pick = srv.pool.pick
        srv.pool.pick = (lambda exclude=(): a1 if not exclude
                         else real_pick(exclude=exclude))
        try:
            with spans.span("serve.client"):
                hedge_ctx = spans.capture()
                out = http_call(raddr, "/generate", {
                    "tokens": prompts[1], "max_new_tokens": MAX_NEW},
                    {"traceparent": spans.traceparent(hedge_ctx)})
        finally:
            srv.pool.pick = real_pick
        require(classify_generate(*out, oracle[1], False) == "ok",
                "the hedged /generate was not oracle-equal")
        require(hedges.value == h0 + 1 and wins.value == w0 + 1,
                f"the hedge did not fire or did not win (budget "
                f"{tokens0} tokens before)")
        tokens1 = budget.tokens()
        require(abs(tokens1 - (min(budget.cap, tokens0 + budget.ratio)
                               - 1.0)) < 1e-9,
                f"the budget went {tokens0} -> {tokens1}")
        t_c = time.perf_counter()
        while kv_of(a1)[:2] != (0, 0):
            require(time.perf_counter() - t_c < 30,
                    f"the hedge's loser kept its pages: {kv_of(a1)}")
            time.sleep(0.02)
        used1, _, cancelled = kv_of(a1)
        print(f"  hedged POST /generate at the router: primary = the "
              f"restarted backend (decode.step +{HEDGE_SLOW_S} s), hedge "
              f"after {delay * 1e3:.1f} ms admitted by the budget "
              f"({tokens0:.2f} -> {tokens1:.2f} tokens; {earned} one-token "
              f"requests earned it first) won, "
              f"oracle-equal; the loser cancelled ({cancelled}) and its "
              f"pages back at {used1} within "
              f"{(time.perf_counter() - t_c) * 1e3:.1f} ms")
        require(cancelled >= 1, "the hedge's loser was not cancelled")
        for addr, label in ((a0, "backend 0"), (a1, "backend 1"),
                            (raddr, "router")):
            introspection_routes(addr, label, device)
        srv.close()
        srv = None
        done = [procs.drain(p) for p in (b0, b1r)]
        for d in done:
            require(d["kv_used"] == 0 and d["leaked"] == 0,
                    f"KV pages left after the drain: {d}")
        launches = dict(procs.kernels)
        print(f"  drained: {done}; K1-K5 launches summed over the 3 "
              f"backend processes: {launches}")
        require(device == "cpu" or (launches["flash_fwd"] > 0
                                    and launches["paged_decode"] > 0),
                "flash_fwd or paged_decode never launched on the backends")
        require(launches["flash_bwd_dq"] == launches["flash_bwd_dkv"]
                == launches["flash_bwd_fused"] == 0,
                "a training kernel launched on the serving path")
        events.reset()
        recs = report.read_events(str(obs))
        by = {}
        for r in recs:
            if r.get("kind") == "span_end":
                by.setdefault(r.get("trace_id"), []).append(r)
        def chain(trace, ranks):
            """client -> route.forward -> serve.generate on one of
            ``ranks`` -> a replica stage, in ``trace``."""
            sp = by.get(trace, [])
            ids = {x["span_id"]: x for x in sp}

            def under(x, name):
                return ids.get(x["parent_id"], {}).get("span") == name

            return (any(x["span"] == "serve.client" for x in sp)
                    and any(x["span"] == "route.forward"
                            and under(x, "serve.client") for x in sp)
                    and any(x["span"] == "serve.generate"
                            and under(x, "route.forward")
                            and x["rank"] in ranks for x in sp)
                    and any(x["span"] in ("serve.prefill", "serve.queue_wait")
                            and under(x, "serve.generate")
                            and x["rank"] in ranks for x in sp)), sp

        stitched, broken = 0, []
        for trace, verdict, _ in results:
            if verdict != "ok":
                continue
            ok, sp = chain(trace, (0, 1))
            if ok:
                stitched += 1
            else:
                broken.append([(x["span"], x["rank"], x["span_id"],
                                x["parent_id"]) for x in sp])
        n_ok = verdicts.count("ok")
        ct = trace_export.connected_traces(recs)
        connected = sum(1 for t, v, _ in results
                        if v == "ok" and ct.get(t, {}).get("connected"))
        hedge_ok, hedge_sp = chain(hedge_ctx.trace_id, (0,))
        print(f"  stitched traces (client -> route.forward -> "
              f"serve.generate -> replica stage): {stitched} of {n_ok} "
              f"answered requests; {connected} fully connected; the "
              f"hedged request's winner on backend 0 stitched: {hedge_ok}")
        require(stitched == n_ok, f"answered requests without a stitched "
                                  f"trace: {broken[:2]}")
        require(hedge_ok, f"the hedge's winner is not stitched under "
                          f"route.forward: {[(x['span'], x['rank']) for x in hedge_sp]}")

        # -- 14b: /predict blue/green and the checkpoint watcher -----------
        print("phase 14b: BlueGreenEngine + CheckpointWatcher over "
              "mnist_mlp() on the card")
        mlp = mnist_mlp(seed=0)
        bg = BlueGreenEngine(lambda: ServingEngine(
            mlp, replicas=1, batch_ladder=SERVE_LADDER, max_queue=100000,
            device=device))
        ck = Checkpointer(str(work / "ck"))
        w = CheckpointWatcher(bg, ck, poll_s=0.02, initial_step=0).start()
        rows = np.random.default_rng(15).normal(
            size=(64, 784)).astype(np.float32)
        futs, stop = [], threading.Event()

        def submitter():
            i = 0
            while not stop.is_set():
                futs.append(bg.submit(rows[i % len(rows)]))
                i += 1
                time.sleep(0.0005)

        def plain(params):
            with torch.inference_mode():
                return mlp.apply(tree_map(lambda a: a.to(dev), params),
                                 torch.from_numpy(rows[:16]).to(dev)
                                 ).cpu().numpy()

        def served(step, params, what):
            t0 = time.perf_counter()
            while w.reloads < step:
                require(time.perf_counter() - t0 < 60,
                        f"cutover {step} never happened (watcher errors "
                        f"{w.errors})")
                time.sleep(0.01)
            err = logits_err(bg.predict(rows[:16], timeout_s=60),
                             plain(params))
            print(f"  cutover {step}: {what} served "
                  f"{(time.perf_counter() - t0) * 1e3:.1f} ms after its "
                  f"commit; predictions against the plain forward of its "
                  f"params on the card: {err:.3e} (tol {SERVE_TOL:g})")
            require(err <= SERVE_TOL, "blue/green serves wrong params")

        loader = threading.Thread(target=submitter)
        loader.start()
        try:
            time.sleep(0.2)
            state = {"params": tree_map(lambda a: a.detach() * 0.5,
                                        mlp.params)}
            ck.save(1, state).wait()
            served(1, state["params"], "step 1 ({params})")
            # a real training directory: a SingleTrainer on the card
            # saves {params, opt_state, rng, t_units} into it
            trained = SingleTrainer(
                mnist_mlp(seed=0), loss="categorical_crossentropy",
                worker_optimizer="adam", batch_size=16, num_epoch=1,
                features_col="x", label_col="y", seed=3,
                checkpoint_dir=str(work / "ck"), device=device).train(
                Dataset({"x": rows, "y": np.eye(10, dtype=np.float32)[
                    np.arange(len(rows)) % 10]}))
            step = ck.latest_step()
            keys = sorted(ck.restore(step=step, verify=False)[1])
            require(keys == ["opt_state", "params", "rng", "t_units"],
                    f"the trainer saved {keys}")
            params = tree_map(lambda a: a.detach(), trained.params)
            served(2, params, f"the SingleTrainer's step {step} ({keys})")
            w.stop()
            ck.save(step + 1, {"params": mlp.params}).wait()
            files = [f for f in (work / "ck" / f"step_{step + 1:08d}")
                     .rglob("*") if f.is_file() and f.name != MANIFEST_NAME]
            big = max(files, key=lambda f: f.stat().st_size)
            with open(big, "r+b") as f:
                b = f.read(1)
                f.seek(0)
                f.write(bytes([b[0] ^ 0xFF]))
            require(w.poll_once() is None and w.skipped_corrupt == 1,
                    "the corrupt step was not skipped")
            got = bg.predict(rows[:16], timeout_s=60)
            require(logits_err(got, plain(params)) <= SERVE_TOL
                    and bg.cutovers == 2,
                    "the corrupt step touched the serving color")
        finally:
            stop.set()
            loader.join(timeout=60)
        done_rows = [f.result(timeout=120) for f in futs]
        st = [e.stats() for e in (bg.active, bg.standby)]
        print(f"  {len(futs)} requests submitted across 2 cutovers and a "
              f"skipped corrupt step: {len(done_rows)} answered, errors "
              f"{[s['errors'] for s in st]}, cutovers {bg.cutovers}, "
              f"active color {bg.stats()['active_engine']}")
        require(len(done_rows) == len(futs) > 100
                and all(s["errors"] == 0 for s in st),
                "blue/green lost or failed a request")
        timeseries.reset()
        a = ReplicaAutoscaler(bg, **GATE_KW)
        ring = timeseries.series("serve.pending")
        ticks = []
        for v in GATE_RING:
            ring.append(v)
            ticks.append((a.tick(), bg.stats()["replicas"]))
        print(f"  autoscaler over the gate's ring: {ticks} "
              f"(resizes {a.resizes}); standby at "
              f"{bg.standby.stats()['replicas']} replicas")
        require(ticks == GATE_TICKS, "the autoscaler's ticks differ from "
                                     "the JAX gate's")
        require(bg.predict(rows[:4], timeout_s=60).shape == (4, 10),
                "the resized engine does not serve")
        bg.close()
        timeseries.reset()

        # -- 14c: the SLO plane --------------------------------------------
        print("phase 14c: DK_SLO shedding, /statusz, /tracez, the scrape, "
              "the drain's flight dump")
        for p, want in list(zip(prompts, oracle))[:2]:
            out = http_call(ac, "/generate", {"tokens": p,
                                              "max_new_tokens": MAX_NEW})
            require(classify_generate(*out, want, False) == "ok",
                    "the SLO backend served wrong tokens")
        t_shed = time.perf_counter()
        while True:
            status, _, text = http_call(ac, "/generate", {
                "tokens": prompts[0], "max_new_tokens": 4,
                "priority": "batch"})
            if status == 503 and json.loads(text).get("reason") \
                    == "shed_batch":
                break
            require(status == 200, f"a batch request answered {status}")
            require(time.perf_counter() - t_shed < 30,
                    "batch work was never shed under DK_SLO")
            http_call(ac, "/generate", {"tokens": prompts[0],
                                        "max_new_tokens": 2})
            time.sleep(0.1)
        slz = json.loads(http_call(ac, "/statusz")[2])["slz"]
        firing = sorted(o["objective"] for o in slz["objectives"]
                        if o.get("firing"))
        print(f"  batch shed as shed_batch "
              f"{(time.perf_counter() - t_shed) * 1e3:.1f} ms into the "
              f"burn; firing objectives {firing}")
        require("generate_ttft" in firing, "the TTFT objective is not "
                                           "firing")
        for p, want in list(zip(prompts, oracle))[2:5]:
            out = http_call(ac, "/generate", {"tokens": p,
                                              "max_new_tokens": MAX_NEW})
            require(classify_generate(*out, want, False) == "ok",
                    "interactive work was not served oracle-equal")
        routes = introspection_routes(ac, "SLO backend", device)
        exemplars = set(re.findall(r'^# \{span_id="[0-9a-f]+",trace_id="'
                                   r'([0-9a-f]+)"\}',
                                   routes["/metricsz?format=prometheus"],
                                   re.M))
        tz = json.loads(routes["/tracez"])
        done_c = procs.drain(c)
        recs = report.read_events(str(obs_slo))
        kept = {r.get("trace_id") for r in recs if r.get("trace_id")}
        dumps = sorted(obs_slo.glob("flightrec-*-preempt.json"))
        cli = subprocess.run(
            [sys.executable, "-m", "dist_keras_tpu_torch.observability",
             str(obs_slo), "--dumps", "--traces"], cwd=str(ROOT),
            capture_output=True, text=True, timeout=120)
        print(f"  scrape exemplars {len(exemplars)}, all on retained "
              f"traces {exemplars <= kept}; /tracez ring "
              f"{tz['n']} records; drain {done_c}; preempt "
              f"dumps {[d.name for d in dumps]}; `python -m "
              f"dist_keras_tpu_torch.observability --dumps --traces` rc "
              f"{cli.returncode}: {cli.stdout.splitlines()[:1]}")
        require(exemplars and exemplars <= kept,
                "the scrape's exemplars do not resolve to retained traces")
        require(done_c["shed"] >= 1 and done_c["kv_used"] == 0,
                f"the SLO backend's drain: {done_c}")
        require(dumps and cli.returncode == 0 and "ok " in cli.stdout,
                f"the drain's flight dump does not read back: "
                f"{cli.stdout[-300:]} {cli.stderr[-300:]}")
        total = dict(procs.kernels)
        total.update({k: total[k] + v
                      for k, v in kernel_counts(fa, fu, da).items()})
        require(total["flash_bwd_dq"] == total["flash_bwd_dkv"]
                == total["flash_bwd_fused"] == 0,
                "a training kernel launched in phase 14")

        # -- 14d: the offered-load serving benchmark -----------------------
        if benches:
            print("phase 14d: serving/bench.py on the card")
            widths = dict(vocab=model_cfg["input_dim"],
                          seq_len=model_cfg["seq_len"],
                          d_model=model_cfg["d_model"],
                          n_heads=model_cfg["n_heads"],
                          n_layers=model_cfg["n_layers"],
                          prefill_ladder=PREFILL_LADDER,
                          decode_ladder=DECODE_LADDER, page_size=PAGE_SIZE,
                          device=device)

            def bench(name, run, decode, what):
                """One bench record on this process, its own K1-K5
                launches counted from 0: K1 and K5 on a decode bench,
                none on the predict bench, K2-K4 never."""
                zero_kernel_counts(fa, fu, da)
                rec = run()
                n = kernel_counts(fa, fu, da)
                print(f"  {name} bench ({what}; {gpu}): {json.dumps(rec)}; "
                      f"its launches {n}")
                require(n["flash_bwd_dq"] == n["flash_bwd_dkv"]
                        == n["flash_bwd_fused"] == 0,
                        f"the {name} bench launched a training kernel")
                if decode:
                    require(device == "cpu" or (n["flash_fwd"] > 0
                                                and n["paged_decode"] > 0),
                            f"the {name} bench did not run K1 and K5: {n}")
                else:
                    require(not any(n.values()),
                            f"the {name} bench launched a kernel: {n}")
                return rec

            rec = bench("decode", lambda: serving_bench.run_decode_benchmark(
                duration_s=BENCH_DECODE_S, replicas=2, **widths), True,
                f"{BENCH_DECODE_S} s, 2 replicas, phase 5's widths and "
                f"ladders")
            require(rec["errors"] == 0 and rec["completed"]
                    == rec["submitted"] > 0 and rec["retrace_count"]
                    <= rec["retrace_bound"], "the decode bench failed")
            rec = bench("survivability",
                        lambda: serving_bench.run_survivability_benchmark(
                            duration_s=BENCH_SURV_S, **widths), True,
                        f"{BENCH_SURV_S} s, the JAX CLI's 4 s lengthened; "
                        f"replica 0 killed at a third")
            require(rec["errors"] == 0 and rec["kv_leaked_pages"] == 0
                    and rec["quarantines"] == 1,
                    "the survivability bench failed")
            rec = bench("predict", lambda: serving_bench.run_serving_benchmark(
                duration_s=BENCH_PREDICT_S, feature_dim=784,
                hidden=(500, 225), num_classes=10, device=device), False,
                f"mnist_mlp()'s widths, {BENCH_PREDICT_S} s, the bench's "
                f"default")
            require(rec["errors"] == 0
                    and rec["completed"] == rec["submitted"] > 0,
                    "the predict bench failed")
        print(f"  phase 14 wall {time.perf_counter() - t_phase:.1f} s on "
              f"{gpu}")
        return launches
    finally:
        if srv is not None:
            srv.close()
        procs.close()
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for mod in (events, flight, spans):
            mod.reset()
        shutil.rmtree(work, ignore_errors=True)


# -- phase 15: the data path on the card ------------------------------------
# examples/mnist.py's load_mnist sets, bench_adag_streamed's and
# bench_adag_mnist_cnn's shapes; a rehearsal on the CPU passes smaller ones
PHASE15 = dict(
    csv_rows=(8192, 2048), csv_epochs=3, gate=GATE_ACC,
    mlp_rows=1048576, mlp_feat=8, mlp_hidden=(4096,) * 6, mlp_batch=512,
    mlp_window=8, mlp_chunk=32, mlp_epochs=2, mlp_runs=BENCH_RUNS,
    cnn_batch=ADAG_BENCH_BATCH, cnn_steps=ADAG_BENCH_STEPS,
    cnn_seconds=4.0, budget=4 << 20, stream_batch=256)
# the full run's cut of 15b (one streamed and one resident run of one
# epoch, a shorter CNN pair): every check stays, only repeats and run
# lengths shrink; ``--phase15`` runs PHASE15's full sizes
PROOF15 = dict(mlp_runs=1, mlp_epochs=1, cnn_seconds=2.0)
STREAM_PARITY = 0.9   # bench.py's streamed / resident target: recorded
STREAM_TOL = 1e-5     # StreamingPredictor against ModelPredictor (f32)


def strict_dispatch():
    """A context in which every chunk's dispatch and every ``ChunkFeed.
    get`` run under ``set_sync_debug_mode("error")``: a host sync inside
    either fails the run.  The retire's loss fetch and the prefetch's
    staging copy stay outside."""
    import contextlib

    import torch

    from dist_keras_tpu_torch.data import feed as feed_mod
    from dist_keras_tpu_torch.trainers import chunking

    def strict(fn):
        def call(*args, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return call

    @contextlib.contextmanager
    def patched():
        run, get = chunking.ChunkRunner.run, feed_mod.ChunkFeed.get

        def guarded_run(self, dispatch, *args, **kw):
            return run(self, strict(dispatch), *args, **kw)

        chunking.ChunkRunner.run = guarded_run
        feed_mod.ChunkFeed.get = strict(get)
        try:
            yield
        finally:
            chunking.ChunkRunner.run, feed_mod.ChunkFeed.get = run, get
    return patched()


def params_bit_equal(a, b):
    return all(np.array_equal(x, y) for x, y in
               zip(a.get_weights(), b.get_weights()))


def csv_flow(work, gpu, device, p):
    """15a: ``load_mnist``'s sets written with ``to_csv`` and read back
    with ``Dataset.from_csv`` (the native reader, against ``np.loadtxt``),
    then the reference's transformer chain, ADAG on the MNIST CNN
    streamed one window a chunk, and predictor -> label index ->
    accuracy; the streamed run bit-equal to the resident one under
    deterministic algorithms.  -> (the streamed model, the test set, the
    training set), both sets through the transformers."""
    import warnings

    from dist_keras_tpu_torch.data import (
        Dataset,
        MinMaxTransformer,
        OneHotTransformer,
        ReshapeTransformer,
    )
    from dist_keras_tpu_torch.data import csv as csv_mod
    from dist_keras_tpu_torch.data import native
    from dist_keras_tpu_torch.data.synthetic import synthetic_mnist, to_csv
    from dist_keras_tpu_torch.models import mnist_cnn
    from dist_keras_tpu_torch.trainers import ADAG

    paths, t0 = {}, time.perf_counter()
    for split, n, seed in zip(("train", "test"), p["csv_rows"], (0, 1)):
        paths[split] = os.path.join(work, f"mnist_{split}_{n}.csv")
        to_csv(synthetic_mnist(n, seed=seed), paths[split])
    print(f"  wrote {p['csv_rows'][0]} + {p['csv_rows'][1]} synthetic MNIST "
          f"rows as CSV in {time.perf_counter() - t0:.1f} s (host)")
    t0 = time.perf_counter()
    lib = native.load_fastcsv()
    built = time.perf_counter() - t0
    require(lib is not None, "the port's fastcsv did not build or load")
    so = Path(lib._name)
    require(so.parent == ROOT / "dist_keras_tpu_torch" / "_build"
            and so.name.startswith("libfastcsv-"),
            f"the native reader was loaded from {so}, not the port's _build")
    print(f"  native reader: {so.name} (g++ build and load {built:.2f} s)")
    t0 = time.perf_counter()
    train = Dataset.from_csv(paths["train"], label="label")
    parse_s = time.perf_counter() - t0
    test = Dataset.from_csv(paths["test"], label="label")
    require(not csv_mod._native_warned,
            "the CSV reader warned and fell back to numpy")
    mb = os.path.getsize(paths["train"]) / 1e6
    print(f"  Dataset.from_csv: {len(train)} rows, {mb:.1f} MB in "
          f"{parse_s * 1e3:.1f} ms = {mb / parse_s:.1f} MB/s (native, host "
          f"of the {gpu} machine)")
    want = np.loadtxt(paths["train"], delimiter=",", skiprows=1,
                      dtype=np.float32)
    got = np.column_stack([train["features"], train["label"]])
    require(got.shape == want.shape and np.array_equal(got, want),
            "Dataset.from_csv's matrix differs from np.loadtxt's")
    print("  the matrix equals np.loadtxt of the same file: True")

    def prep(ds):   # examples/mnist.py's preprocess
        ds = MinMaxTransformer(n_min=0.0, n_max=1.0, o_min=0.0, o_max=255.0,
                               input_col="features",
                               output_col="features_normalized").transform(ds)
        ds = OneHotTransformer(10, input_col="label",
                               output_col="label_encoded").transform(ds)
        return ReshapeTransformer(input_col="features_normalized",
                                  output_col="features_img",
                                  shape=(28, 28, 1)).transform(ds)

    train, test = prep(train), prep(test)
    runs = {}
    deterministic(True)
    try:
        for label, kw in (("resident", {}),
                          ("streamed", {"stream_chunk_windows": 1})):
            t = ADAG(mnist_cnn(), num_workers=ADAG_WORKERS,
                     communication_window=ADAG_WINDOW,
                     worker_optimizer="adam",
                     optimizer_kwargs={"learning_rate": 3e-3},
                     batch_size=64, num_epoch=p["csv_epochs"],
                     features_col="features_img",
                     label_col="label_encoded", device=device, **kw)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")   # the dropped steps
                runs[label] = t, t.train(train, shuffle=True)
    finally:
        deterministic(False)
    (tr, mr), (ts, ms) = runs["resident"], runs["streamed"]
    feed = ts._last_feed
    require(ts._streamed and not tr._streamed and len(feed) > 1
            and feed.peak_resident_chunks <= 2,
            f"15a's streamed run: streamed {ts._streamed}, {len(feed)} "
            f"chunks, peak {feed.peak_resident_chunks}")
    hist_equal = np.array_equal(np.asarray(tr.get_history()),
                                np.asarray(ts.get_history()))
    bits = params_bit_equal(mr, ms)
    acc = accuracy(ms, test, "features_img", device=device)
    print(f"  ADAG(mnist_cnn, {ADAG_WORKERS} workers, window {ADAG_WINDOW}) "
          f"from the CSV, streamed one window a chunk ({len(feed)} chunks, "
          f"peak {feed.peak_resident_chunks} on the card): accuracy "
          f"{acc:.4f} (threshold {p['gate']}), training "
          f"{ts.get_training_time():.3f} s (resident "
          f"{tr.get_training_time():.3f} s); bit-equal to the resident run "
          f"under deterministic algorithms: params {bits}, history "
          f"{hist_equal} on {gpu}")
    require(bits and hist_equal,
            "the streamed run is not bit-equal to the resident one")
    require(acc >= p["gate"], f"15a's accuracy {acc} < {p['gate']}")
    return ms, test, train


def overlap_share(prof):
    """-> (share of the pinned HtoD copies' time that ran under a compute
    kernel, the same without the first copy, copies seen), from one
    ``torch.profiler`` capture's device events."""
    from torch.autograd import DeviceType

    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        if "Memcpy HtoD" in e.name and "Pinned" in e.name:
            copies.append(span)
        elif not e.name.startswith(("Memcpy", "Memset")):
            kernels.append(span)
    kernels.sort()
    merged = []
    for s, t in kernels:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])

    def share(spans):
        total = sum(t - s for s, t in spans)
        under = sum(max(0, min(t, mt) - max(s, ms)) for s, t in spans
                    for ms, mt in merged)
        return under / total if total else float("nan")

    copies.sort()
    return share(copies), share(copies[2:]), len(copies)   # 2 a chunk


def stream_full_width(gpu, device, p):
    """15b: ``bench_adag_streamed``'s MLP resident and streamed (a
    warm-up each, then the median of 3, in turns), peak device memory,
    the residency bound, no host sync in a dispatch or a get; a
    ``max_resident_bytes`` budget under the epoch;
    ``bench_adag_mnist_cnn``'s shape resident against one window a
    chunk, and the profiled share of its copies under compute."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from dist_keras_tpu_torch.data import Dataset
    from dist_keras_tpu_torch.data import feed as feed_mod
    from dist_keras_tpu_torch.models import mnist_cnn, mnist_mlp
    from dist_keras_tpu_torch.observability import metrics
    from dist_keras_tpu_torch.trainers import ADAG

    cuda = torch.device(device).type == "cuda"
    rng = np.random.default_rng(0)
    n, feat = p["mlp_rows"], p["mlp_feat"]
    yv = rng.integers(0, 10, size=n)
    ds = Dataset({"features": rng.integers(0, 256, size=(n, feat)).astype(
        np.uint8), "label": yv,
        "label_encoded": np.eye(10, dtype=np.uint8)[yv]})
    common = dict(num_workers=1, worker_optimizer="sgd",
                  optimizer_kwargs={"learning_rate": 0.01},
                  batch_size=p["mlp_batch"], label_col="label_encoded",
                  communication_window=p["mlp_window"],
                  compute_dtype=torch.bfloat16, data_dtype=None,
                  device=device)

    def mlp():
        return mnist_mlp(hidden=p["mlp_hidden"], input_dim=feat,
                         num_classes=10)

    def run(data, epochs, **kw):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t = ADAG(mlp(), num_epoch=epochs, **common, **kw)
        t.train(data)
        h = np.asarray(t.get_history())
        require(np.isfinite(h).all(), "15b's losses are not finite")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        return t, len(data) * epochs / t.get_training_time(), peak

    print(f"  mnist_mlp hidden {p['mlp_hidden'][0]} x "
          f"{len(p['mlp_hidden'])}: {mlp().count_params} parameters; "
          f"{n} rows x {feat} uint8, batch {p['mlp_batch']}, window "
          f"{p['mlp_window']}, 1 worker, sgd, bf16, {p['mlp_epochs']} epochs")
    chunk = {"stream_chunk_windows": p["mlp_chunk"]}
    # the warm-ups: one epoch of four chunks' rows each
    sub = ds.take(4 * p["mlp_chunk"] * p["mlp_window"] * p["mlp_batch"])
    run(sub, 1)
    with strict_dispatch():
        t, _, _ = run(sub, 1, **chunk)
    print(f"  no host sync in the streamed warm-up's {len(t._last_feed)} "
          f"dispatches and gets (sync debug mode 'error') on {gpu}")
    # the timed runs in turns (resident, streamed, streamed, resident,
    # ...): the host's speed drifts within a call
    res, st = [], []
    for k in range(p["mlp_runs"]):
        for streamed in ((False, True) if k % 2 == 0 else (True, False)):
            (st if streamed else res).append(
                run(ds, p["mlp_epochs"], **(chunk if streamed else {})))
    r_sps = float(np.median([s for _, s, _ in res]))
    s_sps = float(np.median([s for _, s, _ in st]))
    feed = st[-1][0]._last_feed
    require(all(t._streamed and t._last_feed.peak_resident_chunks <= 2
                for t, _, _ in st),
            "a 15b streamed run held more than two chunks")
    ratio = s_sps / r_sps
    order = " ".join("R S" if k % 2 == 0 else "S R"
                     for k in range(p["mlp_runs"]))
    print(f"  bench_adag_streamed shape: resident {r_sps:.1f} samples/s "
          f"(median of {p['mlp_runs']}: "
          f"{', '.join(f'{s:.1f}' for _, s, _ in res)}), streamed "
          f"{s_sps:.1f} ({', '.join(f'{s:.1f}' for _, s, _ in st)}; "
          f"{len(feed)} chunks of {p['mlp_chunk']} windows, peak "
          f"{feed.peak_resident_chunks} on the card, "
          f"{feed.put_bytes / 1e6:.2f} MB shipped): streamed / resident "
          f"{ratio:.4f} (bench.py's parity target {STREAM_PARITY}: "
          f"{'met' if ratio >= STREAM_PARITY else 'missed'}; runs in turns "
          f"{order}) on {gpu}")
    print(f"  torch.cuda.max_memory_allocated: resident "
          f"{res[-1][2] / 2**20:.1f} MiB, streamed {st[-1][2] / 2**20:.1f} "
          f"MiB on {gpu}")

    # max_resident_bytes under the epoch: streaming turns on, C =
    # budget // (2 x a window's bytes), and the feed's chunks on the card
    # stay under the budget
    live, prefetch = [0], feed_mod.ChunkFeed.prefetch

    def counted(self, i):
        prefetch(self, i)
        live[0] = max(live[0], sum(x.nbytes for c in self._bufs.values()
                                   for x in c))

    feed_mod.ChunkFeed.prefetch = counted
    try:
        t, _, _ = run(sub, 1, max_resident_bytes=p["budget"])
    finally:
        feed_mod.ChunkFeed.prefetch = prefetch
    epoch = sub["features"].nbytes + sub["label_encoded"].nbytes
    per_window = epoch // (len(sub) // (p["mlp_batch"] * p["mlp_window"]))
    C = max(k for _, k in t._last_feed._spans)
    print(f"  max_resident_bytes {p['budget']} under the epoch's {epoch} B: "
          f"streamed {t._streamed}, C {C} windows (budget // (2 x "
          f"{per_window} B)), the feed's chunks on the card at most "
          f"{live[0]} B, peak {t._last_feed.peak_resident_chunks} chunks on "
          f"{gpu}")
    require(t._streamed and C == p["budget"] // (2 * per_window)
            and 0 < live[0] <= p["budget"],
            "the max_resident_bytes budget did not hold")

    # bench_adag_mnist_cnn's shape: resident against one window a chunk
    rng = np.random.default_rng(0)
    n = p["cnn_batch"] * p["cnn_steps"]
    y = rng.integers(0, 10, n)
    cds = Dataset({"features": rng.normal(size=(n, 28, 28, 1)).astype(
        np.float32), "label": y,
        "label_encoded": np.eye(10, dtype=np.float32)[y]})

    def cnn(epochs, **kw):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        metrics.reset()
        t = ADAG(mnist_cnn(), num_workers=ADAG_WORKERS,
                 communication_window=ADAG_WINDOW, worker_optimizer="adam",
                 batch_size=p["cnn_batch"], num_epoch=epochs,
                 label_col="label_encoded", compute_dtype=torch.bfloat16,
                 device=device, **kw)
        t.train(cds)
        h = np.asarray(t.get_history())
        require(np.isfinite(h).all(), "the CNN run's losses are not finite")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        return (t, h.size * p["cnn_batch"] / t.get_training_time(), peak,
                metrics.snapshot()["histograms"])

    _, warm, _, _ = cnn(2)
    epochs = max(2, int(p["cnn_seconds"] * warm / n))
    tr, r_sps, r_peak, _ = cnn(epochs)
    ts, s_sps, s_peak, hists = cnn(epochs, stream_chunk_windows=1)
    if cuda:
        # the copy stream under compute: three chunks (two boundaries)
        # of the device-bound CNN, profiled apart from the timed runs
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tp, _, _, _ = cnn(3, stream_chunk_windows=1)
            torch.cuda.synchronize()
        whole, later, n_copies = overlap_share(prof)
        print(f"  torch.profiler over {len(tp._last_feed)} CNN chunks (2 "
              f"chunk boundaries): {n_copies} pinned HtoD copies, "
              f"{later:.1%} of chunks 1..'s copy time under compute "
              f"kernels ({whole:.1%} with chunk 0's, copied before the "
              f"clock with nothing to hide under) on {gpu}")
        require(n_copies >= 6, f"the profiler saw {n_copies} pinned copies")
    chunks = len(ts._last_feed)
    data = hists["perf.phase.data"]["total"] / chunks * 1e3
    step = hists["perf.phase.step"]["total"] / chunks * 1e3
    print(f"  bench_adag_mnist_cnn shape ({ADAG_WORKERS} x "
          f"{p['cnn_batch']}, window {ADAG_WINDOW}, bf16, adam, {epochs} "
          f"epochs): resident {r_sps:.1f} samples/s, peak "
          f"{r_peak / 2**20:.1f} MiB; one window a chunk {s_sps:.1f} "
          f"samples/s ({s_sps / r_sps:.4f} of resident), peak "
          f"{s_peak / 2**20:.1f} MiB; per chunk perf.phase.data (the host's "
          f"staging copy) {data:.3f} ms against perf.phase.step {step:.3f} "
          f"ms ({ts._last_feed.put_bytes / chunks / 1e6:.1f} MB a chunk) on "
          f"{gpu}")
    require(ts._last_feed.peak_resident_chunks <= 2,
            "the CNN's streamed run held more than two chunks")


def stream_predict(model, test, gpu, device, p):
    """15c: a ``SocketSource`` fed by a producer thread over 15a's
    held-out rows; predictions equal ``ModelPredictor``'s, in arrival
    order, every batch at the fixed shape; one ``stream.fetch`` fault
    armed through ``DK_FAULTS`` is retried and loses no row."""
    from dist_keras_tpu_torch.data import (
        ModelPredictor,
        SocketSource,
        StreamingPredictor,
        send_rows,
    )
    from dist_keras_tpu_torch.resilience import faults

    x = np.asarray(test["features_img"], dtype=np.float32)
    want = np.asarray(ModelPredictor(model, features_col="features_img",
                                     device=device).predict(test)
                      ["prediction"])
    faults.clear()
    os.environ["DK_FAULTS"] = "stream.fetch@40:exc=OSError"
    try:
        faults.load_env(force=True)
        (spec,) = faults._specs["stream.fetch"]
        pred = StreamingPredictor(model, batch_size=p["stream_batch"],
                                  max_latency_s=0.05, device=device)
        shapes, forward = [], pred._predict

        def seen(xb):
            shapes.append(xb.shape)
            return forward(xb)

        pred._predict = seen
        src = SocketSource()
        producer = threading.Thread(target=send_rows,
                                    args=(src.address, x), daemon=True)
        t0 = time.perf_counter()
        producer.start()
        out = list(pred.predict_stream(src))
        wall = time.perf_counter() - t0
        producer.join(timeout=60)
        src.close()
    finally:
        os.environ.pop("DK_FAULTS", None)
        faults.clear()
    rows = np.concatenate([r for r, _ in out])
    preds = np.concatenate([q for _, q in out])
    err = float(np.abs(preds - want).max() / np.abs(want).max())
    print(f"  StreamingPredictor over a SocketSource: {len(rows)} rows in "
          f"{len(out)} batches of {p['stream_batch']}, {len(rows) / wall:.1f} "
          f"rows/s (the producer's JSON framing included); max err against "
          f"ModelPredictor {err:.3e} of the largest logit (held to "
          f"{STREAM_TOL}); stream.fetch faults fired {spec.fired}, retried "
          f"on {gpu}")
    require(len(rows) == len(x) and np.array_equal(rows, x),
            "15c lost or reordered rows")
    require(set(shapes) == {(p["stream_batch"],) + x.shape[1:]},
            f"15c forwarded shapes {sorted(set(shapes))}")
    require(err <= STREAM_TOL, f"15c's predictions err {err}")
    require(spec.fired == 1, "15c's stream.fetch fault did not fire once")


def runner_telemetry(work, train, gpu, device, p):
    """15d: a streamed ADAG run under a temporary ``DK_OBS_DIR`` with
    ``DK_OBS_SAMPLE_S`` leaves its chunk events, perf phases, the h2d
    bytes the feed shipped, one ``train.run`` root span, ``report.txt``
    and sampler samples, and the overlap merge's histograms; a
    ``step.loss`` NaN through ``DK_FAULTS`` halts a run by its NaN
    policy."""
    import tempfile
    import warnings

    from dist_keras_tpu_torch.models import mnist_cnn
    from dist_keras_tpu_torch.observability import (
        events,
        metrics,
        report,
        spans,
        timeseries,
    )
    from dist_keras_tpu_torch.resilience import faults
    from dist_keras_tpu_torch.trainers import ADAG

    obs = tempfile.mkdtemp(dir=work)
    saved = {k: os.environ.get(k) for k in ("DK_OBS_DIR", "DK_OBS_SAMPLE_S",
                                            "DK_FAULTS")}
    os.environ.update(DK_OBS_DIR=obs, DK_OBS_SAMPLE_S="0.2")

    def adag(**kw):
        t = ADAG(mnist_cnn(), num_workers=ADAG_WORKERS,
                 communication_window=ADAG_WINDOW, worker_optimizer="adam",
                 optimizer_kwargs={"learning_rate": 3e-3}, batch_size=64,
                 num_epoch=2, features_col="features_img",
                 label_col="label_encoded", stream_chunk_windows=1,
                 device=device, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            t.train(train)
        return t

    def reset():
        for m in (events, metrics, spans, timeseries):
            m.reset()
        faults.clear()

    reset()
    try:
        t = adag(comm_overlap=True, handle_preemption=True)
        sampler = timeseries.get_sampler()
        deadline = time.time() + 2.0
        while time.time() < deadline and not any(
                e["kind"] == "perf_sample" for e in report.read_events(obs)):
            time.sleep(0.05)
        evs = report.read_events(obs)
        snap = metrics.snapshot()
        hists, counters = snap["histograms"], snap["counters"]
        chunk_evs = [e for e in evs if e["kind"] == "chunk"]
        roots = [e for e in evs if e["kind"] == "span_end"
                 and e["span"] == "train.run"]
        n_samples = sum(e["kind"] == "perf_sample" for e in evs)
        phases = {k: hists.get(f"perf.phase.{k}", {}).get("count", 0)
                  for k in ("data", "step", "comm", "ckpt", "comm_overlap",
                            "comm_blocked")}
        print(f"  telemetry of a streamed ADAG run (comm_overlap, "
              f"handle_preemption): {len(chunk_evs)} chunk events, all "
              f"streamed {all(e['streamed'] for e in chunk_evs)}; phase "
              f"counts {phases}; perf.h2d_bytes {counters['perf.h2d_bytes']}"
              f" = the feed's {t._last_feed.put_bytes}; train.run spans "
              f"{len(roots)}; report.txt "
              f"{os.path.exists(os.path.join(obs, 'report.txt'))}; sampler "
              f"running {bool(sampler and sampler.running)}, "
              f"{n_samples} perf_sample events on {gpu}")
        require(chunk_evs and all(e["streamed"] for e in chunk_evs),
                "15d: chunk events missing or not streamed")
        require(all(phases[k] > 0 for k in phases),
                f"15d: an empty perf phase: {phases}")
        require(counters["perf.h2d_bytes"] == t._last_feed.put_bytes > 0,
                "15d: perf.h2d_bytes is not the bytes the feed shipped")
        require(len(roots) == 1 and roots[0]["parent_id"] is None
                and all(e.get("trace_id") == roots[0]["trace_id"]
                        for e in chunk_evs),
                "15d: one train.run span does not root the run")
        require(os.path.exists(os.path.join(obs, "report.txt")),
                "15d: no report.txt")
        require(sampler is not None and sampler.running and n_samples > 0,
                "15d: the sampler did not run")

        os.environ["DK_FAULTS"] = "step.loss@1:action=corrupt"
        faults.clear()
        faults.load_env(force=True)
        t = adag(nan_policy="halt")
        halts = [e for e in report.read_events(obs)
                 if e["kind"] == "nan_halt"]
        windows = np.asarray(t.get_history()).shape[1]
        print(f"  step.loss NaN through DK_FAULTS under nan_policy='halt': "
              f"halted at unit {halts[-1]['units_done'] if halts else None}, "
              f"{t.nonfinite_steps} non-finite losses, {windows} windows "
              f"trained on {gpu}")
        require(halts and t.nonfinite_steps > 0,
                "15d: the NaN did not halt the run")
    finally:
        timeseries.stop_sampler()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset()


def data_path(fa, fu, da, gpu, device="cuda", sizes=None):
    """Phase 15: the CSV flow, streaming at full width, streaming
    inference and the runner's telemetry; no hand-written kernel."""
    import tempfile

    import torch

    p = {**PHASE15, **(sizes or {})}
    zero_kernel_counts(fa, fu, da)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        print("phase 15a: the paper's flow from CSV")
        model, test, train = csv_flow(work, gpu, device, p)
        print("phase 15b: streaming at full width")
        stream_full_width(gpu, device, p)
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        print("phase 15c: StreamingPredictor on the card")
        stream_predict(model, test, gpu, device, p)
        print("phase 15d: the runner's telemetry")
        runner_telemetry(work, train, gpu, device, p)
    counts = kernel_counts(fa, fu, da)
    print(f"  hand-written kernels launched by phase 15: {counts} (none is "
          f"on this path)")
    require(not any(counts.values()),
            f"phase 15 launched a hand-written kernel: {counts}")
    print(f"  phase 15 wall {time.perf_counter() - t0:.1f} s on {gpu}")


# -- phase 16: the workers across processes ---------------------------------
MP_RANKS = 2
MP_TIMEOUT_S = 300      # the longest any one rank process may run
PARITY_TOL = 1e-5       # 16a: of the largest center weight
# 16a's runs (optimizer, compute dtype, whether the split is held to the
# 4-worker run too): each split run is held to PARITY_TOL against the
# witness, the same ADAG merged by hand in this process with the workers
# stacked 2 + 2 as the ranks stack them (parity_by_hand); against the
# 4-worker run only f64 compute is held, as in f32 the stacked step of 2
# workers may round otherwise than that of 4, and adam's +-lr first steps
# (wherever a gradient is within rounding of 0) turn that into lr-sized
# gaps: the witness's own 2 + 2 against 4 reading shows how far
PARITY_RUNS = (("sgd", "float64", True), ("sgd", None, False),
               ("adam", None, False))
# the full run cuts 16b's turns to one run of ~1 s each (``--phase16``
# keeps PHASE16); every check stays
PROOF16 = dict(bench_seconds=1.0, bench_runs=1)
# and 13b's two runs to 3 epochs each (``--phase13`` keeps GATE_EPOCHS)
PROOF13_EPOCHS = 3
PHASE16 = dict(
    parity_batch=32, parity_steps=24,          # 2 windows of 12, f32
    bench_batch=ADAG_BENCH_BATCH, bench_steps=ADAG_BENCH_STEPS,
    bench_seconds=6.0, bench_runs=BENCH_RUNS,
    gate_rows=GATE_ROWS, gate_test_rows=GATE_TEST_ROWS,
    gate_epochs=GATE_EPOCHS, gate_acc=GATE_ACC,
    det_rows=4096, det_epochs=4, det_kill_epoch=2, det_batch=64,
    det_window=4)


def mp_data(n, seed, shape=(28, 28, 1), classes=10):
    """Random images and one-hot labels, made from ``seed``: the same
    rows in every process that asks."""
    from dist_keras_tpu_torch.data import Dataset

    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, n)
    return Dataset({"features": rng.standard_normal(
        (n, *shape), dtype=np.float32), "label": y,
        "label_encoded": np.eye(classes, dtype=np.float32)[y]})


def mp_parity_trainer(p, device, optimizer, compute, **kw):
    """16a's ADAG: the MNIST CNN with dropout 0 (one generator per
    process draws other masks than one for all four workers), 4 workers,
    window 12, f32 params, ``optimizer`` at its default rate, ``compute``
    (a dtype name, or None for f32) for the step."""
    import torch

    from dist_keras_tpu_torch.trainers import ADAG

    return ADAG(no_dropout_cnn(0), num_workers=ADAG_WORKERS,
                communication_window=ADAG_WINDOW, worker_optimizer=optimizer,
                batch_size=p["parity_batch"], num_epoch=1,
                label_col="label_encoded", device=device,
                compute_dtype=compute and getattr(torch, compute), **kw)


def parity_label(opt, compute):
    return f"{opt}_{compute or 'float32'}"


def parity_by_hand(p, device, ds, opt, compute, splits):
    """16a's witness: the parity run's ADAG in this process, its workers
    stacked as ``splits`` (``[lo, hi)`` ranges, each stepped on its own
    stack) and each window's deltas summed range by range, as the ranks'
    all-reduce sums them; -> the center's leaves.  ``[(0, 4)]`` is the
    4-worker run's stacking, ``[(0, 2), (2, 4)]`` the ranks'."""
    import torch

    from dist_keras_tpu_torch.parallel.collectives import tree_psum
    from dist_keras_tpu_torch.utils.bridge import params_to_numpy
    from dist_keras_tpu_torch.utils.pytree import (
        tree_add,
        tree_merge_floats,
        tree_stack,
    )

    t = mp_parity_trainer(p, device, opt, compute)
    model, loss_fn, tx = t._resolve()
    step, opt_init = t._make_worker_step(model, loss_fn, tx)
    xs, ys = t._shards(ds)            # (workers, steps, batch, ...)
    center = t._device_params(model.params)
    parts = [[tree_stack(center, hi - lo),
              t._stack_workers(opt_init(center), hi - lo)]
             for lo, hi in splits]
    generator = torch.Generator(device=t.device).manual_seed(t.seed)
    W = t.communication_window
    for w in range(xs.shape[1] // W):
        total = None
        for (lo, hi), part in zip(splits, parts):
            carry = (part[0], part[1], generator)
            for j in range(w * W, (w + 1) * W):
                carry, _ = step(carry, (
                    torch.as_tensor(xs[lo:hi, j], device=t.device),
                    torch.as_tensor(ys[lo:hi, j], device=t.device)))
            part[0], part[1] = carry[0], carry[1]
            d = tree_psum(t.commit(center, part[0]))
            total = d if total is None else tree_add(total, d)
        center = tree_merge_floats(tree_add(center, total), center)
        for (lo, hi), part in zip(splits, parts):
            part[0] = tree_merge_floats(tree_stack(center, hi - lo), part[0])
    return [v for layer in params_to_numpy(center) for v in layer.values()]


def leaves_err(got, want):
    """Max abs difference of two leaf lists, over ``want``'s largest
    weight."""
    top = max(float(np.abs(w).max()) for w in want)
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want)) / top


def mp_bench_run(ds, epochs, p, device, workers=ADAG_WORKERS, **kw):
    """One run at ``bench_adag_mnist_cnn``'s shape -> (samples/s over
    ``get_training_time()``, the trainer); the samples are every rank's
    (the history is gathered).  ``workers`` over ``ds``'s rows: each
    worker steps ``bench_steps // ADAG_WORKERS`` times an epoch when
    ``ds`` holds ``workers / ADAG_WORKERS`` of the bench's rows."""
    import torch

    from dist_keras_tpu_torch.models import mnist_cnn
    from dist_keras_tpu_torch.trainers import ADAG

    t = ADAG(mnist_cnn(), num_workers=workers,
             communication_window=ADAG_WINDOW, worker_optimizer="adam",
             batch_size=p["bench_batch"], num_epoch=epochs,
             label_col="label_encoded", compute_dtype=torch.bfloat16,
             device=device, **kw)
    t.train(ds)
    h = np.asarray(t.get_history())
    windows = p["bench_steps"] // ADAG_WORKERS // ADAG_WINDOW
    require(h.shape == (workers, epochs, windows, ADAG_WINDOW)
            and np.isfinite(h).all(),
            f"the bench run's history {h.shape} is not finite")
    return h.size * p["bench_batch"] / t.get_training_time(), t


def mp_det_trainer(name, p, device, **kw):
    """16d's trainers: SingleTrainer on the MNIST MLP, ADAG on the MNIST
    CNN with dropout (4 workers, 2 a rank), adam."""
    from dist_keras_tpu_torch.models import mnist_cnn, mnist_mlp
    from dist_keras_tpu_torch.trainers import ADAG, SingleTrainer

    common = dict(worker_optimizer="adam", batch_size=p["det_batch"],
                  num_epoch=p["det_epochs"], label_col="label_encoded",
                  seed=3, device=device, **kw)
    if name == "single":
        return SingleTrainer(mnist_mlp(seed=0), features_col="flat",
                             **common)
    return ADAG(mnist_cnn(seed=0), num_workers=ADAG_WORKERS,
                communication_window=p["det_window"], **common)


def mp_det_data(p):
    ds = mp_data(p["det_rows"], 4)
    return ds.with_column("flat", ds["features"].reshape(p["det_rows"], -1))


def save_leaves(path, leaves):
    np.savez(path, **{f"{i:04d}": v for i, v in enumerate(leaves)})


def load_leaves(path):
    z = np.load(path)
    return [z[k] for k in sorted(z.files)]


class Gates:
    """Files in ``work`` that order the parent and the ranks: the parent
    opens ``<name>.go`` (with a JSON body), each rank answers
    ``<name>.<rank>.json``."""

    def __init__(self, work, procs=()):
        self.work, self.procs = Path(work), list(procs)

    def _wait(self, path, what):
        t0 = time.perf_counter()
        while not path.exists():
            dead = [p for p in self.procs if p.poll() is not None]
            require(not dead, f"{what}: a rank exited first: " + "; ".join(
                f"{p.label} rc={p.returncode}" for p in dead))
            require(time.perf_counter() - t0 < MP_TIMEOUT_S,
                    f"{what}: no answer in {MP_TIMEOUT_S} s")
            time.sleep(0.01)

    def open(self, name, body=None):
        tmp = self.work / f"{name}.go.tmp"
        tmp.write_text(json.dumps(body or {}))
        os.replace(tmp, self.work / f"{name}.go")

    def wait_open(self, name):
        path = self.work / f"{name}.go"
        self._wait(path, f"gate {name}")
        return json.loads(path.read_text())

    def answer(self, name, rank, body):
        tmp = self.work / f"{name}.{rank}.json.tmp"
        tmp.write_text(json.dumps(body))
        os.replace(tmp, self.work / f"{name}.{rank}.json")

    def answers(self, name, world=MP_RANKS):
        out = []
        for r in range(world):
            path = self.work / f"{name}.{r}.json"
            self._wait(path, f"{name} from rank {r}")
            out.append(json.loads(path.read_text()))
        return out


def mp_role(cfg):
    """A rank of phase 16, started fresh by :func:`workers_across_processes`
    (``--mp-role JSON``): joins the group through the ``file://``
    rendezvous ``cfg["rdv"]`` (``JAX_*`` variables, as ``launch.Job``
    exports them), prints ``MP_INIT`` (its backend and device), runs
    ``cfg["tasks"]`` and prints its K1-K5 counters, zeroed at its start,
    as ``MP_KERNELS {json}`` however it ends."""
    for k, v in cfg.get("env", {}).items():
        os.environ[k] = v
    if "DK_COORD_DIR" in os.environ:
        os.environ["DK_COORD_RANK"] = str(cfg["rank"])
    os.environ["JAX_COORDINATOR_ADDRESS"] = "file://" + cfg["rdv"]
    os.environ["JAX_NUM_PROCESSES"] = str(cfg["world"])
    os.environ["JAX_PROCESS_ID"] = str(cfg["rank"])
    sys.path.insert(0, str(ROOT))
    import torch

    from dist_keras_tpu_torch import comm
    from dist_keras_tpu_torch.ops import decode_attention as da
    from dist_keras_tpu_torch.ops import flash_attention as fa
    from dist_keras_tpu_torch.ops import fused_bwd_experimental as fu

    zero_kernel_counts(fa, fu, da)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t0 = time.perf_counter()
        comm.initialize(device=cfg["device"])
        g = comm.group_info()
        write_record("MP_INIT " + json.dumps({
            "rank": g.rank, "world": g.world, "backend": g.backend,
            "device": str(g.device), "local_world": g.local_world,
            "init_s": time.perf_counter() - t0}))
        gates = Gates(cfg["work"])
        for task in cfg["tasks"]:
            MP_TASKS[task](cfg, gates, g.rank)
        return 0
    finally:
        write_kernel_counts("MP_KERNELS", fa, fu, da)
        comm.shutdown()


def mp_task_parity(cfg, gates, rank):
    """16a's split runs (:data:`PARITY_RUNS`): rank r stacks workers
    [2r, 2r+2)."""
    import torch

    from dist_keras_tpu_torch.utils.bridge import params_to_numpy

    p = cfg["sizes"]
    ds = mp_data(ADAG_WORKERS * p["parity_steps"] * p["parity_batch"], 1)
    torch.backends.cudnn.deterministic = True
    for opt, compute, _ in PARITY_RUNS:
        t = mp_parity_trainer(p, cfg["device"], opt, compute)
        m = t.train(ds)
        label = parity_label(opt, compute)
        save_leaves(Path(cfg["work"]) / f"parity_{label}_{rank}.npz",
                    [v for layer in params_to_numpy(m.params)
                     for v in layer.values()])
    torch.backends.cudnn.deterministic = False
    gates.answer("parity", rank, {"lo": t.mesh.lo, "hi": t.mesh.hi,
                                  "history": list(np.shape(
                                      t.get_history()))})


def mp_task_bench(cfg, gates, rank):
    """16b's split runs, each opened by the parent (which times its own
    one-process run between them): a warm-up, the timed runs, one
    overlapped run and one under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dist_keras_tpu_torch.observability import metrics
    from dist_keras_tpu_torch.parallel import collectives

    p = cfg["sizes"]
    ds = mp_data(p["bench_batch"] * p["bench_steps"], 0)
    for k in ["warm"] + list(range(p["bench_runs"])):
        epochs = gates.wait_open(f"bench_{k}")["epochs"]
        collectives.reduce_stats(reset=True)
        metrics.reset()
        sps, t = mp_bench_run(ds, epochs, p, cfg["device"])
        red = collectives.reduce_stats()
        hists = metrics.snapshot()["histograms"]
        gates.answer(f"bench_{k}", rank, {
            "sps": sps, "seconds": t.get_training_time(),
            "windows": epochs, "reduce": red,
            "blocked_ms": hists.get("perf.phase.comm_blocked", {}).get(
                "total", 0.0) * 1e3})
    body = gates.wait_open("bench_extra")
    epochs = body["epochs"]
    red = collectives.reduce_stats()
    metrics.reset()
    collectives.reduce_stats(reset=True)
    sps, t = mp_bench_run(ds, body["overlap_epochs"], p, cfg["device"],
                          comm_overlap=True)
    hists = metrics.snapshot()["histograms"]
    overlap = {"sps": sps, "reduce": collectives.reduce_stats(),
               "windows": body["overlap_epochs"],
               "seconds": t.get_training_time(),
               "phases": {ph: {"count": hists[f"perf.phase.{ph}"]["count"],
                               "total_ms": hists[f"perf.phase.{ph}"]["total"]
                               * 1e3}
                          for ph in ("comm_overlap", "comm_blocked")}}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        _, t = mp_bench_run(ds, epochs, p, cfg["device"])
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3
    gates.answer("bench_extra", rank, {
        "overlap": overlap, "busy_ms": busy_ms,
        "train_ms": t.get_training_time() * 1e3,
        "ops": sum(e.count for e in ops),
        "allreduce_ms": allreduce_alone(red["bytes"] // red["calls"],
                                        cfg["device"])})


def allreduce_alone(nbytes, device, reps=20):
    """The merge's all-reduce without the window before it: one f32
    bucket of ``nbytes`` on ``device``, after a barrier with the card
    idle; -> ms a call (median of ``reps``)."""
    import torch
    import torch.distributed as dist

    from dist_keras_tpu_torch import comm

    x = torch.ones(nbytes // 4, device=device)
    on_card = x.device.type == "cuda"
    times = []
    for i in range(reps + 3):
        if on_card:
            torch.cuda.synchronize()
        comm.barrier(f"allreduce_{i}")
        t0 = time.perf_counter()
        dist.all_reduce(x)
        if on_card:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times[3:])) * 1e3


def mp_task_gate(cfg, gates, rank):
    """16c: phase 10's ADAG gate config split over the ranks."""
    import torch

    from dist_keras_tpu_torch.data import Dataset
    from dist_keras_tpu_torch.models import mnist_cnn
    from dist_keras_tpu_torch.trainers import ADAG

    p = cfg["sizes"]
    gates.wait_open("gate")
    z = np.load(Path(cfg["work"]) / "gate.npz")
    train = Dataset({"fi": z["train_fi"], "le": z["train_le"]})
    test = Dataset({"fi": z["test_fi"], "label": z["test_label"]})
    torch.backends.cudnn.deterministic = True
    t = ADAG(mnist_cnn(), num_workers=ADAG_WORKERS,
             communication_window=ADAG_WINDOW, worker_optimizer="adam",
             optimizer_kwargs={"learning_rate": 3e-3}, batch_size=64,
             num_epoch=p["gate_epochs"], features_col="fi", label_col="le",
             device=cfg["device"])
    model = t.train(train, shuffle=True)
    torch.backends.cudnn.deterministic = False
    hist = np.asarray(t.get_history())
    gates.answer("gate", rank, {
        "acc": accuracy(model, test, "fi", device=cfg["device"]),
        "history": list(hist.shape), "finite": bool(np.isfinite(hist).all()),
        "seconds": t.get_training_time(), "lo": t.mesh.lo,
        "hi": t.mesh.hi})


def mp_task_det(cfg, gates, rank):
    """16d: SingleTrainer then ADAG, each uninterrupted (``mode`` full),
    preempted by a SIGTERM to rank 0 at the end of epoch
    ``det_kill_epoch`` (preempt) or resumed (resume), under deterministic
    algorithms; the weights go to ``<name>_<mode>_<rank>.npz``.  A
    preempted SingleTrainer's ``Preempted`` is caught and recorded so
    that the ADAG run follows in the same process; the ADAG run's is not:
    the process exits with its code."""
    import signal

    from dist_keras_tpu_torch.resilience import preemption
    from dist_keras_tpu_torch.resilience.preemption import Preempted

    p, mode = cfg["sizes"], cfg["mode"]
    ds = mp_det_data(p)
    if mode != "full":
        gates.wait_open(mode)
    deterministic(True)

    def sigterm(trainer, epoch, logs):
        if mode == "preempt" and rank == 0 and epoch == p["det_kill_epoch"]:
            os.kill(os.getpid(), signal.SIGTERM)

    for name in ("single", "adag"):
        kw = {} if mode == "full" else dict(
            checkpoint_dir=os.path.join(cfg["work"], f"ck_{name}"),
            checkpoint_every=p["det_kill_epoch"], max_checkpoints=10,
            handle_preemption=True, resume=mode == "resume",
            callbacks=[sigterm])
        t = mp_det_trainer(name, p, cfg["device"], **kw)
        try:
            m = t.train(ds, shuffle=True)
        except Preempted as e:
            gates.answer(f"{name}_preempt", rank, {
                "code": e.code, "saved": e.saved_step})
            if name == "adag":
                raise
            preemption.clear()
            continue
        save_leaves(Path(cfg["work"]) / f"{name}_{mode}_{rank}.npz",
                    m.get_weights())
    gates.answer(f"det_{mode}", rank, {})


def mp_task_solo(cfg, gates, rank):
    """16b's control, after every task that needs the group: the rank
    leaves the group and, at the parent's gate, trains its 2 workers on
    its half of the bench's rows alone (world 1, no collective) while
    the other rank does the same, the two processes sharing the card."""
    from dist_keras_tpu_torch import comm
    from dist_keras_tpu_torch.resilience import coordination

    for k in ("DK_COORD_DIR", "DK_COORD_WORLD", "DK_COORD_RANK",
              "DK_COORD_SESSION", "JAX_COORDINATOR_ADDRESS",
              "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        os.environ.pop(k, None)
    coordination.reset()
    comm.shutdown()
    deterministic(False)
    p = cfg["sizes"]
    workers = ADAG_WORKERS // MP_RANKS
    ds = mp_data(p["bench_batch"] * p["bench_steps"] * workers
                 // ADAG_WORKERS, 0)
    for k in ("solo_warm", "solo"):
        epochs = gates.wait_open(k)["epochs"]
        sps, t = mp_bench_run(ds, epochs, p, cfg["device"], workers=workers)
        gates.answer(k, rank, {"sps": sps, "seconds": t.get_training_time(),
                               "world": t.mesh.world})


MP_TASKS = {"parity": mp_task_parity, "bench": mp_task_bench,
            "gate": mp_task_gate, "det": mp_task_det, "solo": mp_task_solo}


class MPProcs(RoleProcs):
    """Phase 16's rank processes (``--mp-role``)."""

    def __init__(self, work):
        super().__init__(work, "--mp-role", "MP_KERNELS", MP_TIMEOUT_S)

    def launch(self, label, tasks, device, sizes, **extra):
        """``MP_RANKS`` ranks of one group (a ``file://`` rendezvous of
        their own) running ``tasks``."""
        rdv = self.work / f"{label}.rdv"
        return [self.spawn(f"{label}_{r}", {
            "rank": r, "world": MP_RANKS, "rdv": str(rdv), "tasks": tasks,
            "work": str(self.work), "device": device, "sizes": sizes,
            **extra}) for r in range(MP_RANKS)]

    def init(self, p):
        out = self.output(p)
        m = re.search(r"^MP_INIT (.*)$", out, re.M)
        require(m, f"{p.label}: no MP_INIT line: {out[-400:]}")
        return json.loads(m.group(1))


def workers_across_processes(fa, fu, da, gpu, device="cuda", sizes=None):
    """Phase 16: the windowed trainers split over two rank processes on
    the card (gloo: the ranks share it): 16a parity with the one-process
    run, 16b samples/s beside it in turns, 16c the ADAG gate, 16d
    coordinated preemption and a bit-equal resume; no hand-written
    kernel launched in any process."""
    import shutil
    import tempfile

    import torch

    from dist_keras_tpu_torch import comm
    from dist_keras_tpu_torch.utils.bridge import params_to_numpy

    p = {**PHASE16, **(sizes or {})}
    t0 = time.perf_counter()
    zero_kernel_counts(fa, fu, da)
    work = Path(tempfile.mkdtemp(prefix="dk_mp_phase16_"))
    procs = MPProcs(work)
    gates = Gates(work)
    obs = {m: str(work / f"obs_{m}") for m in ("full", "preempt", "resume")}

    def det_env(mode):
        # DK_COORD_RANK is each rank's own (mp_role sets it)
        return {"DK_COORD_DIR": str(work / "coord"),
                "DK_COORD_WORLD": str(MP_RANKS),
                "DK_COORD_SESSION": mode, "DK_OBS_DIR": obs[mode],
                "DK_COORD_TIMEOUT_S": "120"}

    try:
        main = procs.launch("main", ["parity", "bench", "gate", "det",
                                     "solo"],
                            device, p, mode="full", env=det_env("full"))
        gates.procs = main
        # 16c's rows, made while the ranks start (the ranks load them)
        train, test = mnist_sets(p["gate_rows"], p["gate_test_rows"])
        np.savez(work / "gate.npz", train_fi=train["fi"],
                 train_le=train["le"], test_fi=test["fi"],
                 test_label=test["label"])
        del train, test
        print("phase 16a: ADAG split over 2 ranks x 2 workers against the "
              "one-process run")
        ds = mp_data(ADAG_WORKERS * p["parity_steps"] * p["parity_batch"], 1)
        if torch.device(device).type == "cuda":
            torch.backends.cudnn.deterministic = True
        want = {parity_label(opt, compute): [
            v for layer in params_to_numpy(mp_parity_trainer(
                p, device, opt, compute).train(ds).params)
            for v in layer.values()] for opt, compute, _ in PARITY_RUNS}
        # the witness: the same runs merged by hand, stacked 4 and 2 + 2
        by_hand = {parity_label(opt, compute): {
            k: parity_by_hand(p, device, ds, opt, compute, splits)
            for k, splits in (("4", [(0, 4)]), ("2+2", [(0, 2), (2, 4)]))}
            for opt, compute, _ in PARITY_RUNS}
        torch.backends.cudnn.deterministic = False
        ans = gates.answers("parity")
        for r, q in enumerate(main):
            init = procs.init(q)
            print(f"  rank {r}: backend {init['backend']} on "
                  f"{init['device']} (world {init['world']}, "
                  f"{init['local_world']} on this host), group up in "
                  f"{init['init_s']:.2f} s")
            want_backend = comm.select_backend(
                MP_RANKS, torch.cuda.device_count(),
                torch.device(device).type == "cpu")
            require(init["backend"] == want_backend,
                    f"rank {r}: backend {init['backend']}, the rule says "
                    f"{want_backend}")
        print(f"  ADAG mnist_cnn (dropout 0), 4 workers, window 12, f32 "
              f"params, batch {p['parity_batch']}, 2 windows: ranks' slots "
              f"{[(a['lo'], a['hi']) for a in ans]}, history "
              f"{ans[0]['history']}")
        for opt, compute, held in PARITY_RUNS:
            label = parity_label(opt, compute)
            leaves = want[label]
            hand = by_hand[label]
            centers = [load_leaves(work / f"parity_{label}_{r}.npz")
                       for r in range(MP_RANKS)]
            err = leaves_err(centers[0], leaves)
            err_hand = leaves_err(centers[0], hand["2+2"])
            shape = leaves_err(hand["2+2"], hand["4"])
            control = leaves_err(hand["4"], leaves)
            same = all(np.array_equal(a, b) for a, b in zip(*centers))
            print(f"  {opt}, {compute or 'float32'} compute (max abs err of "
                  f"the largest weight): the split center against the "
                  f"witness merged by hand 2 + 2 {err_hand:.3e} (held to "
                  f"{PARITY_TOL:g}), against the one-process run {err:.3e} ("
                  + (f"held to {PARITY_TOL:g}" if held else "printed")
                  + f"); the witness 2 + 2 against 4 {shape:.3e}, the "
                  f"witness 4 against the one-process run (control) "
                  f"{control:.3e}; the two ranks' centers bit-equal: {same} "
                  f"on {gpu}")
            require(same and err_hand <= PARITY_TOL
                    and (err <= PARITY_TOL or not held),
                    f"16a {label}: split center err {err} (against the "
                    f"witness {err_hand}), ranks equal {same}")

        print("phase 16b: samples/s at bench_adag_mnist_cnn's shape, 2 "
              "ranks x 2 workers beside one process x 4 workers, in turns")
        bench = mp_data(p["bench_batch"] * p["bench_steps"], 0)
        warm, _ = mp_bench_run(bench, 2, p, device)
        n = p["bench_batch"] * p["bench_steps"]
        epochs = max(2, int(p["bench_seconds"] * warm / n))
        gates.open("bench_warm", {"epochs": 2})
        split_warm = gates.answers("bench_warm")
        one, split = [], []
        for k in range(p["bench_runs"]):
            one.append(mp_bench_run(bench, epochs, p, device)[0])
            gates.open(f"bench_{k}", {"epochs": epochs})
            split.append(gates.answers(f"bench_{k}"))
        gates.open("bench_extra", {"epochs": 2, "overlap_epochs": epochs})
        extra = gates.answers("bench_extra")
        s_one = float(np.median(one))
        s_split = float(np.median([a[0]["sps"] for a in split]))
        print(f"  one process x 4 workers: {s_one:.1f} samples/s (median of "
              f"{len(one)} runs of {epochs} epochs: "
              f"{', '.join(f'{v:.1f}' for v in one)}; warm-up {warm:.1f})")
        print(f"  2 ranks x 2 workers: {s_split:.1f} samples/s (median of "
              f"{len(split)}; rank 0 / rank 1 per run: " + "; ".join(
                  f"{a[0]['sps']:.1f} / {a[1]['sps']:.1f}" for a in split)
              + f"; warm-up {split_warm[0]['sps']:.1f}) = "
              f"{s_split / s_one:.3f} of the one-process rate on {gpu}")
        red = split[-1][0]["reduce"]
        w = split[-1][0]["windows"]
        print(f"  the merge's all-reduce ({init['backend']}, tensors on "
              f"{init['device']}), rank 0: "
              f"{red['calls'] / w:.0f} collective(s) and "
              f"{red['bytes'] / w / 1e6:.3f} MB a window, "
              f"{red['seconds'] / w * 1e3:.3f} ms a window blocked "
              f"(perf.phase.comm_blocked "
              f"{split[-1][0]['blocked_ms'] / w:.3f} ms) of "
              f"{split[-1][0]['seconds'] / w * 1e3:.3f} ms a window")
        print(f"  the same all-reduce alone (one {red['bytes'] / w / 1e6:.3f} "
              f"MB bucket, the card idle, after a barrier): "
              + " / ".join(f"{a['allreduce_ms']:.3f}" for a in extra)
              + f" ms on rank 0 / rank 1 (median of 20) on {gpu}")
        for r, a in enumerate(extra):
            ov = a["overlap"]
            ph = ov["phases"]
            print(f"  rank {r}, overlapped (comm_overlap=True, "
                  f"{ov['windows']} epochs): {ov['sps']:.1f} samples/s = "
                  f"{ov['sps'] / s_split:.3f} of the blocked split median, "
                  f"{ov['seconds'] / ov['windows'] * 1e3:.3f} ms a window, "
                  f"comm_overlap {ph['comm_overlap']['total_ms']:.3f} ms "
                  f"over {ph['comm_overlap']['count']} submits, comm_blocked "
                  f"{ph['comm_blocked']['total_ms']:.3f} ms over "
                  f"{ph['comm_blocked']['count']} waits; under "
                  f"torch.profiler (2 epochs): device busy "
                  f"{a['busy_ms']:.3f} ms in {a['ops']} operations of "
                  f"{a['train_ms']:.3f} ms training: idle "
                  f"{max(0.0, 1 - a['busy_ms'] / a['train_ms']):.1%} on {gpu}")

        print("phase 16c: phase 10's ADAG gate split over 2 ranks")
        # 16d's later incarnations start now, and wait at their gates
        pre = procs.launch("preempt", ["det"], device, p, mode="preempt",
                           env=det_env("preempt"))
        res = procs.launch("resume", ["det"], device, p, mode="resume",
                           env=det_env("resume"))
        gates.open("gate")
        ans = gates.answers("gate")
        for r, a in enumerate(ans):
            print(f"  rank {r} (workers [{a['lo']}, {a['hi']})): accuracy "
                  f"{a['acc']:.4f} (threshold {p['gate_acc']:.2f}), history "
                  f"{a['history']}, training {a['seconds']:.3f} s on {gpu}")
            require(a["finite"] and a["acc"] >= p["gate_acc"],
                    f"16c rank {r}: accuracy {a['acc']}")

        print("phase 16d: coordinated preemption and a bit-equal resume "
              "(SingleTrainer, then ADAG 2 x 2; DK_COORD_DIR)")
        gates.answers("det_full")
        # 16b's control: the ranks out of the group, training alone at once
        gates.open("solo_warm", {"epochs": 2})
        gates.answers("solo_warm")
        gates.open("solo", {"epochs": epochs})
        solo = gates.answers("solo")
        s_solo = sum(a["sps"] for a in solo)
        print(f"  16b's control: the two ranks out of the group (world "
              f"{[a['world'] for a in solo]}), each training its 2 workers "
              f"on half the rows alone, at once: "
              + " + ".join(f"{a['sps']:.1f}" for a in solo)
              + f" = {s_solo:.1f} samples/s = {s_solo / s_one:.3f} of the "
              f"one-process rate, {s_solo / s_split:.3f} of the split's "
              f"({epochs} epochs) on {gpu}")
        require(all(a["world"] == 1 for a in solo),
                f"16b's control ran in a group: {solo}")
        for q in main:
            procs.finish(q)
            require(q.returncode == 0, f"{q.label} exited {q.returncode}")
        gates.procs = pre
        gates.open("preempt")
        for q in pre:
            procs.finish(q)
            require(q.returncode == 143, f"{q.label} exited {q.returncode}, "
                    f"wanted 143: {procs.output(q)[-600:]}")
        from dist_keras_tpu_torch.checkpoint import Checkpointer

        spe = {"single": p["det_rows"] // p["det_batch"],
               "adag": p["det_rows"] // ADAG_WORKERS // p["det_batch"]
               // p["det_window"]}
        for name in ("single", "adag"):
            got = gates.answers(f"{name}_preempt")
            steps = Checkpointer(str(work / f"ck_{name}"), rank=0,
                                 world=MP_RANKS).all_steps()
            agreed = p["det_kill_epoch"] * spe[name]
            print(f"  {name}: Preempted codes {[a['code'] for a in got]}, "
                  f"saved steps {[a['saved'] for a in got]}, committed "
                  f"steps {steps} (agreed {agreed})")
            require(all(a["code"] == 143 and a["saved"] == agreed
                        for a in got) and steps == [agreed],
                    f"16d {name}: {got}, steps {steps}")
        dumps = sorted(Path(obs["preempt"]).glob("flightrec-*-preempt.json"))
        by_rank = sorted({d.name.split("-")[1] for d in dumps})
        print(f"  preempt flight dumps: {len(dumps)} ({by_rank})")
        require(by_rank == [f"rank_{r}" for r in range(MP_RANKS)],
                f"16d: preempt dumps {[d.name for d in dumps]}")
        gates.procs = res
        gates.open("resume")
        for q in res:
            procs.finish(q)
            require(q.returncode == 0, f"{q.label} exited {q.returncode}: "
                    f"{procs.output(q)[-600:]}")
        for name in ("single", "adag"):
            equal = all(
                all(np.array_equal(a, b) for a, b in zip(
                    load_leaves(work / f"{name}_full_{r}.npz"),
                    load_leaves(work / f"{name}_resume_{r}.npz")))
                for r in range(MP_RANKS))
            print(f"  {name}: each rank's resumed weights bit-equal to its "
                  f"uninterrupted run: {equal} on {gpu}")
            require(equal, f"16d {name}: the resume differs")
    finally:
        procs.close()
        shutil.rmtree(work, ignore_errors=True)
    counts = kernel_counts(fa, fu, da)
    procs.add_kernels("phase 16's own process", counts)
    print(f"  hand-written kernels launched by phase 16, summed over its "
          f"{len(procs.counted)} processes: {procs.kernels} (none is on "
          f"this path)")
    require(len(procs.counted) == len(procs.procs) + 1,
            f"{len(procs.procs) + 1 - len(procs.counted)} of phase 16's "
            f"processes reported no launch counters")
    require(not any(procs.kernels.values()),
            f"phase 16 launched a hand-written kernel: {procs.kernels}")
    print(f"  phase 16 wall {time.perf_counter() - t0:.1f} s on {gpu}")


# -- phase 17: the MoE transformer, experts and sequence over ranks ---------
MOE = dict(moe_experts=8, moe_capacity_factor=1.25)   # the JAX default factor
MOE_AUX = 1e-2          # make_moe_train_step's aux_weight
EP_TOL = 1e-5           # 17b: of the largest weight, against the witness
# bench_transformer_tp's widths; a rehearsal on the CPU passes smaller ones
PHASE17 = dict(model=TRAIN_MODEL, batch=TRAIN_BATCH, steps=TRAIN_STEPS,
               plain_tokens=2048, ep_batch=2, ep_steps=3, ep_timed=3,
               ring_batch=16, sp_batch=16, sp_steps=3, sp_timed=3, lr=0.01)


def moe_cfg(p):
    from dist_keras_tpu_torch.models.transformer import transformer_config

    return transformer_config(**p["model"], **MOE)


def moe_loss_and_grads(params, x, y, cfg, attn_fn=None, compute_dtype=None):
    """(loss, grads) of one step of ``make_moe_train_step``'s objective
    (nll + MOE_AUX * aux, causal), its attention swappable."""
    import torch

    from dist_keras_tpu_torch.models.transformer import (
        transformer_apply_with_aux,
    )
    from dist_keras_tpu_torch.utils.pytree import (
        tree_cast,
        tree_leaves,
        tree_unflatten,
    )

    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    if compute_dtype is not None:
        p, x = tree_cast(p, compute_dtype), x.to(compute_dtype)
    logits, aux = transformer_apply_with_aux(p, x, cfg, causal=True,
                                             attn_fn=attn_fn)
    nll = -torch.log_softmax(logits.float(), -1).gather(
        1, y.long()[:, None]).mean()
    loss = nll + MOE_AUX * aux
    return loss.detach(), tree_unflatten(params, torch.autograd.grad(
        loss, leaves))


class Routes:
    """Stands in for ``parallel.moe._route`` while :meth:`run` runs:
    ``"record"`` keeps every MoE layer's (expert, position, keep) of the
    run, ``"replay"`` hands the recorded ones back, layer by layer, to a
    second run.  In both the gate is the softmax at the routed expert
    and the aux loss the Switch one over the routed experts, so two runs
    whose attention differs route every token alike."""

    def __init__(self):
        from dist_keras_tpu_torch.parallel import moe as tmoe

        self.moe, self.route, self.saved = tmoe, tmoe._route, []

    def __call__(self, params, x, num_experts, capacity):
        import torch

        if self.mode == "record":
            expert, pos, keep = self.route(params, x, num_experts,
                                           capacity)[:3]
            self.saved.append((expert, pos, keep))
        else:
            expert, pos, keep = self.saved[self.i]
            self.i += 1
        probs = torch.softmax((x @ params["router"]).float(), dim=-1)
        gate = probs.gather(1, expert[:, None])[:, 0]
        frac = torch.nn.functional.one_hot(expert, num_experts).float()
        aux = torch.sum(frac.mean(0) * probs.mean(0)) * num_experts
        return expert, pos, keep, gate, probs, aux

    def run(self, mode, fn):
        self.mode, self.i = mode, 0
        self.moe._route = self
        try:
            return fn()
        finally:
            self.moe._route = self.route


def route_flips(a, b):
    """Two recorded runs' routing over all layers: -> (tokens sent to
    another expert, kept in one and dropped in the other, at another
    queue position (a flip moves every later token of its experts),
    token-layers)."""
    pairs = list(zip(a.saved, b.saved))
    return (sum(int((ea != eb).sum()) for (ea, _, _), (eb, _, _) in pairs),
            sum(int((ka != kb).sum()) for (_, _, ka), (_, _, kb) in pairs),
            sum(int(((ea != eb) | (pa != pb)).sum())
                for (ea, pa, _), (eb, pb, _) in pairs),
            sum(int(e.numel()) for e, _, _ in a.saved))


def moe_one_card(fa, fu, da, gpu, dev, p):
    """17a: the MoE transformer at full width on one card."""
    import torch

    from dist_keras_tpu_torch.models.transformer import transformer_config
    from dist_keras_tpu_torch.parallel import (
        make_moe_train_step,
        make_tp_train_step,
    )
    from dist_keras_tpu_torch.parallel import moe as tmoe
    from dist_keras_tpu_torch.utils.pytree import tree_leaves

    cfg = moe_cfg(p)
    cuda = dev.type == "cuda"
    init_fn, step = make_moe_train_step(cfg, causal=True,
                                        compute_dtype=torch.bfloat16,
                                        device=dev)
    params, opt_state = init_fn(0)
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_expert = sum(t.numel() for blk in params["blocks"]
                   for k, t in blk["moe"].items() if k != "router")
    b, t, e = p["batch"], cfg["seq_len"], cfg["moe_experts"]
    cap = math.ceil(b * t * MOE["moe_capacity_factor"] / e)
    print(f"  model {p['model']} + {MOE}, batch {b} causal, bf16 compute, "
          f"{n_params} f32 master params ({n_expert} in the experts), "
          f"adam(1e-3); {b * t} tokens a layer, capacity {cap} an expert")
    rng = np.random.default_rng(17)
    x, y = train_data(rng, dev, b, t)

    # one step through the kernels against the same step with plain
    # attention: f32 free, bf16 with the routing replayed (both runs route
    # every token alike), and bf16 free (recorded: a near-tie in the
    # router's softmax sends a token elsewhere when the attention differs)
    got = moe_loss_and_grads(params, x, y, cfg)
    want = moe_loss_and_grads(params, x, y, cfg, attn_fn=plain_block)
    compare_grads("one step, kernels vs plain attention, float32", got,
                  want, STEP_F32_TOL)
    del got, want
    bf16 = torch.bfloat16
    kern, plain = Routes(), Routes()
    got = kern.run("record", lambda: moe_loss_and_grads(
        params, x, y, cfg, compute_dtype=bf16))
    want = plain.run("record", lambda: moe_loss_and_grads(
        params, x, y, cfg, attn_fn=plain_block, compute_dtype=bf16))
    expert, dropped, moved, tokens = route_flips(kern, plain)
    errs = [float((g - w).norm() / w.norm().clamp_min(1e-30))
            for g, w in zip(tree_leaves(got[1]), tree_leaves(want[1]))]
    print(f"  one step, kernels vs plain attention, bfloat16, each routing "
          f"its own (recorded): of {tokens} token-layers, {expert} "
          f"({expert / tokens:.3%}) sent to another expert, {dropped} "
          f"kept by one run and dropped by the other, {moved} at another "
          f"queue position; loss {float(got[0]):.6f} vs "
          f"{float(want[0]):.6f}; largest per-leaf relative norm error "
          f"{max(errs):.3e}, median {float(np.median(errs)):.3e}")
    del want
    want = kern.run("replay", lambda: moe_loss_and_grads(
        params, x, y, cfg, attn_fn=plain_block, compute_dtype=bf16))
    again = kern.run("replay", lambda: moe_loss_and_grads(
        params, x, y, cfg, compute_dtype=bf16))
    compare_grads("one step, kernels vs plain attention, bfloat16, the "
                  "kernels' routing replayed in both", again, want,
                  STEP_BF16_TOL)
    del got, want, again
    if cuda:
        torch.cuda.empty_cache()

    # the index dispatch against the one-hot plain version where its
    # (N, E, C) tensors fit
    blk = params["blocks"][0]["moe"]
    tok = torch.from_numpy(rng.standard_normal(
        (p["plain_tokens"], cfg["d_model"]), np.float32)).to(dev)
    idx_out, idx_aux = tmoe.switch_moe_dense(blk, tok, MOE[
        "moe_capacity_factor"])
    ref_out, ref_aux = tmoe.switch_moe_dense_reference(
        blk, tok, MOE["moe_capacity_factor"])
    equal = torch.equal(idx_out, ref_out) and torch.equal(idx_aux, ref_aux)
    line = (f"  switch_moe_dense (index dispatch) against the one-hot plain "
            f"version at N={p['plain_tokens']} tokens, f32: bit-equal "
            f"{equal}")
    if cuda:
        ms = [time_ms(lambda: fn(blk, tok), 5, 3) for fn in (
            tmoe.switch_moe_dense, tmoe.switch_moe_dense_reference)]
        line += f"; {ms[0]:.4f} ms against {ms[1]:.4f} ms on {gpu}"
    print(line)
    require(equal, "the index dispatch differs from the one-hot version")
    del tok, idx_out, ref_out

    # the main path: adam steps through make_moe_train_step
    params, opt_state = init_fn(0)
    if cuda:
        torch.cuda.synchronize()
    zero_kernel_counts(fa, fu, da)
    metrics = []
    t0 = time.perf_counter()
    for _ in range(p["steps"]):
        params, opt_state, m = step(params, opt_state, x, y)
        metrics.append(m)
    metrics = [{k: float(v) for k, v in m.items()} for m in metrics]
    wall = time.perf_counter() - t0
    launches = kernel_counts(fa, fu, da)
    print(f"  {p['steps']} adam steps: loss "
          f"{[round(m['loss'], 5) for m in metrics]}, aux "
          f"{[round(m['aux'], 4) for m in metrics]}")
    print(f"  launches on the main path: {launches}")
    require(all(np.isfinite(list(m.values())).all() for m in metrics),
            "a MoE training metric is not finite")
    per = p["steps"] * cfg["n_layers"]
    if cuda:
        require(launches["flash_fwd"] == per and launches["flash_bwd_dq"]
                == per and launches["flash_bwd_dkv"] == per
                and not launches["flash_bwd_fused"]
                and not launches["paged_decode"],
                f"expected {per} launches of K1, K2 and K3 (one per layer "
                f"per step) and none of K4 / K5, got {launches}")
    tokens = b * t * p["steps"]
    print(f"  MoE training: {tokens} tokens in {wall:.3f} s = "
          f"{tokens / wall:.1f} tokens/s on {gpu}")
    if not cuda:
        return launches

    def one_step():
        return step(params, opt_state, x, y)

    device_ms = time_ms(one_step, reps=3, trials=3, sleep_ms=400)
    walls = []
    for _ in range(3):
        t1 = time.perf_counter()
        float(one_step()[2]["loss"])
        walls.append((time.perf_counter() - t1) * 1e3)
    wall_ms = float(np.median(walls))
    dense_factory, dense_init = make_tp_train_step(
        transformer_config(**p["model"]), causal=True,
        compute_dtype=torch.bfloat16, device=dev)
    dparams, dopt = dense_init(0)
    dstep = dense_factory(dparams, dopt)
    dense_ms = time_ms(lambda: dstep(dparams, dopt, x, y), reps=3, trials=3,
                       sleep_ms=400)
    del dparams, dopt
    print(f"  MoE train step [B={b} T={t}] on {gpu}: wall {wall_ms:.3f} ms, "
          f"device {device_ms:.3f} ms, card idle "
          f"{max(0.0, 1 - device_ms / wall_ms):.0%} of the step; the dense "
          f"step of phase 7 in this call: device {dense_ms:.3f} ms (MoE / "
          f"dense {device_ms / dense_ms:.3f})")
    profile_step(one_step, gpu)
    # the MoE layer alone at the step's shape, forward and backward
    y2 = torch.randn(b * t, cfg["d_model"], device=dev, dtype=torch.bfloat16,
                     requires_grad=True)
    lp = {k: v.detach().bfloat16().requires_grad_()
          for k, v in params["blocks"][0]["moe"].items()}

    def layer():
        out, aux = tmoe.switch_moe_dense(lp, y2, MOE["moe_capacity_factor"])
        torch.autograd.backward((out, aux), (torch.ones_like(out), None))

    layer_ms = time_ms(layer, reps=3, trials=3)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        layer()
        torch.cuda.synchronize()
    top = sorted(((ev.self_device_time_total, ev.key)
                  for ev in prof.key_averages()
                  if ev.self_device_time_total > 0), reverse=True)
    total = sum(us for us, _ in top)
    require(total > 0, "the profiler saw no device time in the MoE layer")
    print(f"  one MoE layer [N={b * t} d={cfg['d_model']} E={e} C={cap} "
          f"bf16], forward and backward: {layer_ms:.3f} ms (CUDA events); "
          f"by kernel (torch.profiler) {total / 1e3:.3f} ms: " + "; ".join(
              f"{name[:60]} {us / 1e3:.3f} ms ({us / total:.1%})"
              for us, name in top[:6]) + f" on {gpu}")
    return launches


def mp_task_ep(cfg, gates, rank):
    """17b: ``make_moe_ep_train_step`` over the ranks (f32, sgd), held to
    a witness in this process (the same steps with every rank's block
    through the dense mixture at the block's capacity, grads summed);
    then its samples/s, and rank 0's against one process alone."""
    import hashlib

    import torch

    from dist_keras_tpu_torch import comm
    from dist_keras_tpu_torch.ops import decode_attention as da
    from dist_keras_tpu_torch.ops import flash_attention as fa
    from dist_keras_tpu_torch.ops import fused_bwd_experimental as fu
    from dist_keras_tpu_torch.ops.optimizers import apply_updates, sgd
    from dist_keras_tpu_torch.parallel import collectives
    from dist_keras_tpu_torch.parallel import (
        EXPERT_AXIS,
        make_moe_ep_train_step,
        make_moe_train_step,
    )
    from dist_keras_tpu_torch.parallel.mesh import rank_axis
    from dist_keras_tpu_torch.parallel.moe import (
        moe_transformer_param_specs,
        split_moe_params,
    )
    from dist_keras_tpu_torch.utils.pytree import tree_leaves, tree_map

    p = cfg["sizes"]
    dev = torch.device(cfg["device"])
    cuda = dev.type == "cuda"
    mcfg = moe_cfg(p)
    axis = rank_axis(EXPERT_AXIS)
    b, t = p["ep_batch"], mcfg["seq_len"]
    rng = np.random.default_rng(171)
    xs = torch.from_numpy(rng.standard_normal(
        (axis.size * b, t, mcfg["input_dim"]), np.float32)).to(dev)
    ys = torch.from_numpy(rng.integers(0, mcfg["n_classes"],
                                       axis.size * b)).to(dev)
    x, y = xs[rank * b:(rank + 1) * b], ys[rank * b:(rank + 1) * b]
    tx = sgd(p["lr"])
    factory, init_fn = make_moe_ep_train_step(mcfg, optimizer=tx,
                                              causal=True, device=dev)
    params, opt = init_fn(0)
    step = factory(params, opt)
    gates.wait_open("ep")
    if cuda:
        torch.cuda.synchronize()
    zero_kernel_counts(fa, fu, da)
    for op in ("all_to_all", "all_reduce"):
        collectives.reduce_stats(reset=True, op=op)
    metrics = []
    for _ in range(p["ep_steps"]):
        params, opt, m = step(params, opt, x, y)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = kernel_counts(fa, fu, da)
    exchange = collectives.reduce_stats(op="all_to_all")
    reduce = collectives.reduce_stats(op="all_reduce")

    # the witness: the full tree from the same seed, every rank's block
    # through the dense mixture at the block's capacity, grads summed
    wparams, _ = make_moe_train_step(mcfg, optimizer=tx, device=dev)[0](0)
    wopt = tx.init(wparams)
    for _ in range(p["ep_steps"]):
        grads = None
        for r in range(axis.size):
            sl = slice(r * b, (r + 1) * b)
            _, g = moe_loss_and_grads(wparams, xs[sl], ys[sl], mcfg)
            grads = g if grads is None else tree_map(torch.add, grads, g)
        grads = tree_map(lambda v: v / axis.size, grads)
        updates, wopt = tx.update(grads, wopt, wparams)
        wparams = apply_updates(wparams, updates)
    mine = split_moe_params(wparams, axis)
    scale = max(float(v.abs().max()) for v in tree_leaves(mine))
    err = max(float((a - w).abs().max()) for a, w in
              zip(tree_leaves(params), tree_leaves(mine))) / scale
    specs = tree_leaves(moe_transformer_param_specs(params))
    digest = hashlib.sha256()
    for v, s in zip(tree_leaves(params), specs):
        if not s:
            digest.update(v.detach().cpu().numpy().tobytes())
    del wparams, wopt, mine, grads

    # samples/s over the ranks, then one process alone (rank 0, the other
    # rank waiting at the barrier)
    comm.barrier("ep_timed")
    t0 = time.perf_counter()
    for _ in range(p["ep_timed"]):
        params, opt, m = step(params, opt, x, y)
    float(m["loss"])
    split_s = time.perf_counter() - t0
    comm.barrier("ep_alone")
    alone_s = None
    if rank == 0:
        one_init, one_step = make_moe_train_step(mcfg, optimizer=tx,
                                                 causal=True, device=dev)
        op_, oo = one_init(0)
        op_, oo, m = one_step(op_, oo, xs, ys)
        float(m["loss"])
        t0 = time.perf_counter()
        for _ in range(p["ep_timed"]):
            op_, oo, m = one_step(op_, oo, xs, ys)
        float(m["loss"])
        alone_s = time.perf_counter() - t0
        del op_, oo
    comm.barrier("ep_done")
    gates.answer("ep", rank, {
        "metrics": metrics, "launches": launches, "exchange": exchange,
        "reduce": reduce, "err": err, "digest": digest.hexdigest(),
        "split_sps": axis.size * b * p["ep_timed"] / split_s,
        "alone_sps": (axis.size * b * p["ep_timed"] / alone_s
                      if alone_s else None),
        "steps": p["ep_steps"], "ranks": axis.size})


def mp_task_ring_sp(cfg, gates, rank):
    """17c: ``ring_attention`` against one-process flash attention on the
    whole sequence (bf16, f32), then the sequence-parallel step against
    the one-card step (rank 0 holds both; f32, sgd), its tokens/s and
    the ring's blocked time."""
    import hashlib

    import torch

    from dist_keras_tpu_torch import comm
    from dist_keras_tpu_torch.models.transformer import transformer_config
    from dist_keras_tpu_torch.ops import decode_attention as da
    from dist_keras_tpu_torch.ops import flash_attention as fa
    from dist_keras_tpu_torch.ops import fused_bwd_experimental as fu
    from dist_keras_tpu_torch.ops.attention import ring_attention
    from dist_keras_tpu_torch.ops.optimizers import sgd
    from dist_keras_tpu_torch.parallel import collectives, make_tp_mesh
    from dist_keras_tpu_torch.parallel import make_tp_train_step
    from dist_keras_tpu_torch.parallel.transformer_tp import (
        loss_and_grads,
        local_block,
    )
    from dist_keras_tpu_torch.utils.pytree import tree_leaves

    p = cfg["sizes"]
    dev = torch.device(cfg["device"])
    cuda = dev.type == "cuda"
    model = p["model"]
    mesh = make_tp_mesh(sp=comm.num_processes())
    n, t = mesh.seq.size, model["seq_len"]
    h = model["n_heads"]
    d = model["d_model"] // h
    tl = t // n
    sl = slice(rank * tl, (rank + 1) * tl)
    rng = np.random.default_rng(172)
    gates.wait_open("ring_sp")
    ring = {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        q, k, v, g = (torch.from_numpy(rng.standard_normal(
            (p["ring_batch"], t, h, d), np.float32)).to(dev) for _ in range(4))
        whole = [a.to(dtype).requires_grad_() for a in (q, k, v)]
        out, _ = fa.flash_attention_with_lse(*whole, causal=True)
        (out.float() * g).sum().backward()
        mine = [a.to(dtype)[:, sl].detach().requires_grad_()
                for a in (q, k, v)]
        got = ring_attention(*mine, mesh.seq, causal=True)
        (got.float() * g[:, sl]).sum().backward()
        errs = [rel_err(got, out[:, sl].detach())] + [
            rel_err(m.grad, w.grad[:, sl]) for m, w in zip(mine, whole)]
        ring[str(dtype)[6:]] = {"errs": errs, "tol": tol}
        del q, k, v, g, whole, out, mine, got
    if cuda:
        torch.cuda.empty_cache()

    scfg = transformer_config(**model)
    x = torch.from_numpy(rng.standard_normal(
        (p["sp_batch"], t, scfg["input_dim"]), np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, scfg["n_classes"],
                                      p["sp_batch"])).to(dev)
    xb = local_block(x, mesh)
    tx = sgd(p["lr"])
    factory, init_fn = make_tp_train_step(scfg, optimizer=tx, causal=True,
                                          device=dev, mesh=mesh)
    params, opt = init_fn(0)
    loss, grads = loss_and_grads(params, xb, y, scfg, causal=True, mesh=mesh)
    step = factory(params, opt)
    if cuda:
        torch.cuda.synchronize()
    zero_kernel_counts(fa, fu, da)
    for op in ("ring", "all_reduce"):
        collectives.reduce_stats(reset=True, op=op)
    losses = []
    for _ in range(p["sp_steps"]):
        params, opt, lv = step(params, opt, xb, y)
        losses.append(float(lv))
    launches = kernel_counts(fa, fu, da)
    shifts = collectives.reduce_stats(op="ring")
    reduce = collectives.reduce_stats(op="all_reduce")
    digest = hashlib.sha256()
    for v in tree_leaves(params):
        digest.update(v.detach().cpu().numpy().tobytes())
    comm.barrier("sp_ref")
    ref = None
    if rank == 0:
        # the one-card step on the whole sequence, the ranks' inputs
        ofactory, oinit = make_tp_train_step(scfg, optimizer=tx, causal=True,
                                             device=dev)
        oparams, oopt = oinit(0)
        oloss, ograds = loss_and_grads(oparams, x, y, scfg, causal=True)
        gerr = [float((a - w).norm() / w.norm().clamp_min(1e-30))
                for a, w in zip(tree_leaves(grads), tree_leaves(ograds))]
        del ograds
        ostep = ofactory(oparams, oopt)
        olosses = []
        for _ in range(p["sp_steps"]):
            oparams, oopt, lv = ostep(oparams, oopt, x, y)
            olosses.append(float(lv))
        perr = [float((a - w).norm() / w.norm().clamp_min(1e-30))
                for a, w in zip(tree_leaves(params), tree_leaves(oparams))]
        float(ostep(oparams, oopt, x, y)[2])
        t0 = time.perf_counter()
        for _ in range(p["sp_timed"]):
            oparams, oopt, lv = ostep(oparams, oopt, x, y)
        float(lv)
        one_s = time.perf_counter() - t0
        ref = {"loss_err": abs(float(loss) - float(oloss))
               / abs(float(oloss)), "grad_err": max(gerr),
               "param_err": max(perr), "losses": olosses,
               "tokens_s": p["sp_batch"] * t * p["sp_timed"] / one_s}
        del oparams, oopt
    comm.barrier("sp_timed")
    collectives.reduce_stats(reset=True, op="ring")
    t0 = time.perf_counter()
    for _ in range(p["sp_timed"]):
        params, opt, lv = step(params, opt, xb, y)
    float(lv)
    sp_s = time.perf_counter() - t0
    timed_ring = collectives.reduce_stats(op="ring")
    gates.answer("ring_sp", rank, {
        "ring": ring, "losses": losses, "launches": launches,
        "shifts": shifts, "reduce": reduce, "digest": digest.hexdigest(),
        "ref": ref, "tokens_s": p["sp_batch"] * t * p["sp_timed"] / sp_s,
        "ring_ms": timed_ring["seconds"] / p["sp_timed"] * 1e3,
        "ring_mb": timed_ring["bytes"] / p["sp_timed"] / 1e6,
        "ranks": n})


def moe_and_sp_across_ranks(fa, fu, da, gpu, device, p):
    """17b and 17c: two rank processes (``--mp-role``) sharing the card
    under gloo. -> the K1-K3 launches of their main paths (the EP and
    the SP steps), summed over the ranks."""
    import shutil
    import tempfile

    work = Path(tempfile.mkdtemp(prefix="dk_mp_phase17_"))
    procs = MPProcs(work)
    gates = Gates(work)
    launches = {}
    try:
        ranks = procs.launch("p17", ["ep", "ring_sp"], device, p)
        gates.procs = ranks
        print("phase 17b: make_moe_ep_train_step over 2 ranks (4 experts "
              "each) sharing the card under gloo")
        gates.open("ep")
        ans = gates.answers("ep")
        for r, q in enumerate(ranks):
            init = procs.init(q)
            print(f"  rank {r}: backend {init['backend']} on "
                  f"{init['device']}, group up in {init['init_s']:.2f} s")
        a0 = ans[0]
        per_step = {k: a0["exchange"][k] / a0["steps"]
                    for k in ("calls", "bytes", "seconds")}
        print(f"  {MOE['moe_experts']} experts over {a0['ranks']} ranks, "
              f"{p['ep_batch']} sequences a rank, f32, sgd({p['lr']}), "
              f"{a0['steps']} steps: losses "
              + " / ".join(str([round(m["loss"], 6) for m in a["metrics"]])
                           for a in ans)
              + " (rank 0 / rank 1)")
        for r, a in enumerate(ans):
            print(f"  rank {r}: params against the witness (every rank's "
                  f"block through the dense mixture in one process, grads "
                  f"summed) {a['err']:.3e} of the largest weight (held to "
                  f"{EP_TOL:g}); launches {a['launches']}")
        same = len({a["digest"] for a in ans}) == 1
        print(f"  the ranks' replicated leaves bit-equal: {same}")
        print(f"  the exchange (all_to_all, staged through pinned host "
              f"buffers under gloo), rank 0: {per_step['calls']:.0f} calls, "
              f"{per_step['bytes'] / 1e6:.3f} MB and "
              f"{per_step['seconds'] * 1e3:.3f} ms blocked a step; the "
              f"replicated grads' packed all-reduce "
              f"{a0['reduce']['bytes'] / a0['steps'] / 1e6:.3f} MB and "
              f"{a0['reduce']['seconds'] / a0['steps'] * 1e3:.3f} ms a step")
        split = " / ".join(f"{a['split_sps']:.2f}" for a in ans)
        print(f"  samples/s: 2 ranks {split} "
              f"(rank 0 / rank 1, {p['ep_timed']} steps); one process alone "
              f"on the whole batch {a0['alone_sps']:.2f} (recorded, not "
              f"gated) on {gpu}")
        require(same and all(a["err"] <= EP_TOL for a in ans)
                and all(np.isfinite([m["loss"] for m in a["metrics"]]).all()
                        for a in ans),
                f"17b: errs {[a['err'] for a in ans]}, ranks equal {same}")
        require(a0["exchange"]["calls"] == 4 * p["model"]["n_layers"]
                * a0["steps"], f"17b: {a0['exchange']['calls']} exchanges")
        for a in ans:
            for k, v in a["launches"].items():
                launches[k] = launches.get(k, 0) + v

        print("phase 17c: ring attention and the sequence-parallel step over "
              "2 ranks sharing the card under gloo")
        gates.open("ring_sp")
        ans = gates.answers("ring_sp")
        t = p["model"]["seq_len"]
        for r, a in enumerate(ans):
            for dt, res in a["ring"].items():
                print(f"  rank {r}: ring_attention [B={p['ring_batch']} "
                      f"T={t} ({t // a['ranks']} a rank) "
                      f"H={p['model']['n_heads']} causal {dt}] "
                      f"against flash_attention_with_lse on the whole "
                      f"sequence, relative to the largest entry: out "
                      f"{res['errs'][0]:.3e}, dq {res['errs'][1]:.3e}, dk "
                      f"{res['errs'][2]:.3e}, dv {res['errs'][3]:.3e} (tol "
                      f"{res['tol']:g})")
                require(max(res["errs"]) <= res["tol"],
                        f"17c rank {r}: ring_attention {dt} disagrees")
        ref = ans[0]["ref"]
        same = len({a["digest"] for a in ans}) == 1
        print(f"  the SP step [sp=2, B={p['sp_batch']}, f32, sgd({p['lr']})] "
              f"against the one-card step: loss relative "
              f"{ref['loss_err']:.3e}, largest per-leaf relative norm error "
              f"of the grads {ref['grad_err']:.3e} (tol {STEP_F32_TOL:g}), "
              f"of the params after {p['sp_steps']} steps "
              f"{ref['param_err']:.3e}; losses {ans[0]['losses']} against "
              f"{ref['losses']}; the ranks' params bit-equal: {same}")
        require(ref["grad_err"] <= STEP_F32_TOL and ref["loss_err"]
                <= STEP_F32_TOL and ref["param_err"] <= STEP_F32_TOL
                and same, "17c: the SP step disagrees with the one-card step")
        sp2 = " / ".join(f"{a['tokens_s']:.1f}" for a in ans)
        print(f"  tokens/s: sp=2 {sp2} "
              f"(rank 0 / rank 1), sp=1 (rank 0 alone) {ref['tokens_s']:.1f}: "
              f"{ans[0]['tokens_s'] / ref['tokens_s']:.3f} of one card; the "
              f"ring's shifts {ans[0]['ring_mb']:.1f} MB and "
              f"{ans[0]['ring_ms']:.3f} ms blocked a step on rank 0 "
              f"(recorded, not gated) on {gpu}")
        for r, a in enumerate(ans):
            print(f"  rank {r}: launches of the SP step ({p['sp_steps']} "
                  f"steps) {a['launches']}")
            for k, v in a["launches"].items():
                launches[k] = launches.get(k, 0) + v
        for q in ranks:
            procs.finish(q)
            require(q.returncode == 0, f"{q.label} exited {q.returncode}: "
                    f"{procs.output(q)[-600:]}")
    finally:
        procs.close()
        shutil.rmtree(work, ignore_errors=True)
    return launches


def moe_and_sequence(fa, fu, da, gpu, device="cuda", sizes=None):
    """Phase 17: 17a the MoE transformer on one card, 17b expert
    parallelism and 17c ring attention and the SP step over two ranks.
    -> ({kernel: launches} of 17a's bf16 path, of 17b/c's f32 paths)."""
    import torch

    p = {**PHASE17, **(sizes or {})}
    t0 = time.perf_counter()
    print("phase 17a: the MoE transformer at full width on one card")
    bf16 = moe_one_card(fa, fu, da, gpu, torch.device(device), p)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    f32 = moe_and_sp_across_ranks(fa, fu, da, gpu, device, p)
    if torch.device(device).type == "cuda":
        for label, got in (("17a", bf16), ("17b + 17c", f32)):
            require(all(got[k] > 0 for k in ("flash_fwd", "flash_bwd_dq",
                                             "flash_bwd_dkv")),
                    f"{label}: a kernel of the path never launched: {got}")
    print(f"  phase 17 launches: 17a (bf16) {bf16}; 17b + 17c (f32, both "
          f"ranks) {f32}")
    print(f"  phase 17 wall {time.perf_counter() - t0:.1f} s on {gpu}")
    return bf16, f32


MP_TASKS.update(ep=mp_task_ep, ring_sp=mp_task_ring_sp)


# ---------------------------------------------------------------------------
# phase 18: the transformer across ranks (TP, FSDP, the pipeline)
# ---------------------------------------------------------------------------
SPLIT_TOL = 1e-4        # 18a-c: split run against one process, f32
# bench_transformer_tp's widths; a rehearsal on the CPU passes smaller ones
PHASE18 = dict(model=TRAIN_MODEL, batch=TRAIN_BATCH, steps=2, timed=2,
               lr=0.01, adam_lr=1e-3, microbatches=8,
               fsdp_min_elems=2 ** 12)   # fsdp_specs' default


def leaf_errs(got, want):
    """Per-leaf relative norm errors of two trees (same leaf order)."""
    from dist_keras_tpu_torch.utils.pytree import tree_leaves

    return [float((a.float() - w.float()).norm()
                  / w.float().norm().clamp_min(1e-30))
            for a, w in zip(tree_leaves(got), tree_leaves(want))]


def leaf_max_errs(got, want):
    """Per-leaf max |got - want| over the leaf's largest |want|."""
    from dist_keras_tpu_torch.utils.pytree import tree_leaves

    return [rel_err(a, w) for a, w in zip(tree_leaves(got),
                                          tree_leaves(want))]


def replicated_digest(tree, specs):
    """SHA-256 of the leaves whose spec names no mesh axis."""
    import hashlib

    from dist_keras_tpu_torch.parallel.mesh import tree_map_specs

    digest = hashlib.sha256()
    tree_map_specs(lambda v, sp: None if any(sp) else digest.update(
        v.detach().cpu().numpy().tobytes()), tree, specs)
    return digest.hexdigest()


def split_stats(ops):
    """``collectives.reduce_stats`` of each op, then zeroed."""
    from dist_keras_tpu_torch.parallel import collectives

    return {op: collectives.reduce_stats(reset=True, op=op) for op in ops}


def phase18_data(p, dev, seed):
    import torch

    from dist_keras_tpu_torch.models.transformer import transformer_config

    scfg = transformer_config(**p["model"])
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(
        (p["batch"], scfg["seq_len"], scfg["input_dim"]), np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, scfg["n_classes"],
                                      p["batch"])).to(dev)
    return scfg, x, y


def full_params(scfg, dev, seed=0):
    import torch

    from dist_keras_tpu_torch.models.transformer import (
        init_transformer_params,
    )
    from dist_keras_tpu_torch.utils.pytree import tree_map

    gen = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: t.to(dev), init_transformer_params(gen, scfg))


def one_process_sgd(params, x, y, scfg, tx, steps, dev):
    """The one-card TP step (no mesh) from ``params``: -> (losses,
    params after ``steps``)."""
    from dist_keras_tpu_torch.parallel import make_tp_train_step

    factory, _ = make_tp_train_step(scfg, optimizer=tx, causal=True,
                                    device=dev)
    opt = tx.init(params)
    step = factory(params, opt)
    losses = []
    for _ in range(steps):
        params, opt, lv = step(params, opt, x, y)
        losses.append(float(lv))
    return losses, params, step, opt


def timed_steps(step, state, data, n):
    """Seconds of ``n`` calls of ``step(*state, *data)``, each call's
    first ``len(state)`` outputs the next one's state (the last call's
    loss, the output after them, fetched to the host at the end)."""
    state = list(state)
    t0 = time.perf_counter()
    for _ in range(n):
        out = step(*state, *data)
        state = list(out[:len(state)])
    float(out[len(state)])
    return time.perf_counter() - t0


def mp_task_tp(cfg, gates, rank):
    """18a: the TP step at tp=2 (3 heads and half the FFN a rank), f32,
    sgd: its grads and params after the steps against the one-card step
    (rank 0 holds both), then one bf16 step against plain attention,
    tokens/s split against one process, the model axis's all-reduces."""
    import torch

    from dist_keras_tpu_torch import comm
    from dist_keras_tpu_torch.ops import decode_attention as da
    from dist_keras_tpu_torch.ops import flash_attention as fa
    from dist_keras_tpu_torch.ops import fused_bwd_experimental as fu
    from dist_keras_tpu_torch.ops.optimizers import sgd
    from dist_keras_tpu_torch.parallel import make_tp_mesh
    from dist_keras_tpu_torch.parallel.transformer_tp import (
        gather_tp_params,
        loss_and_grads,
        make_tp_train_step,
        param_specs,
        split_tp_params,
    )

    p = cfg["sizes"]
    dev = torch.device(cfg["device"])
    mesh = make_tp_mesh(tp=comm.num_processes())
    scfg, x, y = phase18_data(p, dev, 181)
    full = full_params(scfg, dev)
    params = split_tp_params(full, mesh)
    tx = sgd(p["lr"])
    factory, _ = make_tp_train_step(scfg, optimizer=tx, causal=True,
                                    device=dev, mesh=mesh)
    opt = tx.init(params)
    step = factory(params, opt)
    gates.wait_open("tp")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_kernel_counts(fa, fu, da)
    split_stats(("all_reduce", "all_gather"))
    loss, grads = loss_and_grads(params, x, y, scfg, causal=True, mesh=mesh)
    losses = []
    for _ in range(p["steps"]):
        params, opt, lv = step(params, opt, x, y)
        losses.append(float(lv))
    launches = kernel_counts(fa, fu, da)
    stats = split_stats(("all_reduce",))
    grads = gather_tp_params(grads, mesh)
    whole = gather_tp_params(params, mesh)
    digest = replicated_digest(params, param_specs(params))
    comm.barrier("tp_ref")
    ref = None
    if rank == 0:
        oloss, ograds = loss_and_grads(full, x, y, scfg, causal=True)
        gerr = leaf_max_errs(grads, ograds)
        del ograds
        olosses, oparams, ostep, oopt = one_process_sgd(
            full, x, y, scfg, tx, p["steps"], dev)
        perr = leaf_errs(whole, oparams)
        one_s = timed_steps(ostep, (oparams, oopt), (x, y), p["timed"])
        ref = {"loss_err": abs(float(loss) - float(oloss)) / abs(
            float(oloss)), "grad_err": max(gerr), "param_err": max(perr),
            "losses": olosses,
            "tokens_s": p["batch"] * scfg["seq_len"] * p["timed"] / one_s}
        del oparams, oopt, ostep
    del grads, whole
    comm.barrier("tp_timed")
    split_stats(("all_reduce",))
    split_s = timed_steps(step, (params, opt), (x, y), p["timed"])
    timed = split_stats(("all_reduce",))["all_reduce"]
    # one bf16 step, the kernels on each rank's heads, against one process
    # with plain attention
    _, bgrads = loss_and_grads(split_tp_params(full, mesh), x, y, scfg,
                               causal=True, compute_dtype=torch.bfloat16,
                               mesh=mesh)
    bgrads = gather_tp_params(bgrads, mesh)
    comm.barrier("tp_bf16")
    if rank == 0:
        _, pgrads = loss_and_grads(full, x, y, scfg, causal=True,
                                   compute_dtype=torch.bfloat16,
                                   attn_fn=plain_block)
        ref["bf16_err"] = max(leaf_errs(bgrads, pgrads))
        del pgrads
    del bgrads
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    comm.barrier("tp_done")
    gates.answer("tp", rank, {
        "losses": losses, "launches": launches, "stats": stats,
        "digest": digest, "ref": ref,
        "tokens_s": p["batch"] * scfg["seq_len"] * p["timed"] / split_s,
        "ar_ms": timed["seconds"] / p["timed"] * 1e3,
        "ar_mb": timed["bytes"] / p["timed"] / 1e6,
        "ar_calls": timed["calls"] / p["timed"], "steps": p["steps"],
        "ranks": mesh.model.size})


def mp_task_fsdp(cfg, gates, rank):
    """18b: FSDP over the ranks (the batch split, every big leaf and its
    optimizer state sharded), f32, against one process on the whole
    batch (rank 0): with adam, the losses of the steps and the gathered
    adam moments after the first (the grads' image); with sgd, the
    params after the steps.  Adam's params after the steps are held
    against one process that takes the ranks' step itself (each rank's
    rows apart, their grads and losses summed in rank order and
    divided), the losses and moments too; against the whole batch they
    are printed beside that process's own distance from it (the
    summation order alone).  Each rank's persistent bytes against one
    process's, samples/s split against one process, the gathers and
    scatters."""
    import torch

    from dist_keras_tpu_torch import comm
    from dist_keras_tpu_torch.models.transformer import transformer_apply
    from dist_keras_tpu_torch.ops import decode_attention as da
    from dist_keras_tpu_torch.ops import flash_attention as fa
    from dist_keras_tpu_torch.ops import fused_bwd_experimental as fu
    from dist_keras_tpu_torch.ops.optimizers import adam, apply_updates, sgd
    from dist_keras_tpu_torch.parallel import fsdp, grid_mesh
    from dist_keras_tpu_torch.parallel.mesh import P, tree_map_specs
    from dist_keras_tpu_torch.utils.pytree import tree_leaves, tree_unflatten

    p = cfg["sizes"]
    dev = torch.device(cfg["device"])
    mesh = grid_mesh({"workers": comm.num_processes()})
    scfg, x, y = phase18_data(p, dev, 182)
    full = full_params(scfg, dev)

    def apply_fn(params, xb):
        return transformer_apply(params, xb, scfg, causal=True)

    def loss_fn(logits, yb):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(1, yb.long()[:, None]).mean()

    def sharded(tx):
        init_fn, factory = fsdp.make_fsdp_train_step(
            mesh, loss_fn, apply_fn, optimizer=tx, device=dev,
            min_shard_elems=p["fsdp_min_elems"])
        sp, so = init_fn(full)
        return factory(sp, so), sp, so, factory.specs["params"]

    def gather(tree, specs):
        return fsdp.gather_by_specs(mesh, tree, specs)

    adam_tx, sgd_tx = adam(p["adam_lr"]), sgd(p["lr"])
    step, sp, so, specs = sharded(adam_tx)
    xb, yb = (fsdp.place_by_specs(mesh, t, P("workers")) for t in (x, y))
    gates.wait_open("fsdp")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    zero_kernel_counts(fa, fu, da)
    split_stats(("all_gather", "reduce_scatter", "all_reduce"))
    losses = []
    for i in range(p["steps"]):
        sp, so, lv = step(sp, so, xb, yb)
        losses.append(float(lv))
        if i == 0:
            moments = {k: gather(so[k], specs) for k in ("mu", "nu")}
    launches = kernel_counts(fa, fu, da)
    stats = split_stats(("all_gather", "reduce_scatter", "all_reduce"))
    nbytes = fsdp.persistent_bytes(sp, so)
    # params, adam's mu and nu: 1/n of each sharded leaf, every replicated
    # one whole; and the step count
    bound = 3 * sum(
        t.numel() * t.element_size() // (mesh.workers.size if split else 1)
        for t, split in zip(tree_leaves(full), tree_leaves(tree_map_specs(
            lambda _, s: any(s), full, specs)))) + 4
    digest = replicated_digest(sp, specs)
    adam_whole = gather(sp, specs)
    sstep, ssp, sso, _ = sharded(sgd_tx)
    for _ in range(p["steps"]):
        ssp, sso, _ = sstep(ssp, sso, xb, yb)
    sgd_whole = gather(ssp, specs)
    del sstep, ssp, sso
    comm.barrier("fsdp_ref")
    ref = None
    if rank == 0:
        n = mesh.workers.size

        def one_step(tx, parts=1):
            # parts > 1: the ranks' step on one process, the grads and
            # loss of each part summed in rank order, then divided
            def run(params, opt, x, y):
                leaves = [t.detach().requires_grad_()
                          for t in tree_leaves(params)]
                tree = tree_unflatten(params, leaves)
                gs = lv = None
                for xp, yp in zip(x.chunk(parts), y.chunk(parts)):
                    lp = loss_fn(apply_fn(tree, xp), yp)
                    g = torch.autograd.grad(lp, leaves)
                    gs = g if gs is None else [a + b for a, b in zip(gs, g)]
                    lv = lp.detach() if lv is None else lv + lp.detach()
                if parts > 1:
                    gs, lv = [g / parts for g in gs], lv / parts
                updates, opt = tx.update(tree_unflatten(params, gs), opt,
                                         params)
                return apply_updates(params, updates), opt, lv
            return run

        def adam_run(parts):
            params, opt, olosses = full, adam_tx.init(full), []
            ostep = one_step(adam_tx, parts)
            for i in range(p["steps"]):
                params, opt, lv = ostep(params, opt, x, y)
                olosses.append(float(lv))
                if i == 0:
                    merr = (leaf_errs(moments["mu"], opt["mu"])
                            + leaf_errs(moments["nu"], opt["nu"]))
            return params, opt, olosses, max(merr), ostep

        def loss_errs(a, b):
            return max(abs(u - w) / abs(w) for u, w in zip(a, b))

        params, opt, olosses, merr, ostep = adam_run(1)
        hparams, _, hlosses, hmerr, _ = adam_run(n)
        ref = {"moment_err": merr, "losses": olosses,
               "loss_err": loss_errs(losses, olosses),
               "adam_param_err": max(leaf_errs(adam_whole, params)),
               "order_err": max(leaf_errs(hparams, params)),
               "same_order_err": max(loss_errs(losses, hlosses), hmerr,
                                     max(leaf_errs(adam_whole, hparams))),
               "bytes": fsdp.persistent_bytes(params, opt)}
        del hparams
        one_s = timed_steps(ostep, (params, opt), (x, y), p["timed"])
        ref["sps"] = p["batch"] * p["timed"] / one_s
        del params, opt
        sparams, sopt = full, sgd_tx.init(full)
        for _ in range(p["steps"]):
            sparams, sopt, _ = one_step(sgd_tx)(sparams, sopt, x, y)
        ref["param_err"] = max(leaf_errs(sgd_whole, sparams))
        del sparams, sopt
    del moments, sgd_whole, adam_whole
    comm.barrier("fsdp_timed")
    split_stats(("all_gather", "reduce_scatter", "all_reduce"))
    split_s = timed_steps(step, (sp, so), (xb, yb), p["timed"])
    timed = split_stats(("all_gather", "reduce_scatter", "all_reduce"))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    comm.barrier("fsdp_done")
    gates.answer("fsdp", rank, {
        "losses": losses, "launches": launches, "stats": stats,
        "timed": timed, "bytes": nbytes, "bound": bound, "digest": digest,
        "ref": ref, "sps": p["batch"] * p["timed"] / split_s,
        "steps": p["steps"], "ranks": mesh.workers.size})


def layer_order(blocks, p, v):
    """Gathered stage blocks ((L, ...), or (P, v, Lpc, ...) with v > 1)
    -> the (L, ...) stack in layer order."""
    import torch

    from dist_keras_tpu_torch.utils.pytree import tree_map

    if v == 1:
        return blocks

    def unstack(a):
        lpc = a.shape[2]
        order = [None] * (p * v * lpc)
        for s_ in range(p):
            for c in range(v):
                for j in range(lpc):
                    order[(c * p + s_) * lpc + j] = a[s_, c, j]
        return torch.stack(order)

    return tree_map(unstack, blocks)


def mp_task_pp(cfg, gates, rank):
    """18c: the pipeline over the ranks (one stage a rank), 1F1B, then
    interleaved at v=2: loss, grads and the params after the sgd steps
    against the one-card step (rank 0), the stash peak, tokens/s split
    against one process, the point-to-point traffic."""
    import torch

    from dist_keras_tpu_torch import comm
    from dist_keras_tpu_torch.ops import decode_attention as da
    from dist_keras_tpu_torch.ops import flash_attention as fa
    from dist_keras_tpu_torch.ops import fused_bwd_experimental as fu
    from dist_keras_tpu_torch.ops.optimizers import sgd
    from dist_keras_tpu_torch.parallel import pipeline as pp
    from dist_keras_tpu_torch.parallel.transformer_tp import loss_and_grads

    p = cfg["sizes"]
    dev = torch.device(cfg["device"])
    mesh = pp.make_pp_mesh(comm.num_processes())
    nst = mesh.stages.size
    scfg, x, y = phase18_data(p, dev, 183)
    full = full_params(scfg, dev)
    rest = {k: v for k, v in full.items() if k != "blocks"}
    tx, m = sgd(p["lr"]), p["microbatches"]
    gates.wait_open("pp")
    ref = None
    if rank == 0:
        oloss, ograds = loss_and_grads(full, x, y, scfg, causal=True)
        olosses, oparams, ostep, oopt = one_process_sgd(
            full, x, y, scfg, tx, p["steps"], dev)
        one_s = timed_steps(ostep, (oparams, oopt), (x, y), p["timed"])
        ref = {"losses": olosses,
               "tokens_s": p["batch"] * scfg["seq_len"] * p["timed"] / one_s}
        del ostep, oopt
    runs = {}
    for v in (1, 2):
        stacked = (pp.stack_blocks_interleaved(full["blocks"], nst, v)
                   if v > 1 else pp.stack_blocks(full["blocks"]))
        blocks = pp.split_stage_blocks(stacked, mesh, v)
        del stacked
        factory, _ = pp.make_pp_train_step(mesh, scfg, m, optimizer=tx,
                                           causal=True, virtual=v,
                                           device=dev)
        ro, bo = tx.init(rest), tx.init(blocks)
        step = factory(rest, blocks, ro, bo)
        comm.barrier(f"pp_{v}")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        zero_kernel_counts(fa, fu, da)
        split_stats(("p2p", "all_reduce"))
        loss, aux, rg, bg = pp.pp_transformer_1f1b_grads(
            rest, blocks, x, y, scfg, m, causal=True, axis=mesh, virtual=v)
        peak = pp.stash_peak()
        r, b, o1, o2 = rest, blocks, ro, bo
        losses = []
        for _ in range(p["steps"]):
            r, b, o1, o2, lv, _ = step(r, b, o1, o2, x, y)
            losses.append(float(lv))
        launches = kernel_counts(fa, fu, da)
        stats = split_stats(("p2p", "all_reduce"))
        bg = layer_order(pp.gather_stage_blocks(bg, mesh, v), nst, v)
        b_whole = layer_order(pp.gather_stage_blocks(b, mesh, v), nst, v)
        res = {"losses": losses, "launches": launches, "stats": stats,
               "peak": peak, "bound": (min(m, 2 * nst - 1) if v == 1 else
                                       pp.interleaved_1f1b_stash_entries(
                                           nst, v, m))}
        if rank == 0:
            want_b = pp.stack_blocks(ograds["blocks"])
            want_r = {k: ograds[k] for k in rg}
            res["loss_err"] = abs(float(loss) - float(oloss)) / abs(
                float(oloss))
            res["grad_err"] = max(leaf_max_errs(rg, want_r)
                                  + leaf_max_errs(bg, want_b))
            res["param_err"] = max(
                leaf_errs({k: r[k] for k in rest},
                          {k: oparams[k] for k in rest})
                + leaf_errs(b_whole, pp.stack_blocks(oparams["blocks"])))
        del bg, b_whole, rg
        comm.barrier(f"pp_timed_{v}")
        split_stats(("p2p",))
        split_s = timed_steps(step, (r, b, o1, o2), (x, y), p["timed"])
        timed = split_stats(("p2p",))["p2p"]
        res.update(tokens_s=p["batch"] * scfg["seq_len"] * p["timed"]
                   / split_s, p2p_ms=timed["seconds"] / p["timed"] * 1e3,
                   p2p_mb=timed["bytes"] / p["timed"] / 1e6,
                   p2p_calls=timed["calls"] / p["timed"])
        runs[v] = res
        del r, b, o1, o2, step, blocks
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if rank == 0:
        del ograds, oparams
    comm.barrier("pp_done")
    gates.answer("pp", rank, {"runs": runs, "ref": ref, "stages": nst,
                              "microbatches": m})


def print_launches(label, ans):
    for r, a in enumerate(ans):
        print(f"  rank {r}: K1 / K2 / K3 launches of {label} "
              f"{a['launches']['flash_fwd']} / "
              f"{a['launches']['flash_bwd_dq']} / "
              f"{a['launches']['flash_bwd_dkv']}")


def transformer_across_ranks(fa, fu, da, gpu, device="cuda", sizes=None):
    """Phase 18: 18a the TP step at tp=2, 18b FSDP over 2 ranks, 18c the
    pipeline over 2 stages (1F1B, then interleaved at v=2), in two rank
    processes (``--mp-role``) sharing the card under gloo, each split run
    against one process in the same call.  -> the K1-K3 launches of the
    ranks' main paths, summed over the ranks."""
    import shutil
    import tempfile

    import torch

    p = {**PHASE18, **(sizes or {})}
    t0 = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="dk_mp_phase18_"))
    procs = MPProcs(work)
    gates = Gates(work)
    launches = {}

    def add(ans):
        for a in ans:
            for k, v in a["launches"].items():
                launches[k] = launches.get(k, 0) + v

    try:
        ranks = procs.launch("p18", ["tp", "fsdp", "pp"], device, p)
        gates.procs = ranks
        t = p["model"]["seq_len"]
        print(f"phase 18a: the TP step at tp=2 ({p['model']['n_heads'] // 2}"
              f" heads a rank), B={p['batch']}, T={t}, f32, sgd({p['lr']}), "
              f"two ranks sharing the card under gloo")
        gates.open("tp")
        ans = gates.answers("tp")
        for r, q in enumerate(ranks):
            init = procs.init(q)
            print(f"  rank {r}: backend {init['backend']} on "
                  f"{init['device']}, group up in {init['init_s']:.2f} s")
        ref = ans[0]["ref"]
        same = len({a["digest"] for a in ans}) == 1
        print(f"  against the one-card step: loss relative "
              f"{ref['loss_err']:.3e}, grads {ref['grad_err']:.3e} of each "
              f"leaf's largest |grad|, params after {p['steps']} steps "
              f"{ref['param_err']:.3e} (per-leaf relative norm; tol "
              f"{SPLIT_TOL:g}); losses {ans[0]['losses']} against "
              f"{ref['losses']}; replicated leaves bit-equal: {same}")
        print(f"  one bf16 step, the kernels on each rank's heads, against "
              f"one process with plain attention: {ref['bf16_err']:.3e} "
              f"(per-leaf relative norm; tol {STEP_BF16_TOL:g})")
        require(max(ref["loss_err"], ref["grad_err"], ref["param_err"])
                <= SPLIT_TOL and same and ref["bf16_err"] <= STEP_BF16_TOL,
                "18a: the TP step disagrees with the one-card step")
        a0 = ans[0]
        st = a0["stats"]["all_reduce"]
        split = " / ".join(f"{a['tokens_s']:.1f}" for a in ans)
        print(f"  tokens/s: tp=2 {split} "
              f"(rank 0 / rank 1), one process {ref['tokens_s']:.1f}: "
              f"{a0['tokens_s'] / ref['tokens_s']:.3f} of one card; the "
              f"model axis's all-reduces {a0['ar_calls']:.0f} calls, "
              f"{a0['ar_mb']:.1f} MB and {a0['ar_ms']:.1f} ms blocked a "
              f"step on rank 0 ({st['calls']} calls, "
              f"{st['bytes'] / 1e6:.1f} MB in the parity run) on {gpu}")
        print_launches("the TP step (its grads and steps)", ans)
        add(ans)

        print(f"phase 18b: FSDP over 2 ranks, B={p['batch']} "
              f"({p['batch'] // 2} a rank), adam({p['adam_lr']}), f32")
        gates.open("fsdp")
        ans = gates.answers("fsdp")
        ref = ans[0]["ref"]
        same = len({a["digest"] for a in ans}) == 1
        print(f"  against one process on the whole batch: adam, the loss of "
              f"each of {p['steps']} steps {ref['loss_err']:.3e} relative "
              f"(losses {ans[0]['losses']} against {ref['losses']}), the "
              f"gathered adam moments after the first step "
              f"{ref['moment_err']:.3e}; sgd({p['lr']}), the params after "
              f"{p['steps']} steps {ref['param_err']:.3e} (per-leaf "
              f"relative norm; tol {SPLIT_TOL:g}); replicated leaves "
              f"bit-equal: {same}")
        print(f"  against one process taking the ranks' step (each rank's "
              f"rows apart, summed in rank order): adam's losses, moments "
              f"after the first step and params after {p['steps']} steps "
              f"{ref['same_order_err']:.3e} (tol {SPLIT_TOL:g}); adam's "
              f"params against the whole batch {ref['adam_param_err']:.3e}, "
              f"that process's own {ref['order_err']:.3e} (the summation "
              f"order alone)")
        require(max(ref["loss_err"], ref["moment_err"], ref["param_err"],
                    ref["same_order_err"]) <= SPLIT_TOL and same,
                "18b: FSDP disagrees with one process")
        for r, a in enumerate(ans):
            print(f"  rank {r}: persistent bytes (params + adam state) "
                  f"{a['bytes'] / 1e6:.1f} MB against one process's "
                  f"{ref['bytes'] / 1e6:.1f} MB "
                  f"({a['bytes'] / ref['bytes']:.3f}; bound: 1/2 of the "
                  f"sharded leaves and the replicated ones, "
                  f"{a['bound'] / 1e6:.1f} MB)")
        require(all(a["bytes"] <= a["bound"] for a in ans),
                "18b: a rank's persistent state is not sharded")
        tm = ans[0]["timed"]
        split = " / ".join(f"{a['sps']:.2f}" for a in ans)
        print(f"  samples/s: 2 ranks {split} "
              f"(rank 0 / rank 1), one process {ref['sps']:.2f}: "
              f"{ans[0]['sps'] / ref['sps']:.3f}; a step on rank 0: "
              + ", ".join(f"{op} {v['calls'] / p['timed']:.0f} calls "
                          f"{v['bytes'] / p['timed'] / 1e6:.1f} MB "
                          f"{v['seconds'] / p['timed'] * 1e3:.1f} ms"
                          for op, v in tm.items()) + f" on {gpu}")
        print_launches("the FSDP steps", ans)
        add(ans)

        print(f"phase 18c: the pipeline over 2 stages "
              f"({p['model']['n_layers'] // 2} layers a stage), "
              f"M={p['microbatches']} microbatches of "
              f"{p['batch'] // p['microbatches']}, f32, sgd({p['lr']})")
        gates.open("pp")
        ans = gates.answers("pp")
        ref = ans[0]["ref"]
        for v in ("1", "2"):
            r0 = ans[0]["runs"][v]
            kind = "1F1B" if v == "1" else "interleaved 1F1B at v=2"
            print(f"  {kind}: against the one-card step: loss relative "
                  f"{r0['loss_err']:.3e}, grads {r0['grad_err']:.3e} of "
                  f"each leaf's largest |grad|, params after {p['steps']} "
                  f"steps {r0['param_err']:.3e} (tol {SPLIT_TOL:g}); losses "
                  f"{r0['losses']} against {ref['losses']}")
            for r, a in enumerate(ans):
                run = a["runs"][v]
                print(f"  rank {r} (stage {r}): stash peak {run['peak']} "
                      f"microbatch inputs (bound {run['bound']}); "
                      f"{run['tokens_s']:.1f} tokens/s; point-to-point "
                      f"{run['p2p_calls']:.0f} messages, "
                      f"{run['p2p_mb']:.1f} MB sent, {run['p2p_ms']:.1f} ms "
                      f"blocked a step; K1 / K2 / K3 "
                      f"{run['launches']['flash_fwd']} / "
                      f"{run['launches']['flash_bwd_dq']} / "
                      f"{run['launches']['flash_bwd_dkv']}")
                require(1 <= run["peak"] <= run["bound"],
                        f"18c rank {r}: stash peak {run['peak']}")
                for k, n in run["launches"].items():
                    launches[k] = launches.get(k, 0) + n
            print(f"  {kind}: tokens/s one process {ref['tokens_s']:.1f}: "
                  f"{r0['tokens_s'] / ref['tokens_s']:.3f} of one card "
                  f"on {gpu}")
            require(max(r0["loss_err"], r0["grad_err"], r0["param_err"])
                    <= SPLIT_TOL, f"18c: {kind} disagrees with one card")
        for q in ranks:
            procs.finish(q)
            require(q.returncode == 0, f"{q.label} exited {q.returncode}: "
                    f"{procs.output(q)[-600:]}")
    finally:
        procs.close()
        shutil.rmtree(work, ignore_errors=True)
    if torch.device(device).type == "cuda":
        require(all(launches.get(k, 0) > 0 for k in (
            "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
            f"18: a kernel of the path never launched: {launches}")
    print(f"  phase 18 launches (f32, both ranks): {launches}")
    print(f"  phase 18 wall {time.perf_counter() - t0:.1f} s on {gpu}")
    return launches


MP_TASKS.update(tp=mp_task_tp, fsdp=mp_task_fsdp, pp=mp_task_pp)


def main(argv=None):
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--paged-timing-of", type=Path, metavar="CHECKOUT",
                    help="time only the paged-decode kernel at the decode "
                         "rungs (phase 6's inputs), from the "
                         "dist_keras_tpu_torch of CHECKOUT, to compare two "
                         "trees in one run")
    ap.add_argument("--phase12", action="store_true",
                    help="run only phase 1 (the card) and phase 12 "
                         "(checkpoints and resume); no kernel is built")
    ap.add_argument("--phase13", action="store_true",
                    help="run only phase 1 (the card) and phase 13 "
                         "(parameter-server mode, 13b at its full "
                         "epochs); no kernel is built")
    ap.add_argument("--phase14", action="store_true",
                    help="run only phase 1 (the card) and phase 14 (the "
                         "serving fabric); builds K1 and K5 only")
    ap.add_argument("--phase15", action="store_true",
                    help="run only phase 1 (the card) and phase 15 (the "
                         "data path); no kernel is built")
    ap.add_argument("--phase16", action="store_true",
                    help="run only phase 1 (the card) and phase 16 (the "
                         "workers across processes); no kernel is built")
    ap.add_argument("--phase17", action="store_true",
                    help="run only phase 1 (the card) and phase 17 (the MoE "
                         "transformer, expert and sequence parallelism); "
                         "builds K1, K2 and K3 only")
    ap.add_argument("--phase18", action="store_true",
                    help="run only phase 1 (the card) and phase 18 (the "
                         "transformer across ranks: TP, FSDP, the "
                         "pipeline); builds K1, K2 and K3 only")
    ap.add_argument("--ps-role", metavar="JSON",
                    help="(phase 13's own processes) run one server or "
                         "worker of the phase, configured by JSON")
    ap.add_argument("--serve-role", metavar="JSON",
                    help="(phase 14's own processes) run one decode "
                         "backend of the phase, configured by JSON")
    ap.add_argument("--mp-role", metavar="JSON",
                    help="(phase 16's own processes) run one rank of the "
                         "phase, configured by JSON")
    a = ap.parse_args(argv)
    if a.ps_role:
        return ps_role(json.loads(a.ps_role))
    if a.serve_role:
        return serve_role(json.loads(a.serve_role))
    if a.mp_role:
        return mp_role(json.loads(a.mp_role))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    root = (a.paged_timing_of or ROOT).resolve()
    if not (root / "dist_keras_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no dist_keras_tpu_torch package in {root}; run "
              f"{Path(__file__).name} from the repository root",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from dist_keras_tpu_torch.ops import _build
    from dist_keras_tpu_torch.ops import decode_attention as da
    from dist_keras_tpu_torch.ops import flash_attention as fa
    from dist_keras_tpu_torch.ops import fused_bwd_experimental as fu

    print("phase 1: the card")
    gpu = gpu_line()
    print(gpu)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if a.paged_timing_of:
        print(f"paged_decode timing of {root}")
        rows = time_paged_rungs(da, np.random.default_rng(0),
                                torch.device("cuda"), gpu)
        return 0
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(f"  allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    if a.phase12:
        print("phase 12: checkpoints and resume on the card")
        checkpoints_and_resume(fa, fu, da, gpu)
        return 0
    if a.phase13:
        print("phase 13: parameter-server mode on the card")
        ps_mode(fa, fu, da, gpu)
        return 0
    if a.phase15:
        print("phase 15: the data path on the card")
        data_path(fa, fu, da, gpu)
        return 0
    if a.phase16:
        print("phase 16: the workers across processes on the card")
        workers_across_processes(fa, fu, da, gpu)
        return 0
    if a.phase17:
        print("phase 17: the MoE transformer, expert and sequence "
              "parallelism on the card")
        built = _build.build(["flash_fwd", "flash_bwd"])
        print(f"  built {sorted(built)} before the ranks start")
        moe_and_sequence(fa, fu, da, gpu)
        return 0
    if a.phase18:
        print("phase 18: the transformer across ranks on the card")
        built = _build.build(["flash_fwd", "flash_bwd"])
        print(f"  built {sorted(built)} before the ranks start")
        transformer_across_ranks(fa, fu, da, gpu)
        return 0
    if a.phase14:
        print("phase 14: the serving fabric on the card")
        built = _build.build(["flash_fwd", "paged_decode"])
        print(f"  built {sorted(built)} before the backends start")
        fabric_launches = serving_fabric(fa, fu, da, gpu)
        print(f"  launches on the fabric's backends: {fabric_launches}")
        return 0

    # phases 1-7 run the knob-off backward (K2 + K3); phase 7b turns it on
    os.environ.pop("DK_FUSED_BWD", None)

    clock = PhaseClock()
    clock.start("2: build the kernels")
    t0 = time.perf_counter()
    libs = ["flash_fwd", "flash_bwd", "fused_bwd", "paged_decode"]
    built = _build.build(libs)
    usage = {}
    for name in libs:   # ptxas's lines, kept beside each library
        secs = (f"built in {built[name][0]:.1f} s" if name in built
                else "built before")
        print(f"  {name}: {secs}")
        log = _build.build_log(name)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
        usage.update(ptxas_usage(log))
    print(f"  build wall {time.perf_counter() - t0:.1f} s")
    tensor_core = (("flash_fwd", "flash_fwd_bf16_kernel"),
                   ("flash_bwd", "flash_bwd_dq_bf16_kernel"),
                   ("flash_bwd", "flash_bwd_dkv_bf16_kernel"),
                   ("fused_bwd", "flash_bwd_fused_bf16_kernel"),
                   ("flash_fwd", "flash_fwd_f32_kernel"),
                   ("flash_bwd", "flash_bwd_dq_f32_kernel"),
                   ("flash_bwd", "flash_bwd_dkv_f32_kernel"),
                   ("fused_bwd", "flash_bwd_fused_f32_kernel"))
    no_spill = [kernel for _, kernel in tensor_core] + ["paged_decode_kernel"]
    spilled = {f: u for f, u in usage.items() if any(u[1:]) and any(
        kernel in f for kernel in no_spill)}
    require(not spilled, f"tensor-core or paged-decode kernels spill "
                         f"registers: {spilled}")
    paged = {re.search(r"ILi(\d+)E", f).group(1): u
             for f, u in usage.items() if "paged_decode_kernel" in f}
    for dim, (regs, stores, loads) in sorted(paged.items(), key=lambda x:
                                             int(x[0])):
        print(f"  paged_decode_kernel<{dim}>: ptxas {regs} registers, spill "
              f"stores {stores} B, loads {loads} B")
    require(set(paged) == {"32", "64", "128"},
            f"ptxas printed no register line for a paged_decode_kernel "
            f"instantiation: {sorted(paged)}")
    for lib, kernel in tensor_core:
        counts = tensor_core_counts(_build, lib, kernel)
        for fn, n in counts.items():
            regs, stores, loads = usage.get(fn, (None, None, None))
            args = ", ".join(re.findall(r"Li(\d+)E", fn))
            print(f"  {kernel}<{args}>: "
                  f"{n} tensor-core instructions (HMMA/HGMMA in cuobjdump "
                  f"-sass), ptxas {regs} registers, spill stores {stores} "
                  f"B, loads {loads} B")
        dims = {re.search(r"ILi(\d+)E", fn).group(1) for fn in counts}
        require(dims == {"32", "64", "128"}
                and all(n > 0 for n in counts.values()),
                f"a {kernel} instantiation issues no tensor-core "
                f"instruction: {counts}")
        require(all(fn in usage for fn in counts),
                f"ptxas printed no register line for a {kernel} "
                f"instantiation")

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    clock.start("3: flash_fwd against its plain version")
    check_flash(fa, rng, dev)
    clock.start("3b: flash_bwd_dq / flash_bwd_dkv against their plain "
          "version, and autograd through them")
    check_flash_bwd(fa, rng, dev)
    check_flash_grad(fa, rng, dev)
    torch.cuda.empty_cache()
    clock.start("3c: fused_bwd against its plain version, against itself, "
          "and bit for bit against flash_bwd_dq + flash_bwd_dkv")
    check_fused_bwd(fa, fu, rng, dev)
    torch.cuda.empty_cache()
    clock.start("4: paged_decode against its plain version")
    check_paged(da, rng, dev)
    clock.start("5: serve the full-width model over /generate")
    engine, launches, run = serve(rng, fa, da, dev)
    print(f"  engine: {run['tokens']} tokens in {run['wall_s']:.3f} s = "
          f"{run['tokens'] / run['wall_s']:.1f} tokens/s, TTFT p50 "
          f"{run['ttft_p50_s'] * 1e3:.2f} ms on {gpu}")
    clock.start("6: kernel timing at the engine's shapes")
    rows = time_kernels(fa, da, rng, dev, gpu)
    time_step(engine, dev, gpu)
    del engine
    torch.cuda.empty_cache()
    for r in rows:
        r["launches"] = launches[r["name"]]
    clock.start("7: train the full-width model (bench_transformer_tp, "
          "one card)")
    train_launches, x, y = train(fa, fu, rng, dev, gpu)
    torch.cuda.empty_cache()
    check_remat(rng, dev)
    torch.cuda.empty_cache()
    clock.start("7b: train through the DK_FUSED_BWD route (K4 in bf16 and "
          "f32)")
    fused_launches, f32_launches = train_fused(fa, fu, rng, dev, gpu, x, y)
    train_launches["flash_bwd_fused"] = fused_launches["flash_bwd_fused"]
    train_launches.update(f32_launches)
    del x, y
    torch.cuda.empty_cache()
    clock.start("8: kernel timing at the training shape")
    train_rows = time_train_kernels(fa, fu, rng, dev, gpu)
    for r in train_rows:
        r["launches"] = train_launches[r["name"].replace("_bf16", "")]
    rows += train_rows
    for r in rows:
        r.pop("shape")
    torch.cuda.empty_cache()
    clock.start("9: the paper's training loop (SingleTrainer, the MNIST "
          "MLP gate, one card)")
    train_loop(fa, fu, da, gpu)
    torch.cuda.empty_cache()
    clock.start("10: the windowed trainers (DistributedTrainer, W workers "
          "stacked on one card)")
    adag, test = train_windowed(fa, fu, da, gpu)
    torch.cuda.empty_cache()
    clock.start("11: the rest of serving on the card")
    t11 = time.perf_counter()
    clock.start("11a: /predict on the trained MNIST CNN")
    serve_predict(adag, test, fa, fu, da, gpu)
    del adag, test
    clock.start("11b: decode survivability at phase 5's widths")
    decode_survivability(np.random.default_rng(5), fa, fu, da, gpu, dev)
    print(f"  phase 11 wall {time.perf_counter() - t11:.1f} s on {gpu}")
    clock.start("12: checkpoints and resume on the card")
    checkpoints_and_resume(fa, fu, da, gpu)
    torch.cuda.empty_cache()
    clock.start("13: parameter-server mode on the card")
    ps_mode(fa, fu, da, gpu, epochs=PROOF13_EPOCHS)
    torch.cuda.empty_cache()
    clock.start("14: the serving fabric on the card")
    fabric_launches = serving_fabric(fa, fu, da, gpu)
    print(f"  launches on the fabric's backends: {fabric_launches}")
    torch.cuda.empty_cache()
    clock.start("15: the data path on the card")
    data_path(fa, fu, da, gpu, sizes=PROOF15)
    torch.cuda.empty_cache()
    clock.start("16: the workers across processes on the card")
    workers_across_processes(fa, fu, da, gpu, sizes=PROOF16)
    torch.cuda.empty_cache()
    clock.start("17: the MoE transformer, expert and sequence parallelism")
    bf16, f32 = moe_and_sequence(fa, fu, da, gpu)
    phase17 = {"flash_fwd_bf16": bf16["flash_fwd"],
               "flash_bwd_dq": bf16["flash_bwd_dq"],
               "flash_bwd_dkv": bf16["flash_bwd_dkv"],
               "flash_fwd": f32["flash_fwd"],
               "flash_bwd_dq_f32": f32["flash_bwd_dq"],
               "flash_bwd_dkv_f32": f32["flash_bwd_dkv"]}
    for r in rows:
        r["launches"] += phase17.get(r["name"], 0)
    torch.cuda.empty_cache()
    clock.start("18: the transformer across ranks (TP, FSDP, the pipeline)")
    f32 = transformer_across_ranks(fa, fu, da, gpu)
    phase18 = {"flash_fwd": f32["flash_fwd"],
               "flash_bwd_dq_f32": f32["flash_bwd_dq"],
               "flash_bwd_dkv_f32": f32["flash_bwd_dkv"]}
    for r in rows:
        r["launches"] += phase18.get(r["name"], 0)
    clock.summary()
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
