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

``python3 chip_smoke.py --phase12`` runs only phases 1 and 12;
``--phase13`` only phases 1 and 13.
``python3 chip_smoke.py --paged-timing-of CHECKOUT`` runs only phase 6's
K5 timing, on the ``dist_keras_tpu_torch`` of another checkout, so that
two trees' K5 can be timed on the same inputs in one run.

The line before the last is a JSON object of per-kernel numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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


def mnist_sets():
    """The gate's data, as ``tests/test_examples.py``'s ``_prep_mnist``
    builds it (MinMax to ``fn``, one-hot to ``le``, images to ``fi``)."""
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

    return (prep(synthetic_mnist(GATE_ROWS, seed=0)),
            prep(synthetic_mnist(GATE_TEST_ROWS, seed=1)))


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
        print("PS_KERNELS " + json.dumps(kernel_counts(fa, fu, da)),
              flush=True)


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
        print("PS_FINAL", clock, tree_sha(center), flush=True)
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
        print(f"TYPED {type(e).__name__}: {e}", flush=True)
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
    print("PS_WORKER_DONE " + json.dumps(out), flush=True)
    return 0


class PSProcs:
    """Phase 13's processes, each a fresh ``python3 chip_smoke.py
    --ps-role`` (never a fork of this process, which has started CUDA),
    its output in a file under ``work``; :meth:`close` kills any still
    running."""

    def __init__(self, work):
        self.work = Path(work)
        self.procs = []
        self.kernels = {}      # K1-K5 launches summed over the processes
        self.counted = []      # the labels whose launches are in it
        self.env = {k: v for k, v in os.environ.items()
                    if not k.startswith(("DK_COORD", "DK_FAULTS", "DK_OBS",
                                         "DK_CKPT", "DK_ALERT", "DK_PS"))}

    def spawn(self, label, cfg, **env):
        log = open(self.work / f"{label}.log", "w")
        p = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--ps-role",
             json.dumps(cfg)], stdout=log, stderr=subprocess.STDOUT,
            env={**self.env, **env}, cwd=str(ROOT))
        log.close()
        p.label = label
        self.procs.append(p)
        return p

    def output(self, p):
        return (self.work / f"{p.label}.log").read_text()

    def finish(self, p):
        try:
            p.wait(timeout=PS_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            raise SmokeFailure(f"{p.label}: HANG (killed at {PS_TIMEOUT_S} "
                               f"s): {self.output(p)[-400:]}")
        out = self.output(p)
        m = re.search(r"^PS_KERNELS (.*)$", out, re.M)
        require(m, f"{p.label}: printed no launch counters: {out[-400:]}")
        self.add_kernels(p.label, json.loads(m.group(1)))
        return out

    def add_kernels(self, label, counts):
        for k, n in counts.items():
            self.kernels[k] = self.kernels.get(k, 0) + n
        self.counted.append(label)

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
        """SIGTERM -> the drain: exit 143 and -> {"clock", "sha"}."""
        import signal

        server.send_signal(signal.SIGTERM)
        out = self.finish(server)
        require(server.returncode == 143,
                f"{server.label} exited {server.returncode}, wanted 143 "
                f"(SIGTERM drain): {out[-400:]}")
        m = re.search(r"^PS_FINAL (\d+) ([0-9a-f]{64})$", out, re.M)
        require(m, f"{server.label}: no PS_FINAL line: {out[-400:]}")
        return {"clock": int(m.group(1)), "sha": m.group(2)}

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


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
                   profile=False):
    """13b's processes: one server and PS_WORKERS workers sharing the
    card, ``mnist_mlp()`` at full width, window 12, adam 1e-3, batch 64,
    6 epochs of the phase-9 gate set, each worker shuffling with its own
    seed; with ``profile``, one epoch with each worker's whole run under
    ``torch.profiler``.  The workers wait at the run's gate
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
        "batch": 64, "epochs": 1 if profile else GATE_EPOCHS, "x": "fn",
        "y": "le", "seed": i, "device": device, "shuffle": True,
        "gate": gate, "profile": profile},
        DK_COORD_RANK=str(i + 1), **env) for i in range(PS_WORKERS)]
    return {"tag": tag, "run": run, "obs": obs, "server": server,
            "workers": workers, "gate": gate}


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
          f"window {PS_WINDOW}, adam 1e-3, batch 64, {GATE_EPOCHS} epochs, "
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


def ps_mode(fa, fu, da, gpu, device="cuda"):
    """Phase 13: the PS gate on the card (kill and rejoin, drain,
    attribution, chaos), then ``mnist_mlp()`` at full width with 4 worker
    processes sharing the card (uncompressed, int8, and a profiled run
    for the idle share), and card against CPU; no hand-written kernel
    launched in any of its processes."""
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
        plain = ps_mnist(procs, ps_mnist_spawn(procs, work, data, device),
                         test, gpu, device)
        int8 = ps_mnist(procs, ps_mnist_spawn(procs, work, data, device,
                                              compress="int8"),
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
                         "(parameter-server mode); no kernel is built")
    ap.add_argument("--ps-role", metavar="JSON",
                    help="(phase 13's own processes) run one server or "
                         "worker of the phase, configured by JSON")
    a = ap.parse_args(argv)
    if a.ps_role:
        return ps_role(json.loads(a.ps_role))
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

    # phases 1-7 run the knob-off backward (K2 + K3); phase 7b turns it on
    os.environ.pop("DK_FUSED_BWD", None)

    print("phase 2: build the kernels")
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
    print("phase 3: flash_fwd against its plain version")
    check_flash(fa, rng, dev)
    print("phase 3b: flash_bwd_dq / flash_bwd_dkv against their plain "
          "version, and autograd through them")
    check_flash_bwd(fa, rng, dev)
    check_flash_grad(fa, rng, dev)
    torch.cuda.empty_cache()
    print("phase 3c: fused_bwd against its plain version, against itself, "
          "and bit for bit against flash_bwd_dq + flash_bwd_dkv")
    check_fused_bwd(fa, fu, rng, dev)
    torch.cuda.empty_cache()
    print("phase 4: paged_decode against its plain version")
    check_paged(da, rng, dev)
    print("phase 5: serve the full-width model over /generate")
    engine, launches, run = serve(rng, fa, da, dev)
    print(f"  engine: {run['tokens']} tokens in {run['wall_s']:.3f} s = "
          f"{run['tokens'] / run['wall_s']:.1f} tokens/s, TTFT p50 "
          f"{run['ttft_p50_s'] * 1e3:.2f} ms on {gpu}")
    print("phase 6: kernel timing at the engine's shapes")
    rows = time_kernels(fa, da, rng, dev, gpu)
    time_step(engine, dev, gpu)
    del engine
    torch.cuda.empty_cache()
    for r in rows:
        r["launches"] = launches[r["name"]]
    print("phase 7: train the full-width model (bench_transformer_tp, "
          "one card)")
    train_launches, x, y = train(fa, fu, rng, dev, gpu)
    torch.cuda.empty_cache()
    check_remat(rng, dev)
    torch.cuda.empty_cache()
    print("phase 7b: train through the DK_FUSED_BWD route (K4 in bf16 and "
          "f32)")
    fused_launches, f32_launches = train_fused(fa, fu, rng, dev, gpu, x, y)
    train_launches["flash_bwd_fused"] = fused_launches["flash_bwd_fused"]
    train_launches.update(f32_launches)
    del x, y
    torch.cuda.empty_cache()
    print("phase 8: kernel timing at the training shape")
    train_rows = time_train_kernels(fa, fu, rng, dev, gpu)
    for r in train_rows:
        r["launches"] = train_launches[r["name"].replace("_bf16", "")]
    rows += train_rows
    for r in rows:
        r.pop("shape")
    torch.cuda.empty_cache()
    print("phase 9: the paper's training loop (SingleTrainer, the MNIST "
          "MLP gate, one card)")
    train_loop(fa, fu, da, gpu)
    torch.cuda.empty_cache()
    print("phase 10: the windowed trainers (DistributedTrainer, W workers "
          "stacked on one card)")
    adag, test = train_windowed(fa, fu, da, gpu)
    torch.cuda.empty_cache()
    print("phase 11: the rest of serving on the card")
    t11 = time.perf_counter()
    print("phase 11a: /predict on the trained MNIST CNN")
    serve_predict(adag, test, fa, fu, da, gpu)
    del adag, test
    print("phase 11b: decode survivability at phase 5's widths")
    decode_survivability(np.random.default_rng(5), fa, fu, da, gpu, dev)
    print(f"  phase 11 wall {time.perf_counter() - t11:.1f} s on {gpu}")
    print("phase 12: checkpoints and resume on the card")
    checkpoints_and_resume(fa, fu, da, gpu)
    torch.cuda.empty_cache()
    print("phase 13: parameter-server mode on the card")
    ps_mode(fa, fu, da, gpu)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
