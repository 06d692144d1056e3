"""Continuous-batching autoregressive decode engine over paged KV.

Counterpart of ``serving/decode.py``: token-level scheduling of the
causal transformer (``models/transformer.py``) with per-sequence
futures and no batch barrier.

- **Continuous batching.**  A per-replica scheduler thread runs one
  decode iteration at a time over the replica's ACTIVE sequence set;
  between iterations it admits queued sequences into free slots and
  retires finished ones — a short sequence exits early and its slot
  refills on the very next iteration.
- **Prefill / decode phase split, both ladder-bounded.**  A prompt runs
  once through a fixed prefill ladder (padded to the smallest rung that
  fits); every later token runs through a fixed ladder of decode SLOT
  counts.  The distinct shapes dispatched are therefore bounded by
  ``len(prefill_ladder) + len(decode_ladder)``, which ``stats()``
  reports as ``retrace_count`` against ``retrace_bound``.
- **Paged KV.**  Each replica owns one K and one V pool of shape
  ``(layers, heads, num_pages + 1, page_size, head_dim)``, the scratch
  page last, and a :class:`PagedKVCache` allocator.  Admission reserves
  a sequence's WORST-CASE page count up front, so exhaustion is a typed
  ``Overloaded("kv_exhausted")`` strictly at the door, and completion,
  cancel, error and deadline all reclaim through the one allocator path.
- **Hot reload never drops a sequence.**  ``submit_generate`` pins the
  replica's CURRENT params into the sequence; ``set_params`` swaps the
  replica reference only, and decode iterations group active sequences
  by the params they were admitted with.
- **Typed errors, never hangs.**  The ``decode.admit`` /
  ``decode.kv_alloc`` / ``decode.step`` / ``decode.recover`` fault
  points cover admission, page reservation, the step dispatch and the
  quarantine re-admission path; any failure lands typed on the
  affected sequences' futures with their pages reclaimed.
- **Sequence-level recovery.**  A replica worker crash (the
  :meth:`DecodeEngine.kill_replica` seam, or a ``decode.step`` fault
  past the in-place retry) QUARANTINES that replica: its KV pages free,
  its in-flight sequences re-admit onto surviving replicas and REPLAY —
  prefill over the prompt, then teacher-forced decode steps over the
  already-generated tokens (the canonical ``seq.tokens`` are kept and
  the replayed predictions discarded, so ``on_token`` streams resume
  exactly where they stopped).  Futures never see the failure; only
  when NO survivor can hold a sequence does it resolve typed.  Killing
  the last live replica is refused.
- **End-to-end deadlines.**  ``submit_generate(deadline_s=...)`` rejects
  at the door (``Overloaded("deadline_infeasible")``) when the observed
  prefill / step EWMAs say ``max_new_tokens`` cannot finish in time; a
  deadline expiring mid-decode frees the slot and its pages between
  steps and resolves ``finish="deadline"`` with the tokens so far.
- **Brownout shedding.**  ``priority="batch"`` admissions shed typed
  (``Overloaded("shed_batch")``) while KV occupancy sits at or above
  ``DK_DECODE_SHED_WATERMARK``; sheds count ``decode.shed``, not
  ``decode.rejected``, and also while an SLO objective breaches
  (``observability/slo.breaching()``, armed by ``DK_SLO``).
- **The kernels.**  On CUDA, prefill attention is the flash-forward
  kernel (``ops/flash_attention.py``) and each decode step's attention
  the paged-decode kernel (``ops/decode_attention.py``) — replayed
  prefills and teacher-forced steps included; on the CPU both take
  their plain versions.  Every replica lives on the engine's device
  and runs on its own CUDA stream, so a sequence's pinned params serve
  it on whichever replica it is replayed on.  EWMAs and deadlines are
  host floats, timed around each dispatch's token fetch (which waits
  on the replica's stream anyway).

Observability: ``decode_*`` events at every seam, ``decode.*`` registry
metrics, and with tracing on each request's trace gains
``serve.queue_wait`` + ``serve.prefill`` spans stamped from the
scheduler thread.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from dist_keras_tpu_torch.models.transformer import layer_norm, mlp_half
from dist_keras_tpu_torch.observability import events, metrics, perf, spans
from dist_keras_tpu_torch.observability import slo as _slo
from dist_keras_tpu_torch.ops.decode_attention import paged_attention_auto
from dist_keras_tpu_torch.ops.flash_attention import attention_auto
from dist_keras_tpu_torch.resilience.faults import fault_point
from dist_keras_tpu_torch.serving.engine import (
    Overloaded,
    on_stream,
    put_params,
    stream_for,
)
from dist_keras_tpu_torch.serving.kv_cache import PagedKVCache, PagesExhausted
from dist_keras_tpu_torch.utils import knobs
from dist_keras_tpu_torch.utils.device import resolve_device


class _ReplicaDead(Exception):
    """Internal scheduler signal: this replica must quarantine (worker
    crash, kill seam, or a step failure past the retry policy with a
    survivor available).  Never escapes the engine."""

    def __init__(self, cause):
        self.cause = cause
        super().__init__(str(cause))


class _Sequence:
    """One admitted generation: host-side state the scheduler owns."""

    __slots__ = ("sid", "tokens", "prompt_len", "max_new", "eos_id",
                 "future", "on_token", "t", "tw", "ctx", "params",
                 "pages", "kv_len", "steps", "cancelled", "ttft_s",
                 "deadline", "recoveries", "finished")

    def __init__(self, sid, tokens, max_new, eos_id, on_token, params,
                 pages, deadline=None):
        self.sid = sid
        self.tokens = list(tokens)
        self.prompt_len = len(tokens)
        self.max_new = max_new
        self.eos_id = eos_id
        self.future = Future()
        self.on_token = on_token
        self.t = time.monotonic()
        self.tw = time.time()
        self.ctx = spans.capture()
        self.params = params      # pinned: reloads never touch us
        self.pages = pages
        self.kv_len = 0           # KV positions written so far
        self.steps = 0            # decode iterations consumed
        self.cancelled = False
        self.ttft_s = None
        self.deadline = deadline  # absolute monotonic, or None
        self.recoveries = 0       # quarantine re-admissions survived
        self.finished = False     # exit accounted (pages reclaimed)

    def generated(self):
        return self.tokens[self.prompt_len:]

    def result_doc(self, finish):
        return {
            "tokens": list(self.tokens),
            "generated": self.generated(),
            "prompt_len": self.prompt_len,
            "steps": self.steps,
            "ttft_s": self.ttft_s,
            "finish": finish,
            "recoveries": self.recoveries,
        }


class Generation:
    """Caller-side handle: a future plus a cancel seam (cancel reclaims
    the sequence's KV pages; the future resolves with
    ``finish="cancelled"`` and the tokens produced so far)."""

    def __init__(self, engine, seq):
        self._engine = engine
        self._seq = seq
        self.future = seq.future

    def result(self, timeout=None):
        return self.future.result(timeout=timeout)

    def cancel(self):
        return self._engine.cancel(self)

    def done(self):
        return self.future.done()


class _DecodeReplica:
    """One replica: its params swap point, its KV pools, its stream, its
    queue."""

    def __init__(self, index, params, cache, kp, vp, stream):
        self.index = index
        self.params = params
        self.cache = cache
        self.kp = kp
        self.vp = vp
        self.stream = stream
        self.queue = collections.deque()
        self.active = []
        self.retiring = False
        self.killed = False       # crash requested (kill_replica seam)
        self.dead = False         # quarantined: out of service for good


class DecodeEngine:
    """Continuous-batching decode over the causal Transformer.

    Args:
      model: a port ``models.transformer.Transformer`` (anything with a
        ``cfg`` dict and a reference-layout ``params`` tree).  Decode
        needs token in == logit out, so ``input_dim == n_classes`` (the
        vocabulary).
      replicas: replica count (each with its own KV pools, stream and
        scheduler thread, all on ``device``).
      prefill_ladder: ascending fixed PROMPT shapes; a prompt runs
        padded to the smallest rung that fits (``ValueError`` past the
        largest — the front end's 400).
      decode_ladder: ascending fixed SLOT counts for decode steps; the
        largest rung is the per-replica concurrency cap.
      page_size: KV positions per page.
      num_pages: pool pages per replica.  Default sizes the pool so a
        full slot set of maximum-length sequences fits.
      max_queue: admission bound on admitted-but-unresolved sequences.
      max_new_default: ``max_new_tokens`` when a request omits it.
      eos_id: default stop token (None = length-only stopping).
      device: where the pools, params and math live (default ``cuda``;
        ``"cpu"`` runs the plain attention versions).
      step_retries: in-place retries of a failed decode-step dispatch
        (safe: pools and ``kv_len`` only advance on success).  Past
        them the replica quarantines when a survivor exists, else the
        group fails typed.
      shed_watermark: KV occupancy fraction at or above which ``batch``
        admissions shed (default: ``DK_DECODE_SHED_WATERMARK``).
      self_check_interval_s: cadence of the scheduler's allocator
        reconciliation pass (``decode.kv_leaked``).
    """

    def __init__(self, model, replicas=1, prefill_ladder=(16, 64),
                 decode_ladder=(1, 4, 8), page_size=8, num_pages=None,
                 max_queue=256, max_new_default=16, eos_id=None,
                 device=None, step_retries=1, shed_watermark=None,
                 self_check_interval_s=1.0):
        cfg = getattr(model, "cfg", None)
        if cfg is None:
            raise ValueError(
                "DecodeEngine needs the causal Transformer model "
                "contract (a cfg dict); got "
                f"{type(model).__name__}")
        if cfg.get("moe_experts", 0):
            raise ValueError("MoE configs are not decodable here")
        if cfg["input_dim"] != cfg["n_classes"]:
            raise ValueError(
                "causal decode needs token-in == logit-out: "
                f"input_dim={cfg['input_dim']} != "
                f"n_classes={cfg['n_classes']}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.vocab = int(cfg["n_classes"])
        self.seq_len = int(cfg["seq_len"])

        ladder = sorted(set(int(b) for b in prefill_ladder))
        if not ladder or ladder[0] < 1 or ladder[-1] > self.seq_len:
            raise ValueError(
                f"prefill_ladder {prefill_ladder!r} must hold positive "
                f"ints <= seq_len ({self.seq_len})")
        self.prefill_ladder = tuple(ladder)
        slots = sorted(set(int(b) for b in decode_ladder))
        if not slots or slots[0] < 1:
            raise ValueError(
                f"decode_ladder {decode_ladder!r} must hold positive "
                "ints")
        self.decode_ladder = tuple(slots)
        self.max_slots = slots[-1]
        self.max_queue = int(max_queue)
        self.max_new_default = int(max_new_default)
        self.eos_id = eos_id if eos_id is None else int(eos_id)
        self.page_size = int(page_size)
        self.max_pages_per_seq = -(-self.seq_len // self.page_size)
        if num_pages is None:
            num_pages = self.max_slots * self.max_pages_per_seq
        self.num_pages = int(num_pages)

        d, h = cfg["d_model"], cfg["n_heads"]
        self._dh = d // h
        self._heads = h
        self._layers = int(cfg["n_layers"])
        n = int(replicas)
        if n < 1:
            raise ValueError(f"replicas={replicas} must be >= 1")
        self._params = put_params(model.params, [self.device])[self.device]
        self._next_replica_index = n
        self._seq_ids = itertools.count()
        self._replicas = [self._make_replica(i) for i in range(n)]

        self._cond = threading.Condition()
        self._outstanding = 0
        self._draining = False
        self._stopped = False
        self._drained = threading.Event()
        self._rr = 0
        self._shapes = set()      # (phase, rung) dispatched
        self.reload_count = 0
        self.step_retries = int(step_retries)
        self._shed_watermark = float(
            shed_watermark if shed_watermark is not None
            else knobs.get("DK_DECODE_SHED_WATERMARK"))
        self._self_check_interval = float(self_check_interval_s)
        self._next_self_check = (time.monotonic()
                                 + self._self_check_interval)
        # recovered sequences waiting for survivor KV capacity: they
        # hold no pages while pending; every worker iteration tries to
        # place them (admission-identical worst-case reservation)
        self._orphans = []
        # observed wall EWMAs feeding deadline feasibility at the door
        self._ewma_prefill = None
        self._ewma_step = None

        # engine-local instruments + the shared process registry
        self._m_ttft = metrics.Histogram("decode.ttft_s")
        self._m_step = metrics.Histogram("decode.step_s")
        self._n_admitted = 0
        self._n_completed = 0
        self._n_rejected = 0
        self._n_errors = 0
        self._n_cancelled = 0
        self._n_tokens = 0
        self._n_quarantines = 0
        self._n_recovered = 0
        self._n_shed = 0
        self._n_deadline_infeasible = 0
        self._n_deadline_expired = 0
        self._n_kv_leaked = 0
        self._reg_admitted = metrics.counter("decode.admitted")
        self._reg_completed = metrics.counter("decode.completed")
        self._reg_rejected = metrics.counter("decode.rejected")
        self._reg_errors = metrics.counter("decode.errors")
        self._reg_cancelled = metrics.counter("decode.cancelled")
        self._reg_tokens = metrics.counter("decode.tokens")
        self._reg_quarantines = metrics.counter("decode.quarantines")
        self._reg_recovered = metrics.counter("decode.recovered")
        self._reg_shed = metrics.counter("decode.shed")
        self._reg_deadline_infeasible = metrics.counter(
            "decode.deadline_infeasible")
        self._reg_deadline_expired = metrics.counter(
            "decode.deadline_expired")
        self._reg_kv_leaked = metrics.counter("decode.kv_leaked")
        self._reg_ttft = metrics.histogram("decode.ttft_s")
        self._reg_step = metrics.histogram("decode.step_s")
        self._reg_active = metrics.gauge("decode.active")
        self._reg_kv = metrics.gauge("decode.kv_used_pages")

        self._workers = [self._worker_thread(rep)
                         for rep in self._replicas]
        for t in self._workers:
            t.start()

    # -- model math (one shape per ladder rung) -------------------------
    def _make_replica(self, index):
        cache = PagedKVCache(self.num_pages, self.page_size)
        shape = (self._layers, self._heads, self.num_pages + 1,
                 self.page_size, self._dh)
        stream = stream_for(self.device)
        # the pools are made on the replica's own stream, the only one
        # that ever touches them
        with on_stream(stream):
            kp = torch.zeros(shape, dtype=torch.float32,
                             device=self.device)
            vp = torch.zeros(shape, dtype=torch.float32,
                             device=self.device)
        return _DecodeReplica(index, self._params, cache, kp, vp, stream)

    def _worker_thread(self, rep):
        return threading.Thread(target=self._worker_main, args=(rep,),
                                daemon=True,
                                name=f"dk-decode-worker-{rep.index}")

    def _prefill_fn(self, params, kp, vp, tokens, length, page_idx,
                    page_off):
        """One padded prompt -> its first generated token.

        ``tokens (T,) int64`` padded to a prefill rung; positions past
        ``length`` write their K/V to the scratch page (``page_idx``
        routes them there) and never influence position ``length - 1``
        under the causal mask.  The JAX engine donates the pools to its
        jitted step; here they are updated in place (``index_put_``)."""
        t = tokens.shape[0]
        # a row gather is exactly the reference's one_hot @ proj
        hs = (params["proj"][tokens] + params["pos"][:t])[None]
        for li, blk in enumerate(params["blocks"]):
            y = layer_norm(blk["ln1"], hs)
            q = torch.einsum("btd,dhk->bthk", y, blk["wq"])
            k = torch.einsum("btd,dhk->bthk", y, blk["wk"])
            v = torch.einsum("btd,dhk->bthk", y, blk["wv"])
            # K/V land in the pool BEFORE attention: (H, T, dh) rows
            kp[li][:, page_idx, page_off] = k[0].transpose(0, 1)
            vp[li][:, page_idx, page_off] = v[0].transpose(0, 1)
            a = attention_auto(q, k, v, causal=True)
            hs = mlp_half(blk, hs + torch.einsum("bthk,hkd->btd", a,
                                                 blk["wo"]))
        hf = layer_norm(params["ln_f"], hs)[0, length - 1]
        logits = hf @ params["head"]["kernel"] + params["head"]["bias"]
        return torch.argmax(logits)

    def _decode_fn(self, params, kp, vp, tokens, positions, page_tables,
                   write_page, write_off, lengths):
        """One token step for a padded slot set -> next tokens (S,).
        Padding slots carry ``length == 0`` and write to the scratch
        page; the paged attention's dead-row guard makes their output
        exact zeros (then discarded).  ``lengths`` counts the current
        token, whose K/V is written first."""
        hs = params["proj"][tokens] + params["pos"][positions]
        for li, blk in enumerate(params["blocks"]):
            y = layer_norm(blk["ln1"], hs)
            q = torch.einsum("sd,dhk->shk", y, blk["wq"])
            k = torch.einsum("sd,dhk->shk", y, blk["wk"])
            v = torch.einsum("sd,dhk->shk", y, blk["wv"])
            kp[li][:, write_page, write_off] = k.transpose(0, 1)
            vp[li][:, write_page, write_off] = v.transpose(0, 1)
            a = paged_attention_auto(q, kp[li], vp[li], page_tables,
                                     lengths)
            hs = mlp_half(blk, hs + torch.einsum("shk,hkd->sd", a,
                                                 blk["wo"]))
        hf = layer_norm(params["ln_f"], hs)
        logits = hf @ params["head"]["kernel"] + params["head"]["bias"]
        return torch.argmax(logits, dim=-1)

    # -- admission ------------------------------------------------------
    def _rung_for(self, n, ladder):
        for b in ladder:
            if n <= b:
                return b
        return None

    def _live_replicas_locked(self):
        return [r for r in self._replicas
                if not r.retiring and not r.dead and not r.killed]

    def _pick_replica(self, needed_pages):
        """Most free pages wins (KV is the scarce resource), round-robin
        on ties; retiring and quarantined replicas are out of rotation.
        Caller holds the lock."""
        live = self._live_replicas_locked()
        if not live:
            return None, 0
        frees = [r.cache.stats()["free_pages"] for r in live]
        best = max(frees)
        for i in range(self._rr, self._rr + len(live)):
            i %= len(live)
            if frees[i] == best:
                self._rr = (i + 1) % len(live)
                return (live[i] if best >= needed_pages else None), best
        return None, best  # pragma: no cover - unreachable

    def _should_shed_locked(self):
        """Brownout verdict for a ``batch`` admission: KV occupancy at
        or over the watermark, or any SLO objective firing.  Caller
        holds the lock (``slo.breaching`` takes only leaf locks)."""
        total = used = 0
        for r in self._live_replicas_locked():
            st = r.cache.stats()
            total += st["num_pages"]
            used += st["used_pages"]
        if total and used / total >= self._shed_watermark:
            return "kv_watermark"
        firing = _slo.breaching()
        if firing:
            return "slo:" + ",".join(firing)
        return None

    def submit_generate(self, tokens, max_new_tokens=None, eos_id=None,
                        on_token=None, deadline_s=None,
                        priority="interactive"):
        """Admit one prompt; -> :class:`Generation` whose future
        resolves to the result doc (tokens, ttft_s, finish reason).
        Raises :class:`Overloaded` at the door (``queue_full`` /
        ``kv_exhausted`` / ``draining`` / ``stopped`` /
        ``deadline_infeasible`` / ``shed_batch``) and ``ValueError``
        for malformed prompts — rejected, never lost.

        ``deadline_s`` is the caller's end-to-end budget: infeasible
        requests (per the observed prefill/step EWMAs) reject at the
        door; expiry mid-decode frees the slot between steps and
        resolves ``finish="deadline"``.  ``priority`` is
        ``interactive`` (default) or ``batch``; ``batch`` sheds first
        in a brownout.  ``on_token(token)`` runs on the scheduler
        thread as each token lands."""
        fault_point("decode.admit")
        toks = [int(t) for t in tokens]
        if not toks:
            raise ValueError("empty prompt")
        if any(t < 0 or t >= self.vocab for t in toks):
            raise ValueError(
                f"prompt tokens must be in [0, {self.vocab})")
        max_new = (self.max_new_default if max_new_tokens is None
                   else int(max_new_tokens))
        if max_new < 1:
            raise ValueError(f"max_new_tokens={max_new} must be >= 1")
        if self._rung_for(len(toks), self.prefill_ladder) is None:
            raise ValueError(
                f"prompt length {len(toks)} exceeds the prefill "
                f"ladder (max {self.prefill_ladder[-1]})")
        total = len(toks) + max_new
        if total > self.seq_len:
            raise ValueError(
                f"prompt + max_new_tokens = {total} exceeds the "
                f"model's seq_len ({self.seq_len})")
        eos = self.eos_id if eos_id is None else int(eos_id)
        if priority not in ("interactive", "batch"):
            raise ValueError(
                f"priority={priority!r} must be 'interactive' or "
                "'batch'")
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            if not deadline_s > 0:
                raise ValueError(
                    f"deadline_s={deadline_s} must be > 0")
        with self._cond:
            if self._draining or self._stopped:
                self._n_rejected += 1
                self._reg_rejected.inc()
                raise Overloaded(
                    "draining" if self._draining else "stopped")
            if self._outstanding >= self.max_queue:
                self._n_rejected += 1
                self._reg_rejected.inc()
                raise Overloaded("queue_full",
                                 pending=self._outstanding,
                                 capacity=self.max_queue)
            if priority == "batch":
                shed_why = self._should_shed_locked()
                if shed_why is not None:
                    # counted decode.shed, NOT decode.rejected: a shed
                    # that burned the rejection budget would amplify
                    # itself
                    self._n_shed += 1
                    self._reg_shed.inc()
                    events.emit("decode_shed", reason=shed_why,
                                prompt_len=len(toks))
                    raise Overloaded("shed_batch",
                                     pending=self._outstanding,
                                     capacity=self.max_queue)
            if deadline_s is not None \
                    and self._ewma_prefill is not None \
                    and self._ewma_step is not None:
                est = self._ewma_prefill + max_new * self._ewma_step
                if est > deadline_s:
                    self._n_rejected += 1
                    self._reg_rejected.inc()
                    self._n_deadline_infeasible += 1
                    self._reg_deadline_infeasible.inc()
                    events.emit("decode_deadline", phase="admission",
                                deadline_s=deadline_s,
                                estimate_s=round(est, 6))
                    raise Overloaded("deadline_infeasible")
            sid = next(self._seq_ids)
            needed = max(1, -(-total // self.page_size))
            rep, best_free = self._pick_replica(needed)
            if rep is None:
                self._n_rejected += 1
                self._reg_rejected.inc()
                raise Overloaded("kv_exhausted", pending=needed,
                                 capacity=best_free)
            # the allocator's own fault point (decode.kv_alloc) fires
            # inside; a raise here admits nothing and leaks nothing
            pages = rep.cache.alloc(sid, total)
            seq = _Sequence(
                sid, toks, max_new, eos, on_token, rep.params, pages,
                deadline=(None if deadline_s is None
                          else time.monotonic() + deadline_s))
            rep.queue.append(seq)
            self._outstanding += 1
            self._n_admitted += 1
            self._reg_active.set(self._outstanding)
            self._cond.notify_all()
        self._reg_admitted.inc()
        events.emit("decode_admit", sid=sid, prompt_len=len(toks),
                    max_new=max_new, replica=rep.index,
                    pages=len(pages))
        return Generation(self, seq)

    def generate(self, tokens, max_new_tokens=None, eos_id=None,
                 timeout_s=None):
        """Blocking convenience: submit one prompt, wait for the doc."""
        return self.submit_generate(
            tokens, max_new_tokens=max_new_tokens,
            eos_id=eos_id).result(timeout=timeout_s)

    def cancel(self, generation):
        """Cancel a generation: reclaim its pages and resolve its
        future with ``finish="cancelled"`` (tokens so far).  -> True if
        the cancel landed before completion."""
        seq = generation._seq
        dequeued = False
        with self._cond:
            if seq.future.done() or seq.cancelled or seq.finished:
                # the scheduler already accounted the exit and is about
                # to resolve the future: nothing is left to cancel
                return False
            seq.cancelled = True
            # still queued on some replica? finish it here, never
            # occupying a slot
            for rep in self._replicas:
                if seq in rep.queue:
                    rep.queue.remove(seq)
                    self._finish_locked(rep, seq, "cancelled")
                    dequeued = True
                    break
            self._cond.notify_all()
        if dequeued:
            events.emit("decode_cancel", sid=seq.sid,
                        generated=len(seq.generated()))
            self._resolve(seq, "cancelled")
        return True  # active: the scheduler retires it next iteration

    # -- scheduler ------------------------------------------------------
    def _resolve(self, seq, finish, error=None):
        """Resolve a sequence's future OUTSIDE the lock."""
        if error is not None:
            seq.future.set_exception(error)
        else:
            seq.future.set_result(seq.result_doc(finish))

    def _finish_locked(self, rep, seq, finish):
        """Account one sequence's exit (caller holds the lock): reclaim
        its pages, bump counters.  The single reclamation seam for
        complete / cancel / error / deadline / stop — zero leaked pages
        by construction."""
        rep.cache.free(seq.sid)
        self._account_exit_locked(seq, finish)

    def _account_exit_locked(self, seq, finish):
        """The bookkeeping half of an exit — callers (quarantine) whose
        pages were already reclaimed on the dead replica use this
        directly."""
        seq.finished = True
        self._outstanding -= 1
        if finish == "error":
            self._n_errors += 1
            self._reg_errors.inc()
        elif finish == "cancelled":
            self._n_cancelled += 1
            self._reg_cancelled.inc()
        elif finish == "deadline":
            # the CALLER's budget ran out: the future resolves with the
            # tokens produced so far, counted on its own meter
            self._n_deadline_expired += 1
            self._reg_deadline_expired.inc()
        elif finish == "stopped":
            # a close(drain=False) abort is a rejection, not a model
            # error — rejected-not-lost, same as the door
            self._n_rejected += 1
            self._reg_rejected.inc()
        else:
            self._n_completed += 1
            self._reg_completed.inc()
        self._reg_active.set(self._outstanding)
        self._reg_kv.set(sum(r.cache.used_pages()
                             for r in self._replicas))
        self._cond.notify_all()

    def _emit_token(self, seq, token):
        seq.tokens.append(int(token))
        self._n_tokens += 1
        self._reg_tokens.inc()
        if seq.on_token is not None:
            try:
                seq.on_token(int(token))
            # dklint: ignore[broad-except] a caller's token callback must never
            # kill the scheduler
            except Exception as e:  # noqa: BLE001
                events.emit("decode_error", sid=seq.sid,
                            where="on_token", error=type(e).__name__)

    def _sequence_done(self, seq, token):
        if seq.eos_id is not None and int(token) == seq.eos_id:
            return "eos"
        if len(seq.generated()) >= seq.max_new:
            return "length"
        return None

    def _prefill(self, rep, seq):
        """Run one admitted prompt through the prefill ladder; emits
        the first generated token (TTFT) or fails the sequence typed.

        A RECOVERED sequence (``seq.tokens`` longer than the prompt)
        replays the same prefill over the prompt only — its prediction
        is a token the stream already delivered, so it is discarded and
        the teacher-forced decode steps replay the rest."""
        rung = self._rung_for(seq.prompt_len, self.prefill_ladder)
        toks = np.zeros((rung,), np.int64)
        toks[:seq.prompt_len] = seq.tokens[:seq.prompt_len]
        page_idx = np.full((rung,), rep.cache.scratch_page, np.int64)
        ps = self.page_size
        for t in range(seq.prompt_len):
            page_idx[t] = seq.pages[t // ps]
        page_off = np.arange(rung, dtype=np.int64) % ps
        dev = self.device
        t0 = time.perf_counter()
        tw0 = time.time()
        if events.enabled():
            spans.span_at("serve.queue_wait", seq.ctx, seq.tw, tw0)
        try:
            perf.count_dispatch()
            first = int(self._prefill_fn(
                seq.params, rep.kp, rep.vp,
                torch.from_numpy(toks).to(dev), seq.prompt_len,
                torch.from_numpy(page_idx).to(dev),
                torch.from_numpy(page_off).to(dev)))
        # dklint: ignore[broad-except] a failed prefill lands TYPED on its own
        # future, pages reclaimed
        except Exception as e:  # noqa: BLE001
            with self._cond:
                rep.active.remove(seq)
                self._finish_locked(rep, seq, "error")
            events.emit("decode_error", sid=seq.sid, where="prefill",
                        error=type(e).__name__)
            self._resolve(seq, None, error=e)
            return
        dt = time.perf_counter() - t0
        with self._cond:
            self._shapes.add(("prefill", rung))
            self._ewma_prefill = (
                dt if self._ewma_prefill is None
                else 0.8 * self._ewma_prefill + 0.2 * dt)
        seq.kv_len = seq.prompt_len
        replay = len(seq.tokens) > seq.prompt_len
        if not replay:
            seq.ttft_s = time.monotonic() - seq.t
            ex = ((seq.ctx.trace_id, seq.ctx.span_id)
                  if seq.ctx is not None else None)
            self._m_ttft.observe(seq.ttft_s, exemplar=ex)
            self._reg_ttft.observe(seq.ttft_s, exemplar=ex)
        if events.enabled():
            spans.span_at("serve.prefill", seq.ctx, tw0, time.time(),
                          rung=rung, replica=rep.index)
        events.emit("decode_prefill", sid=seq.sid, rung=rung,
                    replica=rep.index, duration_s=dt,
                    ttft_s=seq.ttft_s, replay=replay)
        if replay:
            # the first generated token was emitted before the crash;
            # the replayed prediction stands for that same token —
            # discard it, the canonical seq.tokens drive the
            # teacher-forced catch-up steps
            return
        self._emit_token(seq, first)
        finish = self._sequence_done(seq, first)
        if finish is not None:
            with self._cond:
                rep.active.remove(seq)
                self._finish_locked(rep, seq, finish)
            events.emit("decode_complete", sid=seq.sid, finish=finish,
                        generated=len(seq.generated()),
                        steps=seq.steps)
            self._resolve(seq, finish)

    def _step_group(self, rep, group):
        """One decode step for ``group`` (same pinned params), padded
        to a decode-ladder rung.  A failed dispatch retries IN PLACE
        (``step_retries`` — safe: pools and ``kv_len`` only advance on
        success); past the retries the replica quarantines when a
        survivor exists (the group migrates and replays), else it
        fails exactly this group's sequences, typed, pages reclaimed.

        The input token is ``seq.tokens[seq.kv_len]`` — the last token
        in steady state, a teacher-forced KNOWN token while a recovered
        sequence catches back up (its predictions are discarded until
        ``kv_len`` reaches the frontier, so streams never see a
        duplicate)."""
        rung = self._rung_for(len(group), self.decode_ladder)
        ps = self.page_size
        toks = np.zeros((rung,), np.int64)
        positions = np.zeros((rung,), np.int64)
        tables = np.zeros((rung, self.max_pages_per_seq), np.int32)
        wpage = np.full((rung,), rep.cache.scratch_page, np.int64)
        woff = np.zeros((rung,), np.int64)
        lengths = np.zeros((rung,), np.int32)
        for i, seq in enumerate(group):
            toks[i] = seq.tokens[seq.kv_len]
            positions[i] = seq.kv_len
            tables[i, :len(seq.pages)] = seq.pages
            wpage[i] = seq.pages[seq.kv_len // ps]
            woff[i] = seq.kv_len % ps
            lengths[i] = seq.kv_len + 1
        dev = self.device
        t0 = time.perf_counter()
        err = None
        for attempt in range(1 + self.step_retries):
            try:
                fault_point("decode.step")
                perf.count_dispatch()
                nxt = self._decode_fn(
                    group[0].params, rep.kp, rep.vp,
                    *(torch.from_numpy(a).to(dev) for a in (
                        toks, positions, tables, wpage, woff, lengths))
                ).cpu().numpy()
                err = None
                break
            # dklint: ignore[broad-except] a failed step retries in place, then
            # quarantines or lands TYPED
            except Exception as e:  # noqa: BLE001
                err = e
                if attempt < self.step_retries:
                    events.emit("decode_error", where="step_retry",
                                n=len(group), replica=rep.index,
                                attempt=attempt,
                                error=type(e).__name__)
        if err is not None:
            with self._cond:
                survivors = [r for r in self._live_replicas_locked()
                             if r is not rep]
            if survivors:
                # a peer can hold this work: quarantine this replica,
                # migrate + replay — the futures never see the failure
                raise _ReplicaDead(err)
            with self._cond:
                for seq in group:
                    rep.active.remove(seq)
                    self._finish_locked(rep, seq, "error")
            events.emit("decode_error", where="step", n=len(group),
                        replica=rep.index, error=type(err).__name__)
            for seq in group:
                self._resolve(seq, None, error=err)
            return
        dt = time.perf_counter() - t0
        self._m_step.observe(dt)
        self._reg_step.observe(dt)
        with self._cond:
            self._shapes.add(("decode", rung))
            self._ewma_step = (dt if self._ewma_step is None
                               else 0.8 * self._ewma_step + 0.2 * dt)
        events.emit("decode_step", replica=rep.index, rung=rung,
                    n=len(group), duration_s=dt)
        finished = []
        for i, seq in enumerate(group):
            seq.kv_len += 1
            seq.steps += 1
            if seq.kv_len < len(seq.tokens):
                # replay catch-up: this prediction is a token the
                # stream already delivered before the crash — discard
                continue
            self._emit_token(seq, int(nxt[i]))
            finish = self._sequence_done(seq, int(nxt[i]))
            if finish is not None:
                finished.append((seq, finish))
        if finished:
            with self._cond:
                for seq, finish in finished:
                    rep.active.remove(seq)
                    self._finish_locked(rep, seq, finish)
            for seq, finish in finished:
                events.emit("decode_complete", sid=seq.sid,
                            finish=finish,
                            generated=len(seq.generated()),
                            steps=seq.steps)
                self._resolve(seq, finish)

    def _worker_main(self, rep):
        """Thread body: the scheduler loop plus the crash boundary.
        ANY escape — the :class:`_ReplicaDead` signal (kill seam, step
        failure past retries) or an unexpected scheduler bug —
        quarantines the replica so its sequences migrate or resolve
        typed instead of hanging on a silently dead thread."""
        try:
            with torch.inference_mode(), on_stream(rep.stream):
                self._worker_loop(rep)
        except _ReplicaDead as e:
            self._quarantine(rep, e.cause)
        # dklint: ignore[broad-except] a crashed worker quarantines its
        # replica; sequences migrate or land typed, never hang
        except Exception as e:  # noqa: BLE001
            self._quarantine(rep, e)

    def _worker_loop(self, rep):
        while True:
            dropped = []
            with self._cond:
                # pending orphans hold the park open: an idle replica
                # has its whole pool free, so the next placement pass
                # below always lands them
                while (not rep.queue and not rep.active
                       and not self._orphans
                       and not self._stopped and not rep.retiring
                       and not rep.killed):
                    # dklint: ignore[unbounded-wait] the idle park: every
                    # admit, cancel and lifecycle exit notifies this cond, and
                    # the predicate re-checks stop / retire / kill on wake
                    self._cond.wait()
                if self._stopped:
                    break
                if rep.killed:
                    raise _ReplicaDead(Overloaded("replica_lost"))
                if rep.retiring and not rep.queue and not rep.active:
                    break
                o_migrated, o_dropped = \
                    self._try_place_orphans_locked()
                # retire cancelled and deadline-expired actives, refill
                # free slots — the continuous-batching seam: between
                # iterations, never a batch barrier.  An expired
                # deadline frees the slot HERE, between steps.
                now = time.monotonic()
                for seq in list(rep.active):
                    fin = ("cancelled" if seq.cancelled else
                           "deadline" if seq.deadline is not None
                           and now > seq.deadline else None)
                    if fin is not None:
                        rep.active.remove(seq)
                        self._finish_locked(rep, seq, fin)
                        dropped.append((seq, fin))
                while rep.queue and len(rep.active) < self.max_slots:
                    seq = rep.queue.popleft()
                    fin = ("cancelled" if seq.cancelled else
                           "deadline" if seq.deadline is not None
                           and now > seq.deadline else None)
                    if fin is not None:
                        self._finish_locked(rep, seq, fin)
                        dropped.append((seq, fin))
                        continue
                    rep.active.append(seq)
                # prefill candidates by state, not by admission order:
                # a recovered sequence re-enters here with kv_len == 0
                # and replays exactly like a fresh admission
                prefills = [s for s in rep.active if s.kv_len == 0]
            for seq, target in o_migrated:
                self._reg_recovered.inc()
                events.emit("decode_recover", sid=seq.sid, src=None,
                            dst=target.index,
                            generated=len(seq.generated()),
                            recoveries=seq.recoveries)
            dropped.extend(o_dropped)
            for seq, fin in dropped:
                if fin == "cancelled":
                    events.emit("decode_cancel", sid=seq.sid,
                                generated=len(seq.generated()))
                else:
                    events.emit("decode_deadline", sid=seq.sid,
                                phase="expiry",
                                generated=len(seq.generated()))
                self._resolve(seq, fin)
            for seq in prefills:
                self._prefill(rep, seq)
                if rep.killed:
                    raise _ReplicaDead(Overloaded("replica_lost"))
            with self._cond:
                # group by pinned params: a hot reload means at most a
                # couple of groups until old sequences drain
                groups = {}
                for seq in rep.active:
                    if seq.kv_len == 0:
                        continue  # not prefilled yet: next pass
                    groups.setdefault(id(seq.params), []).append(seq)
                work = list(groups.values())
            for group in work:
                self._step_group(rep, group)
                if rep.killed:
                    raise _ReplicaDead(Overloaded("replica_lost"))
            self._maybe_self_check()

    # -- survivability: quarantine + sequence-level recovery ------------
    def kill_replica(self, index):
        """Chaos seam: crash one replica worker (the thread analogue of
        SIGKILL on a replica process).  The worker observes the flag at
        its next seam, quarantines the replica — pages freed, in-flight
        sequences re-admitted onto survivors and replayed — and exits.
        Refused (``ValueError``) for the LAST live replica: whole-pod
        loss is not a survivable event."""
        with self._cond:
            rep = next((r for r in self._replicas
                        if r.index == int(index)), None)
            if rep is None or rep.dead or rep.killed:
                raise ValueError(
                    f"kill_replica({index}): no such live replica")
            live = self._live_replicas_locked()
            if rep in live and len(live) <= 1:
                raise ValueError(
                    "kill_replica: refusing to kill the last live "
                    "replica (whole-pod loss is out of scope)")
            rep.killed = True
            self._cond.notify_all()
        return rep.index

    def _place_locked(self, seq):
        """Re-admission placement (caller holds the lock): the
        surviving replica with the most free pages that can hold the
        sequence's WORST-CASE reservation — the same door contract as
        submit_generate.  -> the replica, or None when nowhere fits.
        Every replica shares the engine's device, so the sequence keeps
        its pinned params."""
        total = seq.prompt_len + seq.max_new
        live = self._live_replicas_locked()
        live.sort(key=lambda r: -r.cache.stats()["free_pages"])
        for rep in live:
            try:
                seq.pages = rep.cache.alloc(seq.sid, total)
            except PagesExhausted:
                continue
            return rep
        return None

    def _fits_somewhere_locked(self, seq):
        """Could ANY live replica's whole pool hold this sequence's
        worst-case reservation?  If yes, a full-but-alive pool is a
        capacity wait, not a loss."""
        total = seq.prompt_len + seq.max_new
        return any(r.cache.pages_for(total) <= r.cache.num_pages
                   for r in self._live_replicas_locked())

    def _readmit_locked(self, seq, target):
        seq.kv_len = 0          # replay regenerates the KV
        seq.recoveries += 1
        target.queue.append(seq)
        self._n_recovered += 1

    def _try_place_orphans_locked(self):
        """Place pending orphans — recovered sequences waiting for
        survivor capacity (caller holds the lock).  They hold NO pages
        while pending; placement reserves worst-case, exactly like
        admission.  -> (migrated, dropped) pairs for the caller to emit
        events / resolve futures OUTSIDE the lock."""
        migrated, dropped = [], []
        if not self._orphans:
            return migrated, dropped
        now = time.monotonic()
        still = []
        for seq in self._orphans:
            fin = ("cancelled" if seq.cancelled else
                   "deadline" if seq.deadline is not None
                   and now > seq.deadline else None)
            if fin is not None:
                self._account_exit_locked(seq, fin)
                dropped.append((seq, fin))
                continue
            target = self._place_locked(seq)
            if target is None:
                still.append(seq)
                continue
            self._readmit_locked(seq, target)
            migrated.append((seq, target))
        self._orphans[:] = still
        if migrated:
            self._cond.notify_all()
        return migrated, dropped

    def _quarantine(self, rep, cause):
        """Take a crashed replica out of service and carry its
        sequences over: free every page it held, re-admit each
        in-flight sequence onto a survivor (``kv_len`` reset — the
        replay regenerates its KV from the canonical tokens), park what
        fits a survivor's pool but not its current free list (placed as
        capacity frees), and resolve typed only what no survivor could
        EVER hold.  Futures never hang; pages never leak."""
        with self._cond:
            rep.killed = True
            rep.dead = True
            rep.retiring = True     # out of _pick_replica rotation
            orphans = list(rep.active) + list(rep.queue)
            del rep.active[:]
            rep.queue.clear()
            for seq in orphans:
                rep.cache.free(seq.sid)
            self._n_quarantines += 1
            self._cond.notify_all()
        self._reg_quarantines.inc()
        events.emit("decode_quarantine", replica=rep.index,
                    orphans=len(orphans), cause=type(cause).__name__)
        recover_err = None
        try:
            fault_point("decode.recover")
        # dklint: ignore[broad-except] a failed recovery resolves every orphan
        # TYPED — never a hang
        except Exception as e:  # noqa: BLE001
            recover_err = e
        migrated = []
        resolved = []
        with self._cond:
            for seq in orphans:
                if seq.cancelled:
                    self._account_exit_locked(seq, "cancelled")
                    resolved.append((seq, "cancelled", None))
                    continue
                target = (None if recover_err is not None
                          else self._place_locked(seq))
                if target is None:
                    if recover_err is None \
                            and self._fits_somewhere_locked(seq):
                        # survivors exist but are full RIGHT NOW: the
                        # sequence was admitted once, so it WAITS for
                        # capacity instead of failing
                        self._orphans.append(seq)
                        continue
                    # no survivor can EVER hold it (or recovery itself
                    # is the injected failure): typed, never hung
                    err = recover_err if recover_err is not None \
                        else cause
                    if not isinstance(err, BaseException):
                        err = Overloaded("replica_lost")
                    self._account_exit_locked(seq, "error")
                    resolved.append((seq, None, err))
                    continue
                self._readmit_locked(seq, target)
                migrated.append((seq, target))
            self._cond.notify_all()
        for seq, target in migrated:
            self._reg_recovered.inc()
            events.emit("decode_recover", sid=seq.sid,
                        src=rep.index, dst=target.index,
                        generated=len(seq.generated()),
                        recoveries=seq.recoveries)
        for seq, fin, err in resolved:
            if fin == "cancelled":
                events.emit("decode_cancel", sid=seq.sid,
                            generated=len(seq.generated()))
            else:
                events.emit("decode_error", sid=seq.sid,
                            where="quarantine",
                            error=type(err).__name__)
            self._resolve(seq, fin, error=err)

    def _maybe_self_check(self):
        now = time.monotonic()
        with self._cond:
            if now < self._next_self_check:
                return
            self._next_self_check = now + self._self_check_interval
        self.self_check()

    def self_check(self):
        """Reconcile every allocator against the sequences the
        scheduler actually holds — the periodic backstop behind
        :meth:`assert_no_leaks`.  An allocation owned by NO queued or
        active sequence is a leak: reclaimed here, counted on
        ``decode.kv_leaked``, and reported.  -> pages reclaimed."""
        leaked = 0
        stale = []
        with self._cond:
            for rep in self._replicas:
                owned = {s.sid for s in rep.active}
                owned.update(s.sid for s in rep.queue)
                for sid in rep.cache.sequence_ids():
                    if sid not in owned:
                        n = rep.cache.free(sid)
                        leaked += n
                        stale.append((rep.index, sid, n))
            if leaked:
                self._n_kv_leaked += leaked
        for rep_index, sid, n in stale:
            self._reg_kv_leaked.inc(n)
            events.emit("decode_kv_leak", replica=rep_index, sid=sid,
                        pages=n)
        return leaked

    # -- hot reload -----------------------------------------------------
    @property
    def params(self):
        """The params tree new sequences are admitted under, on the
        engine's device (the hot-reload watcher restores onto it as a
        template)."""
        return self._params

    def set_params(self, state, step=None):
        """Swap every replica's params reference.  In-flight sequences
        keep their pinned params (finish on what they started with);
        sequences admitted after this call see the new ones.  ``state``
        is a params tree (numpy or tensor leaves) or ``{"params":
        tree}``."""
        params = (state["params"]
                  if isinstance(state, dict) and "params" in state
                  else state)
        params = put_params(params, [self.device])[self.device]
        with self._cond:
            for rep in self._replicas:
                rep.params = params
            self._params = params
            self.reload_count += 1
        metrics.counter("serve.reloads").inc()
        events.emit("serve_reload", step=step, role="decode",
                    replicas=len(self._replicas))

    # -- elastic replica set --------------------------------------------
    def resize(self, n):
        """Grow or shrink the replica set.  Grow: fresh replicas with
        fresh KV pools and streams on the engine's device.  Shrink:
        retired replicas stop admitting, finish every sequence they
        hold, then exit (nothing admitted is ever dropped).  -> the new
        live replica count."""
        n = int(n)
        if n < 1:
            raise ValueError(f"resize({n}): must keep >= 1 replica")
        started = []
        with self._cond:
            if self._stopped or self._draining:
                raise Overloaded(
                    "stopped" if self._stopped else "draining")
            live = [r for r in self._replicas if not r.retiring]
            cur = len(live)
            if n < cur:
                for rep in live[n:]:
                    rep.retiring = True
                self._rr = 0
                self._cond.notify_all()
            elif n > cur:
                for _ in range(n - cur):
                    idx = self._next_replica_index
                    self._next_replica_index += 1
                    rep = self._make_replica(idx)
                    self._replicas.append(rep)
                    t = self._worker_thread(rep)
                    self._workers.append(t)
                    started.append(t)
        for t in started:
            t.start()
        return n

    # -- lifecycle ------------------------------------------------------
    def drain(self, timeout_s=None):
        """Stop admission (typed rejection), let every admitted
        sequence decode to completion, then stop the schedulers.
        Nothing admitted is ever dropped.  -> delivery counts."""
        t0 = time.perf_counter()
        with self._cond:
            self._draining = True
            backlog = self._outstanding
            self._cond.notify_all()
        events.emit("serve_drain_begin", backlog=backlog,
                    role="decode")
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        with self._cond:
            while self._outstanding:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"drain: {self._outstanding} sequences still "
                        f"in flight after {timeout_s}s")
                self._cond.wait(remaining)
        self._shutdown_threads()
        out = {"delivered": self._n_completed,
               "errored": self._n_errors,
               "rejected": self._n_rejected,
               "cancelled": self._n_cancelled,
               "duration_s": time.perf_counter() - t0}
        events.emit("decode_drain", **out)
        return out

    def _shutdown_threads(self):
        with self._cond:
            first = not self._stopped
            self._stopped = True
            self._cond.notify_all()
        if not first:
            self._drained.wait(timeout=10)
            return
        for t in self._workers:
            if t is not threading.current_thread():
                t.join(timeout=10)
        self._drained.set()

    def close(self, drain=True, timeout_s=None):
        """Stop the engine.  ``drain=True`` finishes the backlog;
        ``drain=False`` fails unresolved sequences with a typed
        :class:`Overloaded` and reclaims their pages (never a silent
        drop, never a leaked page)."""
        if self._stopped:
            return
        if drain:
            self.drain(timeout_s=timeout_s)
            return
        with self._cond:
            self._draining = True
        self._shutdown_threads()
        orphans = []
        with self._cond:
            for rep in self._replicas:
                for seq in list(rep.queue) + list(rep.active):
                    orphans.append((rep, seq))
                rep.queue.clear()
                del rep.active[:]
            for rep, seq in orphans:
                self._finish_locked(rep, seq, "stopped")
            pending = list(self._orphans)
            self._orphans[:] = []
            for seq in pending:   # page-less: bookkeeping half only
                self._account_exit_locked(seq, "stopped")
        for _, seq in orphans:
            self._resolve(seq, None, error=Overloaded("stopped"))
        for seq in pending:
            self._resolve(seq, None, error=Overloaded("stopped"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def draining(self):
        return self._draining

    @property
    def running(self):
        return not self._stopped

    def kv_stats(self):
        """Aggregate + per-replica page-pool accounting (retired
        replicas left out)."""
        per = [r.cache.stats() for r in self._replicas
               if not r.retiring]
        total = sum(p["num_pages"] for p in per)
        used = sum(p["used_pages"] for p in per)
        return {
            "num_pages": total,
            "used_pages": used,
            "peak_pages": sum(p["peak_pages"] for p in per),
            "occupancy": (used / total) if total else 0.0,
            "sequences": sum(p["sequences"] for p in per),
            "replicas": per,
        }

    def assert_no_leaks(self):
        """Every replica's allocator balances and, when idle, holds
        zero pages."""
        for rep in self._replicas:
            rep.cache.assert_balanced()
        with self._cond:
            idle = self._outstanding == 0
        if idle:
            for rep in self._replicas:
                used = rep.cache.used_pages()
                if used:
                    raise AssertionError(
                        f"replica {rep.index} leaked {used} KV pages "
                        "with no sequence outstanding")

    def stats(self):
        """JSON-ready engine counters, with the shape-count contract:
        ``retrace_count`` (distinct (phase, rung) shapes dispatched) is
        bounded by ``retrace_bound``."""
        with self._cond:
            queued = sum(len(r.queue) for r in self._replicas)
            active = sum(len(r.active) for r in self._replicas)
            outstanding = self._outstanding
            shapes = sorted(self._shapes)
            live = len(self._live_replicas_locked())
            dead = sum(1 for r in self._replicas if r.dead)
        return {
            "replicas": live,
            "device": str(self.device),
            "prefill_ladder": list(self.prefill_ladder),
            "decode_ladder": list(self.decode_ladder),
            "page_size": self.page_size,
            "queued": queued,
            "active": active,
            "pending": queued,
            "outstanding": outstanding,
            "admitted": self._n_admitted,
            "completed": self._n_completed,
            "rejected": self._n_rejected,
            "errors": self._n_errors,
            "cancelled": self._n_cancelled,
            "tokens": self._n_tokens,
            "quarantines": self._n_quarantines,
            "recovered": self._n_recovered,
            "shed": self._n_shed,
            "deadline_infeasible": self._n_deadline_infeasible,
            "deadline_expired": self._n_deadline_expired,
            "kv_leaked": self._n_kv_leaked,
            "orphans_pending": len(self._orphans),
            "replicas_dead": dead,
            "reloads": self.reload_count,
            "shapes_dispatched": shapes,
            "retrace_count": len(shapes),
            "retrace_bound": (len(self.prefill_ladder)
                              + len(self.decode_ladder)),
            "draining": self._draining,
            "kv": self.kv_stats(),
            "ttft_s": self._m_ttft.summary(),
            "step_s": self._m_step.summary(),
        }
