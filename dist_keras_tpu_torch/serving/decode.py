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
  cancel and error all reclaim through the one allocator path.
- **Hot reload never drops a sequence.**  ``submit_generate`` pins the
  replica's CURRENT params into the sequence; ``set_params`` swaps the
  replica reference only, and decode iterations group active sequences
  by the params they were admitted with.
- **The kernels.**  On CUDA, prefill attention is the flash-forward
  kernel (``ops/flash_attention.py``) and each decode step's attention
  the paged-decode kernel (``ops/decode_attention.py``); on the CPU both
  take their plain versions.

Not ported yet (a later slice): replica kill / quarantine / sequence
replay, deadlines, brownout shedding, the allocator self-check,
``resize``, fault points, and event / metric / span emission.
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
from dist_keras_tpu_torch.ops.decode_attention import paged_attention_auto
from dist_keras_tpu_torch.ops.flash_attention import attention_auto
from dist_keras_tpu_torch.serving.engine import Overloaded
from dist_keras_tpu_torch.serving.kv_cache import PagedKVCache
from dist_keras_tpu_torch.utils.bridge import params_from_jax
from dist_keras_tpu_torch.utils.device import resolve_device


class _Sequence:
    """One admitted generation: host-side state the scheduler owns."""

    __slots__ = ("sid", "tokens", "prompt_len", "max_new", "eos_id",
                 "future", "on_token", "t", "params", "pages", "kv_len",
                 "steps", "cancelled", "ttft_s", "finished")

    def __init__(self, sid, tokens, max_new, eos_id, on_token, params,
                 pages):
        self.sid = sid
        self.tokens = list(tokens)
        self.prompt_len = len(tokens)
        self.max_new = max_new
        self.eos_id = eos_id
        self.future = Future()
        self.on_token = on_token
        self.t = time.monotonic()
        self.params = params      # pinned: reloads never touch us
        self.pages = pages
        self.kv_len = 0           # KV positions written so far
        self.steps = 0            # decode iterations consumed
        self.cancelled = False
        self.ttft_s = None
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
    """One replica: its params swap point, its KV pools, its queue."""

    def __init__(self, index, params, cache, kp, vp):
        self.index = index
        self.params = params
        self.cache = cache
        self.kp = kp
        self.vp = vp
        self.queue = collections.deque()
        self.active = []
        self.dead = False         # its worker crashed: out of rotation


class DecodeEngine:
    """Continuous-batching decode over the causal Transformer.

    Args:
      model: a port ``models.transformer.Transformer`` (anything with a
        ``cfg`` dict and a reference-layout ``params`` tree).  Decode
        needs token in == logit out, so ``input_dim == n_classes`` (the
        vocabulary).
      replicas: replica count (each with its own KV pools and scheduler
        thread, all on ``device``).
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
    """

    def __init__(self, model, replicas=1, prefill_ladder=(16, 64),
                 decode_ladder=(1, 4, 8), page_size=8, num_pages=None,
                 max_queue=256, max_new_default=16, eos_id=None,
                 device=None):
        cfg = getattr(model, "cfg", None)
        if cfg is None:
            raise ValueError(
                "DecodeEngine needs the causal Transformer model "
                "contract (a cfg dict); got "
                f"{type(model).__name__}")
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
        self._params = params_from_jax(model.params, self.device)
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
        self._n_admitted = 0
        self._n_completed = 0
        self._n_rejected = 0
        self._n_errors = 0
        self._n_cancelled = 0
        self._n_tokens = 0

        self._workers = [threading.Thread(
            target=self._worker_main, args=(rep,), daemon=True,
            name=f"dk-decode-worker-{rep.index}")
            for rep in self._replicas]
        for t in self._workers:
            t.start()

    # -- model math (one shape per ladder rung) -------------------------
    def _make_replica(self, index):
        cache = PagedKVCache(self.num_pages, self.page_size)
        shape = (self._layers, self._heads, self.num_pages + 1,
                 self.page_size, self._dh)
        kp = torch.zeros(shape, dtype=torch.float32, device=self.device)
        vp = torch.zeros(shape, dtype=torch.float32, device=self.device)
        return _DecodeReplica(index, self._params, cache, kp, vp)

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
        return [r for r in self._replicas if not r.dead]

    def _pick_replica(self, needed_pages):
        """Most free pages wins (KV is the scarce resource), round-robin
        on ties.  Caller holds the lock."""
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

    def submit_generate(self, tokens, max_new_tokens=None, eos_id=None,
                        on_token=None):
        """Admit one prompt; -> :class:`Generation` whose future
        resolves to the result doc (tokens, ttft_s, finish reason).
        Raises :class:`Overloaded` at the door (``queue_full`` /
        ``kv_exhausted`` / ``draining`` / ``stopped``) and
        ``ValueError`` for malformed prompts — rejected, never lost.
        ``on_token(token)`` runs on the scheduler thread as each token
        lands."""
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
        with self._cond:
            if self._draining or self._stopped:
                self._n_rejected += 1
                raise Overloaded(
                    "draining" if self._draining else "stopped")
            if self._outstanding >= self.max_queue:
                self._n_rejected += 1
                raise Overloaded("queue_full",
                                 pending=self._outstanding,
                                 capacity=self.max_queue)
            sid = next(self._seq_ids)
            needed = max(1, -(-total // self.page_size))
            rep, best_free = self._pick_replica(needed)
            if rep is None:
                self._n_rejected += 1
                raise Overloaded("kv_exhausted", pending=needed,
                                 capacity=best_free)
            pages = rep.cache.alloc(sid, total)
            seq = _Sequence(sid, toks, max_new, eos, on_token,
                            rep.params, pages)
            rep.queue.append(seq)
            self._outstanding += 1
            self._n_admitted += 1
            self._cond.notify_all()
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
            # still queued? finish it here, never occupying a slot
            for rep in self._replicas:
                if seq in rep.queue:
                    rep.queue.remove(seq)
                    self._finish_locked(rep, seq, "cancelled")
                    dequeued = True
                    break
            self._cond.notify_all()
        if dequeued:
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
        complete / cancel / error / stop — zero leaked pages by
        construction."""
        rep.cache.free(seq.sid)
        seq.finished = True
        self._outstanding -= 1
        if finish == "error":
            self._n_errors += 1
        elif finish == "cancelled":
            self._n_cancelled += 1
        elif finish == "stopped":
            # a close(drain=False) abort is a rejection, not a model
            # error — rejected-not-lost, same as the door
            self._n_rejected += 1
        else:
            self._n_completed += 1
        self._cond.notify_all()

    def _fail_locked(self, rep, seqs, error, failed):
        for seq in seqs:
            if seq in rep.active:
                rep.active.remove(seq)
            self._finish_locked(rep, seq, "error")
            failed.append((seq, error))

    def _emit_token(self, seq, token):
        seq.tokens.append(int(token))
        self._n_tokens += 1
        if seq.on_token is not None:
            try:
                seq.on_token(int(token))
            # a caller's token callback must never kill the scheduler
            except Exception:  # noqa: BLE001
                pass

    def _sequence_done(self, seq, token):
        if seq.eos_id is not None and int(token) == seq.eos_id:
            return "eos"
        if len(seq.generated()) >= seq.max_new:
            return "length"
        return None

    def _prefill(self, rep, seq):
        """Run one admitted prompt through the prefill ladder; emits
        the first generated token (TTFT) or fails the sequence typed."""
        rung = self._rung_for(seq.prompt_len, self.prefill_ladder)
        toks = np.zeros((rung,), np.int64)
        toks[:seq.prompt_len] = seq.tokens
        page_idx = np.full((rung,), rep.cache.scratch_page, np.int64)
        ps = self.page_size
        for t in range(seq.prompt_len):
            page_idx[t] = seq.pages[t // ps]
        page_off = np.arange(rung, dtype=np.int64) % ps
        dev = self.device
        try:
            first = int(self._prefill_fn(
                seq.params, rep.kp, rep.vp,
                torch.from_numpy(toks).to(dev), seq.prompt_len,
                torch.from_numpy(page_idx).to(dev),
                torch.from_numpy(page_off).to(dev)))
        # a failed prefill lands TYPED on its own future, pages reclaimed
        except Exception as e:  # noqa: BLE001
            failed = []
            with self._cond:
                self._fail_locked(rep, [seq], e, failed)
            self._resolve(seq, None, error=e)
            return
        with self._cond:
            self._shapes.add(("prefill", rung))
        seq.kv_len = seq.prompt_len
        seq.ttft_s = time.monotonic() - seq.t
        self._emit_token(seq, first)
        finish = self._sequence_done(seq, first)
        if finish is not None:
            with self._cond:
                rep.active.remove(seq)
                self._finish_locked(rep, seq, finish)
            self._resolve(seq, finish)

    def _step_group(self, rep, group):
        """One decode step for ``group`` (same pinned params), padded
        to a decode-ladder rung.  A failed dispatch fails exactly this
        group's sequences, typed, pages reclaimed (pools and ``kv_len``
        only advance on success)."""
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
        try:
            nxt = self._decode_fn(
                group[0].params, rep.kp, rep.vp,
                *(torch.from_numpy(a).to(dev) for a in (
                    toks, positions, tables, wpage, woff, lengths))
            ).cpu().numpy()
        # a failed step lands TYPED on this group's futures
        except Exception as e:  # noqa: BLE001
            failed = []
            with self._cond:
                self._fail_locked(rep, group, e, failed)
            for seq, err in failed:
                self._resolve(seq, None, error=err)
            return
        with self._cond:
            self._shapes.add(("decode", rung))
        finished = []
        for i, seq in enumerate(group):
            seq.kv_len += 1
            seq.steps += 1
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
                self._resolve(seq, finish)

    def _worker_main(self, rep):
        """Thread body: the scheduler loop plus the crash boundary.  An
        unexpected escape takes the replica out of rotation and fails
        every sequence it holds typed, pages reclaimed — never a hang
        on a silently dead thread."""
        try:
            with torch.inference_mode():
                self._worker_loop(rep)
        # the crash boundary of a scheduler thread: sequences land typed
        except Exception as e:  # noqa: BLE001
            failed = []
            with self._cond:
                rep.dead = True
                held = list(rep.active) + list(rep.queue)
                rep.queue.clear()
                self._fail_locked(rep, held, e, failed)
            for seq, err in failed:
                self._resolve(seq, None, error=err)

    def _worker_loop(self, rep):
        while True:
            dropped = []
            with self._cond:
                # the idle park: every admit, cancel and lifecycle exit
                # notifies this cond, and the predicate re-checks stop
                while (not rep.queue and not rep.active
                       and not self._stopped):
                    self._cond.wait()
                if self._stopped:
                    break
                # retire cancelled actives, refill free slots — the
                # continuous-batching seam: between iterations, never a
                # batch barrier
                for seq in list(rep.active):
                    if seq.cancelled:
                        rep.active.remove(seq)
                        self._finish_locked(rep, seq, "cancelled")
                        dropped.append(seq)
                while rep.queue and len(rep.active) < self.max_slots:
                    seq = rep.queue.popleft()
                    if seq.cancelled:
                        self._finish_locked(rep, seq, "cancelled")
                        dropped.append(seq)
                        continue
                    rep.active.append(seq)
                prefills = [s for s in rep.active if s.kv_len == 0]
            for seq in dropped:
                self._resolve(seq, "cancelled")
            for seq in prefills:
                self._prefill(rep, seq)
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

    # -- hot reload -----------------------------------------------------
    def set_params(self, state):
        """Swap every replica's params reference.  In-flight sequences
        keep their pinned params (finish on what they started with);
        sequences admitted after this call see the new ones.  ``state``
        is a params tree (numpy or tensor leaves) or ``{"params":
        tree}``."""
        params = (state["params"]
                  if isinstance(state, dict) and "params" in state
                  else state)
        params = params_from_jax(params, self.device)
        with self._cond:
            for rep in self._replicas:
                rep.params = params
            self._params = params
            self.reload_count += 1

    # -- lifecycle ------------------------------------------------------
    def drain(self, timeout_s=None):
        """Stop admission (typed rejection), let every admitted
        sequence decode to completion, then stop the schedulers.
        Nothing admitted is ever dropped.  -> delivery counts."""
        t0 = time.perf_counter()
        with self._cond:
            self._draining = True
            self._cond.notify_all()
            deadline = (None if timeout_s is None
                        else time.monotonic() + timeout_s)
            while self._outstanding:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"drain: {self._outstanding} sequences still "
                        f"in flight after {timeout_s}s")
                self._cond.wait(remaining)
        self._shutdown_threads()
        return {"delivered": self._n_completed,
                "errored": self._n_errors,
                "rejected": self._n_rejected,
                "cancelled": self._n_cancelled,
                "duration_s": time.perf_counter() - t0}

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
        for _, seq in orphans:
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
        """Aggregate + per-replica page-pool accounting."""
        per = [r.cache.stats() for r in self._replicas]
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
            "reloads": self.reload_count,
            "shapes_dispatched": shapes,
            "retrace_count": len(shapes),
            "retrace_bound": (len(self.prefill_ladder)
                              + len(self.decode_ladder)),
            "draining": self._draining,
            "kv": self.kv_stats(),
        }
