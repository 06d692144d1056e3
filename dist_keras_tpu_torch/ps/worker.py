"""PS worker mode — the async trainer family over a real server;
counterpart of the JAX package's ``ps/worker.py``.

``PSWorkerTrainer`` is the multi-process counterpart of the single-card
staggered-staleness loop (``trainers/dynsgd.py``): each worker process
pulls the center variable, trains one **communication window** of local
steps on its card (the step every trainer builds,
``Trainer._make_step``), and commits its float32 ``local - pulled``
delta tagged with the version it pulled.  The SERVER applies the DynSGD
scaling ``1/(1+staleness)``, so slow workers, restarts and late joins
are the normal case:

- a **slow** worker's commits arrive with higher staleness and are
  scaled down server-side;
- a **restarted** worker re-joins (sticky ``worker_id`` or a fresh
  one), pulls, and goes — its lease had lapsed, nothing stalled;
- an **over-cap** commit (``DK_PS_STALENESS_CAP``) comes back as a
  typed ``StaleCommit``: the worker drops that window's delta,
  re-pulls, and continues;
- a server restart surfaces as retried RPCs (the named ``ps.*`` retry
  surfaces) against the restored center.

On the card, as ``SingleTrainer`` runs (``trainers/single.py``):

- the epoch's batches are copied to the device once, and global step
  ``t`` reads batch ``t % steps_per_epoch``;
- one ``torch.Generator`` on the device, seeded with ``seed``, is the
  run's random stream (dropout masks), continuous across windows;
- a window's steps run as a Python loop, each loss written into a
  device tensor fetched once per window;
- the delta is computed on the card against the f32 snapshot taken at
  the last pull and copied to the host in one transfer; the center the
  server answers with goes back to the card.

What crosses the wire is numpy, never a tensor, in the JAX package's
format: a worker of either package talks to a server of either.  Each
worker is one process on one card talking HTTP, so a launch
environment with ``DK_COORD_WORLD`` > 1 is accepted here (its
``DK_COORD_RANK`` is the identity the server's host-drop evidence
lapses by), where every other trainer refuses it.

A window's wall is split into always-on ``perf.phase.*`` histograms of
the metrics registry: ``ps_steps`` (the local steps and the loss
fetch), ``ps_delta`` (the delta and its copy to the host),
``ps_encode``, ``ps_commit`` (the commit round trip) and ``ps_merge``
(the center back to the card).

Windows align to epoch boundaries (the last window of an epoch may be
short), so per-epoch metrics and events keep the family contract.  The
returned model carries the FINAL CENTER variable (the authoritative
weights), not this worker's local replica.
"""

from __future__ import annotations

import numpy as np
import torch

from dist_keras_tpu_torch.observability import metrics as _metrics
from dist_keras_tpu_torch.observability import perf
from dist_keras_tpu_torch.ps import compress as _compress
from dist_keras_tpu_torch.ps.center import StaleCommit
from dist_keras_tpu_torch.ps.client import PSClient
from dist_keras_tpu_torch.resilience import world as _dkworld
from dist_keras_tpu_torch.trainers.base import Trainer
from dist_keras_tpu_torch.utils import knobs
from dist_keras_tpu_torch.utils.pytree import tree_leaves, tree_map


def _merge_center(center, local):
    """Adopt the pulled center (numpy) for float leaves, on ``local``'s
    device and dtype; keep local for the rest (integer leaves are RNG
    state — the ``tree_merge_floats`` exemption policy).  Walks
    ``local``'s keys, so a center whose dicts are ordered otherwise (the
    JAX package's sorted keys) merges leaf for leaf."""
    return tree_map(
        lambda l, c: torch.from_numpy(np.asarray(c)).to(
            l.device, l.dtype, copy=True)
        if torch.is_floating_point(l) else l,
        local, center)


def _pulled_f32(params):
    """Device float32 snapshot of the float leaves — the ``pulled``
    reference the window delta subtracts from."""
    return tree_map(
        lambda l: (l.detach().to(torch.float32, copy=True)
                   if torch.is_floating_point(l) else None),
        params)


def _window_delta(local, pulled):
    """The committed payload: float32 ``local - pulled`` per float leaf
    (the exact worker-side expression of the DynSGD commit), computed on
    the card and copied to the host in one transfer; zeros elsewhere.
    -> a numpy tree shaped like ``local``."""
    diffs = tree_map(
        lambda l, p: None if p is None else l.to(torch.float32) - p,
        local, pulled)
    floats = [d for d in tree_leaves(diffs) if d is not None]
    flat = (torch.cat([d.reshape(-1) for d in floats]).cpu().numpy()
            if floats else None)
    parts = iter(np.split(flat, np.cumsum([d.numel() for d in floats]))
                 if floats else ())
    return tree_map(
        lambda d: (np.zeros((), np.int32) if d is None
                   else next(parts).reshape(tuple(d.shape))),
        diffs)


def _add_floats(a, b):
    """``a + b`` per float leaf, ``a`` elsewhere — how the error-
    feedback residual folds into the next window's delta (host numpy)."""
    return tree_map(
        lambda x, y: x + y if np.issubdtype(x.dtype, np.floating) else x,
        a, b)


class PSWorkerTrainer(Trainer):
    """One elastic async worker against a center-variable server.

    ``server_addr`` defaults to the launcher-exported ``DK_PS_ADDR``;
    ``communication_window`` to the server's configured window (what
    the join response reports), else ``DK_PS_WINDOW``.  ``worker_id``
    makes the lease sticky across restarts (a supervisor relaunch with
    the same id re-joins in place); None mints a fresh one.
    ``compress`` pins a ``DK_PS_COMPRESS`` spec (``"fp16"``,
    ``"int8"``, ``"int8@0.1"``); None defers to the knob at ``train()``.
    """

    # one process on one card talking HTTP: DK_COORD_WORLD > 1 is its
    # launch environment, not workers across cards
    accepts_coord_world = True

    def __init__(self, keras_model, server_addr=None,
                 communication_window=None, worker_id=None,
                 client=None, compress=None, **kw):
        super().__init__(keras_model, **kw)
        self.server_addr = server_addr
        # malformed specs fail loudly HERE
        self.compress = compress
        if compress is not None:
            _compress.parse_spec(compress)
        if communication_window is not None \
                and int(communication_window) < 1:
            raise ValueError(
                f"communication_window {communication_window!r} must "
                "be >= 1 (a 0-step window would loop forever "
                "committing empty deltas)")
        self.communication_window = (
            None if communication_window is None
            else int(communication_window))
        self.worker_id = worker_id
        self._client = client
        self.commit_log = []  # [(version, staleness, scale)] applied
        self.stale_rejections = 0  # over-cap commits refused typed
        # payload bytes shipped (array bytes, pickle framing excluded):
        # raw = the float32 delta, wire = what actually went out —
        # equal when compression is off, the compression win otherwise
        self.commit_bytes = {"raw": 0, "wire": 0}

    def _make_client(self):
        if self._client is not None:
            return self._client
        return PSClient(self.server_addr)

    @staticmethod
    def _coord_rank():
        """This worker's coordination rank, if the launcher exported
        one — the identity the server's host-drop evidence lapses by."""
        raw = knobs.raw("DK_COORD_RANK")
        try:
            return int(raw) if raw is not None else None
        except ValueError:
            return None

    def train(self, dataset, shuffle=False):
        model, loss_fn, tx = self._resolve()
        client = self._make_client()
        joined = client.join(wid=self.worker_id,
                             rank=self._coord_rank())
        self.worker_id = joined["wid"]
        version = joined["version"]
        W = self.communication_window or int(joined.get("window") or
                                             knobs.get("DK_PS_WINDOW"))
        if W < 1:
            raise ValueError(
                f"communication window must be >= 1, got {W} (check "
                "communication_window= / the server's window / "
                "DK_PS_WINDOW) — a 0-step window would loop forever "
                "committing empty deltas")
        if shuffle:
            dataset = dataset.shuffle(seed=self.seed)
        xb, yb = dataset.batches(
            self.batch_size, self.features_col, self.label_col,
            dtype=self.data_dtype)
        spe = xb.shape[0]  # steps per epoch
        total_t = self.num_epoch * spe
        dev = self.device
        xs, ys = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in (xb, yb))

        step, opt_init = self._make_step(model, loss_fn, tx)
        params = _merge_center(joined["center"],
                               self._device_params(model.params))
        pulled = _pulled_f32(params)
        opt_state = opt_init(params)
        generator = torch.Generator(device=dev).manual_seed(self.seed)

        self.record_training_start()
        history = []
        epoch_losses = []
        t = 0
        # world seam: epoch wall stamps follow the sim clock under a
        # simulator (real time.time otherwise)
        epoch_t0 = _dkworld.time()
        center = joined["center"]
        # delta compression (DK_PS_COMPRESS): the error-feedback
        # residual holds what the codec dropped from the LAST shipped
        # window; it folds into the next delta so compression error
        # never biases convergence, only delays information
        spec = _compress.resolve_spec(self.compress)
        residual = None
        raw_ctr = _metrics.counter("ps.commit_bytes_raw")
        wire_ctr = _metrics.counter("ps.commit_bytes_wire")
        try:
            while t < total_t:
                # windows align to epoch boundaries so per-epoch
                # metrics keep the family contract
                T = min(W, spe - (t % spe), total_t - t)
                with perf.phase("ps_steps"):
                    losses = torch.empty(T, dtype=torch.float32,
                                         device=dev)
                    carry = (params, opt_state, generator)
                    for j in range(T):
                        si = (t + j) % spe
                        carry, loss = step(carry, (xs[si], ys[si]))
                        losses[j] = loss
                    params, opt_state, _ = carry
                    losses = losses.cpu().numpy()
                history.extend(losses.tolist())
                epoch_losses.extend(losses.tolist())
                t += T
                # commit the window; adopt the fresh center either way
                with perf.phase("ps_delta"):
                    delta = _window_delta(params, pulled)
                if spec is not None and residual is not None:
                    delta = _add_floats(delta, residual)
                with perf.phase("ps_encode"):
                    wire = _compress.encode_tree(delta, spec)
                raw_b = _compress.payload_nbytes(delta)
                wire_b = (raw_b if spec is None
                          else _compress.payload_nbytes(wire))
                raw_ctr.inc(raw_b)
                wire_ctr.inc(wire_b)
                self.commit_bytes["raw"] += raw_b
                self.commit_bytes["wire"] += wire_b
                try:
                    with perf.phase("ps_commit"):
                        resp = client.commit(self.worker_id, version,
                                             wire,
                                             rank=self._coord_rank())
                    self.commit_log.append(
                        (resp["version"], resp["staleness"],
                         resp["scale"]))
                    version, center = resp["version"], resp["center"]
                    if spec is not None:
                        residual = _compress.residual_update(delta, wire)
                except StaleCommit:
                    # over the cap: this window's delta is refused —
                    # drop it, re-pull, keep going (bounded damage).
                    # The residual goes with it: error feedback tracks
                    # APPLIED commits only, and re-shipping a refused
                    # window's error would smuggle the capped delta in
                    self.stale_rejections += 1
                    residual = None
                    fresh = client.pull(self.worker_id)
                    version, center = fresh["version"], fresh["center"]
                with perf.phase("ps_merge"):
                    params = _merge_center(center, params)
                    pulled = _pulled_f32(params)
                if t % spe == 0:
                    now = _dkworld.time()
                    self._emit_epoch_end(
                        t // spe, epoch_losses, now - epoch_t0,
                        len(epoch_losses) * self.batch_size)
                    epoch_losses = []
                    epoch_t0 = now
        finally:
            self.record_training_end()
        # the authoritative result is the CENTER, not this worker's
        # local replica (another worker may have committed after us)
        final = client.pull(self.worker_id)
        final_params = _merge_center(final["center"], params)
        return self._finalize(final_params, history)
