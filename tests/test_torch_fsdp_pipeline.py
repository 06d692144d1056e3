"""FSDP, the pipeline and the TP step's specs in one process (CPU),
against the JAX package on the same numpy inputs.

- The spec rules leaf for leaf: ``fsdp_specs`` (axis sizes 2, 4, 8),
  ``match_specs_for_state`` (adam and sgd-momentum states),
  ``param_specs`` and ``tp_step_specs``; ``stack_blocks_interleaved``'s
  order; ``bubble_fraction`` and ``interleaved_1f1b_stash_entries``.
- The schedules: every rank's 1F1B and interleaved orders run each
  (chunk, microbatch) forward once before its backward, the canonical
  1F1B stash stays within ``min(M, P - s)``.
- Every entry point on a mesh of one rank: the TP step and FSDP are the
  one-card step bit for bit; GPipe is the per-microbatch forward bit for
  bit; 1F1B (flat and interleaved) and ``make_pp_train_step`` match JAX
  at 1e-5 (``test_pipeline.py``'s configuration, f32).  Across ranks
  they are held to the JAX package in
  ``test_torch_tp_fsdp_pp_multiprocess.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from dist_keras_tpu.models import transformer as jtr
from dist_keras_tpu.parallel import fsdp as jfsdp
from dist_keras_tpu.parallel import pipeline as jpp
from dist_keras_tpu.parallel import transformer_tp as jtp
from dist_keras_tpu_torch.models.transformer import (
    transformer_apply_with_aux,
)
from dist_keras_tpu_torch.ops.attention import attention
from dist_keras_tpu_torch.ops.optimizers import adam, sgd
from dist_keras_tpu_torch.parallel import fsdp, mesh, pipeline as pp
from dist_keras_tpu_torch.parallel import transformer_tp as ttp
from dist_keras_tpu_torch.utils.bridge import params_from_jax, params_to_numpy
from dist_keras_tpu_torch.utils.pytree import tree_leaves, tree_map

CFG = jtr.transformer_config(input_dim=6, seq_len=8, d_model=16, n_heads=2,
                             n_layers=8, n_classes=3)
MOE_CFG = jtr.transformer_config(input_dim=6, seq_len=8, d_model=16,
                                 n_heads=2, n_layers=4, n_classes=3,
                                 moe_experts=4, moe_capacity_factor=2.0)
FSDP_CFG = jtr.transformer_config(input_dim=8, seq_len=16, d_model=64,
                                  n_heads=4, n_layers=2, n_classes=2)
TOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jparams(cfg=CFG, seed=0):
    return _np(jtr.init_transformer_params(jax.random.PRNGKey(seed), cfg))


def _data(n=8, cfg=CFG, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, cfg["seq_len"], cfg["input_dim"]))
    return (x.astype(np.float32),
            rng.integers(0, cfg["n_classes"], n).astype(np.int32))


def _spec_leaves(tree):
    """A spec tree's leaves as tuples, dict keys sorted (JAX's order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, (mesh.PartitionSpec, JP)):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tuple(tree)]


def _jspec_leaves(tree):
    return [tuple(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda s: isinstance(s, JP))]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_specs_match_jax(n):
    p = _jparams(FSDP_CFG)
    got = fsdp.fsdp_specs(params_from_jax(p, "cpu"), n)
    want = jfsdp.fsdp_specs(p, n)
    assert _spec_leaves(got) == _jspec_leaves(want)
    assert any(s for s in _spec_leaves(got)) and not all(
        s and any(s) for s in _spec_leaves(got))


@pytest.mark.parametrize("opt", ["adam", "sgd_momentum"])
def test_match_specs_for_state_matches_jax(opt):
    p = _jparams(FSDP_CFG)
    tp = params_from_jax(p, "cpu")
    jtx, ttx = {"adam": (optax.adam(1e-3), adam(1e-3)),
                "sgd_momentum": (optax.sgd(0.1, momentum=0.9),
                                 sgd(0.1, momentum=0.9))}[opt]
    for n in (2, 4):
        got = fsdp.match_specs_for_state(tp, fsdp.fsdp_specs(tp, n),
                                         ttx.init(tp))
        want = jfsdp.match_specs_for_state(p, jfsdp.fsdp_specs(p, n),
                                           jtx.init(p))
        assert _spec_leaves(got) == _jspec_leaves(want)
    with pytest.warns(DeprecationWarning):
        fsdp.match_specs_by_shape(tp, fsdp.fsdp_specs(tp, 2), ttx.init(tp))


@pytest.mark.parametrize("opt", ["adam", "sgd_momentum"])
def test_tp_step_specs_match_jax(opt):
    p = _jparams(CFG)
    tp = params_from_jax(p, "cpu")
    jtx, ttx = {"adam": (optax.adam(1e-3), adam(1e-3)),
                "sgd_momentum": (optax.sgd(0.1, momentum=0.9),
                                 sgd(0.1, momentum=0.9))}[opt]
    got = ttp.tp_step_specs(tp, ttx.init(tp))
    want = jtp.tp_step_specs(p, jtx.init(p))
    assert _spec_leaves(got[0]) == _jspec_leaves(jtp.param_specs(p))
    assert _spec_leaves(ttp.param_specs(tp)) == _jspec_leaves(want[0])
    assert _spec_leaves(got[1]) == _jspec_leaves(want[1])
    assert tuple(got[2]) == tuple(want[2]) and tuple(got[3]) == tuple(
        want[3])


def test_partition_specs_compare_and_pickle_as_tuples():
    import pickle

    s = mesh.P(None, "model", None)
    assert s == tuple(JP(None, "model", None)) and s.dim("model") == 1
    assert pickle.loads(pickle.dumps(s)) == s
    assert isinstance(pickle.loads(pickle.dumps(s)), mesh.PartitionSpec)
    assert mesh.replicated() == mesh.P() and mesh.P().dim("model") is None
    assert mesh.batch_sharded(ndim=3) == mesh.P("workers", None, None)
    assert mesh.num_available_devices() == (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)


@pytest.mark.parametrize("p,v", [(2, 2), (4, 2), (2, 4)])
def test_stack_blocks_interleaved_matches_jax(p, v):
    params = _jparams(CFG)
    got = pp.stack_blocks_interleaved(
        params_from_jax(params, "cpu")["blocks"], p, v)
    want = jpp.stack_blocks_interleaved(params["blocks"], p, v)
    for a, b in zip(jax.tree.leaves(params_to_numpy(got)),
                    jax.tree.leaves(_np(want))):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        pp.stack_blocks_interleaved(
            params_from_jax(params, "cpu")["blocks"], 3, 2)


@pytest.mark.parametrize("p,m,v", [(2, 4, 1), (4, 8, 2), (4, 3, 1),
                                   (8, 16, 4)])
def test_bubble_and_stash_bounds_match_jax(p, m, v):
    assert pp.bubble_fraction(p, m, v) == jpp.bubble_fraction(p, m, v)
    assert (pp.interleaved_1f1b_stash_entries(p, v, m)
            == jpp.interleaved_1f1b_stash_entries(p, v, m))


def _live_peak(order):
    live, peak = set(), 0
    for kind, c, mi in order:
        if kind == "F":
            assert (c, mi) not in live
            live.add((c, mi))
            peak = max(peak, len(live))
        else:
            live.remove((c, mi))
    assert not live
    return peak


@pytest.mark.parametrize("p,m", [(2, 4), (4, 8), (4, 2), (3, 7)])
def test_1f1b_order_is_canonical(p, m):
    for s in range(p):
        order = pp._1f1b_order(p, s, m)
        assert sorted(order) == sorted(
            [(k, 0, i) for k in "FB" for i in range(m)])
        assert _live_peak(order) == min(m, p - s) <= min(m, 2 * p - 1)
        assert [mi for k, _, mi in order if k == "B"] == list(range(m))


@pytest.mark.parametrize("p,m,v", [(2, 4, 2), (4, 8, 2), (2, 2, 4)])
def test_interleaved_order_stays_within_the_jax_stash(p, m, v):
    for s in range(p):
        order = pp._interleaved_order(p, s, m, v)
        assert len(order) == 2 * m * v
        assert _live_peak(order) <= pp.interleaved_1f1b_stash_entries(
            p, v, m)


def _one_stage():
    return pp.make_pp_mesh(1)


def test_a_one_rank_fsdp_step_is_the_one_card_step_bit_for_bit():
    params = _jparams(FSDP_CFG)
    x, y = _data(8, FSDP_CFG)
    m1 = mesh.grid_mesh({"workers": 1})
    assert m1.shape == {"workers": 1} and m1.workers.size == 1

    def apply_fn(p, xb):
        return transformer_apply_with_aux(p, xb, FSDP_CFG,
                                          attn_fn=attention)[0]

    def loss_fn(logits, yb):
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(1, yb.long()[:, None]).mean()

    tx = adam(1e-3)
    init_fn, factory = fsdp.make_fsdp_train_step(m1, loss_fn, apply_fn,
                                                 optimizer=tx, device="cpu")
    sp, so = init_fn(params)
    got, _, loss = factory(sp, so)(sp, so, x, y)
    tp = params_from_jax(params, "cpu")
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    ref = loss_fn(apply_fn(tp, torch.from_numpy(x)), torch.from_numpy(y))
    ref.backward()
    grads = tree_map(lambda t: t.grad, tp)
    upd, _ = tx.update(grads, tx.init(tp), tp)
    want = tree_map(lambda a, u: a.detach() + u, tp, upd)
    assert torch.equal(loss, ref.detach())
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)
    assert fsdp.persistent_bytes(sp, so) == 3 * sum(
        t.numel() * 4 for t in leaves) + 4
    _, losses = fsdp.train_fsdp(m1, apply_fn, loss_fn, params, x, y,
                                steps=2, device="cpu")
    assert losses[0] == float(loss) and losses[1] < losses[0]


def test_place_by_specs_cuts_each_named_dim():
    x = np.arange(24).reshape(4, 6)
    m1 = mesh.grid_mesh({"workers": 1})
    assert fsdp.place_by_specs(m1, x, mesh.P("workers", None)) is x
    t = torch.arange(24.0).reshape(4, 6)
    tree = {"a": t, "b": [t]}
    got = fsdp.place_by_specs(m1, tree, {"a": mesh.P(), "b": [mesh.P(
        None, "workers")]})
    assert torch.equal(got["b"][0], t)


def test_one_stage_gpipe_is_the_microbatched_forward_bit_for_bit():
    for cfg, seed in ((CFG, 0), (MOE_CFG, 1)):
        params = params_from_jax(_jparams(cfg, seed), "cpu")
        rest = {k: v for k, v in params.items() if k != "blocks"}
        x = torch.from_numpy(_data(8, cfg)[0])
        moe = bool(cfg["moe_experts"])
        out = pp.pp_transformer_apply(
            rest, pp.stack_blocks(params["blocks"]), x, cfg, 4, causal=True,
            axis=_one_stage(), attn_fn=attention, with_aux=True)
        per_mb = [transformer_apply_with_aux(params, xm, cfg, causal=True,
                                             attn_fn=attention)
                  for xm in x.chunk(4)]
        want_aux = torch.stack([a for _, a in per_mb]).mean()
        assert torch.allclose(out[0], torch.cat([lg for lg, _ in per_mb]),
                              atol=1e-6, rtol=0)
        assert torch.allclose(out[1], want_aux, atol=1e-7, rtol=0)
        if moe:
            with pytest.raises(ValueError, match="with_aux"):
                pp.pp_transformer_apply(rest, pp.stack_blocks(
                    params["blocks"]), x, cfg, 4, axis=_one_stage())


def test_one_stage_gpipe_matches_sequential_stages():
    """A generic stage (tanh of a product) on one stage, and its
    interleaved form with the 4 layers as 4 chunks, equal the layers
    applied in order."""
    rng = np.random.default_rng(0)
    ws = torch.from_numpy(rng.normal(size=(4, 8, 8)).astype(np.float32)
                          * 0.3)
    x = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    want = x
    for w in ws:
        want = torch.tanh(want @ w)
    seq = pp.gpipe_apply(lambda w, h: torch.tanh(torch.tanh(torch.tanh(
        torch.tanh(h @ w[0]) @ w[1]) @ w[2]) @ w[3]), ws, x, 8,
        axis=_one_stage())
    inter = pp.interleaved_gpipe_apply(lambda w, h: torch.tanh(h @ w), ws,
                                       x, 4, 4, axis=_one_stage())
    assert torch.equal(seq, want) and torch.equal(inter, want)


def _jax_1f1b(params, x, y, cfg, v):
    rest = {k: t for k, t in params.items() if k != "blocks"}
    stacked = (jax.tree.map(lambda a: a[0], jpp.stack_blocks_interleaved(
        params["blocks"], 1, v)) if v > 1
        else jpp.stack_blocks(params["blocks"]))
    from jax.sharding import Mesh

    from dist_keras_tpu.utils.jax_compat import shard_map

    def run(r, b, xb, yb):
        loss, aux, rg, bg = jpp.pp_transformer_1f1b_grads(
            r, b, xb, yb, cfg, num_microbatches=4, causal=True, virtual=v)
        return loss, aux, rg, jax.tree.map(lambda g: g[None], bg)

    fn = shard_map(run, mesh=Mesh(np.array(jax.devices()[:1]),
                                  (jpp.PIPE_AXIS,)),
                   in_specs=(JP(), JP(), JP(), JP()),
                   out_specs=(JP(), JP(), JP(), JP(jpp.PIPE_AXIS)))
    loss, aux, rg, bg = jax.jit(fn)(rest, stacked, x, y)
    return _np((loss, aux, rg, jax.tree.map(lambda g: g[0], bg)))


@pytest.mark.parametrize("cfg,v", [(CFG, 1), (CFG, 2), (MOE_CFG, 1)],
                         ids=["dense", "interleaved", "moe"])
def test_one_stage_1f1b_matches_jax(cfg, v):
    jp = _jparams(cfg, int(bool(cfg["moe_experts"])))
    x, y = _data(8, cfg)
    want = _jax_1f1b(jp, jnp.asarray(x), jnp.asarray(y), cfg, v)
    params = params_from_jax(jp, "cpu")
    rest = {k: t for k, t in params.items() if k != "blocks"}
    blocks = (pp.split_stage_blocks(pp.stack_blocks_interleaved(
        params["blocks"], 1, v), _one_stage(), v) if v > 1
        else pp.stack_blocks(params["blocks"]))
    loss, aux, rg, bg = pp.pp_transformer_1f1b_grads(
        rest, blocks, torch.from_numpy(x), torch.from_numpy(y), cfg, 4,
        causal=True, axis=_one_stage(), virtual=v)
    np.testing.assert_allclose(float(loss), want[0], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(aux), want[1], atol=TOL, rtol=TOL)
    for a, b in zip(jax.tree.leaves(params_to_numpy((rg, bg))),
                    jax.tree.leaves(want[2:])):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL)
    assert pp.stash_peak() == v


def test_one_stage_pp_train_step_matches_jax():
    jp = _jparams(CFG)
    x, y = _data(8, CFG)
    mesh1 = jpp.make_pp_mesh(stages=1)
    jf, _ = jpp.make_pp_train_step(mesh1, CFG, 4, optimizer=optax.sgd(0.1),
                                   causal=True)
    rest = {k: t for k, t in jp.items() if k != "blocks"}
    blocks = jpp.stack_blocks(jp["blocks"])
    tx = optax.sgd(0.1)
    jr, jb, *_, jloss, _ = jf(rest, blocks, tx.init(rest), tx.init(blocks))(
        rest, blocks, tx.init(rest), tx.init(blocks), jnp.asarray(x),
        jnp.asarray(y))
    factory, init_fn = pp.make_pp_train_step(_one_stage(), CFG, 4,
                                             optimizer=sgd(0.1), causal=True,
                                             device="cpu")
    params = params_from_jax(jp, "cpu")
    r = {k: t for k, t in params.items() if k != "blocks"}
    b = pp.split_stage_blocks(pp.stack_blocks(params["blocks"]),
                              _one_stage())
    r2, b2, _, _, loss, aux = factory(r, b, {}, {})(r, b, {}, {}, x, y)
    np.testing.assert_allclose(float(loss), float(jloss), atol=TOL)
    assert float(aux) == 0.0
    for a, w in zip(jax.tree.leaves(params_to_numpy((r2, b2))),
                    jax.tree.leaves(_np((jr, jb)))):
        np.testing.assert_allclose(a, w, atol=TOL, rtol=TOL)
    specs = factory.specs(r, b, {}, {})
    assert specs[4] == mesh.P(None)
    assert all(s == mesh.P("stages") for s in _spec_leaves(specs[1]))
    (_, blocks_out), losses = pp.train_pp_transformer(
        _one_stage(), CFG, x, y, 4, steps=2, optimizer=sgd(0.1), causal=True,
        device="cpu")
    assert losses[1] < losses[0] and tree_leaves(blocks_out)[0].shape[0] == 8
    assert init_fn(0)[1]["wq"].shape == (8, 16, 2, 8)
