"""The port's Switch-MoE layer, MoE transformer and MoE step against the
JAX package's ``parallel/moe.py`` and ``models/transformer.py`` (CPU,
one process; the expert ranks are in ``test_torch_moe_sp_multiprocess.py``).

Weights cross from the JAX package through ``utils/bridge.py``; inputs
come from ``numpy.random.default_rng``.  The JAX side runs its jnp
attention oracle (no Pallas kernel).  Routing is discrete, so every
parity test first asserts that the two packages send each token to the
same expert at the same queue position (a dropped token: position -1),
and only then compares values.

Tolerances (f32): the layer's out and aux 1e-6 and its grads 1e-5 (one
non-zero term per dispatched entry; observed ~5e-8); the transformer's
logits, aux and grads, and params after three sgd steps, 1e-5; remat
1e-6 (the same arithmetic recomputed).  The index dispatch against the
one-hot plain version: the forward bit for bit, the grads rtol 1e-5
(the same math summed in another order; observed ~1e-8).
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dist_keras_tpu.models import transformer as jtr
from dist_keras_tpu.ops.attention import attention as jattention
from dist_keras_tpu.parallel import moe as jmoe
from dist_keras_tpu.utils.serialization import serialize_model
from dist_keras_tpu_torch.models import transformer as ttr
from dist_keras_tpu_torch.ops.optimizers import sgd
from dist_keras_tpu_torch.parallel import moe as tmoe
from dist_keras_tpu_torch.parallel import (
    make_moe_ep_train_step,
    make_moe_train_step,
    make_tp_train_step,
)
from dist_keras_tpu_torch.utils.bridge import params_from_jax, params_to_numpy
from dist_keras_tpu_torch.utils.pytree import tree_leaves
from dist_keras_tpu_torch.utils.serialization import deserialize_model

D, FF, E = 16, 32, 8
CFG = jtr.transformer_config(input_dim=6, seq_len=12, d_model=32, n_heads=2,
                             n_layers=2, n_classes=2, moe_experts=4,
                             moe_capacity_factor=2.0)
CAPACITY_FACTORS = (0.25, 1.25, 8.0)


def _layer(seed=0):
    return jmoe.init_moe_params(jax.random.PRNGKey(seed), D, FF, E)


def _tokens(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _bridge(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _np_leaves(tree):
    """numpy leaves in JAX's order (sorted dict keys) for either side."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        tree = params_to_numpy(tree)
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _jax_route(p, y, capacity):
    """(expert, position or -1 when dropped) of the reference's routing."""
    num_experts = p["router"].shape[1]
    dispatch, _, _ = jmoe._route(p, y, num_experts, capacity)
    d = np.asarray(dispatch)
    probs = jax.nn.softmax((y @ p["router"]).astype(jnp.float32), axis=-1)
    kept = d.sum((1, 2)) > 0
    return (np.asarray(jnp.argmax(probs, axis=-1)),
            np.where(kept, d.sum(1).argmax(-1), -1))


def _torch_route(p, y, capacity):
    expert, pos, keep, _, _, _ = tmoe._route(p, y, p["router"].shape[1],
                                             capacity)
    return expert.numpy(), torch.where(keep, pos, -1).numpy()


def _assert_same_routes(got, want):
    assert len(got) == len(want)
    for (ge, gp), (we, wp) in zip(got, want):
        np.testing.assert_array_equal(ge, we)
        np.testing.assert_array_equal(gp, wp)


def _capacity(n, cf, num_experts):
    return int(math.ceil(n * cf / num_experts))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_routing_matches_the_reference(cf):
    jp, x = _layer(), _tokens(256)
    c = _capacity(256, cf, E)
    _assert_same_routes([_torch_route(_bridge(jp), torch.from_numpy(x), c)],
                        [_jax_route(jp, jnp.asarray(x), c)])


@pytest.mark.parametrize("impl", ["index", "one_hot"])
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_switch_moe_dense_matches_the_reference(cf, impl):
    jp, x = _layer(1), _tokens(256, seed=1)
    fn = (tmoe.switch_moe_dense if impl == "index"
          else tmoe.switch_moe_dense_reference)
    c = _capacity(256, cf, E)
    _assert_same_routes([_torch_route(_bridge(jp), torch.from_numpy(x), c)],
                        [_jax_route(jp, jnp.asarray(x), c)])
    want, waux = jmoe.switch_moe_dense(jp, jnp.asarray(x),
                                       capacity_factor=cf)
    got, aux = fn(_bridge(jp), torch.from_numpy(x), capacity_factor=cf)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(waux), atol=1e-6)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_switch_moe_grads_match_the_reference(cf):
    """Grads of sum(out^2) + aux w.r.t. x and every leaf (the router's
    through the gate and the aux)."""
    jp, x = _layer(2), _tokens(128, seed=2)

    def jloss(p, xv):
        out, aux = jmoe.switch_moe_dense(p, xv, capacity_factor=cf)
        return jnp.sum(out ** 2) + aux

    wp, wx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in _bridge(jp).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.switch_moe_dense(tp, tx, capacity_factor=cf)
    (torch.sum(out ** 2) + aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(wx), atol=1e-5)
    for k in jp:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(wp[k]),
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_index_dispatch_is_the_one_hot_plain_version(cf):
    """The forward bit for bit (f32 and bf16); the grads the same math
    (the gate's and the bias's sums run in another order)."""
    p = _bridge(_layer(3))
    x = torch.from_numpy(_tokens(200, seed=3))
    results = []
    for fn in (tmoe.switch_moe_dense, tmoe.switch_moe_dense_reference):
        q = {k: v.clone().requires_grad_() for k, v in p.items()}
        xv = x.clone().requires_grad_()
        out, aux = fn(q, xv, capacity_factor=cf)
        (torch.sum(out ** 3) + aux).backward()
        results.append([out, aux, xv.grad] + [q[k].grad for k in sorted(q)])
    (out, aux, *grads), (wout, waux, *wgrads) = results
    assert torch.equal(out, wout) and torch.equal(aux, waux)
    for a, b in zip(grads, wgrads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    bf16 = [fn({k: v.bfloat16() for k, v in p.items()}, x.bfloat16(),
               capacity_factor=cf)[0]
            for fn in (tmoe.switch_moe_dense,
                       tmoe.switch_moe_dense_reference)]
    assert bf16[0].dtype == torch.bfloat16
    assert torch.equal(*bf16)


def test_capacity_drops_tokens():
    """As ``test_capacity_drops_tokens``: a dropped token's output is
    exactly zero; capacity ceil(64 * 0.25 / 8) = 2 slots an expert."""
    p = _bridge(_layer())
    x = torch.from_numpy(_tokens(64, seed=3))
    out, _ = tmoe.switch_moe_dense(p, x, capacity_factor=0.25)
    rows = (out.abs().sum(-1) > 1e-9).numpy()
    _, pos, keep, _, _, _ = tmoe._route(p, x, E, 2)
    assert rows.sum() <= 16
    np.testing.assert_array_equal(rows, keep.numpy())
    want, _ = jmoe.switch_moe_dense(_layer(), jnp.asarray(x.numpy()),
                                    capacity_factor=0.25)
    np.testing.assert_array_equal(
        rows, np.abs(np.asarray(want)).sum(-1) > 1e-9)
    ample, _ = tmoe.switch_moe_dense(p, x, capacity_factor=8.0)
    assert int((ample.abs().sum(-1) > 1e-9).sum()) == 64


def test_aux_loss_prefers_balance():
    """A uniform router gives aux ~ 1 (its minimum); a collapsed one
    (every token to expert 0) aux ~ E."""
    p = _bridge(_layer())
    x = torch.from_numpy(_tokens(256, seed=2))
    _, aux_u = tmoe.switch_moe_dense(dict(p, router=torch.zeros(D, E)), x)
    assert abs(float(aux_u) - 1.0) < 0.2
    collapsed = torch.full((D, E), -10.0)
    collapsed[:, 0] = 10.0
    _, aux_c = tmoe.switch_moe_dense(dict(p, router=collapsed),
                                     x.abs() + 0.5)
    assert float(aux_c) > 4.0


def test_int32_queue_positions_are_exact():
    """Every token to one expert: positions 0..N-1 in order, exact."""
    p = _bridge(_layer())
    p["router"] = torch.zeros(D, E)
    p["router"][:, 5] = 1.0
    x = torch.from_numpy(np.abs(_tokens(3000)) + 0.1)
    expert, pos, keep, _, _, _ = tmoe._route(p, x, E, 100)
    assert pos.dtype == torch.int32
    assert (expert == 5).all()
    np.testing.assert_array_equal(pos.numpy(), np.arange(3000))
    assert int(keep.sum()) == 100


def test_param_specs_match_the_reference():
    jp = jtr.init_transformer_params(jax.random.PRNGKey(0), CFG)
    want = [s == jax.sharding.PartitionSpec(jmoe.EXPERT_AXIS) for s in
            jax.tree.leaves(jmoe.moe_transformer_param_specs(jp),
                            is_leaf=lambda s: isinstance(
                                s, jax.sharding.PartitionSpec))]
    specs = tmoe.moe_transformer_param_specs(_bridge(jp))
    got = [s == tmoe.EXPERT_AXIS for s in jax.tree.leaves(
        specs, is_leaf=lambda s: s is None or isinstance(s, str))]
    assert got == want and sum(got) == 4 * CFG["n_layers"]
    assert tmoe.moe_param_specs() == {k: None if k == "router"
                                      else "experts" for k in
                                      ("router", "w1", "b1", "w2", "b2")}


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------
def _data(n=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, CFG["seq_len"], CFG["input_dim"]))
    return x.astype(np.float32), rng.integers(0, CFG["n_classes"], n)


def _jax_params(seed=0):
    return jtr.init_transformer_params(jax.random.PRNGKey(seed), CFG)


def _jax_layer_routes(params, x, causal):
    """Every MoE layer's routing in the reference's forward (eager)."""
    routes = []
    cf = CFG["moe_capacity_factor"]

    def moe_fn(p, y):
        routes.append(_jax_route(p, y, _capacity(y.shape[0], cf,
                                                 p["router"].shape[1])))
        return jmoe.switch_moe_dense(p, y, capacity_factor=cf)

    h = jnp.asarray(x) @ params["proj"] + params["pos"][None, :x.shape[1]]
    for blk in params["blocks"]:
        h, _ = jtr.apply_block_aux(blk, h, jattention, causal, moe_fn=moe_fn)
    return routes


@pytest.fixture
def torch_routes(monkeypatch):
    """Records every MoE layer's routing the port computes."""
    routes = []
    route = tmoe._route

    def recording(p, y, num_experts, capacity):
        out = route(p, y, num_experts, capacity)
        routes.append((out[0].numpy().copy(),
                       torch.where(out[2], out[1], -1).numpy().copy()))
        return out

    monkeypatch.setattr(tmoe, "_route", recording)
    return routes


def _jax_objective(p, x, y, causal=False):
    logits, aux = jtr.transformer_apply_with_aux(
        p, x, CFG, causal=causal, attn_fn=jattention)
    logp = jax.nn.log_softmax(logits)
    nll = -jnp.take_along_axis(logp, y[:, None], axis=-1).mean()
    return nll + 1e-2 * aux, (logits, aux)


@pytest.mark.parametrize("causal", [False, True])
def test_transformer_logits_aux_and_grads_match_the_reference(
        causal, torch_routes):
    jp = _jax_params()
    x, y = _data()
    (_, (wlogits, waux)), wgrads = jax.value_and_grad(
        _jax_objective, has_aux=True)(jp, jnp.asarray(x), jnp.asarray(y),
                                      causal)
    params = _bridge(jp)
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    logits, aux = ttr.transformer_apply_with_aux(params, torch.from_numpy(x),
                                                 CFG, causal=causal)
    _assert_same_routes(torch_routes, _jax_layer_routes(jp, x, causal))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, torch.from_numpy(y)[:, None]).mean()
    grads = torch.autograd.grad(nll + 1e-2 * aux, leaves)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(wlogits),
                               atol=1e-5)
    np.testing.assert_allclose(float(aux.detach()), float(waux), atol=1e-5)
    got = _reorder(params, grads)
    want = _np_leaves(wgrads)
    assert len(got) == len(want) == 6 + 13 * CFG["n_layers"]
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-5)


def _reorder(params, grads):
    """The port's grads (its tree order) -> numpy in JAX's leaf order."""
    from dist_keras_tpu_torch.utils.pytree import tree_unflatten

    tree = params_to_numpy(tree_unflatten(
        params, [g.detach() for g in grads]))
    return jax.tree.leaves(tree)


def test_three_sgd_steps_of_the_moe_step_match_the_reference(torch_routes):
    jp = _jax_params(seed=1)
    x, y = _data(seed=1)
    init_fn, jstep = jmoe.make_moe_train_step(
        CFG, optimizer=optax.sgd(0.1), aux_weight=1e-2, causal=True,
        attn_fn=jattention)
    jopt = optax.sgd(0.1).init(jp)
    _, step = make_moe_train_step(CFG, optimizer=sgd(0.1), aux_weight=1e-2,
                                  causal=True, device="cpu")
    params = _bridge(jp)
    opt = sgd(0.1).init(params)
    for _ in range(3):
        want_routes = _jax_layer_routes(jp, x, True)
        del torch_routes[:]
        params, opt, m = step(params, opt, x, y)
        _assert_same_routes(torch_routes, want_routes)
        jp, jopt, jm = jstep(jp, jopt, jnp.asarray(x), jnp.asarray(y))
        for k in ("loss", "nll", "aux"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=1e-5,
                                       err_msg=k)
    for a, b in zip(_np_leaves(params), _np_leaves(jp)):
        np.testing.assert_allclose(a, b, atol=1e-5)
    assert all(t.dtype == torch.float32 for t in tree_leaves(params))


def test_transformer_apply_refuses_moe_configs():
    params = _bridge(_jax_params())
    x, _ = _data()
    with pytest.raises(ValueError, match="aux"):
        ttr.transformer_apply(params, torch.from_numpy(x), CFG)
    with pytest.raises(ValueError, match="aux"):
        jtr.transformer_apply(_jax_params(), jnp.asarray(x), CFG)


def test_remat_gives_the_same_grads():
    params = _bridge(_jax_params())
    x, y = _data(n=4)
    out = []
    for remat in (False, True):
        leaves = [t.clone().requires_grad_() for t in tree_leaves(params)]
        from dist_keras_tpu_torch.utils.pytree import tree_unflatten

        p = tree_unflatten(params, leaves)
        logits, aux = ttr.transformer_apply_with_aux(
            p, torch.from_numpy(x), CFG, causal=True, remat=remat)
        loss = torch.nn.functional.cross_entropy(
            logits, torch.from_numpy(y)) + 1e-2 * aux
        out.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*out):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_the_module_forward_drops_aux_and_matches_the_reference():
    jp = _jax_params()
    x, _ = _data()
    model = ttr.Transformer(CFG, params=jax.tree.map(np.asarray, jp),
                            device="cpu")
    got = model(torch.from_numpy(x))
    want = jtr.Transformer(cfg=CFG)
    want.set_params(jp)
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want(x)), atol=1e-5)


def test_the_moe_tree_crosses_the_bridge_bit_for_bit():
    jp = _jax_params()
    tp = _bridge(jp)
    assert sorted(tp["blocks"][0]) == sorted(jp["blocks"][0])
    assert sorted(tp["blocks"][0]["moe"]) == ["b1", "b2", "router", "w1",
                                              "w2"]
    for a, b in zip(_np_leaves(tp), _np_leaves(jp)):
        np.testing.assert_array_equal(a, b)
    init_fn, _ = make_moe_train_step(CFG, device="cpu")
    ours, opt = init_fn(0)
    assert [a.shape for a in _np_leaves(ours)] == \
        [b.shape for b in _np_leaves(jp)]
    assert int(opt["count"]) == 0


def test_ep_step_at_one_rank_is_the_moe_step():
    """World 1: the exchange is the identity and no torch.distributed
    call is made; the EP step is make_moe_train_step's math."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    jp = _jax_params(seed=2)
    x, y = _data(seed=2)
    _, one = make_moe_train_step(CFG, optimizer=sgd(0.1), causal=True,
                                 device="cpu")
    factory, init_fn = make_moe_ep_train_step(CFG, optimizer=sgd(0.1),
                                              causal=True, device="cpu")
    a = b = _bridge(jp)
    oa = ob = {}
    ep = factory(b, ob)
    for _ in range(2):
        a, oa, ma = one(a, oa, x, y)
        b, ob, mb = ep(b, ob, x, y)
        for k in ("loss", "nll", "aux"):
            np.testing.assert_allclose(float(ma[k]), float(mb[k]),
                                       atol=1e-6)
    for u, v in zip(tree_leaves(a), tree_leaves(b)):
        np.testing.assert_allclose(u.numpy(), v.numpy(), atol=1e-6)
    full, _ = init_fn(0)
    assert full["blocks"][0]["moe"]["w1"].shape[0] == CFG["moe_experts"]
    assert tmoe.gather_moe_params(full) is full
    assert not dist.is_initialized()


def test_the_dense_step_refuses_moe_and_points_to_the_moe_steps():
    with pytest.raises(ValueError, match="make_moe_train_step"):
        make_tp_train_step(CFG, device="cpu")
    with pytest.raises(ValueError, match="moe_experts"):
        make_moe_train_step(dict(CFG, moe_experts=0), device="cpu")


def test_moe_training_reduces_nll():
    """As ``test_moe_transformer_trains``: the Switch objective trains."""
    cfg = dict(CFG, input_dim=8, seq_len=16)
    init_fn, step = make_moe_train_step(cfg, aux_weight=1e-2, device="cpu")
    params, opt = init_fn(0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(32, 16, 8)).astype(np.float32)
    y = (x[:, :, 0].mean(1) > 0).astype(np.int64)
    first = None
    for _ in range(40):
        params, opt, m = step(params, opt, x, y)
        first = float(m["nll"]) if first is None else first
    assert float(m["nll"]) < first * 0.5
    assert np.isfinite(float(m["aux"]))


# ---------------------------------------------------------------------------
# serialization and the decode engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("moe", [0, 4])
def test_a_reference_transformer_deserializes_into_the_port(moe):
    cfg = dict(CFG, moe_experts=moe)
    jm = jtr.Transformer(cfg=cfg, seed=3)
    d = serialize_model(jm)
    model = deserialize_model(d, device="cpu")
    assert isinstance(model, ttr.Transformer)
    assert json.loads(model.to_json()) == json.loads(jm.to_json())
    assert model.count_params == jm.count_params
    for a, b in zip(model.get_weights(), d["weights"]):
        np.testing.assert_array_equal(a, b)
    x, _ = _data()
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm(x)), atol=1e-5)


def test_set_weights_checks_count_and_shape():
    model = ttr.Transformer(CFG, device="cpu")
    w = model.get_weights()
    model.set_weights([v + 1 for v in w])
    for a, b in zip(model.get_weights(), w):
        np.testing.assert_array_equal(a, b + 1)
    with pytest.raises(ValueError, match="weights"):
        model.set_weights(w[:-1])
    with pytest.raises(ValueError, match="shape"):
        model.set_weights([np.zeros((1, 1), np.float32)] + w[1:])


def test_decode_engine_refuses_moe_configs():
    from dist_keras_tpu_torch.serving import DecodeEngine

    cfg = dict(CFG, input_dim=8, n_classes=8)
    with pytest.raises(ValueError, match="MoE configs are not decodable"):
        DecodeEngine(ttr.Transformer(cfg, device="cpu"), prefill_ladder=(4,),
                     decode_ladder=(1,), device="cpu")
