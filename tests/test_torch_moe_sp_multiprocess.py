"""Expert parallelism, ring attention and the sequence-parallel step of the
port across processes, against the JAX package under ``shard_map`` on
``conftest.py``'s virtual CPU devices.

Each rank is a fresh ``python`` subprocess that imports only the port
(no jax, as on the card's host) and brings up a gloo ``torch.distributed``
group through a ``file://`` rendezvous under ``tmp_path``; its results
come back as a pickle of numpy trees.  There are two launches, of 2 and
of 4 ranks, each running every task once:

- ``switch_moe_ep`` (D=16, FF=32, E=8, 32 tokens a rank, capacity
  factors 1.25 and 8.0) against JAX ``switch_moe_ep`` on a mesh of as
  many devices: each rank's routing equal first, then ``out`` within
  1e-6 and the grads of mean(sum(out^2) + aux) through both exchanges
  within 1e-5 (x, every expert leaf on its owner, the router summed
  across the ranks);
- ``make_moe_ep_train_step`` (``test_moe.py``'s EP config with
  capacity factor 1.25, batch 8, sgd 0.1): each step's routing on each
  rank equal first, then loss, nll and aux of 3 steps and the gathered
  params after them within 1e-5; the ranks' replicated leaves bit-equal;
- ``ring_attention`` causal and not (``test_attention.py``'s shapes):
  each rank's block within atol 2e-5, rtol 1e-4 of JAX
  ``ring_attention``, the grads of sum(out^2) within atol 2e-4, rtol
  1e-3; the same over subgroups (pairs of ranks, each a ``seq`` axis
  running the whole sequence) against JAX's 2-device ring;
- ``make_tp_train_step(mesh=make_tp_mesh(sp=n))`` against JAX
  ``make_tp_train_step(make_tp_mesh(sp=n))``, f32, causal: the loss and
  every grad within 1e-5, the params after 3 sgd steps within 1e-5;
  ``make_tp_mesh(dp=2)`` / ``(tp=2)`` building ``(2, 1, n/2)`` /
  ``(1, 2, n/2)`` and refusing an ``sp`` whose product is not the
  group's size.

Every launch has its own ``communicate(timeout=...)`` and its group a
timeout (``DK_COORD_TIMEOUT_S``).
"""

import json
import math
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from dist_keras_tpu.models import transformer as jtr
from dist_keras_tpu.ops.attention import attention as jattention
from dist_keras_tpu.ops.attention import ring_attention as jring
from dist_keras_tpu.parallel import moe as jmoe
from dist_keras_tpu.parallel.mesh import SEQ_AXIS
from dist_keras_tpu.parallel.transformer_tp import (
    make_tp_mesh as jmake_tp_mesh,
    make_tp_train_step as jmake_tp_train_step,
)
from dist_keras_tpu.utils.jax_compat import shard_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 120     # each launch's communicate()
GROUP_TIMEOUT_S = "60"     # each group's DK_COORD_TIMEOUT_S

D, FF, E, TOKENS = 16, 32, 8, 32          # the layer; tokens a rank
LAYER_CFS = (1.25, 8.0)
EP_CFG = jtr.transformer_config(input_dim=6, seq_len=12, d_model=32,
                                n_heads=2, n_layers=2, n_classes=2,
                                moe_experts=8, moe_capacity_factor=1.25)
EP_BATCH, STEPS = 8, 3
SP_CFG = jtr.transformer_config(input_dim=6, seq_len=16, d_model=16,
                                n_heads=4, n_layers=2, d_ff=32, n_classes=3)
SP_BATCH = 8
QKV = dict(b=2, t=32, h=4, d=8)

_RANK = r'''
import json, os, pickle, sys
rank, world, job = int(sys.argv[1]), int(sys.argv[2]), json.loads(sys.argv[3])
os.environ["DK_COORD_TIMEOUT_S"] = job["timeout"]
os.environ["JAX_COORDINATOR_ADDRESS"] = "file://" + job["rdv"]
os.environ["JAX_NUM_PROCESSES"] = str(world)
os.environ["JAX_PROCESS_ID"] = str(rank)
sys.path.insert(0, job["repo"])
import numpy as np
import torch
torch.set_num_threads(1)
from dist_keras_tpu_torch import comm
from dist_keras_tpu_torch.ops.attention import ring_attention
from dist_keras_tpu_torch.ops.optimizers import sgd
from dist_keras_tpu_torch.parallel import collectives, mesh as tmesh
from dist_keras_tpu_torch.parallel import moe as tmoe
from dist_keras_tpu_torch.parallel.transformer_tp import (
    loss_and_grads, local_block, make_tp_train_step)
from dist_keras_tpu_torch.utils.bridge import params_from_jax, params_to_numpy
from dist_keras_tpu_torch.utils.pytree import tree_leaves, tree_unflatten
comm.initialize(device="cpu")
assert "jax" not in sys.modules and "dist_keras_tpu" not in sys.modules
with open(job["inputs"], "rb") as f:
    inp = pickle.load(f)
axis = tmesh.rank_axis("experts")
assert (axis.size, axis.index) == (world, rank)
res = {}
routes = []
_route = tmoe._route

def recording(p, y, num_experts, capacity):
    out = _route(p, y, num_experts, capacity)
    routes.append((out[0].numpy().copy(),
                   torch.where(out[2], out[1], -1).numpy().copy()))
    return out

tmoe._route = recording

def block(a, n_rows):
    return torch.from_numpy(np.ascontiguousarray(
        a[rank * n_rows:(rank + 1) * n_rows]))

# the layer, through both exchanges
for cf in inp["layer_cfs"]:
    full = params_from_jax(inp["layer"], "cpu")
    p = tmoe.split_moe_params({"blocks": [{"moe": full}]}, axis)
    p = {k: v.requires_grad_() for k, v in p["blocks"][0]["moe"].items()}
    x = block(inp["tokens"], inp["per_rank"]).requires_grad_()
    del routes[:]
    out, aux = tmoe.switch_moe_ep(p, x, axis, capacity_factor=cf)
    ((torch.sum(out ** 2) + aux) / world).backward()
    router = collectives.cross_rank_sum([p["router"].grad], axis)[0]
    res[f"layer_{cf}"] = dict(
        routes=list(routes), out=out.detach().numpy(), aux=float(aux),
        gx=x.grad.numpy(), router=router.numpy(),
        **{k: p[k].grad.numpy() for k in ("w1", "b1", "w2", "b2")})

# the expert-parallel step
collectives.reduce_stats(reset=True, op="all_to_all")
factory, _ = tmoe.make_moe_ep_train_step(
    inp["ep_cfg"], optimizer=sgd(0.1), aux_weight=1e-2, device="cpu")
params = tmoe.split_moe_params(params_from_jax(inp["ep_params"], "cpu"))
opt = sgd(0.1).init(params)
step = factory(params, opt)
xb = block(inp["ep_x"], inp["ep_batch"] // world)
yb = block(inp["ep_y"], inp["ep_batch"] // world)
metrics, step_routes = [], []
for _ in range(inp["steps"]):
    del routes[:]
    params, opt, m = step(params, opt, xb, yb)
    step_routes.append(list(routes))
    metrics.append({k: float(v) for k, v in m.items()})
specs = tree_leaves(tmoe.moe_transformer_param_specs(params))
res["ep_step"] = dict(
    metrics=metrics, routes=step_routes,
    params=params_to_numpy(tmoe.gather_moe_params(params)),
    replicated=[t.numpy() for t, s in zip(tree_leaves(params), specs)
                if not s],
    exchange=collectives.reduce_stats(op="all_to_all"))

# ring attention
seq = tmesh.rank_axis("seq")
t_local = inp["q"].shape[1] // world
for causal in (False, True):
    q, k, v = (torch.from_numpy(np.ascontiguousarray(
        a[:, rank * t_local:(rank + 1) * t_local])).requires_grad_()
        for a in (inp["q"], inp["k"], inp["v"]))
    collectives.reduce_stats(reset=True, op="ring")
    out = ring_attention(q, k, v, seq, causal=causal)
    torch.sum(out ** 2).backward()
    res[f"ring_{causal}"] = dict(
        out=out.detach().numpy(), gq=q.grad.numpy(), gk=k.grad.numpy(),
        gv=v.grad.numpy(), ring=collectives.reduce_stats(op="ring"))

# a ring over subgroups: pairs of ranks {0, 1}, {2, 3}, ... each run the
# whole sequence (every rank creates every group, in the same order)
import torch.distributed as dist
pairs = [dist.new_group([2 * i, 2 * i + 1]) for i in range(world // 2)]
sub = tmesh.rank_axis("seq", group=pairs[rank // 2])
half = inp["q"].shape[1] // 2
q, k, v = (torch.from_numpy(np.ascontiguousarray(
    a[:, sub.index * half:(sub.index + 1) * half])).requires_grad_()
    for a in (inp["q"], inp["k"], inp["v"]))
out = ring_attention(q, k, v, sub, causal=True)
torch.sum(out ** 2).backward()
res["ring_sub"] = dict(index=sub.index, size=sub.size,
                       out=out.detach().numpy(), gq=q.grad.numpy(),
                       gk=k.grad.numpy(), gv=v.grad.numpy())

# the sequence-parallel step
mesh = tmesh.make_tp_mesh(sp=world)
cfg = inp["sp_cfg"]
x = local_block(torch.from_numpy(inp["sp_x"]), mesh)
y = torch.from_numpy(inp["sp_y"])
params = params_from_jax(inp["sp_params"], "cpu")
loss, grads = loss_and_grads(params, x, y, cfg, causal=True, mesh=mesh)
factory, _ = make_tp_train_step(cfg, optimizer=sgd(0.1), causal=True,
                                device="cpu", mesh=mesh)
opt = sgd(0.1).init(params)
step = factory(params, opt)
losses = []
for _ in range(inp["steps"]):
    params, opt, l = step(params, opt, x, y)
    losses.append(float(l))
errors = []
for kw in ({"sp": world + 1}, {"dp": 2}, {"tp": 2}):
    try:
        errors.append(tmesh.make_tp_mesh(**kw).shape)
    except (ValueError, NotImplementedError) as e:
        errors.append(type(e).__name__ + ": " + str(e))
res["sp"] = dict(loss=float(loss), grads=params_to_numpy(grads),
                 losses=losses, params=params_to_numpy(params),
                 errors=errors)

with open(os.path.join(job["out"], f"rank_{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
print("DONE", rank, flush=True)
comm.shutdown()
'''


def _launch(tmp_path, world, inputs):
    """``world`` ranks of the rank program on ``inputs``; -> each rank's
    results."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    ipath = tmp_path / "inputs.pkl"
    with open(ipath, "wb") as f:
        pickle.dump(inputs, f)
    job = dict(repo=REPO, rdv=str(tmp_path / "rdv"), out=str(tmp_path),
               inputs=str(ipath), timeout=GROUP_TIMEOUT_S)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "DK_"))
           and k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "MASTER_ADDR",
                         "MASTER_PORT", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), json.dumps(job)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=LAUNCH_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(
        f"rank {r} rc={p.returncode}:\n{o[-3000:]}"
        for r, (p, o) in enumerate(zip(procs, outs)))
    results = []
    for r in range(world):
        with open(tmp_path / f"rank_{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------
def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _mesh(n, axis):
    return Mesh(np.array(jax.devices()[:n]), (axis,))


def _capacity(n, cf, num_experts):
    return int(math.ceil(n * cf / num_experts))


def _jax_route(p, y, capacity):
    """(expert, position or -1 when dropped) of the reference's routing."""
    dispatch, _, _ = jmoe._route(p, y, p["router"].shape[1], capacity)
    d = np.asarray(dispatch)
    probs = jax.nn.softmax((y @ p["router"]).astype(jnp.float32), axis=-1)
    return (np.asarray(jnp.argmax(probs, axis=-1)),
            np.where(d.sum((1, 2)) > 0, d.sum(1).argmax(-1), -1))


def _jax_layer_routes(params, x, cfg):
    """Every MoE layer's routing of the reference's forward over ``x``
    (one rank's sequences: its routing is the block's)."""
    routes = []
    cf = cfg["moe_capacity_factor"]

    def moe_fn(p, y):
        routes.append(_jax_route(p, y, _capacity(y.shape[0], cf,
                                                 p["router"].shape[1])))
        return jmoe.switch_moe_dense(p, y, capacity_factor=cf)

    h = jnp.asarray(x) @ params["proj"] + params["pos"][None, :x.shape[1]]
    for blk in params["blocks"]:
        h, _ = jtr.apply_block_aux(blk, h, jattention, False, moe_fn=moe_fn)
    return routes


def _jax_layer(params, x, n, cf):
    mesh = _mesh(n, jmoe.EXPERT_AXIS)
    specs = jmoe.moe_param_specs()

    def body(p, xb):
        o, a = jmoe.switch_moe_ep(p, xb, capacity_factor=cf)
        return o, lax.pmean(a, jmoe.EXPERT_AXIS)

    out, aux = jax.jit(shard_map(
        body, mesh=mesh, in_specs=(specs, P(jmoe.EXPERT_AXIS)),
        out_specs=(P(jmoe.EXPERT_AXIS), P())))(params, x)

    def loss(p, xb):
        def local(p_, x_):
            o, a = jmoe.switch_moe_ep(p_, x_, capacity_factor=cf)
            return lax.pmean(jnp.sum(o ** 2) + a, jmoe.EXPERT_AXIS)

        return shard_map(local, mesh=mesh,
                         in_specs=(specs, P(jmoe.EXPERT_AXIS)),
                         out_specs=P())(p, xb)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    blocks = [np.asarray(x)[r * TOKENS:(r + 1) * TOKENS] for r in range(n)]
    return dict(out=np.asarray(out), aux=float(aux), gx=np.asarray(gx),
                grads=_np(gp), routes=[
                    _jax_route(params, jnp.asarray(b),
                               _capacity(TOKENS, cf, E)) for b in blocks])


def _jax_ep_step(params, x, y, n):
    factory, _ = jmoe.make_moe_ep_train_step(
        _mesh(n, jmoe.EXPERT_AXIS), EP_CFG, optimizer=optax.sgd(0.1),
        aux_weight=1e-2, attn_fn=jattention)
    opt = optax.sgd(0.1).init(params)
    fn = factory(params, opt)
    metrics, routes = [], []
    rows = EP_BATCH // n
    for _ in range(STEPS):
        host = _np(params)
        routes.append([_jax_layer_routes(host, x[r * rows:(r + 1) * rows],
                                         EP_CFG) for r in range(n)])
        params, opt, m = fn(params, opt, jnp.asarray(x), jnp.asarray(y))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(metrics=metrics, routes=routes, params=_np(params))


def _jax_ring(q, k, v, n, causal):
    fn = shard_map(lambda q, k, v: jring(q, k, v, causal=causal),
                   mesh=_mesh(n, SEQ_AXIS),
                   in_specs=(P(None, SEQ_AXIS),) * 3,
                   out_specs=P(None, SEQ_AXIS))
    out = jax.jit(fn)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _keep_grads():
    """optax transformation: zero updates, the gradient kept as state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), {"g": g}))


def _jax_sp(params, x, y, n):
    out = {}
    for tag, tx, steps in (("grads", _keep_grads(), 1),
                           ("sgd", optax.sgd(0.1), STEPS)):
        factory, _ = jmake_tp_train_step(jmake_tp_mesh(1, 1, n), SP_CFG,
                                         optimizer=tx, causal=True)
        p, opt = params, tx.init(params)
        fn = factory(p, opt)
        losses = []
        for _ in range(steps):
            p, opt, loss = fn(p, opt, jnp.asarray(x), jnp.asarray(y))
            losses.append(float(loss))
        out[tag] = (losses, _np(opt["g"]) if tag == "grads" else _np(p))
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def run(request, tmp_path_factory):
    """-> (n, JAX references, each rank's results) of one launch."""
    n = request.param
    assert jax.device_count() >= n
    rng = np.random.default_rng(n)
    layer = jmoe.init_moe_params(jax.random.PRNGKey(0), D, FF, E)
    tokens = rng.normal(size=(n * TOKENS, D)).astype(np.float32)
    ep_params = jtr.init_transformer_params(jax.random.PRNGKey(1), EP_CFG)
    ep_x = rng.normal(size=(EP_BATCH, EP_CFG["seq_len"], EP_CFG["input_dim"]))
    ep_x = ep_x.astype(np.float32)
    ep_y = rng.integers(0, 2, EP_BATCH)
    q, k, v = (rng.normal(size=(QKV["b"], QKV["t"], QKV["h"], QKV["d"]))
               .astype(np.float32) for _ in range(3))
    inputs = dict(layer=_np(layer), tokens=tokens, per_rank=TOKENS,
                  layer_cfs=LAYER_CFS, ep_cfg=EP_CFG, ep_params=_np(ep_params),
                  ep_x=ep_x, ep_y=ep_y, ep_batch=EP_BATCH, steps=STEPS,
                  q=q, k=k, v=v)
    want = {f"layer_{cf}": _jax_layer(layer, jnp.asarray(tokens), n, cf)
            for cf in LAYER_CFS}
    want["ep_step"] = _jax_ep_step(ep_params, ep_x, ep_y, n)
    for causal in (False, True):
        want[f"ring_{causal}"] = _jax_ring(q, k, v, n, causal)
    want["ring_sub"] = _jax_ring(q, k, v, 2, True)
    sp_params = jtr.init_transformer_params(jax.random.PRNGKey(2), SP_CFG)
    sp_x = rng.normal(size=(SP_BATCH, SP_CFG["seq_len"],
                            SP_CFG["input_dim"])).astype(np.float32)
    sp_y = rng.integers(0, SP_CFG["n_classes"], SP_BATCH)
    inputs.update(sp_params=_np(sp_params), sp_cfg=SP_CFG, sp_x=sp_x,
                  sp_y=sp_y)
    want["sp"] = _jax_sp(sp_params, sp_x, sp_y, n)
    got = _launch(tmp_path_factory.mktemp(f"ranks{n}"), n, inputs)
    return n, want, got


def _same_routes(got, want):
    assert len(got) == len(want)
    for (ge, gp), (we, wp) in zip(got, want):
        np.testing.assert_array_equal(ge, we)
        np.testing.assert_array_equal(gp, wp)


@pytest.mark.parametrize("cf", LAYER_CFS)
def test_switch_moe_ep_matches_the_reference(run, cf):
    n, want, got = run
    w = want[f"layer_{cf}"]
    for r, res in enumerate(got):
        _same_routes(res[f"layer_{cf}"]["routes"], [w["routes"][r]])
    out = np.concatenate([res[f"layer_{cf}"]["out"] for res in got])
    np.testing.assert_allclose(out, w["out"], atol=1e-6)
    aux = np.mean([res[f"layer_{cf}"]["aux"] for res in got])
    np.testing.assert_allclose(aux, w["aux"], atol=1e-6)


@pytest.mark.parametrize("cf", LAYER_CFS)
def test_grads_through_both_exchanges_match_the_reference(run, cf):
    n, want, got = run
    w = want[f"layer_{cf}"]
    gx = np.concatenate([res[f"layer_{cf}"]["gx"] for res in got])
    np.testing.assert_allclose(gx, w["gx"], atol=1e-5)
    e_local = E // n
    for r, res in enumerate(got):
        g = res[f"layer_{cf}"]
        np.testing.assert_allclose(g["router"], w["grads"]["router"],
                                   atol=1e-5)
        for k in ("w1", "b1", "w2", "b2"):
            np.testing.assert_allclose(
                g[k], w["grads"][k][r * e_local:(r + 1) * e_local],
                atol=1e-5, err_msg=k)


def test_the_ep_step_matches_the_reference(run):
    n, want, got = run
    w = want["ep_step"]
    for s in range(STEPS):
        for r, res in enumerate(got):
            _same_routes(res["ep_step"]["routes"][s], w["routes"][s][r])
    for res in got:
        for m, wm in zip(res["ep_step"]["metrics"], w["metrics"]):
            for k in ("loss", "nll", "aux"):
                np.testing.assert_allclose(m[k], wm[k], atol=1e-5,
                                           err_msg=k)
        for a, b in zip(jax.tree.leaves(res["ep_step"]["params"]),
                        jax.tree.leaves(w["params"])):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-5)
    for res in got[1:]:
        for a, b in zip(res["ep_step"]["replicated"],
                        got[0]["ep_step"]["replicated"]):
            np.testing.assert_array_equal(a, b)
    # one exchange each way per layer per step, and their backwards
    ex = got[0]["ep_step"]["exchange"]
    assert ex["calls"] == 4 * EP_CFG["n_layers"] * STEPS
    assert ex["bytes"] > 0


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_the_reference(run, causal):
    n, want, got = run
    wout, wgrads = want[f"ring_{causal}"]
    out = np.concatenate([res[f"ring_{causal}"]["out"] for res in got], 1)
    np.testing.assert_allclose(out, wout, atol=2e-5, rtol=1e-4)
    for name, w in zip(("gq", "gk", "gv"), wgrads):
        g = np.concatenate([res[f"ring_{causal}"][name] for res in got], 1)
        np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3,
                                   err_msg=name)
    # K and V ride one shift a ring step; the backward shifts back
    assert got[0][f"ring_{causal}"]["ring"]["calls"] == 2 * (n - 1)


def test_ring_attention_over_subgroups_matches_the_reference(run):
    """Pairs of ranks, each pair a ``seq`` subgroup running the whole
    sequence: every pair's blocks equal JAX's 2-device ring."""
    n, want, got = run
    wout, wgrads = want["ring_sub"]
    for pair in range(n // 2):
        res = [got[2 * pair]["ring_sub"], got[2 * pair + 1]["ring_sub"]]
        assert [r["index"] for r in res] == [0, 1]
        assert all(r["size"] == 2 for r in res)
        out = np.concatenate([r["out"] for r in res], 1)
        np.testing.assert_allclose(out, wout, atol=2e-5, rtol=1e-4)
        for name, w in zip(("gq", "gk", "gv"), wgrads):
            g = np.concatenate([r[name] for r in res], 1)
            np.testing.assert_allclose(g, w, atol=2e-4, rtol=1e-3,
                                       err_msg=name)


def test_the_sp_step_matches_the_reference(run):
    n, want, got = run
    (wloss,), wgrads = want["sp"]["grads"]
    wlosses, wparams = want["sp"]["sgd"]
    for res in got:
        sp = res["sp"]
        np.testing.assert_allclose(sp["loss"], wloss, atol=1e-5)
        for a, b in zip(jax.tree.leaves(sp["grads"]),
                        jax.tree.leaves(wgrads)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-5)
        np.testing.assert_allclose(sp["losses"], wlosses, atol=1e-5)
        for a, b in zip(jax.tree.leaves(sp["params"]),
                        jax.tree.leaves(wparams)):
            np.testing.assert_allclose(a, b, atol=1e-5)
        # any product equal to the group's size builds; others raise
        refused, dp2, tp2 = sp["errors"]
        assert refused.startswith("ValueError: make_tp_mesh(")
        assert dp2 == {"workers": 2, "model": 1, "seq": n // 2}
        assert tp2 == {"workers": 1, "model": 2, "seq": n // 2}
