"""The transformer across ranks — the TP step's ``model`` and ``workers``
axes, FSDP and the pipeline (GPipe, 1F1B, interleaved) — held to the
JAX package under ``shard_map`` on ``conftest.py``'s virtual CPU
devices.

Each rank is a fresh ``python`` subprocess that imports only the port
(no jax, as on the card's host) and joins a gloo ``torch.distributed``
group through a ``file://`` rendezvous under ``tmp_path``; inputs (the
JAX package's weights and data, ``utils/bridge.py`` carries them
across) and results cross as pickles of numpy trees.  There are three
launches:

- 2 ranks: the TP step at (dp, tp, sp) = (1, 2, 1); FSDP; GPipe
  (``pp_transformer_apply``, dense and MoE with ``with_aux``) and
  interleaved GPipe at v=2; 1F1B (``pp_transformer_1f1b_grads``, dense
  and MoE) and interleaved 1F1B at v=2 and v=4; ``make_pp_train_step``
  (3 sgd steps, v=1 and v=2); an FSDP state saved over the 2 ranks
  (``Checkpointer.save(..., shard_specs=fsdp_specs(...))``) restores at
  world 1 equal to the gathered state;
- 4 ranks: the TP step at (2, 2, 1), (1, 2, 2), (2, 1, 2) and (1, 4, 1),
  ``remat="mlp"`` and ``True`` at (1, 2, 2); FSDP over 4;
  ``make_pp_train_step`` at stages=4 and at stages=2 x dp=2, each at
  v=1 and v=2; ``make_tp_mesh``'s default and refused products;
- 8 ranks: the (2, 2, 2) TP step (``bench_transformer_tp``'s mesh).

The references run on the same meshes, but for two: the ``remat`` runs
are held to the same mesh's run without remat, and every
``make_pp_train_step`` cell to JAX's pure 2-stage pipe at the same
``virtual`` (the JAX tests hold remat to no remat, and the composed and
deeper grids to the pure pipe).  For each: the loss and every grad
(gathered over the model, workers or stages ranks) within the JAX
tests' own tolerance and at most 1e-5
(``test_transformer_tp.py:76``, ``:103-106``; ``test_fsdp.py:92-95``;
``test_pipeline.py:57-228``); the params after 3 sgd steps within 1e-5;
the ranks' replicated leaves bit-equal; FSDP's persistent bytes a rank
at most 1/n of the sharded leaves plus the replicated ones; the 1F1B
stash peak within ``min(M, 2P - 1)``.  Grads are read through an
sgd that keeps the gradient it is given as its state (both packages).
The ranks run while this process computes the references; each rank
has its own wait timeout and its group a timeout
(``DK_COORD_TIMEOUT_S``).
"""

import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, PartitionSpec as JP

from dist_keras_tpu.models import transformer as jtr
from dist_keras_tpu.ops.attention import attention as jattention
from dist_keras_tpu.parallel import fsdp as jfsdp
from dist_keras_tpu.parallel import pipeline as jpp
from dist_keras_tpu.parallel.mesh import worker_mesh as jworker_mesh
from dist_keras_tpu.parallel.transformer_tp import (
    make_tp_mesh as jmake_tp_mesh,
    make_tp_train_step as jmake_tp_train_step,
)
from dist_keras_tpu.utils.jax_compat import shard_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 300     # each rank's wait
GROUP_TIMEOUT_S = "90"     # each group's DK_COORD_TIMEOUT_S
TOL = 1e-5
STEPS, LR = 3, 0.1

SP_CFG = jtr.transformer_config(input_dim=6, seq_len=16, d_model=16,
                                n_heads=4, n_layers=2, d_ff=32, n_classes=3)
TP_BATCH = 8
PP_CFG = jtr.transformer_config(input_dim=6, seq_len=8, d_model=16,
                                n_heads=2, n_layers=8, n_classes=3)
MOE_CFG = jtr.transformer_config(input_dim=6, seq_len=8, d_model=16,
                                 n_heads=2, n_layers=4, n_classes=3,
                                 moe_experts=4, moe_capacity_factor=2.0)
PP_BATCH, PP_M, AUX_W = 8, 4, 1e-2
FSDP_CFG = jtr.transformer_config(input_dim=8, seq_len=16, d_model=64,
                                  n_heads=4, n_layers=2, n_classes=2)
FSDP_BATCH = 16

# (dp, tp, sp, remat) of each launch's TP steps
TP_MESHES = {
    2: [(1, 2, 1, False)],
    4: [(2, 2, 1, False), (1, 2, 2, False), (2, 1, 2, False),
        (1, 4, 1, False), (1, 2, 2, "mlp"), (1, 2, 2, True)],
    8: [(2, 2, 2, False)],
}
# (stages, dp, virtual) of each launch's make_pp_train_step runs
PP_STEPS = {2: [(2, 1, 1), (2, 1, 2)],
            4: [(4, 1, 1), (4, 1, 2), (2, 2, 1), (2, 2, 2)], 8: []}

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
from dist_keras_tpu_torch.checkpoint import Checkpointer
from dist_keras_tpu_torch.models.transformer import transformer_apply
from dist_keras_tpu_torch.ops.attention import attention
from dist_keras_tpu_torch.ops.optimizers import Optimizer, sgd
from dist_keras_tpu_torch.parallel import fsdp
from dist_keras_tpu_torch.parallel import mesh as tmesh
from dist_keras_tpu_torch.parallel import pipeline as pp
from dist_keras_tpu_torch.parallel import transformer_tp as ttp
from dist_keras_tpu_torch.utils.bridge import params_from_jax, params_to_numpy
from dist_keras_tpu_torch.utils.pytree import (
    tree_leaves, tree_map, tree_unflatten)
comm.initialize(device="cpu")
assert "jax" not in sys.modules and "dist_keras_tpu" not in sys.modules
with open(job["inputs"], "rb") as f:
    inp = pickle.load(f)
res = {}
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))

def sgd_keeping_grads(lr):
    """sgd(lr), the gradient it was given kept as its state."""
    return Optimizer(lambda p: {"g": tree_map(torch.zeros_like, p)},
                     lambda g, s, p=None: (tree_map(lambda t: -lr * t, g),
                                           {"g": g}))

def three_steps(step, params, opt, *args):
    """-> (losses, step 1's grads, params after 3 steps)."""
    losses = []
    for i in range(3):
        params, opt, l = step(params, opt, *args)
        losses.append(float(l))
        if i == 0:
            grads = opt["g"]
    return losses, grads, params

def replicated(tree, specs):
    """The leaves whose spec names no mesh axis, as numpy arrays."""
    out = []
    tmesh.tree_map_specs(lambda x, s: out.append(x.numpy()) if not any(s)
                         else None, tree, specs)
    return out

# the TP step on each mesh
for dp, tp, sp, remat in inp["tp_meshes"]:
    mesh = tmesh.make_tp_mesh(dp, tp, sp)
    cfg = inp["sp_cfg"]
    x = ttp.local_block(T(inp["tp_x"]), mesh)
    y = ttp.local_block(T(inp["tp_y"]), mesh)
    tx = sgd_keeping_grads(0.1)
    factory, _ = ttp.make_tp_train_step(cfg, optimizer=tx, causal=True,
                                        remat=remat, device="cpu", mesh=mesh)
    params = ttp.split_tp_params(params_from_jax(inp["tp_params"], "cpu"),
                                 mesh)
    opt = tx.init(params)
    losses, grads, params = three_steps(factory(params, opt), params, opt,
                                        x, y)
    res[f"tp_{dp}_{tp}_{sp}_{remat}"] = dict(
        losses=losses,
        grads=params_to_numpy(ttp.gather_tp_params(grads, mesh)),
        params=params_to_numpy(ttp.gather_tp_params(params, mesh)),
        replicated=replicated(params, ttp.param_specs(params)))

if world == 4:
    errors = []
    for kw in ({"sp": world + 1}, {"dp": 3}, {"dp": 2, "tp": 2, "sp": 2}):
        try:
            tmesh.make_tp_mesh(**kw)
        except ValueError as e:
            errors.append(str(e))
    res["mesh"] = dict(
        dp2=tmesh.make_tp_mesh(dp=2).shape, tp2=tmesh.make_tp_mesh(tp=2).shape,
        default=tmesh.make_tp_mesh().shape, errors=errors,
        same=tmesh.make_tp_mesh(dp=2) is tmesh.make_tp_mesh(2, 1, 2))

# FSDP over every rank
if world in (2, 4):
    mesh = tmesh.grid_mesh({"workers": world})
    cfg = inp["fsdp_cfg"]
    apply_fn = lambda p, xb: transformer_apply(p, xb, cfg, attn_fn=attention)
    def loss_fn(logits, yb):
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(1, yb.long()[:, None]).mean()
    full = params_from_jax(inp["fsdp_params"], "cpu")
    xb = fsdp.place_by_specs(mesh, T(inp["fsdp_x"]), tmesh.P("workers"))
    yb = fsdp.place_by_specs(mesh, T(inp["fsdp_y"]), tmesh.P("workers"))
    gather = lambda tree, sp_: fsdp.gather_by_specs(mesh, tree, sp_)
    init_fn, factory = fsdp.make_fsdp_train_step(
        mesh, loss_fn, apply_fn, optimizer=sgd_keeping_grads(0.1),
        device="cpu")
    params, opt = init_fn(full)
    losses, grads, params = three_steps(factory(params, opt), params, opt,
                                        xb, yb)
    specs = factory.specs["params"]
    out = dict(losses=losses, grads=params_to_numpy(gather(grads, specs)),
               params=params_to_numpy(gather(params, specs)),
               replicated=replicated(params, specs))
    adam_init, adam_factory = fsdp.make_fsdp_train_step(
        mesh, loss_fn, apply_fn, device="cpu")
    ap, ao = adam_init(full)
    ap, ao, _ = adam_factory(ap, ao)(ap, ao, xb, yb)
    out["bytes"] = fsdp.persistent_bytes(ap, ao)
    specs = adam_factory.specs["params"]
    out["sharded_bytes"] = sum(
        t.numel() * 4 for t, s in zip(tree_leaves(full), tree_leaves(
            tmesh.tree_map_specs(lambda _, s: [any(s)], full, specs)))
        if s)
    if world == 2:
        # the checkpoint: params and adam state, saved over the ranks
        ospecs = fsdp.match_specs_for_state(ap, specs, ao)
        ck = Checkpointer(job["ckpt"])
        ck.save(1, {"params": ap, "opt_state": ao},
                shard_specs={"params": specs, "opt_state": ospecs}).wait(
                    timeout_s=60)
        out["saved"] = params_to_numpy({"params": gather(ap, specs),
                                        "opt_state": gather(ao, ospecs)})
    res["fsdp"] = out

# the pipeline over the stages: GPipe and 1F1B, dense and MoE
if world == 2:
    axis = tmesh.rank_axis("stages")
    def nll_of(logits, yb):
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -logp.gather(1, yb.long()[:, None]).mean()
    for name, cfg in (("dense", inp["pp_cfg"]), ("moe", inp["moe_cfg"])):
        full = params_from_jax(inp[f"pp_params_{name}"], "cpu")
        rest = {k: v for k, v in full.items() if k != "blocks"}
        x, y = T(inp["pp_x"]), T(inp["pp_y"])
        moe = name == "moe"
        for v in ((1, 2) if not moe else (1,)):
            if v > 1:
                stacked = pp.stack_blocks_interleaved(full["blocks"], 2, v)
            else:
                stacked = pp.stack_blocks(full["blocks"])
            blocks = pp.split_stage_blocks(stacked, axis, v)
            # GPipe: autograd through the messages
            leaves = [t.requires_grad_() for t in tree_leaves(rest)]
            r = tree_unflatten(rest, leaves)
            bl = tree_map(lambda t: t.clone().requires_grad_(), blocks)
            if v > 1:
                out = pp.pp_transformer_interleaved_apply(
                    r, bl, x, cfg, inp["pp_m"], v, causal=True, axis=axis,
                    with_aux=moe)
            else:
                out = pp.pp_transformer_apply(r, bl, x, cfg, inp["pp_m"],
                                              causal=True, axis=axis,
                                              with_aux=moe)
            logits, aux = out if moe else (out, torch.zeros(()))
            loss = nll_of(logits, y) + inp["aux_w"] * aux
            loss.backward()
            res[f"gpipe_{name}_{v}"] = dict(
                logits=logits.detach().numpy(), aux=float(aux),
                rest=params_to_numpy(tree_unflatten(
                    rest, [t.grad for t in leaves])),
                blocks=params_to_numpy(pp.gather_stage_blocks(
                    tree_map(lambda t: t.grad, bl), axis, v)))
            for t in leaves:
                t.grad = None
        for v in ((1, 2, 4) if not moe else (1,)):
            stacked = (pp.stack_blocks_interleaved(full["blocks"], 2, v)
                       if v > 1 else pp.stack_blocks(full["blocks"]))
            blocks = pp.split_stage_blocks(stacked, axis, v)
            loss, aux, rg, bg = pp.pp_transformer_1f1b_grads(
                rest, blocks, x, y, cfg, inp["pp_m"], causal=True,
                axis=axis, aux_weight=inp["aux_w"], virtual=v)
            res[f"1f1b_{name}_{v}"] = dict(
                loss=float(loss), aux=float(aux), rest=params_to_numpy(rg),
                blocks=params_to_numpy(pp.gather_stage_blocks(bg, axis, v)),
                peak=pp.stash_peak())

# make_pp_train_step on each (stages, dp) grid
for stages, dp, v in inp["pp_steps"]:
    mesh = pp.make_pp_mesh(stages, dp)
    cfg = inp["pp_cfg"]
    full = params_from_jax(inp["pp_params_dense"], "cpu")
    rest = {k: t for k, t in full.items() if k != "blocks"}
    stacked = (pp.stack_blocks_interleaved(full["blocks"], stages, v)
               if v > 1 else pp.stack_blocks(full["blocks"]))
    blocks = pp.split_stage_blocks(stacked, mesh, v)
    factory, _ = pp.make_pp_train_step(mesh, cfg, inp["pp_m"],
                                       optimizer=sgd(0.1), causal=True,
                                       virtual=v, device="cpu")
    tx = sgd(0.1)
    ro, bo = tx.init(rest), tx.init(blocks)
    step = factory(rest, blocks, ro, bo)
    n = inp["pp_x"].shape[0] // dp
    w = mesh.workers.index
    xb, yb = T(inp["pp_x"][w * n:(w + 1) * n]), T(inp["pp_y"][w * n:(w + 1) * n])
    losses = []
    for _ in range(3):
        rest, blocks, ro, bo, l, a = step(rest, blocks, ro, bo, xb, yb)
        losses.append(float(l))
    res[f"pp_step_{stages}_{dp}_{v}"] = dict(
        losses=losses, rest=params_to_numpy(rest),
        blocks=params_to_numpy(pp.gather_stage_blocks(blocks, mesh, v)))

with open(os.path.join(job["out"], f"rank_{rank}.pkl"), "wb") as f:
    pickle.dump(res, f)
print("DONE", rank, flush=True)
comm.shutdown()
'''


def _launch(tmp_path, world, inputs):
    """Start ``world`` ranks of the rank program on ``inputs``; -> a
    function that waits for them (``LAUNCH_TIMEOUT_S`` each) and returns
    each rank's results."""
    script = tmp_path / "rank.py"
    script.write_text(_RANK)
    ipath = tmp_path / "inputs.pkl"
    with open(ipath, "wb") as f:
        pickle.dump(inputs, f)
    job = dict(repo=REPO, rdv=str(tmp_path / "rdv"), out=str(tmp_path),
               inputs=str(ipath), timeout=GROUP_TIMEOUT_S,
               ckpt=str(tmp_path / "ckpt"))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "DK_"))
           and k not in ("PYTHONPATH", "WORLD_SIZE", "RANK", "MASTER_ADDR",
                         "MASTER_PORT", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    logs = [open(tmp_path / f"rank_{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), json.dumps(job)],
        stdout=log, stderr=subprocess.STDOUT, env=env, text=True)
        for r, log in enumerate(logs)]

    def wait():
        try:
            for p in procs:
                p.wait(timeout=LAUNCH_TIMEOUT_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
        assert all(p.returncode == 0 for p in procs), "\n".join(
            f"rank {r} rc={p.returncode}:\n{o[-3000:]}"
            for r, (p, o) in enumerate(zip(procs, outs)))
        results = []
        for r in range(world):
            with open(tmp_path / f"rank_{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results

    return wait


# ---------------------------------------------------------------------------
# the JAX references
# ---------------------------------------------------------------------------
def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _sgd_keeping_grads():
    """optax.sgd(LR), the gradient it was given kept as its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (jax.tree.map(lambda t: -LR * t, g), {"g": g}))


def _three_steps(fn, p, opt, *args):
    """-> {losses, step 1's grads, params after STEPS steps}."""
    losses = []
    for i in range(STEPS):
        p, opt, loss = fn(p, opt, *args)
        losses.append(float(loss))
        if i == 0:
            grads = _np(opt["g"])
    return dict(losses=losses, grads=grads, params=_np(p))


def _jax_tp(params, x, y, dp, tp, sp):
    tx = _sgd_keeping_grads()
    factory, _ = jmake_tp_train_step(jmake_tp_mesh(dp, tp, sp), SP_CFG,
                                     optimizer=tx, causal=True)
    opt = tx.init(params)
    return _three_steps(factory(params, opt), params, opt, jnp.asarray(x),
                        jnp.asarray(y))


def _fsdp_fns():
    def apply_fn(p, xb):
        return jtr.transformer_apply(p, xb, FSDP_CFG, attn_fn=jattention)

    def loss_fn(logits, yb):
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(
            logp, yb[:, None].astype(jnp.int32), axis=-1).mean()

    return apply_fn, loss_fn


def _jax_fsdp(params, x, y, n):
    apply_fn, loss_fn = _fsdp_fns()
    mesh = jworker_mesh(n)
    init_fn, factory = jfsdp.make_fsdp_train_step(
        mesh, loss_fn, apply_fn, optimizer=_sgd_keeping_grads())
    p, opt = init_fn(jax.tree.map(jnp.array, params))
    return _three_steps(factory(p, opt), p, opt,
                        jfsdp.place_by_specs(mesh, x, JP("workers")),
                        jfsdp.place_by_specs(mesh, y, JP("workers")))


def _pp_mesh(p):
    return Mesh(np.array(jax.devices()[:p]), (jpp.PIPE_AXIS,))


def _nll(logits, y):
    logp = jax.nn.log_softmax(logits.astype(jnp.float32))
    return -jnp.take_along_axis(logp, y[:, None], axis=-1).mean()


def _jax_gpipe(params, x, y, cfg, v):
    """Logits, aux and the grads of nll + AUX_W * aux through JAX's
    GPipe (interleaved at v > 1) on 2 stages."""
    moe = bool(cfg["moe_experts"])
    rest = {k: t for k, t in params.items() if k != "blocks"}
    if v > 1:
        stacked = jpp.stack_blocks_interleaved(params["blocks"], 2, v)

        def fwd(r, b, xb):
            out = jpp.pp_transformer_interleaved_apply(
                r, jax.tree.map(lambda a: a[0], b), xb, cfg, PP_M, v,
                causal=True, with_aux=moe)
            return out if moe else (out, jnp.float32(0.0))
    else:
        stacked = jpp.stack_blocks(params["blocks"])

        def fwd(r, b, xb):
            out = jpp.pp_transformer_apply(r, b, xb, cfg, PP_M, causal=True,
                                           with_aux=moe)
            return out if moe else (out, jnp.float32(0.0))

    fn = shard_map(fwd, mesh=_pp_mesh(2),
                   in_specs=(JP(), JP(jpp.PIPE_AXIS), JP()),
                   out_specs=(JP(), JP()))

    def loss(r, b):
        lg, a = fn(r, b, x)
        return _nll(lg, y) + AUX_W * a, (lg, a)

    (_, (logits, aux)), (gr, gb) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(rest, stacked)
    return dict(logits=np.asarray(logits), aux=float(aux), rest=_np(gr),
                blocks=_np(gb))


def _jax_1f1b(params, x, y, cfg, v):
    rest = {k: t for k, t in params.items() if k != "blocks"}
    if v > 1:
        stacked = jpp.stack_blocks_interleaved(params["blocks"], 2, v)
    else:
        stacked = jpp.stack_blocks(params["blocks"])

    def run(r, b, xb, yb):
        loss, aux, rg, bg = jpp.pp_transformer_1f1b_grads(
            r, jax.tree.map(lambda a: a[0], b) if v > 1 else b, xb, yb,
            cfg, num_microbatches=PP_M,
            causal=True, aux_weight=AUX_W, virtual=v)
        if v > 1:
            bg = jax.tree.map(lambda g: g[None], bg)
        return loss, aux, rg, bg

    loss, aux, rg, bg = jax.jit(shard_map(
        run, mesh=_pp_mesh(2),
        in_specs=(JP(), JP(jpp.PIPE_AXIS), JP(), JP()),
        out_specs=(JP(), JP(), JP(), JP(jpp.PIPE_AXIS))))(rest, stacked, x, y)
    return dict(loss=float(loss), aux=float(aux), rest=_np(rg),
                blocks=_np(bg))


def _jax_pp_step(params, x, y, stages, dp, v):
    mesh = jpp.make_pp_mesh(stages=stages, dp=dp)
    factory, _ = jpp.make_pp_train_step(
        mesh, PP_CFG, num_microbatches=PP_M, optimizer=optax.sgd(LR),
        causal=True, virtual=v)
    rest = {k: t for k, t in params.items() if k != "blocks"}
    blocks = (jpp.stack_blocks_interleaved(params["blocks"], stages, v)
              if v > 1 else jpp.stack_blocks(params["blocks"]))
    tx = optax.sgd(LR)
    opt_r, opt_b = tx.init(rest), tx.init(blocks)
    fn = factory(rest, blocks, opt_r, opt_b)
    losses = []
    for _ in range(STEPS):
        rest, blocks, opt_r, opt_b, loss, _ = fn(
            rest, blocks, opt_r, opt_b, jnp.asarray(x), jnp.asarray(y))
        losses.append(float(loss))
    return dict(losses=losses, rest=_np(rest), blocks=_np(blocks))


def _inputs(n):
    rng = np.random.default_rng(n)
    model = jtr.Transformer(input_dim=8, seq_len=16, d_model=64, n_heads=4,
                            n_layers=2, n_classes=2, seed=0)
    fx = rng.normal(size=(FSDP_BATCH, 16, 8)).astype(np.float32)
    return dict(
        sp_cfg=SP_CFG, tp_meshes=TP_MESHES[n], pp_steps=PP_STEPS[n],
        tp_params=_np(jtr.init_transformer_params(jax.random.PRNGKey(2),
                                                  SP_CFG)),
        tp_x=rng.normal(size=(TP_BATCH, SP_CFG["seq_len"],
                              SP_CFG["input_dim"])).astype(np.float32),
        tp_y=rng.integers(0, SP_CFG["n_classes"], TP_BATCH),
        fsdp_cfg=FSDP_CFG, fsdp_params=_np(model.params), fsdp_x=fx,
        fsdp_y=(fx[:, :, 0].mean(1) > 0).astype(np.int32),
        pp_cfg=PP_CFG, moe_cfg=MOE_CFG, pp_m=PP_M, aux_w=AUX_W,
        pp_x=rng.normal(size=(PP_BATCH, 8, 6)).astype(np.float32),
        pp_y=rng.integers(0, 3, PP_BATCH).astype(np.int32),
        pp_params_dense=_np(jtr.init_transformer_params(
            jax.random.PRNGKey(0), PP_CFG)),
        pp_params_moe=_np(jtr.init_transformer_params(
            jax.random.PRNGKey(1), MOE_CFG)))


def _refs(n, inp):
    """The JAX references of the n-rank launch's runs.  The remat runs
    are held to the same mesh's run without remat (a memory policy: the
    JAX test holds the two equal), and every ``make_pp_train_step`` cell
    to JAX's pure 2-stage pipe at the same ``virtual`` (the JAX tests
    hold the composed and deeper grids to it)."""
    want = {}
    for dp, tp, sp, remat in TP_MESHES[n]:
        if not remat:
            want[f"tp_{dp}_{tp}_{sp}"] = _jax_tp(
                inp["tp_params"], inp["tp_x"], inp["tp_y"], dp, tp, sp)
    if n in (2, 4):
        want["fsdp"] = _jax_fsdp(inp["fsdp_params"], inp["fsdp_x"],
                                 inp["fsdp_y"], n)
    x, y = jnp.asarray(inp["pp_x"]), jnp.asarray(inp["pp_y"])
    if n == 2:
        for name, cfg in (("dense", PP_CFG), ("moe", MOE_CFG)):
            params = inp[f"pp_params_{name}"]
            for v in ((1, 2) if name == "dense" else (1,)):
                want[f"gpipe_{name}_{v}"] = _jax_gpipe(params, x, y, cfg, v)
            for v in ((1, 2, 4) if name == "dense" else (1,)):
                want[f"1f1b_{name}_{v}"] = _jax_1f1b(params, x, y, cfg, v)
    for v in sorted({v for _, _, v in PP_STEPS[n]}):
        want[f"pp_step_{v}"] = _jax_pp_step(
            inp["pp_params_dense"], inp["pp_x"], inp["pp_y"], 2, 1, v)
    return want


_LAUNCHED = {}


def _launched(n, tmp_path_factory):
    """-> (JAX references, each rank's results, the launch's dir) of the
    n-rank launch, run once per module."""
    if n not in _LAUNCHED:
        assert jax.device_count() >= n
        inputs = _inputs(n)
        tmp = tmp_path_factory.mktemp(f"ranks{n}")
        # the ranks run while this process computes the references
        wait = _launch(tmp, n, inputs)
        want = _refs(n, inputs)
        _LAUNCHED[n] = (want, wait(), tmp)
    return _LAUNCHED[n]


def _close(got, want, tol=TOL, what=""):
    ga, wa = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(ga) == len(wa) > 0, what
    for a, b in zip(ga, wa):
        assert np.shape(a) == np.shape(b), what
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=what)


def _layer_order(blocks, p, v):
    """Stacked blocks in ``stack_blocks_interleaved``'s (P, v, Lpc, ...)
    layout (v > 1) -> the layer order's (L, ...) stack."""
    if v == 1:
        return blocks

    def unstack(a):
        lpc = a.shape[2]
        flat = np.empty((p * v * lpc,) + a.shape[3:], a.dtype)
        for s_ in range(p):
            for c in range(v):
                for j in range(lpc):
                    flat[(c * p + s_) * lpc + j] = a[s_, c, j]
        return flat

    return jax.tree.map(unstack, blocks)


def _matches(got, key, want):
    """Every rank's step-1 loss and grads, losses and params after the
    steps match the reference; the replicated leaves are bit-equal."""
    for res in got:
        g = res[key]
        np.testing.assert_allclose(g["losses"], want["losses"], atol=TOL,
                                   rtol=TOL)
        _close(g["grads"], want["grads"], what=f"{key} grads")
        _close(g["params"], want["params"], what=f"{key} params")
    for res in got[1:]:
        for a, b in zip(res[key]["replicated"], got[0][key]["replicated"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,mesh", [(n, m) for n in (2, 4, 8)
                                    for m in TP_MESHES[n]],
                         ids=lambda v: str(v))
def test_the_tp_step_matches_the_reference(tmp_path_factory, n, mesh):
    want, got, _ = _launched(n, tmp_path_factory)
    key = "tp_{}_{}_{}_{}".format(*mesh)
    _matches(got, key, want["tp_{}_{}_{}".format(*mesh[:3])])


def test_make_tp_mesh_builds_every_product_of_the_group(tmp_path_factory):
    _, got, _ = _launched(4, tmp_path_factory)
    for res in got:
        m = res["mesh"]
        assert m["dp2"] == {"workers": 2, "model": 1, "seq": 2}
        assert m["tp2"] == {"workers": 1, "model": 2, "seq": 2}
        assert m["default"] == {"workers": 1, "model": 1, "seq": 4}
        assert m["same"]
        assert len(m["errors"]) == 3
        assert all("make_tp_mesh" in e for e in m["errors"])
        assert not any("item 17" in e for e in m["errors"])


@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_matches_the_reference(tmp_path_factory, n):
    want, got, _ = _launched(n, tmp_path_factory)
    _matches(got, "fsdp", want["fsdp"])


@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_keeps_a_sharded_footprint(tmp_path_factory, n):
    """params + adam state a rank: at most 1/n of the sharded leaves plus
    the replicated ones (the gathered leaves do not outlive the step)."""
    want, got, _ = _launched(n, tmp_path_factory)
    for res in got:
        f = res["fsdp"]
        full = 4 * sum(np.size(a) for a in jax.tree.leaves(
            want["fsdp"]["params"]))
        replicated = full - f["sharded_bytes"]
        # params, mu and nu: three copies; the count is 4 bytes
        assert f["bytes"] <= 3 * (f["sharded_bytes"] / n + replicated) + 4
        assert f["bytes"] < 3 * full / 1.5


def test_an_fsdp_checkpoint_restores_at_world_1(tmp_path_factory):
    """Saved over 2 ranks with ``shard_specs=fsdp_specs(...)``, restored
    at world 1 through the elastic restore: the gathered state."""
    from dist_keras_tpu_torch.checkpoint import Checkpointer

    _, got, tmp = _launched(2, tmp_path_factory)
    step, state = Checkpointer(str(tmp / "ckpt"), rank=0, world=1).restore()
    assert step == 1
    saved = got[0]["fsdp"]["saved"]
    for res in got[1:]:
        _close(res["fsdp"]["saved"], saved, tol=0)
    # every sharded leaf and its adam moments came back whole
    assert state["opt_state"]["mu"]["blocks"][0]["w1"].shape == (64, 256)
    got_l, want_l = jax.tree.leaves(state), jax.tree.leaves(saved)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("key", ["gpipe_dense_1", "gpipe_dense_2",
                                 "gpipe_moe_1"])
def test_gpipe_matches_the_reference(tmp_path_factory, key):
    want, got, _ = _launched(2, tmp_path_factory)
    w = want[key]
    for res in got:
        g = res[key]
        np.testing.assert_allclose(g["logits"], w["logits"], atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(g["aux"], w["aux"], atol=TOL, rtol=TOL)
        _close(g["rest"], w["rest"], what=f"{key} rest grads")
        _close(g["blocks"], w["blocks"], what=f"{key} block grads")
        np.testing.assert_array_equal(g["logits"], got[0][key]["logits"])


@pytest.mark.parametrize("key", ["1f1b_dense_1", "1f1b_dense_2",
                                 "1f1b_dense_4", "1f1b_moe_1"])
def test_1f1b_matches_the_reference(tmp_path_factory, key):
    want, got, _ = _launched(2, tmp_path_factory)
    w = want[key]
    v = int(key[-1])
    for r, res in enumerate(got):
        g = res[key]
        np.testing.assert_allclose(g["loss"], w["loss"], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(g["aux"], w["aux"], atol=TOL, rtol=TOL)
        _close(g["rest"], w["rest"], what=f"{key} rest grads")
        _close(g["blocks"], w["blocks"], what=f"{key} block grads")
        # the stash stays within the JAX engines' bounds
        bound = (min(PP_M, 2 * 2 - 1) if v == 1 else
                 jpp.interleaved_1f1b_stash_entries(2, v, PP_M))
        assert 1 <= g["peak"] <= bound
        if v == 1:
            assert g["peak"] == min(PP_M, 2 - r)
    for a, b in zip(jax.tree.leaves(got[1][key]["rest"]),
                    jax.tree.leaves(got[0][key]["rest"])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,cell", [(n, c) for n in (2, 4)
                                    for c in PP_STEPS[n]],
                         ids=lambda v: str(v))
def test_the_pp_train_step_matches_the_reference(tmp_path_factory, n, cell):
    want, got, _ = _launched(n, tmp_path_factory)
    stages, _, v = cell
    key = "pp_step_{}_{}_{}".format(*cell)
    w = want[f"pp_step_{v}"]
    for res in got:
        g = res[key]
        np.testing.assert_allclose(g["losses"], w["losses"], atol=TOL,
                                   rtol=TOL)
        _close(g["rest"], w["rest"], what=f"{key} rest")
        _close(_layer_order(g["blocks"], stages, v),
               _layer_order(w["blocks"], 2, v), what=f"{key} blocks")
    for res in got[1:]:
        for a, b in zip(jax.tree.leaves(res[key]["rest"]),
                        jax.tree.leaves(got[0][key]["rest"])):
            np.testing.assert_array_equal(a, b)
