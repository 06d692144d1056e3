"""The port stands alone: importing it loads no jax, no port file imports
the JAX package, and entry points refuse to fall back to the CPU when
CUDA is missing unless the caller asked for ``device="cpu"``."""

import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dist_keras_tpu_torch.data import Dataset, ModelPredictor
from dist_keras_tpu_torch.models import mnist_mlp
from dist_keras_tpu_torch.models.transformer import (
    Transformer,
    transformer_config,
)
from dist_keras_tpu_torch.parallel import (
    make_tp_train_step,
    train_tp_transformer,
)
from dist_keras_tpu_torch.serving import DecodeEngine
from dist_keras_tpu_torch.trainers import (
    ADAG,
    DOWNPOUR,
    AveragingTrainer,
    DynSGD,
    EnsembleTrainer,
    SingleTrainer,
)
from dist_keras_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dist_keras_tpu_torch"
CFG = dict(input_dim=8, seq_len=16, d_model=8, n_heads=2, n_layers=1,
           n_classes=8)

_IMPORTS_JAX_PACKAGE = re.compile(
    r"^\s*(from|import)\s+dist_keras_tpu(\.|\s|$)", re.M)
_IMPORTS_JAX = re.compile(r"^\s*(from|import)\s+(jax|jaxlib)(\.|\s|$)",
                          re.M)
_IMPORTS_JAX_LIBS = re.compile(
    r"^\s*(from|import)\s+(optax|orbax|ml_dtypes|flax|chex)(\.|\s|$)", re.M)


def _sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def test_import_leaves_jax_out_of_sys_modules():
    # a fresh interpreter: this process's conftest already imported jax
    code = (
        "import importlib, pkgutil, sys\n"
        "import dist_keras_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, prefix='dist_keras_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'optax',\n"
        "             'orbax', 'ml_dtypes') or k.startswith(('jax.',\n"
        "             'optax.', 'orbax.', 'ml_dtypes.', 'dist_keras_tpu.')))\n"
        "assert len(mods) >= 57, mods\n"
        "for m in ('parallel.transformer_tp', 'ops.optimizers',\n"
        "          'trainers.single', 'models.model', 'trainers.step',\n"
        "          'trainers.chunking', 'data.predictors', 'ops.losses',\n"
        "          'checkpoint', 'resilience.retry', 'resilience.store',\n"
        "          'resilience.coordination', 'resilience.elastic',\n"
        "          'resilience.supervisor', 'serving.router',\n"
        "          'serving.reload', 'serving.autoscale', 'serving.bench',\n"
        "          'observability.flight', 'observability.timeseries',\n"
        "          'observability.watchdog', 'observability.slo',\n"
        "          'observability.trace_export', 'observability.statusz',\n"
        "          'observability.prometheus', 'observability.__main__'):\n"
        "    assert 'dist_keras_tpu_torch.' + m in mods, m\n"
        "assert not bad, bad\n"
        "assert 'dist_keras_tpu' not in sys.modules\n"
        "print('ok', len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_copied_modules_work_with_jax_blocked(tmp_path):
    """The knob registry, the event log and the fused backward import and
    run in an interpreter where importing jax or the JAX package fails,
    and an enabled event log attaches the port's own flight recorder;
    the serving fabric and the observability plane import there too."""
    code = (
        "import importlib.abc, os, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'dist_keras_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"os.environ['DK_OBS_DIR'] = {str(tmp_path)!r}\n"
        "os.environ['DK_FUSED_BWD'] = '1'\n"
        "from dist_keras_tpu_torch.utils import knobs\n"
        "from dist_keras_tpu_torch.observability import events\n"
        "from dist_keras_tpu_torch.ops import fused_bwd_experimental as f\n"
        "assert knobs.get('DK_FUSED_BWD') is True\n"
        "v = f.graduate(1, 8, 8, 8, 'float32', True, q_offset=8,\n"
        "               device='cpu')\n"
        "assert v.status == 'unverifiable' and events.enabled()\n"
        "from dist_keras_tpu_torch.observability import flight\n"
        "assert [m for m in sys.modules if 'flight' in m] == \\\n"
        "    ['dist_keras_tpu_torch.observability.flight']\n"
        "assert [r['kind'] for r in flight.recorder().records()] == \\\n"
        "    ['fused_bwd_rejected']\n"
        "import dist_keras_tpu_torch.serving as s\n"
        "import dist_keras_tpu_torch.serving.bench\n"
        "import dist_keras_tpu_torch.observability.__main__\n"
        "from dist_keras_tpu_torch.observability import (prometheus, slo,\n"
        "    statusz, timeseries, trace_export, watchdog)\n"
        "assert s.RouterServer and s.BlueGreenEngine and s.ReplicaAutoscaler\n"
        "assert 'torch' in statusz.status_doc()['build']\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    [line] = (tmp_path / "events-rank_0.jsonl").read_text().splitlines()
    assert '"kind": "fused_bwd_rejected"' in line


def test_a_reference_checkpoint_restores_with_jax_and_optax_blocked(
        tmp_path, monkeypatch):
    """A step the JAX package wrote (an optax adam state, chunked leaves)
    restores, verifies and converts in an interpreter where jax, optax,
    orbax, ml_dtypes and the JAX package cannot be imported — as on the
    machine with the card."""
    import jax
    import jax.numpy as jnp

    from dist_keras_tpu.checkpoint import Checkpointer
    from dist_keras_tpu.ops.optimizers import get_optimizer

    params = [{"kernel": np.arange(60, dtype=np.float32).reshape(6, 10),
               "bias": np.ones(10, np.float32)}]
    opt = get_optimizer("adam").init(jax.tree.map(jnp.asarray, params))
    monkeypatch.setenv("DK_CKPT_CHUNK_MB", "0.0001")
    Checkpointer(str(tmp_path)).save(3, {
        "params": params, "opt_state": jax.tree.map(np.asarray, opt)}).wait()
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'optax', 'orbax',\n"
        "                                  'ml_dtypes', 'dist_keras_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from dist_keras_tpu_torch.checkpoint import Checkpointer\n"
        "from dist_keras_tpu_torch.utils.bridge import opt_state_from_optax\n"
        f"ck = Checkpointer({str(tmp_path)!r})\n"
        "assert ck.verify(3) == 'ok'\n"
        "step, st = ck.restore()\n"
        "s = opt_state_from_optax('adam', st['opt_state'])\n"
        "assert sorted(s) == ['count', 'mu', 'nu'], s\n"
        "assert float(st['params'][0]['kernel'][5, 9]) == 59.0\n"
        "print('ok', step)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok 3"


def test_import_builds_nothing_and_touches_no_card():
    code = ("import torch\n"
            "import dist_keras_tpu_torch.serving\n"
            "import dist_keras_tpu_torch.parallel\n"
            "import dist_keras_tpu_torch.ops._build as b\n"
            "assert not b._LIBS\n"
            "assert not torch.cuda.is_initialized()\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("pattern", [_IMPORTS_JAX_PACKAGE, _IMPORTS_JAX,
                                     _IMPORTS_JAX_LIBS],
                         ids=["dist_keras_tpu", "jax", "optax-orbax"])
def test_no_port_file_imports_jax_or_the_jax_package(pattern):
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in _sources()
            for m in pattern.finditer(f.read_text())]
    assert not hits, hits


def test_scan_tells_the_port_from_the_jax_package():
    assert _IMPORTS_JAX_PACKAGE.search("from dist_keras_tpu.ops import x")
    assert _IMPORTS_JAX_PACKAGE.search("import dist_keras_tpu")
    assert not _IMPORTS_JAX_PACKAGE.search(
        "from dist_keras_tpu_torch.ops import x")
    assert not _IMPORTS_JAX_PACKAGE.search("import dist_keras_tpu_torch")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Transformer(transformer_config(**CFG))
    model = Transformer(transformer_config(**CFG), device="cpu")
    with pytest.raises(RuntimeError):
        DecodeEngine(model, prefill_ladder=(4,), decode_ladder=(1,))


def test_entry_points_run_on_the_cpu_when_asked(no_cuda):
    assert resolve_device("cpu") == torch.device("cpu")
    model = Transformer(transformer_config(**CFG), device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    eng = DecodeEngine(model, prefill_ladder=(4,), decode_ladder=(1,),
                       page_size=4, device="cpu")
    try:
        doc = eng.generate([1, 2], max_new_tokens=2, timeout_s=120)
        assert len(doc["generated"]) == 2
    finally:
        eng.close()


@pytest.mark.parametrize("name", ["run_serving_benchmark",
                                  "run_decode_benchmark",
                                  "run_survivability_benchmark"])
def test_bench_functions_refuse_without_cuda(no_cuda, name):
    from dist_keras_tpu_torch.serving import bench

    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(bench, name)(duration_s=0.1)


def test_bluegreen_of_cuda_engines_refuses_without_cuda(no_cuda):
    from dist_keras_tpu_torch.serving import BlueGreenEngine, ServingEngine

    model = mnist_mlp(hidden=(4,), input_dim=4, num_classes=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlueGreenEngine(lambda: ServingEngine(model))
    bg = BlueGreenEngine(lambda: ServingEngine(model, device="cpu"))
    try:
        rows = np.zeros((2, 4), np.float32)
        assert bg.predict(rows, timeout_s=60).shape == (2, 2)
        assert all(t.device.type == "cpu" for layer in bg.params
                   for t in layer.values())
    finally:
        bg.close()


def test_training_entry_points_refuse_without_cuda(no_cuda):
    cfg = transformer_config(**CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_tp_train_step(cfg)
    x = torch.zeros((2, CFG["seq_len"], CFG["input_dim"]))
    y = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_tp_transformer(cfg, x, y, steps=1)


def test_training_runs_on_the_cpu_when_asked(no_cuda):
    cfg = transformer_config(**CFG)
    x = torch.randn((2, CFG["seq_len"], CFG["input_dim"]),
                    generator=torch.Generator().manual_seed(0))
    params, losses = train_tp_transformer(cfg, x, torch.tensor([1, 3]),
                                          steps=2, causal=True, device="cpu")
    assert len(losses) == 2 and all(map(math.isfinite, losses))
    assert params["proj"].device.type == "cpu"


def test_training_loop_entry_points_refuse_without_cuda(no_cuda):
    model = mnist_mlp(hidden=(4,), input_dim=6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SingleTrainer(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelPredictor(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.predict(np.zeros((2, 6), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model(np.zeros((2, 6), np.float32))


def test_training_loop_runs_on_the_cpu_when_asked(no_cuda):
    model = mnist_mlp(hidden=(4,), num_classes=3, input_dim=6)
    rng = np.random.default_rng(0)
    data = Dataset.from_arrays(rng.normal(size=(32, 6)).astype(np.float32),
                               np.eye(3, dtype=np.float32)[
                                   rng.integers(0, 3, 32)])
    t = SingleTrainer(model, batch_size=8, num_epoch=2, device="cpu")
    trained = t.train(data)
    assert len(t.get_history()) == 8
    assert all(map(math.isfinite, t.get_history()))
    out = ModelPredictor(trained, device="cpu").predict(data)["prediction"]
    assert out.shape == (32, 3)
    np.testing.assert_allclose(trained.predict(data["features"],
                                               device="cpu"), out, rtol=1e-6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trained(data["features"])
    called = trained(data["features"], device="cpu")
    assert called.device.type == "cpu"
    np.testing.assert_allclose(called.detach().numpy(), out, rtol=1e-6)


def test_build_keeps_the_compiler_log_beside_the_library(tmp_path,
                                                         monkeypatch):
    """The compiler's output (ptxas's register lines) is read back from
    beside the library, so it is there without a rebuild; a library
    whose log is missing is built again."""
    from dist_keras_tpu_torch.ops import _build

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\necho "ptxas info : Used 40 registers"\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    built = _build.build(["paged_decode"])
    assert list(built) == ["paged_decode"]
    assert _build.library_path("paged_decode").exists()
    assert "Used 40 registers" in _build.build_log("paged_decode")
    assert _build.build(["paged_decode"]) == {}
    _build.library_path("paged_decode").with_suffix(".log").unlink()
    assert list(_build.build(["paged_decode"])) == ["paged_decode"]
    assert "Used 40 registers" in _build.build_log("paged_decode")


def test_kernel_bits_digest_agrees_exactly_when_torch_equal_does():
    from dist_keras_tpu_torch.utils.kernel_bits import digest

    x = torch.tensor([0.0, 1.5, -2.25])
    for dtype in (torch.float32, torch.bfloat16):
        a, b = x.to(dtype), torch.tensor([-0.0, 1.5, -2.25]).to(dtype)
        assert torch.equal(a, b) and digest(a) == digest(b)
        c = a.clone()
        c[1] = 1.5 + 2 ** -7   # one bf16 ulp up
        assert not torch.equal(a, c) and digest(a) != digest(c)


def test_kernel_bits_may_differ_by_kernel_or_by_dtype():
    from dist_keras_tpu_torch.utils.kernel_bits import compare

    a = {"flash_bwd_dq B=1 float32": ["x"], "flash_bwd_dq B=1 bfloat16": ["y"],
         "paged_decode S=1 float32": ["z"]}
    b = {"flash_bwd_dq B=1 float32": ["x2"], "flash_bwd_dq B=1 bfloat16": ["y2"],
         "paged_decode S=1 float32": ["z"]}
    assert compare(a, b, ["flash_bwd_dq"])[1] == 0
    lines, differ = compare(a, b, ["flash_bwd_dq:float32"])
    assert differ == 1
    assert "DIFFERENT  flash_bwd_dq B=1 bfloat16" in lines
    assert "different, allowed  flash_bwd_dq B=1 float32" in lines
    assert "equal  paged_decode S=1 float32" in lines
    assert compare(a, a, [])[1] == 0


_MULTI_WORKER = [ADAG, DOWNPOUR, DynSGD, AveragingTrainer, EnsembleTrainer]


@pytest.mark.parametrize("cls", _MULTI_WORKER, ids=lambda c: c.__name__)
def test_multi_worker_trainers_refuse_without_cuda(no_cuda, cls):
    model = mnist_mlp(hidden=(4,), input_dim=6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cls(model)


def test_adag_trains_on_the_cpu_when_asked(no_cuda):
    model = mnist_mlp(hidden=(4,), num_classes=3, input_dim=6)
    rng = np.random.default_rng(0)
    data = Dataset.from_arrays(rng.normal(size=(96, 6)).astype(np.float32),
                               np.eye(3, dtype=np.float32)[
                                   rng.integers(0, 3, 96)])
    t = ADAG(model, num_workers=4, communication_window=3, batch_size=8,
             num_epoch=2, device="cpu")
    trained = t.train(data)
    assert np.asarray(t.get_history()).shape == (4, 2, 1, 3)
    assert all(p.device.type == "cpu" for p in trained.parameters())


@pytest.mark.parametrize("cls", _MULTI_WORKER, ids=lambda c: c.__name__)
def test_multi_worker_trainers_take_a_worker_mesh(cls):
    """``mesh=`` takes a WorkerMesh (its slots are the trainer's
    workers, its device the trainer's); anything else is a TypeError."""
    from dist_keras_tpu_torch.parallel.mesh import worker_mesh

    model = mnist_mlp(hidden=(4,), input_dim=6)
    mesh = worker_mesh(2, "cpu")
    t = cls(model, num_workers=2, mesh=mesh)
    assert t.mesh is mesh and t.device == torch.device("cpu")
    assert t._local_worker_range() == (0, 2)
    with pytest.raises(TypeError, match="WorkerMesh"):
        cls(model, mesh="workers", device="cpu")


@pytest.mark.parametrize("env,alone", [
    ({"JAX_NUM_PROCESSES": "1"}, True),
    ({"JAX_COORDINATOR_ADDRESS": "file:///nonexistent", "JAX_NUM_PROCESSES":
      "1", "JAX_PROCESS_ID": "0"}, True),
    ({"WORLD_SIZE": "2"}, False)],
    ids=["jax_one_process", "jax_world_one", "world_size_alone"])
def test_multi_worker_trainers_read_the_multi_host_env(monkeypatch, env,
                                                       alone):
    """The launcher's environment of ONE process is the single-process
    path; torchrun's world without its rendezvous, or an address with no
    process id, is an actionable ValueError, never a lone rank."""
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID", "WORLD_SIZE", "RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    model = mnist_mlp(hidden=(4,), input_dim=6)
    for cls in _MULTI_WORKER:
        if alone:
            t = cls(model, device="cpu")
            assert (t.mesh.world, t.mesh.rank) == (1, 0)
        else:
            with pytest.raises(ValueError, match="MASTER_ADDR"):
                cls(model, device="cpu")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="JAX_PROCESS_ID"):
        ADAG(model, device="cpu")
