"""The port's Keras adapter (Keras 3, torch backend) against the JAX
package's (Keras 3, jax backend), on the CPU.

The same Keras architectures get the same numpy weights in both
packages, and are held to each other:

- the MLP's forward (``training=False``) within 1e-5;
- one full-batch SGD step of a BatchNorm model through each package's
  ``SingleTrainer``: trainables and moving statistics within 2e-4, and
  the moving statistics moved;
- a JAX ``serialize_model(KerasModelAdapter(...))`` deserializes in the
  port into a model giving the same outputs (1e-5), and the reverse;
- the Dropout model trains under ADAG, ``AveragingTrainer`` and DynSGD
  in both, its integer seed-generator state surviving every merge, with
  a finite history and the JAX tests' accuracy floors.  The backends
  draw other dropout masks, so dropout is not compared element by
  element.

Keras costs ~17 s per import, so each side runs once per module: the
port's in ONE subprocess with ``KERAS_BACKEND=torch`` and a meta-path
finder that refuses ``jax`` and ``dist_keras_tpu`` (the adapter stands
without them, as on the card's host); the JAX side in this process when
Keras is loaded (or loadable) with the jax backend, as
``tests/test_keras_adapter.py`` runs it, else in a subprocess too.  The
sides hand their results back through ``.npz`` files under the module's
temporary directory.  Run as a script, this file is that side runner:
``python tests/test_torch_keras_adapter.py {torch,jax,jax-reverse} IN
OUT``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

FWD_TOL = 1e-5
STEP_TOL = 2e-4
# (trainer, floor): the JAX tests' floors (tests/test_keras_adapter.py)
FLOORS = {"ADAG": 0.9, "AveragingTrainer": 0.85, "DynSGD": 0.80}
INIT_SEED = 0
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- the side runner (one process per side; imports nothing at module
# import beyond numpy, so the port's side can refuse jax) ---------------

class _Refuse:
    """A meta-path finder that refuses jax and the JAX package."""

    NAMES = ("jax", "jaxlib", "dist_keras_tpu")

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in self.NAMES:
            raise ImportError(f"{name} is refused in the port's process")
        return None


def _blobs():
    """``tests/conftest.py``'s blobs set: 512 rows, 8 features, 2
    classes."""
    rng = np.random.default_rng(0)
    n, d = 512, 8
    y = rng.integers(0, 2, size=n)
    centers = np.stack([np.full(d, -1.0), np.full(d, 1.0)])
    x = (centers[y] + rng.normal(size=(n, d)).astype(np.float32))
    return {"features": x.astype(np.float32), "label": y,
            "label_encoded": np.eye(2, dtype=np.float32)[y]}


def _keras_model(keras, kind):
    middle = {"mlp": [],
              "bn": [keras.layers.BatchNormalization()],
              "dropout": [keras.layers.Dropout(0.3)]}[kind]
    return keras.Sequential(
        [keras.layers.Input((8,)),
         keras.layers.Dense(16, activation="relu")] + middle
        + [keras.layers.Dense(2)])


def _init_weights(keras_model, seed):
    """Trainables from numpy (Glorot-uniform kernels, zero biases and
    betas, unit gammas), in the model's variable order: the same arrays
    in both backends."""
    rng = np.random.default_rng(seed)
    out = []
    for v in keras_model.trainable_variables:
        shape = tuple(v.shape)
        name = v.path.rsplit("/", 1)[-1]
        if name == "kernel":
            lim = np.sqrt(6.0 / (shape[0] + shape[1]))
            out.append(rng.uniform(-lim, lim, size=shape).astype(np.float32))
        elif name == "gamma":
            out.append(np.ones(shape, np.float32))
        else:
            out.append(np.zeros(shape, np.float32))
    return out


def _side(side, inp, out):
    """Run one package's half; -> the dict written to ``out``."""
    if side == "torch":
        sys.meta_path.insert(0, _Refuse())
        os.environ["KERAS_BACKEND"] = "torch"
    else:
        os.environ.setdefault("KERAS_BACKEND", "jax")
    import keras

    assert keras.backend.backend() == ("torch" if side == "torch"
                                       else "jax")
    if side == "torch":
        from dist_keras_tpu_torch import trainers
        from dist_keras_tpu_torch.data import Dataset
        from dist_keras_tpu_torch.models.keras_adapter import (
            KerasModelAdapter,
        )
        from dist_keras_tpu_torch.utils import serialization
        kw = {"device": "cpu"}
    else:
        from dist_keras_tpu import trainers
        from dist_keras_tpu.data import Dataset
        from dist_keras_tpu.models.keras_adapter import KerasModelAdapter
        from dist_keras_tpu.utils import serialization
        kw = {}

    def adapter(kind):
        km = _keras_model(keras, kind)
        ad = KerasModelAdapter(km, **kw)
        ad.set_weights(_init_weights(km, INIT_SEED))
        return ad

    def host(a):
        return np.asarray(a.detach().cpu() if hasattr(a, "detach") else a)

    z = dict(np.load(inp, allow_pickle=False))
    res = {}
    if side == "jax-reverse":
        ad = serialization.deserialize_model(
            {"model": str(z["ser_json"]),
             "weights": [z[f"ser_w{i}"] for i in range(int(z["ser_n"]))]})
        res["reverse_out"] = host(ad(z["x_small"]))
        np.savez(out, **res)
        return res

    data = _blobs()
    # 1. the MLP's forward
    mlp = adapter("mlp")
    res["fwd"] = host(mlp(z["x_small"]))
    res["count_params"] = np.asarray(mlp.count_params)
    ser = serialization.serialize_model(mlp)
    res["ser_json"] = np.asarray(ser["model"])
    res["ser_n"] = np.asarray(len(ser["weights"]))
    for i, w in enumerate(ser["weights"]):
        res[f"ser_w{i}"] = np.asarray(w)
    # 2. one full-batch SGD step of the BatchNorm model
    bn = adapter("bn")
    res["bn_init"] = np.concatenate(
        [host(s).ravel() for s in bn.params["state"]])
    t = trainers.SingleTrainer(
        bn, loss="categorical_crossentropy", worker_optimizer="sgd",
        optimizer_kwargs={"learning_rate": 0.05}, batch_size=64,
        num_epoch=1, label_col="label_encoded", **kw)
    trained = t.train(Dataset({"features": data["features"][:64],
                               "label_encoded":
                               data["label_encoded"][:64]}))
    for i, w in enumerate(trained.get_weights()):
        res[f"bn_w{i}"] = np.asarray(w)
    res["bn_n"] = np.asarray(len(trained.get_weights()))
    # 3. the other package's serialized MLP, deserialized here
    if "ser_json" in z:
        d = {"model": str(z["ser_json"]),
             "weights": [z[f"ser_w{i}"] for i in range(int(z["ser_n"]))]}
        other = serialization.deserialize_model(d, **kw)
        res["deser_out"] = host(other(z["x_small"]))
    # 4. the Dropout model under every merge algebra
    ds = Dataset(data)
    for name, make in (
        ("ADAG", lambda m: trainers.ADAG(
            m, num_workers=4, communication_window=2,
            worker_optimizer="adam", loss="categorical_crossentropy",
            batch_size=16, num_epoch=8, label_col="label_encoded", **kw)),
        ("AveragingTrainer", lambda m: trainers.AveragingTrainer(
            m, num_workers=4, worker_optimizer="adam",
            loss="categorical_crossentropy", batch_size=16, num_epoch=10,
            label_col="label_encoded", **kw)),
        ("DynSGD", lambda m: trainers.DynSGD(
            m, num_workers=4, communication_window=2,
            worker_optimizer="adam", loss="categorical_crossentropy",
            batch_size=16, num_epoch=4, label_col="label_encoded", **kw)),
    ):
        keras.utils.set_random_seed(1)
        t = make(adapter("dropout"))
        trained = t.train(ds)
        logits = np.asarray(trained.predict(data["features"]))
        res[f"{name}_history"] = np.asarray(t.get_history(), np.float64)
        res[f"{name}_acc"] = np.asarray(float(np.mean(
            np.argmax(logits, -1) == data["label"])))
        res[f"{name}_state_dtypes"] = np.asarray(
            [str(host(s).dtype) for s in trained.params["state"]])
        if side == "torch" and name == "ADAG":
            from dist_keras_tpu_torch.data import ModelPredictor

            res["predictor_err"] = np.asarray(float(np.max(np.abs(
                ModelPredictor(trained, device="cpu").predict(ds)[
                    "prediction"] - logits))))
    if side == "torch":
        import torch

        from dist_keras_tpu_torch.models.keras_adapter import from_keras_json

        res["jax_loaded"] = np.asarray(
            any(k.split(".")[0] in _Refuse.NAMES for k in sys.modules))
        res["params_devices"] = np.asarray(sorted({
            str(p.device) for p in mlp.params["trainable"]
            + bn.params["state"]}))
        # without a card, the default device refuses instead of falling
        # back to the CPU
        try:
            KerasModelAdapter(_keras_model(keras, "mlp"))
            res["default_device"] = np.asarray("no error")
        except RuntimeError as e:
            res["default_device"] = np.asarray(str(e))
        res["cuda_available"] = np.asarray(torch.cuda.is_available())
        # the bf16 cast touches the trainable split only
        cast = bn.cast_params(bn.params, torch.bfloat16)
        res["cast_dtypes"] = np.asarray(
            [str(p.dtype) for p in cast["trainable"] + cast["state"]])
        # weights: the trainables-only form, and a wrong count
        w = mlp.get_weights()
        again = from_keras_json(mlp.to_json(), w[:4], device="cpu")
        res["trainables_only_out"] = host(again(z["x_small"]))
        try:
            again.set_weights(w[:3])
            res["wrong_count"] = np.asarray("no error")
        except ValueError as e:
            res["wrong_count"] = np.asarray(str(e))
    np.savez(out, **res)
    return res


# -- the tests -----------------------------------------------------------

def _run(side, inp, out, env_extra):
    env = dict(os.environ, PYTHONPATH=ROOT, **env_extra)
    if side == "torch":
        env["KERAS_BACKEND"] = "torch"
    else:
        env["KERAS_BACKEND"] = "jax"
        env.setdefault("JAX_PLATFORMS", "cpu")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), side, str(inp),
         str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(out, allow_pickle=False))


def _jax_in_process():
    """True when this process can run the JAX side: Keras loaded (or
    loadable) with the jax backend."""
    if "keras" not in sys.modules:
        os.environ.setdefault("KERAS_BACKEND", "jax")
        if os.environ["KERAS_BACKEND"] != "jax":
            return False
    keras = pytest.importorskip("keras")
    return keras.backend.backend() == "jax"


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    d = tmp_path_factory.mktemp("keras_sides")
    env = {"KERAS_HOME": str(d / "keras_home")}
    x_small = np.random.default_rng(1).normal(size=(4, 8)).astype(
        np.float32)
    np.savez(d / "in.npz", x_small=x_small)
    if _jax_in_process():
        jx = {k: np.asarray(v) for k, v in
              _side("jax", d / "in.npz", d / "jax.npz").items()}
    else:
        jx = _run("jax", d / "in.npz", d / "jax.npz", env)
    np.savez(d / "torch_in.npz", x_small=x_small,
             **{k: v for k, v in jx.items() if k.startswith("ser_")})
    tx = _run("torch", d / "torch_in.npz", d / "torch.npz", env)
    np.savez(d / "rev_in.npz", x_small=x_small,
             **{k: v for k, v in tx.items() if k.startswith("ser_")})
    if _jax_in_process():
        rev = _side("jax-reverse", d / "rev_in.npz", d / "rev.npz")
    else:
        rev = _run("jax-reverse", d / "rev_in.npz", d / "rev.npz", env)
    return {"jax": jx, "torch": tx, "reverse": rev}


def test_the_port_side_ran_on_keras_torch_without_jax(sides):
    t = sides["torch"]
    assert not bool(t["jax_loaded"])
    assert list(t["params_devices"]) == ["cpu"]
    # ModelPredictor rebuilds the trained adapter on its own device
    assert float(t["predictor_err"]) == 0.0


def test_forward_matches_the_jax_adapter(sides):
    got, want = sides["torch"]["fwd"], sides["jax"]["fwd"]
    assert got.shape == want.shape == (4, 2)
    np.testing.assert_allclose(got, want, atol=FWD_TOL, rtol=0)
    assert int(sides["torch"]["count_params"]) == int(
        sides["jax"]["count_params"])


def test_one_sgd_step_of_the_batchnorm_model_matches(sides):
    t, j = sides["torch"], sides["jax"]
    n = int(j["bn_n"])
    assert int(t["bn_n"]) == n == 8   # 6 trainables + 2 moving stats
    for i in range(n):
        np.testing.assert_allclose(t[f"bn_w{i}"], j[f"bn_w{i}"],
                                   atol=STEP_TOL, rtol=0,
                                   err_msg=f"weight {i}")
    moved = np.concatenate([t["bn_w6"].ravel(), t["bn_w7"].ravel()])
    assert not np.allclose(moved, t["bn_init"]), \
        "the moving statistics never updated"


def test_jax_serialized_keras_model_deserializes_in_the_port(sides):
    np.testing.assert_allclose(sides["torch"]["deser_out"],
                               sides["jax"]["fwd"], atol=FWD_TOL, rtol=0)


def test_port_serialized_keras_model_deserializes_in_jax(sides):
    np.testing.assert_allclose(sides["reverse"]["reverse_out"],
                               sides["torch"]["fwd"], atol=FWD_TOL,
                               rtol=0)


@pytest.mark.parametrize("name", sorted(FLOORS))
def test_dropout_seed_state_survives_the_merges(sides, name):
    for side in ("torch", "jax"):
        r = sides[side]
        assert np.isfinite(r[f"{name}_history"]).all(), (side, name)
        assert float(r[f"{name}_acc"]) > FLOORS[name], (
            side, name, float(r[f"{name}_acc"]))
    # the seed-generator state came through as an integer leaf
    assert list(sides["torch"][f"{name}_state_dtypes"]) == ["int32"]


def test_the_default_device_is_the_card_never_a_silent_cpu(sides):
    t = sides["torch"]
    if bool(t["cuda_available"]):
        pytest.skip("a card is present: the default device is cuda")
    assert "pass device='cpu'" in str(t["default_device"])


def test_cast_weights_and_json_round_trip(sides):
    t = sides["torch"]
    assert list(t["cast_dtypes"]) == ["torch.bfloat16"] * 6 + [
        "torch.float32"] * 2
    np.testing.assert_allclose(t["trainables_only_out"], t["fwd"],
                               atol=0, rtol=0)
    assert "got 3 weights" in str(t["wrong_count"])


if __name__ == "__main__":
    _side(sys.argv[1], sys.argv[2], sys.argv[3])
