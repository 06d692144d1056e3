"""dist_keras_tpu_torch — the PyTorch / CUDA port of ``dist_keras_tpu``.

The JAX package beside this one stays the reference; this package mirrors
its module names (``ops/flash_attention.py`` for
``ops/pallas/flash_attention.py``, ``serving/decode.py`` for
``serving/decode.py``, ...) so each counterpart is easy to find.  It
imports ``torch`` and never ``jax`` or ``dist_keras_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without that request they raise.  Every kernel the
JAX package wrote in Pallas is a CUDA C++ kernel under ``csrc/``, built
on first use (``ops/_build.py``), never at import.

Ported so far: decode serving (``POST /generate``) — the causal
transformer, the paged KV allocator, the continuous-batching
``DecodeEngine``, the HTTP ``ServingServer``, and the flash-forward and
paged-decode kernels; and single-card transformer training
(``parallel.make_tp_train_step``) — the flash backward kernels behind
a ``torch.autograd.Function``, adam and sgd with optax's rules; and the
``DK_FUSED_BWD`` one-pass backward with its graduation route, the knob
registry and the event log; and the paper's own training loop —
Keras-style ``Sequential`` models with their layers and zoo
(``models/``), the loss and optimizer registries (``ops/losses.py``,
``ops/optimizers.py``), the train step (``trainers/step.py``), the
chunk runner and ``SingleTrainer`` (``trainers/``), the data path
(``Dataset``, the transformers, the synthetic sets, ``ModelPredictor``
and the evaluators under ``data/``), the NaN sentinel
(``resilience/guards.py``) and the metrics registry; and the
multi-worker trainers on one card — ``DistributedTrainer``, the
windowed DOWNPOUR / ADAG / AEASGD / EAMSGD, ``AveragingTrainer``,
``EnsembleTrainer`` and ``DynSGD`` — with the W workers stacked on one
dimension (``parallel/mesh.py``, ``parallel/collectives.py``,
``comm/backend.py``).  This loop runs PyTorch's own ops (cuBLAS, cuDNN,
elementwise): the JAX package runs it through XLA, with no Pallas
kernel on it.  And the rest of serving: ``ServingEngine`` behind
``POST /predict`` for those models, the decode engine's survivability
(replica kill and replay, deadlines, brownout shedding, self-check,
resize, fault points), with copies of ``resilience/faults.py``,
``world.py`` and ``preemption.py`` and ``observability/spans.py`` and
``perf.py``.  And checkpoints, resume and preemption: ``checkpoint.py``
(atomic and two-phase commits, manifests, the async writer, the
differential and remote tiers, the elastic restore), copies of
``resilience/retry.py``, ``coordination.py``, ``store.py``,
``elastic.py`` and ``supervisor.py``, and every trainer's
``checkpoint_dir`` / ``resume`` / ``handle_preemption``.  And
parameter-server mode (``ps/``): the center-variable server with its
center in numpy on the host, the HTTP client, the delta codec and the
in-process pair (copies of the JAX package's, on the same wire and
checkpoints), ``PSWorkerTrainer`` training its windows on the card, and
the run report (``observability/report.py``).  And the rest: the
serving fabric, the data path, workers across processes, MoE and the
transformer across ranks, the launcher and the simulator, and lastly
the Keras 3 adapter on Keras's torch backend (``models/keras_adapter``)
and dklint over the port's own tree (``analysis/``).
"""

__version__ = "0.1.0"
