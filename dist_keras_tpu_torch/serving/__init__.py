"""Online serving: the fixed-shape ``ServingEngine`` behind
``POST /predict``, the continuous-batching ``DecodeEngine`` over a paged
KV cache behind ``POST /generate`` (with replica kill and replay,
deadlines and brownout shedding), their HTTP front end, and the serving
fabric: :class:`RouterServer` over many backends (:class:`BackendPool`
is its HTTP-free policy core), :class:`BlueGreenEngine` and
:class:`CheckpointWatcher` for hot reload as one atomic cutover, and
:class:`ReplicaAutoscaler`.  ``python -m dist_keras_tpu_torch.serving.bench``
is the offered-load benchmark."""

from dist_keras_tpu_torch.serving.autoscale import ReplicaAutoscaler
from dist_keras_tpu_torch.serving.decode import DecodeEngine, Generation
from dist_keras_tpu_torch.serving.engine import Overloaded, ServingEngine
from dist_keras_tpu_torch.serving.kv_cache import PagedKVCache, PagesExhausted
from dist_keras_tpu_torch.serving.reload import (
    BlueGreenEngine,
    CheckpointWatcher,
)
from dist_keras_tpu_torch.serving.router import (
    BackendPool,
    ForwardError,
    NoBackends,
    RouterServer,
    default_route_port,
)
from dist_keras_tpu_torch.serving.server import ServingServer, default_port

__all__ = ["ServingEngine", "Overloaded", "CheckpointWatcher",
           "ServingServer", "default_port",
           "RouterServer", "BackendPool", "ForwardError", "NoBackends",
           "BlueGreenEngine", "ReplicaAutoscaler",
           "default_route_port",
           "DecodeEngine", "Generation", "PagedKVCache",
           "PagesExhausted"]
