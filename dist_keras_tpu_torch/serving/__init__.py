"""Online serving: the fixed-shape ``ServingEngine`` behind
``POST /predict``, the continuous-batching ``DecodeEngine`` over a paged
KV cache behind ``POST /generate`` (with replica kill and replay,
deadlines and brownout shedding), and their HTTP front end.  The
router, hot-reload watcher and autoscaler are not ported yet (ROADMAP
queue 1, item 6)."""

from dist_keras_tpu_torch.serving.decode import DecodeEngine, Generation
from dist_keras_tpu_torch.serving.engine import Overloaded, ServingEngine
from dist_keras_tpu_torch.serving.kv_cache import PagedKVCache, PagesExhausted
from dist_keras_tpu_torch.serving.server import ServingServer, default_port

__all__ = ["ServingEngine", "Overloaded", "ServingServer", "default_port",
           "DecodeEngine", "Generation", "PagedKVCache",
           "PagesExhausted"]
