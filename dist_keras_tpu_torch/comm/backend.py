"""Communication backend — counterpart of ``comm/backend.py``.

The JAX package brings up a multi-host ``jax.distributed`` group from
the ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID`` environment (what ``launch.Job`` exports per host),
runs its collectives through XLA and fetches sharded arrays across
hosts.  Here the same roles ride a ``torch.distributed`` process group:

- :func:`initialize` brings the group up from its arguments, the
  ``JAX_*`` variables (``host:port`` becomes a ``tcp://`` rendezvous; a
  ``file://`` or ``tcp://`` URL is used as it is) or the ``torchrun``
  ones (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``
  / ``LOCAL_RANK``), and is a no-op with neither, as the JAX one is.
  The group's timeout is ``coordination.default_timeout_s()``
  (``DK_COORD_TIMEOUT_S``), so a dead peer raises instead of hanging.
- A host's identity composes with its cards': with the ``JAX_*``
  variables and ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` both exported (the
  per-card fan-out ``launch/local.py`` under ``launch.Job``), the world
  is ``JAX_NUM_PROCESSES * LOCAL_WORLD_SIZE`` and the rank
  ``JAX_PROCESS_ID * LOCAL_WORLD_SIZE + LOCAL_RANK``, met at the Job's
  coordinator.  Every host must run the same number of ranks: the
  hosts' counts cross the rendezvous store first, and a mismatch is a
  ``ValueError`` naming the hosts, never a hang.
- The backend is a rule (:func:`select_backend`): NCCL when no two
  ranks of the group would share a physical card (each rank's card
  UUID and host name cross the rendezvous store), gloo on the CPU and
  when ranks share a card (NCCL refuses two ranks on one device; two
  emulated hosts on one card each see a local world of 1, so the count
  of cards on a host cannot decide it).  Under gloo the device
  collectives are ``all_reduce`` and ``broadcast`` only (gloo reduces
  CUDA tensors for those two); host-side gathers (:func:`fetch_global`,
  the coordinator's votes, :func:`barrier`) run over a CPU gloo side
  group.  The choice is a ``coord`` event with ``op="comm.init"``.
- :func:`local_data_slice` is the contiguous deal of rows (or worker
  slots) over the processes; :func:`barrier` a real cross-process
  barrier under the JAX package's deadline and poisoning;
  :func:`fetch_global` the all-gather of each leaf along dim 0.
- Several cards on one host: a JAX process sees every device of its
  host, a rank here holds one card, so the port trains one rank per
  card.  Under ``launch.Job`` the host's command is the fan-out
  (``Job(python="python3 -m dist_keras_tpu_torch.launch.local")``),
  which starts a rank per card with ``LOCAL_RANK`` /
  ``LOCAL_WORLD_SIZE`` beside the Job's ``JAX_*`` variables; without
  it, ``torchrun --nproc-per-node N`` exports the ``torchrun`` set.  A
  single process lists every visible card in :func:`local_devices`
  (``ModelPredictor`` shards over them; the trainers use one).
"""

from __future__ import annotations

import datetime
import os
import socket
import time

import numpy as np
import torch

from dist_keras_tpu_torch.utils import knobs
from dist_keras_tpu_torch.utils.pytree import (
    tree_leaves,
    tree_map,
    tree_unflatten,
)

_group = None              # the bring-up's facts, None single-process
_barrier_poisoned = None   # message of the timeout that desynced barriers


class _Group:
    """What :func:`initialize` brought up: this rank's identity, its
    host-local identity, the backend, the rank's device and the CPU
    side group for host gathers."""

    def __init__(self, rank, world, local_rank, local_world, backend,
                 device, cpu_group, devices):
        self.rank, self.world = rank, world
        self.local_rank, self.local_world = local_rank, local_world
        self.backend, self.device = backend, device
        self.cpu_group = cpu_group
        self.devices = devices   # every rank's device, rank-ordered


def select_backend(cards, on_cpu=False):
    """The backend rule over ``cards``, every rank's physical card
    (rank-ordered keys, each host name and card UUID; None for a rank
    without one): ``"nccl"`` when every rank has a card and no two
    share one, ``"gloo"`` on the CPU and when ranks share a card."""
    cards = list(cards)
    if on_cpu or not cards or any(c is None for c in cards) \
            or len(set(cards)) < len(cards):
        return "gloo"
    return "nccl"


def _card_uuid(index):
    """The UUID of visible card ``index`` (a seam: the tests fake it)."""
    return str(torch.cuda.get_device_properties(index).uuid)


def _card_keys(store, rank, world, index, timeout_s):
    """-> every rank's card key (``host/uuid``, or None without a card),
    rank-ordered, through the rendezvous store; ``index`` is the visible
    card this rank would take, None on the CPU."""
    mine = ("-" if index is None
            else f"{socket.gethostname()}/{_card_uuid(index)}")
    store.set(f"dk_card/{rank}", mine)
    store.wait([f"dk_card/{r}" for r in range(world)],
               datetime.timedelta(seconds=timeout_s))
    keys = [store.get(f"dk_card/{r}").decode() for r in range(world)]
    return [None if k == "-" else k for k in keys]


def _local_slot():
    """-> (LOCAL_RANK, LOCAL_WORLD_SIZE) when both are exported, else
    None."""
    env = os.environ
    if env.get("LOCAL_RANK") is None or env.get("LOCAL_WORLD_SIZE") is None:
        return None
    local_rank, local_world = int(env["LOCAL_RANK"]), \
        int(env["LOCAL_WORLD_SIZE"])
    if not 0 <= local_rank < local_world:
        raise ValueError(f"LOCAL_RANK={local_rank} outside "
                         f"LOCAL_WORLD_SIZE={local_world}")
    return local_rank, local_world


def _composed():
    """-> (host id, hosts, local rank, local world) when the ``JAX_*``
    process variables and ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` are all
    exported (a rank of the per-card fan-out), else None."""
    env = os.environ
    slot = _local_slot()
    if slot is None or not env.get("JAX_NUM_PROCESSES") \
            or not env.get("JAX_PROCESS_ID"):
        return None
    return (int(env["JAX_PROCESS_ID"]), int(env["JAX_NUM_PROCESSES"]),
            *slot)


def _init_method(address):
    if "://" in address:
        return address
    return f"tcp://{address}"


def _rendezvous_from(coordinator_address, num_processes, process_id):
    """-> (init_method, world, rank), or None when nothing asks for a
    group (arguments, the ``JAX_*`` variables, then the torchrun ones).
    The ``JAX_*`` variables beside ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``
    compose: world = hosts x local world, rank = host x local world +
    local rank.  A world of several processes without the rest of its
    rendezvous is a ValueError, never a lone process."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS") or None
    if num_processes is None and env.get("JAX_NUM_PROCESSES"):
        num_processes = int(env["JAX_NUM_PROCESSES"])
    if process_id is None and env.get("JAX_PROCESS_ID"):
        process_id = int(env["JAX_PROCESS_ID"])
    composed = _composed()
    if composed is not None and num_processes == composed[1] \
            and process_id == composed[0]:
        # a rank of the per-card fan-out: hosts x cards
        host, hosts, local_rank, local_world = composed
        num_processes = hosts * local_world
        process_id = host * local_world + local_rank
    if coordinator_address is not None or num_processes is not None:
        world = 1 if num_processes is None else int(num_processes)
        if coordinator_address is None:
            if world > 1:
                raise ValueError(
                    f"num_processes={world} without a coordinator "
                    "address: pass coordinator_address= or export "
                    "JAX_COORDINATOR_ADDRESS (host:port or a file:// URL)")
            return None
        if process_id is None:
            raise ValueError(
                f"coordinator {coordinator_address!r} without this "
                "process's id: pass process_id= or export JAX_PROCESS_ID")
        return _init_method(coordinator_address), world, int(process_id)
    torchrun = {k: env.get(k) or None for k in
                ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    world = int(torchrun["WORLD_SIZE"] or 1)
    rank = int(torchrun["RANK"] or 0)
    if world <= 1 and rank == 0:
        return None
    missing = [k for k, v in torchrun.items() if v is None]
    if missing:
        raise ValueError(
            f"WORLD_SIZE={world}, RANK={rank} without "
            f"{', '.join(missing)}: export all four torchrun variables "
            "(or the JAX_* ones) to train across processes")
    return "env://", world, rank


def _host_identity(store, rank, world, timeout_s):
    """-> (local_rank, local_world): the ranks sharing this host, from
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` when torchrun exports them,
    else by exchanging host names through the rendezvous store."""
    env = os.environ
    if env.get("LOCAL_RANK") is not None \
            and env.get("LOCAL_WORLD_SIZE") is not None:
        return int(env["LOCAL_RANK"]), int(env["LOCAL_WORLD_SIZE"])
    store.set(f"dk_host/{rank}", socket.gethostname())
    store.wait([f"dk_host/{r}" for r in range(world)],
               datetime.timedelta(seconds=timeout_s))
    hosts = [store.get(f"dk_host/{r}").decode() for r in range(world)]
    mine = [r for r in range(world) if hosts[r] == hosts[rank]]
    return mine.index(rank), len(mine)


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None, device=None, **kw):
    """Bring up the process group (a no-op single-process, and when the
    group is up already).

    ``coordinator_address`` is ``host:port`` (a ``tcp://`` rendezvous)
    or a ``file://`` / ``tcp://`` URL; with no arguments the ``JAX_*``
    variables, then the torchrun ones, are read.  ``backend`` overrides
    :func:`select_backend`; ``device="cpu"`` asks for ranks on the CPU
    (gloo).  ``kw`` goes to ``init_process_group``."""
    global _group
    if _group is not None:
        return
    import torch.distributed as dist

    if dist.is_initialized():  # brought up by the caller: adopt it
        _adopt(dist, backend=dist.get_backend(), device=device, t0=None)
        return
    rdv = _rendezvous_from(coordinator_address, num_processes, process_id)
    if rdv is None or rdv[1] <= 1:
        return
    from dist_keras_tpu_torch.resilience.coordination import (
        default_timeout_s,
    )

    init_method, world, rank = rdv
    timeout_s = default_timeout_s() or 1800.0
    t0 = time.perf_counter()
    composed = _composed()
    if composed is not None and world == composed[1] * composed[3]:
        store = _fan_out_store(init_method, rank, world, composed,
                               timeout_s)
    else:
        store, rank, world = next(dist.rendezvous(
            init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s)))
    local_rank, local_world = _host_identity(store, rank, world, timeout_s)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    index = None if on_cpu or count < 1 else local_rank % count
    cards = _card_keys(store, rank, world, index, timeout_s)
    chosen = backend or select_backend(cards, on_cpu)
    if chosen == "nccl":
        torch.cuda.set_device(index)
    dist.init_process_group(
        chosen, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _adopt(dist, backend=chosen, device=device, t0=t0,
           local=(local_rank, local_world))


def _fan_out_store(init_method, rank, world, composed, timeout_s):
    """The rendezvous store of a fan-out rank (``init_method`` a
    ``tcp://`` or ``file://`` URL; host 0's local rank 0 serves a TCP
    store), after every host's local world has crossed it: hosts that
    disagree are a ValueError naming them (a store sized by one host's
    world would wait for ranks that never come)."""
    import urllib.parse

    import torch.distributed as dist

    host, hosts, local_rank, local_world = composed
    timeout = datetime.timedelta(seconds=timeout_s)
    url = urllib.parse.urlparse(init_method)
    if url.scheme == "tcp":
        store = dist.TCPStore(url.hostname, url.port, None,
                              rank == 0, timeout, wait_for_workers=False)
    elif url.scheme == "file":
        store = dist.FileStore(url.path, world)
    else:
        raise ValueError(f"rendezvous {init_method!r}: a fan-out rank meets "
                         "at a tcp:// or file:// address")
    if local_rank == 0:
        store.set(f"dk_local_world/{host}", str(local_world))
    store.wait([f"dk_local_world/{h}" for h in range(hosts)], timeout)
    counts = [int(store.get(f"dk_local_world/{h}")) for h in range(hosts)]
    if len(set(counts)) > 1:
        raise ValueError(
            "the hosts run different numbers of ranks (LOCAL_WORLD_SIZE): "
            + ", ".join(f"host {h} {n}" for h, n in enumerate(counts))
            + "; start the same number on every host (--nproc-per-host)")
    return store


def _adopt(dist, backend, device, t0, local=None):
    """Record an initialised default group (ours or the caller's): the
    rank's device, the CPU side group, every rank's device; emit the
    ``comm.init`` event."""
    global _group
    from dist_keras_tpu_torch.observability import events

    rank, world = dist.get_rank(), dist.get_world_size()
    if local is None:
        env = os.environ
        local = (int(env.get("LOCAL_RANK", rank)),
                 int(env.get("LOCAL_WORLD_SIZE", world)))
    local_rank, local_world = local
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    elif backend == "nccl":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    elif torch.cuda.is_available():
        # ranks share the cards round-robin (one card: all on cuda:0)
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    else:
        dev = torch.device("cpu")
    cpu_group = dist.new_group(backend="gloo")
    names = [None] * world
    dist.all_gather_object(names, str(dev), group=cpu_group)
    _group = _Group(rank, world, local_rank, local_world, backend, dev,
                    cpu_group, [torch.device(n) for n in names])
    events.emit("coord", op="comm.init", world=world, process=rank,
                local_rank=local_rank, local_world=local_world,
                backend=backend, device=str(dev),
                duration_s=(time.perf_counter() - t0) if t0 else 0.0)


def shutdown():
    """Tear the group down (the side group with it); the process is
    single-process again."""
    global _group, _barrier_poisoned
    if _group is None:
        return
    import torch.distributed as dist

    _group = None
    _barrier_poisoned = None
    if dist.is_initialized():
        dist.destroy_process_group()


def group_info():
    """-> the bring-up's :class:`_Group` (rank, world, backend, device,
    ...), or None single-process."""
    return _group


def rank_device():
    """The device this rank runs on (``cuda:LOCAL_RANK`` under NCCL,
    the shared card under gloo), or None single-process."""
    return None if _group is None else _group.device


def num_processes():
    return 1 if _group is None else _group.world


def process_index():
    return 0 if _group is None else _group.rank


def is_multi_host():
    return _group is not None and _group.world > 1


def local_devices():
    """This process's devices, as ``jax.local_devices()``: under a
    process group the rank's one device; single-process every visible
    card, or the CPU alone on a host without one."""
    if _group is not None:
        return [_group.device]
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def global_devices():
    """Every process's device, rank-ordered."""
    return list(_group.devices) if _group is not None else local_devices()


def local_data_slice(n_rows, process=None, count=None):
    """Row range [start, stop) a process loads from a global dataset of
    ``n_rows`` (contiguous split, the dealing order of
    ``Dataset.worker_shards``; the last process takes the remainder)."""
    process = process_index() if process is None else process
    count = num_processes() if count is None else count
    per = n_rows // count
    start = process * per
    stop = n_rows if process == count - 1 else start + per
    return start, stop


def barrier_default_timeout_s():
    """The barrier deadline when a caller passes ``timeout_s=None``:
    ``coordination.default_timeout_s()`` (``DK_COORD_TIMEOUT_S``, re-read
    per call); 0.0 means no deadline."""
    from dist_keras_tpu_torch.resilience.coordination import (
        default_timeout_s,
    )

    return default_timeout_s()


def barrier(tag="dist_keras_tpu_barrier", timeout_s=None):
    """Block until every process reaches this point (this process's
    queued card work done first); -> the number of processes.

    Across processes the wait runs over the CPU side group under a
    deadline (``timeout_s``, default :func:`barrier_default_timeout_s`;
    0 opts out): a dead peer raises ``coordination.PeerLost`` (when
    heartbeat files under ``DK_COORD_DIR`` name the dark rank) or
    ``BarrierTimeout``, and every later barrier raises
    ``CoordinatorPoisoned`` — the abandoned barrier may still complete
    on the peers, so this process's place in the barrier stream is
    unknowable.  Each barrier is a ``barrier`` event."""
    global _barrier_poisoned
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    if not is_multi_host():
        return 1
    import torch.distributed as dist

    from dist_keras_tpu_torch.observability import events
    from dist_keras_tpu_torch.resilience import coordination

    if timeout_s is None:
        timeout_s = barrier_default_timeout_s()
    if _barrier_poisoned:
        raise coordination.CoordinatorPoisoned(
            "comm.barrier is poisoned: a previous timed barrier gave up "
            f"({_barrier_poisoned}) and this process's position in the "
            "collective stream is unknowable — restart the process "
            "instead of retrying barriers")
    group = _group

    def probe():
        d = knobs.raw("DK_COORD_DIR")
        if not d:
            return []
        return coordination.dead_peers_at(d, group.world, require_file=True)

    t0 = time.perf_counter()
    try:
        coordination.collective_with_deadline(
            lambda: dist.barrier(group=group.cpu_group), timeout_s,
            f"barrier({tag!r})", probe)
    except (coordination.PeerLost, coordination.BarrierTimeout) as e:
        _barrier_poisoned = str(e)
        events.emit("barrier", tag=tag,
                    duration_s=time.perf_counter() - t0,
                    error=type(e).__name__)
        raise
    events.emit("barrier", tag=tag, duration_s=time.perf_counter() - t0,
                n_devices=group.world)
    return group.world


def _to_host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def fetch_global(tree):
    """Device tree -> the same tree of host arrays, holding every
    process's rows: each leaf is all-gathered along dim 0 across the
    ranks (``process_allgather(tiled=True)``'s meaning; leading sizes
    may differ, trailing shapes must not; a 0-d leaf gathers to
    ``(world,)``).  Single-process, the leaves are copied to the host.
    bf16 leaves come back as CPU tensors (numpy has no bf16)."""
    host = tree_map(_to_host, tree)
    if not is_multi_host():
        return host
    import torch.distributed as dist

    leaves = [x.reshape(1) if x.ndim == 0 else x for x in tree_leaves(host)]
    every = [None] * _group.world
    dist.all_gather_object(every, leaves, group=_group.cpu_group)
    return tree_unflatten(host, [
        torch.cat(parts) if isinstance(parts[0], torch.Tensor)
        else np.concatenate(parts) for parts in zip(*every)])
