"""NCCL's pair rule for point-to-point messages, held on the CPU.

PyTorch's NCCL group runs every send and receive between two ranks on
one stream, in posting order, whatever the tag, so two ranks must post
the ops between them in mirrored order.  ``collectives.check_mirror``
holds recorded logs to that rule; here it is fed constructed logs (a
crossing pair of sends, a swapped pair of messages, batches), and then
the logs of the real 1F1B and interleaved 1F1B engines, every stage run
in this process over a stand-in transport that records each posted op
and hands back zeros, over a sweep of stages, microbatches and chunks:
on the pipeline's per-direction links the rule holds, and on one group
a pair it would cross is caught.  The gloo launches of
``tests/test_torch_tp_fsdp_pp_multiprocess.py`` record the real
messages of GPipe, 1F1B and ``make_pp_train_step`` across processes."""

import collections

import pytest
import torch

from dist_keras_tpu_torch.parallel import collectives
from dist_keras_tpu_torch.parallel import pipeline as pp
from dist_keras_tpu_torch.parallel.mesh import RankAxis


def op(kind, peer, tag, shape=(2, 4), group="0", ranks=(0, 1)):
    return {"op": kind, "peer": peer, "shape": tuple(shape),
            "dtype": "float32", "tag": tag, "group": group, "ranks": ranks}


def batch(ops, group="0", ranks=(0, 1)):
    return {"op": "batch", "ops": ops, "group": group, "ranks": ranks}


def test_mirrored_ops_pass():
    logs = {0: [op("send", 1, 17), op("recv", 1, 18)],
            1: [op("recv", 0, 17), op("send", 0, 18)]}
    res = collectives.check_mirror(logs)
    assert res == {"pairs": 1, "ops": 4, "batches": 0, "problems": []}
    # a list indexed by rank reads the same
    assert collectives.check_mirror([logs[0], logs[1]]) == res


def test_a_crossing_pair_of_sends_is_named():
    """1F1B's stage 0 posting its second activation while stage 1 posts
    its first cotangent, on one group: NCCL hangs there."""
    logs = {0: [op("send", 1, 16), op("send", 1, 18), op("recv", 1, 17)],
            1: [op("recv", 0, 16), op("send", 0, 17), op("recv", 0, 18)]}
    (problem,) = collectives.check_mirror(logs)["problems"]
    assert "ranks 0 <-> 1, unit 1: two sends cross" in problem
    assert "rank 0 send [2, 4] float32 tag 18" in problem
    assert "rank 1 send [2, 4] float32 tag 17" in problem


def test_a_swapped_pair_of_messages_is_named():
    """Two microbatches' messages received in the other order: NCCL would
    hand each to the other's receive (same shapes) without a word."""
    logs = {0: [op("send", 1, 16), op("send", 1, 18)],
            1: [op("recv", 0, 18), op("recv", 0, 16)]}
    (problem,) = collectives.check_mirror(logs)["problems"]
    assert "ranks 0 <-> 1, unit 0: the units do not mirror" in problem
    assert "rank 0 send [2, 4] float32 tag 16" in problem
    assert "rank 1 recv [2, 4] float32 tag 18" in problem


@pytest.mark.parametrize("logs,words", [
    ({0: [op("send", 1, 16, shape=(2, 4))],
      1: [op("recv", 0, 16, shape=(4, 2))]}, "do not mirror"),
    ({0: [op("recv", 1, 16)], 1: [op("recv", 0, 16)]}, "two recvs cross"),
    ({0: [op("send", 1, 16), op("send", 1, 18)], 1: [op("recv", 0, 16)]},
     "rank 0 posts 2 units towards 1, rank 1 1 towards 0; unit 1"),
    ({0: [batch([op("send", 1, 0), op("recv", 1, 0)])],
      1: [op("recv", 0, 0), op("send", 0, 0)]}, "unit 0: the units do not"),
], ids=["shape", "two_recvs", "unmatched_tail", "batch_against_ops"])
def test_other_breaks_are_named(logs, words):
    problems = collectives.check_mirror(logs)["problems"]
    assert problems and words in problems[0]


def test_a_mirrored_batch_passes_and_a_lopsided_one_fails():
    """The ring's shift: one ``batch_isend_irecv`` a rank; a batch meets a
    batch whose sends are its receives."""
    ring = {r: [batch([op("send", (r + 1) % 3, 0, ranks=(0, 1, 2)),
                       op("recv", (r - 1) % 3, 0, ranks=(0, 1, 2))],
                      ranks=(0, 1, 2))] for r in range(3)}
    res = collectives.check_mirror(ring)
    assert res["problems"] == [] and res["batches"] == 3
    assert res["pairs"] == 3 and res["ops"] == 6
    two = {0: [batch([op("send", 1, 0), op("recv", 1, 0)])],
           1: [batch([op("recv", 0, 0), op("send", 0, 0)])]}
    assert collectives.check_mirror(two)["problems"] == []
    two[1][0]["ops"][1]["shape"] = (3, 4)
    (problem,) = collectives.check_mirror(two)["problems"]
    assert "unit 0: the units do not mirror" in problem


def test_a_first_batch_must_involve_every_rank_of_its_group():
    ranks = (0, 1, 2)
    logs = {0: [batch([op("send", 1, 0, ranks=ranks)], ranks=ranks)],
            1: [batch([op("recv", 0, 0, ranks=ranks)], ranks=ranks)],
            2: []}
    (problem,) = collectives.check_mirror(logs)["problems"]
    assert "group 0" in problem and "[2]" in problem


def test_groups_are_separate_streams():
    """Two sends crossing on two groups (a group per direction) pass."""
    logs = {0: [op("send", 1, 16, group="a"), op("send", 1, 18, group="a"),
                op("recv", 1, 17, group="b")],
            1: [op("recv", 0, 16, group="a"), op("send", 0, 17, group="b"),
                op("recv", 0, 18, group="a")]}
    res = collectives.check_mirror(logs)
    assert res["problems"] == [] and res["pairs"] == 2


def test_the_recorder_is_off_by_default():
    collectives.record_p2p(False)
    assert collectives.p2p_log() == []
    collectives._record([("send", 1, torch.zeros(2), 0)], None)
    assert collectives.p2p_log() == []


# ---------------------------------------------------------------------------
# the 1F1B engines' posting order, every stage in this process
# ---------------------------------------------------------------------------
class _Posted:
    def done(self):
        return True

    def wait(self):
        pass


def _stand_in(monkeypatch, one_group):
    """Replace the transport under ``pipeline``: each op is appended to
    ``logs[stage]`` as ``collectives._record`` would log it; a receive
    returns zeros.  ``one_group``: every message on the axis's group,
    as before the links."""
    logs = collections.defaultdict(list)
    where = {}

    def links(axis):
        if one_group:
            return collections.defaultdict(lambda: "axis")
        p = axis.size
        return {(i, j): f"{i}->{j}" for i in range(p)
                for j in {(i + 1) % p, (i - 1) % p} - {i}}

    def isend(x, axis, to, tag=0, group=None):
        logs[where["s"]].append(op("send", to, tag, x.shape, group))
        return _Posted()

    def recv(shape, dtype, device, axis, frm, tag=0, group=None):
        logs[where["s"]].append(op("recv", frm, tag, shape, group))
        return torch.zeros(shape, dtype=dtype)

    monkeypatch.setattr(pp, "_links", links)
    monkeypatch.setattr(collectives, "isend", isend)
    monkeypatch.setattr(collectives, "recv", recv)
    monkeypatch.setattr(collectives, "cross_rank_sum", lambda t, axis: t)
    return logs, where


def _run_stages(p, m, v, logs, where):
    """Each stage's 1F1B (v = 1) or interleaved 1F1B over a stand-in
    transport; -> the logs."""

    def stage_fn(w, h):
        return h * w, torch.zeros(())

    def last_fn(h, mi):
        return h.sum(), torch.ones_like(h), {"b": torch.zeros(1)}

    def first_fn(dh, mi):
        return {"e": dh.sum()[None]}

    like = {"extras_like": {"b": torch.zeros(1)},
            "first_extras_like": {"e": torch.zeros(1)}}
    h = torch.ones(2 * m, 3)
    for s in range(p):
        where["s"] = s
        axis = RankAxis("stages", p, s)
        if v == 1:
            pp.pipeline_1f1b(stage_fn, torch.ones(()), h, m, last_fn, axis,
                             first_fn=first_fn, **like)
        else:
            pp.pipeline_interleaved_1f1b(stage_fn, torch.ones(v), h, m, v,
                                         last_fn, axis, first_fn=first_fn,
                                         **like)
    return dict(logs)


SCHEDULES = ([(p, m, 1) for p in (2, 3, 4) for m in (1, 2, 3, 8)]
             + [(p, m, v) for p in (2, 3, 4) for v in (2, 3)
                for m in (p, 2 * p)])


@pytest.mark.parametrize("p,m,v", SCHEDULES,
                         ids=[f"p{p}_m{m}_v{v}" for p, m, v in SCHEDULES])
def test_the_1f1b_engines_keep_the_pair_rule(monkeypatch, p, m, v):
    """On the per-direction links every pair of stages posts in mirrored
    order: each link carries one direction, and both ends post it in
    the schedules' tick order.  On one group (before the links) the
    same engines cross two sends wherever more than one microbatch is
    in flight."""
    logs, where = _stand_in(monkeypatch, one_group=False)
    res = collectives.check_mirror(_run_stages(p, m, v, logs, where))
    assert res["problems"] == []
    sends = sum(e["op"] == "send" for es in logs.values() for e in es)
    # every microbatch's activation crosses each of the v*p - 1 chunk
    # boundaries, and its cotangent crosses them back
    assert sends == res["ops"] // 2 == 2 * m * (v * p - 1)
    assert res["pairs"] == (2 * (p - 1) if v == 1 or p == 2 else 2 * p)
    logs, where = _stand_in(monkeypatch, one_group=True)
    res = collectives.check_mirror(_run_stages(p, m, v, logs, where))
    if m > 1:
        assert any("two sends cross" in e for e in res["problems"])
    else:
        assert res["problems"] == []


@pytest.mark.parametrize("sizes,links", [
    ({"stages": 4}, {(0, 1), (1, 0), (1, 2), (2, 1), (2, 3), (3, 2),
                     (3, 0), (0, 3)}),
    ({"workers": 2, "stages": 2}, {(0, 1), (1, 0)}),
], ids=["stages4", "dp2_stages2"])
def test_the_mesh_creates_the_stage_links_at_its_setup(monkeypatch, sizes,
                                                       links):
    """``grid_mesh`` creates the stages axis' per-direction groups when
    the mesh is built, every line's on every rank in one order, with no
    collective of its own; an engine only reads them from the axis."""
    import torch.distributed as dist

    from dist_keras_tpu_torch.comm import backend as comm
    from dist_keras_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(tmesh, "_MESH_CACHE", {})
    made = {}
    for rank in range(4):
        calls = []
        monkeypatch.setattr(comm, "num_processes", lambda: 4)
        monkeypatch.setattr(comm, "process_index", lambda r=rank: r)
        monkeypatch.setattr(comm, "group_info", lambda r=rank: ("g", r))
        monkeypatch.setattr(dist, "new_group",
                            lambda ranks: calls.append(tuple(ranks))
                            or tuple(ranks))
        mesh = tmesh.grid_mesh(sizes)
        stages = mesh.stages
        assert set(stages.links) == links
        line = [r for r in range(4)
                if r // stages.size == rank // stages.size]
        for (i, j), g in stages.links.items():
            assert g == (line[i], line[j])
        assert mesh.workers.links is None
        assert pp._links(stages) is stages.links
        made[rank] = calls
        # asked again, the cached grid creates none
        assert tmesh.grid_mesh(sizes) is mesh and len(calls) == len(made[rank])
    # every rank created every group, in one order
    assert all(calls == made[0] for calls in made.values())


def test_an_engine_refuses_a_stages_axis_without_links():
    """A stages axis of several ranks built without its links raises
    before any message is posted."""

    def stage_fn(w, h):
        return h * w

    axis = RankAxis("stages", 2, 0)
    with pytest.raises(ValueError, match="no per-direction links"):
        pp.gpipe_apply(stage_fn, torch.ones(()), torch.ones(4, 3), 2,
                       axis=axis)
    assert pp._PENDING == []
    assert collectives.p2p_log() == []
