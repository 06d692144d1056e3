"""The port's launcher (``dist_keras_tpu_torch.launch``) against the JAX
package's.

- Parity: every argument set of the JAX launch tests
  (``tests/test_aux.py``, ``test_resilience.py``, ``test_coordination.py``,
  ``test_observability.py``, ``test_self_healing.py``, ``test_elastic.py``,
  ``test_ps.py``, ``test_serving.py``, ``test_tracing.py``,
  ``test_multihost.py``) goes to both packages' ``Job`` / ``JobConfig`` /
  ``Punchcard`` / CLI, each in a directory of its own with the same
  layout.  What each case observes must be equal: the command lists, the
  ``host_env`` dicts, ``supervise_run``'s waves, the typed errors and
  their messages (paths and the package name normalised).
- One real local run on the CPU: ``Job`` behind ``chip_smoke.py``'s
  local transport (phase 19a's: ssh becomes ``sh -c`` in a host
  directory, rsync a copy) starts two port
  processes on the CPU, which form a gloo group from ``host_env``'s
  ``JAX_*`` variables and train ADAG 2 + 2 with a checkpoint every
  window and ``resume=True``.  Rank 1 SIGKILLs itself once after the
  first promoted save; ``supervise_run`` relaunches the pod once and the
  resumed run ends with the params of an unkilled run, bit for bit.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

import dist_keras_tpu.launch.__main__ as jax_cli
import dist_keras_tpu.launch.config as jax_config
import dist_keras_tpu.launch.job as jax_job
import dist_keras_tpu.observability.events as jax_events
import dist_keras_tpu.resilience.coordination as jax_coordination
import dist_keras_tpu.resilience.faults as jax_faults
import dist_keras_tpu.resilience.supervisor as jax_supervisor
import dist_keras_tpu_torch.launch.__main__ as port_cli
import dist_keras_tpu_torch.launch.config as port_config
import dist_keras_tpu_torch.launch.job as port_job
import dist_keras_tpu_torch.observability.events as port_events
import dist_keras_tpu_torch.resilience.coordination as port_coordination
import dist_keras_tpu_torch.resilience.faults as port_faults
import dist_keras_tpu_torch.resilience.supervisor as port_supervisor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the local transport of phase 19a)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PACKAGES = {
    "jax": types.SimpleNamespace(
        Job=jax_job.Job, Punchcard=jax_job.Punchcard,
        JobConfig=jax_config.JobConfig, main=jax_cli.main,
        faults=jax_faults, Heartbeat=jax_coordination.Heartbeat,
        CrashLoop=jax_supervisor.CrashLoop, events=jax_events),
    "port": types.SimpleNamespace(
        Job=port_job.Job, Punchcard=port_job.Punchcard,
        JobConfig=port_config.JobConfig, main=port_cli.main,
        faults=port_faults, Heartbeat=port_coordination.Heartbeat,
        CrashLoop=port_supervisor.CrashLoop, events=port_events),
}
SUP = {"max_restarts": 3, "grace_s": 0.0, "interval_s": 0.0}
TRACE = "ab" * 16


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in PACKAGES.values():
        pkg.faults.clear()
    yield
    for pkg in PACKAGES.values():
        pkg.faults.clear()


def _jobdir(root):
    jd = root / "jobdir"
    jd.mkdir(exist_ok=True)
    (jd / "main.py").write_text("print('hi')")
    return jd


def _job(pkg, root, *, quiet=True, **kw):
    kw.setdefault("hosts", ["h0", "h1"])
    kw.setdefault("dry_run", True)
    kw.setdefault("trace_id", TRACE)
    job = pkg.Job("s", "j1", str(_jobdir(root)), **kw)
    if quiet:
        job.retry_policy.sleep = lambda s: None
        job.launch_retry_policy.sleep = lambda s: None
    return job


def _cmds(job):
    return [list(c) for c in job.commands]


def _error(fn):
    """-> (type name, message) of what ``fn`` raises, or its value."""
    try:
        return ("ok", fn())
    except Exception as e:  # the parity compares the typed errors
        return (type(e).__name__, str(e))


def _stale(root, rank):
    old = time.time() - 3600
    os.utime(root / "hb" / f"rank_{rank}", (old, old))


# -- the cases: each takes a package and its own root, -> what it saw --


def case_send_two_hosts(pkg, root):
    job = pkg.Job("s3cret", "exp1", str(_jobdir(root)),
                  hosts=["tpu-host-0", "tpu-host-1"], dry_run=True,
                  trace_id=TRACE)
    return {"rc": job.send(), "cmds": _cmds(job),
            "env": [job.host_env(0), job.host_env(1)]}


def case_punchcard_secret_auth(pkg, root):
    jd = _jobdir(root)
    (root / "m.json").write_text(json.dumps([
        {"secret": "good", "job_name": "a", "job_dir": str(jd),
         "hosts": ["h0"], "trace_id": TRACE},
        {"secret": "evil", "job_name": "b", "job_dir": str(jd),
         "hosts": ["h0"], "trace_id": TRACE}]))
    pc = pkg.Punchcard(str(root / "m.json"), secrets=["good"], dry_run=True)
    ran = pc.run_once()
    return {"ran": [(j.job_name, j.last_rc, _cmds(j)) for j in ran],
            "again": [j.job_name for j in pc.run_once()]}


def case_unsafe_names(pkg, root):
    jd = str(_jobdir(root))
    out = [_error(lambda: pkg.Job("s", "bad;rm -rf /", jd, hosts=["h"],
                                  dry_run=True)),
           _error(lambda: pkg.Job("s", "ok", jd, hosts=["h"], dry_run=True,
                                  remote_root="~/jobs;evil")),
           _error(lambda: pkg.Job("s", "ok", jd, hosts=["-oProxy=x"],
                                  dry_run=True))]
    job = pkg.Job("s", "ok-name_1", jd, hosts=["h"], dry_run=True,
                  trace_id=TRACE)
    return {"errors": out, "rc": job.send(), "cmds": _cmds(job)}


def case_job_config_validation(pkg, root):
    jd = str(_jobdir(root))
    cfg = pkg.JobConfig.from_dict({"job_name": "exp1", "job_dir": jd,
                                   "hosts": ["h0", "h1"],
                                   "trace_id": TRACE})
    job = cfg.to_job(dry_run=True)
    bad = [{"job_name": "a", "job_dir": ".", "hostz": ["h"]},
           {"job_name": "a"},
           {"job_name": "a", "job_dir": ".", "hosts": "localhost"},
           {"job_name": "a", "job_dir": ".", "hosts": ["h"],
            "coordinator_port": "8476"},
           {"job_name": "j", "job_dir": jd, "obs_dir": 7},
           {"job_name": "x", "job_dir": jd, "serve_port": "9000"},
           {"job_name": "x", "job_dir": jd, "supervise": "yes"},
           {"job_name": "x", "job_dir": jd, "retries": True},
           {"job_name": "x", "job_dir": jd, "hosts": [1, 2]}]
    return {"cfg": cfg.to_dict(), "rc": job.send(), "cmds": _cmds(job),
            "round_trip": pkg.JobConfig.from_dict(cfg.to_dict()) == cfg,
            "errors": [_error(lambda d=d: pkg.JobConfig.from_dict(d))
                       for d in bad]}


def case_job_config_json_fields(pkg, root):
    """One JSON file with every field, loaded by both packages."""
    jd = str(_jobdir(root))
    doc = {"job_name": "j", "job_dir": jd, "secret": "s",
           "entrypoint": "train.py", "hosts": ["h0", "h1"],
           "coordinator_port": 9100, "num_processes": 2,
           "remote_root": "~/jobs", "python": "python3 -u", "retries": 5,
           "retry_backoff": 0.1, "launch_retries": 1,
           "coord_dir": "/shared/coord", "coord_timeout_s": 30,
           "obs_dir": "/scratch/obs", "serve_port": 9000,
           "metrics_port": 9400, "obs_sample_s": 0.5,
           "ps_addr": "1.2.3.4:5", "ps_window": 8, "trace_id": TRACE,
           "supervise": {"max_restarts": 1}}
    path = root / "job.json"
    path.write_text(json.dumps(doc))
    cfg = pkg.JobConfig.from_json(str(path))
    job = cfg.to_job(dry_run=True)
    return {"cfg": cfg.to_dict(), "attempts": job.retry_policy.attempts,
            "launch_attempts": job.launch_retry_policy.attempts,
            "supervise": job.supervise, "rc": job.send(),
            "cmds": _cmds(job), "env": job.host_env(1, session=2)}


def case_cli_job_dry_run(pkg, root):
    jd = _jobdir(root)
    (root / "job.json").write_text(json.dumps(
        {"job_name": "exp1", "job_dir": str(jd), "secret": "s",
         "hosts": ["tpu-host-0", "tpu-host-1"], "trace_id": TRACE}))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pkg.main(["--job", str(root / "job.json"), "--dry-run"])
    return {"rc": rc, "out": out.getvalue()}


def case_cli_manifest(pkg, root):
    jd = _jobdir(root)
    (root / "m.json").write_text(json.dumps([
        {"secret": "good", "job_name": "a", "job_dir": str(jd),
         "hosts": ["h0"], "trace_id": TRACE},
        {"secret": "evil", "job_name": "b", "job_dir": str(jd),
         "hosts": ["h0"], "trace_id": TRACE}]))
    res = {}
    for secret in ("good", "typo"):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = pkg.main(["--manifest", str(root / "m.json"), "--secret",
                           secret, "--dry-run"])
        res[secret] = (rc, out.getvalue(), err.getvalue())
    return res


def case_sync_recovers_from_twice_failing_rsync(pkg, root):
    job = _job(pkg, root)
    pkg.faults.inject("job.rsync", at=0, times=2, action="replace",
                      value=30)
    return {"rc": job.sync(), "cmds": _cmds(job)}


def case_sync_gives_up_after_budget(pkg, root):
    job = _job(pkg, root, retries=2)
    pkg.faults.inject("job.rsync", at=0, times=99, action="replace",
                      value=30)
    return {"rc": job.sync(), "cmds": _cmds(job)}


def case_launch_not_retried_by_default(pkg, root):
    job = _job(pkg, root)
    pkg.faults.inject("job.ssh", at=0, times=1, action="replace",
                      value=255)
    return {"rc": job.launch(), "cmds": _cmds(job)}


def case_launch_retries_only_when_opted_in(pkg, root):
    job = _job(pkg, root, launch_retries=1)
    pkg.faults.inject("job.ssh", at=0, times=1, action="replace",
                      value=255)
    return {"rc": job.launch(), "cmds": _cmds(job)}


def case_punchcard_torn_read(pkg, root):
    jd = _jobdir(root)
    (root / "m.json").write_text(json.dumps([{
        "secret": "s", "job_name": "a", "job_dir": str(jd),
        "hosts": ["h1"], "trace_id": TRACE}]))
    pc = pkg.Punchcard(str(root / "m.json"), secrets=("s",), dry_run=True)
    pc.read_policy.sleep = lambda s: None
    pkg.faults.inject("punchcard.read_manifest", at=0, times=2,
                      exc=OSError)
    jobs = pc.run_once()
    # past the read budget the torn read surfaces
    pkg.faults.inject("punchcard.read_manifest", at=0, times=9,
                      exc=OSError)
    return {"jobs": [(j.job_name, j.last_rc) for j in jobs],
            "exhausted": _error(pc.run_once)[0]}


def case_coord_env_and_dead_hosts(pkg, root):
    job = _job(pkg, root, coord_dir=str(root / "coord"))
    pkg.Heartbeat(str(root / "coord"), rank=0).beat_once()
    plain = _job(pkg, root, hosts=["h0"])
    return {"env": job.host_env(1),
            "dead": job.dead_hosts(stale_after_s=60),
            "plain": _error(plain.dead_hosts)}


def case_obs_and_timeout_env(pkg, root):
    job = _job(pkg, root, coord_dir="/shared/coord", coord_timeout_s=45,
               obs_dir="/scratch/obs")
    return {"env": job.host_env(1), "rc": job.launch(), "cmds": _cmds(job)}


def case_collect_obs(pkg, root):
    job = _job(pkg, root, obs_dir="/scratch/obs")
    rc = job.collect_obs(root / "collected")
    plain = _job(pkg, root, hosts=["h0"])
    return {"rc": rc, "cmds": _cmds(job),
            "plain": _error(lambda: plain.collect_obs(root))}


def case_monitor_transitions(pkg, root):
    obs = root / "obs"
    w = pkg.events.EventWriter(str(obs), rank=0)
    w.emit("train_start")
    w.close()
    w = pkg.events.EventWriter(str(obs), rank=1)
    w.emit("train_start")
    w.emit("epoch_end", epoch=0)
    w.close()
    job = _job(pkg, root, obs_dir=str(obs), coord_dir=str(root / "coord"))
    pkg.Heartbeat(str(root / "coord"), rank=0).beat_once()
    printed = []
    lines = job.monitor(interval_s=0.0, max_polls=2, out=printed.append,
                        stale_after_s=60)
    return {"lines": lines, "printed": printed == lines}


def case_plane_exports(pkg, root):
    """The serving, fabric, PS, scrape, SLO and trace planes' exports."""
    job = _job(pkg, root, serve_port=9001, route_port=8123,
               metrics_port=9400, obs_sample_s=0.25, slo=True,
               trace_retain=True, trace_sample=0.1, ps_addr="10.0.0.9:7447",
               ps_window=16, obs_dir="/tmp/obs", coordinator_port=9999)
    errors = [_error(lambda: _job(pkg, root, route_port=8123)),
              _error(lambda: _job(pkg, root, ps_addr="nope")),
              _error(lambda: _job(pkg, root, ps_window=0)),
              _error(lambda: _job(pkg, root, trace_id="not-hex")),
              _error(lambda: _job(pkg, root, coord_dir="/a b")),
              _error(lambda: _job(pkg, root, obs_dir="/a;b")),
              _error(lambda: _job(pkg, root, hosts=[]).launch()),
              _error(lambda: _job(pkg, root, hosts=[]).host_env(0))]
    minted = pkg.Job("s", "j", str(_jobdir(root)), hosts=["h0"],
                     dry_run=True)
    return {"env": [job.host_env(0), job.host_env(1, session=3)],
            "errors": errors, "minted": len(minted.trace_id),
            "rc": job.send(), "cmds": _cmds(job)}


def case_supervise_knob_forms(pkg, root):
    forms = [None, True, 5, {"max_restarts": 1, "interval_s": 0.5},
             {"max_restarts": 1, "elastic": False, "min_world": 2}, 2]
    return {"forms": [_job(pkg, root, supervise=f).supervise
                      for f in forms],
            "errors": [_error(lambda k=k: _job(pkg, root, supervise=k))
                       for k in ({"retries": 3}, {"world": 1})]}


def case_supervise_requires_arming_and_coord_dir(pkg, root):
    job = _job(pkg, root, coord_dir=str(root / "coord"))
    plain = _job(pkg, root, hosts=["h0"], supervise=1)
    return [_error(lambda: job.supervise_run(max_polls=1)),
            _error(lambda: plain.supervise_run(max_polls=1))]


def case_supervise_relaunches_whole_pod(pkg, root):
    job = _job(pkg, root, coord_dir=str(root / "coord"), supervise=SUP)
    pkg.Heartbeat(str(root / "coord"), rank=0).beat_once()
    waves = job.supervise_run(max_polls=1, out=None, stale_after_s=60)
    return {"waves": waves, "cmds": _cmds(job)}


def case_launch_host_rc_dir_shell_safe(pkg, root):
    jd = str(_jobdir(root))
    bad = _error(lambda: pkg.Job("s", "jq", jd, hosts=["h0"], dry_run=True,
                                 coord_dir=str(root / "my runs" / "c")))
    job = pkg.Job("s", "jq", jd, hosts=["h0"], dry_run=True,
                  coord_dir=str(root / "coord"), trace_id=TRACE)
    job.launch_host(0)
    tilde = pkg.Job("s", "jt", jd, hosts=["h0"], dry_run=True,
                    coord_dir="~/dkcoord", trace_id=TRACE)
    tilde.launch_host(0, session=3)
    tilde.stop_host("h0")
    return {"bad": bad, "cmds": _cmds(job) + _cmds(tilde)}


def case_supervise_judges_new_session(pkg, root):
    coord = root / "coord"
    job = _job(pkg, root, coord_dir=str(coord), supervise=SUP)
    pkg.Heartbeat(str(coord), rank=0).beat_once()
    pkg.Heartbeat(str(coord / "1"), rank=0).beat_once()
    pkg.Heartbeat(str(coord / "1"), rank=1).beat_once()
    return job.supervise_run(max_polls=3, out=None, stale_after_s=60)


def case_supervise_budget_counts_waves(pkg, root):
    coord = root / "coord"
    job = _job(pkg, root, coord_dir=str(coord),
               supervise={**SUP, "max_restarts": 1})
    for r in (coord, coord / "1"):
        for rank in (0, 1):
            pkg.Heartbeat(str(r), rank=rank).beat_once()
            _stale(r, rank)
    try:
        job.supervise_run(max_polls=4, out=None, stale_after_s=60)
    except pkg.CrashLoop as e:
        return {"msg": str(e), "evidence": len(e.evidence),
                "cmds": _cmds(job)}
    return "no CrashLoop"


def case_supervise_failed_wave_is_not_silence(pkg, root):
    job = _job(pkg, root, coord_dir=str(root / "coord"),
               supervise={**SUP, "max_restarts": 1})
    pkg.Heartbeat(str(root / "coord"), rank=0).beat_once()
    try:
        job.supervise_run(max_polls=3, out=None, stale_after_s=60)
    except pkg.CrashLoop as e:
        return {"msg": str(e), "evidence": len(e.evidence)}
    return "no CrashLoop"


def case_supervise_completed_pod(pkg, root):
    coord = root / "coord"
    job = _job(pkg, root, coord_dir=str(coord), supervise=SUP)
    for rank in (0, 1):
        pkg.Heartbeat(str(coord), rank=rank).beat_once()
        _stale(coord, rank)
    (coord / "rc").mkdir()
    for rank in (0, 1):
        (coord / "rc" / f"rank_{rank}").write_text("0\n")
    printed = []
    waves = job.supervise_run(max_polls=5, out=printed.append,
                              stale_after_s=60)
    return {"waves": waves, "cmds": _cmds(job), "printed": printed}


def case_supervise_rc_zero_exempts_one_rank(pkg, root):
    coord = root / "coord"
    job = _job(pkg, root, coord_dir=str(coord), supervise=SUP)
    for rank in (0, 1):
        pkg.Heartbeat(str(coord), rank=rank).beat_once()
        _stale(coord, rank)
    (coord / "rc").mkdir()
    (coord / "rc" / "rank_0").write_text("0\n")
    printed = []
    waves = job.supervise_run(max_polls=1, out=printed.append,
                              stale_after_s=60)
    return {"waves": waves, "printed": printed}


def case_supervise_nonzero_rc_is_evidence(pkg, root):
    coord = root / "coord"
    job = _job(pkg, root, coord_dir=str(coord), supervise=SUP)
    (coord / "rc").mkdir(parents=True)
    for rank in (0, 1):
        (coord / "rc" / f"rank_{rank}").write_text("143\n")
    return job.supervise_run(max_polls=1, out=None, stale_after_s=60)


def case_host_rcs_skip_garbled(pkg, root):
    coord = root / "coord"
    job = _job(pkg, root, coord_dir=str(coord))
    (coord / "rc").mkdir(parents=True)
    (coord / "rc" / "rank_0").write_text("0\n")
    (coord / "rc" / "rank_1").write_text("garbled")
    (coord / "rc" / "notarank").write_text("7")
    (coord / "2" / "rc").mkdir(parents=True)
    (coord / "2" / "rc" / "rank_1").write_text("143")
    plain = _job(pkg, root, hosts=["h0"])
    return [job.host_rcs(), job.host_rcs(session=2),
            _error(plain.host_rcs)]


def case_supervise_budget_exhaustion(pkg, root):
    job = _job(pkg, root, coord_dir=str(root / "coord"),
               supervise={**SUP, "max_restarts": 0})
    pkg.Heartbeat(str(root / "coord"), rank=0).beat_once()
    try:
        job.supervise_run(max_polls=2, out=None, stale_after_s=60)
    except pkg.CrashLoop as e:
        return {"msg": str(e), "evidence": len(e.evidence)}
    return "no CrashLoop"


def case_elastic_shrink(pkg, root):
    coord = root / "coord"
    job = _job(pkg, root, coord_dir=str(coord), supervise=SUP)
    pkg.Heartbeat(str(coord), rank=0).beat_once()
    pkg.Heartbeat(str(coord), rank=1).beat_once()
    _stale(coord, 1)
    pkg.Heartbeat(str(coord / "1"), rank=0).beat_once()
    (coord / "1" / "rc").mkdir(parents=True)
    (coord / "1" / "rc" / "rank_1").write_text("137\n")
    (coord / "2" / "rc").mkdir(parents=True)
    (coord / "2" / "rc" / "rank_0").write_text("0\n")
    printed = []
    waves = job.supervise_run(max_polls=3, out=printed.append,
                              stale_after_s=60)
    return {"waves": waves, "hosts": job.hosts,
            "world": job.num_processes, "cmds": _cmds(job),
            "printed": printed}


def case_elastic_respects_min_world(pkg, root):
    coord = root / "coord"
    job = _job(pkg, root, coord_dir=str(coord),
               supervise={**SUP, "max_restarts": 1, "min_world": 2})
    for r in (coord, coord / "1"):
        pkg.Heartbeat(str(r), rank=0).beat_once()
        pkg.Heartbeat(str(r), rank=1).beat_once()
        _stale(r, 1)
    try:
        job.supervise_run(max_polls=3, out=None, stale_after_s=60)
        raised = None
    except pkg.CrashLoop as e:
        raised = str(e)
    return {"raised": raised, "hosts": job.hosts}


def case_elastic_off_never_resizes(pkg, root):
    coord = root / "coord"
    job = _job(pkg, root, coord_dir=str(coord),
               supervise={**SUP, "elastic": False})
    pkg.Heartbeat(str(coord), rank=0).beat_once()
    pkg.Heartbeat(str(coord), rank=1).beat_once()
    _stale(coord, 1)
    pkg.Heartbeat(str(coord / "1"), rank=0).beat_once()
    (coord / "1" / "rc").mkdir(parents=True)
    (coord / "1" / "rc" / "rank_1").write_text("137\n")
    waves = job.supervise_run(max_polls=2, out=None, stale_after_s=60)
    return {"waves": waves, "hosts": job.hosts}


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def _norm(x, roots):
    """Each package's root directory and name -> one spelling."""
    if isinstance(x, str):
        for root in roots:
            x = x.replace(str(root), "<root>")
        return x.replace("dist_keras_tpu_torch", "dist_keras_tpu")
    if isinstance(x, dict):
        return {_norm(k, roots): _norm(v, roots) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_norm(v, roots) for v in x)
    return x


@pytest.mark.parametrize("name", sorted(CASES))
def test_launch_matches_the_jax_package(name, tmp_path, monkeypatch):
    for k in [k for k in os.environ if k.startswith("DK_")]:
        monkeypatch.delenv(k)
    seen, roots = {}, []
    for tag, pkg in PACKAGES.items():
        root = tmp_path / tag
        root.mkdir()
        roots.append(root)
        seen[tag] = CASES[name](pkg, root)
    assert _norm(seen["port"], roots) == _norm(seen["jax"], roots)


def test_elastic_knob_governs_when_the_supervise_dict_is_silent(
        tmp_path, monkeypatch):
    """``DK_ELASTIC_MIN_WORLD`` (read by the port since the launcher came)
    keeps the repeat offender in the pod, as ``min_world`` does."""
    for k in [k for k in os.environ if k.startswith("DK_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("DK_ELASTIC_MIN_WORLD", "2")
    seen = {}
    for tag, pkg in PACKAGES.items():
        root = tmp_path / tag
        root.mkdir()
        coord = root / "coord"
        job = _job(pkg, root, coord_dir=str(coord),
                   supervise={**SUP, "max_restarts": 1})
        for r in (coord, coord / "1"):
            pkg.Heartbeat(str(r), rank=0).beat_once()
            pkg.Heartbeat(str(r), rank=1).beat_once()
            _stale(r, 1)
        with pytest.raises(pkg.CrashLoop):
            job.supervise_run(max_polls=3, out=None, stale_after_s=60)
        seen[tag] = job.hosts
    assert seen["port"] == seen["jax"] == ["h0", "h1"]


def test_cli_module_entry():
    """``python -m dist_keras_tpu_torch.launch`` is a shell entry point:
    its dry-run prints the JAX CLI's lines."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("DK_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = {}
    with contextlib.ExitStack() as stack:
        import tempfile

        d = Path(stack.enter_context(tempfile.TemporaryDirectory()))
        jd = _jobdir(d)
        (d / "job.json").write_text(json.dumps(
            {"job_name": "exp1", "job_dir": str(jd), "hosts": ["h0"],
             "trace_id": TRACE}))
        for mod in ("dist_keras_tpu.launch", "dist_keras_tpu_torch.launch"):
            proc = subprocess.run(
                [sys.executable, "-m", mod, "--job", str(d / "job.json"),
                 "--dry-run"], capture_output=True, text=True, env=env,
                timeout=300)
            assert proc.returncode == 0, proc.stderr[-2000:]
            out[mod] = [ln for ln in proc.stdout.splitlines()
                        if ln.startswith("DRY-RUN ")]
    assert out["dist_keras_tpu_torch.launch"] == out["dist_keras_tpu.launch"]
    assert any(ln.startswith("DRY-RUN rsync") for ln in out[mod])


# -- one real local run: supervised relaunch of a split port trainer ----

ENTRY = r"""
import os, signal, sys
sys.path.insert(0, os.environ["DK_TEST_ROOT"])
from dist_keras_tpu_torch.resilience import coordination
coord = coordination.get_coordinator()   # beats before torch loads
import numpy as np
import torch
torch.set_num_threads(1)
from dist_keras_tpu_torch import comm
from dist_keras_tpu_torch.data import Dataset
from dist_keras_tpu_torch.models import mnist_mlp
from dist_keras_tpu_torch.trainers import ADAG
from dist_keras_tpu_torch.utils.bridge import params_to_numpy

work = os.environ["DK_TEST_WORK"]
kill = os.environ["DK_TEST_KILL"] == "1"
session = os.environ.get("DK_COORD_SESSION", "0")
comm.initialize(device="cpu")
rank = comm.process_index()
rng = np.random.default_rng(0)
x = rng.normal(size=(512, 8)).astype(np.float32)
y = (x[:, 0] + x[:, 1] > 0).astype(np.int64)
ds = Dataset({"features": x, "label": y,
              "label_encoded": np.eye(2, dtype=np.float32)[y]})
t = ADAG(mnist_mlp(hidden=(16,), input_dim=8, num_classes=2, seed=0),
         num_workers=4, communication_window=2, worker_optimizer="sgd",
         optimizer_kwargs={"learning_rate": 0.05}, batch_size=16,
         num_epoch=1, label_col="label_encoded", device="cpu",
         checkpoint_dir=os.path.join(work, "ck"),
         checkpoint_every_windows=1, max_checkpoints=10, resume=True)
marker = os.path.join(work, "killed")
vote = coord.any_flag


def any_flag(flag, timeout_s=None):
    if kill and rank == int(os.environ["DK_TEST_KILL_RANK"]) \
            and not os.path.exists(marker) \
            and t._checkpointer_or_none().latest_step() is not None:
        with open(marker, "w") as f:
            f.write(session)
        os.kill(os.getpid(), signal.SIGKILL)
    return vote(flag, timeout_s=timeout_s)


coord.any_flag = any_flag
m = t.train(ds)
leaves = [v for layer in params_to_numpy(m.params) for v in layer.values()]
np.savez(os.path.join(work, f"final_{session}_{rank}.npz"),
         **{f"{i:04d}": v for i, v in enumerate(leaves)})
comm.shutdown()
"""


def _supervised_run(work, kill, per_host=1):
    """One supervised job of two hosts of ``per_host`` CPU ranks each (more
    than one: through the per-card fan-out) -> (waves, every rank's final
    leaves), from the session that finished; the killed rank is host 1's
    last."""
    import numpy as np

    work.mkdir()
    jd = work / "jobdir"
    jd.mkdir()
    (jd / "main.py").write_text(ENTRY)
    env = {k: v for k, v in os.environ.items() if not k.startswith("DK_")}
    env.update(DK_TEST_ROOT=REPO, DK_TEST_WORK=str(work),
               DK_TEST_KILL="1" if kill else "0",
               DK_TEST_KILL_RANK=str(2 * per_host - 1), PYTHONUNBUFFERED="1",
               PYTHONPATH=REPO)
    python = sys.executable if per_host == 1 else (
        f"{sys.executable} -m dist_keras_tpu_torch.launch.local "
        f"--nproc-per-host {per_host}")
    job = chip_smoke.local_job(work, env)(
        "s", "job", str(jd), hosts=["127.0.0.1", "127.0.0.2"],
        coordinator_port=chip_smoke.free_port(), remote_root="jobs",
        python=python, coord_dir=str(work / "coord"),
        coord_timeout_s=60.0, trace_id=TRACE,
        supervise={"max_restarts": 2, "interval_s": 0.1, "grace_s": 3.0})
    try:
        assert job.send() == 0
        chip_smoke.wait_pod_up(work, 2, "the CPU pod")
        waves = job.supervise_run(max_polls=1500, out=None,
                                  stale_after_s=10.0)
    finally:
        chip_smoke.kill_pods(work)
    session = waves[-1][1] if waves else 0
    rcs = job.host_rcs(session=session or None)
    logs = {p.name: p.read_text()[-1500:]
            for p in (work / "hosts").glob("*/jobs/job/job.log*")}
    assert rcs == {0: 0, 1: 0}, (waves, rcs, logs)
    finals = []
    for r in range(2 * per_host):
        z = np.load(work / f"final_{session}_{r}.npz")
        finals.append([z[k] for k in sorted(z.files)])
    return waves, finals


def test_supervised_relaunch_of_split_port_ranks_on_the_cpu(tmp_path):
    import numpy as np

    waves, (got0, got1) = _supervised_run(tmp_path / "killed", kill=True)
    assert waves == [((1,), 1)]
    assert (tmp_path / "killed" / "killed").read_text() == "0"
    assert (tmp_path / "killed" / "coord" / "1" / "hb").is_dir()
    _, (want, _) = _supervised_run(tmp_path / "unkilled", kill=False)
    assert all(np.array_equal(a, b) for a, b in zip(got0, got1))
    assert len(got0) == len(want)
    assert all(np.array_equal(a, b) for a, b in zip(got0, want))


def test_supervised_relaunch_of_two_hosts_of_two_ranks_on_the_cpu(tmp_path):
    """The Job over two local hosts, each running the per-card fan-out
    (``python -m dist_keras_tpu_torch.launch.local --nproc-per-host 2``):
    one group of 4 gloo ranks, 1 ADAG worker each.  Host 1's last rank
    SIGKILLs itself after a promoted save; its fan-out exits non-zero, the
    supervisor names host 1 (the Job's liveness stays per host: the
    fan-outs beat the hosts' files, the ranks their own under
    ``<coord_dir>/ranks``), relaunches the pod, and the resumed ranks end
    bit-equal to an unkilled run of the same pod."""
    import numpy as np

    waves, got = _supervised_run(tmp_path / "killed", kill=True, per_host=2)
    assert waves == [((1,), 1)]
    assert (tmp_path / "killed" / "killed").read_text() == "0"
    coord = tmp_path / "killed" / "coord"
    assert sorted(p.name for p in (coord / "1" / "hb").glob("rank_?")) == [
        "rank_0", "rank_1"]
    assert sorted(p.name for p in (coord / "ranks" / "1" / "hb").glob(
        "rank_?")) == ["rank_0", "rank_1", "rank_2", "rank_3"]
    _, want = _supervised_run(tmp_path / "unkilled", kill=False, per_host=2)
    for leaves in got[1:]:
        assert all(np.array_equal(a, b) for a, b in zip(got[0], leaves))
    assert len(got[0]) == len(want[0])
    assert all(np.array_equal(a, b) for a, b in zip(got[0], want[0]))
