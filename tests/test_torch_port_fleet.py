"""The port's serving fleet on the CPU: the torch-free modules copied from
the JAX package (router, transport, autoscaler, chaos plan and injector,
the fleet goodput fold, the launcher's supervision rules) driven beside
the JAX ones with the same scripted inputs; the fleet parent's import
rule (no torch); and ``run.serve --replicas 2 --device cpu`` with real
port replica processes: streams against the single-replica server (and
once the JAX XLA-arm server), a killed replica, the socket transport, a
hot swap, a corrupted swap target and a replica that cannot use CUDA.
The ``cuda`` case (a graph-captured server swapped in place) runs on the
card through ``scripts/run_torch_cuda_tests.py -k fleet``."""

import json
import os
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from distributed_pipeline_tpu.chaos import goodput as jax_goodput  # noqa
from distributed_pipeline_tpu.chaos.plan import \
    ChaosPlan as JaxChaosPlan  # noqa: E402
from distributed_pipeline_tpu.parallel import launcher as jax_launcher  # noqa
from distributed_pipeline_tpu.serving import autoscale as jax_autoscale  # noqa
from distributed_pipeline_tpu.serving import router as jax_router  # noqa
from distributed_pipeline_tpu.serving import \
    transport as jax_transport  # noqa: E402
from distributed_pipeline_tpu_torch.chaos import goodput  # noqa: E402
from distributed_pipeline_tpu_torch.chaos.inject import (  # noqa: E402
    ChaosInjector, corrupt_checkpoint_payload)
from distributed_pipeline_tpu_torch.chaos.plan import ChaosPlan  # noqa
from distributed_pipeline_tpu_torch.convert import \
    params_from_flax  # noqa: E402
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.parallel import launcher  # noqa: E402
from distributed_pipeline_tpu_torch.run import serve as serve_mod  # noqa
from distributed_pipeline_tpu_torch.serving import autoscale  # noqa: E402
from distributed_pipeline_tpu_torch.serving import router  # noqa: E402
from distributed_pipeline_tpu_torch.serving import transport  # noqa: E402
from distributed_pipeline_tpu_torch.serving.fleet import (  # noqa: E402
    ServingFleet, find_newest_finalized, read_json_file)
from distributed_pipeline_tpu_torch.serving.scheduler import \
    DecodeServer  # noqa: E402
from distributed_pipeline_tpu_torch.utils.checkpoint import \
    save_run  # noqa: E402

from tests.test_autoscale import FakeFleet, FakeSignals  # noqa: E402
from tests.test_fleet import FakeReplica  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(model_family="gpt2", vocab_size=128, seq_len=64, hidden_size=64,
           num_layers=2, num_heads=2, dtype="float32")
# the replicas' and the single server's geometry
GEOM = dict(decode_slots=4, page_size=16, max_prompt_len=32, decode_span=4,
            dispatch_lag=2)


class Clock:
    """A wall clock the test advances: both routers (and autoscalers)
    stamp the same times, so their journals compare exactly."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t


# ================================================== copied modules vs JAX

def _router_script(mod, tmp, clock, seed):
    """A seeded script over fake replicas: submits, polls, completions,
    an attempt bump, a supervisor death, draining, a retire; then a router
    rebuilt from the journal. Returns what the router decided."""
    clock.t = 1000.0
    rng = np.random.default_rng(seed)
    clients = {i: FakeReplica(i) for i in range(3)}
    path = os.path.join(tmp, f"journal_{mod.__name__}.jsonl")
    r = mod.Router(clients, path, stale_beacon_s=2.0, page_size=4)
    placements = []
    for step in range(40):
        clock.t += 0.25
        op = rng.integers(0, 9)
        if op <= 3:
            r.submit(rng.integers(4, 60, (int(rng.integers(1, 9)),)),
                     int(rng.integers(1, 6)), submit_t=clock.t)
        elif op == 4:
            rid = int(rng.integers(0, 3))
            for p in list(clients[rid].inbox)[:2]:
                clients[rid].finish(p["id"], tokens=[p["id"], step])
        elif op == 6:
            clients[int(rng.integers(0, 3))].beacon_age = float(
                rng.choice([0.0, 5.0]))
        elif op == 7:
            r.set_draining(2, bool(rng.integers(0, 2)))
        if step == 17:
            clients[1].restart()
        if step == 30:
            clients[0]._alive = False
        r.poll()
        placements.append(sorted((rec.id, rec.replica, rec.state,
                                  rec.replays)
                                 for rec in r.records.values()))
    rec2 = mod.Router.recover({i: FakeReplica(i) for i in range(3)}, path)
    with open(path) as f:
        journal = [json.loads(line) for line in f]
    return {"placements": placements, "journal": journal,
            "replayed": r.replayed, "completed": r.completed,
            "down": sorted(i for i in range(3) if r.down(i)),
            "recovered": sorted((rec.id, rec.state, list(rec.prompt))
                                for rec in rec2.records.values())}


def _autoscale_script(mod, tmp, clock):
    """The same backlog and TTFT series through an autoscaler over the
    JAX tests' fake fleet and router signals."""
    clock.t = 1000.0
    fleet = FakeFleet(2)
    sig = FakeSignals(range(2), os.path.join(tmp, f"as_{mod.__name__}"))
    scaler = mod.AutoScaler(fleet, sig, min_replicas=1, max_replicas=4,
                            slo_ttft_s=1.0, up_backlog=2.0, down_frac=0.5,
                            cooldown_s=0.0, window_s=30.0,
                            drain_timeout_s=3.0)
    series = [(5, [0.2]), (9, [0.3, 4.0, 5.0]), (0, [2.0]), (0, []),
              (0, [0.1]), (0, [0.1]), (1, [0.2]), (0, [0.1]), (0, [])]
    trail = []
    for backlog, ttfts in series:
        clock.t += 2.0
        sig.backlog, sig.ttfts = backlog, ttfts
        scaler.step(now=clock.t)
        trail.append((list(fleet.added), list(fleet.stopped),
                      sorted(sig._draining), list(sig.retired)))
    scaler.close(now=clock.t + 1.0)
    with open(sig.journal_path) as f:
        journal = [json.loads(line) for line in f]
    return {"trail": trail, "summary": scaler.summary(), "journal": journal}


def _replica_dirs(root):
    """Replica dirs with attempts, sidecars, beacons and a journal: a
    killed attempt (beacon snapshot only), a clean one, a torn line."""
    r0, r1 = goodput.replica_dir(root, 0), goodput.replica_dir(root, 1)
    for d in (r0, r1):
        os.makedirs(d, exist_ok=True)
    goodput.append_attempt(r0, {"attempt": 0, "rc": -9, "t_spawn": 10.0,
                                "t_exit": 15.0, "duration_s": 5.0,
                                "downtime_s": 0.0,
                                "serving": {"wall_s": 4.0, "serving_s": 3.5,
                                            "drain_s": 0.5, "swap_s": 0.0}})
    goodput.append_attempt(r0, {"attempt": 1, "rc": 0, "t_spawn": 15.5,
                                "t_exit": 30.0, "duration_s": None,
                                "downtime_s": 0.5})
    with open(goodput.serving_record_path(r0, 1), "w") as f:
        json.dump({"attempt": 1, "wall_s": 14.0, "serving_s": 12.0,
                   "drain_s": 1.0, "swap_s": 1.0}, f)
    goodput.append_attempt(r1, {"attempt": 0, "rc": 0, "t_spawn": 10.0,
                                "t_exit": 30.0, "duration_s": 20.0,
                                "downtime_s": 0.0})
    with open(goodput.attempts_path(r1), "a") as f:
        f.write('{"attempt": 1, "rc"')  # torn tail
    with open(goodput.serving_journal_path(root), "w") as f:
        for ev in ({"ev": "replay", "wasted_s": 2.5},
                   {"ev": "paid_idle", "idle_s": 1.25},
                   {"ev": "assign", "id": 1}):
            f.write(json.dumps(ev) + "\n")


PLANS = [
    '{"faults": [{"kind": "kill_replica", "step": 3, "rank": 1}]}',
    '{"faults": [{"kind": "stall_replica", "step": 1, "rank": 0, '
    '"seconds": 2.5}, {"kind": "corrupt_swap_checkpoint", "step": 0}]}',
    '[{"kind": "kill", "step": 2, "sig": "SIGTERM"}]',
    '{"faults": [{"kind": "slow_rank", "step": 2, "seconds": 0.1}]}',
    '{"faults": []}', '{"faults": [{"kind": "nope", "step": 1}]}',
    '{"faults": [{"kind": "kill", "step": -1}]}',
    '{"faults": [{"kind": "stall_replica", "step": 1, "seconds": 0}]}',
    '{"faults": [{"kind": "kill", "step": 1, "extra": 2}]}', 'not json',
]


def _parse(cls, src):
    try:
        plan = cls.parse(src)
    except ValueError as e:
        return ("error", str(e).split(":")[0])
    return ("ok", plan.to_json(), plan.describe())


def _budget_trail(mod, stamps, window):
    t = [0.0]
    b = mod._RestartBudget(3, window, now=lambda: t[0])
    out = []
    for s in stamps:
        t[0] = s
        out.append((b.allows_restart(), b.spent()))
        if b.allows_restart():
            b.charge()
    return out


ATTEMPT_RECORDS = [
    [], [{"rc": 1, "steps": 0}],
    [{"rc": 1, "steps": 0}, {"rc": 1, "steps": 0}],
    [{"rc": 1, "steps": 0}, {"rc": 1, "steps": 3}],
    [{"rc": 1, "steps": None}, {"rc": 1, "steps": 0}],
    [{"rc": 0, "steps": 0}, {"rc": 1, "steps": 0}],
    [{"rc": 1, "steps": 5}, {"rc": 1, "steps": 0}, {"rc": 1, "steps": 0}],
]


@pytest.mark.parametrize("case", ["router", "autoscaler", "goodput",
                                  "chaos_plan", "restart_rules",
                                  "harvest"])
def test_copied_module_matches_jax(case, tmp_path, monkeypatch):
    """Each torch-free module the port copies gives the JAX module's
    results on the same scripted inputs, exactly: the router's placements,
    replays, journal and journal recovery; the autoscaler's decisions and
    journal; the serving goodput fold; ChaosPlan.parse over good and bad
    plans; the launcher's
    sliding-window restart budget and crash-loop rule; the launcher's
    attempt harvest from a replica's beacon."""
    clock = Clock()
    if case in ("router", "autoscaler"):
        monkeypatch.setattr(time, "time", clock)
        monkeypatch.setattr(time, "monotonic", clock)
    if case == "router":
        got = _router_script(router, str(tmp_path), clock, 3)
        assert got == _router_script(jax_router, str(tmp_path), clock, 3)
        assert got["replayed"] >= 1 and got["down"] == [0]
    elif case == "autoscaler":
        got = _autoscale_script(autoscale, str(tmp_path), clock)
        want = _autoscale_script(jax_autoscale, str(tmp_path), clock)
        assert got == want and got["summary"]["scale_ups"] >= 1
    elif case == "goodput":
        _replica_dirs(str(tmp_path))
        got = goodput.aggregate_serving(str(tmp_path))
        assert got == jax_goodput.aggregate_serving(str(tmp_path))
        assert got["accounted_frac"] == pytest.approx(1.0)
        assert got["replay_s"] == 2.5 and got["paid_idle_s"] == 1.25
    elif case == "chaos_plan":
        for src in PLANS:
            assert _parse(ChaosPlan, src) == _parse(JaxChaosPlan, src), src
    elif case == "restart_rules":
        for window in (0.0, 10.0):
            stamps = [0, 1, 2, 3, 4, 12, 13, 14, 30]
            assert _budget_trail(launcher, stamps, window) == \
                _budget_trail(jax_launcher, stamps, window)
        for recs in ATTEMPT_RECORDS:
            assert launcher._crash_looping(recs) == \
                jax_launcher._crash_looping(recs)
    else:
        run_dir = tmp_path / "replica_0"
        run_dir.mkdir()
        handshake = tmp_path / "handshake"
        handshake.write_text(str(run_dir))
        beacon = {"step": 7, "start_step": 0, "attempt": 1, "rank": 0,
                  "replica": 0, "serving": {"wall_s": 3.0,
                                            "serving_s": 3.0}}
        (run_dir / ".progress_rank0.json").write_text(json.dumps(beacon))
        for mod in (launcher, jax_launcher):
            args = (str(handshake), 1, -9, 10.0, 14.0, 9.5, 4)
            kw = dict(ring_status={"hung": True, "hang_s": 2.0,
                                   "hang_kind": "stall"},
                      nprocs=1, devices_per_proc=1)
            rec, rd = mod._harvest_attempt(*args, **kw)
            assert rd == str(run_dir)
            if mod is launcher:
                mine = rec
        assert mine == rec and mine["serving"] == beacon["serving"]


@pytest.mark.parametrize("case", ["frames", "torn", "closed", "oversize",
                                  "prefix_hashes", "socket_roundtrip"])
def test_transport_matches_jax(case, tmp_path):
    """The copied transport speaks the JAX module's wire: frames written
    by one are read by the other, torn/closed/oversize frames raise
    ``TransportError`` on both, ``prefix_block_hashes`` agree, and the
    JAX package's socket client submits to, drains from and heartbeats
    the port's worker endpoint (and the port's client the JAX
    endpoint)."""
    mods = (transport, jax_transport)
    if case == "frames":
        for tx, rx in ((transport, jax_transport),
                       (jax_transport, transport)):
            a, b = socket.socketpair()
            try:
                for obj in ({"op": "hb"}, {"op": "submit", "req": {
                        "id": 3, "prompt": [1, 2, 3]}}, {"u": "héllo"}):
                    tx.send_frame(a, obj)
                    assert rx.recv_frame(b) == obj
            finally:
                a.close()
                b.close()
    elif case in ("torn", "closed", "oversize"):
        for mod in mods:
            a, b = socket.socketpair()
            try:
                if case == "torn":
                    a.sendall(struct.pack(">I", 100) + b"x" * 10)
                    a.close()
                    match = "torn frame"
                elif case == "closed":
                    a.close()
                    match = "peer closed"
                else:
                    a.sendall(struct.pack(">I", mod.MAX_FRAME_BYTES + 1))
                    match = "too large"
                with pytest.raises(mod.TransportError, match=match):
                    mod.recv_frame(b)
            finally:
                a.close()
                b.close()
    elif case == "prefix_hashes":
        rng = np.random.default_rng(1)
        for n, page in ((9, 4), (0, 4), (400, 2), (33, 16)):
            toks = rng.integers(0, 50000, (n,)).tolist()
            for mb in (32, 4):
                assert transport.prefix_block_hashes(toks, page, mb) == \
                    jax_transport.prefix_block_hashes(toks, page, mb)
    else:
        for ep_mod, cl_mod in ((transport, jax_transport),
                               (jax_transport, transport)):
            paths = ep_mod.ReplicaPaths.at(
                str(tmp_path / ep_mod.__name__), 0).ensure()
            ep = ep_mod.WorkerSocketEndpoint(paths, 0, attempt=0)
            client = cl_mod.SocketReplicaClient(
                cl_mod.ReplicaPaths.at(paths.root, 0), hb_cache_s=0.0)
            try:
                client.submit({"id": 7, "prompt": [1, 2],
                               "max_new_tokens": 4})
                client.submit({"id": 8, "prompt": [3], "max_new_tokens": 2})
                assert [r["id"] for r in ep.take_submits()] == [7, 8]
                ep.queue_result({"id": 7, "tokens": [11, 12]})
                assert [r["id"] for r in client.consume_results()] == [7]
                assert client.consume_results() == []
                now = time.time()
                ep.tick(now, extra={"prefix_index": [11, 22]})
                assert client.beacon_age_s(now + 0.5) == pytest.approx(
                    0.5, abs=0.2)
                assert list(client.prefix_index()) == [11, 22]
            finally:
                client.close()
                ep.close()


def test_port_checkpoint_layout_and_serving_faults(tmp_path, monkeypatch):
    """The port's finalized checkpoint is ``model_NNNNNN.pt`` (never a
    ``.tmp``); ``corrupt_checkpoint_payload`` garbles it so ``torch.load``
    fails; ``on_serve_tick`` fires a replica fault once, at the first
    tick past its admitted threshold with work in flight, and
    ``on_swap`` corrupts the swap target once."""
    run = str(tmp_path)
    assert find_newest_finalized(run) is None
    for step in (3, 12):
        torch.save({"w": torch.ones(4)}, os.path.join(
            run, f"model_{step:06d}.pt"))
    (tmp_path / "model_000099.pt.tmp").write_bytes(b"torn")
    (tmp_path / "model_abc.pt").write_bytes(b"x")
    (tmp_path / "ema_0.9_000050.pt").write_bytes(b"x")
    target = find_newest_finalized(run)
    assert target == os.path.join(run, "model_000012.pt")
    assert corrupt_checkpoint_payload(target)
    with pytest.raises(Exception):
        torch.load(target, weights_only=True)
    assert not corrupt_checkpoint_payload(os.path.join(run, "missing.pt"))

    fired = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: fired.append(sig))
    plan = ChaosPlan.parse('{"faults": [{"kind": "kill_replica", "step": '
                           '3, "rank": 1}, {"kind": '
                           '"corrupt_swap_checkpoint", "step": 0}]}')
    inj = ChaosInjector(plan, rank=1, run_dir=run)
    inj.on_serve_tick(5, 0)       # nothing in flight
    inj.on_serve_tick(2, 1)       # below the threshold
    assert fired == []
    inj.on_serve_tick(4, 2)
    inj.on_serve_tick(6, 2)       # once per run
    assert len(fired) == 1
    again = ChaosInjector(plan, rank=1, run_dir=run)  # a respawned worker
    again.on_serve_tick(9, 1)
    assert len(fired) == 1
    other = os.path.join(run, "model_000003.pt")
    assert inj.on_swap(other) is True and inj.on_swap(other) is False
    with pytest.raises(Exception):
        torch.load(other, weights_only=True)


def test_fleet_parent_imports_no_torch():
    """The fleet parent's modules, imported in a fresh interpreter, leave
    torch (and JAX, and the JAX package) out of ``sys.modules``."""
    code = (
        "import sys\n"
        "import distributed_pipeline_tpu_torch.run.serve\n"
        "import distributed_pipeline_tpu_torch.serving.fleet\n"
        "import distributed_pipeline_tpu_torch.serving.router\n"
        "import distributed_pipeline_tpu_torch.serving.transport\n"
        "import distributed_pipeline_tpu_torch.serving.autoscale\n"
        "import distributed_pipeline_tpu_torch.parallel.launcher\n"
        "import distributed_pipeline_tpu_torch.chaos\n"
        "import distributed_pipeline_tpu_torch.obs.trace\n"
        "import distributed_pipeline_tpu_torch.mpmd.link\n"
        "import distributed_pipeline_tpu_torch.ops._build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'distributed_pipeline_tpu')]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_launcher_refuses_several_processes():
    """A ring of several processes is served now (``run.train
    --distributed --nprocs N``, tests/test_torch_port_dist.py); what the
    launcher still refuses is a ring of no process, and each worker of a
    ring gets its own rank of the same rendezvous."""
    with pytest.raises(ValueError, match="nprocs must be >= 1"):
        launcher.run_argv_as_distributed("x", [], nprocs=0)
    envs = [launcher._worker_env(r, 2, 1234) for r in range(2)]
    assert [(e["RANK"], e["LOCAL_RANK"], e["WORLD_SIZE"], e["MASTER_PORT"])
            for e in envs] == [("0", "0", "2", "1234"),
                               ("1", "1", "2", "1234")]


# ===================================================== the fleet, end to end

@pytest.fixture(scope="module")
def fleet_run_dir(tmp_path_factory):
    """A port run dir (GPT-2, 2 layers, hidden 64, vocab 128, seq 64) with
    step 1 converted from JAX weights and step 2 from the port's seeded
    init; the JAX model and step 1's params."""
    from flax.core import meta

    from distributed_pipeline_tpu.models import \
        create_model_from_config as jax_create
    from distributed_pipeline_tpu_torch.convert import init_params
    wl = jax_create(**CFG)
    run = str(tmp_path_factory.mktemp("fleet_run") / "run")
    params = jax.tree_util.tree_map(
        np.asarray, meta.unbox(wl.init_params(jax.random.PRNGKey(4))))
    save_run(run, CFG, params_from_flax(params), 1)
    save_run(run, CFG, init_params(CFG, seed=9), 2)
    return run, wl, params


def _single_streams(run, step, prompts, budget=8):
    """The port's single-replica server (the fleet's geometry) on
    ``step``: one stream a prompt."""
    from distributed_pipeline_tpu_torch.run.sample import load_run
    model, _, _ = load_run(run, step, "cpu")
    srv = DecodeServer(model, device="cpu", **GEOM)
    reqs = [srv.submit(np.asarray(p, np.int32), budget) for p in prompts]
    srv.drain()
    return [list(r.tokens) for r in reqs]


def _fleet_argv(run, tmp, tag, *extra, requests=8):
    return ["--checkpoint_path", run, "--device", "cpu", "--step", "1",
            "--replicas", "2", "--decode_slots", "4", "--page_size", "16",
            "--max_prompt_len", "32", "--max_new_tokens", "8",
            "--synthetic_requests", str(requests), "--traffic", "poisson",
            "--rate_rps", "200", "--fleet_dir", os.path.join(tmp, tag),
            "--out", os.path.join(tmp, f"{tag}.jsonl"),
            "--fleet_deadline_s", "60", "--hang_timeout_s", "20",
            "--fleet_backoff_s", "0.05", *extra]


def _rows(tmp, tag):
    with open(os.path.join(tmp, f"{tag}.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("case", ["file", "socket_kill"])
def test_fleet_streams_equal_single_replica(case, fleet_run_dir, tmp_path):
    """``run.serve --replicas 2 --device cpu`` with real port replica
    processes: every request completes, every replica exits 0, and each
    greedy stream equals the port's single-replica server's on the same
    prompt — over the file transport with no fault (and there the JAX
    XLA-arm server's too, under the serve tests' near-tie rule), and over
    the socket transport with a ``kill_replica`` fault on each replica at
    its first admission (whichever replica is ready first takes the whole
    burst, so both carry the fault): ``replayed >= 1``, and a killed
    replica's ``attempts.jsonl`` holds a failed attempt and a second
    one; the autoscaler rides along at its floor."""
    run, wl, jax_params = fleet_run_dir
    tmp = str(tmp_path)
    extra = {"file": (), "socket_kill": (
        "--serve_transport", "socket", "--autoscale", "true",
        "--autoscale_min", "2", "--chaos_plan", json.dumps(
            {"faults": [{"kind": "kill_replica", "step": 1, "rank": r}
                        for r in (0, 1)]}))}[case]
    summary = serve_mod.main(_fleet_argv(run, tmp, case, *extra))
    rows = _rows(tmp, case)
    assert summary["mode"] == "fleet" and summary["completed"] == 8
    assert summary["dropped"] == 0 and summary["replica_rcs"] == [0, 0]
    assert summary["device"] == "cpu" and summary["transport"] == (
        "socket" if case == "socket_kill" else "file")
    assert summary["serving_goodput"]["accounted_frac"] == pytest.approx(
        1.0, abs=1e-3)
    ref = _single_streams(run, 1, [r["prompt"] for r in rows])
    assert [r["tokens"] for r in rows] == ref
    assert all(r["params_step"] == 1 for r in rows)
    fleet_dir = os.path.join(tmp, case)
    if case == "socket_kill":
        # the autoscaler runs beside the router (at its floor: no change)
        assert summary["autoscale"]["scale_ups"] == 0
        assert summary["autoscale"]["scale_downs"] == 0
        assert summary["replayed"] >= 1
        killed = [a for rid in (0, 1) for a in [goodput.read_attempts(
            goodput.replica_dir(fleet_dir, rid))] if a[0]["rc"] != 0]
        assert killed and all(len(a) >= 2 for a in killed)
        assert any(r["replays"] > 0 for r in rows)
    for rdir in goodput.list_replica_dirs(fleet_dir):
        cars = goodput.read_serving_records(rdir)
        last = cars[max(cars)]
        # the CPU replicas serve through the plain version, no kernel
        assert last["device"] == "cpu" and \
            last["decode_kernel_launches"] == 0
    if case == "file":
        from tests.test_torch_port_serve import _hold_against_jax
        model = create_model_from_config(**CFG, device="cpu")
        model.load_state_dict(params_from_flax(jax_params))
        from distributed_pipeline_tpu.serving import \
            DecodeServer as JaxDecodeServer
        kw = dict(decode_slots=4, page_size=16, max_prompt_len=32,
                  decode_span=4)
        jsrv = JaxDecodeServer(wl, jax_params, decode_impl="xla", **kw)
        jreqs = [jsrv.submit(np.asarray(r["prompt"], np.int32), 8)
                 for r in rows]
        jsrv.drain()
        for r, jr in zip(rows, jreqs):
            _hold_against_jax(wl, jax_params, model, kw,
                              np.asarray(r["prompt"], np.int32),
                              list(jr.tokens), r["tokens"])


def _wait(pred, what, timeout_s=40.0):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def test_fleet_hot_swap_then_corrupt_swap(fleet_run_dir, tmp_path):
    """Two real port replicas behind the router: a rolling hot swap to
    step 2 moves both replicas one at a time (at least one ready at every
    instant) and the requests after it equal a fresh server at step 2;
    then a ``corrupt_swap_checkpoint`` on a step-3 target aborts on the
    canary with zero replicas moved, and the fleet goes on serving step
    2's streams."""
    import shutil
    run, _, _ = fleet_run_dir
    fleet_dir = str(tmp_path / "fleet")
    argv = serve_mod._worker_argv(serve_mod.parse_settings(
        ["--checkpoint_path", run, "--step", "1", "--decode_slots", "4",
         "--page_size", "16", "--max_prompt_len", "32"]))
    fleet = ServingFleet(fleet_dir, 2, "distributed_pipeline_tpu_torch."
                         "run.serve", argv, hang_timeout_s=20.0,
                         restart_backoff_s=0.05, monitor_interval=0.02,
                         replica_platform="cpu")
    fleet.start()
    r = router.Router(fleet.clients(), goodput.serving_journal_path(
        fleet_dir), page_size=16)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(4, 128, (int(n),)).astype(np.int32)
               for n in (5, 9, 3, 12, 7, 16, 4, 10)]
    ready_counts = []
    report = {}

    def drive(tick=None):
        def done():
            r.poll()
            if fleet.swap_active:
                rep = fleet.step_swap(r)
                if rep is not None:
                    report.clear()
                    report.update(rep)
            ready_counts.append(sum(r.healthy(i) for i in range(2)))
            if tick is not None:
                tick()
            return r.all_done() and not fleet.swap_active
        _wait(done, "the fleet to finish", 60.0)

    try:
        _wait(lambda: len(fleet.ready_replicas()) == 2, "two ready replicas")
        before = [r.submit(p, 8) for p in prompts[:4]]
        drive()
        arm = fleet.begin_hot_swap(run, 2, drain_timeout_s=20,
                                   swap_timeout_s=20)
        assert arm["step"] == 2 and arm["target"].endswith(
            "model_000002.pt")
        ready_counts.clear()
        drive()
        assert report["ok"] and sorted(report["swapped"]) == [0, 1]
        assert min(ready_counts) >= 1
        windows = sorted(tuple(w) for w in report["windows"].values())
        assert windows[0][1] <= windows[1][0] + 1e-6
        after = [r.submit(p, 8) for p in prompts[4:]]
        drive()
        # a corrupted target: the canary refuses, nothing moves
        shutil.copy(os.path.join(run, "model_000002.pt"),
                    os.path.join(run, "model_000003.pt"))
        plan = ChaosPlan.parse('{"faults": [{"kind": '
                               '"corrupt_swap_checkpoint", "step": 0}]}')
        inj = ChaosInjector(plan, rank=0, run_dir=fleet_dir)
        arm = fleet.begin_hot_swap(run, 3, injector=inj,
                                   drain_timeout_s=20, swap_timeout_s=20)
        assert arm["injected"] is True
        drive()
        assert report["ok"] is False and report["swapped"] == []
        assert "refused" in report["error"]
        post = [r.submit(p, 8) for p in prompts[:3]]
        drive()
    finally:
        rcs = fleet.stop()
        os.remove(os.path.join(run, "model_000003.pt"))
    assert rcs == [0, 0]
    assert [q.params_step for q in before] == [1] * 4
    assert [q.tokens for q in before] == _single_streams(run, 1,
                                                         prompts[:4])
    assert [q.params_step for q in after] == [2] * 4
    step2 = _single_streams(run, 2, prompts[4:])
    assert [q.tokens for q in after] == step2
    assert step2 != _single_streams(run, 1, prompts[4:])
    assert [q.params_step for q in post] == [2] * 3
    assert [q.tokens for q in post] == _single_streams(run, 2, prompts[:3])
    for rid in range(2):
        assert read_json_file(fleet.paths[rid].current_path)["step"] == 2


def test_replica_without_cuda_fails_loudly(fleet_run_dir, tmp_path):
    """A replica asked to serve on CUDA where there is none fails (no CPU
    fallback): its ring spends its restart budget (0 here), nothing is
    served, and the summary's ``replica_rcs`` are non-zero."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    run, _, _ = fleet_run_dir
    tmp = str(tmp_path)
    argv = _fleet_argv(run, tmp, "nocuda", "--replica_platform", "cuda",
                       "--fleet_max_restarts", "0", "--fleet_deadline_s",
                       "3", requests=2)
    argv[argv.index("--replicas") + 1] = "1"
    summary = serve_mod.main(argv)
    assert summary["completed"] == 0 and summary["deadline_hit"]
    assert summary["replica_rcs"] == [1]
    attempts = goodput.read_attempts(goodput.replica_dir(
        os.path.join(tmp, "nocuda"), 0))
    assert [a["rc"] for a in attempts] == [1]
    with open(os.path.join(tmp, "nocuda", "replica_0", "logs",
                           "worker_0.log")) as f:
        assert "CUDA is not available" in f.read()


def test_worker_argv_carries_every_setting_but_the_parents():
    """Every serve setting but the fleet parent's own reaches the replica
    workers (the JAX package's ``_PARENT_ONLY`` set), and a worker parses
    the argv back to the same settings."""
    from distributed_pipeline_tpu.run.serve import _PARENT_ONLY
    assert serve_mod._PARENT_ONLY == _PARENT_ONLY
    s = serve_mod.parse_settings(["--checkpoint_path", "/r", "--replicas",
                                  "3", "--cost_ledger", "true", "--ema",
                                  "0.99", "--serve_transport", "socket"])
    argv = serve_mod._worker_argv(s)
    back = serve_mod.parse_settings(argv)
    for name in vars(s):
        want = 0 if name == "replicas" else getattr(s, name)
        if name not in _PARENT_ONLY:
            assert getattr(back, name) == want, name
    assert "--replicas" not in argv and "--out" not in argv


# ============================================================ on the card

@pytest.mark.cuda
def test_graph_server_swapped_in_place_on_card(tmp_path):
    """A graph-captured server swapped in place (``set_params``) serves
    the new weights: its streams equal a fresh graph server's at the new
    step, each phase was captured once, the capture's tensors are the
    ones written, and a shape mismatch refuses the swap."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the graph engine captures CUDA graphs")
    from distributed_pipeline_tpu_torch.convert import init_params
    from distributed_pipeline_tpu_torch.ops import flash_decode as fd
    cfg = dict(CFG, vocab_size=256, seq_len=128, hidden_size=128,
               dtype="bfloat16")
    sd1, sd2 = init_params(cfg, seed=1), init_params(cfg, seed=2)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(4, 256, (int(n),)).astype(np.int32)
               for n in (40, 7, 63, 20, 33, 12)]

    def server(sd):
        model = create_model_from_config(**cfg, device="cuda")
        model.load_state_dict(sd)
        return DecodeServer(model, decode_slots=4, page_size=16,
                            max_prompt_len=64, decode_span=3,
                            device="cuda")

    def streams(srv):
        reqs = [srv.submit(p, max_new_tokens=12) for p in prompts]
        srv.drain()
        return [r.tokens for r in reqs]

    srv = server(sd1)
    first = streams(srv)
    ptrs = [t.data_ptr() for t in srv.model.state_dict().values()]
    fd.reset_launch_count()
    srv.set_params(sd2)  # the model keeps f32 weights, bf16 compute
    swapped = streams(srv)
    assert fd.launch_count() > 0 and fd.plain_call_count() == 0
    assert ptrs == [t.data_ptr() for t in srv.model.state_dict().values()]
    assert all(n == 1 for n in srv.engine.captures.values())
    assert swapped == streams(server(sd2)) and swapped != first
    bad = dict(sd1)
    key = next(iter(bad))
    bad[key] = bad[key][:1]
    with pytest.raises(ValueError, match="does not fit"):
        srv.set_params(bad)
    assert streams(srv) == swapped
