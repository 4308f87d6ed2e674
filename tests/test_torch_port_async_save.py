"""Lagged logging and background saves in the port's ``TrainLoop``, on the
CPU.

* A log at ``log_interval`` leaves the newest ``dispatch_lag`` steps in
  flight, as the JAX trainer's ``run_loop`` does, and each logged row
  holds the metrics of the step ``dispatch_lag`` before it: the JAX
  ``TrainLoop``'s on the same weights and batches (GPT-2 at 2 layers,
  D=32, H=2, V=64, seq_len 32, f32, batch 8 in microbatches of 4; loss
  rtol 2e-5 and grad norm rtol 1e-4, the bars of
  ``tests/test_torch_port_train.py``).
* ``EventTimer.poll`` reads only the completed pairs; the all-reduce's
  mean divides by the calls read.
* ``utils/checkpoint.AsyncSaver``: a save returns before its files exist,
  ``wait()`` finalizes them with the meta file last, prune never touches
  the step in flight, a writer error is raised at the next ``wait()``,
  and ``tear()`` (``crash_in_save``) leaves the same torn step whatever
  the writer's timing.
* ``TrainLoop.run_loop`` saves in the background: ``save_s`` is the copy
  plus the waits, the save in flight is waited for when the loop raises.
"""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from flax.core import meta  # noqa: E402

from distributed_pipeline_tpu.data import \
    load_data_from_args as jax_load_data  # noqa: E402
from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu.parallel import make_mesh  # noqa: E402
from distributed_pipeline_tpu.utils.trainer import \
    TrainLoop as JaxTrainLoop  # noqa: E402
from distributed_pipeline_tpu_torch.chaos import (ChaosInjector,  # noqa: E402
                                                  ChaosPlan)
from distributed_pipeline_tpu_torch.convert import \
    params_from_flax  # noqa: E402
from distributed_pipeline_tpu_torch.data import \
    load_data_from_args  # noqa: E402
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.utils import \
    checkpoint as ckpt  # noqa: E402
from distributed_pipeline_tpu_torch.utils.logger import Logger  # noqa: E402
from distributed_pipeline_tpu_torch.utils.perf import EventTimer  # noqa: E402
from distributed_pipeline_tpu_torch.utils.trainer import \
    TrainLoop  # noqa: E402

CFG = dict(model_family="gpt2", vocab_size=64, seq_len=32, hidden_size=32,
           num_layers=2, num_heads=2, dtype="float32")
STEPS = 5
LOOP = dict(batch_size=8, microbatch=4, lr=1e-3, ema_rate="0.9,0.99",
            learning_steps=STEPS, gradient_clipping=1.0,
            save_interval=10 ** 9)
TINY = dict(model_family="diffuseq", vocab_size=64, seq_len=16,
            hidden_size=32, num_layers=1, num_heads=2, diffusion_steps=50,
            dtype="float32")


class RecordingLogger(Logger):
    """A logger that keeps each dumped row with the loop's in-flight count
    at the dump."""

    def __init__(self) -> None:
        super().__init__("")
        self.loop = None
        self.dumps = []

    def dumpkvs(self):
        row = super().dumpkvs()
        self.dumps.append((dict(row), len(self.loop._inflight)))
        return row


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX ``TrainLoop``'s per-step metrics over ``STEPS`` batches,
    and its initial weights."""
    jloop = JaxTrainLoop(
        model=jax_create(**CFG, attention_impl="xla"), data=None,
        mesh=make_mesh(dp=1, devices=jax.devices()[:1]), seed=5,
        checkpoint_dir="", fused_update=False, log_interval=10 ** 9,
        **LOOP)
    init = params_from_flax(jax.tree_util.tree_map(
        np.asarray, meta.unbox(jloop.state.params)))
    it = jax_load_data("train", batch_size=8, dataset="synthetic-lm",
                       seq_len=32, vocab_size=64, seed=3)
    batches = [next(it) for _ in range(STEPS)]
    metrics = []
    for b in batches:
        m = jloop.run_step(b)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    return init, batches, metrics


@pytest.mark.parametrize("lag", [1, 2])
def test_log_keeps_the_lag_in_flight_and_rows_match_jax(jax_reference, lag):
    """``log_interval 1``: every dump leaves ``min(lag, step)`` steps in
    flight; the row dumped at step s holds step s - lag's metrics (none
    for s <= lag), the JAX trainer's values; the history is complete once
    the loop exits."""
    init, batches, want = jax_reference
    log = RecordingLogger()
    loop = TrainLoop(
        model=create_model_from_config(**CFG, attention_impl="xla",
                                       device="cpu"),
        data=iter(batches), init_params=init, fused_update="false",
        checkpoint_dir="", dispatch_lag=lag, log_interval=1, logger=log,
        **LOOP)
    log.loop = loop
    loop.run_loop()
    assert len(log.dumps) == STEPS
    for s, (row, inflight) in enumerate(log.dumps, start=1):
        assert row["step"] == s
        assert inflight == min(lag, s)
        if s <= lag:
            assert "loss" not in row
            continue
        ref = want[s - lag - 1]
        np.testing.assert_allclose(row["loss"], ref["loss"], rtol=2e-5)
        np.testing.assert_allclose(row["grad_norm"], ref["grad_norm"],
                                   rtol=1e-4)
        np.testing.assert_allclose(row["lr"], ref["lr"], rtol=1e-7)
    assert [h["step"] for h in loop.history] == list(range(1, STEPS + 1))
    for h, ref in zip(loop.history, want):
        np.testing.assert_allclose(h["loss"], ref["loss"], rtol=2e-5)
    assert loop.logged_step == loop.step and not loop._inflight


class _Event:
    """A CUDA event's stand-in: ``query()`` says whether it completed."""

    def __init__(self, t, done=True):
        self.t, self.done = t, done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_event_timer_poll_reads_only_completed_pairs():
    t = EventTimer()
    pending = _Event(3.5, done=False)
    t._events = [(_Event(0.0), _Event(0.25)), (_Event(1.0), _Event(1.5)),
                 (_Event(3.0), pending), (_Event(4.0), _Event(4.25))]
    t.calls = 4
    t.poll()
    assert t.drained == 2 and t.seconds == pytest.approx(0.75)
    assert t.seconds_per_call == pytest.approx(0.375)
    assert len(t._events) == 2      # the pending pair and the one after
    t.poll()
    assert t.drained == 2
    t.drain()
    assert t.drained == 4 and t.seconds == pytest.approx(1.5)
    assert not t._events
    cpu = EventTimer()
    with cpu.measure(torch.device("cpu")):
        pass
    assert cpu.calls == cpu.drained == 1


# ---------------------------------------------------------------- saver

def _state(v):
    return {"a": torch.full((3,), float(v)), "b": torch.arange(4.0) * v}


def _save_args(v):
    return (_state(v), {"0.9": _state(v + 1)},
            {"mu": _state(0), "nu": _state(0), "count": v}, {"samples": v})


@pytest.fixture
def gated(monkeypatch):
    """``_save`` blocks until the gate opens; the file order is recorded
    (with the meta write)."""
    gate, order = threading.Event(), []
    real_save, real_meta = ckpt._save, ckpt._write_meta

    def slow_save(obj, path):
        gate.wait(30)
        real_save(obj, path)
        order.append(os.path.basename(path))

    def meta(path, m):
        real_meta(path, m)
        order.append(os.path.basename(path))

    monkeypatch.setattr(ckpt, "_save", slow_save)
    monkeypatch.setattr(ckpt, "_write_meta", meta)
    return gate, order


def test_save_returns_before_its_files_and_meta_lands_last(tmp_path,
                                                           gated):
    gate, order = gated
    saver = ckpt.AsyncSaver()
    params, ema, opt, meta_ = _save_args(2)
    saver.save(str(tmp_path), 2, params, ema, opt, meta_)
    # the caller's tensors may change at once: the copy was taken
    params["a"].fill_(-1.0)
    assert saver.in_flight and ckpt.in_flight_steps(str(tmp_path)) == {2}
    assert not [n for n in os.listdir(tmp_path) if not n.endswith(".tmp")]
    gate.set()
    saver.wait()
    assert order == ["model_000002.pt", "ema_0.9_000002.pt",
                     "opt_000002.pt", "meta_000002.json"]
    assert not saver.in_flight and ckpt.in_flight_steps(str(tmp_path)) == set()
    assert ckpt.finalized_steps(str(tmp_path)) == [2]
    got = torch.load(tmp_path / "model_000002.pt", weights_only=True)
    assert torch.equal(got["a"], torch.full((3,), 2.0))
    assert json.loads((tmp_path / "meta_000002.json").read_text()) == \
        {"step": 2, "samples": 2}


def test_prune_never_touches_the_step_in_flight(tmp_path, gated):
    gate, _ = gated
    gate.set()
    for step in (1, 2, 3):
        ckpt.save_checkpoint(str(tmp_path), step, *_save_args(step))
    gate.clear()
    saver = ckpt.AsyncSaver()
    saver.save(str(tmp_path), 4, *_save_args(4))
    # step 4's files may appear mid-write (here: none, the writer waits);
    # a meta written by hand for it still does not make it prunable or
    # counted while the save is in flight
    with open(tmp_path / "meta_000004.json", "w") as f:
        json.dump({"step": 4}, f)
    assert ckpt.prune_checkpoints(str(tmp_path), 1) == [1, 2]
    assert (tmp_path / "meta_000004.json").exists()
    assert ckpt.finalized_steps(str(tmp_path)) == [3]
    gate.set()
    saver.wait()
    assert ckpt.prune_checkpoints(str(tmp_path), 1) == [3]
    assert ckpt.finalized_steps(str(tmp_path)) == [4]


def test_a_writer_error_is_raised_at_the_next_wait(tmp_path, monkeypatch):
    def broken(obj, path):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ckpt, "_save", broken)
    saver = ckpt.AsyncSaver()
    saver.save(str(tmp_path), 1, *_save_args(1))
    with pytest.raises(OSError, match="No space left"):
        saver.wait()
    assert ckpt.finalized_steps(str(tmp_path)) == []
    assert ckpt.in_flight_steps(str(tmp_path)) == set()
    saver.wait()    # raised once, not again
    saver.save(str(tmp_path), 2, *_save_args(2))
    with pytest.raises(OSError):    # the next save waits for step 2's
        saver.save(str(tmp_path), 3, *_save_args(3))


@pytest.mark.parametrize("writer", ["slow", "fast"])
def test_tear_leaves_the_same_torn_step(tmp_path, monkeypatch, writer):
    """Whether the writer has committed the step or not when ``tear``
    comes, the step's payload files exist and its meta does not."""
    real_save = ckpt._save
    if writer == "slow":
        monkeypatch.setattr(ckpt, "_save", lambda o, p: (time.sleep(0.05),
                                                         real_save(o, p)))
    saver = ckpt.AsyncSaver()
    ckpt.save_checkpoint(str(tmp_path), 1, *_save_args(1))
    saver.save(str(tmp_path), 2, *_save_args(2))
    if writer == "fast":
        saver._thread.join()
        assert (tmp_path / "meta_000002.json").exists()
    assert saver.tear() is True
    names = set(os.listdir(tmp_path))
    assert {"model_000002.pt", "ema_0.9_000002.pt", "opt_000002.pt"} <= names
    assert "meta_000002.json" not in names
    assert not [n for n in names if n.endswith(".tmp")]
    assert ckpt.finalized_steps(str(tmp_path)) == [1]
    assert saver.tear() is False


# ------------------------------------------------------------ TrainLoop

def tiny_loop(run_dir, **kw):
    model = create_model_from_config(**TINY, device=torch.device("cpu"))
    data = load_data_from_args("train", batch_size=4,
                               dataset="synthetic-seq2seq", seq_len=16,
                               vocab_size=64, seed=0, data_loader_workers=0)
    kw.setdefault("log_interval", 10 ** 9)
    return TrainLoop(model=model, data=data, batch_size=4, microbatch=2,
                     lr=1e-3, ema_rate="0.9,0.99",
                     checkpoint_dir=str(run_dir), seed=0, **kw)


def test_loop_saves_in_the_background_and_books_both_parts(tmp_path):
    loop = tiny_loop(tmp_path, learning_steps=4, save_interval=2,
                     keep_checkpoints=1)
    loop.run_loop()
    assert [t["step"] for t in loop.save_times] == [2, 4]
    assert all(t["copy_s"] > 0 and t["wait_s"] >= 0
               for t in loop.save_times)
    assert loop.goodput.get("save_s") == pytest.approx(
        sum(t["copy_s"] + t["wait_s"] for t in loop.save_times))
    assert not loop.saver.in_flight
    assert ckpt.finalized_steps(str(tmp_path)) == [4]
    assert sorted(os.listdir(tmp_path)) == sorted(
        ["ema_0.9_000004.pt", "ema_0.99_000004.pt", "model_000004.pt",
         "opt_000004.pt", "meta_000004.json", "goodput_attempt000.json",
         "log.txt", "progress.csv"])


def test_loop_waits_for_the_save_in_flight_when_it_raises(tmp_path,
                                                          monkeypatch):
    real_save = ckpt._save
    monkeypatch.setattr(ckpt, "_save", lambda o, p: (time.sleep(0.05),
                                                     real_save(o, p)))
    loop = tiny_loop(tmp_path, learning_steps=6, save_interval=2)
    real_step = loop.run_step

    def boom(batch):
        if loop.step == 2:
            raise RuntimeError("step 3 failed")
        return real_step(batch)

    loop.run_step = boom
    with pytest.raises(RuntimeError, match="step 3 failed"):
        loop.run_loop()
    assert not loop.saver.in_flight
    assert ckpt.finalized_steps(str(tmp_path)) == [2]


def test_crash_in_save_tears_the_step_the_same_way_every_time(tmp_path,
                                                             monkeypatch):
    """``crash_in_save`` at step 2 through ``run_loop`` (the SIGKILL
    intercepted), with a slow and a fast writer: step 2's payload without
    its meta both times, step 1 the newest finalized."""
    kills = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: kills.append(sig))
    real_save = ckpt._save
    plan = ChaosPlan.parse('{"faults": [{"kind": "crash_in_save", '
                           '"step": 2}]}')
    for delay in (0.05, 0.0):
        d = tmp_path / f"delay{delay}"
        monkeypatch.setattr(ckpt, "_save", lambda o, p, t=delay: (
            time.sleep(t), real_save(o, p)))
        loop = tiny_loop(d, learning_steps=2, save_interval=1,
                         chaos=ChaosInjector(plan, 0, str(d)))
        loop.run_loop()
        names = set(os.listdir(d))
        assert {"model_000002.pt", "opt_000002.pt", "ema_0.9_000002.pt",
                "ema_0.99_000002.pt"} <= names, names
        assert "meta_000002.json" not in names
        assert ckpt.finalized_steps(str(d)) == [1]
    assert kills == [signal.SIGKILL] * 2


def test_tear_races_the_writer_under_fast_thread_switching(tmp_path):
    """``tear()`` issued at once after ``save``, 25 times with the
    interpreter switching threads every microsecond: whichever of the
    writer and the tear reaches the meta first, the step ends with its
    payload and without its meta, and no save stays in flight."""
    import sys
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        saver = ckpt.AsyncSaver()
        for step in range(1, 26):
            saver.save(str(tmp_path), step, *_save_args(step))
            assert saver.tear() is True
            assert not saver.in_flight
            assert (tmp_path / f"model_{step:06d}.pt").exists()
            assert not (tmp_path / f"meta_{step:06d}.json").exists()
    finally:
        sys.setswitchinterval(prev)
    assert ckpt.finalized_steps(str(tmp_path)) == []
    assert ckpt.in_flight_steps(str(tmp_path)) == set()
