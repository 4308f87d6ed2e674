"""The port's training configuration against the JAX package's, on the CPU.

* A JAX ``TrainSettings`` dumped to JSON (what ``train.sh`` hands to
  ``run.train --config_json``) parses through the port field for field, at
  the JAX defaults and with small sizes, and trains there.
* The JAX options the port does not train yet fail at parse time naming
  their ROADMAP item; ``compilation_cache_dir`` takes only ``auto`` and
  ``off``.
* ``--keep_checkpoints``, ``--debug_nans`` and ``--prefetch_depth`` behave
  as the JAX flags do: retention prunes every file kind of a step together,
  a non-finite step raises ``FloatingPointError`` naming the step, and the
  losses do not depend on the prefetch depth (bitwise).

GPT-2 at 2 layers, D=32, H=2, V=64, seq_len 32, f32, batch 8 in
microbatches of 4, as in tests/test_torch_port_train.py.
"""

import json
import os

import numpy as np
import pytest
import torch

from distributed_pipeline_tpu.config.train import \
    TrainSettings as JaxTrainSettings
from distributed_pipeline_tpu_torch.config.train import (DEFERRED,
                                                         TrainSettings,
                                                         parse_settings)
from distributed_pipeline_tpu_torch.data import load_data_from_args
from distributed_pipeline_tpu_torch.models import create_model_from_config
from distributed_pipeline_tpu_torch.run import train as train_mod
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop

ARGV = ["--device", "cpu", "--model_family", "gpt2", "--dataset",
        "synthetic-lm", "--seq_len", "32", "--vocab_size", "64",
        "--hidden_size", "32", "--num_layers", "2", "--num_heads", "2",
        "--dtype", "float32", "--batch_size", "8", "--microbatch", "4",
        "--ema_rate", "0.9,0.99", "--lr", "1e-3", "--log_interval", "1",
        "--data_loader_workers", "0"]
SMALL = dict(model_family="gpt2", dataset="synthetic-lm", seq_len=32,
             vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
             dtype="float32", batch_size=8, microbatch=4, learning_steps=2,
             log_interval=1, save_interval=2, data_loader_workers=0)
# the JAX fields the port lacked until it took every one of them
NEW_FIELDS = ("debug_nans", "keep_checkpoints", "prefetch_depth",
              "compilation_cache_dir", "profile_steps", "auto_tune_budget_s",
              "scan_unroll", "moe_top_k", "moe_every", "moe_capacity_factor",
              "mpmd_stages", "mpmd_link_capacity", "mpmd_hang_timeout_s",
              "mpmd_max_restarts")


def _jax_dump(tmp_path, **overrides) -> str:
    path = tmp_path / "train_config.json"
    path.write_text(json.dumps(JaxTrainSettings(**overrides).model_dump()))
    return str(path)


def test_jax_default_config_json_parses(tmp_path):
    """The JAX defaults' dump parses, and every field lands at the JAX
    value (the port's own ``device`` stays empty)."""
    jax_values = JaxTrainSettings().model_dump()
    s = parse_settings(["--config_json", _jax_dump(tmp_path)])
    ours = s.to_dict()
    assert set(ours) - set(jax_values) == {"device"}
    assert set(jax_values) - set(ours) == set()
    for key, value in jax_values.items():
        assert ours[key] == value, key
    assert set(NEW_FIELDS) <= set(ours)


def test_jax_config_json_trains(tmp_path):
    """A JAX settings dump at small sizes trains through ``run.train
    --config_json`` (``--device cpu`` beside it) and saves its last step."""
    run = str(tmp_path / "run")
    loop = train_mod.main(["--config_json",
                           _jax_dump(tmp_path, checkpoint_path=run,
                                     **SMALL),
                           "--device", "cpu"])
    assert loop.step == 2 and loop.prefetch_depth == 2
    assert all(np.isfinite(h["loss"]) for h in loop.history)
    assert os.path.exists(os.path.join(run, "meta_000002.json"))


@pytest.mark.parametrize("flag,value,item", [
    ("profile_steps", "3:8", "ROADMAP A.10"),
    ("auto_tune_budget_s", "30", "ROADMAP A.10"),
    ("scan_unroll", "2", "ROADMAP A.9"),
    ("moe_top_k", "1", "ROADMAP A.8"),
    ("moe_every", "1", "ROADMAP A.8"),
    ("moe_capacity_factor", "2.0", "ROADMAP A.8"),
    ("mpmd_stages", "4", "ROADMAP A.9"),
    ("mpmd_link_capacity", "4", "ROADMAP A.9"),
    ("mpmd_hang_timeout_s", "5", "ROADMAP A.9"),
    ("mpmd_max_restarts", "1", "ROADMAP A.9"),
    ("compilation_cache_dir", "/tmp/cache", "no XLA compilation cache"),
    ("keep_checkpoints", "-1", "must be >= 0"),
    ("prefetch_depth", "-1", "must be >= 0")])
def test_new_fields_refused_name_their_reason(flag, value, item, capsys):
    with pytest.raises(SystemExit) as e:
        parse_settings([f"--{flag}", value])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert item in err
    if flag in DEFERRED:
        assert DEFERRED[flag][1] in err


@pytest.mark.parametrize("value", ["auto", "off"])
def test_compilation_cache_dir_accepts_auto_and_off(value):
    assert parse_settings(["--compilation_cache_dir", value]) \
        .compilation_cache_dir == value


def test_keep_checkpoints_prunes_every_file_kind(tmp_path):
    """4 saves under ``--keep_checkpoints 2`` leave exactly steps 3 and 4,
    each with its model, EMA (both rates), opt and meta file."""
    run = str(tmp_path / "run")
    train_mod.main(ARGV + ["--checkpoint_path", run, "--learning_steps", "4",
                           "--save_interval", "1", "--keep_checkpoints", "2"])
    kinds = ("model_{:06d}.pt", "opt_{:06d}.pt", "meta_{:06d}.json",
             "ema_0.9_{:06d}.pt", "ema_0.99_{:06d}.pt")
    names = {n for n in os.listdir(run) if n[-3:] in (".pt", "son")
             and n != "training_args.json"}
    assert names == {k.format(s) for k in kinds for s in (3, 4)}


def _gpt2_loop(tmp_path, **kw) -> TrainLoop:
    model = create_model_from_config(
        model_family="gpt2", vocab_size=64, seq_len=32, hidden_size=32,
        num_layers=2, num_heads=2, dtype="float32",
        device=torch.device("cpu"))
    return TrainLoop(model=model, data=None, batch_size=8, microbatch=4,
                     lr=1e-3, ema_rate="0.9", learning_steps=100,
                     log_interval=10 ** 9, save_interval=10 ** 9,
                     checkpoint_dir=str(tmp_path), seed=5, **kw)


def _poisoned(at_step: int):
    """The synthetic-lm stream with a NaN in the float loss mask of the
    batch that step ``at_step`` reads."""
    it = load_data_from_args("train", batch_size=8, dataset="synthetic-lm",
                             seq_len=32, vocab_size=64, seed=3,
                             data_loader_workers=0)
    step = 0
    while True:
        batch = dict(next(it))
        step += 1
        if step == at_step:
            mask = batch["input_mask"].astype(np.float32)
            mask[1, 5] = np.nan
            batch["input_mask"] = mask
        yield batch


def test_debug_nans_raises_at_the_poisoned_step(tmp_path):
    loop = _gpt2_loop(tmp_path / "a", debug_nans=True)
    loop.set_data(_poisoned(3))
    loop.run_step(next(loop.data))
    loop.run_step(next(loop.data))
    with pytest.raises(FloatingPointError, match="at step 3"):
        loop.run_step(next(loop.data))
    # without the flag the same step runs on with a NaN loss
    quiet = _gpt2_loop(tmp_path / "b")
    quiet.set_data(_poisoned(3))
    for _ in range(3):
        quiet.run_step(next(quiet.data))
    quiet.flush_metrics()
    assert np.isnan(quiet.history[-1]["loss"])


def test_prefetch_depth_keeps_losses_bitwise(tmp_path):
    """The same 4 steps with ``--prefetch_depth`` 0 and 2: the same
    batches in the same order, so the same losses bit for bit."""
    losses = []
    for depth in (0, 2):
        loop = train_mod.main(ARGV + [
            "--checkpoint_path", str(tmp_path / f"d{depth}"),
            "--learning_steps", "4", "--prefetch_depth", str(depth)])
        assert loop.prefetch_depth == depth
        losses.append([h["loss"] for h in loop.history])
    assert len(losses[0]) == 4 and losses[0] == losses[1]


def test_settings_dataclass_keeps_jax_defaults():
    s = TrainSettings()
    assert (s.keep_checkpoints, s.debug_nans, s.prefetch_depth,
            s.compilation_cache_dir) == (0, False, 2, "auto")
