"""The port's GPT-2 training path against the JAX package's, on the CPU.

* Data: the port's loader gives the JAX loader's batches.
* Trainer: a JAX ``TrainLoop`` and the port's ``TrainLoop(device cpu)``
  from the same flax weights (``convert.py``) on the same batches - GPT-2
  at 2 layers, D=32, H=2, V=64, seq_len 32, f32, batch 8 in microbatches of
  4, EMA rates 0.9 and 0.99, lr 1e-3 annealed over 1000 steps, clip 1.0 -
  once with the JAX kernel arms (interpreted Pallas flash attention and
  fused update) against the port's plain versions of the same kernels, and
  once with the XLA arms against the port's dense arm and plain update.
* Entry and resume: ``run.train --device cpu`` end to end; a resumed run
  equals an uninterrupted one bit for bit; no CUDA without ``--device cpu``
  raises; options not ported fail at parse time; ``run.serve`` loads the
  trained run directory.

Tolerances, each with its reason:
* per-step losses rtol 2e-5: f32 through 2 layers, another summation order;
* step-1 gradients rtol 5e-4 / atol 1e-6: the bar of
  tests/test_torch_parity.py for the same model against torch autograd;
* state after 3 steps: Adam divides mu by sqrt(nu), so where a gradient's
  relative rounding noise is large, an update can move by up to ``lr`` a
  step; on these inputs no element comes near that (measured on the CPU:
  params 1.4e-7, EMAs 2.4e-7, mu 7.8e-9, nu 5.5e-12 at most), so the bars
  are params and EMA copies 1e-5, mu 1e-7, nu 1e-10 absolute (about 50x
  the measured, 100x below ``lr``), at rtol 1e-4.
"""

import json
import os
import shutil

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
from distributed_pipeline_tpu_torch.config.train import (  # noqa: E402
    DEFERRED, parse_settings)
from distributed_pipeline_tpu_torch.convert import (  # noqa: E402
    opt_state_from_optax, params_from_flax)
from distributed_pipeline_tpu_torch.data import load_data_from_args  # noqa: E402
from distributed_pipeline_tpu_torch.models import \
    create_model_from_config  # noqa: E402
from distributed_pipeline_tpu_torch.run import sample as sample_mod  # noqa: E402
from distributed_pipeline_tpu_torch.run import serve as serve_mod  # noqa: E402
from distributed_pipeline_tpu_torch.run import train as train_mod  # noqa: E402
from distributed_pipeline_tpu_torch.utils.trainer import TrainLoop  # noqa: E402

CFG = dict(model_family="gpt2", vocab_size=64, seq_len=32, hidden_size=32,
           num_layers=2, num_heads=2, dtype="float32")
LOOP = dict(batch_size=8, microbatch=4, lr=1e-3, ema_rate="0.9,0.99",
            learning_steps=1000, gradient_clipping=1.0,
            log_interval=10 ** 9, save_interval=10 ** 9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loader_gives_the_jax_batches(seed):
    kw = dict(batch_size=4, dataset="synthetic-lm", seq_len=24,
              vocab_size=50, seed=seed)
    for split, skip, workers in (("train", 0, 0), ("train", 3, 2),
                                 ("valid", 1, 0)):
        ours = load_data_from_args(split, skip_batches=skip,
                                   data_loader_workers=workers, **kw)
        ref = jax_load_data(split, skip_batches=skip, **kw)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


def _batches(n):
    it = jax_load_data("train", batch_size=8, dataset="synthetic-lm",
                       seq_len=32, vocab_size=64, seed=3)
    return [next(it) for _ in range(n)]


def _flax(tree):
    return params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                   meta.unbox(tree)))


@pytest.mark.parametrize("jax_arms,port_arms", [
    (("pallas", True), ("torch", "false")),
    (("xla", False), ("xla", "false")),
], ids=["kernel-arms", "xla-arms"])
def test_trainer_matches_jax_trainloop(tmp_path, jax_arms, port_arms):
    attn, fused = jax_arms
    jloop = JaxTrainLoop(
        model=jax_create(**CFG, attention_impl=attn), data=None,
        mesh=make_mesh(dp=1, devices=jax.devices()[:1]), seed=5,
        checkpoint_dir=str(tmp_path / "jax"), fused_update=fused, **LOOP)
    init = _flax(jloop.state.params)
    port = TrainLoop(
        model=create_model_from_config(**CFG, attention_impl=port_arms[0],
                                       device="cpu"),
        data=None, init_params=init, fused_update=port_arms[1],
        checkpoint_dir="", **LOOP)
    batches = _batches(3)

    # step-1 gradients (averaged over the two microbatches)
    port.forward_backward(batches[0])
    got = {k: v.clone() for k, v in port.state_dict_of(port.grads).items()}
    wl = jloop.workload

    def micro_loss(p, mb):
        return wl.compute_losses(p, mb, jax.random.PRNGKey(0))["loss"]

    grads = [jax.grad(micro_loss)(jloop.state.params,
                                  {k: v[i * 4:(i + 1) * 4]
                                   for k, v in batches[0].items()})
             for i in range(2)]
    want = _flax(jax.tree_util.tree_map(lambda a, b: (a + b) * 0.5, *grads))
    for key in ("word_emb.embedding", "pos_emb",
                "backbone.block_0.attn.qkv", "backbone.block_1.mlp.wo",
                "backbone.ln_f.scale"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=5e-4, atol=1e-6, err_msg=key)

    for batch in batches:
        jm = jloop.run_step(batch)
        pm = port.run_step(batch)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=2e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(pm["lr"]), float(jm["lr"]),
                                   rtol=1e-7)

    opt = opt_state_from_optax(jloop.state.opt_state)
    assert int(port.count) == opt["count"] == 3
    checks = [(port.state_dict_of(port.params),
               _flax(jloop.state.params), 1e-5),
              (port.state_dict_of(port.mu), opt["mu"], 1e-7),
              (port.state_dict_of(port.nu), opt["nu"], 1e-10)]
    for rate, ema in port.ema_state_dicts().items():
        checks.append((ema, _flax(jloop.state.ema[rate]), 1e-5))
    for ours, ref, atol in checks:
        for key in ref:
            np.testing.assert_allclose(ours[key].numpy(), ref[key].numpy(),
                                       rtol=1e-4, atol=atol, err_msg=key)


ARGV = ["--device", "cpu", "--model_family", "gpt2", "--dataset",
        "synthetic-lm", "--seq_len", "32", "--vocab_size", "64",
        "--hidden_size", "32", "--num_layers", "2", "--num_heads", "2",
        "--dtype", "float32", "--batch_size", "8", "--microbatch", "4",
        "--ema_rate", "0.9,0.99", "--lr", "1e-3", "--log_interval", "2",
        "--data_loader_workers", "0"]


def test_run_train_cpu_end_to_end_and_serve(tmp_path, capsys):
    run = str(tmp_path / "run")
    loop = train_mod.main(ARGV + ["--checkpoint_path", run,
                                  "--learning_steps", "4",
                                  "--save_interval", "3"])
    assert loop.step == 4 and [h["step"] for h in loop.history] == \
        [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in loop.history)
    names = set(os.listdir(run))
    for step in (3, 4):
        assert {f"model_{step:06d}.pt", f"opt_{step:06d}.pt",
                f"meta_{step:06d}.json", f"ema_0.9_{step:06d}.pt",
                f"ema_0.99_{step:06d}.pt"} <= names
    assert {"training_args.json", "log.txt", "progress.csv"} <= names
    with open(os.path.join(run, "meta_000004.json")) as f:
        assert json.load(f)["samples"] == 32
    capsys.readouterr()
    result = serve_mod.main([
        "--checkpoint_path", run, "--device", "cpu", "--decode_slots", "2",
        "--page_size", "4", "--max_prompt_len", "8",
        "--synthetic_requests", "3", "--max_new_tokens", "4"])
    assert result["step"] == 4 and result["decode_tokens"] == 12


def test_resume_is_bitwise(tmp_path):
    """4 steps in one run == 2 steps, then a resume from the step-2
    checkpoint to step 4 (same schedule, data fast-forwarded)."""
    full, half = str(tmp_path / "full"), str(tmp_path / "half")
    train_mod.main(ARGV + ["--checkpoint_path", full, "--learning_steps",
                           "4", "--save_interval", "2"])
    os.makedirs(half)
    for name in os.listdir(full):
        if "000002" in name or name == "training_args.json":
            shutil.copy(os.path.join(full, name), half)
    loop = train_mod.main(ARGV + ["--checkpoint_path", half,
                                  "--learning_steps", "4",
                                  "--save_interval", "2"])
    assert loop.resumed_from == half and [h["step"] for h in loop.history] \
        == [3, 4]
    for name in ("model_000004.pt", "opt_000004.pt", "ema_0.9_000004.pt",
                 "ema_0.99_000004.pt"):
        a = torch.load(os.path.join(full, name), weights_only=True)
        b = torch.load(os.path.join(half, name), weights_only=True)
        if name.startswith("opt"):
            assert a["count"] == b["count"] == 4
            a, b = {**a["mu"], **{"nu." + k: v for k, v in a["nu"].items()}},\
                {**b["mu"], **{"nu." + k: v for k, v in b["nu"].items()}}
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)


def test_run_train_without_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in ARGV if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_mod.main(argv + ["--checkpoint_path", str(tmp_path / "r"),
                               "--learning_steps", "1"])


# refusals lifted since: MoE with --sequence > 1 is trained (A.8e); on one
# process the sequence axis's own check refuses --sequence 2. The sharded
# state (A.8c) is trained: --shard_optimizer parses, --fsdp 2 and --dp 2
# fail the mesh's own check on one process, an unreadable
# --partition_rules fails naming the flag, and --expert names A.8g. The
# stacked layers and the pipe schedule (A.9a) are trained
LIFTED = {"ROADMAP A.8e": "must divide the world size",
          "ROADMAP A.8c": "ROADMAP A.8g",
          ("--fsdp", "2"): "must multiply to the world size",
          ("--dp", "2"): "must multiply to the world size",
          ("--shard_optimizer", "true"): None,
          ("--partition_rules", "x"): "--partition_rules",
          # the stacked layers and the pipe schedule (A.9a) are trained:
          # their flags parse; the MPMD runtime (A.9b) needs the stacked
          # layers
          ("--scan_layers", "true"): None,
          ("--pp_chunks", "8"): None,
          ("--scan_unroll", "2"): None,
          ("--mpmd", "true"): "--mpmd requires --scan_layers true"}


@pytest.mark.parametrize("entry,argv,expect", [
    ("train", ["--expert", "2"], "ROADMAP A.8c"),
    ("train", ["--sequence", "2"], "must divide the world size"),
    ("train", ["--scan_layers", "true"], "ROADMAP A.9"),
    ("train", ["--pp_chunks", "8"], "ROADMAP A.9"),
    ("train", ["--fsdp", "2"], "ROADMAP A.8"),
    ("train", ["--dp", "2"], "ROADMAP A.8"),
    ("train", ["--shard_optimizer", "true"], "ROADMAP A.8"),
    ("train", ["--partition_rules", "x"], "ROADMAP A.8"),
    ("train", ["--auto_tune", "true"], "ROADMAP A.10"),
    ("train", ["--trace", "true"], None),
    ("train", ["--cost_ledger", "true"], None),
    ("train", ["--sanitize", "true"], None),
    ("train", ["--chaos_plan", "{bad"], "chaos plan is not valid JSON"),
    ("train", ["--profile_dir", "x"], None),
    ("train", ["--mpmd", "true"], "ROADMAP A.9"),
    ("train", ["--moe_experts", "4", "--sequence", "2"], "ROADMAP A.8e"),
    ("train", ["--scan_unroll", "2"], "ROADMAP A.9"),
    ("train", ["--noise_schedule", "quadratic"], "invalid choice"),
    ("sample", ["--top_k", "5"], "Pass --temperature > 0"),
    ("sample", ["--top_p", "0.9"], "Pass --temperature > 0")])
def test_options_not_ported_fail_at_parse_time(entry, argv, expect, tmp_path,
                                               capsys):
    """Options not trained yet fail at parse time, naming the ROADMAP item
    that brings them; so do an unknown noise schedule, a malformed chaos
    plan and run.sample's ``--top_k``/``--top_p`` without ``--temperature
    > 0`` (greedy decoding would ignore them), as in the JAX entry point.
    The training tooling's options (``expect`` None) now parse, and so
    does a refusal a later slice lifted (``LIFTED``: the item, and what
    the next check says instead)."""
    expect = LIFTED.get(tuple(argv), LIFTED.get(expect, expect))
    if expect is None:
        s = parse_settings(argv)
        flag = argv[0][2:]
        assert flag not in DEFERRED
        assert str(getattr(s, flag)).lower() == argv[1]
        return
    with pytest.raises(SystemExit) as e:
        if entry == "train":
            parse_settings(argv)
        else:
            (tmp_path / "training_args.json").write_text(
                json.dumps({"model_family": "gpt2"}))
            sample_mod.main(["--checkpoint_path", str(tmp_path),
                             "--device", "cpu", *argv])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert expect in err
    flag = argv[0][2:] if argv else ""
    if flag in DEFERRED:
        assert DEFERRED[flag][1] in err


def test_config_json_is_exclusive_and_takes_device(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"lr": 3e-4, "seq_len": 64}))
    s = parse_settings(["--config_json", str(cfg), "--device", "cpu"])
    assert (s.lr, s.seq_len, s.device, s.model_family) == \
        (3e-4, 64, "cpu", "diffuseq")
    with pytest.raises(SystemExit):
        parse_settings(["--config_json", str(cfg), "--lr", "1e-4"])
