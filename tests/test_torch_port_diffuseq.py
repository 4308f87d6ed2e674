"""The port's DiffuSeq slice against the JAX package's, on the CPU.

DiffuSeq at V=64, L=16, D=32, H=2, 2 layers, batch 8, f32 unless stated
(the sizes of tests/test_torch_parity.py). Every reference value comes from
the JAX package on the CPU, on the same weights (the flax tree through
``convert.params_from_flax``) and the same numpy inputs; the port's random
draws are replaced by the JAX package's (``t`` and ``noise`` from the same
keys) through the port's draw hooks.

Tolerances, each with its reason:
* schedules, datasets, loader streams, sampled tokens: bitwise / identical;
* ``timestep_embedding``: rtol 1e-6 with atol 1e-5. XLA's f32 ``exp`` is
  not correctly rounded; at dim 32 it differs from torch's by one ulp in 2
  of the 16 frequencies (measured on the CPU), and ``t`` up to 2000 carries
  that ulp into the sine's argument (3.5e-6 absolute measured);
* forward in f32: rtol 1e-5, atol 1e-5 (that embedding ulp, through the
  time MLP; 2.5e-6 measured against outputs up to 4.5); ``logits``: rtol
  1e-5;
* forward in bf16: within two bf16 ulps of the output's largest magnitude
  (atol 2^-6 max|ref|): another order of bf16 roundings through 2 layers
  (one ulp, 0.03125 at |x| ~ 4.5, measured);
* loss and each term rtol 1e-5; gradients rtol 5e-4 / atol 1e-6 (the bars
  of tests/test_torch_parity.py:299-310);
* 3 trainer steps: the bars of tests/test_torch_port_train.py (losses
  rtol 2e-5; params and EMAs 1e-5, mu 1e-7, nu 1e-10 absolute at rtol
  1e-4).
"""

import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from flax.core import meta  # noqa: E402

from distributed_pipeline_tpu.data import \
    load_data_from_args as jax_load_data  # noqa: E402
from distributed_pipeline_tpu.data.dataset import \
    JsonlSeq2SeqDataset as JaxJsonl  # noqa: E402
from distributed_pipeline_tpu.data.dataset import \
    SyntheticSeq2SeqDataset as JaxSeq2Seq  # noqa: E402
from distributed_pipeline_tpu.data.tokenizer import train_bpe  # noqa: E402
from distributed_pipeline_tpu.models import \
    create_model_from_config as jax_create  # noqa: E402
from distributed_pipeline_tpu.models import \
    sampling as jax_sampling  # noqa: E402
from distributed_pipeline_tpu.models.diffuseq import \
    DiffuSeqModel as JaxDiffuSeq  # noqa: E402
from distributed_pipeline_tpu.models.diffuseq import \
    timestep_embedding as jax_temb  # noqa: E402
from distributed_pipeline_tpu.models.diffusion import \
    make_schedule as jax_schedule  # noqa: E402
from distributed_pipeline_tpu.parallel import make_mesh  # noqa: E402
from distributed_pipeline_tpu.utils.trainer import \
    TrainLoop as JaxTrainLoop  # noqa: E402
from distributed_pipeline_tpu_torch.convert import (  # noqa: E402
    init_params, opt_state_from_optax, params_from_flax)
from distributed_pipeline_tpu_torch.data import \
    load_data_from_args  # noqa: E402
from distributed_pipeline_tpu_torch.data.dataset import (  # noqa: E402
    JsonlSeq2SeqDataset, SyntheticSeq2SeqDataset)
from distributed_pipeline_tpu_torch.models import (  # noqa: E402
    compute_losses, create_model_from_config)
from distributed_pipeline_tpu_torch.models import sampling  # noqa: E402
from distributed_pipeline_tpu_torch.models.diffuseq import \
    timestep_embedding  # noqa: E402
from distributed_pipeline_tpu_torch.models.diffusion import \
    make_schedule  # noqa: E402
from distributed_pipeline_tpu_torch.run import \
    sample as sample_mod  # noqa: E402
from distributed_pipeline_tpu_torch.run import train as train_mod  # noqa: E402
from distributed_pipeline_tpu_torch.utils.trainer import \
    TrainLoop  # noqa: E402

V, L, D, H, LAYERS, B, E = 64, 16, 32, 2, 2, 8, 128
CFG = dict(model_family="diffuseq", vocab_size=V, seq_len=L, hidden_size=D,
           num_layers=LAYERS, num_heads=H, diffusion_steps=2000,
           dtype="float32", attention_impl="xla")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _pair(dtype="float32", seed=3, **over):
    """(JAX workload, numpy flax params, port model with those weights)."""
    cfg = {**CFG, "dtype": dtype, **over}
    wl = jax_create(**cfg)
    params = _np(wl.init_params(jax.random.PRNGKey(seed)))
    model = create_model_from_config(**cfg, device="cpu")
    model.load_state_dict(params_from_flax(params))
    return wl, params, model


def _batch(seed=0, batch_size=B):
    """A synthetic seq2seq batch (its rows are padded) from the JAX
    loader."""
    return next(jax_load_data("train", batch_size=batch_size,
                              dataset="synthetic-seq2seq", seq_len=L,
                              vocab_size=V, seed=seed, skip_batches=seed))


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _draws(key, sched, n=B):
    """The draws JAX's ``diffuseq_losses`` makes from ``key``."""
    rng_t, rng_noise = jax.random.split(key)
    return {"t": torch.from_numpy(np.array(sched.sample_t(rng_t, n))),
            "noise": torch.from_numpy(np.array(
                jax.random.normal(rng_noise, (n, L, E), jnp.float32)))}


@pytest.mark.parametrize("name", ["sqrt", "cosine", "linear"])
def test_schedules_are_bitwise_the_jax_tables(name):
    for steps in (2000, 37):
        ours, ref = make_schedule(name, steps), jax_schedule(name, steps)
        assert ours.num_steps == ref.num_steps == steps
        for field in ("betas", "alphas_cumprod", "sqrt_alphas_cumprod",
                      "sqrt_one_minus_alphas_cumprod"):
            a, b = getattr(ours, field), getattr(ref, field)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {field}")


@pytest.mark.parametrize("dim", [31, 32])
def test_timestep_embedding_matches(dim):
    t = np.random.default_rng(dim).integers(0, 2000, 64).astype(np.int32)
    t[:2] = (0, 1999)
    ref = np.asarray(jax_temb(jnp.asarray(t), dim))
    got = timestep_embedding(torch.from_numpy(t), dim).numpy()
    assert got.shape == ref.shape == (64, dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


def test_params_from_flax_maps_the_diffuseq_tree():
    """At one layer ``model.init`` lists 20 leaves; the port's model has
    exactly those paths and shapes, and ``init_params`` draws that tree."""
    wl, params, model = _pair(num_layers=1)
    sd = params_from_flax(params)
    assert len(sd) == 20
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert tuple(sd["time_mlp.layers_0.kernel"].shape) == (D, 4 * D)
    assert tuple(sd["word_emb.embedding"].shape) == (V, E)
    fresh = init_params({**CFG, "num_layers": 1, "hidden_size": 256,
                         "num_heads": 4}, seed=0)
    assert set(fresh) == set(sd)
    k = fresh["time_mlp.layers_0.kernel"]      # lecun_normal, truncated
    bound = 2 * 256 ** -0.5 / .87962566103423978
    assert float(k.abs().max()) <= bound
    assert abs(float(k.std()) - 256 ** -0.5) < 0.02 * 256 ** -0.5
    assert float(fresh["in_proj.bias"].abs().max()) == 0.0


def test_forward_and_logits_match_f32():
    wl, params, model = _pair()
    batch = _batch()
    assert (batch["pad_mask"] == 0).any(), "rows must carry real padding"
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, L, E)).astype(np.float32)
    t = rng.integers(0, 2000, B).astype(np.int32)
    ref = np.asarray(wl.model.apply(params, jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(batch["pad_mask"])))
    ref_logits = np.asarray(wl.model.apply(params, jnp.asarray(ref),
                                           method=JaxDiffuSeq.logits))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(batch["pad_mask"]))
        logits = model.logits(torch.from_numpy(ref.copy()))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-5)


def test_forward_matches_jax_bf16():
    wl, params, model = _pair(dtype="bfloat16")
    batch = _batch(1)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, L, E)).astype(np.float32)
    t = rng.integers(0, 2000, B).astype(np.int32)
    ref = np.asarray(wl.model.apply(params, jnp.asarray(x), jnp.asarray(t),
                                    jnp.asarray(batch["pad_mask"])))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(batch["pad_mask"])).numpy()
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2 ** -6 * float(np.abs(ref).max()))


def test_diffuseq_losses_and_grads_match_with_jax_draws():
    wl, params, model = _pair()
    batch = _batch(2)
    key = jax.random.PRNGKey(9)

    def jax_loss(p):
        d = wl.compute_losses(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, key)
        return d["loss"], d

    (_, ref), grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    got = compute_losses(model, _t(batch), _draws(key, wl.schedule))
    assert set(got) == set(ref) == {"loss", "mse", "tT", "decoder_nll"}
    for name in got:
        np.testing.assert_allclose(float(got[name].detach()),
                                   float(ref[name]), rtol=1e-5, err_msg=name)
    got["loss"].backward()
    want = params_from_flax(_np(grads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=5e-4, atol=1e-6, err_msg=name)


LOOP = dict(batch_size=B, microbatch=4, lr=1e-3, ema_rate="0.9,0.99",
            learning_steps=1000, gradient_clipping=1.0,
            log_interval=10 ** 9, save_interval=10 ** 9)


def test_trainer_matches_jax_trainloop(tmp_path):
    """3 steps of 2 microbatches: the port's TrainLoop, fed the JAX draws
    ``fold_in(fold_in(PRNGKey(seed), step), i)``, against the JAX one."""
    seed = 5
    jloop = JaxTrainLoop(
        model=jax_create(**CFG), data=None,
        mesh=make_mesh(dp=1, devices=jax.devices()[:1]), seed=seed,
        checkpoint_dir=str(tmp_path / "jax"), fused_update=False, **LOOP)
    base = jax.random.PRNGKey(seed)
    sched = jloop.workload.schedule

    def draws(step, i):
        key = jax.random.fold_in(jax.random.fold_in(base, step), i)
        return _draws(key, sched, n=4)

    port = TrainLoop(
        model=create_model_from_config(**CFG, device="cpu"), data=None,
        init_params=params_from_flax(_np(jloop.state.params)),
        fused_update="false", checkpoint_dir="", draws=draws, **LOOP)
    for s in range(3):
        batch = _batch(s)
        jm, pm = jloop.run_step(batch), port.run_step(batch)
        for k in ("loss", "mse", "tT", "decoder_nll"):
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=2e-5, err_msg=k)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    opt = opt_state_from_optax(jloop.state.opt_state)
    assert int(port.count) == opt["count"] == 3
    checks = [(port.state_dict_of(port.params),
               params_from_flax(_np(jloop.state.params)), 1e-5),
              (port.state_dict_of(port.mu), opt["mu"], 1e-7),
              (port.state_dict_of(port.nu), opt["nu"], 1e-10)]
    for rate, ema in port.ema_state_dicts().items():
        checks.append((ema, params_from_flax(_np(jloop.state.ema[rate])),
                       1e-5))
    for ours, ref, atol in checks:
        for key in ref:
            np.testing.assert_allclose(ours[key].numpy(), ref[key].numpy(),
                                       rtol=1e-4, atol=atol, err_msg=key)


@pytest.mark.parametrize("seed", [0, 3])
def test_seq2seq_items_and_loader_streams_are_bitwise(seed):
    ours = SyntheticSeq2SeqDataset(seq_len=L, vocab_size=V, seed=seed)
    ref = JaxSeq2Seq(seq_len=L, vocab_size=V, seed=seed)
    for i in (0, 1, 7, 99_999):
        a, b = ours[i], ref[i]
        for k in b:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    kw = dict(batch_size=4, seq_len=L, vocab_size=V, seed=seed)
    for split, skip, workers in (("train", 0, 0), ("train", 3, 2),
                                 ("valid", 1, 0)):
        got = load_data_from_args(split, skip_batches=skip,
                                  data_loader_workers=workers, **kw)
        want = jax_load_data(split, skip_batches=skip, **kw)
        for _ in range(3):
            a, b = next(got), next(want)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


CORPUS = [
    {"src": "the cat sat on the mat", "trg": "a cat is sitting"},
    {"src": "hello world", "tgt": "bonjour le monde"},
    {"src": "naïve café ünïcode words", "trg": "mots inconnus"},
    {"src": " ".join(f"w{i}" for i in range(30)), "trg": "long source"},
    {"src": "short", "trg": " ".join(f"t{i}" for i in range(30))},
    {"src": "", "trg": ""},
]


@pytest.mark.parametrize("mode", ["bpe", "vocab", "hash"])
def test_jsonl_items_are_bitwise(tmp_path, mode):
    lines = []
    for i, obj in enumerate(CORPUS):
        lines.append(json.dumps(obj) + "\n")
        lines.append(["\n", "   \n", "\t\n"][i % 3])   # blank lines skipped
    (tmp_path / "train.jsonl").write_text("".join(lines))
    texts = [str(o.get(k, "")) for o in CORPUS for k in ("src", "trg")]
    if mode == "bpe":
        (tmp_path / "bpe.json").write_text(json.dumps(train_bpe(texts, V)))
    elif mode == "vocab":
        words = sorted({w for t in texts for w in t.split()})
        (tmp_path / "vocab.json").write_text(json.dumps(
            {w: 4 + i % (V - 4) for i, w in enumerate(words[:20])}))
    ours = JsonlSeq2SeqDataset(str(tmp_path), "train", seq_len=L,
                               vocab_size=V)
    ref = JaxJsonl(str(tmp_path), "train", seq_len=L, vocab_size=V)
    assert len(ours) == len(ref) == len(CORPUS)
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{i} {k}")
    got = next(load_data_from_args("train", data_dir=str(tmp_path),
                                   batch_size=4, seq_len=L, vocab_size=V))
    want = next(jax_load_data("train", data_dir=str(tmp_path), batch_size=4,
                              seq_len=L, vocab_size=V))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("clamp", [True, False], ids=["clamp", "no-clamp"])
def test_diffuseq_sample_token_identical(clamp):
    wl, params, model = _pair(diffusion_steps=50)
    batch = _batch(3)
    key = jax.random.PRNGKey(11)
    ref = np.asarray(jax_sampling.diffuseq_sample(
        wl, params, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        sample_steps=4, clamp=clamp))
    noise = torch.from_numpy(np.array(
        jax.random.normal(key, (B, L, E), jnp.float32)))
    got = sampling.diffuseq_sample(model, _t(batch), noise, sample_steps=4,
                                   clamp=clamp).numpy()
    np.testing.assert_array_equal(got, ref)
    src = batch["input_mask"] == 0
    np.testing.assert_array_equal(got[src], batch["input_ids"][src])


def test_mbr_scores_and_pick_identical():
    rng = np.random.default_rng(4)
    cands = rng.integers(4, 8, (5, B, L)).astype(np.int32)
    tgt = rng.integers(0, 2, (B, L)).astype(np.float32)
    tgt[0] = 0                                   # an empty span
    np.testing.assert_allclose(
        sampling._mbr_scores(torch.from_numpy(cands),
                             torch.from_numpy(tgt)).numpy(),
        np.asarray(jax_sampling._mbr_scores(jnp.asarray(cands),
                                            jnp.asarray(tgt))), rtol=1e-6)
    wl, params, model = _pair(diffusion_steps=50)
    batch = _batch(4)
    key = jax.random.PRNGKey(12)
    ref = np.asarray(jax_sampling.diffuseq_sample_mbr(
        wl, params, {k: jnp.asarray(v) for k, v in batch.items()}, key,
        num_candidates=3, sample_steps=4))
    noise = torch.stack([torch.from_numpy(np.array(jax.random.normal(
        k, (B, L, E), jnp.float32))) for k in jax.random.split(key, 3)])
    got = sampling.diffuseq_sample_mbr(model, _t(batch), noise,
                                       num_candidates=3, sample_steps=4)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0.0 <= float(sampling.target_span_accuracy(got, _t(batch))) <= 1.0


ARGV = ["--device", "cpu", "--seq_len", "16", "--vocab_size", "64",
        "--hidden_size", "32", "--num_layers", "2", "--num_heads", "2",
        "--dtype", "float32", "--batch_size", "8", "--microbatch", "4",
        "--ema_rate", "0.9,0.99", "--lr", "1e-3", "--log_interval", "2",
        "--diffusion_steps", "100", "--data_loader_workers", "0"]


@pytest.fixture(scope="module")
def diffuseq_run(tmp_path_factory):
    """``run.train --device cpu`` with no family flag: 4 steps, saved at 2
    and 4, with an eval and a decode pass at steps 2 and 4."""
    run = str(tmp_path_factory.mktemp("diffuseq") / "full")
    loop = train_mod.main(ARGV + [
        "--checkpoint_path", run, "--learning_steps", "4",
        "--save_interval", "2", "--eval_interval", "2",
        "--eval_decode", "true", "--eval_decode_sample_steps", "3"])
    return run, loop


def test_run_train_defaults_to_diffuseq_and_resumes_bitwise(diffuseq_run,
                                                             tmp_path):
    full, loop = diffuseq_run
    with open(os.path.join(full, "training_args.json")) as f:
        targs = json.load(f)
    assert (targs["model_family"], targs["dataset"]) == \
        ("diffuseq", "synthetic-seq2seq")
    assert loop.model.family == "diffuseq" and loop.step == 4
    assert [h["step"] for h in loop.history] == [1, 2, 3, 4]
    assert all(math.isfinite(h[k]) for h in loop.history
               for k in ("loss", "mse", "tT", "decoder_nll"))
    with open(os.path.join(full, "progress.csv")) as f:
        header = f.readline().strip().split(",")
    assert "decode_acc" in header and "eval_loss" in header
    half = str(tmp_path / "half")
    os.makedirs(half)
    for name in os.listdir(full):
        if "000002" in name or name == "training_args.json":
            shutil.copy(os.path.join(full, name), half)
    resumed = train_mod.main(ARGV + ["--checkpoint_path", half,
                                     "--learning_steps", "4",
                                     "--save_interval", "2"])
    assert resumed.resumed_from == half and \
        [h["step"] for h in resumed.history] == [3, 4]
    for name in ("model_000004.pt", "opt_000004.pt", "ema_0.9_000004.pt",
                 "ema_0.99_000004.pt"):
        a = torch.load(os.path.join(full, name), weights_only=True)
        b = torch.load(os.path.join(half, name), weights_only=True)
        if name.startswith("opt"):
            assert a["count"] == b["count"] == 4
            a = {**a["mu"], **{"nu." + k: v for k, v in a["nu"].items()}}
            b = {**b["mu"], **{"nu." + k: v for k, v in b["nu"].items()}}
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), (name, k)


def test_run_sample_prints_the_jax_keys(diffuseq_run, tmp_path, capsys):
    run, _ = diffuseq_run
    capsys.readouterr()
    out = str(tmp_path / "pred.jsonl")
    result = sample_mod.main(["--checkpoint_path", run, "--device", "cpu",
                              "--batch_size", "4", "--num_batches", "2",
                              "--sample_steps", "3", "--mbr", "2",
                              "--ema", "0.99", "--out", out])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result
    assert set(result) == {"step", "params", "decode_acc", "eval_loss",
                           "num_batches", "batch_size"}
    assert (result["step"], result["params"]) == (4, "ema_0.99")
    assert 0.0 <= result["decode_acc"] <= 1.0
    assert math.isfinite(result["eval_loss"])
    with open(out) as f:
        rows = [json.loads(line) for line in f]
    assert len(rows) == 8 and all(len(r["pred"]) == 16 for r in rows)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_diffuseq_step_kernels_against_plain(cuda_device):
    """One bf16 DiffuSeq step with the flash kernels (bidirectional,
    pad-masked) and the fused update, against the plain versions: loss
    within 0.5% and grad norm within 3% (the bars of chip_smoke.py's
    training steps)."""
    cfg = dict(CFG, hidden_size=128, dtype="bfloat16", seq_len=128)
    batch = next(load_data_from_args("train", batch_size=4, seq_len=128,
                                     vocab_size=V, seed=0))
    out = {}
    for arm, (attn, fused) in (("kernels", ("cuda", "true")),
                               ("plain", ("torch", "false"))):
        loop = TrainLoop(
            model=create_model_from_config(**{**cfg, "attention_impl": attn},
                                           device=cuda_device),
            data=None, batch_size=4, microbatch=2, seed=0,
            fused_update=fused, checkpoint_dir="")
        m = loop.run_step(batch)
        out[arm] = (float(m["loss"]), float(m["grad_norm"]))
    (la, ga), (lb, gb) = out["kernels"], out["plain"]
    assert abs(la - lb) <= 5e-3 * abs(lb) and abs(ga - gb) <= 3e-2 * gb
