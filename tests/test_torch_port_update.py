"""The port's fused AdamW + EMA update against the JAX package's.

On the CPU the port's arm is the plain version ``torch_fused_update`` (the
``fused_update false`` arm); it is held against the JAX ``fused_adamw_ema``
(Pallas, interpreted) and the staged optax chain over 3 steps with weight
decay and two EMA rates, at rtol/atol 3e-7: the JAX package's own bar for
its kernel against optax (one ulp of f32; XLA may contract a multiply-add
where torch rounds twice). The CUDA kernel must equal the plain version
bit for bit on the card (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from distributed_pipeline_tpu.ops import fused_update as jfu  # noqa: E402
from distributed_pipeline_tpu_torch.ops import fused_update as fu  # noqa: E402

LR, WD, RATES = 3e-3, 0.01, ("0.9", "0.99")


def tree(rng):
    return {"w": rng.standard_normal((17, 9)).astype(np.float32),
            "b": rng.standard_normal((9,)).astype(np.float32)}


def flat(t):
    return torch.from_numpy(np.concatenate([t["b"].ravel(), t["w"].ravel()]))


def jflat(t):
    return np.concatenate([np.asarray(t["b"]).ravel(),
                           np.asarray(t["w"]).ravel()])


@pytest.mark.parametrize("schedule", [False, True])
def test_plain_update_matches_jax_kernel_and_optax(schedule):
    rng = np.random.default_rng(23)
    params, grads = tree(rng), tree(rng)
    total = 1000

    def lr_jax(c):
        c = jnp.asarray(c)
        return (jnp.asarray(LR, jnp.float32)
                * jnp.maximum(0.0, 1.0 - c / total) if schedule
                else jnp.asarray(LR, jnp.float32))

    def lr_torch(c):
        lr = torch.tensor(LR, dtype=torch.float32)
        return (lr * torch.clamp(1.0 - c.float() / total, min=0.0)
                if schedule else lr)

    opt = optax.adamw(lr_jax if schedule else LR, weight_decay=WD)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    state_o = state_f = opt.init(jp)
    po, pf = jp, jp
    eo = ef = {r: jp for r in RATES}

    p, g = flat(params), flat(grads)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    ema = p[None].repeat(len(RATES), 1)
    count = torch.zeros((), dtype=torch.int32)
    for _ in range(3):
        upd, state_o = opt.update(jg, state_o, po)
        po = optax.apply_updates(po, upd)
        eo = {r: jax.tree_util.tree_map(
            lambda e, x: e * float(r) + x * (1 - float(r)), eo[r], po)
            for r in RATES}
        pf, state_f, ef = jfu.fused_adamw_ema(pf, jg, state_f, ef,
                                              lr_fn=lr_jax, weight_decay=WD)
        scalars = fu.update_scalars(count, lr_torch)
        fu.torch_fused_update(p, g, mu, nu, ema, scalars,
                              [float(r) for r in RATES], weight_decay=WD)
        count += 1
        assert int(count) == int(state_f[0].count) == int(state_o[0].count)
        for got, refs in (
                (p, (po, pf)), (mu, (state_o[0].mu, state_f[0].mu)),
                (nu, (state_o[0].nu, state_f[0].nu)),
                (ema[0], (eo["0.9"], ef["0.9"])),
                (ema[1], (eo["0.99"], ef["0.99"]))):
            for ref in refs:
                np.testing.assert_allclose(got.numpy(), jflat(ref),
                                           rtol=3e-7, atol=3e-7)


def test_update_hbm_bytes_equals_jax_census():
    rng = np.random.default_rng(5)
    for _ in range(10):
        shapes = [tuple(rng.integers(1, 9, rng.integers(1, 4)))
                  for _ in range(rng.integers(1, 6))]
        leaves = [np.zeros(s, np.float32) for s in shapes]
        r = int(rng.integers(0, 4))
        assert fu.update_hbm_bytes([x.size for x in leaves], r) == \
            jfu.update_hbm_bytes(leaves, r)
    # the CUDA kernel's census at GPT-2 base, R = 3 (chip_smoke's bound)
    assert fu.update_hbm_bytes([124356864], 3, per_leaf_scalars=False) == \
        6466556928 + 12


def test_resolve_and_kernel_on_cpu_raises():
    cpu = torch.device("cpu")
    assert fu.resolve_fused_update("auto", cpu) is False
    assert fu.resolve_fused_update("false", cpu) is False
    with pytest.raises(ValueError, match="CUDA"):
        fu.resolve_fused_update("true", cpu)
    with pytest.raises(ValueError, match="auto/true/false"):
        fu.resolve_fused_update("maybe", cpu)
    p = torch.zeros(8)
    before = fu.launch_count()
    with pytest.raises(ValueError, match="CUDA"):
        fu.fused_adamw_ema(p, p, p, p, p[None], torch.zeros(3), [0.9])
    assert fu.launch_count() == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_bitwise_equals_plain_version(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    n, rates = 100003, [0.5, 0.9, 0.99]
    state = [torch.randn(n, generator=g, device=cuda_device)
             for _ in range(4)]
    state[3] = state[3].abs()
    ema = torch.randn((3, n), generator=g, device=cuda_device)
    a = [x.clone() for x in state] + [ema.clone()]
    b = [x.clone() for x in state] + [ema.clone()]
    count = torch.zeros((), dtype=torch.int32, device=cuda_device)
    for _ in range(3):
        scal = fu.update_scalars(count, lambda c: torch.tensor(
            3e-4, device=cuda_device) * (1.0 - c.float() / 20))
        fu.fused_adamw_ema(a[0], a[1], a[2], a[3], a[4], scal, rates,
                           weight_decay=0.01)
        fu.torch_fused_update(b[0], b[1], b[2], b[3], b[4], scal, rates,
                              weight_decay=0.01)
        count += 1
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
