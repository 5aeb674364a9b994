"""The port's Switch-MoE VideoViT (tensor_stream_torch/models/moe.py)
against the JAX package's on the CPU, at a small size (4 experts, depth 2,
dim 32, 2 heads, patch 8, tubelet 2 over clips [4, 4, 16, 16, 3]: 8 tokens
a group, capacity 3, so some tokens are dropped).

The flax parameters are initialized and shifted by seeded numpy noise,
then converted with ``moe_state_dict_from_flax``. The JAX package's own
MoE laws (tests/test_moe.py) are repeated on the port: one expert equals
the dense MLP, tokens past capacity give exactly zero, and uniform routing
gives balance 1.

Tolerances: f32, the same math up to reduction order: logits and
outputs within 1e-4 of their largest value, aux and loss within 1e-5
relative, each gradient within 1e-4 of the largest gradient (GRAD_TOL);
the bf16 forward within 2e-2 (the port's TOL).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_stream_tpu.models import moe as jmoe
from tensor_stream_torch.models import (VideoMoE, make_moe_train_step,
                                        moe_loss, moe_state_dict_from_flax)
from tensor_stream_torch.models.moe import MoEMLP
from tensor_stream_torch.models.video_vit import _Init

CLIP = (4, 4, 16, 16, 3)
KW = dict(num_classes=2, num_experts=4, depth=2, dim=32, num_heads=2,
          patch=8, tubelet_t=2)
TOL = 1e-4
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
MASK = np.array([True, False, True, False])


def clips_of(seed):
    return np.random.default_rng(seed).uniform(0, 1, CLIP).astype(np.float32)


def shifted(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)


def pair(dtype=torch.float32, seed=0, **kw):
    cfg = {**KW, **kw}
    jm = jmoe.VideoMoE(compute_dtype=(jnp.float32 if dtype == torch.float32
                                      else jnp.bfloat16), **cfg)
    params = shifted(jm.init(jax.random.PRNGKey(seed), jnp.zeros(CLIP)),
                     seed + 1)
    tm = VideoMoE(compute_dtype=dtype, frames=CLIP[1], size=CLIP[2],
                  device="cpu", **cfg)
    tm.load_state_dict(moe_state_dict_from_flax(params), strict=True)
    return jm, params, tm


def close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def mlp_pair(num_experts, hidden_mult, capacity_factor, x, seed=0,
             **kw):
    jm = jmoe.MoEMLP(num_experts=num_experts, hidden_mult=hidden_mult,
                     capacity_factor=capacity_factor,
                     compute_dtype=jnp.float32, **kw)
    params = shifted(jm.init(jax.random.PRNGKey(seed), x), seed + 1)
    tm = MoEMLP(x.shape[-1], num_experts, hidden_mult, capacity_factor,
                torch.float32, _Init("cpu", torch.Generator()), **kw)
    tm.load_state_dict(moe_state_dict_from_flax(params), strict=True)
    return jm, params, tm


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25, 4.0])
def test_moe_mlp_matches_jax(capacity_factor):
    x = np.random.default_rng(2).standard_normal((3, 12, 16)).astype(
        np.float32)
    jm, params, tm = mlp_pair(4, 2, capacity_factor, x)
    want, waux = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x))
    close(got, want, TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_forward_matches_jax():
    jm, params, tm = pair()
    x = clips_of(3)
    want, waux = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x))
    assert got.shape == (CLIP[0], 2)
    close(got, want, TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


def test_bf16_forward_matches_jax():
    jm, params, tm = pair(torch.bfloat16)
    x = clips_of(4)
    want, waux = jm.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got, aux = tm(torch.from_numpy(x))
    close(got, want, BF16_TOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=BF16_TOL)


def test_loss_and_grads_match_jax():
    """make_moe_train_step's loss (CE + aux) and every gradient."""
    jm, params, tm = pair()
    clips = clips_of(5)

    def loss_fn(p):
        x = jnp.where(jnp.asarray(MASK)[:, None, None, None, None],
                      jnp.flip(clips, axis=1), clips)
        labels = jnp.asarray(MASK).astype(jnp.int32)
        logits, aux = jm.apply(p, x)
        ce = -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                  labels[:, None], axis=1).mean()
        return ce + aux, aux
    (jl, jaux), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    loss, _, aux = moe_loss(tm, torch.from_numpy(clips),
                            torch.from_numpy(MASK))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    want = moe_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           jgrads))
    assert set(want) == {n for n, _ in tm.named_parameters()}
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in tm.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, msg=name)


def test_single_expert_equals_dense_mlp():
    """E = 1: every token goes to expert 0 with gate 1 and ample
    capacity, so the layer is the plain 2-layer GELU MLP."""
    x = torch.randn(2, 12, 16, generator=torch.Generator().manual_seed(1))
    tm = MoEMLP(16, 1, 2, 1.0, torch.float32,
                _Init("cpu", torch.Generator().manual_seed(0)))
    with torch.no_grad():
        got, _ = tm(x)
        h = torch.nn.functional.gelu(x @ tm.w1[0] + tm.b1[0],
                                     approximate="tanh")
        want = h @ tm.w2[0] + tm.b2[0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_capacity_overflow_drops_tokens():
    """A zero router ties every token, argmax picks expert 0 (the first
    index, as jnp.argmax), and the tokens past its capacity C = 2 give
    exactly zero."""
    s, d, e = 8, 16, 2
    tm = MoEMLP(d, e, 2, 0.5, torch.float32,
                _Init("cpu", torch.Generator().manual_seed(0)))
    with torch.no_grad():
        tm.router.weight.zero_()
        x = torch.randn(1, s, d, generator=torch.Generator().manual_seed(1))
        out, aux = tm(x)
        _, _, mask, keep, _ = tm.route(x)
    assert tm.capacity(s) == 2
    assert bool(mask[..., 0].all()) and int(keep.sum()) == 2
    assert out[0, :2].abs().sum() > 0
    assert torch.equal(out[0, 2:], torch.zeros(s - 2, d))
    assert torch.isfinite(aux)


def test_balance_loss_is_one_at_uniform():
    """Round-robin routing (an identity-block router on one-hot tokens)
    gives balance 1: with z-loss off, aux = router_weight = 0.01."""
    s, d, e = 16, 8, 4
    tm = MoEMLP(d, e, 1, 4.0, torch.float32,
                _Init("cpu", torch.Generator().manual_seed(0)),
                zloss_weight=0.0)
    x = torch.eye(e, d)[torch.arange(s) % e][None]
    with torch.no_grad():
        tm.router.weight.zero_()
        tm.router.weight[:e, :e] = torch.eye(e) * 50.0
        _, aux = tm(x)
    np.testing.assert_allclose(float(aux), 0.01, rtol=1e-4)


def test_train_step_descends():
    """The JAX package's test_moe_train_step_descends on one device: bf16,
    remat, Adam 3e-3, 8 steps on its ramp batch (the CPU step is eager)."""
    tm = VideoMoE(compute_dtype=torch.bfloat16, remat=True, frames=CLIP[1],
                  size=CLIP[2], device="cpu",
                  generator=torch.Generator().manual_seed(0), **KW)
    step = make_moe_train_step(tm, torch.optim.Adam(tm.parameters(),
                                                    lr=3e-3))
    rng = np.random.default_rng(4)
    ramp = np.linspace(0, 1, CLIP[1], dtype=np.float32)
    clips = torch.from_numpy(rng.uniform(0, .25, CLIP).astype(np.float32)
                             + ramp[None, :, None, None, None])
    losses = [step(clips, torch.from_numpy(MASK))[0].item()
              for _ in range(8)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
