"""The port's MixUp/CutMix (ops/mix.py) against the JAX package's, on the
CPU: for the lam or the box that JAX draws from a key, the port's apply
gives the JAX package's bytes, and mix_labels its soft targets. JAX runs
eagerly here: under jit XLA may fuse lam*x + (1-lam)*y into one rounding,
which the port's two products and one add do not."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_stream_tpu.ops import mix as jmix
from tensor_stream_torch.ops import mix


def batch_of(dtype, shape=(4, 3, 3, 10, 12), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, np.uint8)
    return rng.random(shape).astype(np.float32)


def jax_cutmix_box(key, height, width, alpha):
    """The box JAX's cutmix cuts for `key` (its split and f32 arithmetic)."""
    k_lam, k_y, k_x = jax.random.split(key, 3)
    cut = jnp.sqrt(1.0 - jax.random.beta(k_lam, alpha, alpha))
    ch, cw = cut * height, cut * width
    cy = jax.random.uniform(k_y) * height
    cx = jax.random.uniform(k_x) * width
    edges = [jnp.clip(jnp.round(c), 0, n).astype(jnp.int32)
             for c, n in ((cy - ch / 2, height), (cy + ch / 2, height),
                          (cx - cw / 2, width), (cx + cw / 2, width))]
    return tuple(int(e) for e in edges)


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixup_apply_matches_jax(dtype, seed):
    x = batch_of(dtype, seed=seed)
    key = jax.random.key(seed)
    want, wperm, wlam = jmix.mixup(key, x, 0.4)  # eager: no contraction
    got, perm, lam = mix.apply_mixup(torch.from_numpy(x), np.asarray(wlam))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(perm.numpy(), np.asarray(wperm))
    assert float(lam) == float(wlam)


@pytest.mark.parametrize("axes", [(-2, -1), (-3, -2)])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("seed", [0, 3])
def test_cutmix_apply_matches_jax(axes, dtype, seed):
    x = batch_of(dtype, seed=seed)
    h, w = x.shape[axes[0]], x.shape[axes[1]]
    key = jax.random.key(10 + seed)
    want, wperm, wlam = jmix.cutmix(key, x, 1.0, axes)
    box = jax_cutmix_box(key, h, w, 1.0)
    got, perm, lam = mix.apply_cutmix(torch.from_numpy(x), box, axes)
    assert got.dtype == torch.from_numpy(x).dtype
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(perm.numpy(), np.asarray(wperm))
    assert float(lam) == float(wlam)


def test_mix_labels_matches_jax():
    rng = np.random.default_rng(4)
    one_hot = np.eye(6, dtype=np.float32)[rng.integers(0, 6, 5)]
    perm = np.arange(4, -1, -1)
    for lam in (np.float32(0.3), np.float32(0.91)):
        want = jmix.mix_labels(one_hot, perm, lam)
        got = mix.mix_labels(torch.from_numpy(one_hot), torch.from_numpy(perm),
                             torch.tensor(lam))
        assert np.array_equal(got.numpy(), np.asarray(want))
        torch.testing.assert_close(got.sum(1), torch.ones(5))


def test_draws_are_deterministic_and_lam_is_the_surviving_share():
    x = torch.from_numpy(batch_of("float32"))
    a = mix.cutmix(np.random.default_rng(9), x)
    b = mix.cutmix(np.random.default_rng(9), x)
    assert torch.equal(a[0], b[0]) and float(a[2]) == float(b[2])
    changed = (a[0] != x).any(dim=(1, 2)).float().mean()  # over H, W
    assert 0.0 <= float(a[2]) <= 1.0
    assert abs(float(changed) - (1 - float(a[2]))) < 0.2
    m1 = mix.mixup(np.random.default_rng(5), x, 0.2)
    m2 = mix.mixup(np.random.default_rng(5), x, 0.2)
    assert torch.equal(m1[0], m2[0]) and 0.0 <= float(m1[2]) <= 1.0
    y0, y1, x0, x1 = mix.draw_cutmix(np.random.default_rng(1), 10, 12)
    assert 0 <= y0 <= y1 <= 10 and 0 <= x0 <= x1 <= 12
