"""The port's PSNR and SSIM (tensor_stream_torch/ops/metrics.py) against
the JAX package's on the CPU: seeded images in [0, 1] and [0, 255], with
leading batch and time axes, within 1e-5 (f32 on both sides; the two
convolutions sum the window in different orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_stream_tpu.ops import metrics as jax_metrics
from tensor_stream_torch.ops import metrics

TOL = 1e-5


def pair(shape, max_val, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, max_val, shape).astype(np.float32)
    noise = rng.normal(0, 0.05 * max_val, shape).astype(np.float32)
    return a, np.clip(a + noise, 0, max_val).astype(np.float32)


@pytest.mark.parametrize("max_val", [1.0, 255.0])
@pytest.mark.parametrize("shape", [(2, 3, 24, 20, 3), (4, 16, 16, 1)])
def test_psnr_and_ssim_match_jax(shape, max_val):
    a, b = pair(shape, max_val, seed=len(shape) + int(max_val))
    for name in ("psnr", "ssim"):
        want = np.asarray(getattr(jax_metrics, name)(
            jnp.asarray(a), jnp.asarray(b), max_val=max_val))
        got = getattr(metrics, name)(torch.from_numpy(a), torch.from_numpy(b),
                                     max_val=max_val)
        assert tuple(got.shape) == want.shape == shape[:-3], name
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL,
                                   err_msg=name)


def test_identical_images():
    """PSNR of an image with itself is +inf; SSIM is 1 (up to f32)."""
    a, _ = pair((2, 16, 16, 3), 1.0, seed=9)
    t = torch.from_numpy(a)
    assert torch.isinf(metrics.psnr(t, t)).all()
    np.testing.assert_allclose(metrics.ssim(t, t).numpy(), 1.0, atol=1e-5)


def test_gaussian_window_is_the_references():
    want = np.asarray(jax_metrics._gaussian_window())
    got = metrics.gaussian_window()
    assert got.dtype == np.float32 and np.array_equal(got, want)
