"""Video quality metrics: PSNR and SSIM over [..., H, W, C] images.

Port of the JAX package's ``ops/metrics.py``. Both take any leading
batch/time axes over channels-last images in any range (``max_val``: 255
for u8-scale, 1.0 for normalized) and return one value per leading
element, in f32. SSIM is Wang et al. 2004: the 11x11 Gaussian window of
sigma 1.5 (made in numpy in f64, as the reference makes it), K1 = 0.01,
K2 = 0.03, VALID windows.

The window's depthwise convolution is ``F.conv2d(groups=C)`` in f32; on
CUDA it runs with TF32 off, the counterpart of the reference's
``Precision.HIGHEST`` (the E[x²]−E[x]² variances downstream amplify any
rounding of the moments).
"""
import contextlib

import numpy as np
import torch
import torch.nn.functional as F


def psnr(a, b, max_val=1.0, dims=(-3, -2, -1)):
    """Peak signal-to-noise ratio in dB over `dims` (default: one value
    per leading element). Identical inputs give +inf."""
    a, b = a.float(), b.float()
    mse = ((a - b) ** 2).mean(dim=dims)
    peak = 2 * float(np.log10(np.float32(max_val)))  # in f32, as jnp's
    return 10.0 * (peak - torch.log10(mse))


def gaussian_window(size=11, sigma=1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


@contextlib.contextmanager
def _no_tf32():
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _depthwise(img, window):
    """[N, C, H, W] convolved per channel with [kh, kw], VALID."""
    c = img.shape[1]
    kern = window[None, None].expand(c, 1, *window.shape)
    return F.conv2d(img, kern, groups=c)


def ssim(a, b, max_val=1.0):
    """Mean SSIM over [..., H, W, C]; one value per leading element.
    H and W must be at least 11 (the window)."""
    lead = a.shape[:-3]
    a = a.float().reshape((-1,) + a.shape[-3:]).permute(0, 3, 1, 2)
    b = b.float().reshape((-1,) + b.shape[-3:]).permute(0, 3, 1, 2)
    win = torch.from_numpy(gaussian_window()).to(a.device)
    with _no_tf32() if a.is_cuda else contextlib.nullcontext():
        mu_a = _depthwise(a, win)
        mu_b = _depthwise(b, win)
        saa = _depthwise(a * a, win) - mu_a ** 2
        sbb = _depthwise(b * b, win) - mu_b ** 2
        sab = _depthwise(a * b, win) - mu_a * mu_b
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2) /
         ((mu_a ** 2 + mu_b ** 2 + c1) * (saa + sbb + c2)))
    return s.mean(dim=(1, 2, 3)).reshape(lead)
