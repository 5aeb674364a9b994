"""TransformerNet: the fast-neural-style network, as ``nn.Module``s.

Port of the JAX package's ``models/transformer_net.py`` (the upstream
example's own model, ``python_examples/fast_neural_style/``). The API is
the reference's: NHWC float32 images in [0, 255] in and out; inside, the
convolutions run NCHW.

  conv9x9(3->32) -> IN -> relu
  conv3x3 s2 (32->64) -> IN -> relu
  conv3x3 s2 (64->128) -> IN -> relu
  5 x residual[conv3x3 -> IN -> relu -> conv3x3 -> IN, +skip]
  upsample2x + conv3x3 (128->64) -> IN -> relu
  upsample2x + conv3x3 (64->32) -> IN -> relu
  conv9x9(32->3)

Every convolution reflection-pads by kernel // 2 first (``F.pad(mode=
"reflect")``, jnp's "reflect"); the instance norm is affine, with the
biased variance and eps 1e-5; the upsample is nearest at 2x, which equals
``jax.image.resize(..., "nearest")`` at an integer factor. Parameters are
f32 and so is the compute (the flax module sets no dtype). Weights for
parity come from flax through ``models/convert.py``.
"""
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from .video_vit import draw_params


class ConvLayer(nn.Module):
    """Reflection pad by kernel // 2, then a VALID conv. ``weight`` is
    [out, in, k, k]."""

    def __init__(self, cin, cout, kernel, stride=1, upsample=1):
        super().__init__()
        self.stride, self.upsample = stride, upsample
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        if self.upsample > 1:
            x = F.interpolate(x, scale_factor=self.upsample, mode="nearest")
        p = self.weight.shape[-1] // 2
        if p:
            x = F.pad(x, (p, p, p, p), mode="reflect")
        return F.conv2d(x, self.weight, self.bias, stride=self.stride)


class InstanceNorm(nn.Module):
    """InstanceNorm2d(affine=True) over [N, C, H, W]: per sample and
    channel over H, W; biased variance, eps 1e-5."""

    def __init__(self, channels, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class ResidualBlock(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.convs = nn.ModuleList([ConvLayer(channels, channels, 3)
                                    for _ in range(2)])
        self.norms = nn.ModuleList([InstanceNorm(channels)
                                    for _ in range(2)])

    def forward(self, x):
        y = F.relu(self.norms[0](self.convs[0](x)))
        return self.norms[1](self.convs[1](y)) + x


class TransformerNet(nn.Module):
    """NHWC f32 images in [0, 255] -> NHWC f32 images (the reference's
    range; the output is not clamped). The module names follow flax's
    automatic ones in their order of creation: ``convs`` are ConvLayer_0-3,
    ``norms`` InstanceNorm_0-4, ``blocks`` ResidualBlock_0-4 and ``ups``
    UpsampleConvLayer_0-1."""

    def __init__(self, device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.device = resolve_device(device)
        self.convs = nn.ModuleList([ConvLayer(3, 32, 9),
                                    ConvLayer(32, 64, 3, stride=2),
                                    ConvLayer(64, 128, 3, stride=2),
                                    ConvLayer(32, 3, 9)])
        self.norms = nn.ModuleList([InstanceNorm(c)
                                    for c in (32, 64, 128, 64, 32)])
        self.blocks = nn.ModuleList([ResidualBlock(128) for _ in range(5)])
        self.ups = nn.ModuleList([ConvLayer(128, 64, 3, upsample=2),
                                  ConvLayer(64, 32, 3, upsample=2)])
        init_params(generator if generator is not None
                    else torch.Generator().manual_seed(0), self)
        self.to(self.device)

    def forward(self, x):
        y = x.float().permute(0, 3, 1, 2)
        for k in range(3):
            y = F.relu(self.norms[k](self.convs[k](y)))
        for block in self.blocks:
            y = block(y)
        for k, up in enumerate(self.ups):
            y = F.relu(self.norms[3 + k](up(y)))
        return self.convs[3](y).permute(0, 2, 3, 1)


def init_params(generator: torch.Generator, model: TransformerNet) -> dict:
    """Re-draws every parameter of `model` from `generator` (on the CPU, in
    registration order): conv kernels normal with std fan_in**-0.5, biases
    0, instance-norm scales 1. Returns the state dict."""
    draw_params(generator, model)
    return model.state_dict()


def gram_matrix(features):
    """Channel covariance of NHWC activations, per sample: [N, C, C]."""
    n, h, w, c = features.shape
    f = features.reshape(n, h * w, c)
    return torch.einsum("nic,nid->ncd", f, f) / (h * w * c)


def style_transfer_loss(model, content, style_grams, content_weight=1.0,
                        style_weight=1e-4, tv_weight=1e-6):
    """The reference's objective: content MSE + gram-matrix style MSE +
    total variation of the output (NHWC), weighted."""
    out = model(content)
    content_loss = ((out - content) ** 2).mean()
    style_loss = ((gram_matrix(out) - style_grams) ** 2).mean()
    tv = ((out[:, 1:] - out[:, :-1]).abs().mean()
          + (out[:, :, 1:] - out[:, :, :-1]).abs().mean())
    return (content_weight * content_loss + style_weight * style_loss
            + tv_weight * tv)
