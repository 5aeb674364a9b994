"""Causal Video-VAE, as ``nn.Module``s.

Port of the JAX package's ``models/video_vae.py``: a 3D conv VAE over
[B, T, H, W, C] clips (the reference's layout at the API; the convolutions
run [N, C, T, H, W] inside) that is causal in time: every conv pads only
to the left in time, so frame t's latent depends only on frames <= t.
Space is downsampled 4x and time 2x by strided convs; the decoder
upsamples by nearest repetition and a conv.

The reference's numerics, written out by hand:

* ``CausalConv3D`` pads time ``(kt - 1, 0)`` and space ``((k - 1) // 2,
  k // 2)``, then convolves VALID with its stride in ``compute_dtype``
  (input and kernel cast, the bias added after the product in that
  dtype, as flax's ``nn.Conv(dtype=...)``);
* the GroupNorm (``min(8, C)`` groups) keeps PER-FRAME statistics, as
  flax's ``GroupNorm(reduction_axes=(2, 3, 4))``: it reduces over the
  group's channels, H and W, never over T (which would break causality).
  It runs in f32 with flax's eps of 1e-6 and its fast variance,
  E[x²] − E[x]²;
* SiLU, then a cast to ``compute_dtype`` before each conv; a ResBlock
  returns f32;
* the reparameterisation noise is drawn from an explicit
  ``torch.Generator`` or passed in (``noise``), in the latents' layout
  [B, T', H', W', latent].

``make_vae_train_step`` is the JAX step without its mesh, replayed as a
CUDA graph on the card (``_train.py``), drawing its noise on the device
from a generator the step owns.
"""
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ._train import graphed_train_step, step_generator
from .video_vit import draw_params

GN_EPS = 1e-6  # flax nn.GroupNorm's default


class CausalConv3D(nn.Module):
    """3D conv over [N, C, T, H, W], causal in time; ``weight`` is
    [out, in, kt, kh, kw]."""

    def __init__(self, cin, cout, compute_dtype, kernel=(3, 3, 3),
                 strides=(1, 1, 1)):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.strides = tuple(strides)
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        kt, kh, kw = self.weight.shape[2:]
        cd = self.compute_dtype
        x = F.pad(x.to(cd), ((kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2,
                             kt - 1, 0))
        y = F.conv3d(x, self.weight.to(cd), stride=self.strides)
        return y + self.bias.to(cd)[:, None, None, None]


class GroupNorm(nn.Module):
    """flax ``GroupNorm(num_groups=min(8, C), reduction_axes=(2, 3, 4),
    dtype=float32)`` over [N, C, T, H, W]: statistics per sample, group
    and frame."""

    def __init__(self, channels):
        super().__init__()
        self.groups = min(8, channels)
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        n, c, t, h, w = x.shape
        g = self.groups
        x = x.float().reshape(n, g, c // g, t, h, w)
        mean = x.mean(dim=(2, 4, 5), keepdim=True)
        var = ((x * x).mean(dim=(2, 4, 5), keepdim=True)
               - mean * mean).clamp_min(0.0)
        shape = (1, g, c // g, 1, 1, 1)
        mul = torch.rsqrt(var + GN_EPS) * self.weight.view(shape)
        y = (x - mean) * mul + self.bias.view(shape)
        return y.reshape(n, c, t, h, w)


class ResBlock(nn.Module):
    """norm, SiLU, conv, norm, SiLU, conv, plus the input (through a 1x1x1
    conv, ``convs[2]``, where the widths differ); returns f32."""

    def __init__(self, cin, cout, compute_dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norms = nn.ModuleList([GroupNorm(cin), GroupNorm(cout)])
        convs = [CausalConv3D(cin, cout, compute_dtype),
                 CausalConv3D(cout, cout, compute_dtype)]
        if cin != cout:
            convs.append(CausalConv3D(cin, cout, compute_dtype, (1, 1, 1)))
        self.convs = nn.ModuleList(convs)

    def forward(self, x):
        cd = self.compute_dtype
        h = self.convs[0](F.silu(self.norms[0](x)).to(cd))
        h = self.convs[1](F.silu(self.norms[1](h)).to(cd))
        if len(self.convs) == 3:
            x = self.convs[2](x)
        return (x + h).float()


def _repeat(x, t, s):
    """Nearest upsampling of [N, C, T, H, W] by t in time and s in space
    (a broadcast, whose backward is a sum: no atomics)."""
    n, c, tt, h, w = x.shape
    x = x[:, :, :, None, :, None, :, None].expand(n, c, tt, t, h, s, w, s)
    return x.reshape(n, c, tt * t, h * s, w * s)


class Encoder(nn.Module):
    def __init__(self, channels, base, latent, compute_dtype):
        super().__init__()
        cd = compute_dtype
        self.convs = nn.ModuleList([
            CausalConv3D(channels, base, cd),
            CausalConv3D(base, base * 2, cd, strides=(1, 2, 2)),
            CausalConv3D(base * 2, base * 4, cd, strides=(2, 2, 2)),
            CausalConv3D(base * 4, 2 * latent, cd, kernel=(1, 1, 1))])
        self.blocks = nn.ModuleList([ResBlock(base * m, base * m, cd)
                                     for m in (1, 2, 4)])

    def forward(self, x):
        for conv, block in zip(self.convs, self.blocks):
            x = block(conv(x))
        moments = self.convs[3](x).float()
        mean, logvar = moments.chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)


class Decoder(nn.Module):
    def __init__(self, base, latent, out_channels, compute_dtype):
        super().__init__()
        cd = compute_dtype
        self.convs = nn.ModuleList([
            CausalConv3D(latent, base * 4, cd),
            CausalConv3D(base * 4, base * 2, cd),
            CausalConv3D(base * 2, base, cd),
            CausalConv3D(base, out_channels, cd, kernel=(1, 1, 1))])
        self.blocks = nn.ModuleList([ResBlock(base * m, base * m, cd)
                                     for m in (4, 2, 1)])

    def forward(self, z):
        x = self.blocks[0](self.convs[0](z))
        x = self.blocks[1](self.convs[1](_repeat(x, 2, 2)))
        x = self.blocks[2](self.convs[2](_repeat(x, 1, 2)))
        return self.convs[3](x).float()


def _to_channels_first(x):
    return x.permute(0, 4, 1, 2, 3)


def _to_channels_last(x):
    return x.permute(0, 2, 3, 4, 1)


class VideoVAE(nn.Module):
    """[B, T, H, W, C] -> (recon, mean, logvar), the latents
    [B, T/2, H/4, W/4, latent]. T, H, W must be divisible by 2, 4, 4."""

    def __init__(self, base=32, latent=8, out_channels=3, channels=3,
                 compute_dtype=torch.bfloat16, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.device = resolve_device(device)
        self.latent = latent
        self.encoder = Encoder(channels, base, latent, compute_dtype)
        self.decoder = Decoder(base, latent, out_channels, compute_dtype)
        draw_params(generator if generator is not None
                    else torch.Generator().manual_seed(0), self)
        self.to(self.device)

    def forward(self, clips, noise=None,
                generator: Optional[torch.Generator] = None):
        b, t, h, w, _ = clips.shape
        if t % 2 or h % 4 or w % 4:
            raise ValueError(f"clips {tuple(clips.shape)}: T, H, W must be "
                             "divisible by 2, 4, 4")
        mean, logvar = self.encoder(_to_channels_first(clips))
        if noise is None:
            noise = torch.randn(_to_channels_last(mean).shape,
                                generator=generator, device=mean.device)
        z = mean + torch.exp(0.5 * logvar) * _to_channels_first(noise)
        return (_to_channels_last(self.decoder(z)), _to_channels_last(mean),
                _to_channels_last(logvar))

    def encode(self, clips) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, logvar) of [B, T, H, W, C] clips, channels last."""
        mean, logvar = self.encoder(_to_channels_first(clips))
        return _to_channels_last(mean), _to_channels_last(logvar)

    def decode(self, z):
        """Latents [B, T', H', W', latent] -> clips [B, 2T', 4H', 4W', C]."""
        return _to_channels_last(self.decoder(_to_channels_first(z)))


def vae_loss(recon, clips, mean, logvar, kl_weight=1e-4):
    """L2 reconstruction + KL(q || N(0,1)), both per-element means:
    returns (loss, (rec, kl))."""
    rec = ((recon - clips) ** 2).mean()
    kl = 0.5 * (mean.square() + logvar.exp() - 1.0 - logvar).mean()
    return rec + kl_weight * kl, (rec, kl)


def make_vae_train_step(model: VideoVAE, optimizer: torch.optim.Optimizer,
                        kl_weight=1e-4,
                        generator: Optional[torch.Generator] = None):
    """The JAX ``make_vae_train_step`` on one device, without its mesh:
    returns step(clips) -> (loss, rec, kl), 0-d device tensors, after one
    `optimizer` step on the gradients of ``vae_loss``. The noise is drawn
    on the device from `generator` (default: a generator of the model's
    device seeded 0), which the step's CUDA graph registers; on CUDA
    ``step.graphed.fn`` is the same step, eager."""
    gen = generator if generator is not None else step_generator(
        model.device)

    def step(clips):
        recon, mean, logvar = model(clips, generator=gen)
        loss, (rec, kl) = vae_loss(recon, clips, mean, logvar, kl_weight)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach(), rec.detach(), kl.detach()
    return graphed_train_step(step, optimizer, model.device, (gen,))
