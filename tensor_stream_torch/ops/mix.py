"""Batch-level training mixes: MixUp and CutMix for clip and frame batches.

Port of the JAX package's ``ops/mix.py``, with the same semantics: one
draw a batch, each element mixed with the reversed batch (``x[::-1]``),
and for CutMix one rectangle of area fraction ``1 - lam`` at a uniform
centre, clipped, with ``lam`` corrected to the exact surviving fraction.
They work across the batch axis, so they belong in the train step:

    rng = np.random.default_rng(0)
    mixed, perm, lam = mixup(rng, clips, alpha=0.2)
    target = mix_labels(one_hot, perm, lam)

The JAX package draws from a ``jax.random`` key; the port takes an
explicit numpy ``Generator`` and splits each mix in two, the draw on the
host (``draw_mixup``, ``draw_cutmix``) and the apply on the device
(``apply_mixup``, ``apply_cutmix``), so a given ``lam`` or box gives the
JAX package's result. ``lam`` is returned as a float32 0-d tensor on the
batch's device; the apply reads nothing back from the device.
"""
import numpy as np
import torch


def _pair(x):
    """The mixing partner of every batch element: the reversed batch."""
    return torch.flip(x, dims=(0,))


def _reversal(b, device):
    return torch.arange(b - 1, -1, -1, device=device)


def draw_mixup(rng: np.random.Generator, alpha=0.2) -> np.float32:
    """lam ~ Beta(alpha, alpha), one draw a batch."""
    return np.float32(rng.beta(alpha, alpha))


def apply_mixup(batch, lam):
    """``(mixed, perm, lam)``: ``mixed = lam * batch + (1 - lam) *
    batch[perm]`` in float32 (or wider, as the batch), with ``perm`` the
    reversal."""
    dtype = torch.promote_types(batch.dtype, torch.float32)
    lam = torch.tensor(np.float32(lam), dtype=torch.float32,
                       device=batch.device)
    x = batch.to(dtype)
    mixed = lam.to(dtype) * x + (1.0 - lam).to(dtype) * _pair(x)
    return mixed, _reversal(batch.shape[0], batch.device), lam


def mixup(rng: np.random.Generator, batch, alpha=0.2):
    """MixUp a ``[B, ...]`` batch; see ``apply_mixup``."""
    return apply_mixup(batch, draw_mixup(rng, alpha))


def draw_cutmix(rng: np.random.Generator, height: int, width: int,
                alpha=1.0):
    """The CutMix box ``(y0, y1, x0, x1)`` of a ``height x width`` frame:
    ``lam0 ~ Beta(alpha, alpha)``, a rect of side fraction
    ``sqrt(1 - lam0)`` at a uniform centre, its edges rounded (half to
    even) and clipped to the frame, in float32 as the JAX package
    computes them."""
    f32 = np.float32
    lam0 = f32(rng.beta(alpha, alpha))
    cut = np.sqrt(f32(1.0) - lam0)
    ch = cut * f32(height)
    cw = cut * f32(width)
    cy = f32(rng.random()) * f32(height)
    cx = f32(rng.random()) * f32(width)
    half_h, half_w = ch / f32(2), cw / f32(2)
    y0 = int(np.clip(np.round(cy - half_h), 0, height))
    y1 = int(np.clip(np.round(cy + half_h), 0, height))
    x0 = int(np.clip(np.round(cx - half_w), 0, width))
    x1 = int(np.clip(np.round(cx + half_w), 0, width))
    return y0, y1, x0, x1


def apply_cutmix(batch, box, spatial_axes=(-2, -1)):
    """``(mixed, perm, lam)``: the box of every frame and channel replaced
    by the reversed batch's pixels (any dtype; pixels are copied), and
    ``lam`` the exact fraction of surviving pixels. ``spatial_axes``
    locates (H, W): ``(-2, -1)`` planar, ``(-3, -2)`` merged."""
    y0, y1, x0, x1 = (int(v) for v in box)
    h_ax = spatial_axes[0] % batch.dim()
    w_ax = spatial_axes[1] % batch.dim()
    height, width = batch.shape[h_ax], batch.shape[w_ax]
    rows = torch.arange(height, device=batch.device)
    cols = torch.arange(width, device=batch.device)
    shape_y = [1] * batch.dim()
    shape_y[h_ax] = height
    shape_x = [1] * batch.dim()
    shape_x[w_ax] = width
    inside = (((rows >= y0) & (rows < y1)).view(shape_y)
              & ((cols >= x0) & (cols < x1)).view(shape_x))
    mixed = torch.where(inside, _pair(batch), batch)
    lam = np.float32(1.0) - np.float32((y1 - y0) * (x1 - x0)) / np.float32(
        height * width)
    return (mixed, _reversal(batch.shape[0], batch.device),
            torch.tensor(lam, dtype=torch.float32, device=batch.device))


def cutmix(rng: np.random.Generator, batch, alpha=1.0,
           spatial_axes=(-2, -1)):
    """CutMix a ``[B, ...]`` batch; see ``draw_cutmix``, ``apply_cutmix``."""
    h_ax = spatial_axes[0] % batch.dim()
    w_ax = spatial_axes[1] % batch.dim()
    box = draw_cutmix(rng, batch.shape[h_ax], batch.shape[w_ax], alpha)
    return apply_cutmix(batch, box, spatial_axes)


def mix_labels(one_hot, perm, lam):
    """Soft targets for a mixed batch: ``lam * y + (1 - lam) * y[perm]`` on
    one-hot (or already soft) ``[B, num_classes]`` labels."""
    dtype = torch.promote_types(one_hot.dtype, torch.float32)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=one_hot.device)
    y = one_hot.to(dtype)
    return (lam.to(dtype) * y
            + (1.0 - lam).to(dtype) * y.index_select(0, perm))
