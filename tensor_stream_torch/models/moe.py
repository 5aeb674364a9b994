"""Switch-MoE VideoViT on one device, as ``nn.Module``s.

Port of the JAX package's ``models/moe.py`` without its expert-parallel
mesh: the block MLP is a top-1 mixture of E experts whose weights are
stacked on a leading expert axis (``w1`` [E, D, F], ``b1`` [E, F], ``w2``
[E, F, D], ``b2`` [E, D], flax's own layout). Routing is the reference's
static-shape GShard/Switch formulation, nothing data-dependent in shape:

* router logits [G, S, E] in f32 (a group is one clip's tokens), softmax,
  top-1 by argmax (ties to the first expert, as ``jnp.argmax``);
* capacity C = ceil(S / E * capacity_factor) a group; a token's place in
  its expert's buffer is a cumulative sum, and tokens past C are dropped
  (zero output; the residual carries them);
* one-hot dispatch [G, S, E, C] and combine (scaled by the router's gate)
  einsums around the experts' batched 2-layer GELU (tanh) MLPs in
  ``compute_dtype``;
* aux loss = router_weight * balance + zloss_weight * z-loss, balance =
  E * sum_e f_e * p_e (1 at uniform routing), z-loss = mean(logsumexp²).

Nothing in the forward or the train step syncs with the host (no
``nonzero``, no ``item``), so the step replays as one CUDA graph
(``_train.py``). Left out: ``moe_param_specs`` and the ``ep`` mesh of
``make_moe_train_step`` (ROADMAP.md, the parallel slice).
"""
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ._train import graphed_train_step
from .video_vit import MHA, Dense, LayerNorm, _Init, tubelet_embed


class MoEMLP(nn.Module):
    """Switch top-1 MoE over the tokens of each group: [G, S, D] ->
    (output [G, S, D], aux loss, 0-d)."""

    def __init__(self, dim, num_experts, hidden_mult, capacity_factor,
                 compute_dtype, init: _Init, router_weight=0.01,
                 zloss_weight=1e-3):
        super().__init__()
        e, f = num_experts, hidden_mult * dim
        self.num_experts, self.capacity_factor = e, capacity_factor
        self.compute_dtype = compute_dtype
        self.router_weight, self.zloss_weight = router_weight, zloss_weight
        self.router = Dense(dim, e, torch.float32, init, use_bias=False)
        self.w1 = init.normal((e, dim, f), dim ** -0.5)
        self.b1 = init.const((e, f), 0.0)
        self.w2 = init.normal((e, f, dim), f ** -0.5)
        self.b2 = init.const((e, dim), 0.0)

    def capacity(self, tokens: int) -> int:
        return int(math.ceil(tokens / self.num_experts * self.capacity_factor))

    def route(self, x):
        """(logits, probs, mask [G, S, E] one-hot of the expert, keep
        [G, S, E]: routed and within capacity, dispatch [G, S, E, C])."""
        g, s, _ = x.shape
        e, c = self.num_experts, self.capacity(s)
        logits = self.router(x.float())
        probs = torch.softmax(logits, dim=-1)
        experts = torch.arange(e, device=x.device)
        mask = (probs.argmax(-1)[..., None] == experts).float()
        pos = torch.cumsum(mask, dim=1) * mask - 1.0
        keep = (pos < c) & (mask > 0)
        slots = torch.arange(c, device=x.device)
        pos_c = pos.clamp(0, c - 1).long()
        dispatch = (pos_c[..., None] == slots).float() * keep[..., None]
        return logits, probs, mask, keep, dispatch

    def forward(self, x):
        cd = self.compute_dtype
        logits, probs, mask, _, dispatch = self.route(x)
        gate = (probs * mask).sum(-1)
        combine = dispatch * gate[:, :, None, None]
        xin = torch.einsum("gsec,gsd->egcd", dispatch, x.float()).to(cd)
        h = torch.einsum("egcd,edf->egcf", xin, self.w1.to(cd))
        h = F.gelu(h + self.b1[:, None, None].to(cd), approximate="tanh")
        y = torch.einsum("egcf,efd->egcd", h, self.w2.to(cd))
        y = y + self.b2[:, None, None].to(cd)
        out = torch.einsum("gsec,egcd->gsd", combine, y.float())
        f_e, p_e = mask.mean(dim=1), probs.mean(dim=1)
        balance = self.num_experts * (f_e * p_e).sum(-1).mean()
        zloss = (torch.logsumexp(logits, dim=-1) ** 2).mean()
        aux = self.router_weight * balance + self.zloss_weight * zloss
        return out.to(x.dtype), aux


class MoEBlock(nn.Module):
    """The FactorizedBlock layout with the dense MLP swapped for MoEMLP:
    [B, T, N, D] -> (x, aux). The MoE groups are the clips (T·N tokens)."""

    def __init__(self, dim, num_heads, num_experts, hidden_mult,
                 capacity_factor, compute_dtype, init: _Init):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.ln_s = LayerNorm(dim, init)
        self.attn_s = MHA(dim, num_heads, compute_dtype, init)
        self.ln_t = LayerNorm(dim, init)
        self.attn_t = MHA(dim, num_heads, compute_dtype, init)
        self.ln_m = LayerNorm(dim, init)
        self.moe = MoEMLP(dim, num_experts, hidden_mult, capacity_factor,
                          compute_dtype, init)

    def forward(self, x):
        cd = self.compute_dtype
        x = x + self.attn_s(self.ln_s(x).to(cd)).to(x.dtype)
        y = self.attn_t(self.ln_t(x).to(cd).transpose(1, 2))
        x = x + y.transpose(1, 2).to(x.dtype)
        b, t, n, d = x.shape
        y, aux = self.moe(self.ln_m(x).reshape(b, t * n, d))
        return x + y.reshape(b, t, n, d).to(x.dtype), aux


class VideoMoE(nn.Module):
    """VideoViT with MoE MLPs: clips [B, frames, size, size, C] ->
    (logits [B, classes], the blocks' mean aux loss)."""

    def __init__(self, num_classes, num_experts=4, depth=4, dim=192,
                 num_heads=3, patch=16, tubelet_t=2, hidden_mult=4,
                 capacity_factor=1.25, compute_dtype=torch.bfloat16,
                 remat=False, frames=16, size=224, channels=3, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        height, width = (size, size) if isinstance(size, int) else size
        if frames % tubelet_t or height % patch or width % patch:
            raise ValueError(f"frames {frames} and size {size} must divide "
                             f"into tubelets of {tubelet_t}x{patch}x{patch}")
        self.device = resolve_device(device)
        init = _Init(self.device, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.patch, self.tubelet_t, self.remat = patch, tubelet_t, remat
        self.compute_dtype, self.residual_dtype = compute_dtype, torch.float32
        self.tubelet = Dense(tubelet_t * patch * patch * channels, dim,
                             compute_dtype, init)
        self.pos_spatial = init.normal(
            ((height // patch) * (width // patch), dim), 0.02)
        self.pos_temporal = init.normal((frames // tubelet_t, dim), 0.02)
        self.blocks = nn.ModuleList([
            MoEBlock(dim, num_heads, num_experts, hidden_mult,
                     capacity_factor, compute_dtype, init)
            for _ in range(depth)])
        self.ln_f = LayerNorm(dim, init)
        self.head = Dense(dim, num_classes, torch.float32, init)

    def forward(self, clips):
        x = tubelet_embed(self, clips)
        remat = self.remat and torch.is_grad_enabled()
        aux = 0.0
        for block in self.blocks:
            x, a = (checkpoint(block, x, use_reentrant=False) if remat
                    else block(x))
            aux = aux + a
        logits = self.head(self.ln_f(x).mean(dim=(1, 2)))
        return logits, aux / len(self.blocks)


def moe_loss(model: VideoMoE, clips, flip_mask):
    """The JAX step's arrow-of-time task and loss: clips whose `flip_mask`
    is set are time-reversed, the mask is the label; returns (loss, acc,
    aux), loss = cross-entropy + aux."""
    x = torch.where(flip_mask[:, None, None, None, None], clips.flip(1),
                    clips)
    labels = flip_mask.long()
    logits, aux = model(x)
    ce = -torch.take_along_dim(torch.log_softmax(logits, dim=-1),
                               labels[:, None], dim=1).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return ce + aux, acc, aux


def make_moe_train_step(model: VideoMoE, optimizer: torch.optim.Optimizer):
    """The JAX ``make_moe_train_step`` on one device, without its ep mesh:
    step(clips, flip_mask) -> (loss, acc, aux), 0-d device tensors, after
    one `optimizer` step on ``moe_loss``. Replayed as a CUDA graph on the
    card (``_train.py``); ``step.graphed.fn`` is the same step, eager."""
    def step(clips, flip_mask):
        loss, acc, aux = moe_loss(model, clips, flip_mask)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach(), acc, aux.detach()
    return graphed_train_step(step, optimizer, model.device)
