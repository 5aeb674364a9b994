"""Latent video diffusion: a DiT over Video-VAE latents, with DDIM and CFG.

Port of the JAX package's ``models/latent_diffusion.py``:

* ``cosine_alpha_bar`` and ``DiffusionSchedule``: the cosine ᾱ table,
  computed in numpy in f64 exactly as the reference computes it (betas
  clipped at 0.999), then moved to the device as f32;
* ``VideoDiT``: an ε-predictor over [B, T', h', w', Cz] latents. Tokens
  come from the shared tubelet stem (``video_vit.tubelet_embed``, a
  per-latent-pixel linear embed); conditioning is adaLN-zero (``DiTBlock``:
  non-affine LayerNorms, eps 1e-6, modulated by a (shift, scale, gate)
  triple a sublayer regressed from the conditioning vector, zero-init, so
  that every block starts as the identity) or "in_context" (the embedding
  added to the tokens of plain ``FactorizedBlock``s). ``num_classes`` > 0
  makes it class-conditional, with label ``num_classes`` the learned NULL
  class. The head is zero-init too. GELU is the tanh approximation (flax's
  ``nn.gelu``); attention is materialized, as in the reference's blocks;
* ``diffusion_loss``, the ε-MSE given explicit draws, and the two train
  steps, which draw t, ε and the label-dropout mask on the device inside
  the step from a generator the step owns (registered with its CUDA graph,
  so every replay draws anew);
* ``ddim_sample``: deterministic DDIM through the step indices
  ``np.linspace(T, 0, n + 1).round()``, with classifier-free guidance
  ``(1 + w)·ε(y) − w·ε(∅)``; ``make_ddim_sampler`` replays the whole n-step
  loop as one CUDA graph, the counterpart of the reference's ``lax.scan``.

Meshes: ``ring_axis``/``mesh`` ring the spatial attention (video_vit.MHA,
``ops/ring_attention.py``); the train steps take ``mesh=`` (data
parallel: each rank draws the global batch's t, ε and dropout mask from
the step's generator, seeded alike on every rank, and runs the model on
its share of the batch; the gradients are averaged over "dp").
"""
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..graphs import cuda_graph
from ._train import graphed_train_step, step_generator
from .video_vit import (LN_EPS, MHA, Dense, FactorizedBlock, LayerNorm, _Init,
                        tubelet_embed)


# --------------------------------------------------------------- schedule

def cosine_alpha_bar(timesteps: int, s: float = 0.008) -> np.ndarray:
    """ᾱ_t for t in [0, timesteps], cosine schedule; ᾱ_0 = 1."""
    t = np.linspace(0, 1, timesteps + 1)
    f = np.cos((t + s) / (1 + s) * np.pi / 2) ** 2
    return (f / f[0]).astype(np.float32)


def alpha_bar_table(timesteps: int) -> np.ndarray:
    """The schedule's ᾱ [T+1] in f32: the betas of the cosine ᾱ clipped at
    0.999 (Nichol & Dhariwal's guard), their cumulative product in f64."""
    ab = cosine_alpha_bar(timesteps).astype(np.float64)
    betas = np.clip(1.0 - ab[1:] / ab[:-1], 0.0, 0.999)
    return np.concatenate([[1.0], np.cumprod(1.0 - betas)]).astype(np.float32)


def _per_sample(table, t):
    return table[t][:, None, None, None, None]


class DiffusionSchedule:
    """DDPM/DDIM quantities over the ᾱ table on `device` (None: cuda)."""

    def __init__(self, timesteps: int = 1000, device=None):
        self.timesteps = timesteps
        self.alpha_bar = torch.from_numpy(alpha_bar_table(timesteps)).to(
            resolve_device(device))

    def q_sample(self, x0, t, noise):
        """Forward process: x_t = sqrt(ᾱ_t) x0 + sqrt(1-ᾱ_t) ε; t [B]."""
        ab = _per_sample(self.alpha_bar, t)
        return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise

    def x0_from_eps(self, xt, t, eps):
        ab = _per_sample(self.alpha_bar, t)
        return (xt - torch.sqrt(1.0 - ab) * eps) / torch.sqrt(ab)

    def ddim_step(self, xt, t, t_prev, eps):
        """Deterministic DDIM x_t -> x_{t_prev} given the predicted ε."""
        x0 = self.x0_from_eps(xt, t, eps)
        ab_prev = _per_sample(self.alpha_bar, t_prev)
        return torch.sqrt(ab_prev) * x0 + torch.sqrt(1.0 - ab_prev) * eps


# ------------------------------------------------------------------ model

def timestep_embedding(t, dim: int, max_period: float = 10_000.0):
    """Sinusoidal embedding of integer timesteps, [B] -> [B, dim] f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _layer_norm(x):
    """flax ``LayerNorm(use_bias=False, use_scale=False)`` in f32."""
    return F.layer_norm(x.float(), x.shape[-1:], eps=LN_EPS)


def _modulate(h, shift, scale):
    return h * (1 + scale[:, None, None]) + shift[:, None, None]


class DiTBlock(nn.Module):
    """Factorized space-time block over [B, T, N, D] with adaLN-zero
    conditioning on c [B, D]: spatial attention, temporal attention, then
    the MLP, each behind a modulated non-affine LayerNorm and gated."""

    def __init__(self, dim, num_heads, hidden_mult, compute_dtype,
                 init: _Init, **ring):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.adaLN = Dense(dim, 9 * dim, torch.float32, init, zero_init=True)
        self.attn_s = MHA(dim, num_heads, compute_dtype, init, **ring)
        self.attn_t = MHA(dim, num_heads, compute_dtype, init)
        self.fc1 = Dense(dim, hidden_mult * dim, compute_dtype, init)
        self.fc2 = Dense(hidden_mult * dim, dim, compute_dtype, init)

    def forward(self, x, c):
        cd = self.compute_dtype
        m = self.adaLN(F.silu(c)).chunk(9, dim=-1)      # each [B, D]
        y = _modulate(_layer_norm(x), m[0], m[1]).to(cd)
        x = x + m[2][:, None, None] * self.attn_s(y).to(x.dtype)
        y = _modulate(_layer_norm(x), m[3], m[4]).to(cd)
        y = self.attn_t(y.transpose(1, 2))
        x = x + m[5][:, None, None] * y.transpose(1, 2).to(x.dtype)
        y = _modulate(_layer_norm(x), m[6], m[7]).to(cd)
        y = self.fc2(F.gelu(self.fc1(y), approximate="tanh"))
        return x + m[8][:, None, None] * y.to(x.dtype)


class VideoDiT(nn.Module):
    """ε-predictor over latents [B, T', h', w', Cz] (``latent_shape`` =
    (T', h', w', Cz): the positional tables are sized at construction, as
    the flax module sizes them from its first input). ``forward(z, t, y)``
    takes timesteps t [B] and, where ``num_classes`` > 0, labels y [B]
    (``num_classes`` is the NULL class). ``ring_axis``, ``mesh``,
    ``ring_batch_axis`` and ``ring_head_axis`` ring the spatial attention
    (video_vit.MHA's)."""

    def __init__(self, latent_shape, depth=4, dim=192, num_heads=3,
                 hidden_mult=4, patch=1, tubelet_t=1,
                 compute_dtype=torch.bfloat16, remat=False,
                 conditioning="adaln", num_classes=0, device=None,
                 generator: Optional[torch.Generator] = None,
                 ring_axis=None, mesh=None, ring_batch_axis="dp",
                 ring_head_axis=None):
        super().__init__()
        if patch != 1 or tubelet_t != 1:
            raise ValueError("the linear head writes one latent pixel a "
                             f"token: patch {patch} and tubelet_t "
                             f"{tubelet_t} must be 1")
        if conditioning not in ("adaln", "in_context"):
            raise ValueError(f"conditioning must be 'adaln' or 'in_context': "
                             f"{conditioning!r}")
        self.device = resolve_device(device)
        init = _Init(self.device, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        frames, h, w, cz = latent_shape
        self.latent_shape = tuple(latent_shape)
        self.dim, self.patch, self.tubelet_t = dim, patch, tubelet_t
        self.compute_dtype, self.residual_dtype = compute_dtype, torch.float32
        self.conditioning, self.num_classes = conditioning, num_classes
        self.remat = remat
        self.tubelet = Dense(cz, dim, compute_dtype, init)
        self.pos_spatial = init.normal((h * w, dim), 0.02)
        self.pos_temporal = init.normal((frames, dim), 0.02)
        self.time_mlp1 = Dense(dim, dim, torch.float32, init)
        self.time_mlp2 = Dense(dim, dim, torch.float32, init)
        if num_classes:
            self.label_embed = nn.Embedding(
                num_classes + 1, dim,
                _weight=init.normal((num_classes + 1, dim), dim ** -0.5))
        ring = {} if ring_axis is None else dict(
            ring_axis=ring_axis, mesh=mesh, ring_batch_axis=ring_batch_axis,
            ring_head_axis=ring_head_axis)
        self.ringed = ring_axis is not None
        if conditioning == "adaln":
            blocks = [DiTBlock(dim, num_heads, hidden_mult, compute_dtype,
                               init, **ring) for _ in range(depth)]
        else:
            blocks = [FactorizedBlock(dim, num_heads, hidden_mult,
                                      compute_dtype, init, **ring)
                      for _ in range(depth)]
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = LayerNorm(dim, init)
        self.head = Dense(dim, cz, torch.float32, init, zero_init=True)

    def forward(self, z, t, y=None):
        b, tt, hh, ww, cz = z.shape
        x = tubelet_embed(self, z)          # [B, T', N, D], pos included
        temb = self.time_mlp2(F.silu(self.time_mlp1(
            timestep_embedding(t, self.dim))))
        if self.num_classes:
            if y is None:
                raise ValueError("a class-conditional model needs labels")
            temb = temb + self.label_embed(y)
        adaln = self.conditioning == "adaln"
        if not adaln:
            x = x + temb[:, None, None]
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            args = (x, temb) if adaln else (x,)
            x = (checkpoint(block, *args, use_reentrant=False) if remat
                 else block(*args))
        eps = self.head(self.ln_f(x))
        return eps.reshape(b, tt, hh, ww, cz)


# --------------------------------------------------------------- training

def diffusion_draws(schedule: DiffusionSchedule, latents, generator,
                    label_dropout: Optional[float] = None):
    """The train step's draws on the latents' device: t [B] uniform in
    [1, T], ε like the latents, and, for a conditional step, the
    label-dropout mask [B] (uniform < `label_dropout`)."""
    b, dev = latents.shape[0], latents.device
    t = torch.randint(1, schedule.timesteps + 1, (b,), generator=generator,
                      device=dev)
    noise = torch.randn(latents.shape, generator=generator, device=dev)
    if label_dropout is None:
        return t, noise, None
    drop = torch.rand((b,), generator=generator, device=dev) < label_dropout
    return t, noise, drop


def diffusion_loss(model: VideoDiT, schedule: DiffusionSchedule, latents, t,
                   noise, y=None):
    """ε-prediction MSE at timesteps t with noise ε (and labels y)."""
    xt = schedule.q_sample(latents, t, noise)
    return ((model(xt, t, y) - noise) ** 2).mean()


def _make_train_step(model, schedule, optimizer, label_dropout, generator,
                     mesh):
    gen = generator if generator is not None else step_generator(
        model.device)
    if mesh is not None:
        from ..parallel.sharding import (gathered_params, local_batch,
                                         local_module, mean_over,
                                         shard_params)
        if model.ringed:
            raise ValueError("the data-parallel step runs the model on each "
                             "rank's batch; build it without ring_axis")
        shard_params(model, mesh, {}, optimizer)

    def update(latents, t, noise, y):
        if mesh is None:
            loss = diffusion_loss(model, schedule, latents, t, noise, y)
        else:
            local = local_module(model, gathered_params(model, mesh))
            loss = diffusion_loss(local, schedule,
                                  *local_batch(mesh, latents, t, noise, y))
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach() if mesh is None else mean_over(loss.detach(),
                                                            mesh)

    if label_dropout is None:
        def step(latents):
            t, noise, _ = diffusion_draws(schedule, latents, gen)
            return update(latents, t, noise, None)
    else:
        def step(latents, labels):
            t, noise, drop = diffusion_draws(schedule, latents, gen,
                                             label_dropout)
            y = torch.where(drop, model.num_classes, labels)
            return update(latents, t, noise, y)
    return graphed_train_step(step, optimizer, model.device, (gen,))


def make_diffusion_train_step(model: VideoDiT, schedule: DiffusionSchedule,
                              optimizer: torch.optim.Optimizer,
                              generator: Optional[torch.Generator] = None,
                              mesh=None):
    """The JAX ``make_diffusion_train_step``: step(latents) -> loss (0-d,
    on the device), after one `optimizer` step on ``diffusion_loss`` at t
    and ε drawn on the device from `generator` (default: one of the
    model's device, seeded 0). With `mesh` the step is data parallel over
    "dp" (latents: a DTensor, or the whole batch on every rank) and the
    loss is the global batch's. Replayed as a CUDA graph on the card
    (``_train.py``); ``step.graphed.fn`` is the same step, eager."""
    return _make_train_step(model, schedule, optimizer, None, generator,
                            mesh)


def make_conditional_diffusion_train_step(
        model: VideoDiT, schedule: DiffusionSchedule,
        optimizer: torch.optim.Optimizer, label_dropout: float = 0.1,
        generator: Optional[torch.Generator] = None, mesh=None):
    """The class-conditional step: step(latents, labels) -> loss, where
    `label_dropout` of the labels become the NULL class (drawn on the
    device each step), so that the model also learns the unconditional
    prediction that CFG needs. `mesh` as for the unconditional step."""
    if not model.num_classes:
        raise ValueError("a conditional step needs a model with num_classes")
    return _make_train_step(model, schedule, optimizer, float(label_dropout),
                            generator, mesh)


# --------------------------------------------------------------- sampling

@torch.no_grad()
def ddim_sample(model: VideoDiT, schedule: DiffusionSchedule, noise,
                n_steps: int = 50, y=None, guidance_scale: float = 0.0):
    """Deterministic DDIM from the initial latents `noise` (the
    reference draws them from its rng; here they are given) to latents of
    the same shape, `n_steps` evenly spaced through the schedule.
    Conditional models take labels y [B]; `guidance_scale` w > 0 applies
    classifier-free guidance, ε = (1 + w)·ε(y) − w·ε(∅), two model calls
    a step."""
    ts = np.linspace(schedule.timesteps, 0, n_steps + 1).round()
    b, dev = noise.shape[0], noise.device
    null = (torch.full((b,), model.num_classes, dtype=torch.long, device=dev)
            if model.num_classes else None)

    def eps_fn(x, t):
        if y is None:
            return model(x, t)
        cond = model(x, t, y)
        if guidance_scale == 0.0:
            return cond
        uncond = model(x, t, null)
        return (1.0 + guidance_scale) * cond - guidance_scale * uncond

    x = noise
    for i in range(n_steps):
        t = torch.full((b,), int(ts[i]), dtype=torch.long, device=dev)
        t_prev = torch.full((b,), int(ts[i + 1]), dtype=torch.long,
                            device=dev)
        x = schedule.ddim_step(x, t, t_prev, eps_fn(x, t))
    return x


def make_ddim_sampler(model: VideoDiT, schedule: DiffusionSchedule,
                      n_steps: int = 50, guidance_scale: float = 0.0):
    """sample(noise, y=None) -> latents: ``ddim_sample`` with these
    settings. On CUDA the n-step loop is one CUDA graph (``cuda_graph``:
    the first call eager, the second captures, later calls replay; ``.fn``
    is the eager sampler); on the CPU it is the loop itself."""
    def sample(noise, y=None):
        return ddim_sample(model, schedule, noise, n_steps, y,
                           guidance_scale)
    if model.device.type != "cuda":
        return sample
    return cuda_graph(sample)
