"""VideoViT: a space-time video transformer, as ``nn.Module``s.

Port of the JAX package's ``models/video_vit.py`` (MHA, MLP,
FactorizedBlock, JointBlock, tubelet_embed, VideoViT). Clips
``[B, T, H, W, C]`` go to logits. ``attention="factorized"`` attends
within a frame, then across frames at each patch position, then applies
the MLP; ``"joint"`` attends over all T'·N tokens at once, the regime the
flash kernel (``use_flash=True``) exists for.

The cast points are flax's, written out by hand (no autocast):

* dense layers cast their input and f32 kernel to ``compute_dtype`` and add
  the bias after the product, in that dtype;
* LayerNorm runs in f32 with flax's eps of 1e-6;
* the MLP's GELU is the tanh approximation (flax's ``nn.gelu`` default);
* attention logits and softmax are f32, P@V in ``compute_dtype``;
* the head is f32;
* the tubelet Conv3D has stride equal to its kernel, so it is a patchify
  and one matmul (which also keeps cuDNN's TF32 out of f32 runs).

Parameters are f32. ``device=None`` means ``cuda:0`` and raises without a
card; random init draws from an explicit ``torch.Generator`` (weights for
parity come from the JAX package through ``models/convert.py``).

Training: ``remat=True`` runs each block under ``torch.utils.checkpoint``
(non-reentrant) when grad is enabled, as the flax module wraps its blocks
in ``nn.remat``; ``init_vit`` re-draws a model's parameters from a
generator; ``make_vit_train_step`` is the JAX step without its mesh (the
arrow-of-time task, its loss and accuracy, then the optimizer), replayed
as a CUDA graph on the card. Left out here: ring attention
(``ring_axis``/``mesh``), ``act_sharding``, ``vit_param_specs``,
``make_act_sharding`` and the mesh of ``make_vit_train_step`` (ROADMAP.md,
the parallel slice).
"""
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops.flash_attention import band_mask, flash_attention, recomputing
from ._train import _GraphedStep, graphed_train_step  # noqa: F401

LN_EPS = 1e-6  # flax nn.LayerNorm's default


class _Init:
    """Draws parameters on the CPU from one generator, then moves them."""

    def __init__(self, device, generator):
        self.device = device
        self.gen = generator

    def normal(self, shape, std):
        t = torch.empty(shape, dtype=torch.float32)
        t.normal_(0.0, std, generator=self.gen)
        return nn.Parameter(t.to(self.device))

    def const(self, shape, value):
        return nn.Parameter(torch.full(shape, float(value), dtype=torch.float32,
                                       device=self.device))


def draw_params(generator: torch.Generator, model: nn.Module) -> None:
    """Re-draws the parameters of a convolutional model from `generator`
    (on the CPU, in registration order): every ``weight`` of two or more
    dims normal with std fan_in**-0.5 (fan_in: its size over its output
    axis 0), every 1-D ``weight`` (a norm's scale) 1, every ``bias`` 0."""
    with torch.no_grad():
        for mod in model.modules():
            for name, p in mod.named_parameters(recurse=False):
                if name == "weight" and p.ndim >= 2:
                    w = torch.empty(p.shape)
                    w.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
                    p.copy_(w)
                else:
                    p.fill_(1.0 if name == "weight" else 0.0)


class Dense(nn.Module):
    """flax ``Dense``/``DenseGeneral`` with f32 parameters: the input and
    the kernel cast to ``compute_dtype``, the bias added after the product
    in that dtype. ``weight`` is [out, in] (kernel-init at lecun-normal
    scale, or zero where ``zero_init``; bias zero, or none where not
    ``use_bias``)."""

    def __init__(self, in_features, out_features, compute_dtype, init: _Init,
                 use_bias=True, zero_init=False):
        super().__init__()
        self.compute_dtype = compute_dtype
        shape = (out_features, in_features)
        self.weight = (init.const(shape, 0.0) if zero_init
                       else init.normal(shape, in_features ** -0.5))
        self.bias = init.const((out_features,), 0.0) if use_bias else None

    def forward(self, x):
        cd = self.compute_dtype
        y = F.linear(x.to(cd), self.weight.to(cd))
        return y if self.bias is None else y + self.bias.to(cd)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 in and out, eps 1e-6."""

    def __init__(self, dim, init: _Init):
        super().__init__()
        self.weight = init.const((dim,), 1.0)
        self.bias = init.const((dim,), 0.0)

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, LN_EPS)


class MHA(nn.Module):
    """Multi-head attention over the last-but-one axis of [..., S, D].

    ``use_flash`` routes the core through ``ops.flash_attention`` (the CUDA
    kernel on the card; ``flash_impl`` as there); otherwise logits are
    materialized (f32, -inf masking, as the JAX module's own branch).
    ``num_kv_heads`` < ``num_heads`` is GQA; ``window`` the sliding window
    (causal: last W positions; else the band |i-j| < W)."""

    def __init__(self, dim, num_heads, compute_dtype, init: _Init,
                 causal=False, use_flash=False, flash_impl="auto",
                 num_kv_heads=None, window=None):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"dim {dim} must be a multiple of num_heads "
                             f"{num_heads}")
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_kv_heads {kv_heads} must divide "
                             f"num_heads {num_heads}")
        self.num_heads, self.kv_heads = num_heads, kv_heads
        self.head_dim = dim // num_heads
        self.compute_dtype = compute_dtype
        self.causal, self.window = causal, window
        self.use_flash, self.flash_impl = use_flash, flash_impl
        dh = self.head_dim
        self.query = Dense(dim, num_heads * dh, compute_dtype, init)
        self.key = Dense(dim, kv_heads * dh, compute_dtype, init)
        self.value = Dense(dim, kv_heads * dh, compute_dtype, init)
        self.out = Dense(num_heads * dh, dim, compute_dtype, init)

    def forward(self, x):
        return self.attend(x, self.use_flash, self.causal, self.window)

    def attend(self, x, use_flash, causal, window):
        """The forward with the core and its mask given by the caller
        (``models/streaming.py`` runs spatial attention on the materialized
        core with no mask, as the JAX stream does, whatever the block's
        own settings)."""
        lead, s, dh = x.shape[:-2], x.shape[-2], self.head_dim
        q = self.query(x).reshape(-1, s, self.num_heads, dh)
        k = self.key(x).reshape(-1, s, self.kv_heads, dh)
        v = self.value(x).reshape(-1, s, self.kv_heads, dh)
        scale = dh ** -0.5
        if use_flash:
            # [N, S, H, dh] -> [N, H, S, dh] views: the kernel takes the
            # strides, and its output transposes back without a copy.
            o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window, sm_scale=scale,
                                impl=self.flash_impl).transpose(1, 2)
        else:
            if self.kv_heads != self.num_heads:
                rep = self.num_heads // self.kv_heads
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            logits = torch.matmul(q.transpose(1, 2).float(),
                                  k.permute(0, 2, 3, 1).float()) * scale
            mask = band_mask(s, s, causal, window, x.device)
            if mask is not None:
                logits = logits.masked_fill(~mask, float("-inf"))
            probs = torch.softmax(logits, dim=-1).to(self.compute_dtype)
            o = torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)
        return self.out(o.reshape(*lead, s, self.num_heads * dh))


class MLP(nn.Module):
    def __init__(self, dim, hidden_mult, compute_dtype, init: _Init):
        super().__init__()
        self.fc1 = Dense(dim, hidden_mult * dim, compute_dtype, init)
        self.fc2 = Dense(hidden_mult * dim, dim, compute_dtype, init)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class FactorizedBlock(nn.Module):
    """Pre-LN block over [B, T, N, D]: spatial attention (within a frame),
    temporal attention (across frames; ``causal``/``temporal_window``),
    then the MLP. ``spatial_window`` bands the spatial token axis."""

    def __init__(self, dim, num_heads, hidden_mult, compute_dtype,
                 init: _Init, causal=False, use_flash=False,
                 flash_impl="auto", num_kv_heads=None, temporal_window=None,
                 spatial_window=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        mha = dict(dim=dim, num_heads=num_heads, compute_dtype=compute_dtype,
                   init=init, use_flash=use_flash, flash_impl=flash_impl,
                   num_kv_heads=num_kv_heads)
        self.ln_s = LayerNorm(dim, init)
        self.attn_s = MHA(window=spatial_window, **mha)
        self.ln_t = LayerNorm(dim, init)
        self.attn_t = MHA(causal=causal, window=temporal_window, **mha)
        self.ln_m = LayerNorm(dim, init)
        self.mlp = MLP(dim, hidden_mult, compute_dtype, init)

    def forward(self, x):
        cd = self.compute_dtype
        x = x + self.attn_s(self.ln_s(x).to(cd)).to(x.dtype)
        y = self.attn_t(self.ln_t(x).to(cd).transpose(1, 2))
        x = x + y.transpose(1, 2).to(x.dtype)
        return x + self.mlp(self.ln_m(x).to(cd)).to(x.dtype)


class JointBlock(nn.Module):
    """Pre-LN joint space-time block over [B, S, D]: attention over all
    tokens at once, then the MLP."""

    def __init__(self, dim, num_heads, hidden_mult, compute_dtype,
                 init: _Init, use_flash=False, flash_impl="auto",
                 num_kv_heads=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.ln_a = LayerNorm(dim, init)
        self.attn = MHA(dim, num_heads, compute_dtype, init,
                        use_flash=use_flash, flash_impl=flash_impl,
                        num_kv_heads=num_kv_heads)
        self.ln_m = LayerNorm(dim, init)
        self.mlp = MLP(dim, hidden_mult, compute_dtype, init)

    def forward(self, x):
        cd = self.compute_dtype
        x = x + self.attn(self.ln_a(x).to(cd)).to(x.dtype)
        return x + self.mlp(self.ln_m(x).to(cd)).to(x.dtype)


def tubelet_tokens(m, clips):
    """Tubelet Conv3D (stride = kernel, so patchify + one matmul):
    [B, T, H, W, C] -> [B, T', N, D] in ``m.compute_dtype``. Reads
    ``m.tubelet`` (a Dense over t·p·p·C patch vectors)."""
    b, t, h, w, c = clips.shape
    tt, p = m.tubelet_t, m.patch
    if t % tt or h % p or w % p:
        raise ValueError(f"clips {tuple(clips.shape)} must divide into "
                         f"tubelets of {tt}x{p}x{p}")
    x = clips.to(m.compute_dtype).reshape(b, t // tt, tt, h // p, p, w // p,
                                          p, c)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(
        b, t // tt, (h // p) * (w // p), tt * p * p * c)
    return m.tubelet(x)


def tubelet_embed(m, clips):
    """``tubelet_tokens`` plus the factorized positional embeddings
    (``m.pos_spatial``, ``m.pos_temporal``), in ``m.residual_dtype``."""
    x = tubelet_tokens(m, clips).float()
    x = x + m.pos_spatial[None, None] + m.pos_temporal[None, :, None]
    return x.to(m.residual_dtype)


class VideoViT(nn.Module):
    """Space-time ViT: clips [B, frames, size, size, C] -> logits [B,
    classes] (``causal``: per tubelet step, [B, T', classes]).

    The positional embeddings are sized at construction for ``frames`` and
    ``size`` (the flax module sizes them from its first input)."""

    def __init__(self, num_classes, depth=4, dim=192, num_heads=3, patch=16,
                 tubelet_t=2, hidden_mult=4, compute_dtype=torch.bfloat16,
                 causal=False, use_flash=False, flash_impl="auto",
                 num_kv_heads=None, temporal_window=None,
                 spatial_window=None, residual_dtype=torch.float32,
                 attention="factorized", frames=16, size=224, channels=3,
                 remat=False, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if attention not in ("factorized", "joint"):
            raise ValueError(f"attention must be 'factorized' or 'joint': "
                             f"{attention!r}")
        joint = attention == "joint"
        if joint and causal:
            raise ValueError("causal needs factorized attention")
        if temporal_window is not None and not causal:
            raise ValueError("temporal_window requires causal=True")
        if joint and spatial_window is not None:
            raise ValueError("spatial_window requires factorized attention "
                             "(the joint token axis mixes space and time)")
        height, width = (size, size) if isinstance(size, int) else size
        if frames % tubelet_t or height % patch or width % patch:
            raise ValueError(f"frames {frames} and size {size} must divide "
                             f"into tubelets of {tubelet_t}x{patch}x{patch}")
        self.device = resolve_device(device)
        init = _Init(self.device, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.joint, self.causal, self.remat = joint, causal, remat
        self.frames, self.channels = frames, channels
        self.size = (height, width)
        self.patch, self.tubelet_t = patch, tubelet_t
        self.compute_dtype, self.residual_dtype = compute_dtype, residual_dtype
        fan_in = tubelet_t * patch * patch * channels
        self.tubelet = Dense(fan_in, dim, compute_dtype, init)
        self.pos_spatial = init.normal(
            ((height // patch) * (width // patch), dim), 0.02)
        self.pos_temporal = init.normal((frames // tubelet_t, dim), 0.02)
        common = dict(dim=dim, num_heads=num_heads, hidden_mult=hidden_mult,
                      compute_dtype=compute_dtype, init=init,
                      use_flash=use_flash, flash_impl=flash_impl,
                      num_kv_heads=num_kv_heads)
        if joint:
            blocks = [JointBlock(**common) for _ in range(depth)]
        else:
            blocks = [FactorizedBlock(causal=causal,
                                      temporal_window=temporal_window,
                                      spatial_window=spatial_window, **common)
                      for _ in range(depth)]
        self.blocks = nn.ModuleList(blocks)
        self.ln_f = LayerNorm(dim, init)
        self.head = Dense(dim, num_classes, torch.float32, init)

    def forward(self, clips):
        x = tubelet_embed(self, clips)
        if self.joint:
            b, tt, n, d = x.shape
            x = x.reshape(b, tt * n, d)
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = checkpoint(_Remat(block), x, use_reentrant=False)
            else:
                x = block(x)
        x = self.ln_f(x)
        if self.causal:
            x = x.mean(dim=2)           # per-step pool (tokens only)
        elif self.joint:
            x = x.mean(dim=1)           # global token pool (flat)
        else:
            x = x.mean(dim=(1, 2))      # global token pool
        return self.head(x)


class _Remat:
    """One block under ``checkpoint``: its first call is the forward, a
    later one the recompute in the backward, whose flash launches
    ``ops.flash_attention`` counts apart (``recompute_launches``)."""

    def __init__(self, block):
        self.block = block
        self.calls = 0

    def __call__(self, x):
        self.calls += 1
        if self.calls == 1:
            return self.block(x)
        with recomputing():
            return self.block(x)


def init_vit(generator: torch.Generator, model: VideoViT,
             clip_shape: Tuple[int, ...]) -> dict:
    """Re-draws every parameter of `model` from `generator`, as the
    constructor draws them (in registration order, on the CPU: Dense
    kernels normal with std fan_in**-0.5, positional embeddings 0.02,
    biases 0, LayerNorm scales 1), and returns the state dict: a model
    built with the same generator gets the same values. `clip_shape`
    [B, T, H, W, C] must be what the model was sized for (the JAX
    ``init_vit`` sizes the model from it)."""
    if (len(clip_shape) != 5 or clip_shape[1] != model.frames
            or tuple(clip_shape[2:4]) != model.size
            or clip_shape[4] != model.channels):
        raise ValueError(f"clips {tuple(clip_shape)} do not fit a model of "
                         f"{model.frames} frames of {model.size} with "
                         f"{model.channels} channels")
    init = _Init(model.device, generator)
    owners = {id(p): mod for mod in model.modules()
              for p in mod.parameters(recurse=False)}
    params = dict(model.named_parameters())
    # The constructor draws the tubelet before the positional embeddings,
    # which named_parameters lists first (a module's own come first).
    first = ["tubelet.weight", "tubelet.bias", "pos_spatial", "pos_temporal"]
    order = first + [n for n in params if n not in first]
    with torch.no_grad():
        for name in order:
            param = params[name]
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("pos_"):
                new = init.normal(param.shape, 0.02)
            elif leaf == "bias":
                new = init.const(param.shape, 0.0)
            elif isinstance(owners[id(param)], LayerNorm):
                new = init.const(param.shape, 1.0)
            else:                           # a Dense kernel [out, in]
                new = init.normal(param.shape, param.shape[1] ** -0.5)
            param.copy_(new)
    return model.state_dict()


def vit_loss(model: VideoViT, clips: torch.Tensor, flip_mask: torch.Tensor):
    """The JAX step's task and ``loss_fn``: clips [B, T, H, W, C] whose
    `flip_mask` [B] (bool) is set are time-reversed on the device, the mask
    is the label; returns (loss, acc) as 0-d device tensors, loss =
    -mean(log_softmax(logits)[label]), acc = mean(argmax == label)."""
    x = torch.where(flip_mask[:, None, None, None, None], clips.flip(1),
                    clips)
    labels = flip_mask.long()
    logits = model(x)
    loss = -torch.take_along_dim(torch.log_softmax(logits, dim=-1),
                                 labels[:, None], dim=1).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


def make_vit_train_step(model: VideoViT, optimizer: torch.optim.Optimizer):
    """The JAX ``make_vit_train_step`` on one device, without its mesh:
    returns step(clips, flip_mask) -> (loss, acc), which takes the
    gradients of ``vit_loss``, applies `optimizer` and clears the
    gradients, updating `model` and `optimizer` in place. Nothing in it
    waits for the device: loss and acc come back as 0-d device tensors.

    On CUDA the step is replayed as a CUDA graph (``_train.py``: the
    counterpart of the JAX step's ``jax.jit``; the optimizer is made
    capturable, a float hyperparameter changed after the capture raises,
    a tensor lr may be scheduled); on the CPU it runs eagerly. On CUDA
    ``step.graphed.fn`` is the same step, eager."""
    def step(clips, flip_mask):
        loss, acc = vit_loss(model, clips, flip_mask)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return loss.detach(), acc
    return graphed_train_step(step, optimizer, model.device)
