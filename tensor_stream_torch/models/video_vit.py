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

The blocks' seams are one operator each (``ops/block_fusions.py``, a
hand-written CUDA kernel on the card, the unfused ops on the CPU), with
the rounding points above: a LayerNorm with the cast of its output
(``ln_s``, ``ln_a``) and, before ``ln_t`` and ``ln_m``, the sublayer's
output projection's bias and the residual add (``LayerNorm.add_cast``;
that projection returns its product alone); the MLP's fc1 bias with the
GELU (``ts::bias_gelu``).

Parameters are f32. ``device=None`` means ``cuda:0`` and raises without a
card; random init draws from an explicit ``torch.Generator`` (weights for
parity come from the JAX package through ``models/convert.py``).

Training: ``remat=True`` runs each block under ``torch.utils.checkpoint``
(non-reentrant) when grad is enabled, as the flax module wraps its blocks
in ``nn.remat``; ``init_vit`` re-draws a model's parameters from a
generator; ``make_vit_train_step`` is the JAX step (the arrow-of-time
task, its loss and accuracy, then the optimizer), replayed as a CUDA graph
on the card.

Meshes (``parallel/sharding.py``): ``ring_axis``/``mesh`` route attention
through ring attention (``ops/ring_attention.py``: the token axis stays
sharded over that mesh axis, the flash kernel at each hop; the spatial
attention of a factorized block, every attention of a joint one);
``act_sharding`` (``make_act_sharding``) pins the residual stream's layout
after every sub-layer; ``vit_param_specs`` is the Megatron layout (q/k/v
and fc1 over heads / hidden, out and fc2 over their inputs), and
``make_vit_train_step(..., mesh=...)`` lays the parameters out by it and
steps on DTensors: dp shards the clips, tp the heads, whose attention
launches the kernel on each rank's heads (the ``ts`` operators' sharding
rules, ``parallel/_rules.py``).
"""
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..ops._library import recomputing
from ..ops.block_fusions import add_ln_cast, bias_gelu, ln_cast
from ..ops.flash_attention import band_mask, flash_attention
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

    def forward(self, x, bias=True):
        """The layer; with ``bias`` False the product alone (the caller
        adds the bias, fused with what follows: ``ops/block_fusions.py``)."""
        cd = self.compute_dtype
        y = F.linear(x.to(cd), self.weight.to(cd))
        return y if self.bias is None or not bias else y + self.bias.to(cd)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: f32 in and out, eps 1e-6.
    ``cast`` and ``add_cast`` are the blocks' seams, each one operator
    (``ops/block_fusions.py``): the LayerNorm cast to a compute dtype, and
    before it the residual add of a sublayer's output and bias."""

    def __init__(self, dim, init: _Init):
        super().__init__()
        self.weight = init.const((dim,), 1.0)
        self.bias = init.const((dim,), 0.0)

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, LN_EPS)

    def cast(self, x, dtype):
        """self(x).to(dtype)."""
        return ln_cast(x, self.weight, self.bias, dtype, LN_EPS)

    def add_cast(self, x, y, y_bias):
        """(x', self(x').to(y.dtype)) for x' = x + (y + y_bias.to(y.dtype))
        .to(x.dtype): a Dense's product `y` joining the residual `x`."""
        return add_ln_cast(x, y, y_bias, self.weight, self.bias, LN_EPS)


class MHA(nn.Module):
    """Multi-head attention over the last-but-one axis of [..., S, D].

    ``use_flash`` routes the core through ``ops.flash_attention`` (the CUDA
    kernel on the card; ``flash_impl`` as there); otherwise logits are
    materialized (f32, -inf masking, as the JAX module's own branch).
    ``num_kv_heads`` < ``num_heads`` is GQA; ``window`` the sliding window
    (causal: last W positions; else the band |i-j| < W).

    ``ring_axis``/``mesh``: ring attention over the token axis sharded on
    that mesh axis (the batch on ``ring_batch_axis``, the heads on
    ``ring_head_axis`` when tp shards them). On DTensors the output comes
    back in the layout of the projections (no collective when the tokens
    already lie on the ring's axis); plain tensors are taken as the whole
    arrays (the same on every rank) and the output is gathered whole."""

    def __init__(self, dim, num_heads, compute_dtype, init: _Init,
                 causal=False, use_flash=False, flash_impl="auto",
                 num_kv_heads=None, window=None, ring_axis=None, mesh=None,
                 ring_batch_axis="dp", ring_head_axis=None):
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
        if ring_axis is not None:
            if kv_heads != num_heads:
                raise ValueError("ring attention does not compose with "
                                 "num_kv_heads")
            if mesh is None:
                raise ValueError("ring_axis needs the mesh")
        self.ring_axis, self.mesh = ring_axis, mesh
        self.ring_batch_axis, self.ring_head_axis = (ring_batch_axis,
                                                     ring_head_axis)
        dh = self.head_dim
        self.query = Dense(dim, num_heads * dh, compute_dtype, init)
        self.key = Dense(dim, kv_heads * dh, compute_dtype, init)
        self.value = Dense(dim, kv_heads * dh, compute_dtype, init)
        self.out = Dense(num_heads * dh, dim, compute_dtype, init)

    def forward(self, x, out_bias=True):
        """Attention over x; with ``out_bias`` False the output projection's
        product without its bias (``Dense(bias=False)``)."""
        return self.attend(x, self.use_flash, self.causal, self.window,
                           out_bias)

    def attend(self, x, use_flash, causal, window, out_bias=True):
        """The forward with the core and its mask given by the caller
        (``models/streaming.py`` runs spatial attention on the materialized
        core with no mask, as the JAX stream does, whatever the block's
        own settings)."""
        lead, s, dh = x.shape[:-2], x.shape[-2], self.head_dim
        q = self.query(x).reshape(-1, s, self.num_heads, dh)
        k = self.key(x).reshape(-1, s, self.kv_heads, dh)
        v = self.value(x).reshape(-1, s, self.kv_heads, dh)
        scale = dh ** -0.5
        if self.ring_axis is not None:
            o = self._ring(x, q, k, v, causal, window, scale)
        elif use_flash:
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
        return self.out(o.reshape(*lead, s, self.num_heads * dh), out_bias)

    def _ring(self, x, q, k, v, causal, window, scale):
        from torch.distributed.tensor import DTensor

        from ..ops.ring_attention import ring_attention_sharded
        from ..parallel.sharding import as_dtensor
        mesh = self.mesh
        ring = mesh[self.ring_axis].size()
        if x.shape[-2] % ring:
            raise ValueError(f"token axis {x.shape[-2]} must divide the ring "
                             f"size {ring} ({self.ring_axis!r})")
        for axis, n, what in ((self.ring_batch_axis, x.shape[0], "batch"),
                              (self.ring_head_axis, self.num_heads,
                               "num_heads")):
            if axis is not None and n % mesh[axis].size():
                raise ValueError(f"{what} {n} must divide mesh axis {axis!r}="
                                 f"{mesh[axis].size()}")
        qt = q.transpose(1, 2)
        o = ring_attention_sharded(
            mesh, qt, k.transpose(1, 2), v.transpose(1, 2),
            seq_axis=self.ring_axis, batch_axis=self.ring_batch_axis,
            head_axis=self.ring_head_axis, causal=causal, window=window,
            sm_scale=scale, impl=self.flash_impl)
        if not isinstance(q, DTensor):
            return o.full_tensor().transpose(1, 2)
        # Back in the layout the projections gave (a no-op when the
        # residual stream's tokens are already on the ring's axis).
        return as_dtensor(o, mesh, qt.placements).transpose(1, 2)


class MLP(nn.Module):
    def __init__(self, dim, hidden_mult, compute_dtype, init: _Init):
        super().__init__()
        self.fc1 = Dense(dim, hidden_mult * dim, compute_dtype, init)
        self.fc2 = Dense(hidden_mult * dim, dim, compute_dtype, init)

    def forward(self, x):
        """fc2(gelu_tanh(fc1(x))), fc1's bias and the GELU one operator
        (``ts::bias_gelu``)."""
        return self.fc2(bias_gelu(self.fc1(x, bias=False), self.fc1.bias))


class FactorizedBlock(nn.Module):
    """Pre-LN block over [B, T, N, D]: spatial attention (within a frame),
    temporal attention (across frames; ``causal``/``temporal_window``),
    then the MLP. ``spatial_window`` bands the spatial token axis; the
    ``ring`` options (MHA's) ring the spatial attention; ``act_sharding``
    pins the residual stream after every sub-layer."""

    def __init__(self, dim, num_heads, hidden_mult, compute_dtype,
                 init: _Init, causal=False, use_flash=False,
                 flash_impl="auto", num_kv_heads=None, temporal_window=None,
                 spatial_window=None, act_sharding=None, **ring):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.act_sharding = act_sharding
        mha = dict(dim=dim, num_heads=num_heads, compute_dtype=compute_dtype,
                   init=init, use_flash=use_flash, flash_impl=flash_impl,
                   num_kv_heads=num_kv_heads)
        self.ln_s = LayerNorm(dim, init)
        self.attn_s = MHA(window=spatial_window, **mha, **ring)
        self.ln_t = LayerNorm(dim, init)
        self.attn_t = MHA(causal=causal, window=temporal_window, **mha)
        self.ln_m = LayerNorm(dim, init)
        self.mlp = MLP(dim, hidden_mult, compute_dtype, init)

    def _pin(self, x):
        return x if self.act_sharding is None else self.act_sharding(x)

    def forward(self, x):
        # Each sublayer's output projection returns its product alone: its
        # bias, the residual add and the next LayerNorm with its cast are
        # one operator (ln_t, ln_m: LayerNorm.add_cast). The temporal
        # sublayer's product goes in as the transposed view it is.
        h = self.ln_s.cast(x, self.compute_dtype)
        x, h = self.ln_t.add_cast(x, self.attn_s(h, out_bias=False),
                                  self.attn_s.out.bias)
        x = self._pin(x)
        y = self.attn_t(h.transpose(1, 2), out_bias=False).transpose(1, 2)
        x, h = self.ln_m.add_cast(x, y, self.attn_t.out.bias)
        x = self._pin(x)
        return self._pin(x + self.mlp(h).to(x.dtype))


class JointBlock(nn.Module):
    """Pre-LN joint space-time block over [B, S, D]: attention over all
    tokens at once (ringed with the ``ring`` options), then the MLP."""

    def __init__(self, dim, num_heads, hidden_mult, compute_dtype,
                 init: _Init, use_flash=False, flash_impl="auto",
                 num_kv_heads=None, act_sharding=None, **ring):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.act_sharding = act_sharding
        self.ln_a = LayerNorm(dim, init)
        self.attn = MHA(dim, num_heads, compute_dtype, init,
                        use_flash=use_flash, flash_impl=flash_impl,
                        num_kv_heads=num_kv_heads, **ring)
        self.ln_m = LayerNorm(dim, init)
        self.mlp = MLP(dim, hidden_mult, compute_dtype, init)

    _pin = FactorizedBlock._pin

    def forward(self, x):
        # As FactorizedBlock's: attn's bias, the residual add and ln_m with
        # its cast are one operator.
        h = self.ln_a.cast(x, self.compute_dtype)
        x, h = self.ln_m.add_cast(x, self.attn(h, out_bias=False),
                                  self.attn.out.bias)
        x = self._pin(x)
        return self._pin(x + self.mlp(h).to(x.dtype))


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
                 generator: Optional[torch.Generator] = None,
                 act_sharding=None, ring_axis=None, mesh=None,
                 ring_batch_axis="dp", ring_head_axis=None):
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
        self.act_sharding = act_sharding
        fan_in = tubelet_t * patch * patch * channels
        self.tubelet = Dense(fan_in, dim, compute_dtype, init)
        self.pos_spatial = init.normal(
            ((height // patch) * (width // patch), dim), 0.02)
        self.pos_temporal = init.normal((frames // tubelet_t, dim), 0.02)
        common = dict(dim=dim, num_heads=num_heads, hidden_mult=hidden_mult,
                      compute_dtype=compute_dtype, init=init,
                      use_flash=use_flash, flash_impl=flash_impl,
                      num_kv_heads=num_kv_heads, act_sharding=act_sharding)
        if ring_axis is not None:
            common.update(ring_axis=ring_axis, mesh=mesh,
                          ring_batch_axis=ring_batch_axis,
                          ring_head_axis=ring_head_axis)
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
        if self.act_sharding is not None:
            x = self.act_sharding(x)
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
    later one the recompute in the backward, whose kernel launches
    ``ops.flash_attention`` and ``ops.block_fusions`` count apart
    (``recompute_launches``, under ``ops._library.recomputing()``)."""

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


def flip_clips(clips, flip_mask):
    """The arrow-of-time task's input: the clips whose `flip_mask` [B]
    (bool) is set, time-reversed."""
    return torch.where(flip_mask[:, None, None, None, None], clips.flip(1),
                       clips)


def loss_and_accuracy(logits, labels):
    """-mean(log_softmax(logits)[label]) and mean(argmax == label)."""
    loss = -torch.take_along_dim(torch.log_softmax(logits, dim=-1),
                                 labels[:, None], dim=1).mean()
    acc = (logits.argmax(-1) == labels).float().mean()
    return loss, acc


def vit_loss(model: VideoViT, clips: torch.Tensor, flip_mask: torch.Tensor):
    """The JAX step's task and ``loss_fn``: clips [B, T, H, W, C] whose
    `flip_mask` [B] (bool) is set are time-reversed on the device, the mask
    is the label; returns (loss, acc) as 0-d device tensors, loss =
    -mean(log_softmax(logits)[label]), acc = mean(argmax == label)."""
    return loss_and_accuracy(model(flip_clips(clips, flip_mask)),
                             flip_mask.long())


def vit_param_specs(model: nn.Module, tp_axis: str = "mp", mesh=None) -> dict:
    """The Megatron layout, {parameter name: JAX-style spec} (the JAX
    ``vit_param_specs`` on the port's [out, in] weights): q/k/v weights
    and biases over heads (their output rows) on `tp_axis`, the output
    projection over its input; fc1 over the hidden units, fc2 over its
    input (its bias replicated); everything else replicated.

    With `mesh` the head counts are checked up front: under GQA/MQA the
    key/value heads are ``num_kv_heads``, and a tp axis they do not divide
    raises a ValueError naming the counts."""
    tp = None
    if mesh is not None and tp_axis in mesh.mesh_dim_names:
        tp = mesh[tp_axis].size()
    specs = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        leaf = parts[-1]
        spec = ()
        proj = next((n for n in parts if n in ("query", "key", "value")),
                    None)
        if proj is not None:
            owner = model.get_submodule(".".join(parts[:parts.index(proj)]))
            heads = owner.num_heads if proj == "query" else owner.kv_heads
            if tp and heads % tp:
                raise ValueError(
                    f"{proj} projection has {heads} heads (num_kv_heads for "
                    f"key/value under GQA/MQA), not divisible by mesh axis "
                    f"'{tp_axis}' of size {tp}; pick num_kv_heads as a "
                    f"multiple of the tp axis size, or shrink the tp axis.")
            spec = (tp_axis, None) if leaf == "weight" else (tp_axis,)
        elif "out" in parts and leaf == "weight":
            spec = (None, tp_axis)
        elif "fc1" in parts:
            spec = (tp_axis, None) if leaf == "weight" else (tp_axis,)
        elif "fc2" in parts and leaf == "weight":
            spec = (None, tp_axis)
        specs[name] = spec
    return specs


def make_act_sharding(mesh, seq_axis: Optional[str], joint: bool = False):
    """The residual-stream pin: [B, T, N, D] with the batch on "dp" and
    the spatial tokens on `seq_axis` (sequence parallelism), or with
    ``joint`` the flat [B, S, D] stream with S on `seq_axis`. Returns
    pin(x) -> x redistributed so (``with_sharding_constraint``)."""
    from ..parallel.sharding import distribute
    spec = ("dp", seq_axis, None) if joint else ("dp", None, seq_axis, None)

    def pin(x):
        return distribute(x, mesh, spec)
    return pin


def make_vit_train_step(model: VideoViT, optimizer: torch.optim.Optimizer,
                        mesh=None, tp_axis: str = "mp"):
    """The JAX ``make_vit_train_step``: returns step(clips, flip_mask) ->
    (loss, acc), which takes the gradients of ``vit_loss``, applies
    `optimizer` and clears the gradients, updating `model` and `optimizer`
    in place. Nothing in it waits for the device: loss and acc come back
    as 0-d device tensors.

    With `mesh` (``parallel.make_mesh``) the model's parameters are laid
    out by ``vit_param_specs`` on `tp_axis` (replaced by DTensor
    parameters, the optimizer pointed at them; it must have no state
    yet), the clips and mask (DTensors, or the whole batch on every rank)
    are sharded over "dp", and the model runs on DTensors (the flip and
    the loss on each rank's share); loss and acc are the global batch's,
    the same on every rank.

    On CUDA the step is replayed as a CUDA graph (``_train.py``: the
    counterpart of the JAX step's ``jax.jit``; the optimizer is made
    capturable, a float hyperparameter changed after the capture raises,
    a tensor lr may be scheduled); on the CPU it runs eagerly. On CUDA
    ``step.graphed.fn`` is the same step, eager."""
    if mesh is None:
        def step(clips, flip_mask):
            loss, acc = vit_loss(model, clips, flip_mask)
            loss.backward()
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            return loss.detach(), acc
        return graphed_train_step(step, optimizer, model.device)

    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import distribute, mean_over, shard_params
    shard_params(model, mesh, vit_param_specs(model, tp_axis, mesh),
                 optimizer)
    dp = mesh["dp"].size()

    def meshed_step(clips, flip_mask):
        # The flip and the loss run on each rank's own clips and logits
        # (DTensor has no sharding rule for flip in every torch release);
        # the loss over dp is the mean of the ranks' means.
        clips = distribute(clips, mesh, ("dp",))
        mask = distribute(flip_mask, mesh, ("dp",)).to_local()
        x = DTensor.from_local(flip_clips(clips.to_local(), mask), mesh,
                               clips.placements, run_check=False,
                               shape=clips.shape, stride=clips.stride())
        logits = distribute(model(x), mesh, ("dp",)).to_local()
        loss, acc = loss_and_accuracy(logits, mask.long())
        (loss / dp).backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return mean_over(loss.detach(), mesh), mean_over(acc, mesh)
    return graphed_train_step(meshed_step, optimizer, model.device)
