"""Flash attention, forward and backward: the wrappers of the CUDA kernels
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` and their plain torch
versions.

The forward kernel replaces the JAX package's two Pallas TPU kernels,
``ops/flash_attention.py::_kernel`` and ``::_band_kernel`` (the band mode
of the same CUDA kernel serves the latter); the backward kernel replaces
its tile-recomputing VJP ``_flash_bwd`` (a ``lax.scan``, not Pallas).
Layout is the JAX package's, ``[batch, heads, seq, head_dim]``, with k/v
allowed fewer heads (GQA).

The kernels are the operators ``ts::flash_fwd`` (o; its overload
``ts::flash_fwd.residuals`` returns o, l and m; window 0 means none) and
``ts::flash_bwd``: the dispatcher runs the kernel on CUDA tensors and the
plain version on CPU tensors, and their fakes give the outputs' shapes
and strides, so ``torch.export`` traces them without storage.
``impl="auto"`` calls the ops; ``"plain"`` calls the plain versions
anywhere; ``"cuda"`` calls the ops and raises off CUDA. Nothing falls back
from one to the other. Each forward launch adds one to ``launches`` and to
its mode's entry of ``launches_by_mode``: "band" with a window (the mode
that serves ``_band_kernel``), else "causal" or "full", and to its
design's entry of ``launches_by_design``: "tiled" (bf16: TMA and
warp-specialised wgmma), "short" (bf16 at Sq and Sk <= 64: a warp a 16-row
head on mma.sync, one softmax pass; MHA self-attention at S <= 8 packs 16 /
S heads a tile, ``short_fwd_plan``), "mid" (bf16 at 64 < max(Sq, Sk) <=
256 and d <= 64: K/V of a kv head staged once by TMA, a warpgroup a 64-row
q tile on wgmma, m and l online over 64-column chunks) or "f32" (FMAs), as
the library's ``ts_flash_fwd`` reports the kernel it launched; a forward
launched while a checkpointed block is recomputed
(``_library.recomputing()``) also adds one to ``recompute_launches``.
Each backward launch adds one to ``bwd_launches`` and to its design's
entry of ``bwd_launches_by_design``: "short" (bf16 at Sq and Sk <= 64,
any d: one launch, a block staging its kv heads' whole q and kv sides),
"mid" (bf16 at d = 64 and 64 < max(Sq, Sk) <= 256, without GQA or with
at least 72 (batch, kv head) pairs: one launch, a block a kv head, five
products on wgmma), "wgmma" (bf16 at d = 64: TMA and warp-specialised
wgmma), "mma_sync" (bf16 at d = 32 and 128) or "f32" (FMAs), as the
library's ``ts_flash_bwd_design`` names the kernels it launches.

``flash_attention`` is differentiable: with grad enabled and an input that
requires grad it runs through ``_FlashAttention``, whose forward keeps the
residuals (o, l, m) and whose backward is ``flash_attention_bwd``. Under
``torch.no_grad()`` it calls the residual-free forward alone.
"""
import ctypes
from typing import Optional

import numpy as np
import torch

from .. import _build
from .._device import kernel_device, stream_handle
from . import _library

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

MODES = ("full", "causal", "band")
FWD_DESIGNS = ("tiled", "short", "f32", "mid")
BWD_DESIGNS = ("wgmma", "mma_sync", "f32", "short", "mid")
BWD_TILE = 64  # rows of the backward's q tiles, whose statistics it pads
# The short forward's launch plan (csrc/flash_fwd.cu: kShortWarps, kShortPad,
# kPackMax, kPackWarps, kPackStages, kPackBlocksPerSm: the packed grid's
# blocks an SM at d <= 64, 2 at d = 128).
SHORT_WARPS, SHORT_PAD = 4, 8
PACK_MAX, PACK_WARPS, PACK_STAGES, PACK_BLOCKS_PER_SM = 8, 4, 2, 3

launches = 0
launches_by_mode = dict.fromkeys(MODES, 0)
launches_by_design = dict.fromkeys(FWD_DESIGNS, 0)
recompute_launches = 0
bwd_launches = 0
bwd_launches_by_design = dict.fromkeys(BWD_DESIGNS, 0)
# dO copies the backward made because autograd handed it a layout the
# kernel cannot read (a non-contiguous last dim or unaligned strides).
dout_copies = 0

_FN = None
_BWD_FN = None
_BWD_DESIGN_FN = None


def reset_counts():
    global launches, recompute_launches, bwd_launches, dout_copies
    launches = recompute_launches = bwd_launches = dout_copies = 0
    for mode in MODES:
        launches_by_mode[mode] = 0
    for design in FWD_DESIGNS:
        launches_by_design[design] = 0
    for design in BWD_DESIGNS:
        bwd_launches_by_design[design] = 0


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("flash_fwd")
        v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.ts_flash_fwd
        fn.restype = i
        fn.argtypes = ([v] * 6 + [i] * 7 + [ll] * 12
                       + [ctypes.c_float, i, i, v, ctypes.POINTER(i)])
        _FN = fn
    return _FN


def _bwd_kernel():
    global _BWD_FN, _BWD_DESIGN_FN
    if _BWD_FN is None:
        lib = _build.load("flash_bwd")
        v, i = ctypes.c_void_p, ctypes.c_int
        fn = lib.ts_flash_bwd
        fn.restype = i
        fn.argtypes = [v] * 11 + [i] * 7 + [v, ctypes.c_float, i, i, v]
        design = lib.ts_flash_bwd_design
        design.restype = i
        design.argtypes = [i] * 7
        _BWD_FN, _BWD_DESIGN_FN = fn, design
    return _BWD_FN


def short_fwd_plan(b, h, hk, sq, sk, d, sms):
    """The launch plan of the "short" forward (bf16 at Sq, Sk <= 64) on a
    card of `sms` SMs, as csrc/flash_fwd.cu's PlanShort makes it (the
    library's ``ts_flash_fwd_short_plan`` reports it on the card).
    "FlashFwdPacked" for MHA self-attention at S <= PACK_MAX: tiles of
    ``pack`` = 16 // S heads (``packed_tile_rows``), a persistent grid of at
    most PACK_BLOCKS_PER_SM blocks an SM (2 at d = 128), a warp the tiles
    ``packed_warp_tiles`` gives it through a ring of PACK_STAGES slots.
    "FlashFwdShort" for the rest: ``heads`` kv heads a block."""
    if h == hk and sq == sk and sq <= PACK_MAX:
        pack = 16 // sq
        tiles = -(-b * h // pack)
        return {"kernel": "FlashFwdPacked", "pack": pack,
                "heads": PACK_WARPS * pack, "tiles": tiles,
                "blocks": min(-(-tiles // PACK_WARPS), sms * (
                    PACK_BLOCKS_PER_SM if d <= 64 else 2)),
                "smem": PACK_WARPS * PACK_STAGES * 3 * 16 * (d + SHORT_PAD)
                * 2, "stages": PACK_STAGES, "warps": PACK_WARPS}
    tasks = h // hk * -(-sq // 16)
    heads = 1 if tasks >= SHORT_WARPS else SHORT_WARPS // tasks
    return {"kernel": "FlashFwdShort", "pack": 1, "heads": heads,
            "tiles": b * h * -(-sq // 16), "blocks": -(-b * hk // heads),
            "smem": (2 * heads * -(-sk // 16) * 16 + SHORT_WARPS * 16)
            * (d + SHORT_PAD) * 2, "stages": 1, "warps": SHORT_WARPS}


def packed_tile_rows(tile, pack, s, heads):
    """The live rows of FlashFwdPacked's tile `tile` (and FlashBwdPacked's):
    (row of the tile, flat head b * H + h, row of the head) for head i of
    the tile at rows [i s, (i + 1) s), heads past `heads` left out; rows
    from pack * s on are spare."""
    return [(i * s + r, tile * pack + i, r) for i in range(pack)
            if tile * pack + i < heads for r in range(s)]


def packed_warp_tiles(plan, block, warp):
    """The tiles warp `warp` of block `block` takes, in order, in a
    FlashFwdPacked plan: every (blocks * warps)-th from its own index."""
    step = plan["blocks"] * plan["warps"]
    return range(block * plan["warps"] + warp, plan["tiles"], step)


def _check(q, k, v, causal, window, sm_scale):
    """The JAX function's argument checks; returns (sm_scale, window)."""
    if (q.dim() != 4 or k.dim() != 4 or k.shape[0] != q.shape[0]
            or v.shape != k.shape or q.shape[-1] != k.shape[-1]):
        raise ValueError(f"bad attention shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} must be a multiple of kv "
                         f"heads {k.shape[1]} (GQA)")
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal=True requires equal q/kv lengths")
    if window is not None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if q.shape[2] != k.shape[2]:
            raise ValueError("window requires equal q/kv lengths")
        window = int(window)
    return float(sm_scale), window


def band_mask(sq, sk, causal, window, device):
    """[sq, sk] bool of the live (row, col) pairs, or None for no mask."""
    if not causal and window is None:
        return None
    row = torch.arange(sq, device=device)[:, None]
    col = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= col <= row + (sk - sq)
    if window is not None:
        mask &= (col > row - window) if causal else (col - row).abs() < window
    return mask


def flash_attention_plain(q, k, v, causal=False, window=None, sm_scale=None,
                          residuals=False, mask=None):
    """The torch twin of the JAX ``_reference``: materialized f32 logits,
    masked with -0.7 * f32max, softmax in f32, P cast to v's dtype, P@V
    accumulated in f32 and cast back. With ``residuals`` returns (o, l, m),
    l and m being the f32 row sum and row max [B, H, Sq] of the masked,
    scaled logits. ``mask`` ([Sq, Sk] bool) replaces the one of `causal`
    and `window`."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if mask is None:
        mask = band_mask(q.shape[2], k.shape[2], causal, window, q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.tensor(MASK_VALUE, dtype=torch.float32,
                                              device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), v.float()).to(q.dtype)
    if not residuals:
        return o
    m = s.amax(dim=-1)
    return o, torch.exp(s - m[..., None]).sum(dim=-1), m


def check_aligned(**tensors):
    """Raises unless each tensor has a contiguous last dim and a 16-byte
    aligned base and B/H/S strides, as the kernel's vector loads need. The
    wrapper makes no copy: a caller with such a view makes it contiguous."""
    for name, t in tensors.items():
        step = 16 // t.element_size()
        if t.stride(-1) != 1:
            raise ValueError(f"the last dim of {name} must be contiguous")
        if t.data_ptr() % 16 or any(s % step for s in t.stride()[:3]):
            raise ValueError(
                f"{name}: base and B/H/S strides {t.stride()[:3]} must be "
                f"16-byte aligned (multiples of {step} elements)")


def _cuda_shapes(q, k, v):
    """The kernels' argument checks; returns (b, h, hk, sq, sk, d)."""
    if not (q.device.type == "cuda" and k.device == q.device
            and v.device == q.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}: the kernel needs all three on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes bf16 or f32 q/k/v of one dtype, "
                        f"got {q.dtype}/{k.dtype}/{v.dtype}")
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if sk == 0:
        raise ValueError("the kernel needs at least one kv position")
    if h > 65535 or b > 65535:
        raise ValueError(f"heads {h} and batch {b} must fit the kernels' "
                         "grids (65535)")
    check_aligned(q=q, k=k, v=v)
    return b, h, hk, sq, sk, d


def _empty_like(t):
    """An output in t's stride order, so that [B, S, H, d] projections get
    gradients and outputs whose transpose back is a free view."""
    out = torch.empty_like(t, memory_format=torch.preserve_format)
    if out.stride(-1) != 1:
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    return out


def _residuals(q):
    """(l, m): [B, H, Sq] f32."""
    return (q.new_empty(q.shape[:3], dtype=torch.float32),
            q.new_empty(q.shape[:3], dtype=torch.float32))


def _flash_fwd_cuda(q, k, v, causal, window, sm_scale, residuals):
    """The forward kernel (window 0: none): o, or (o, l, m) with
    ``residuals``."""
    b, h, hk, sq, sk, d = _cuda_shapes(q, k, v)
    o = _empty_like(q)
    l, m = _residuals(q) if residuals else (None, None)
    if o.numel() == 0:
        return (o, l, m) if residuals else o
    fn = _kernel()
    design = ctypes.c_int()
    with kernel_device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                l.data_ptr() if residuals else None,
                m.data_ptr() if residuals else None,
                _DTYPES[q.dtype], b, h, hk, sq, sk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], sm_scale, int(causal),
                window, stream_handle(q.device),
                ctypes.byref(design))
    if rc != 0:
        raise RuntimeError(f"ts_flash_fwd launch failed: cudaError {rc}")
    global launches, recompute_launches
    launches += 1
    launches_by_mode["band" if window else "causal" if causal else "full"] += 1
    launches_by_design[FWD_DESIGNS[design.value]] += 1
    if _library.in_recompute():
        recompute_launches += 1
    return (o, l, m) if residuals else o


def _like(t, value):
    """`value` in an output laid out as the kernel lays out t's (the
    fake's strides, which an exported program holds the op to)."""
    return _empty_like(t).copy_(value)


def _flash_fwd_cpu(q, k, v, causal, window, sm_scale, residuals):
    if residuals:
        o, l, m = flash_attention_plain(q, k, v, causal, window or None,
                                        sm_scale, True)
        return _like(q, o), l, m
    return _like(q, flash_attention_plain(q, k, v, causal, window or None,
                                          sm_scale))


_ARGS = "Tensor q, Tensor k, Tensor v, bool causal, int window, float sm_scale"
# ts::flash_fwd: o; its overload ts::flash_fwd.residuals: (o, l, m).
_FWD = _library.define(
    f"flash_fwd({_ARGS}) -> Tensor",
    cuda=lambda *a: _flash_fwd_cuda(*a, False),
    cpu=lambda *a: _flash_fwd_cpu(*a, False),
    fake=lambda q, *a: _empty_like(q))
_FWD_RES = _library.define(
    f"flash_fwd.residuals({_ARGS}) -> (Tensor, Tensor, Tensor)",
    cuda=lambda *a: _flash_fwd_cuda(*a, True),
    cpu=lambda *a: _flash_fwd_cpu(*a, True),
    fake=lambda q, *a: (_empty_like(q), *_residuals(q)))


def flash_attention_bwd_plain(q, k, v, o, l, m, do, causal=False,
                              window=None, sm_scale=None, mask=None):
    """The torch twin of the JAX ``_flash_bwd`` with P materialized:
    delta = rowsum(f32(dO) * f32(o)); P = exp(S - m) * l_inv in f32 (S the
    scaled logits, masked with -0.7 * f32max; l_inv 1 where l == 0);
    dV = P cast to the input dtype, transposed, times dO; dP = dO V^T;
    dS = (P * (dP - delta)) * scale cast to the input dtype; dQ = dS K,
    dK = dS^T Q. Products of input-dtype operands sum in f32; under GQA
    dK and dV sum over each group of q heads in f32; each output is cast
    to the input dtype at the end. ``mask`` as in the forward. Returns
    (dq, dk, dv)."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    dt = q.dtype
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = h // hk
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    dof = do.to(dt).float()
    delta = (do.float() * o.float()).sum(dim=-1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * sm_scale
    if mask is None:
        mask = band_mask(sq, sk, causal, window, q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.tensor(MASK_VALUE, dtype=torch.float32,
                                              device=s.device))
    l_inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    p = torch.exp(s - m[..., None]) * l_inv[..., None]
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * sm_scale).to(dt).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dk = dk.view(b, hk, g, sk, d).sum(dim=2)
    dv = dv.view(b, hk, g, sk, d).sum(dim=2)
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_cuda(q, k, v, o, l, m, do, causal, window, sm_scale):
    """The backward kernels (window 0: none): (dq, dk, dv)."""
    b, h, hk, sq, sk, d = _cuda_shapes(q, k, v)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dO {tuple(do.shape)} must "
                         f"have q's shape {tuple(q.shape)}")
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"o and dO must be {q.dtype}, got {o.dtype} and "
                        f"{do.dtype}")
    for name, t in (("l", l), ("m", m)):
        if (t.shape != (b, h, sq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous f32 [B, H, Sq] "
                             f"tensor on {q.device}")
    for t in (o, do):
        if t.device != q.device:
            raise ValueError(f"o and dO must be on {q.device}")
    check_aligned(o=o, do=do)
    dq, dk, dv = _empty_like(q), _empty_like(k), _empty_like(v)
    if sq == 0:
        return dq, dk.zero_(), dv.zero_()
    fn = _bwd_kernel()
    design = BWD_DESIGNS[_BWD_DESIGN_FN(_DTYPES[q.dtype], d, b, h, hk, sq,
                                        sk)]
    # delta and l_inv, or the wgmma design's per-row bias and delta in
    # blocks of BWD_TILE rows: the C entry's `scratch` ("short" and "mid"
    # compute their own in shared memory).
    scratch = None
    if design not in ("short", "mid"):
        scratch = torch.empty(2 * b * h * -(-sq // BWD_TILE) * BWD_TILE,
                              dtype=torch.float32, device=q.device)
    tensors = (q, k, v, o, do, dq, dk, dv)
    strides = (ctypes.c_longlong * 24)(*[st for t in tensors
                                         for st in t.stride()[:3]])
    with kernel_device(q.device):
        rc = fn(*[None if t is None else t.data_ptr()
                  for t in (q, k, v, o, do, l, m, scratch, dq, dk, dv)],
                _DTYPES[q.dtype], b, h, hk, sq, sk, d, strides, sm_scale,
                int(causal), window,
                stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"ts_flash_bwd launch failed: cudaError {rc}")
    global bwd_launches
    bwd_launches += 1
    bwd_launches_by_design[design] += 1
    return dq, dk, dv


def _flash_bwd_cpu(q, k, v, o, l, m, do, causal, window, sm_scale):
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, o, l, m, do, causal,
                                           window or None, sm_scale)
    return _like(q, dq), _like(k, dk), _like(v, dv)


_BWD = _library.define(
    "flash_bwd(Tensor q, Tensor k, Tensor v, Tensor o, Tensor l, Tensor m, "
    "Tensor dout, bool causal, int window, float sm_scale) "
    "-> (Tensor, Tensor, Tensor)",
    cuda=_flash_bwd_cuda, cpu=_flash_bwd_cpu,
    fake=lambda q, k, v, o, l, m, dout, causal, window, sm_scale:
        (_empty_like(q), _empty_like(k), _empty_like(v)))


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None, impl: str = "auto"):
    """The forward with its residuals: (o, l, m), l and m the f32 row sum
    and row max [B, H, Sq] that the JAX ``_fwd_padded`` saves for the
    backward (there at the padded length)."""
    sm_scale, window = _check(q, k, v, causal, window, sm_scale)
    return _dispatch(q, k, v, causal, window, sm_scale, impl, True)


def flash_attention_bwd(q, k, v, o, l, m, do, *, causal: bool = False,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None, impl: str = "auto"):
    """(dq, dk, dv) of ``flash_attention`` from the forward's residuals:
    o as it returned it, and l and m of ``flash_attention_fwd``; ``do``
    is dL/do in o's dtype. ``impl`` as for the forward."""
    sm_scale, window = _check(q, k, v, causal, window, sm_scale)
    if _use_kernel(impl, (q, k, v, o, do)):
        return _BWD(q, k, v, o, l, m, do, bool(causal), window or 0,
                    sm_scale)
    return flash_attention_bwd_plain(q, k, v, o, l, m, do, causal, window,
                                     sm_scale)


class _FlashAttention(torch.autograd.Function):
    """The differentiable flash attention: the forward keeps (q, k, v, o,
    l, m), the backward runs ``flash_attention_bwd`` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, sm_scale, impl):
        o, l, m = _dispatch(q, k, v, causal, window, sm_scale, impl, True)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.args = (causal, window, sm_scale, impl)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        causal, window, sm_scale, impl = ctx.args
        if (impl != "plain" and q.device.type == "cuda"
                and not _aligned(do)):
            global dout_copies
            do = do.contiguous()
            dout_copies += 1
        dq, dk, dv = flash_attention_bwd(q, k, v, o, l, m, do, causal=causal,
                                         window=window, sm_scale=sm_scale,
                                         impl=impl)
        return dq, dk, dv, None, None, None, None


def _aligned(t):
    try:
        check_aligned(t=t)
    except ValueError:
        return False
    return True


def flash_attention(q, k, v, *, causal: bool = False,
                    window: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_k: Optional[int] = None,
                    impl: str = "auto"):
    """softmax(Q K^T * sm_scale) V for [B, H, S, d] tensors, without the
    [Sq, Sk] logits in device memory. kv may be shorter or longer than q
    (cross-attention) unless causal or windowed; k/v may carry fewer heads
    (GQA). ``window=W`` is the sliding window: with causal each row sees
    its last W positions, without it the symmetric band |row-col| < W.
    Differentiable: with grad enabled and an input that requires grad, the
    backward is ``flash_attention_bwd``.

    ``block_q``/``block_k`` choose the TPU kernel's tiles in the JAX
    package and are accepted for the same signature; the CUDA kernels'
    tiles are fixed: forward bf16 192 q rows x 128 kv at d <= 64 and
    128 x 128 at d = 128 (TMA and wgmma), 16 q rows a warp against the
    whole row where Sq and Sk <= 64 (mma.sync; 16 // S heads a tile for
    MHA self-attention at S <= 8), 64 q rows a warpgroup
    against 64-column chunks of a staged kv head where both are <= 256 at
    d <= 64 (TMA and wgmma), f32 32 x 32;
    backward bf16 16-row slices against a block's whole staged heads
    where Sq and Sk <= 64 (mma.sync), 64-row kv slices against 64-row q
    tiles of a staged kv head where both are <= 256 at d = 64, 128 rows a
    block against 64-row steps beyond (TMA and wgmma), 64 x 64 at d = 32
    and 128 (mma.sync), f32 32 x 32."""
    sm_scale, window = _check(q, k, v, causal, window, sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, sm_scale, impl)
    return _dispatch(q, k, v, causal, window, sm_scale, impl, False)[0]


def _use_kernel(impl, tensors):
    """True for the operators (whose CUDA kernels are the hand-written
    ones and whose CPU kernels the plain versions), False for the plain
    versions called directly (``impl`` as in ``flash_attention``)."""
    if impl == "plain":
        return False
    if impl not in ("auto", "cuda"):
        raise ValueError(f"unknown impl {impl!r} (auto, plain or cuda)")
    _library.on_one_device(*tensors, cuda=impl == "cuda")
    return True


def _dispatch(q, k, v, causal, window, sm_scale, impl, residuals):
    if _use_kernel(impl, (q, k, v)):
        args = (q, k, v, bool(causal), window or 0, sm_scale)
        return _FWD_RES(*args) if residuals else (_FWD(*args), None, None)
    if residuals:
        return flash_attention_plain(q, k, v, causal, window, sm_scale, True)
    return flash_attention_plain(q, k, v, causal, window, sm_scale), None, None
