"""Streaming (online) VideoViT inference with a temporal KV cache.

Port of the JAX package's ``models/streaming.py``. A causal VideoViT
(``VideoViT(causal=True)``) is run one tubelet at a time: one step of
``tubelet_t`` frames in, one logits row out, with each block's temporal
keys and values kept in a cache, so a step costs O(T) attention against
the cache instead of recomputing O(T²).

The cache is a fixed-size ring: step t writes slot ``t % max_steps``, so
past ``max_steps`` the attention slides over the most recent
``max_steps`` steps. That is the batch model's sliding window, so
``VideoViT(causal=True, temporal_window=max_steps)`` reproduces
``stream_step``'s logits at every step, past the wrap too. With GQA
(``num_kv_heads``) the cache holds only the kv heads. Steps past the
trained temporal extent take the last positional embedding.

    model = VideoViT(num_classes, causal=True, frames=32, ...)
    cache = init_stream_cache(model, batch=2, max_steps=16)
    step = functools.partial(stream_step, model)
    for frames in stream:            # [B, tubelet_t, H, W, 3]
        cache, logits = step(cache, frames)

The weights are the ordinary VideoViT ones. The step reads ``t`` only on
the device (slot, live mask and positional clamp are tensor ops), so it
never waits for the card and a CUDA graph can capture it.

The cache is updated IN PLACE: ``stream_step`` writes the new k/v into
the ring tensors, adds one to ``t`` and returns the same dict. Keep no
copy of an earlier state by reference; clone it (``clone_cache``).
"""
from typing import Dict

import numpy as np
import torch

from .._device import resolve_device
from .video_vit import LN_EPS, VideoViT, tubelet_tokens


def init_stream_cache(model: VideoViT, batch: int, max_steps: int) -> Dict:
    """Zeroed ring cache on ``model.device``: ``{"t": 0-d int64, "blocks":
    [{"k", "v"}] * depth}``, k and v of shape [B, N, max_steps, Hkv, dh]
    in ``model.compute_dtype`` (the JAX package's layout). N is the
    positional table's token count."""
    device = resolve_device(model.device)
    attn = model.blocks[0].attn_t
    shape = (batch, model.pos_spatial.shape[0], max_steps, attn.kv_heads,
             attn.head_dim)

    def kv():
        return torch.zeros(shape, dtype=model.compute_dtype, device=device)
    return {"t": torch.zeros((), dtype=torch.int64, device=device),
            "blocks": [{"k": kv(), "v": kv()} for _ in model.blocks]}


def clone_cache(cache: Dict) -> Dict:
    """A copy of the cache that later steps on the original leave alone."""
    return {"t": cache["t"].clone(),
            "blocks": [{"k": b["k"].clone(), "v": b["v"].clone()}
                       for b in cache["blocks"]]}


def stream_cache_from_jax(cache, device=None) -> Dict:
    """The JAX package's cache, its leaves as numpy arrays (``{"t": (),
    "blocks": [{"k", "v"}]}``), as this package's cache on ``device``
    (None: cuda). k and v keep their dtype; bfloat16 arrays (numpy's
    ``ml_dtypes`` type) carry over bit for bit."""
    device = resolve_device(device)

    def leaf(a):
        a = np.array(a)  # a writable, contiguous copy
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)
    return {"t": torch.tensor(int(np.asarray(cache["t"])), dtype=torch.int64,
                              device=device),
            "blocks": [{"k": leaf(b["k"]), "v": leaf(b["v"])}
                       for b in cache["blocks"]]}


def _ln(ln, x):
    """The JAX stream's hand LayerNorm: biased variance, eps 1e-6."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + LN_EPS) * ln.weight + ln.bias


def _temporal_attn(attn, y, cache_blk, t):
    """One step of causal temporal attention against the ring.

    y: [B, N, D] (post-LN, compute dtype); cache k/v [B, N, S, Hkv, dh],
    each group of H/Hkv query heads sharing one kv head. The new k/v go
    into slot t % S in place. Logits and softmax in f32 (dead slots get
    -inf), probabilities cast to the compute dtype for P·V. Returns
    [B, N, D] in the compute dtype."""
    b, n, _ = y.shape
    h, hk, dh = attn.num_heads, attn.kv_heads, attn.head_dim
    q = attn.query(y).view(b, n, hk, h // hk, dh)
    kc, vc = cache_blk["k"], cache_blk["v"]
    s = kc.shape[2]
    slot = torch.remainder(t, s).view(1)
    kc.index_copy_(2, slot, attn.key(y).view(b, n, 1, hk, dh))
    vc.index_copy_(2, slot, attn.value(y).view(b, n, 1, hk, dh))
    # Products of compute-dtype values, summed in f32 (the JAX einsum's
    # preferred_element_type=f32): inputs widened, so bf16 logits are
    # never rounded.
    logits = torch.einsum("bnkgd,bnskd->bnkgs", q.float(), kc.float())
    logits = logits * dh ** -0.5
    live = torch.arange(s, device=y.device) <= t  # all once the ring wraps
    logits = logits.masked_fill(~live, float("-inf"))
    probs = torch.softmax(logits, dim=-1).to(y.dtype)
    o = torch.einsum("bnkgs,bnskd->bnkgd", probs, vc)
    return attn.out(o.reshape(b, n, h * dh))


def stream_step(model: VideoViT, cache: Dict, frames):
    """(cache, frames [B, tubelet_t, H, W, 3]) -> (cache, logits [B, C]).

    The batch causal forward's step ``cache["t"]``, computed against the
    cache. The residual stream is f32 whatever ``model.residual_dtype``
    is, spatial attention runs on the materialized core (never the flash
    kernel), and ln_f, the token pool and the head are f32, as in the JAX
    package. Updates ``cache`` in place and returns it."""
    if not model.causal:
        raise ValueError("stream_step needs VideoViT(causal=True)")
    if frames.shape[1] != model.tubelet_t:
        raise ValueError(f"frames {tuple(frames.shape)} must be one tubelet "
                         f"of {model.tubelet_t} frames")
    t = cache["t"]
    cd = model.compute_dtype
    x = tubelet_tokens(model, frames)[:, 0].float()    # [B, N, D]
    pos_t = model.pos_temporal
    t_pos = torch.clamp(t, max=pos_t.shape[0] - 1).view(1)  # past the extent
    x = x + model.pos_spatial[None] + pos_t.index_select(0, t_pos)[None]
    for block, cache_blk in zip(model.blocks, cache["blocks"]):
        y = _ln(block.ln_s, x).to(cd)
        x = x + block.attn_s.attend(y, False, False, None).to(x.dtype)
        y = _ln(block.ln_t, x).to(cd)
        x = x + _temporal_attn(block.attn_t, y, cache_blk, t).to(x.dtype)
        y = _ln(block.ln_m, x).to(cd)
        x = x + block.mlp(y).to(x.dtype)
    x = _ln(model.ln_f, x).mean(dim=1)                 # pool tokens
    t.add_(1)
    return cache, model.head(x)
