"""Flash attention forward: the wrapper of the CUDA kernel
``csrc/flash_fwd.cu`` and its plain torch version.

The kernel replaces the JAX package's two Pallas TPU kernels,
``ops/flash_attention.py::_kernel`` and ``::_band_kernel`` (the band mode
of the same CUDA kernel serves the latter). Layout is the JAX package's,
``[batch, heads, seq, head_dim]``, with k/v allowed fewer heads (GQA).

``impl="auto"`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; ``"plain"`` forces the plain version anywhere;
``"cuda"`` forces the kernel and raises on the CPU. Nothing falls back
from one to the other. Each launch adds one to ``launches`` and to its
mode's entry of ``launches_by_mode``: "band" with a window (the mode that
serves ``_band_kernel``), else "causal" or "full".

Only the forward is ported: inputs that require grad raise
``NotImplementedError`` (the flash backward is ROADMAP queue 2 item 4).
"""
import ctypes
from typing import Optional

import numpy as np
import torch

from .. import _build

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

MODES = ("full", "causal", "band")

launches = 0
launches_by_mode = dict.fromkeys(MODES, 0)

_FN = None


def reset_counts():
    global launches
    launches = 0
    for mode in MODES:
        launches_by_mode[mode] = 0


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("flash_fwd")
        v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn = lib.ts_flash_fwd
        fn.restype = i
        fn.argtypes = ([v] * 6 + [i] * 7 + [ll] * 12
                       + [ctypes.c_float, i, i, v])
        _FN = fn
    return _FN


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward-only: the flash backward is not "
            "ported yet (ROADMAP.md queue 2 item 4); run under "
            "torch.no_grad() or use the materialized attention path")
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
                          residuals=False):
    """The torch twin of the JAX ``_reference``: materialized f32 logits,
    masked with -0.7 * f32max, softmax in f32, P cast to v's dtype, P@V
    accumulated in f32 and cast back. With ``residuals`` returns (o, l, m),
    l and m being the f32 row sum and row max [B, H, Sq] of the masked,
    scaled logits."""
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
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


def _flash_cuda(q, k, v, causal, window, sm_scale, residuals):
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
        raise ValueError(f"heads {h} and batch {b} must fit the kernel's "
                         "grid (65535)")
    check_aligned(q=q, k=k, v=v)
    # Same stride order as q, so [B, S, H, d] projections give an output
    # whose transpose back to [B, S, H*d] is a free view.
    o = torch.empty_like(q, memory_format=torch.preserve_format)
    if o.stride(-1) != 1:
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if residuals:
        l = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
        m = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    else:
        l = m = None
    if o.numel() == 0:
        return o, l, m
    fn = _kernel()
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                l.data_ptr() if residuals else None,
                m.data_ptr() if residuals else None,
                _DTYPES[q.dtype], b, h, hk, sq, sk, d,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *o.stride()[:3], sm_scale, int(bool(causal)),
                window or 0, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ts_flash_fwd launch failed: cudaError {rc}")
    global launches
    launches += 1
    launches_by_mode["band" if window else "causal" if causal else "full"] += 1
    return o, l, m


def flash_attention_fwd(q, k, v, *, causal: bool = False,
                        window: Optional[int] = None,
                        sm_scale: Optional[float] = None, impl: str = "auto"):
    """The forward with its residuals: (o, l, m), l and m the f32 row sum
    and row max [B, H, Sq] that the JAX ``_fwd_padded`` saves for the
    backward (there at the padded length)."""
    sm_scale, window = _check(q, k, v, causal, window, sm_scale)
    return _dispatch(q, k, v, causal, window, sm_scale, impl, True)


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

    ``block_q``/``block_k`` choose the TPU kernel's tiles in the JAX
    package and are accepted for the same signature; the CUDA kernel's
    tiles are fixed: bf16 192 q rows x 128 kv at d <= 64 and 128 x 128 at
    d = 128 (TMA and wgmma), f32 32 x 32."""
    sm_scale, window = _check(q, k, v, causal, window, sm_scale)
    return _dispatch(q, k, v, causal, window, sm_scale, impl, False)[0]


def _dispatch(q, k, v, causal, window, sm_scale, impl, residuals):
    if impl == "plain":
        return _plain(q, k, v, causal, window, sm_scale, residuals)
    if impl == "cuda":
        return _flash_cuda(q, k, v, causal, window, sm_scale, residuals)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r} (auto, plain or cuda)")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return _plain(q, k, v, causal, window, sm_scale, residuals)
    return _flash_cuda(q, k, v, causal, window, sm_scale, residuals)


def _plain(q, k, v, causal, window, sm_scale, residuals):
    if residuals:
        return flash_attention_plain(q, k, v, causal, window, sm_scale, True)
    return flash_attention_plain(q, k, v, causal, window, sm_scale), None, None
