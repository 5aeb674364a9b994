"""Full-frame NV12 -> RGB24/BGR24: the wrapper of the CUDA kernel
``csrc/nv12_rgb.cu`` and its plain torch version. The kernel replaces
the JAX package's Pallas TPU kernel
``ops/pallas_color.py::_nv12_rgb_kernel``.

``nv12_to_rgb`` calls the operator ``ts::nv12_to_rgb`` (``_library``),
whose CUDA kernel is the hand-written one and whose CPU kernel is the
plain version; there is no fallback between the two. Its fake gives the
output's shape and dtype, so ``torch.export`` traces it without storage.
The kernel has two variants, and ``variant`` picks one from the shape and
the pointers before the launch: "vector" (bands of rows moved by bulk
copies) for W % 16 == 0 with 16-byte aligned planes, "edge" for every
other even shape. Each launch adds one to ``launches`` and to its
variant's entry of ``launches_by_variant``, so a run can show that its
main path went through the kernel, and which variant served it.
"""
import ctypes

import torch

from .. import _build
from .._device import kernel_device
from . import _library, color

VARIANTS = ("vector", "edge")
_ENTRY = {"vector": "ts_nv12_rgb_vec", "edge": "ts_nv12_rgb"}

launches = 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)

_FNS = None


def reset_counts():
    global launches
    launches = 0
    for v in VARIANTS:
        launches_by_variant[v] = 0


def _lib():
    global _FNS
    if _FNS is None:
        lib = _build.load("nv12_rgb")
        v, i = ctypes.c_void_p, ctypes.c_int
        fns = {}
        for name, entry in _ENTRY.items():
            fn = getattr(lib, entry)
            fn.restype = i
            fn.argtypes = [v, v, v, i, i, i, i, i, i, i, v]
            fns[name] = fn
        _FNS = fns
    return _FNS


def variant(h: int, w: int, y_ptr: int, uv_ptr: int, out_ptr: int) -> str:
    """The kernel variant for an [N,H,W] conversion with these base
    addresses. The vector kernel moves bands of whole rows with 1-D bulk
    copies, whose addresses and sizes must be multiples of 16 bytes: it
    needs W % 16 == 0 and every plane and the output on a 16-byte
    boundary (then every row is). It holds a band of at least one row
    pair in shared memory (W <= 4096) and indexes a frame in 32 bits, which
    H < 65536 keeps within range (3*H*W < 2**31). The edge kernel takes
    every other even H and W. The C entry point of each variant refuses
    what this rule does not give it."""
    aligned = (y_ptr | uv_ptr | out_ptr) % 16 == 0
    if w % 16 == 0 and w <= 4096 and h < 65536 and aligned:
        return "vector"
    return "edge"


def nv12_to_rgb_plain(y, uv, swap_rb: bool, planar: bool, normalization: bool,
                      standard: int = 0):
    """The plain torch version (ops/color.py), on whatever device y is."""
    return color.nv12_to_rgb(y, uv, swap_rb=swap_rb, planar=planar,
                             normalization=normalization, standard=standard)


def output_shape(y_shape, planar: bool):
    *lead, h, w = y_shape
    return (*lead, 3, h, w) if planar else (*lead, h, w, 3)


def nv12_to_rgb(y, uv, swap_rb: bool, planar: bool, normalization: bool,
                standard: int = 0):
    """y [N,H,W] or [H,W] uint8, uv [N,H/2,W] or [H/2,W] uint8 ->
    [N,3,H,W]/[N,H,W,3] (or without N), uint8 or float32 (x/255).

    Calls the operator ``ts::nv12_to_rgb``: the dispatcher runs the
    kernel for CUDA planes and the plain version for CPU planes, so a
    program traced by ``torch.export`` on either device holds the op."""
    _library.on_one_device(y, uv)
    return _OP(y, uv, bool(swap_rb), bool(planar), bool(normalization),
               int(standard))


def _nv12_to_rgb_cuda(y, uv, swap_rb, planar, normalization, standard):
    """The kernel: checks the planes, picks the variant from the
    pointers, launches and counts."""
    _library.on_one_device(y, uv)
    if y.dtype != torch.uint8 or uv.dtype != torch.uint8:
        raise TypeError(f"NV12 planes must be uint8, got {y.dtype}/{uv.dtype}")
    if y.dim() not in (2, 3) or uv.dim() != y.dim():
        raise ValueError(f"expected [N,H,W] or [H,W] planes, got "
                         f"{tuple(y.shape)} and {tuple(uv.shape)}")
    *lead, h, w = y.shape
    n = lead[0] if lead else 1
    if h % 2 or w % 2 or tuple(uv.shape) != (*lead, h // 2, w):
        raise ValueError(f"NV12 needs even H, W and uv of shape "
                         f"{(*lead, h // 2, w)}; got y {tuple(y.shape)}, "
                         f"uv {tuple(uv.shape)}")
    if not (y.is_contiguous() and uv.is_contiguous()):
        raise ValueError("NV12 planes must be contiguous")
    if standard not in (0, 1, 2, 3):
        raise ValueError(f"colour standard {standard} must be resolved "
                         "(0..3) before the kernel")
    if n > 65535:
        raise ValueError(f"batch {n} exceeds the kernel's grid (65535)")
    out = _empty_out(y, planar, normalization)
    if out.numel() == 0:
        return out
    which = variant(h, w, y.data_ptr(), uv.data_ptr(), out.data_ptr())
    fn = _lib()[which]
    with kernel_device(y.device):
        rc = fn(y.data_ptr(), uv.data_ptr(), out.data_ptr(), n, h, w,
                int(swap_rb), int(planar), int(normalization), int(standard),
                torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{_ENTRY[which]} launch failed: cudaError {rc}")
    global launches
    launches += 1
    launches_by_variant[which] += 1
    return out


def _empty_out(y, planar, normalization):
    return y.new_empty(output_shape(y.shape, planar),
                       dtype=torch.float32 if normalization else torch.uint8)


_OP = _library.define(
    "nv12_to_rgb(Tensor y, Tensor uv, bool swap_rb, bool planar, "
    "bool normalization, int standard) -> Tensor",
    cuda=_nv12_to_rgb_cuda, cpu=nv12_to_rgb_plain,
    fake=lambda y, uv, swap_rb, planar, normalization, standard:
        _empty_out(y, planar, normalization))
