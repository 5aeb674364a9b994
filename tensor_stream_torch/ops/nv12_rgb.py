"""Full-frame NV12 -> RGB24/BGR24: the wrapper of the CUDA kernel
``csrc/nv12_rgb.cu`` and its plain torch version. The kernel replaces
the JAX package's Pallas TPU kernel
``ops/pallas_color.py::_nv12_rgb_kernel``.

``nv12_to_rgb`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no fallback between the two. Each
launch adds one to ``launches``, so a run can show that its main path
went through the kernel.
"""
import ctypes

import torch

from .. import _build
from . import color

launches = 0

_SIG = None


def _lib():
    global _SIG
    lib = _build.load("nv12_rgb")
    if _SIG is None:
        v, i = ctypes.c_void_p, ctypes.c_int
        lib.ts_nv12_rgb.restype = i
        lib.ts_nv12_rgb.argtypes = [v, v, v, i, i, i, i, i, i, i, v]
        _SIG = lib.ts_nv12_rgb
    return _SIG


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
    [N,3,H,W]/[N,H,W,3] (or without N), uint8 or float32 (x/255)."""
    if y.device.type == "cpu" and uv.device.type == "cpu":
        return nv12_to_rgb_plain(y, uv, swap_rb, planar, normalization,
                                 standard)
    if y.device.type != "cuda" or uv.device != y.device:
        raise ValueError(f"y on {y.device} and uv on {uv.device}: both must "
                         "be on one CUDA device (or both on the CPU)")
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
    out = torch.empty(output_shape(y.shape, planar),
                      dtype=torch.float32 if normalization else torch.uint8,
                      device=y.device)
    if out.numel() == 0:
        return out
    fn = _lib()
    with torch.cuda.device(y.device):
        rc = fn(y.data_ptr(), uv.data_ptr(), out.data_ptr(), n, h, w,
                int(bool(swap_rb)), int(bool(planar)),
                int(bool(normalization)), int(standard),
                torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ts_nv12_rgb launch failed: cudaError {rc}")
    global launches
    launches += 1
    return out
