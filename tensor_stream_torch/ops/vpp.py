"""VPP: crop -> NV12-domain resize -> colour conversion -> tensor shaping.

Port of the JAX package's ``ops/vpp.py`` (reference:
src/VideoProcessor.cpp:94-166 and the tensor shape contract of
src/Wrappers/WrapperPython.cpp:315-343). PyTorch runs eagerly, so a
"built" VPP is a plain function over tensors with its index tables made
once; it runs on the device its input lies on.

On CUDA tensors, RGB24/BGR24 (planar or merged, after any crop and
resize) goes through the hand-written NV12 kernel (ops/nv12_rgb.py), and
BILINEAR, BICUBIC and AREA resizes through their kernels (ops/resize.py);
a crop is a strided view that the resize kernels read in place. The other
colour formats and NEAREST run torch ops, and every config on the CPU
runs the plain torch versions.

``build_vpp_clip_augment`` adds the training augmentation of
ops/augment.py, one CUDA graph a batch: after the crop and resize, one
operator converts and augments the NV12 planes
(``ts::nv12_clip_augment``).
"""
import dataclasses
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .._device import resolve_device
from ..enums import (ColorStandard, FourCC, Planes, ResizeType,
                     channels_by_fourcc)
from ..graphs import cuda_graph
from . import augment
from . import color as color_ops
from . import nv12_rgb
from .crop import crop_nv12
from .resize import make_resize_fn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class VPPConfig:
    """Static parameters of one conversion."""
    src_width: int
    src_height: int
    crop: tuple = (0, 0, 0, 0)  # (left, top, right, bottom); zeros = off
    width: int = 0              # resize target; 0 = native
    height: int = 0
    resize_type: ResizeType = ResizeType.NEAREST
    fourcc: FourCC = FourCC.RGB24
    planes: Planes = Planes.MERGED
    normalization: bool = False
    # YUV->RGB matrix; only RGB24/BGR24/HSV apply it.
    standard: ColorStandard = ColorStandard.BT601
    # Output dtype override: "" keeps the reference contract (uint8, or
    # float32 with normalization); "bfloat16"/"float16"/"float32" cast the
    # final tensor once, after the exact f32 math.
    dtype: str = ""

    def __post_init__(self):
        if self.dtype not in ("", *_DTYPES):
            raise ValueError(
                f"unsupported output dtype {self.dtype!r}; expected "
                "'bfloat16', 'float16', 'float32' or '' (contract default)")
        # HSV output is always normalized float (VideoProcessor.h:39-52).
        if self.fourcc == FourCC.HSV:
            object.__setattr__(self, "normalization", True)
        # NV12-domain resize interleaves UV at half the target width, so
        # odd targets would corrupt chroma; fail loudly.
        if (self.width or self.height) and (self.width % 2 or
                                            self.height % 2):
            raise ValueError("resize target must have even width/height "
                             f"(got {self.width}x{self.height})")

    def output_size(self):
        """Final (width, height) after crop/resize defaulting
        (reference: VideoProcessor.cpp:106-135)."""
        w, h = self.src_width, self.src_height
        cw = self.crop[2] - self.crop[0]
        ch = self.crop[3] - self.crop[1]
        if 0 < cw < self.src_width and 0 < ch < self.src_height:
            w, h = cw, ch
        if self.width and self.height:
            w, h = self.width, self.height
        return w, h

    def output_shape(self):
        """Tensor shape contract (WrapperPython.cpp:318-341)."""
        w, h = self.output_size()
        c = channels_by_fourcc(self.fourcc)
        if self.fourcc in (FourCC.RGB24, FourCC.BGR24):
            return (3, h, w) if self.planes == Planes.PLANAR else (h, w, 3)
        if self.fourcc in (FourCC.YUV444, FourCC.HSV):
            return (h, w, 3)
        return (1, int(h * c), w)

    def output_dtype(self):
        if self.dtype:
            return _DTYPES[self.dtype]
        return torch.float32 if self.normalization else torch.uint8


def make_nv12_stage_fn(cfg: VPPConfig):
    """The VPP's NV12 stages for `cfg`: (y [..., H, W], uv [..., H/2, W])
    -> the planes after the crop (a strided view) and the NV12-domain
    resize, at cfg.output_size()."""
    cw = cfg.crop[2] - cfg.crop[0]
    ch = cfg.crop[3] - cfg.crop[1]
    do_crop = 0 < cw < cfg.src_width and 0 < ch < cfg.src_height
    cur_w, cur_h = (cw, ch) if do_crop else (cfg.src_width, cfg.src_height)
    do_resize = bool(cfg.width and cfg.height and
                     (cfg.width != cur_w or cfg.height != cur_h))
    if cfg.fourcc in (FourCC.RGB24, FourCC.BGR24, FourCC.HSV) and \
            cfg.standard is ColorStandard.AUTO:
        raise ValueError("ColorStandard.AUTO must be resolved from the "
                         "stream before the VPP is built")
    resize = (make_resize_fn(cur_w, cur_h, cfg.width, cfg.height,
                             cfg.resize_type) if do_resize else None)

    def stage_fn(y, uv):
        if do_crop:
            y, uv = crop_nv12(y, uv, *cfg.crop)
        if do_resize:
            y, uv = resize(y, uv)
        return y, uv

    return stage_fn


def make_vpp_fn(cfg: VPPConfig):
    """The NV12 -> tensor conversion for `cfg`: (y [..., H, W],
    uv [..., H/2, W]) uint8 -> [..., *cfg.output_shape()], on y's device."""
    stage_fn = make_nv12_stage_fn(cfg)
    out_w, out_h = cfg.output_size()
    four = cfg.fourcc
    rgb = four in (FourCC.RGB24, FourCC.BGR24)
    swap_rb = four == FourCC.BGR24
    planar = cfg.planes == Planes.PLANAR

    def base_fn(y, uv):
        y, uv = stage_fn(y, uv)
        if rgb:
            # The NV12 kernel for CUDA tensors (it takes contiguous planes:
            # a crop that is not resized is copied first), plain on the CPU.
            return nv12_rgb.nv12_to_rgb(y.contiguous(), uv.contiguous(),
                                        swap_rb, planar, cfg.normalization,
                                        cfg.standard.value)
        if four == FourCC.Y800:
            return color_ops.nv12_to_y800(y, cfg.normalization)
        if four == FourCC.UYVY:
            out = color_ops.nv12_to_uyvy(y, uv, cfg.normalization)
            return out.reshape(*out.shape[:-2], 1, out_h * 2, out_w)
        if four == FourCC.YUV444:
            uyvy = color_ops.nv12_to_uyvy(y, uv, normalization=False,
                                          as_float=cfg.normalization)
            return color_ops.uyvy_to_yuv444(uyvy, out_w, out_h,
                                            cfg.normalization,
                                            float_mode=cfg.normalization)
        if four == FourCC.NV12:
            return color_ops.nv12_merge(y, uv, cfg.normalization)
        if four == FourCC.HSV:
            return color_ops.nv12_to_hsv(y, uv, standard=cfg.standard.value)
        raise ValueError(f"unsupported FourCC {four}")

    if not cfg.dtype:
        return base_fn
    out_dtype = _DTYPES[cfg.dtype]
    return lambda y, uv: base_fn(y, uv).to(out_dtype)


def _on(device, t):
    return t if t.device == device else t.to(device, non_blocking=True)


@lru_cache(maxsize=256)
def _vpp(cfg: VPPConfig, device: torch.device):
    fn = make_vpp_fn(cfg)
    return lambda y, uv: fn(_on(device, y), _on(device, uv))


def build_vpp(cfg: VPPConfig, device=None, device_index: int = 0):
    """Single-frame VPP: (y [H,W] u8, uv [H/2,W] u8) -> tensor on `device`
    (default ``cuda:<device_index>``)."""
    return _vpp(cfg, resolve_device(device, device_index))


def build_vpp_batched(cfg: VPPConfig, device=None, device_index: int = 0):
    """Batched VPP: (y [N,H,W], uv [N,H/2,W]) -> [N, ...] on `device`."""
    return _vpp(cfg, resolve_device(device, device_index))


def _convert_flat(cfg: VPPConfig, batch: int, post_fn):
    fn = make_vpp_fn(cfg)
    h, w = cfg.src_height, cfg.src_width
    y_size = batch * h * w

    def convert(flat):
        ys = flat[:y_size].view(batch, h, w)
        uvs = flat[y_size:].view(batch, h // 2, w)
        out = fn(ys, uvs)
        return post_fn(out) if post_fn is not None else out

    return convert


@lru_cache(maxsize=64)
def _vpp_flat(cfg: VPPConfig, batch: int, device: torch.device):
    convert = _convert_flat(cfg, batch, None)
    return lambda flat: convert(_on(device, flat))


def build_vpp_batched_flat(cfg: VPPConfig, batch: int, device=None,
                           post_fn=None, device_index: int = 0):
    """Batched VPP over ONE flat NV12 staging buffer.

    Takes a (batch*H*W*3/2,) uint8 tensor laid out as all Y planes then
    all UV planes and returns [batch, ...] tensors; the planes are views
    of the buffer, so a batch costs one host-to-device copy.

    `post_fn` ([batch, ...] in, anything out) runs right after the
    conversion. On CUDA the conversion and `post_fn` are one CUDA graph
    (graphs.cuda_graph: a warm-up call, then a capture, then replays),
    the counterpart of the JAX package tracing `post_fn` into the VPP
    program: one dispatch a batch. The graph reads its own static device
    buffer: the copy to the device stays outside it, so each replay reads
    the staging buffer the call was given. Each call builds a new graph,
    which lives as long as the returned function."""
    device = resolve_device(device, device_index)
    if post_fn is None:
        return _vpp_flat(cfg, int(batch), device)
    graphed = cuda_graph(_convert_flat(cfg, int(batch), post_fn))

    def flat_fn(flat):
        return graphed(_on(device, flat))

    flat_fn.graphed = graphed
    return flat_fn


def build_vpp_clip_augment(cfg: VPPConfig, aug, clips: int, clip_len: int,
                           aug_seed: int, device=None, device_index: int = 0):
    """Batched VPP + per-clip training augmentation over one flat staging
    buffer (the layout of ``build_vpp_batched_flat``).

    Returns ``fn(flat, ids) -> [clips, clip_len, ...]``, where `ids` is an
    integer [clips, 2] array of (epoch, clip identity). The VPP runs
    without the dtype override, the augmentation (ops/augment.py) on its
    contract values, and one final cast gives cfg's dtype. A config that
    changes pixels runs the crop and resize, then one operator,
    ``ts::nv12_clip_augment`` (``augment.make_nv12_clip_augment_fn``),
    which converts each pixel that the augmentation reads as the NV12
    kernel would: no RGB frames are written between the two. The
    identity config is the plain VPP and its cast. Each clip's
    parameters are drawn on the host from (aug_seed, epoch, identity)
    (``augment.sample_clip_params``), so a resumed loader replays the same
    bytes for the same clips. On CUDA the VPP and the augmentation are one
    CUDA graph; the flat buffer and the parameters are its inputs, copied
    into its static buffers before each replay (graphs.cuda_graph). Each
    call builds a new graph, which lives as long as the returned
    function."""
    if cfg.fourcc not in (FourCC.RGB24, FourCC.BGR24):
        raise ValueError("augment requires an RGB24/BGR24 pixel format "
                         f"(got {cfg.fourcc}) — the transforms are "
                         "defined on RGB model inputs")
    if aug.mean and cfg.output_dtype() == torch.uint8:
        raise ValueError("mean/std normalization needs a float tensor; "
                         "pass normalization=True or dtype='bfloat16'/"
                         "'float32'")
    device = resolve_device(device, device_index)
    h, w = cfg.src_height, cfg.src_width
    out_w, out_h = cfg.output_size()
    planar = cfg.planes == Planes.PLANAR
    batch = clips * clip_len
    y_size = batch * h * w
    if augment.op_flags(aug):
        stage_fn = make_nv12_stage_fn(cfg)
        aug_fn = augment.make_nv12_clip_augment_fn(
            aug, out_h, out_w, planar, swap_rb=(cfg.fourcc == FourCC.BGR24),
            normalization=cfg.normalization, standard=cfg.standard.value,
            out_dtype=cfg.output_dtype())

        def convert(flat, params):
            y, uv = stage_fn(flat[:y_size].view(batch, h, w),
                             flat[y_size:].view(batch, h // 2, w))
            # The kernel takes contiguous planes: a crop that is not
            # resized is copied first.
            return aug_fn(y.contiguous(), uv.contiguous(), params)
    else:
        fn = make_vpp_fn(dataclasses.replace(cfg, dtype=""))
        clip_fn = augment.make_clip_augment_fn(
            aug, out_h, out_w, planar=planar,
            out_dtype=cfg.output_dtype())

        def convert(flat, params):
            t = fn(flat[:y_size].view(batch, h, w),
                   flat[y_size:].view(batch, h // 2, w))
            return clip_fn(t.reshape((clips, clip_len) + t.shape[1:]),
                           params)

    graphed = cuda_graph(convert)

    def flat_fn(flat, ids):
        params = torch.from_numpy(augment.sample_clip_params(
            aug, out_h, out_w, aug_seed, ids))
        return graphed(_on(device, flat), _on(device, params))

    flat_fn.graphed = graphed
    return flat_fn


def vpp_numpy(cfg: VPPConfig, y: np.ndarray, uv: np.ndarray,
              device=None) -> np.ndarray:
    """Runs the VPP on host arrays and returns a NumPy copy (bfloat16
    results come back as float32, which holds them exactly)."""
    out = build_vpp(cfg, device)(torch.from_numpy(np.ascontiguousarray(y)),
                                 torch.from_numpy(np.ascontiguousarray(uv)))
    out = out.cpu()
    if out.dtype == torch.bfloat16:
        out = out.to(torch.float32)
    return out.numpy()
