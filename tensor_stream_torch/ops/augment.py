"""Training augmentations for clip and frame batches, on the device.

Port of the JAX package's ``ops/augment.py``. The semantics are the JAX
package's (torchvision ``RandomResizedCrop`` with a clamped rect and
bilinear half-pixel sampling, ``hflip`` folded into the sampling grid,
``ColorJitter`` factors with hue as a YIQ chroma rotation, applied in the
order brightness, contrast, saturation, hue, one clamp, then mean/std,
then ``RandomErasing`` of one rect a clip). One draw augments a whole
clip: all its frames share the transform. Contrast blends against the
mean gray of the whole clip.

The JAX package draws inside its jitted program from
``fold_in(fold_in(key(aug_seed), epoch), identity)``; the port cannot
reproduce ``jax.random``, so the transform is split in two:

- ``sample_clip_params`` draws each clip's parameters on the host with
  numpy ``default_rng([aug_seed, epoch, identity])`` into a float32
  [clips, K] array (the columns are ``PARAMS``). The same (aug_seed,
  epoch, identity) always gives the same parameters, so a resumed loader
  replays the same augmentation, and the device program reads no random
  state and nothing on the host (a CUDA graph can capture it).
- Two operators (``ops/_library.py``) apply given parameters, both
  through the hand-written kernels of ``csrc/clip_augment.cu`` on CUDA
  tensors (two passes with contrast, one without) and through the plain
  float32 torch ops on CPU tensors; there is no fallback between the two:

  - ``ts::clip_augment`` (``apply_clip_augment``, ``make_clip_augment_fn``,
    ``make_frame_augment_fn``) takes a batch of clips as a tensor, u8, f32
    or any other real dtype (cast to f32 first); its plain version is
    ``clip_augment_plain``; ``launches`` and ``launches_by_pass`` count
    its kernels;
  - ``ts::nv12_clip_augment`` (``make_nv12_clip_augment_fn``, the route of
    ``ops/vpp.py::build_vpp_clip_augment`` and so of every augmenting
    loader) takes the VPP's NV12 planes, after its crop and resize, and
    converts each pixel that a tap reads as ``ops/nv12_rgb.py`` converts
    it, so an augmented batch never holds the RGB frames; its plain
    version is ``nv12_clip_augment_plain`` (``nv12_to_rgb_plain``, then
    ``clip_augment_plain``); ``nv12_launches``, ``nv12_launches_by_pass``
    and ``nv12_launches_by_mode`` count its kernels.

The distributions and clamps are the JAX package's (its ``_sample_rect``,
``_factor`` and the erase draw); only the random bits differ.
"""
import ctypes
import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from .._device import kernel_device
from . import _library, nv12_rgb

# ITU-R BT.601 luma weights (torchvision rgb_to_grayscale).
_GRAY_RGB = (0.299, 0.587, 0.114)
# RGB->YIQ / YIQ->RGB (NTSC), for the hue rotation.
_RGB2YIQ = np.array([[0.299, 0.587, 0.114],
                     [0.595716, -0.274453, -0.321263],
                     [0.211456, -0.522591, 0.311135]], np.float32)
_YIQ2RGB = np.linalg.inv(_RGB2YIQ).astype(np.float32)

# The columns of a parameter row: the crop rect (y0, x0, h, w) in source
# pixels, the flip (0 or 1), the brightness, contrast and saturation
# factors, the hue angle in radians, the erase flag (0 or 1) and the erase
# rect (y0, x0, h, w) in output pixels.
PARAMS = ("y0", "x0", "rect_h", "rect_w", "flip", "brightness", "contrast",
          "saturation", "theta", "erase", "erase_y0", "erase_x0", "erase_h",
          "erase_w")
_COL = {name: k for k, name in enumerate(PARAMS)}


@dataclass(frozen=True)
class AugmentConfig:
    """Static augmentation parameters, the JAX package's fields.

    All fields default to "off": the default config is the identity."""
    # Spatial target. 0/0 = keep the source size (then only hflip and
    # the photometric ops apply).
    width: int = 0
    height: int = 0
    # RandomResizedCrop: crop area fraction range and aspect ratio (w/h)
    # range. (1,1)/(1,1) = deterministic full-frame resize.
    scale: tuple = (1.0, 1.0)
    ratio: tuple = (1.0, 1.0)
    # Probability of a horizontal flip.
    hflip: float = 0.0
    # ColorJitter half-ranges (0 = off): factor ~ U[max(0,1-x), 1+x].
    brightness: float = 0.0
    contrast: float = 0.0
    saturation: float = 0.0
    # Hue delta half-range in turns, applied as a YIQ chroma rotation.
    hue: float = 0.0
    # Per-channel normalization (in the tensor's value scale), applied
    # after the final clamp. Both empty or both length-3.
    mean: tuple = ()
    std: tuple = ()
    # RandomErasing, applied last (after mean/std; zero fill): probability,
    # area-fraction range, aspect (w/h) range; one rect a clip.
    erase: float = 0.0
    erase_scale: tuple = (0.02, 0.33)
    erase_ratio: tuple = (0.3, 3.3)

    def __post_init__(self):
        if (self.width > 0) != (self.height > 0):
            raise ValueError("width/height must be set together "
                             f"(got {self.width}x{self.height})")
        for name, rng, lo_min in (("scale", self.scale, 0.0),
                                  ("ratio", self.ratio, 0.0)):
            if len(rng) != 2 or not (lo_min < rng[0] <= rng[1]):
                raise ValueError(f"{name} must be (lo, hi) with "
                                 f"0 < lo <= hi, got {rng}")
        if self.scale[1] > 1.0:
            raise ValueError(f"scale upper bound must be <= 1.0 "
                             f"(a crop cannot exceed the frame), "
                             f"got {self.scale}")
        if self.samples_rect and not self.width:
            raise ValueError("scale/ratio sampling needs a static "
                             "output size; set width/height")
        if not 0.0 <= self.hflip <= 1.0:
            raise ValueError(f"hflip must be a probability, got "
                             f"{self.hflip}")
        for name, v in (("brightness", self.brightness),
                        ("contrast", self.contrast),
                        ("saturation", self.saturation)):
            if v < 0:
                raise ValueError(f"{name} must be >= 0, got {v}")
        if not 0.0 <= self.hue <= 0.5:
            raise ValueError(f"hue must be in [0, 0.5] turns, got "
                             f"{self.hue}")
        if not 0.0 <= self.erase <= 1.0:
            raise ValueError(f"erase must be a probability, got "
                             f"{self.erase}")
        es, er = self.erase_scale, self.erase_ratio
        if len(es) != 2 or not (0.0 < es[0] <= es[1] <= 1.0):
            raise ValueError(f"erase_scale must be (lo, hi) within "
                             f"(0, 1], got {es}")
        if len(er) != 2 or not (0.0 < er[0] <= er[1]):
            raise ValueError(f"erase_ratio must be (lo, hi) with "
                             f"0 < lo <= hi, got {er}")
        if bool(self.mean) != bool(self.std):
            raise ValueError("mean/std must be set together")
        if self.mean and (len(self.mean) != 3 or len(self.std) != 3
                          or any(s == 0 for s in self.std)):
            raise ValueError("mean/std must be length-3 with nonzero "
                             f"std, got {self.mean}/{self.std}")

    @property
    def samples_rect(self):
        return self.scale != (1.0, 1.0) or self.ratio != (1.0, 1.0)

    @property
    def identity(self):
        """True when this config never changes any pixel."""
        return (not self.width and not self.samples_rect and self.hflip == 0
                and self.brightness == 0 and self.contrast == 0
                and self.saturation == 0 and self.hue == 0
                and not self.mean and self.erase == 0)

    def output_size(self, src_w, src_h):
        return (self.width or src_w, self.height or src_h)


def _seed_word(x):
    return int(x) % (1 << 64)


def _draw(cfg, src_h, src_w, rng):
    """One clip's parameter row (float64) from 14 uniforms drawn in a fixed
    order, whatever the config, so a field that is off changes no other."""
    u = rng.random(14)
    out_w, out_h = cfg.output_size(src_w, src_h)
    row = np.zeros(len(PARAMS))
    row[_COL["rect_h"]], row[_COL["rect_w"]] = src_h, src_w
    if cfg.width and cfg.samples_rect:
        area = src_h * src_w * (cfg.scale[0] +
                                u[0] * (cfg.scale[1] - cfg.scale[0]))
        lo, hi = math.log(cfg.ratio[0]), math.log(cfg.ratio[1])
        r = math.exp(lo + u[1] * (hi - lo))
        w = min(max(math.sqrt(area * r), 1.0), float(src_w))
        h = min(max(math.sqrt(area / r), 1.0), float(src_h))
        row[_COL["x0"]] = u[2] * (src_w - w)
        row[_COL["y0"]] = u[3] * (src_h - h)
        row[_COL["rect_h"]], row[_COL["rect_w"]] = h, w
    row[_COL["flip"]] = float(u[4] < cfg.hflip)
    for k, name in ((5, "brightness"), (6, "contrast"), (7, "saturation")):
        half = getattr(cfg, name)
        lo = max(0.0, 1.0 - half)
        row[_COL[name]] = lo + u[k] * (1.0 + half - lo) if half > 0 else 1.0
    row[_COL["theta"]] = 2.0 * math.pi * cfg.hue * (2.0 * u[8] - 1.0)
    if cfg.erase > 0:
        area = out_h * out_w * (cfg.erase_scale[0] + u[10] *
                                (cfg.erase_scale[1] - cfg.erase_scale[0]))
        lo, hi = math.log(cfg.erase_ratio[0]), math.log(cfg.erase_ratio[1])
        r = math.exp(lo + u[11] * (hi - lo))
        ew = min(max(math.sqrt(area * r), 1.0), float(out_w))
        eh = min(max(math.sqrt(area / r), 1.0), float(out_h))
        row[_COL["erase"]] = float(u[9] < cfg.erase)
        row[_COL["erase_y0"]] = u[12] * (out_h - eh)
        row[_COL["erase_x0"]] = u[13] * (out_w - ew)
        row[_COL["erase_h"]], row[_COL["erase_w"]] = eh, ew
    return row


def sample_clip_params(cfg: AugmentConfig, src_h: int, src_w: int,
                       aug_seed: int, ids) -> np.ndarray:
    """float32 [clips, len(PARAMS)]: one row a clip, drawn from
    ``default_rng([aug_seed, epoch, identity])`` for each (epoch, identity)
    row of `ids` ([clips, 2] integers). `src_h`/`src_w` are the size of
    the frames the transform receives."""
    ids = np.asarray(ids, np.int64).reshape(-1, 2)
    rows = [_draw(cfg, src_h, src_w, np.random.default_rng(
        [_seed_word(aug_seed), _seed_word(e), _seed_word(i)]))
        for e, i in ids]
    return np.asarray(rows, np.float64).reshape(-1, len(PARAMS)).astype(
        np.float32)


def _grid_1d(n_out, start, extent, flip=None):
    """Half-pixel bilinear sampling coordinates of `n_out` points over
    [start, start+extent) for each clip ([B, 1] each -> [B, n_out]); where
    `flip` ([B, 1] bool) is set, the direction inside the rect reverses."""
    j = torch.arange(n_out, dtype=torch.float32, device=extent.device)
    u = (j + 0.5)[None, :] * (extent / n_out)
    if flip is not None:
        u = torch.where(flip, extent - u, u)
    return start + u - 0.5


def _gather_lerp(x, coords, axis, size):
    """Bilinear 1-D resample of `x` ([B, ...]) along `axis` at each clip's
    float coordinates ([B, n]), edge-replicated: both neighbour indices
    clamp independently from the unclamped floor."""
    lo = torch.floor(coords)
    t = coords - lo
    lo = lo.to(torch.int64)
    i0 = lo.clamp(0, size - 1)
    i1 = (lo + 1).clamp(0, size - 1)
    shape = [x.shape[0]] + [1] * (x.dim() - 1)
    shape[axis] = coords.shape[1]
    full = list(x.shape)
    full[axis] = coords.shape[1]
    a = torch.gather(x, axis, i0.view(shape).expand(full))
    b = torch.gather(x, axis, i1.view(shape).expand(full))
    t = t.view(shape)
    return a * (1.0 - t) + b * t


def _dot3(t, w):
    return (t[..., 0] * float(w[0]) + t[..., 1] * float(w[1])
            + t[..., 2] * float(w[2]))


def _per_clip(params, name, ndim):
    """Column `name` of [B, K] params, shaped to broadcast over [B, ...]."""
    return params[:, _COL[name]].reshape((-1,) + (1,) * (ndim - 1))


OPS = ("resize", "rect", "flip", "brightness", "contrast", "saturation",
       "hue", "normalize", "erase")
OP_BITS = {name: 1 << k for k, name in enumerate(OPS)}


def op_flags(cfg: AugmentConfig) -> int:
    """The operations `cfg` applies, as a mask of ``OPS`` bits: "resize" a
    static output size, "rect" a sampled crop rect, "flip" a drawn flip,
    each jitter, "normalize" mean/std, "erase" RandomErasing. 0 for the
    identity."""
    on = (bool(cfg.width), cfg.samples_rect, cfg.hflip > 0,
          cfg.brightness > 0, cfg.contrast > 0, cfg.saturation > 0,
          cfg.hue > 0, bool(cfg.mean), cfg.erase > 0)
    return sum(OP_BITS[name] for name, flag in zip(OPS, on) if flag)


def channel_mixes(bgr: bool):
    """(gray weights [3], RGB->YIQ [3, 3], YIQ->RGB [3, 3]) float32 in the
    tensor's channel order: BGR permutes the gray weights, the RGB->YIQ
    columns and the YIQ->RGB rows."""
    gray_w = np.asarray(_GRAY_RGB, np.float32)
    yiq, yiq_inv = _RGB2YIQ, _YIQ2RGB
    if bgr:
        gray_w = gray_w[::-1].copy()
        yiq = yiq[:, ::-1].copy()
        yiq_inv = yiq_inv[::-1, :].copy()
    return gray_w, yiq, yiq_inv


def _cast(x, dt):
    if dt == torch.uint8:
        return torch.round(x).clamp(0.0, 255.0).to(torch.uint8)
    return x.to(dt)


@functools.lru_cache(maxsize=64)
def _plain_constants(device: str, src_h: int, src_w: int, mean: tuple,
                     std: tuple):
    """(mean, std, the full-frame rect) as float32 tensors on `device`,
    made once per device and config on the first (eager) call, so that a
    CUDA graph's capture of the plain version copies nothing from the
    host."""
    return (torch.tensor(mean, dtype=torch.float32, device=device),
            torch.tensor(std, dtype=torch.float32, device=device),
            torch.tensor([0.0, 0.0, float(src_h), float(src_w)],
                         dtype=torch.float32, device=device))


def clip_augment_plain(clips, params, planar: bool, out_h: int, out_w: int,
                       ops: int, mean, std, unit: float, bgr: bool,
                       out_dtype):
    """The plain torch version of ``ts::clip_augment``, on whatever device
    the clips lie: `ops` (``op_flags``) applied with the per-clip
    `params` to ``clips`` ([B, T, ...], frames of any size; the output
    frames are out_h x out_w), math in float32, cast to `out_dtype`."""
    on = {name: bool(ops & bit) for name, bit in OP_BITS.items()}
    h_axis, w_axis, c_axis = (3, 4, 2) if planar else (2, 3, 4)
    src_h, src_w = clips.shape[h_axis], clips.shape[w_axis]
    gray_w, yiq, yiq_inv = channel_mixes(bgr)
    spatial = on["resize"] or on["flip"]
    n_jitter = sum(on[k] for k in ("brightness", "contrast", "saturation",
                                   "hue"))
    x = clips.to(torch.float32)
    p = params.to(torch.float32)
    consts = _plain_constants(str(x.device), src_h, src_w, tuple(mean),
                              tuple(std))
    if spatial:
        if on["rect"]:
            rect = p[:, :4]
        else:
            rect = consts[2].expand(p.shape[0], 4)
        y0, x0, rh, rw = (rect[:, k:k + 1] for k in range(4))
        flip = (p[:, _COL["flip"]:_COL["flip"] + 1] > 0.5
                if on["flip"] else None)
        ys = _grid_1d(out_h, y0, rh)
        xs = _grid_1d(out_w, x0, rw, flip)
        x = _gather_lerp(x, ys, h_axis, src_h)
        x = _gather_lerp(x, xs, w_axis, src_w)
    if n_jitter or on["normalize"]:
        x = torch.movedim(x, c_axis, -1)  # [..., 3] for channel math
        nd = x.dim()
        # Channel mixes are written elementwise in float32, as the JAX
        # package writes them.
        if on["brightness"]:
            x = x * _per_clip(p, "brightness", nd)
        if on["contrast"]:
            m = _dot3(x, gray_w).flatten(1).mean(dim=1)
            m = m.reshape((-1,) + (1,) * (nd - 1))
            x = (x - m) * _per_clip(p, "contrast", nd) + m
        if on["saturation"]:
            g = _dot3(x, gray_w)[..., None]
            x = g + (x - g) * _per_clip(p, "saturation", nd)
        if on["hue"]:
            theta = _per_clip(p, "theta", nd - 1)
            c, s = torch.cos(theta), torch.sin(theta)
            lum = _dot3(x, yiq[0])
            i0, q0 = _dot3(x, yiq[1]), _dot3(x, yiq[2])
            i1 = c * i0 - s * q0
            q1 = s * i0 + c * q0
            x = torch.stack(
                [lum * float(yiq_inv[ch, 0]) + i1 * float(yiq_inv[ch, 1])
                 + q1 * float(yiq_inv[ch, 2]) for ch in range(3)],
                dim=-1)
        if n_jitter:
            x = x.clamp(0.0, unit)
        if on["normalize"]:
            x = (x - consts[0]) / consts[1]
        x = torch.movedim(x, -1, c_axis)
    if on["erase"]:
        nd = x.dim()
        e = {k: p[:, _COL[k]:_COL[k] + 1] for k in (
            "erase_y0", "erase_x0", "erase_h", "erase_w")}
        rows = torch.arange(out_h, dtype=torch.float32, device=x.device)
        cols = torch.arange(out_w, dtype=torch.float32, device=x.device)
        in_y = (rows >= e["erase_y0"]) & (
            rows < e["erase_y0"] + e["erase_h"])
        in_x = (cols >= e["erase_x0"]) & (
            cols < e["erase_x0"] + e["erase_w"])
        shape_y = [x.shape[0]] + [1] * (nd - 1)
        shape_y[h_axis] = out_h
        shape_x = [x.shape[0]] + [1] * (nd - 1)
        shape_x[w_axis] = out_w
        do = _per_clip(p, "erase", nd) > 0.5
        inside = in_y.view(shape_y) & in_x.view(shape_x)
        x = torch.where(do & inside, 0.0, x)
    return _cast(x, out_dtype)


# ------------------------------------------------------------ the kernel

# Output dtypes the kernel writes, by its code (csrc/clip_augment.cu
# OutKind).
OUT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
             torch.uint8: 3}
SMEM = 227 * 1024  # shared memory a block can hold
MEAN_BLOCKS = 32  # pass 1's blocks a clip
PASSES = ("mean", "apply")

# How the NV12 kernel's pass 2 reads its source (``nv12_plan``): taps
# gathered from device memory, converting each, or the rows a block's taps
# touch staged in shared memory by TMA and converted once.
NV12_MODES = ("gather", "staged")

launches = 0
launches_by_pass = dict.fromkeys(PASSES, 0)
nv12_launches = 0
nv12_launches_by_pass = dict.fromkeys(PASSES, 0)
nv12_launches_by_mode = dict.fromkeys(NV12_MODES, 0)

_FNS = None


def reset_counts():
    global launches, nv12_launches
    launches = nv12_launches = 0
    for k in PASSES:
        launches_by_pass[k] = 0
        nv12_launches_by_pass[k] = 0
    for k in NV12_MODES:
        nv12_launches_by_mode[k] = 0


def _lib():
    global _FNS
    if _FNS is None:
        lib = _build.load("clip_augment")
        v = ctypes.c_void_p
        fns = {}
        for name, n_args in (("ts_clip_augment", 7),
                             ("ts_nv12_clip_augment", 9)):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [v] * n_args
            fns[name] = fn
        _FNS = fns
    return _FNS


def output_shape(shape, planar: bool, out_h: int, out_w: int):
    b, t = shape[:2]
    return (b, t, 3, out_h, out_w) if planar else (b, t, out_h, out_w, 3)


@functools.lru_cache(maxsize=64)
def pack_constants(mean, std, unit: float, bgr: bool) -> np.ndarray:
    """The kernel's Consts (csrc/clip_augment.cu), 28 float32: the gray
    weights, RGB->YIQ and YIQ->RGB (row-major), all in the tensor's
    channel order (``channel_mixes``), then mean, std and unit. `mean` and
    `std` are tuples. Read-only."""
    gray_w, yiq, yiq_inv = channel_mixes(bgr)
    out = np.concatenate([gray_w, yiq.reshape(-1), yiq_inv.reshape(-1),
                          np.asarray(mean, np.float32),
                          np.asarray(std, np.float32),
                          np.asarray([unit], np.float32)]).astype(np.float32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=256)
def launch_dims(shape, in_dtype, params_shape, planar: bool, out_h: int,
                out_w: int, ops: int, out_dtype) -> np.ndarray:
    """The kernel's dims (B, T, H, W, out H, out W, ops, planar, input u8,
    output kind, pass 1's blocks a clip) as int32, after checking what the
    kernel takes; raises on anything else. Read-only.

    Pass 1 (with contrast) holds the taps of every output row and column
    and the weights of every source row and column in shared memory."""
    if len(shape) != 5 or shape[2 if planar else 4] != 3:
        raise ValueError(f"clips {shape}: expected [B, T, 3, H, W] "
                         "(planar) or [B, T, H, W, 3] (merged)")
    if in_dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"the kernel reads uint8 or float32 clips, got "
                        f"{in_dtype}")
    if out_dtype not in OUT_TYPES:
        raise TypeError(f"the kernel writes {list(OUT_TYPES)}, not "
                        f"{out_dtype}")
    b, t = shape[:2]
    h, w = shape[3:5] if planar else shape[2:4]
    if tuple(params_shape) != (b, len(PARAMS)):
        raise ValueError(f"params {tuple(params_shape)}: expected "
                         f"({b}, {len(PARAMS)})")
    if not (ops & (OP_BITS["resize"] | OP_BITS["flip"])) and (out_h, out_w) != (
            h, w):
        raise ValueError(f"output {out_h}x{out_w} without a spatial op "
                         f"must be the frames' {h}x{w}")
    if not (0 < b <= 65535 and 0 < t <= 65535) or min(h, w, out_h,
                                                      out_w) < 1:
        raise ValueError(f"clips {shape} -> {out_h}x{out_w}: outside the "
                         "kernel's grid")
    if 3 * max(h * w, out_h * out_w) >= 2 ** 31 or t * h >= 2 ** 31:
        raise ValueError(f"frames of {h}x{w} -> {out_h}x{out_w} exceed the "
                         "kernel's 32-bit frame indexing")
    smem = (out_h + out_w) * 12 + (h + w) * 4
    if ops & OP_BITS["contrast"] and smem > SMEM:
        raise ValueError(f"frames of {h}x{w} -> {out_h}x{out_w}: the clip "
                         f"mean's tables take {smem} bytes, more than a "
                         f"block's {SMEM} of shared memory")
    dims = np.asarray([b, t, h, w, out_h, out_w, ops, int(planar),
                       int(in_dtype == torch.uint8), OUT_TYPES[out_dtype],
                       min(MEAN_BLOCKS, t * h)], np.int32)
    dims.flags.writeable = False
    return dims


def _empty_out(clips, planar, out_h, out_w, out_dtype):
    return clips.new_empty(output_shape(clips.shape, planar, out_h, out_w),
                           dtype=out_dtype)


def _clip_augment_cuda(clips, params, planar, out_h, out_w, ops, mean, std,
                       unit, bgr, out_dtype):
    """The kernel: casts clips of another dtype to float32 (the plain
    version's first op), checks, launches pass 1 (with contrast) and
    pass 2, and counts."""
    _library.on_one_device(clips, params, cuda=True)
    if clips.dtype not in (torch.uint8, torch.float32):
        clips = clips.to(torch.float32)
    params = params.to(torch.float32).contiguous()
    dims = launch_dims(tuple(clips.shape), clips.dtype, tuple(params.shape),
                       bool(planar), int(out_h), int(out_w), int(ops),
                       out_dtype)
    if not clips.is_contiguous():
        raise ValueError("the kernel reads contiguous clips")
    out = _empty_out(clips, planar, out_h, out_w, out_dtype)
    contrast = bool(ops & OP_BITS["contrast"])
    partials = (clips.new_empty(int(dims[0] * dims[10]),
                                dtype=torch.float32) if contrast else None)
    consts = pack_constants(tuple(mean), tuple(std), float(unit), bool(bgr))
    with kernel_device(clips.device):
        rc = _lib()["ts_clip_augment"](
            clips.data_ptr(), params.data_ptr(),
            partials.data_ptr() if contrast else None, out.data_ptr(),
            dims.ctypes.data, consts.ctypes.data,
            torch.cuda.current_stream(clips.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ts_clip_augment launch failed: cudaError {rc}")
    global launches
    launches += 1 + contrast
    launches_by_pass["mean"] += contrast
    launches_by_pass["apply"] += 1
    return out


def _clip_augment_cpu(clips, params, planar, out_h, out_w, ops, mean, std,
                      unit, bgr, out_dtype):
    # The plain version, its output in the fake's (contiguous) strides.
    return clip_augment_plain(clips, params, planar, out_h, out_w, ops,
                              mean, std, unit, bgr, out_dtype).contiguous()


_OP = _library.define(
    "clip_augment(Tensor clips, Tensor params, bool planar, int out_h, "
    "int out_w, int ops, float[] mean, float[] std, float unit, bool bgr, "
    "ScalarType out_dtype) -> Tensor",
    cuda=_clip_augment_cuda, cpu=_clip_augment_cpu,
    fake=lambda clips, params, planar, out_h, out_w, ops, mean, std, unit,
    bgr, out_dtype: _empty_out(clips, planar, out_h, out_w, out_dtype))


# ------------------------------------------------------ the NV12 kernel

# Dynamic shared memory a block of the NV12 pass 2 may take: the rest of
# SMEM holds its value table and barriers. A block takes NV12_RUN frames of
# a clip (csrc/clip_augment.cu kRun), each staged on its own.
NV12_SMEM = SMEM - 2048
NV12_RUN = 2


def nv12_frames(y_shape, uv_shape, params_shape):
    """(clips, frames a clip, H, W) of NV12 planes y [clips * T, H, W] and
    uv [clips * T, H/2, W] with parameter rows [clips, len(PARAMS)];
    raises on anything else."""
    if len(y_shape) != 3 or len(uv_shape) != 3:
        raise ValueError(f"expected y [N, H, W] and uv [N, H/2, W], got "
                         f"{tuple(y_shape)} and {tuple(uv_shape)}")
    n, h, w = y_shape
    if h % 2 or w % 2 or tuple(uv_shape) != (n, h // 2, w):
        raise ValueError(f"NV12 needs even H, W and uv of shape "
                         f"{(n, h // 2, w)}; got y {tuple(y_shape)}, uv "
                         f"{tuple(uv_shape)}")
    if len(params_shape) != 2 or params_shape[1] != len(PARAMS):
        raise ValueError(f"params {tuple(params_shape)}: expected "
                         f"(clips, {len(PARAMS)})")
    clips = params_shape[0]
    if clips < 1 or n % clips:
        raise ValueError(f"{n} frames do not split into {clips} clips")
    return clips, n // clips, h, w


@functools.lru_cache(maxsize=256)
def nv12_plan(h: int, w: int, out_h: int, out_w: int, ops: int,
              aligned: bool):
    """The launch plan of the NV12 kernel's pass 2 (csrc/clip_augment.cu
    Nv12ClipApply), as the dict of its fields.

    A warp takes 32 output columns by 4 rows at a time, a lane a column;
    a block has as many warps as cover whole rows of such chunks, up to 8
    (7 at 224 wide), and writes a band of output rows, two passes of its
    warps, of 2 frames of one clip. "staged" keeps a stage a frame of the
    rows the band's taps can touch (Y rows, then their UV rows: at most
    ceil((band - 1) * H / out H) + 3 Y rows, since a drawn rect is never
    taller than the frame) and those rows converted, 16 bytes a pixel;
    the band halves until they fit, down to one pass of the warps, or the
    plan gathers. Staging needs W % 16 == 0 and 16-byte aligned planes
    (`aligned`), as the 1-D bulk copies do; "gather" takes the rest."""
    chunks = -(-out_w // 32)
    warps = chunks * (8 // chunks) if chunks <= 8 else 8
    threads = 32 * warps
    rows_pass = 4 * max(1, warps // chunks)
    groups = -(-out_w // 4)
    spatial = bool(ops & (OP_BITS["resize"] | OP_BITS["flip"]))

    def fields(band, staged):
        rows = (min(h, -(-(band - 1) * h // out_h) + 3) if spatial
                else band)
        stage_y = rows * w if staged else 0
        stage_uv = min(h // 2, rows // 2 + 1) * w if staged else 0
        rgb = rows * w * 16 if staged else 0
        tables = -(-(3 * 4 * groups + 3 * (-(-band // 4) * 4)) * 4
                   // 128) * 128
        return {"mode": "staged" if staged else "gather", "band": band,
                "stage_y": stage_y, "stage_uv": stage_uv, "rgb": rgb,
                "threads": threads,
                "smem": tables + NV12_RUN * (stage_y + stage_uv) + rgb}

    least, band = min(rows_pass, out_h), min(2 * rows_pass, out_h)
    if w % 16 == 0 and aligned:
        b = band
        while fields(b, True)["smem"] > NV12_SMEM and b > least:
            b = max(least, b // 2)
        if fields(b, True)["smem"] <= NV12_SMEM:
            return fields(b, True)
    if fields(band, False)["smem"] > NV12_SMEM:
        raise ValueError(f"frames of {h}x{w} -> {out_h}x{out_w}: the "
                         "kernel's tap tables exceed a block's shared memory")
    return fields(band, False)


def nv12_output_shape(y_shape, params_shape, planar: bool, out_h: int,
                      out_w: int):
    clips = params_shape[0]
    return output_shape((clips, y_shape[0] // clips), planar, out_h, out_w)


def _empty_nv12_out(y, params, planar, out_h, out_w, out_dtype):
    return y.new_empty(nv12_output_shape(y.shape, params.shape, planar,
                                         out_h, out_w), dtype=out_dtype)


def nv12_clip_augment_plain(y, uv, params, swap_rb: bool, normalization: bool,
                            standard: int, planar: bool, out_h: int,
                            out_w: int, ops: int, mean, std, unit: float,
                            out_dtype):
    """The plain version of ``ts::nv12_clip_augment``: the NV12 conversion
    (``nv12_rgb.nv12_to_rgb_plain``) of the clips' frames, then
    ``clip_augment_plain`` with the R/B swap as its BGR order."""
    clips = params.shape[0]
    rgb = nv12_rgb.nv12_to_rgb_plain(y, uv, swap_rb, planar, normalization,
                                     standard)
    rgb = rgb.reshape((clips, rgb.shape[0] // clips) + tuple(rgb.shape[1:]))
    return clip_augment_plain(rgb, params, planar, out_h, out_w, ops, mean,
                              std, unit, swap_rb, out_dtype)


def _nv12_clip_augment_cuda(y, uv, params, swap_rb, normalization, standard,
                            planar, out_h, out_w, ops, mean, std, unit,
                            out_dtype):
    """The kernel: checks the planes and the device, plans (``nv12_plan``),
    launches pass 1 (with contrast) and pass 2, and counts."""
    if y.dtype != torch.uint8 or uv.dtype != torch.uint8:
        raise TypeError(f"NV12 planes must be uint8, got {y.dtype}/"
                        f"{uv.dtype}")
    clips, t, h, w = nv12_frames(y.shape, uv.shape, params.shape)
    if not (y.is_contiguous() and uv.is_contiguous()):
        raise ValueError("the kernel reads contiguous NV12 planes")
    if standard not in (0, 1, 2, 3):
        raise ValueError(f"colour standard {standard} must be resolved "
                         "(0..3) before the kernel")
    _library.on_one_device(y, uv, params, cuda=True)
    params = params.to(torch.float32).contiguous()
    # The augmentation's dims, on the values the NV12 kernel would write
    # (f32 x/255 with normalization, u8 without).
    value_dtype = torch.float32 if normalization else torch.uint8
    shape = (clips, t, 3, h, w) if planar else (clips, t, h, w, 3)
    dims = launch_dims(shape, value_dtype, tuple(params.shape), bool(planar),
                       int(out_h), int(out_w), int(ops), out_dtype)
    aligned = (y.data_ptr() | uv.data_ptr()) % 16 == 0
    plan = nv12_plan(h, w, int(out_h), int(out_w), int(ops), aligned)
    fields = np.asarray([int(swap_rb), int(standard), int(normalization),
                         plan["mode"] == "staged", plan["band"],
                         plan["stage_y"], plan["stage_uv"], plan["rgb"],
                         plan["threads"]], np.int32)
    out = _empty_nv12_out(y, params, planar, out_h, out_w, out_dtype)
    contrast = bool(ops & OP_BITS["contrast"])
    partials = (y.new_empty(int(dims[0] * dims[10]), dtype=torch.float32)
                if contrast else None)
    consts = pack_constants(tuple(mean), tuple(std), float(unit),
                            bool(swap_rb))
    with kernel_device(y.device):
        rc = _lib()["ts_nv12_clip_augment"](
            y.data_ptr(), uv.data_ptr(), params.data_ptr(),
            partials.data_ptr() if contrast else None, out.data_ptr(),
            dims.ctypes.data, fields.ctypes.data, consts.ctypes.data,
            torch.cuda.current_stream(y.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ts_nv12_clip_augment launch failed: cudaError "
                           f"{rc}")
    global nv12_launches
    nv12_launches += 1 + contrast
    nv12_launches_by_pass["mean"] += contrast
    nv12_launches_by_pass["apply"] += 1
    nv12_launches_by_mode[plan["mode"]] += 1
    return out


def _nv12_clip_augment_cpu(y, uv, params, swap_rb, normalization, standard,
                           planar, out_h, out_w, ops, mean, std, unit,
                           out_dtype):
    nv12_frames(y.shape, uv.shape, params.shape)
    return nv12_clip_augment_plain(
        y, uv, params, swap_rb, normalization, standard, planar, out_h,
        out_w, ops, mean, std, unit, out_dtype).contiguous()


_NV12_OP = _library.define(
    "nv12_clip_augment(Tensor y, Tensor uv, Tensor params, bool swap_rb, "
    "bool normalization, int standard, bool planar, int out_h, int out_w, "
    "int ops, float[] mean, float[] std, float unit, ScalarType out_dtype) "
    "-> Tensor",
    cuda=_nv12_clip_augment_cuda, cpu=_nv12_clip_augment_cpu,
    fake=lambda y, uv, params, swap_rb, normalization, standard, planar,
    out_h, out_w, ops, mean, std, unit, out_dtype: _empty_nv12_out(
        y, params, planar, out_h, out_w, out_dtype))


def make_nv12_clip_augment_fn(cfg: AugmentConfig, src_h: int, src_w: int,
                              planar: bool, swap_rb: bool,
                              normalization: bool, standard: int,
                              out_dtype=None):
    """``fn(y, uv, params) -> clips``: the NV12 conversion of
    ``ops/nv12_rgb.py`` (`swap_rb`, `normalization`, colour `standard`)
    and then `cfg`'s augmentation, in one operator.

    `y` [clips * T, src_h, src_w] and `uv` [clips * T, src_h/2, src_w]
    are uint8 planes, frame-major by clip, and `params` float32 [clips,
    len(PARAMS)] on the same device; the result is what
    ``make_clip_augment_fn(cfg, src_h, src_w, planar, unit, bgr=swap_rb,
    out_dtype)`` returns on the converted frames, with `unit` 1.0 with
    normalization and 255.0 without, and `out_dtype` by default the
    conversion's (float32 with normalization, else uint8). Calls
    ``ts::nv12_clip_augment``: on CUDA tensors the kernel of
    csrc/clip_augment.cu, on CPU tensors the plain version. `cfg` must
    change some pixel: the identity is the NV12 conversion alone."""
    ops = op_flags(cfg)
    if not ops:
        raise ValueError("the identity config needs no augmentation kernel: "
                         "convert the planes with ops/nv12_rgb.py")
    out_w, out_h = cfg.output_size(src_w, src_h)
    mean = [float(v) for v in cfg.mean or (0.0,) * 3]
    std = [float(v) for v in cfg.std or (1.0,) * 3]
    unit = 1.0 if normalization else 255.0
    dt = out_dtype if out_dtype is not None else (
        torch.float32 if normalization else torch.uint8)

    def fn(y, uv, params):
        if tuple(y.shape[1:]) != (src_h, src_w):
            raise ValueError(f"y {tuple(y.shape)}: expected frames of "
                             f"{src_h}x{src_w}")
        _library.on_one_device(y, uv, params)
        return _NV12_OP(y, uv, params, bool(swap_rb), bool(normalization),
                        int(standard), bool(planar), out_h, out_w, ops, mean,
                        std, unit, dt)

    return fn


def make_clip_augment_fn(cfg: AugmentConfig, src_h: int, src_w: int,
                         planar: bool, unit: float = 1.0, bgr: bool = False,
                         out_dtype=None):
    """``fn(clips, params) -> clips`` for a batch of clips.

    `clips` is ``[B, T, 3, H, W]`` (planar) or ``[B, T, H, W, 3]``
    (merged) in any real dtype, `params` float32 ``[B, len(PARAMS)]`` on
    the same device (``sample_clip_params``). Math runs in float32 and
    the result is cast to `out_dtype` (default: the input dtype; uint8
    gets round and clamp). `unit` is the value scale (1.0 for normalized
    tensors, 255.0 for u8-valued ones).

    Calls the operator ``ts::clip_augment``: on CUDA tensors the kernel
    of csrc/clip_augment.cu, on CPU tensors the plain version. The
    identity config (``AugmentConfig()``) is the cast alone and calls
    nothing."""
    h_axis, w_axis = (3, 4) if planar else (2, 3)
    out_w, out_h = cfg.output_size(src_w, src_h)
    ops = op_flags(cfg)
    mean = [float(v) for v in cfg.mean or (0.0,) * 3]
    std = [float(v) for v in cfg.std or (1.0,) * 3]

    def fn(clips, params):
        if (clips.shape[h_axis], clips.shape[w_axis]) != (src_h, src_w):
            raise ValueError(f"clips {tuple(clips.shape)}: expected frames "
                             f"of {src_h}x{src_w}")
        dt = out_dtype if out_dtype is not None else clips.dtype
        if not ops:
            return _cast(clips.to(torch.float32), dt)
        _library.on_one_device(clips, params)
        return _OP(clips, params, bool(planar), out_h, out_w, ops, mean, std,
                   float(unit), bool(bgr), dt)

    return fn


def apply_clip_augment(cfg: AugmentConfig, clips, params, planar: bool,
                       unit: float = 1.0, bgr: bool = False, out_dtype=None):
    """Applies `cfg` with per-clip `params` to ``clips`` ([B, T, ...])."""
    h_axis = 3 if planar else 2
    src_h, src_w = clips.shape[h_axis], clips.shape[h_axis + 1]
    return make_clip_augment_fn(cfg, src_h, src_w, planar, unit, bgr,
                                out_dtype)(clips, params)


def make_frame_augment_fn(cfg: AugmentConfig, src_h: int, src_w: int,
                          planar: bool, unit: float = 1.0, bgr: bool = False,
                          out_dtype=None):
    """Frame variant: ``fn(frames [B, ...], params [B, K])``, each frame a
    clip of length 1."""
    clip_fn = make_clip_augment_fn(cfg, src_h, src_w, planar, unit, bgr,
                                   out_dtype)

    def fn(frames, params):
        return clip_fn(frames[:, None], params)[:, 0]

    return fn
