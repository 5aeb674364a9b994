"""NV12 colour conversions in plain torch: RGB24/BGR24, Y800, UYVY,
YUV444, NV12-merge, HSV.

Port of the JAX package's ``ops/color.py`` (reference:
src/ColorConversion.cu:6-278). Every multiply and add is its own torch
op, in the source order of the reference, so each rounds once and
nothing is contracted into an FMA: the results equal the native host
converter (csrc/vpp_convert.cpp, built -ffp-contract=off) byte for byte.

Functions take tightly packed planes with any leading batch dims:
y [..., H, W] uint8 and uv [..., H/2, W] uint8 (interleaved U,V).
"""
import numpy as np
import torch

# BT.601 constants, the exact float32 values the reference uses
# (src/ColorConversion.cu:23-35).
_Y_COEF = np.float32(1.163999557)
_RV = np.float32(1.5959997177)
_BU = np.float32(2.017999649)
_GV = np.float32(-0.812999725)
_GU = np.float32(-0.390999794)

# BT.709 limited range (Kr=0.2126, Kb=0.0722, scaled by 255/224).
_RV709 = np.float32(2 * (1 - 0.2126) * 255 / 224)
_BU709 = np.float32(2 * (1 - 0.0722) * 255 / 224)
_GV709 = np.float32(-(2 * (1 - 0.2126) * 0.2126 / 0.7152) * 255 / 224)
_GU709 = np.float32(-(2 * (1 - 0.0722) * 0.0722 / 0.7152) * 255 / 224)

# Full-range (PC/JPEG swing): Y maps 0..255 directly and the chroma
# coefficients drop the 255/224 excursion scale.
_RV601F = np.float32(2 * (1 - 0.299))
_BU601F = np.float32(2 * (1 - 0.114))
_GV601F = np.float32(-(2 * (1 - 0.299) * 0.299 / 0.587))
_GU601F = np.float32(-(2 * (1 - 0.114) * 0.114 / 0.587))
_RV709F = np.float32(2 * (1 - 0.2126))
_BU709F = np.float32(2 * (1 - 0.0722))
_GV709F = np.float32(-(2 * (1 - 0.2126) * 0.2126 / 0.7152))
_GU709F = np.float32(-(2 * (1 - 0.0722) * 0.0722 / 0.7152))

_ONE = np.float32(1.0)
_ZERO = np.float32(0.0)

# standard value (enums.ColorStandard) -> (Rv, Bu, Gv, Gu, Ycoef, Yoff)
_STANDARD_COEFS = {
    0: (_RV, _BU, _GV, _GU, _Y_COEF, np.float32(16)),  # BT601 (ref-exact)
    1: (_RV709, _BU709, _GV709, _GU709, _Y_COEF, np.float32(16)),
    2: (_RV601F, _BU601F, _GV601F, _GU601F, _ONE, _ZERO),  # BT601 full
    3: (_RV709F, _BU709F, _GV709F, _GU709F, _ONE, _ZERO),  # BT709 full
}

# Correctly rounded i/255: the reference's CUDA `/= 255` is a true IEEE
# division, so integer-valued channels go through this table.
_DIV255 = np.arange(256, dtype=np.float32) / np.float32(255)
# clip(num/16, 0, 255)/255 for the integer numerators of the YUV444
# horizontal chroma filter (float mode); num is clamped into [0, 4080].
_DIV16_255 = (np.minimum(np.arange(4081, dtype=np.float32) / np.float32(16),
                         np.float32(255))) / np.float32(255)

_TABLES = {}


def _table(name: str, values: np.ndarray, device) -> torch.Tensor:
    key = (name, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(values).to(device)
        _TABLES[key] = t
    return t


def _lut(name, values, x):
    idx = x.to(torch.int64).clamp(0, len(values) - 1)
    return _table(name, values, x.device)[idx]


def _norm255_int(x):
    """Exact x/255 for integer-valued x in [0, 255]."""
    return _lut("div255", _DIV255, x)


def _upsample_uv(uv):
    """Expands interleaved UV [..., H/2, W] to per-pixel U and V planes
    [..., H, W]: UVRow = i/2, UVCol = even-aligned j
    (src/ColorConversion.cu:16-21)."""
    u = uv[..., 0::2].repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    v = uv[..., 1::2].repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return u, v


def nv12_to_rgb_channels(y, uv, standard: int = 0):
    """Clamped integer (R, G, B) int32 planes (src/ColorConversion.cu:6-39)."""
    rv, bu, gv, gu, y_coef, y_off = (float(c) for c in _STANDARD_COEFS[standard])
    u, v = _upsample_uv(uv)
    # Full-range standards: y_off=0 / y_coef=1 make this the identity on
    # uint8 input, so one expression serves both swings.
    yf = torch.clamp_min(y.to(torch.float32) - y_off, 0.0) * y_coef
    vi = (v.to(torch.int32) - 128).to(torch.float32)
    ui = (u.to(torch.int32) - 128).to(torch.float32)
    r = (yf + ((vi * rv) + 0.5)).to(torch.int32)
    b = (yf + ((ui * bu) + 0.5)).to(torch.int32)
    g = (yf + (((vi * gv) + (ui * gu)) + 0.5)).to(torch.int32)
    return r.clamp(0, 255), g.clamp(0, 255), b.clamp(0, 255)


def nv12_to_rgb(y, uv, swap_rb: bool, planar: bool, normalization: bool,
                standard: int = 0):
    """NV12 -> RGB24/BGR24, planar [..., 3, H, W] or merged [..., H, W, 3]
    (src/ColorConversion.cu:41-93)."""
    r, g, b = nv12_to_rgb_channels(y, uv, standard)
    if swap_rb:
        r, b = b, r
    chans = [r, g, b]
    if normalization:
        chans = [_norm255_int(c) for c in chans]
    else:
        chans = [c.to(torch.uint8) for c in chans]
    return torch.stack(chans, dim=-3 if planar else -1)


def nv12_to_y800(y, normalization: bool):
    """(src/ColorConversion.cu:95-105); shape [..., 1, H, W]."""
    out = _norm255_int(y) if normalization else y
    return out.unsqueeze(-3)


def _uyvy_chroma_vertical(uv):
    """Vertical 4-tap chroma interpolation on odd UV rows, 420 -> 422
    (src/ColorConversion.cu:107-127); returns uint8 [..., H/2, W]."""
    h2 = uv.shape[-2]
    p = uv.to(torch.int32)
    rows = np.arange(h2)
    take = lambda r: p.index_select(-2, torch.as_tensor(r, device=p.device))
    r2 = np.minimum(rows + 1, h2 - 1)
    r3 = np.maximum(rows - 1, 0)
    r4 = np.minimum(rows + 2, h2 - 1)
    filt = (9 * (p + take(r2)) - (take(r3) + take(r4)) + 8) >> 4
    filt = filt.clamp(0, 255)
    odd = torch.as_tensor((rows % 2 != 0)[:, None], device=p.device)
    return torch.where(odd, filt, p).to(torch.uint8)


def nv12_to_uyvy(y, uv, normalization: bool, as_float: bool = False):
    """NV12 -> UYVY 4:2:2 merged (src/ColorConversion.cu:176-209).
    Per luma row: U0 Y0 V0 Y1 | U1 Y2 V1 Y3 | ...; returns [..., H, 2W]."""
    h, w = y.shape[-2:]
    uv_rows = _uyvy_chroma_vertical(uv).repeat_interleave(2, dim=-2)
    out = torch.stack([uv_rows[..., 0::2], y[..., 0::2],
                       uv_rows[..., 1::2], y[..., 1::2]], dim=-1)
    out = out.reshape(*y.shape[:-2], h, 2 * w)
    if normalization:
        return _norm255_int(out)
    if as_float:
        return out.to(torch.float32)
    return out


def _yuv444_taps(w: int, h: int, shift: int):
    """Flat-index taps of the horizontal chroma filter over the UYVY
    buffer, with the reference's boundary substitutions
    (src/ColorConversion.cu:129-143). p2 may point up to 3 past the
    payload: the reference reads the zeroed tail of its over-allocated
    buffer there, so the gather runs over a zero-padded buffer."""
    idx = np.arange(w * h, dtype=np.int64)
    src_index = idx * 2 + 1
    last = w * h * 2 - 1
    p1 = np.clip(src_index - 3 + shift, 0, last)
    p2 = src_index + 1 + shift
    p3 = src_index - 7 + shift
    p3 = np.where(p3 < 0, p1, p3)
    p4 = src_index + 5 + shift
    p4 = np.where(p4 > last, p2, p4)
    return p1, p2, p3, p4


def uyvy_to_yuv444(uyvy, w: int, h: int, normalization: bool, float_mode: bool):
    """UYVY -> planar YUV444 (src/ColorConversion.cu:146-173).

    `float_mode` is the CUDA template's T: float when the final output is
    normalized, uchar otherwise. The uchar path keeps the reference's
    truncating int division and mod-256 wrap on assignment; the float path
    divides exactly and clamps. Returns the planar buffer reshaped to
    [..., H, W, 3], as the reference reinterprets it."""
    lead = uyvy.shape[:-2]
    flat_int = uyvy.reshape(*lead, -1).to(torch.int32)
    dev = flat_int.device
    n = 2 * w * h
    idx = np.arange(w * h, dtype=np.int64)
    src_index = idx * 2 + 1
    even = torch.as_tensor(idx % 2 == 0, device=dev)

    def take(buf, index):
        index = np.clip(index, 0, buf.shape[-1] - 1)
        return buf.index_select(-1, torch.as_tensor(index, device=dev))

    y_direct = take(flat_int, src_index)
    flat_pad = torch.cat(
        [flat_int, torch.zeros(*lead, 8, dtype=torch.int32, device=dev)], -1)

    def chroma(shift):
        direct = take(flat_int, np.clip(src_index - 1 + shift, 0, n - 1))
        p1, p2, p3, p4 = _yuv444_taps(w, h, shift)
        num = (9 * (take(flat_pad, p1) + take(flat_pad, p2))
               - (take(flat_pad, p3) + take(flat_pad, p4)) + 8)
        if float_mode:
            if normalization:
                val = _lut("div16_255", _DIV16_255, num.clamp(0, 4080))
                return torch.where(even, _norm255_int(direct), val)
            val = (num.to(torch.float32) / 16.0).clamp(0, 255)
            return torch.where(even, direct.to(torch.float32), val)
        val = torch.div(num, 16, rounding_mode="trunc")
        # Assignment to uchar wraps mod 256 before the (no-op) clamp
        # (src/ColorConversion.cu:139-141); quirk preserved.
        val = val.to(torch.uint8)
        return torch.where(even, direct.to(torch.uint8), val)

    u_plane = chroma(0)
    v_plane = chroma(2)
    if normalization:
        y_plane = _norm255_int(y_direct)
    elif float_mode:
        y_plane = y_direct.to(torch.float32)
    else:
        y_plane = y_direct.to(torch.uint8)
    return torch.cat([y_plane, u_plane, v_plane], -1).reshape(*lead, h, w, 3)


def nv12_merge(y, uv, normalization: bool):
    """NV12 passthrough into one contiguous Y+UV buffer
    (src/ColorConversion.cu:211-233); shape [..., 1, 1.5H, W]."""
    h, w = y.shape[-2:]
    lead = y.shape[:-2]
    out = torch.cat([y.reshape(*lead, -1), uv.reshape(*lead, -1)], -1)
    if normalization:
        out = _norm255_int(out)
    return out.reshape(*lead, 1, h * 3 // 2, w)


def rgb_to_hsv(rgb):
    """Merged normalized RGB float32 -> merged HSV float32, H scaled to
    [0,1] from degrees/360, S = 1 - min/max, V = max
    (src/ColorConversion.cu:235-278)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    min_v = torch.minimum(torch.minimum(r, g), b)
    max_v = torch.maximum(torch.maximum(r, g), b)
    delta = max_v - min_v
    zero = torch.zeros((), dtype=torch.float32, device=rgb.device)
    s = torch.where(max_v != 0, 1 - min_v / max_v, zero)
    h = torch.where(
        (r == max_v) & (g >= b), 60 * (g - b) / delta,
        torch.where((r == max_v) & (g < b), 60 * (g - b) / delta + 360,
                    torch.where(g == max_v, 60 * (b - r) / delta + 120,
                                60 * (r - g) / delta + 240)))
    h = torch.where(h < 0, h + 360, h) / 360.0
    # max == min: H = 0 and the early return skips the /360 (quirk kept).
    h = torch.where(max_v == min_v, zero, h)
    return torch.stack([h, s, max_v], dim=-1)


def nv12_to_hsv(y, uv, standard: int = 0):
    """HSV is always produced from normalized merged RGB float
    (src/ColorConversion.cu:360-372)."""
    rgb = nv12_to_rgb(y, uv, swap_rb=False, planar=False, normalization=True,
                      standard=standard)
    return rgb_to_hsv(rgb)
