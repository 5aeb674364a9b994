"""NV12-domain resize on the device: NEAREST, BILINEAR, BICUBIC and AREA.

Port of the JAX package's ``ops/resize.py`` (reference:
src/Resize.cu:160-473). Every index and weight depends only on the output
row or the output column, so the per-axis tables are built on the host
with numpy, in the float32/float64 arithmetic the reference's CUDA code
used (the JAX package's table code, unchanged), once per geometry and
device.

NEAREST is two ``index_select`` gathers a plane. The other three blend
source taps, and their bytes are those of nvcc's FMA-contracted float32
(``csrc/vpp_host.cpp`` writes the order out with ``fmaf``). On CUDA each
runs a hand-written kernel of ``csrc/resize_nv12.cu``; on the CPU it runs
the plain torch version beside it, which rounds exactly as the kernel
does (``_fmaf`` is a correctly rounded fused multiply-add):

- ``resize_bilinear_nv12``: BILINEAR, and AREA when it upscales on either
  axis (the same blend with coverage weights);
- ``resize_bicubic_nv12``: BICUBIC, two passes of 4 taps in float64;
- ``resize_area_down_nv12``: AREA when both axes shrink, a weighted box of
  ``ceil(ratio)`` taps an axis.

Both planes are described alike: a plane's output row r reads the rows
that its row table names and blends them with the row weights, and its
output column j reads the columns that its column table names. The UV
plane's columns interleave U (even) and V (odd), so its column tables
hold each chroma column's taps and weights, and one description covers Y
and UV. A kernel launch covers the whole batch and both planes. Each
launch adds one to its kernel's entry of ``launches``.
"""
import ctypes
import math

import numpy as np
import torch

from .. import _build
from ..enums import ResizeType

KERNELS = ("resize_bilinear_nv12", "resize_bicubic_nv12",
           "resize_area_down_nv12")
_ENTRY = {"resize_bilinear_nv12": "ts_resize_bilinear_nv12",
          "resize_bicubic_nv12": "ts_resize_bicubic_nv12",
          "resize_area_down_nv12": "ts_resize_area_down_nv12"}

launches = dict.fromkeys(KERNELS, 0)

_FNS = None
_EPS32 = np.float32(np.finfo(np.float32).eps)


def reset_counts():
    for k in KERNELS:
        launches[k] = 0


def _lib():
    global _FNS
    if _FNS is None:
        lib = _build.load("resize_nv12")
        v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fns = {}
        for name, entry in _ENTRY.items():
            fn = getattr(lib, entry)
            fn.restype = i
            fn.argtypes = [v, ll, ll, v, ll, ll, v, v, i, i, i,
                           v, v, v, v, i, i, v]
            fns[name] = fn
        _FNS = fns
    return _FNS


# ---------------------------------------------------------------- nearest

def _nearest_axis(dst_n: int, ratio: np.float32) -> np.ndarray:
    # x = (int)(xRatio * j): f32 product truncated (src/Resize.cu:249-250).
    j = np.arange(dst_n, dtype=np.float32)
    return (ratio * j).astype(np.int64)


def nearest_tables(src_w, src_h, dst_w, dst_h):
    """(rows, cols, uv_rows, uv_cols) int64 gather tables."""
    x_ratio = np.float32(src_w) / np.float32(dst_w)
    y_ratio = np.float32(src_h) / np.float32(dst_h)
    xs = _nearest_axis(dst_w, x_ratio)
    ys = _nearest_axis(dst_h, y_ratio)
    # UV: dst (i, 2j / 2j+1) <- src (y[i], 2x[j] / 2x[j]+1) over half dims
    # (src/Resize.cu:262-265).
    xs_uv = xs[: dst_w // 2]
    cols = np.empty(dst_w, dtype=np.int64)
    cols[0::2] = 2 * xs_uv
    cols[1::2] = 2 * xs_uv + 1
    return ys, xs, ys[: dst_h // 2], cols


# ------------------------------------------------------------ axis tables

def _coord_fma(dst_n: int, ratio: np.float32) -> np.ndarray:
    """f32 center-aligned coordinate fmaf(j+0.5, ratio, -0.5), the
    single-rounding form nvcc contracts `(j + 0.5f) * ratio - 0.5f` into
    (src/Resize.cu:277-278): the product is exact in f64, so the one f32
    cast is the FMA's rounding."""
    j = np.arange(dst_n, dtype=np.float32)
    f64 = (j + np.float32(0.5)).astype(np.float64) * np.float64(ratio) - 0.5
    return f64.astype(np.float32)


def _bilinear_axis(dst_n: int, ratio: np.float32, src_n: int):
    """Center-aligned source coordinate with the reference's border clamps
    (src/Resize.cu:276-302): x<0 -> (0, w=0); x>src-1 -> (src-1, w=0)."""
    f = _coord_fma(dst_n, ratio)
    base = np.floor(f).astype(np.int64)
    w = (f - base.astype(np.float32)).astype(np.float32)
    low = base < 0
    base[low] = 0
    w[low] = 0
    high = base > src_n - 1
    base[high] = src_n - 1
    w[high] = 0
    return base, w


def _area_axis_up(dst_n: int, ratio: np.float32):
    """x = floor(ratio*j); w = frac((j+1) - (x+1)/ratio), clamped at 0
    (src/Resize.cu:220-232)."""
    j = np.arange(dst_n, dtype=np.float32)
    base = np.floor(ratio * j).astype(np.float32)
    w = (j + 1) - (base + 1) / ratio
    w = np.where(w <= 0, np.float32(0), w - np.floor(w)).astype(np.float32)
    return base.astype(np.int64), w


def _bicubic_axis(dst_n: int, ratio: np.float32, src_n: int):
    """f64 coordinate of the f32 expression (src/Resize.cu:321-347)."""
    f = _coord_fma(dst_n, ratio).astype(np.float64)
    base = np.floor(f).astype(np.int64)
    w = f - base
    low = base < 0
    base[low] = 0
    w[low] = 0.0
    high = base > src_n - 1
    base[high] = src_n - 1
    w[high] = 0.0
    return base, w


def _bicubic_coefs(w: np.ndarray):
    """Spline weights, a=-0.75, in float64 as the CUDA code computes them
    (src/Resize.cu:45-50; csrc/vpp_host.cpp BuildBicubicAxis, whose
    w2 = w*w and w3 = w2*w are two products, not pow); (dst_n, 4)."""
    a = -0.75
    w2 = w * w
    w3 = w2 * w
    c0 = a * w - 2 * a * w2 + a * w3
    c1 = 1 - (a + 3) * w2 + (a + 2) * w3
    c2 = -a * w + (2 * a + 3) * w2 - (a + 2) * w3
    c3 = a * w2 - a * w3
    return np.stack([c0, c1, c2, c3], axis=1)


def _bicubic_taps(base: np.ndarray, diff: int, n: int):
    """Tap positions (-diffTop, 0, +diff, +2diff) with the reference's
    collapse rules (src/Resize.cu:29-43): the + taps collapse when either
    base+diff or base+2*diff crosses the bound, the - tap at 0;
    (dst_n, 4)."""
    d = np.full_like(base, diff)
    d[base + diff >= n] = 0
    d[base + 2 * diff >= n] = 0
    d_top = np.full_like(base, diff)
    d_top[base - diff < 0] = 0
    return np.stack([base - d_top, base, base + d, base + 2 * d], axis=1)


def generate_resize_pattern(scale: np.float32):
    """Fractional pixel-coverage rows of the INTER_AREA-style box filter,
    the reference's host code in its float32 arithmetic and epsilon loop
    bound (src/Resize.cu:359-386). Rows are cut to ceil(scale) taps: the
    reference's kernel reads no more (src/Resize.cu:162-166)."""
    scale = np.float32(scale)
    pattern = []
    rest = np.float32(0)
    current = 0
    width = int(math.ceil(float(scale)))
    while True:
        prod = np.float32(current) * scale
        if not (prod == 0 or (prod - np.float32(int(prod))) > _EPS32):
            break
        dyn = scale
        row = []
        if rest:
            row.append(np.float32(rest))
            dyn = np.float32(dyn - rest)
        while dyn - 1 > 0:
            row.append(np.float32(1))
            dyn = np.float32(dyn - 1)
        if dyn > _EPS32:
            row.append(np.float32(dyn))
            rest = np.float32(1 - dyn)
        while len(row) < width:
            row.append(np.float32(0))
        pattern.append(row[:width])
        current += 1
        if current > 8192:  # the reference could spin forever
            break
    return np.asarray(pattern, dtype=np.float32)  # (period, ceil(scale))


def _area_axis_down(dst_n: int, ratio: np.float32):
    j = np.arange(dst_n, dtype=np.float32)
    base = (ratio * j).astype(np.float32)
    base = np.floor(base.astype(np.int32).astype(np.float32)).astype(np.int64)
    pattern = generate_resize_pattern(ratio)
    rows = pattern[np.arange(dst_n) % pattern.shape[0]]  # (dst_n, taps)
    return base, rows


# ----------------------------------------------------------- plane tables

def _pairs(u, v):
    """Interleaves per-chroma-column rows: out[2j] = u[j], out[2j+1] = v[j]."""
    out = np.empty((2 * u.shape[0],) + u.shape[1:], u.dtype)
    out[0::2] = u
    out[1::2] = v
    return out


def _bilinear_planes(xs, wx, ys, wy, src_w, src_h, dst_w, dst_h):
    """Y and UV tables of the 4-tap blend: rows (ra, rc), cols (ca, cb),
    row weight wy, column weight wx. The +1 tap collapses at the border,
    and U/V taps step by 2 over the interleaved row (src/Resize.cu:5-25,
    235-238, 307-310)."""
    h2 = src_h // 2
    y_plane = dict(
        rows=np.stack([ys, np.where(ys + 1 >= src_h, ys, ys + 1)], axis=1),
        cols=np.stack([xs, np.where(xs + 1 >= src_w, xs, xs + 1)], axis=1),
        row_w=wy[:, None], col_w=wx[:, None])
    ys_uv = ys[: dst_h // 2]
    u_a = 2 * xs[: dst_w // 2]
    v_a = u_a + 1
    u_cols = np.stack([u_a, np.where(u_a + 2 >= src_w, u_a, u_a + 2)], 1)
    v_cols = np.stack([v_a, np.where(v_a + 2 >= src_w, v_a, v_a + 2)], 1)
    wx_uv = wx[: dst_w // 2, None]
    uv_plane = dict(
        rows=np.stack([ys_uv, np.where(ys_uv + 1 >= h2, ys_uv, ys_uv + 1)],
                      axis=1),
        cols=_pairs(u_cols, v_cols), row_w=wy[: dst_h // 2, None],
        col_w=_pairs(wx_uv, wx_uv))
    return y_plane, uv_plane


def _bicubic_planes(src_w, src_h, dst_w, dst_h):
    x_ratio = np.float32(src_w) / np.float32(dst_w)
    y_ratio = np.float32(src_h) / np.float32(dst_h)
    xs, wx = _bicubic_axis(dst_w, x_ratio, src_w)
    ys, wy = _bicubic_axis(dst_h, y_ratio, src_h)
    cx, cy = _bicubic_coefs(wx), _bicubic_coefs(wy)
    y_plane = dict(rows=_bicubic_taps(ys, 1, src_h),
                   cols=_bicubic_taps(xs, 1, src_w), row_w=cy, col_w=cx)
    xs_uv = xs[: dst_w // 2]
    cx_uv = cx[: dst_w // 2]
    uv_plane = dict(
        rows=_bicubic_taps(ys[: dst_h // 2], 1, src_h // 2),
        cols=_pairs(_bicubic_taps(2 * xs_uv, 2, src_w),
                    _bicubic_taps(2 * xs_uv + 1, 2, src_w)),
        row_w=cy[: dst_h // 2], col_w=_pairs(cx_uv, cx_uv))
    return y_plane, uv_plane


def _area_down_planes(src_w, src_h, dst_w, dst_h):
    """Weighted box tables: tap t of output row i reads row
    min(base[i] + t, plane_h - 1) with pattern weight w[i, t]; columns
    alike, the U/V taps stepping by 2 (src/Resize.cu:160-178,
    csrc/vpp_host.cpp:330-355)."""
    x_ratio = np.float32(src_w) / np.float32(dst_w)
    y_ratio = np.float32(src_h) / np.float32(dst_h)
    xb, wx = _area_axis_down(dst_w, x_ratio)
    yb, wy = _area_axis_down(dst_h, y_ratio)
    ty, tx = np.arange(wy.shape[1]), np.arange(wx.shape[1])
    y_plane = dict(rows=np.minimum(yb[:, None] + ty, src_h - 1),
                   cols=np.minimum(xb[:, None] + tx, src_w - 1),
                   row_w=wy, col_w=wx)
    xb_uv = xb[: dst_w // 2, None]
    wx_uv = wx[: dst_w // 2]
    uv_plane = dict(
        rows=np.minimum(yb[: dst_h // 2, None] + ty, src_h // 2 - 1),
        cols=_pairs(np.minimum(2 * xb_uv + 2 * tx, src_w - 1),
                    np.minimum(2 * xb_uv + 1 + 2 * tx, src_w - 1)),
        row_w=wy[: dst_h // 2], col_w=_pairs(wx_uv, wx_uv))
    return y_plane, uv_plane


def plane_tables(src_w, src_h, dst_w, dst_h, resize_type: ResizeType):
    """(kernel name, (Y tables, UV tables)) for BILINEAR, BICUBIC or AREA.
    Each plane's tables: ``rows`` int [out_h, taps], ``cols`` int
    [out_w, taps], ``row_w`` [out_h, k] and ``col_w`` [out_w, k]
    (float32; float64 for BICUBIC)."""
    x_ratio = np.float32(src_w) / np.float32(dst_w)
    y_ratio = np.float32(src_h) / np.float32(dst_h)
    if resize_type == ResizeType.BILINEAR:
        xs, wx = _bilinear_axis(dst_w, x_ratio, src_w)
        ys, wy = _bilinear_axis(dst_h, y_ratio, src_h)
        return "resize_bilinear_nv12", _bilinear_planes(
            xs, wx, ys, wy, src_w, src_h, dst_w, dst_h)
    if resize_type == ResizeType.BICUBIC:
        return "resize_bicubic_nv12", _bicubic_planes(src_w, src_h, dst_w,
                                                      dst_h)
    if resize_type == ResizeType.AREA:
        if x_ratio > 1 and y_ratio > 1:
            return "resize_area_down_nv12", _area_down_planes(
                src_w, src_h, dst_w, dst_h)
        # Upscale on either axis: bilinear with coverage-derived weights
        # (src/Resize.cu:214-240).
        xs, wx = _area_axis_up(dst_w, x_ratio)
        ys, wy = _area_axis_up(dst_h, y_ratio)
        return "resize_bilinear_nv12", _bilinear_planes(
            xs, wx, ys, wy, src_w, src_h, dst_w, dst_h)
    raise ValueError(f"unsupported resize type {resize_type}")


# ------------------------------------------------------- plain versions

def _fmaf(x, y, z):
    """Correctly rounded float32 fmaf(x, y, z) of float32 tensors: the
    product is exact in float64, the sum is rounded to odd (a TwoSum error
    term, then one step off an even last bit when it is inexact), and the
    cast to float32 then rounds once, since 53 >= 24 + 2 bits."""
    p = x.double() * y.double()
    zd = z.double()
    s = p + zd
    bb = s - p
    err = (p - (s - bb)) + (zd - bb)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, math.inf),
                       torch.full_like(s, -math.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


def _trunc_u8(x):
    """C's (uint8_t)(int)x of a float."""
    return x.to(torch.int32).to(torch.uint8)


def _take(img, rows, cols):
    return img.index_select(-2, rows).index_select(-1, cols)


def _bilinear_plain(img, t):
    """The 4-tap blend of csrc/vpp_host.cpp Blend4 (nvcc's contraction):
    s = fmaf(a*omx, omy, (b*wx)*omy); s = fmaf(c*wy, omx, s);
    s = fmaf(d, wx*wy, s); (int)s."""
    rows, cols = t["rows"], t["cols"]
    a = _take(img, rows[:, 0], cols[:, 0]).float()
    b = _take(img, rows[:, 0], cols[:, 1]).float()
    c = _take(img, rows[:, 1], cols[:, 0]).float()
    d = _take(img, rows[:, 1], cols[:, 1]).float()
    wx = t["col_w"][:, 0][None, :]
    wy = t["row_w"][:, 0][:, None]
    omx = 1.0 - wx
    omy = 1.0 - wy
    s = _fmaf(a * omx, omy, (b * wx) * omy)
    s = _fmaf(c * wy, omx, s)
    s = _fmaf(d, wx * wy, s)
    return _trunc_u8(s)


def _round_clamp(x):
    """std::round (half away from zero) of float64, clamped to [0, 255]."""
    whole = torch.trunc(x)
    frac = x - whole
    step = (frac >= 0.5).to(x.dtype) - (frac <= -0.5).to(x.dtype)
    return (whole + step).clamp(0, 255)


def _bicubic_plain(img, t):
    """Two-pass spline in float64 (csrc/vpp_host.cpp BicubicPlane): at
    each of 4 row taps, ((c0 p0 + c1 p1) + c2 p2) + c3 p3, rounded and
    clamped; then the same over the 4 rows."""
    rows, cols, cx, cy = t["rows"], t["cols"], t["col_w"], t["row_w"]
    blended = []
    for r in range(4):
        sub = img.index_select(-2, rows[:, r])
        acc = None
        for k in range(4):
            p = sub.index_select(-1, cols[:, k]).double()
            term = cx[:, k][None, :] * p
            acc = term if acc is None else acc + term
        blended.append(_round_clamp(acc))
    acc = None
    for r in range(4):
        term = cy[:, r][:, None] * blended[r]
        acc = term if acc is None else acc + term
    return _round_clamp(acc).to(torch.uint8)


def _area_down_plain(img, t):
    """Weighted box in the reference's order (y taps outer, x inner): per
    tap w2d = f32(wy*wx), div += w2d, acc = fmaf(p, w2d, acc); then
    (int)(acc / div)."""
    rows, cols, wy, wx = t["rows"], t["cols"], t["row_w"], t["col_w"]
    acc = None
    div = None
    for ti in range(rows.shape[1]):
        sub = img.index_select(-2, rows[:, ti])
        for tj in range(cols.shape[1]):
            w2d = wy[:, ti][:, None] * wx[:, tj][None, :]
            div = w2d if div is None else div + w2d
            p = sub.index_select(-1, cols[:, tj]).float()
            acc = _fmaf(p, w2d, torch.zeros_like(p) if acc is None else acc)
    return _trunc_u8(acc / div)


_PLAIN = {"resize_bilinear_nv12": _bilinear_plain,
          "resize_bicubic_nv12": _bicubic_plain,
          "resize_area_down_nv12": _area_down_plain}


# ------------------------------------------------------------ the resize

class NV12Resize:
    """One (source, target, algorithm): its tables, its plain version and
    its kernel. Calling it runs the kernel on CUDA tensors and the plain
    version on CPU tensors; there is no fallback between the two.

    Planes are [..., H, W] and [..., H/2, W] uint8 (any leading batch
    dims on the CPU; [N, H, W] or [H, W] on CUDA, where a crop's strided
    view is read in place through its row pitch and batch stride)."""

    def __init__(self, src_w, src_h, dst_w, dst_h, resize_type):
        self.src = (int(src_w), int(src_h))
        self.dst = (int(dst_w), int(dst_h))
        self.kernel, self.planes = plane_tables(src_w, src_h, dst_w, dst_h,
                                                resize_type)
        self._on = {}

    def _tables(self, device):
        key = str(device)
        if key not in self._on:
            wtype = (torch.float64 if self.kernel == "resize_bicubic_nv12"
                     else torch.float32)
            planes = [{k: torch.as_tensor(v, dtype=(torch.int64
                                                     if k in ("rows", "cols")
                                                     else wtype),
                                          device=device)
                       for k, v in p.items()} for p in self.planes]
            # The kernel's packing: each kind of table of the Y plane, then
            # of the UV plane, in one contiguous buffer.
            packed = [torch.cat([p[k] for p in planes]).to(
                torch.int32 if k in ("rows", "cols") else wtype).contiguous()
                for k in ("rows", "cols", "row_w", "col_w")]
            self._on[key] = (planes, packed)
        return self._on[key]

    def plain(self, y, uv):
        """The plain torch version, on whatever device the planes lie."""
        planes, _ = self._tables(y.device)
        fn = _PLAIN[self.kernel]
        return fn(y, planes[0]), fn(uv, planes[1])

    def __call__(self, y, uv):
        if y.device.type == "cpu" and uv.device.type == "cpu":
            return self.plain(y, uv)
        return self.launch(y, uv)

    def launch(self, y, uv):
        """The CUDA kernel: one launch for the batch and both planes."""
        if y.device.type != "cuda" or uv.device != y.device:
            raise ValueError(f"y on {y.device} and uv on {uv.device}: both "
                             "must be on one CUDA device (or both on the "
                             "CPU)")
        if y.dtype != torch.uint8 or uv.dtype != torch.uint8:
            raise TypeError(f"NV12 planes must be uint8, got "
                            f"{y.dtype}/{uv.dtype}")
        if y.dim() not in (2, 3) or uv.dim() != y.dim():
            raise ValueError(f"expected [N,H,W] or [H,W] planes, got "
                             f"{tuple(y.shape)} and {tuple(uv.shape)}")
        sw, sh = self.src
        dw, dh = self.dst
        *lead, h, w = y.shape
        n = lead[0] if lead else 1
        if (h, w) != (sh, sw) or tuple(uv.shape) != (*lead, sh // 2, sw):
            raise ValueError(f"planes {tuple(y.shape)}/{tuple(uv.shape)} "
                             f"do not match the {sw}x{sh} source")
        if y.stride(-1) != 1 or uv.stride(-1) != 1:
            raise ValueError("plane rows must be contiguous")
        if n > 65535 or dh + dh // 2 > 65535:
            raise ValueError(f"batch {n} or height {dh} exceeds the grid")
        out_y = torch.empty((*lead, dh, dw), dtype=torch.uint8,
                            device=y.device)
        out_uv = torch.empty((*lead, dh // 2, dw), dtype=torch.uint8,
                             device=y.device)
        if n == 0:
            return out_y, out_uv
        _, (rows, cols, row_w, col_w) = self._tables(y.device)
        batch_y = y.stride(0) if lead else 0
        batch_uv = uv.stride(0) if lead else 0
        with torch.cuda.device(y.device):
            rc = _lib()[self.kernel](
                y.data_ptr(), y.stride(-2), batch_y,
                uv.data_ptr(), uv.stride(-2), batch_uv,
                out_y.data_ptr(), out_uv.data_ptr(), n, dw, dh,
                rows.data_ptr(), cols.data_ptr(), row_w.data_ptr(),
                col_w.data_ptr(), rows.shape[1], cols.shape[1],
                torch.cuda.current_stream(y.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{_ENTRY[self.kernel]} launch failed: "
                               f"cudaError {rc}")
        launches[self.kernel] += 1
        return out_y, out_uv


def make_resize_fn(src_w, src_h, dst_w, dst_h, resize_type: ResizeType):
    """(y [..., H, W], uv [..., H/2, W]) -> resized planes. NEAREST is two
    gathers a plane; the others are an NV12Resize."""
    if resize_type != ResizeType.NEAREST:
        return NV12Resize(src_w, src_h, dst_w, dst_h, resize_type)
    tables = nearest_tables(src_w, src_h, dst_w, dst_h)
    on_device = {}

    def fn(y, uv):
        key = str(y.device)
        if key not in on_device:
            on_device[key] = [torch.as_tensor(t, device=y.device)
                              for t in tables]
        rows, cols, uv_rows, uv_cols = on_device[key]
        return _take(y, rows, cols), _take(uv, uv_rows, uv_cols)

    return fn
