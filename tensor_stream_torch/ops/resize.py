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

Each kernel is an operator (``_library``), ``ts::resize_bilinear_nv12``,
``ts::resize_bicubic_nv12`` and ``ts::resize_area_down_nv12`` (planes,
target width and height, resize type): its CUDA kernel is the
hand-written one and its CPU kernel the plain version, and the tables of
the geometry are made inside it, so an exported program holds the op and
its integers, not the tables or the pointers.
"""
import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .._device import kernel_device
from . import _library
from ..enums import ResizeType

KERNELS = ("resize_bilinear_nv12", "resize_bicubic_nv12",
           "resize_area_down_nv12")
_ENTRY = {"resize_bilinear_nv12": "ts_resize_bilinear_nv12",
          "resize_bicubic_nv12": "ts_resize_bicubic_nv12",
          "resize_area_down_nv12": "ts_resize_area_down_nv12"}

launches = dict.fromkeys(KERNELS, 0)
# resize_area_down_nv12's launches by variant (area_plan): "registers" keeps
# a column's weights in registers, "table" in shared memory.
AREA_VARIANTS = ("registers", "table")
area_launches_by_variant = dict.fromkeys(AREA_VARIANTS, 0)

_FNS = None
_EPS32 = np.float32(np.finfo(np.float32).eps)


def reset_counts():
    for k in KERNELS:
        launches[k] = 0
    for k in AREA_VARIANTS:
        area_launches_by_variant[k] = 0


def bind(lib):
    """{kernel name: entry point} of a built resize_nv12 library, with
    their argument types."""
    v, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fns = {}
    for name, entry in _ENTRY.items():
        fn = getattr(lib, entry)
        fn.restype = i
        fn.argtypes = [v, ll, ll, v, ll, ll, v, v, i, i, i,
                       v, v, v, v, i, i, v]
        if name == "resize_area_down_nv12":
            fn.argtypes += [v, v, v] + [i] * (len(AREA_ARGS) - 3)
        fns[name] = fn
    return fns


def _lib():
    global _FNS
    if _FNS is None:
        _FNS = bind(_build.load("resize_nv12"))
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


# ------------------------------------------------------- the AREA plan

AREA_REGISTER_TAPS = 16  # csrc/resize_nv12.cu kRegisterTaps
AREA_THREADS = 256       # most threads (output columns) a block
AREA_BANDS = (4, 2, 1)   # csrc/resize_nv12.cu kMaxBand is the first
AREA_FRAMES = (2, 1)
AREA_SMEM_TARGET = 48 * 1024   # a block's shared bytes, to keep ~4 an SM
AREA_SMEM_LIMIT = 232448       # the most a block may have on Hopper
AREA_MIN_BLOCKS = 2            # blocks an SM that a launch should have


class AreaPlan(NamedTuple):
    """How resize_area_down_nv12 cuts a launch into blocks. A block owns
    one plane of `frames` frames, a band of `band` output rows and a tile
    of `tile` output columns (a thread each). For each frame it stages the
    source bytes its taps read in shared memory: up to `rows` rows, row k
    holding its source row's columns from the tile's first at k * (pitch
    + source pitch mod 16) + (the first row's first byte's address mod
    16), the row's last byte repeated past its end. The frames of a block
    share their weights' products."""
    variant: str   # "registers" or "table"
    band: int      # output rows a block (1 in the table variant)
    tile: int      # output columns a block
    frames: int    # frames a block (1 in the table variant)
    tiles: int
    bands: tuple   # (Y bands, UV bands)
    pitch: int     # shared bytes a staged row
    rows: int      # staged rows (the table variant: rows a chunk)
    smem: int      # dynamic shared bytes a block
    spans: np.ndarray  # int32: [bands][2] (first source row, rows), Y
    #                    then UV; then [2][tiles][2] (first source column,
    #                    columns), Y then UV
    taps: np.ndarray   # int32: [bands][band * ty][2] (source row - the
    #                    band's first, weight bits) of each row tap


def area_steps(planes, src_w):
    """Each plane's first column tap c0 and tap step S (1 on Y, 2 on the
    interleaved UV plane), after checking that every tap is
    min(c0 + S*t, src_w - 1): the kernel reads c0 + S*t from the staged
    row, whose bytes past src_w - 1 repeat the last one."""
    out = []
    for step, plane in zip((1, 2), planes):
        cols = np.asarray(plane["cols"])
        c0 = cols[:, 0]
        taps = np.minimum(c0[:, None] + step * np.arange(cols.shape[1]),
                          src_w - 1)
        if not np.array_equal(cols, taps) or (c0 >= src_w).any():
            raise ValueError("AREA column taps do not step from their "
                             "first")
        out.append((c0.astype(np.int64), step))
    return out


def _round_up(x, m):
    return -(-x // m) * m


def area_blocks(planes, src_w, src_h, dw, dh, band, tile, variant,
                frames=1):
    """The AreaPlan of one band, tile, variant and frame count, whatever
    its size."""
    ty = np.asarray(planes[0]["rows"]).shape[1]
    tx = np.asarray(planes[0]["cols"]).shape[1]
    if variant == "registers" and tx > AREA_REGISTER_TAPS:
        raise ValueError(f"{tx} column taps exceed the registers variant")
    if band > AREA_BANDS[0]:
        raise ValueError(f"a band of {band} rows exceeds {AREA_BANDS[0]}")
    if variant == "table" and (band, frames) != (1, 1):
        raise ValueError("the table variant takes one output row a block")
    tiles = -(-dw // tile)
    row_spans, col_spans, taps = [], [], []
    for plane in planes:
        rows = np.asarray(plane["rows"])
        wy = np.asarray(plane["row_w"], np.float32).view(np.int32)
        for r0 in range(0, rows.shape[0], band):
            blk = rows[r0:r0 + band]
            row_spans.append((blk.min(), blk.max() - blk.min() + 1))
            tap = np.zeros((band, ty, 2), np.int32)
            tap[:len(blk), :, 0] = blk - blk.min()
            tap[:len(blk), :, 1] = wy[r0:r0 + band]
            taps.append(tap)
    for c0, step in area_steps(planes, src_w):
        for t in range(tiles):
            blk = c0[t * tile:(t + 1) * tile]
            if blk.size == 0:  # past the UV plane's last column
                col_spans.append((0, 0))
            else:
                col_spans.append((blk.min(), blk.max() + step * (tx - 1)
                                  - blk.min() + 1))
    # A staged row holds its 16-byte chunks: up to 15 bytes before its
    # first column and 15 after its last.
    pitch = _round_up(max(c for _, c in col_spans) + 31, 16)
    need = max(n for _, n in row_spans)

    def rows_bytes(rows):  # steps of up to pitch + 15, from up to 15 in
        return rows * (pitch + 16) + 16

    if variant == "registers":
        # The band's row taps, then each frame's rows.
        rows = need
        smem = _round_up(band * ty * 8, 16) + frames * rows_bytes(rows)
    else:
        wbytes = _round_up(tx * tile * 4, 16)
        rows = max(1, min(need, (AREA_SMEM_LIMIT - wbytes - 16)
                          // (pitch + 16)))
        smem = wbytes + rows_bytes(rows)
    spans = np.asarray(row_spans + col_spans, np.int32).reshape(-1)
    return AreaPlan(variant, band, tile, frames, tiles,
                    (-(-dh // band), -(-(dh // 2) // band)), pitch, rows,
                    int(smem), spans, np.concatenate(taps).reshape(-1))


# What resize_area_down_nv12 takes after the tables and the stream.
AREA_ARGS = ("div", "spans", "taps", "sw", "sh", "uvw", "band", "tile",
             "frames", "pitch", "rows", "smem", "variant")


def area_args(plan, div_ptr, spans_ptr, taps_ptr, src_w, src_h, uv_cols):
    """The values of AREA_ARGS for a launch under `plan`."""
    return (div_ptr, spans_ptr, taps_ptr, src_w, src_h, uv_cols, plan.band,
            plan.tile, plan.frames, plan.pitch, plan.rows, plan.smem,
            AREA_VARIANTS.index(plan.variant))


def area_div(planes):
    """Each output's sum of w2d = wy*wx over its taps, y outer and x
    inner, in float32 as the blend sums it: the Y plane's [dh, dw] then
    the UV plane's, flat. It depends on the weights alone, so the
    registers variant reads it instead of summing it in every frame."""
    out = []
    for plane in planes:
        wy = np.asarray(plane["row_w"], np.float32)
        wx = np.asarray(plane["col_w"], np.float32)
        div = np.zeros((wy.shape[0], wx.shape[0]), np.float32)
        for ti in range(wy.shape[1]):
            for tj in range(wx.shape[1]):
                div = div + wy[:, ti, None] * wx[None, :, tj]
        out.append(div.reshape(-1))
    return np.concatenate(out)


def area_launch_blocks(plan, n):
    """The blocks of a launch of `n` frames under `plan`."""
    return plan.tiles * -(-n // plan.frames) * sum(plan.bands)


def area_tiles(dw):
    """Column tiles to try, widest first: the fewest tiles of at most
    AREA_THREADS columns, then narrower ones down to one column."""
    tile = _round_up(-(-dw // -(-dw // AREA_THREADS)), 32)
    out = [tile]
    while tile > 1:
        tile = _round_up(tile // 2, 32) if tile > 32 else tile // 2
        out.append(tile)
    return out


def area_plan(planes, src_w, src_h, dw, dh, n=1, sms=132):
    """The plan resize_area_down_nv12 launches with for a batch of `n` on
    a card of `sms` SMs. The registers variant where the column taps fit
    (tx <= AREA_REGISTER_TAPS): the widest tile, then the most frames and
    the tallest band that leave AREA_MIN_BLOCKS blocks an SM with the
    shared bytes within AREA_SMEM_TARGET, else within the card's limit;
    the table variant otherwise (many taps, or a band too tall for any
    tile)."""
    tx = np.asarray(planes[0]["cols"]).shape[1]
    blocks = AREA_MIN_BLOCKS * sms
    if tx <= AREA_REGISTER_TAPS:
        for target in (AREA_SMEM_TARGET, AREA_SMEM_LIMIT):
            for tile in area_tiles(dw):
                for frames in AREA_FRAMES:
                    for band in AREA_BANDS:
                        plan = area_blocks(planes, src_w, src_h, dw, dh,
                                           band, tile, "registers",
                                           min(frames, n))
                        if plan.smem <= target and (
                                area_launch_blocks(plan, n) >= blocks
                                or band == plan.frames == 1):
                            return plan
    for tile in area_tiles(dw):
        plan = area_blocks(planes, src_w, src_h, dw, dh, 1, tile, "table")
        if plan.smem <= AREA_SMEM_LIMIT:
            return plan
    raise ValueError(f"no AREA plan fits {src_w}x{src_h} -> {dw}x{dh} in "
                     "shared memory")


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
    its kernel. Calling it calls the kernel's operator (``_OPS``), which
    runs the kernel on CUDA tensors and the plain version on CPU tensors;
    there is no fallback between the two.

    There is one object a geometry a process: ``NV12Resize(...)`` returns
    the geometry's registered object, and the operators look theirs up
    in the same registry from the planes' shape and their arguments. So
    the caller's object is the one its calls run on (its AREA plans
    included), and the tables on the device, whose pointers a captured
    CUDA graph holds, live as long as the process.

    Planes are [..., H, W] and [..., H/2, W] uint8 (any leading batch
    dims on the CPU; [N, H, W] or [H, W] on CUDA, where a crop's strided
    view is read in place through its row pitch and batch stride)."""

    def __new__(cls, src_w, src_h, dst_w, dst_h, resize_type):
        key = (int(src_w), int(src_h), int(dst_w), int(dst_h),
               ResizeType(resize_type))
        self = _GEOMETRIES.get(key)
        if self is None:
            self = _GEOMETRIES[key] = super().__new__(cls)
            self.src, self.dst = key[:2], key[2:4]
            self.resize_type = key[4]
            self.kernel, self.planes = plane_tables(*key)
            self._on = {}
            self._plans = {}
            self._area_on = {}
        return self

    def area_plan(self, n, sms=132):
        """resize_area_down_nv12's plan for a batch of `n` (area_plan)."""
        key = (n, sms)
        if key not in self._plans:
            self._plans[key] = area_plan(self.planes, *self.src, *self.dst,
                                         n=n, sms=sms)
        return self._plans[key]

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

    def __call__(self, y, uv, impl: str = "auto"):
        """The operator ``ts::<kernel>``: the kernel on CUDA planes, the
        plain version on CPU planes. ``impl="cuda"`` raises unless the
        planes lie on one CUDA device, ``impl="plain"`` calls the plain
        version on any device (as ``flash_attention``'s ``impl``)."""
        if impl not in ("auto", "plain", "cuda"):
            raise ValueError(f"unknown impl {impl!r} (auto, plain or cuda)")
        _library.on_one_device(y, uv, cuda=impl == "cuda")
        self._match(y, uv)
        if impl == "plain":
            return self.plain(y, uv)
        return _OPS[self.kernel](y, uv, *self.dst, self.resize_type.value)

    def _match(self, y, uv):
        """Raises unless the planes are [..., H, W] and [..., H/2, W] of
        this source."""
        sw, sh = self.src
        lead = tuple(y.shape[:-2])
        if (tuple(y.shape[-2:]) != (sh, sw)
                or tuple(uv.shape) != (*lead, sh // 2, sw)):
            raise ValueError(f"planes {tuple(y.shape)}/{tuple(uv.shape)} "
                             f"do not match the {sw}x{sh} source")

    def _launch(self, y, uv):
        """The kernel's body: one launch for the batch and both planes."""
        _library.on_one_device(y, uv, cuda=True)
        if y.dtype != torch.uint8 or uv.dtype != torch.uint8:
            raise TypeError(f"NV12 planes must be uint8, got "
                            f"{y.dtype}/{uv.dtype}")
        if y.dim() not in (2, 3) or uv.dim() != y.dim():
            raise ValueError(f"expected [N,H,W] or [H,W] planes, got "
                             f"{tuple(y.shape)} and {tuple(uv.shape)}")
        self._match(y, uv)
        sw, sh = self.src
        dw, dh = self.dst
        *lead, h, w = y.shape
        n = lead[0] if lead else 1
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
        extra, plan = (), None
        if self.kernel == "resize_area_down_nv12":
            plan = self.area_plan(n, torch.cuda.get_device_properties(
                y.device).multi_processor_count)
            div, spans, taps = self._area_tables(plan, y.device)
            extra = area_args(plan, div.data_ptr(), spans.data_ptr(),
                              taps.data_ptr(), sw, sh,
                              self.planes[1]["cols"].shape[0])
        with kernel_device(y.device):
            rc = _lib()[self.kernel](
                y.data_ptr(), y.stride(-2), batch_y,
                uv.data_ptr(), uv.stride(-2), batch_uv,
                out_y.data_ptr(), out_uv.data_ptr(), n, dw, dh,
                rows.data_ptr(), cols.data_ptr(), row_w.data_ptr(),
                col_w.data_ptr(), rows.shape[1], cols.shape[1],
                torch.cuda.current_stream(y.device).cuda_stream, *extra)
        if rc != 0:
            raise RuntimeError(f"{_ENTRY[self.kernel]} launch failed: "
                               f"cudaError {rc}")
        launches[self.kernel] += 1
        if plan is not None:
            area_launches_by_variant[plan.variant] += 1
        return out_y, out_uv

    def _area_tables(self, plan, device):
        """(div, spans, taps) of `plan` on `device` (area_div; AreaPlan)."""
        key = (str(device), plan.band, plan.tile)
        if key not in self._area_on:
            div = self._area_on.get(str(device))
            if div is None:
                div = self._area_on[str(device)] = torch.as_tensor(
                    area_div(self.planes), device=device)
            self._area_on[key] = (div,
                                  torch.as_tensor(plan.spans, device=device),
                                  torch.as_tensor(plan.taps, device=device))
        return self._area_on[key]


_GEOMETRIES = {}


def _geometry(y, dst_w, dst_h, resize_type):
    return NV12Resize(y.shape[-1], y.shape[-2], dst_w, dst_h, resize_type)


def _define_op(kernel):
    """``ts::<kernel>(y, uv, dst_w, dst_h, resize_type) -> (y, uv)``: the
    hand-written kernel on CUDA, the plain version on the CPU, and a fake
    that gives the outputs' shapes (contiguous, as the kernel's are)."""

    def cuda(y, uv, dst_w, dst_h, resize_type):
        r = _geometry(y, dst_w, dst_h, resize_type)
        if r.kernel != kernel:
            raise ValueError(f"{ResizeType(resize_type)} at {r.src} -> "
                             f"{r.dst} runs {r.kernel}, not {kernel}")
        return r._launch(y, uv)

    def cpu(y, uv, dst_w, dst_h, resize_type):
        return _geometry(y, dst_w, dst_h, resize_type).plain(y, uv)

    def fake(y, uv, dst_w, dst_h, resize_type):
        lead = y.shape[:-2]
        return (y.new_empty((*lead, dst_h, dst_w)),
                uv.new_empty((*lead, dst_h // 2, dst_w)))

    return _library.define(
        f"{kernel}(Tensor y, Tensor uv, int dst_w, int dst_h, "
        "int resize_type) -> (Tensor, Tensor)", cuda, cpu, fake)


_OPS = {kernel: _define_op(kernel) for kernel in KERNELS}


def make_resize_fn(src_w, src_h, dst_w, dst_h, resize_type: ResizeType):
    """(y [..., H, W], uv [..., H/2, W]) -> resized planes. NEAREST is two
    gathers a plane; the others are an NV12Resize."""
    if resize_type != ResizeType.NEAREST:
        return NV12Resize(src_w, src_h, dst_w, dst_h, resize_type)
    tables = nearest_tables(src_w, src_h, dst_w, dst_h)
    on_device = {}

    def fn(y, uv):
        key = str(y.device)
        on = on_device.get(key)
        if on is None:
            on = [torch.as_tensor(t, device=y.device) for t in tables]
            # A trace (torch.export) makes fake tables: they stay in it.
            if not torch.compiler.is_compiling():
                on_device[key] = on
        rows, cols, uv_rows, uv_cols = on
        return _take(y, rows, cols), _take(uv, uv_rows, uv_cols)

    return fn
