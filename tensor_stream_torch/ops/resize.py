"""NV12-domain resize on the device: NEAREST.

Port of the NEAREST path of the JAX package's ``ops/resize.py``
(reference: src/Resize.cu:245-266). Every source index depends only on
the output row or column, so the index tables are computed on the host in
the reference's float32 arithmetic and the device does two gathers per
plane.

BILINEAR, BICUBIC and AREA on the device are not ported yet (ROADMAP.md
queue 1, "device resize kernels"): they raise NotImplementedError. All
four stay available through ``host_resize=True``, the native host resize
that is bit-exact to the reference's CRCs.
"""
import numpy as np
import torch

from ..enums import ResizeType


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


def _take2(img, rows, cols):
    return img.index_select(-2, rows).index_select(-1, cols)


def make_resize_fn(src_w, src_h, dst_w, dst_h, resize_type: ResizeType):
    """(y [..., H, W], uv [..., H/2, W]) -> resized planes."""
    if resize_type != ResizeType.NEAREST:
        raise NotImplementedError(
            f"device {resize_type.name} resize is not ported yet (ROADMAP.md "
            "queue 1, 'device resize kernels'); use host_resize=True, which "
            "runs all four algorithms bit-exactly on the host")
    tables = nearest_tables(src_w, src_h, dst_w, dst_h)
    on_device = {}

    def fn(y, uv):
        key = str(y.device)
        if key not in on_device:
            on_device[key] = [torch.as_tensor(t, device=y.device)
                              for t in tables]
        rows, cols, uv_rows, uv_cols = on_device[key]
        return _take2(y, rows, cols), _take2(uv, uv_rows, uv_cols)

    return fn
