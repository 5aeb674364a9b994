"""NV12-domain crop (port of the JAX package's ``ops/crop.py``).

The reference CUDA crop kernel (src/Crop.cu:4-48) reduces to two plane
slices:
  Y'  = Y [top : top+h,       left : left+w]
  UV' = UV[top/2 : top/2+h/2, left : left+w]
Works on any leading batch dims; the slices are views.
"""


def crop_nv12(y, uv, left: int, top: int, right: int, bottom: int):
    """Crops tightly packed NV12 planes; box is (left, top, right, bottom)."""
    w = right - left
    h = bottom - top
    y_out = y[..., top:top + h, left:left + w]
    uv_out = uv[..., top // 2: top // 2 + h // 2, left:left + w]
    return y_out, uv_out
