"""The ViT blocks' LayerNorm seams and MLP activation: the wrappers of the
CUDA kernels ``csrc/block_fusions.cu`` and their plain torch versions.

The kernels replace the XLA fusions (not Pallas kernels) of the JAX
package's ViT blocks (its ``models/video_vit.py``): a
LayerNorm with the ``astype(compute_dtype)`` after it and, where a
sublayer's output joins the residual stream just before it, that
sublayer's Dense bias and the residual add (``:263-278``, ``:309-319``);
and fc1's bias with the tanh GELU after it (``:205``).

Operators (``ops/_library.py``: CUDA kernel, CPU plain version, fake):

* ``ts::ln_cast(x, weight, bias, eps, dtype) -> (h, mean, rstd)``:
  h = dtype(LayerNorm_f32(f32(x))), mean and rstd f32 of x's leading
  shape;
* ``ts::ln_cast.residual(x, y, y_bias, weight, bias, eps) -> (x', h,
  mean, rstd)``: x' = x + (y + y_bias in y's dtype) in x's dtype, h =
  LayerNorm of x' in y's dtype. y may be a strided view (the temporal
  sublayer's transposed output), read at its strides;
* ``ts::ln_cast_bwd(dh, x, mean, rstd, weight) -> (dx, dweight, dbias)``
  and ``ts::ln_cast_bwd.residual(dh, dx', x', mean, rstd, weight) -> (dx,
  dweight, dbias, dy_bias)``: dx in x's dtype (with the residual, the
  stream's incoming gradient dx' added; dy is dx in y's dtype), the column
  sums in f32, summed in a fixed order;
* ``ts::bias_gelu(y, bias) -> g``: gelu_tanh(y + bias in y's dtype), in
  y's dtype; ``ts::bias_gelu_bwd(dg, y, bias) -> (dy, dbias)``, the
  pre-activation recomputed from y and bias.

The plain versions are the port's unfused op sequence (``F.layer_norm``,
``F.gelu``, the adds and casts, and for the backward the ATen backward
ops autograd runs on it), so on the CPU the model computes what it did
before these operators, bit for bit. Parameters are f32; x and y bf16 or
f32.

``ln_cast``, ``add_ln_cast`` and ``bias_gelu`` are differentiable: with
grad enabled and an input that requires grad they run through
``torch.autograd.Function``s whose backward calls the backward operator.
Each launch of a kernel adds one to its entry of ``launches`` ("ln_cast",
"ln_cast_bwd", "bias_gelu", "bias_gelu_bwd"); a forward launched while a
checkpointed block is recomputed (``_library.recomputing()``) also adds
one to its entry of ``recompute_launches``. ``grad_copies`` counts the
gradients the backward made contiguous because autograd handed it rows the
kernel cannot read (a non-contiguous last dim or unaligned strides).
"""
import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from .._device import kernel_device, stream_handle
from . import _library

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
KERNELS = ("ln_cast", "ln_cast_bwd", "bias_gelu", "bias_gelu_bwd")
MAX_DIM = 1024  # ts::ln_cast: D a multiple of 8, at most 32 lanes x 32
GELU_MAX_DIM = 1 << 30  # ts::bias_gelu: N a multiple of 8 (int column indices)
LN_TILE = 8  # ts::ln_cast_bwd: rows a tile, one a warp (csrc kTile)
LN_THREADS = 256  # threads a block of LnCast and LnCastBwd (kLnThreads)
LN_FWD_BLOCKS_PER_SM = 3  # kFwdBlocksPerSm
LN_BWD_BLOCKS_PER_SM = 2  # kBwdBlocksPerSm

launches = dict.fromkeys(KERNELS, 0)
recompute_launches = dict.fromkeys(("ln_cast", "bias_gelu"), 0)
grad_copies = 0

_LIB = None
_ROWS = {}  # (rows, D) -> the row layout of a contiguous tensor
_GROUPS = {}  # (entry, rows) -> the backward's row groups


def reset_counts():
    global grad_copies
    grad_copies = 0
    for k in KERNELS:
        launches[k] = 0
    for k in recompute_launches:
        recompute_launches[k] = 0


def _lib():
    global _LIB
    if _LIB is None:
        lib = _build.load("block_fusions")
        v, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.ts_ln_cast.argtypes = ([v, v, i, v, v, v, v, v, v, v, i, v, v,
                                    ll, i, f, v])
        lib.ts_ln_cast_bwd.argtypes = ([v] * 6 + [i, i] + [v] * 8
                                       + [i, ll, i, v])
        lib.ts_bias_gelu.argtypes = [v, v, v, i, ll, i, v]
        lib.ts_bias_gelu_bwd.argtypes = [v] * 6 + [i, ll, i, v]
        for name in ("ts_ln_cast_bwd_groups", "ts_bias_gelu_bwd_groups",
                     "ts_ln_cast_ring"):
            getattr(lib, name).argtypes = [ll]
        for name in ("ts_ln_cast", "ts_ln_cast_bwd", "ts_bias_gelu",
                     "ts_bias_gelu_bwd", "ts_ln_cast_bwd_groups",
                     "ts_bias_gelu_bwd_groups", "ts_ln_cast_ring"):
            getattr(lib, name).restype = i
        _LIB = lib
    return _LIB


# ------------------------------------------------------------ plain versions

def ln_cast_plain(x, weight, bias, eps, dtype, y=None, y_bias=None):
    """The unfused sequence: with y, t = y + y_bias.to(y.dtype) and x' = x +
    t.to(x.dtype) (else x' = x); out, mean, rstd = native_layer_norm(
    x'.float()) (what ``F.layer_norm`` runs); h = out.to(dtype) (y's
    dtype with y). Returns (x' or None, h, mean, rstd), mean and rstd of
    x's leading shape."""
    xp = None
    if y is not None:
        xp = x + (y + y_bias.to(y.dtype)).to(x.dtype)
        dtype = y.dtype
    src = x if xp is None else xp
    out, mean, rstd = torch.native_layer_norm(src.float(), (src.shape[-1],),
                                              weight, bias, eps)
    return xp, out.to(dtype), mean.squeeze(-1), rstd.squeeze(-1)


def ln_cast_bwd_plain(dh, x, mean, rstd, weight, dres=None,
                      y_dtype=None):
    """What autograd runs on ``ln_cast_plain``: native_layer_norm_backward
    of f32(dh) (dweight, dbias), its dx cast to x's dtype; with the
    residual (``y_dtype`` given) the stream's gradient ``dres`` (or none)
    added, dy = dx in y_dtype and dy_bias = dy summed to the bias's shape
    in y_dtype, then f32. Returns (dx, dweight, dbias[, dy_bias])."""
    d = x.shape[-1]
    # The backward reads the LayerNorm bias for its shape alone: weight's.
    dxf, dweight, dbias = torch.ops.aten.native_layer_norm_backward(
        dh.float(), x.float(), [d], mean.unsqueeze(-1), rstd.unsqueeze(-1),
        weight, weight, [True, True, True])
    dx = dxf.to(x.dtype)
    if y_dtype is None:
        return dx, dweight, dbias
    if dres is not None:
        dx = dres + dx
    dy_bias = dx.to(y_dtype).sum_to_size(d).float()
    return dx, dweight, dbias, dy_bias


def bias_gelu_plain(y, bias):
    """gelu_tanh(y + bias.to(y.dtype)) in y's dtype (``MLP``'s fc1 bias and
    activation, unfused)."""
    return F.gelu(y + bias.to(y.dtype), approximate="tanh")


def bias_gelu_bwd_plain(dg, y, bias):
    """What autograd runs on ``bias_gelu_plain``: dy = gelu_backward(dg, u)
    on the recomputed pre-activation u, dbias = dy summed to the bias's
    shape in y's dtype, then f32. Returns (dy, dbias)."""
    u = y + bias.to(y.dtype)
    dy = torch.ops.aten.gelu_backward(dg, u, approximate="tanh")
    return dy, dy.sum_to_size(bias.shape).float()


# ------------------------------------------------------------ launch plans

def ln_fwd_plan(rows, sms):
    """The plan ``ts::ln_cast`` runs `rows` on (``LnFwdRing``, which the
    library's ``ts_ln_cast_ring`` answers): "ring" (``LnCast``: a
    persistent grid of LN_FWD_BLOCKS_PER_SM blocks of 8 warps an SM, rows
    streamed by bulk copies through a ring a warp) where a warp of that
    grid has more than one row, else "wave" (``LnCastWave``: a warp a row,
    every row in one wave)."""
    return "ring" if rows > sms * LN_FWD_BLOCKS_PER_SM * 8 else "wave"


def ln_bwd_blocks(rows, sms):
    """The grid of ``ts::ln_cast_bwd`` (``LnBwdBlocks``, which the
    library's ``ts_ln_cast_bwd_groups`` returns): a block a tile of
    LN_TILE rows, at most LN_BWD_BLOCKS_PER_SM blocks an SM; one partial
    row of column sums a block."""
    return min(-(-rows // LN_TILE), sms * LN_BWD_BLOCKS_PER_SM)


def ln_bwd_plan(rows, blocks, stages=2):
    """The rows ``LnCastBwd`` gives each of its `blocks` blocks, in the
    order the block walks them: block g takes rows [g R / G, (g + 1) R /
    G) (R rows, G blocks) in tiles of up to LN_TILE consecutive rows, tile
    t into ring slot t mod `stages`. Returns a list a block of (slot,
    range of rows) a tile."""
    plan = []
    for g in range(blocks):
        r0, r1 = rows * g // blocks, rows * (g + 1) // blocks
        plan.append([(t % stages, range(a, min(a + LN_TILE, r1)))
                     for t, a in enumerate(range(r0, r1, LN_TILE))])
    return plan


def ln_bwd_subsets(d):
    """(chunks, subsets) of ``LnCastBwd``'s column phase: thread t owns
    the 8 columns 8 (t mod chunks) of the tile's rows t div chunks + k
    subsets; threads past chunks x subsets sum nothing."""
    chunks = d // 8
    return chunks, LN_THREADS // chunks


# ------------------------------------------------------------ CUDA wrappers

def _rows(t, name):
    """(n1, n2, s0, s1, s2) of t's leading dims as the kernels address
    rows (at most three, after merging dims contiguous with each other);
    raises where the kernel cannot read t's rows with 16-byte loads."""
    step = 16 // t.element_size()
    if t.is_contiguous():  # the common case, one row stride
        d = t.shape[-1]
        if t.data_ptr() % 16 == 0 and d % step == 0:
            key = (t.numel() // d, d)
            rows = _ROWS.get(key)
            if rows is None:  # read only by the kernels: shared
                rows = _ROWS[key] = (ctypes.c_longlong * 5)(1, key[0], 0,
                                                            0, d)
            return rows
    if (t.stride(-1) != 1 or t.data_ptr() % 16
            or any(s % step for s in t.stride()[:-1])):
        raise ValueError(f"{name}: the last dim must be contiguous and the "
                         f"base and row strides {t.stride()[:-1]} 16-byte "
                         f"aligned (multiples of {step} elements)")
    sizes, strides = list(t.shape[:-1]), list(t.stride()[:-1])
    i = 0
    while len(sizes) > 3 and i < len(sizes) - 1:
        if strides[i] == sizes[i + 1] * strides[i + 1]:
            sizes[i:i + 2] = [sizes[i] * sizes[i + 1]]
            strides[i:i + 2] = [strides[i + 1]]
        else:
            i += 1
    if len(sizes) > 3:
        raise ValueError(f"{name}: leading dims {tuple(t.shape[:-1])} at "
                         f"strides {t.stride()[:-1]} do not merge into 3")
    sizes = [1] * (3 - len(sizes)) + sizes
    strides = [0] * (3 - len(strides)) + strides
    return (ctypes.c_longlong * 5)(sizes[1], sizes[2], *strides)


def _check(x, params, others=(), max_dim=MAX_DIM):
    """Device, dtype and width checks of the kernels; returns D."""
    _library.on_one_device(x, *params, *others, cuda=True)
    d = x.shape[-1]
    if d % 8 or not 0 < d <= max_dim:
        raise ValueError(f"the kernel takes a last dim that is a multiple "
                         f"of 8 up to {max_dim}, got {d}")
    for t in (x, *others):
        if t.dtype not in _DTYPES:
            raise TypeError(f"the kernel takes bf16 or f32, got {t.dtype}")
    for p in params:
        if (p.dtype != torch.float32 or p.shape != (d,)
                or not p.is_contiguous() or p.data_ptr() % 16):
            raise ValueError(f"parameters must be contiguous f32 [{d}], got "
                             f"{p.dtype} {tuple(p.shape)}")
    return d


def _stream(t):
    return stream_handle(t.device)


def _groups(entry, rows):
    """The row groups of a backward's column-sum partials (the library's
    ``ts_*_bwd_groups``), once for each row count."""
    key = (entry, rows)
    groups = _GROUPS.get(key)
    if groups is None:
        groups = _GROUPS[key] = getattr(_lib(), entry)(rows)
    return groups


def _count(kernel, rc):
    if rc != 0:
        raise RuntimeError(f"ts_{kernel} launch failed: cudaError {rc}")
    launches[kernel] += 1
    if kernel in recompute_launches and _library.in_recompute():
        recompute_launches[kernel] += 1


def _ln_cast_cuda(x, weight, bias, eps, dtype, y=None, y_bias=None):
    params = (weight, bias) + (() if y is None else (y_bias,))
    d = _check(x, params, () if y is None else (y,))
    if y is not None:
        if y.shape != x.shape:
            raise ValueError(f"y {tuple(y.shape)} must have x's shape "
                             f"{tuple(x.shape)}")
        dtype = y.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"the kernel writes bf16 or f32, not {dtype}")
    lead = x.shape[:-1]
    xp = None if y is None else torch.empty(x.shape, dtype=x.dtype,
                                            device=x.device)
    h = torch.empty(x.shape, dtype=dtype, device=x.device)
    mean = torch.empty(lead, dtype=torch.float32, device=x.device)
    rstd = torch.empty(lead, dtype=torch.float32, device=x.device)
    rows = mean.numel()
    if rows:
        with kernel_device(x.device):
            rc = _lib().ts_ln_cast(
                x.data_ptr(), _rows(x, "x"), _DTYPES[x.dtype],
                None if y is None else y.data_ptr(),
                None if y is None else _rows(y, "y"),
                None if y is None else y_bias.data_ptr(), weight.data_ptr(),
                bias.data_ptr(), None if y is None else xp.data_ptr(),
                h.data_ptr(), _DTYPES[dtype], mean.data_ptr(),
                rstd.data_ptr(), rows, d, eps, _stream(x))
        _count("ln_cast", rc)
    return xp, h, mean, rstd


def _ln_cast_bwd_cuda(dh, x, mean, rstd, weight, dres=None, residual=False):
    others = (dh, mean, rstd) + (() if dres is None else (dres,))
    d = _check(x, (weight,), others)
    for name, t in (("dh", dh), ("dres", dres)):
        if t is not None and t.shape != x.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must have x's shape "
                             f"{tuple(x.shape)}")
    if dres is not None and dres.dtype != x.dtype:
        raise TypeError(f"dres must be {x.dtype}, got {dres.dtype}")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if (t.dtype != torch.float32 or t.shape != x.shape[:-1]
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous f32 tensor of "
                             f"x's leading shape")
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = mean.numel()
    sums = [(torch.empty if rows else torch.zeros)(
        d, dtype=torch.float32, device=x.device)
        for _ in range(3 if residual else 2)]
    if rows:
        with kernel_device(x.device):
            partial = torch.empty(
                3 * _groups("ts_ln_cast_bwd_groups", rows) * d,
                dtype=torch.float32, device=x.device)
            rc = _lib().ts_ln_cast_bwd(
                dh.data_ptr(), _rows(dh, "dh"),
                None if dres is None else dres.data_ptr(),
                None if dres is None else _rows(dres, "dres"),
                x.data_ptr(), _rows(x, "x"), _DTYPES[x.dtype],
                _DTYPES[dh.dtype], mean.data_ptr(), rstd.data_ptr(),
                weight.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                *[t.data_ptr() for t in sums],
                *([None] if not residual else []), int(residual), rows, d,
                _stream(x))
        _count("ln_cast_bwd", rc)
    return (dx, *sums)


def _bias_gelu_cuda(y, bias):
    d = _check(y, (bias,), max_dim=GELU_MAX_DIM)
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    g = torch.empty_like(y, memory_format=torch.contiguous_format)
    rows = y.numel() // d if d else 0
    if rows:
        with kernel_device(y.device):
            rc = _lib().ts_bias_gelu(y.data_ptr(), bias.data_ptr(),
                                     g.data_ptr(), _DTYPES[y.dtype], rows, d,
                                     _stream(y))
        _count("bias_gelu", rc)
    return g


def _bias_gelu_bwd_cuda(dg, y, bias):
    d = _check(y, (bias,), (dg,), max_dim=GELU_MAX_DIM)
    if dg.shape != y.shape or dg.dtype != y.dtype:
        raise ValueError(f"dg {dg.dtype} {tuple(dg.shape)} must match y "
                         f"{y.dtype} {tuple(y.shape)}")
    if not (y.is_contiguous() and dg.is_contiguous()):
        raise ValueError("dg and y must be contiguous")
    dy = torch.empty_like(y, memory_format=torch.contiguous_format)
    rows = y.numel() // d
    dbias = (torch.empty if rows else torch.zeros)(d, dtype=torch.float32,
                                                   device=y.device)
    if rows:
        partial = torch.empty(_groups("ts_bias_gelu_bwd_groups", rows) * d,
                              dtype=torch.float32, device=y.device)
        with kernel_device(y.device):
            rc = _lib().ts_bias_gelu_bwd(dg.data_ptr(), y.data_ptr(),
                                      bias.data_ptr(), dy.data_ptr(),
                                      partial.data_ptr(), dbias.data_ptr(),
                                      _DTYPES[y.dtype], rows, d, _stream(y))
        _count("bias_gelu_bwd", rc)
    return dy, dbias


# ------------------------------------------------------------ operators

def _contiguous(*tensors):
    """Each tensor as the CPU kernels return it: contiguous (the fakes'
    strides, which an exported program holds the op to)."""
    return tuple(None if t is None else t.contiguous() for t in tensors)


def _lead(x):
    return x.new_empty(x.shape[:-1], dtype=torch.float32)


def _vec(x):
    return x.new_empty(x.shape[-1:], dtype=torch.float32)


_LN = _library.define(
    "ln_cast(Tensor x, Tensor weight, Tensor bias, float eps, "
    "ScalarType dtype) -> (Tensor, Tensor, Tensor)",
    cuda=lambda x, w, b, eps, dtype: _ln_cast_cuda(x, w, b, eps, dtype)[1:],
    cpu=lambda x, w, b, eps, dtype: _contiguous(
        *ln_cast_plain(x, w, b, eps, dtype)[1:]),
    fake=lambda x, w, b, eps, dtype: (
        torch.empty_like(x, dtype=dtype,
                         memory_format=torch.contiguous_format),
        _lead(x), _lead(x)))
_LN_RES = _library.define(
    "ln_cast.residual(Tensor x, Tensor y, Tensor y_bias, Tensor weight, "
    "Tensor bias, float eps) -> (Tensor, Tensor, Tensor, Tensor)",
    cuda=lambda x, y, yb, w, b, eps: _ln_cast_cuda(x, w, b, eps, None, y,
                                                   yb),
    cpu=lambda x, y, yb, w, b, eps: _contiguous(
        *ln_cast_plain(x, w, b, eps, None, y, yb)),
    fake=lambda x, y, yb, w, b, eps: (
        torch.empty_like(x, memory_format=torch.contiguous_format),
        torch.empty_like(x, dtype=y.dtype,
                         memory_format=torch.contiguous_format),
        _lead(x), _lead(x)))
_LN_BWD = _library.define(
    "ln_cast_bwd(Tensor dh, Tensor x, Tensor mean, Tensor rstd, "
    "Tensor weight) -> (Tensor, Tensor, Tensor)",
    cuda=lambda dh, x, mean, rstd, w: _ln_cast_bwd_cuda(dh, x, mean, rstd,
                                                        w),
    cpu=lambda dh, x, mean, rstd, w: _contiguous(
        *ln_cast_bwd_plain(dh, x, mean, rstd, w)),
    fake=lambda dh, x, mean, rstd, w: (
        torch.empty_like(x, memory_format=torch.contiguous_format),
        _vec(x), _vec(x)))
_LN_RES_BWD = _library.define(
    "ln_cast_bwd.residual(Tensor dh, Tensor dres, Tensor x, Tensor mean, "
    "Tensor rstd, Tensor weight) -> (Tensor, Tensor, Tensor, Tensor)",
    cuda=lambda dh, dres, x, mean, rstd, w: _ln_cast_bwd_cuda(
        dh, x, mean, rstd, w, dres, True),
    cpu=lambda dh, dres, x, mean, rstd, w: _contiguous(
        *ln_cast_bwd_plain(dh, x, mean, rstd, w, dres, dh.dtype)),
    fake=lambda dh, dres, x, mean, rstd, w: (
        torch.empty_like(x, memory_format=torch.contiguous_format),
        _vec(x), _vec(x), _vec(x)))
_GELU = _library.define(
    "bias_gelu(Tensor y, Tensor bias) -> Tensor",
    cuda=_bias_gelu_cuda,
    cpu=lambda y, b: bias_gelu_plain(y, b).contiguous(),
    fake=lambda y, b: torch.empty_like(
        y, memory_format=torch.contiguous_format))
_GELU_BWD = _library.define(
    "bias_gelu_bwd(Tensor dg, Tensor y, Tensor bias) -> (Tensor, Tensor)",
    cuda=_bias_gelu_bwd_cuda,
    cpu=lambda dg, y, b: _contiguous(*bias_gelu_bwd_plain(dg, y, b)),
    fake=lambda dg, y, b: (
        torch.empty_like(y, memory_format=torch.contiguous_format), _vec(y)))


# ------------------------------------------------------------ autograd

def _readable(t):
    """t, or a contiguous copy where the kernels cannot read its rows
    (counted in ``grad_copies``); CPU tensors as they are."""
    global grad_copies
    if t.device.type != "cuda":
        return t
    if (type(t) is torch.Tensor and t.is_contiguous()
            and t.data_ptr() % 16 == 0):
        return t  # rows of D, a multiple of 8: readable (_check)
    try:
        _rows(t.to_local() if hasattr(t, "to_local") else t, "t")
    except ValueError:
        grad_copies += 1
        return t.contiguous()
    return t


class _LnCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, dtype):
        h, mean, rstd = _LN(x, weight, bias, eps, dtype)
        ctx.save_for_backward(x, mean, rstd, weight)
        return h

    @staticmethod
    def backward(ctx, dh):
        x, mean, rstd, weight = ctx.saved_tensors
        dx, dweight, dbias = _LN_BWD(_readable(dh), x, mean, rstd, weight)
        return dx, dweight, dbias, None, None


class _AddLnCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, y_bias, weight, bias, eps):
        xp, h, mean, rstd = _LN_RES(x, y, y_bias, weight, bias, eps)
        ctx.save_for_backward(xp, mean, rstd, weight)
        ctx.y_dtype = y.dtype
        return xp, h

    @staticmethod
    def backward(ctx, dxp, dh):
        xp, mean, rstd, weight = ctx.saved_tensors
        dx, dweight, dbias, dy_bias = _LN_RES_BWD(
            _readable(dh), _readable(dxp), xp, mean, rstd, weight)
        return (dx, dx.to(ctx.y_dtype), dy_bias, dweight, dbias, None)


class _BiasGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, bias):
        ctx.save_for_backward(y, bias)
        return _GELU(y, bias)

    @staticmethod
    def backward(ctx, dg):
        y, bias = ctx.saved_tensors
        if dg.device.type == "cuda" and not dg.is_contiguous():
            global grad_copies
            grad_copies += 1
            dg = dg.contiguous()
        return _GELU_BWD(dg, y, bias)


def _grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def ln_cast(x, weight, bias, dtype, eps):
    """LayerNorm of x's last dim in f32 (``weight``, ``bias`` f32), cast
    to ``dtype``: ``ts::ln_cast``'s h."""
    if _grad(x, weight, bias):
        return _LnCast.apply(x, weight, bias, eps, dtype)
    return _LN(x, weight, bias, eps, dtype)[0]


def add_ln_cast(x, y, y_bias, weight, bias, eps):
    """(x', h): the residual add x' = x + (y + y_bias in y's dtype) in x's
    dtype, and h = LayerNorm(x') in y's dtype (``ts::ln_cast.residual``);
    y may be a strided view."""
    if _grad(x, y, y_bias, weight, bias):
        return _AddLnCast.apply(x, y, y_bias, weight, bias, eps)
    return tuple(_LN_RES(x, y, y_bias, weight, bias, eps)[:2])


def bias_gelu(y, bias):
    """gelu_tanh(y + bias in y's dtype), in y's dtype (``ts::bias_gelu``)."""
    if _grad(y, bias):
        return _BiasGelu.apply(y, bias)
    return _GELU(y, bias)
