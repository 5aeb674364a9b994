"""DTensor sharding rules of the ``ts`` operators (``ops/_library.py``).

DTensor refuses an operator without a rule. Each kernel here works on
independent rows of its leading axes, so a DTensor sharded on them runs
the kernel on the rank's local shard, with no collective:

* ``ts::flash_fwd``, ``ts::flash_fwd.residuals`` and ``ts::flash_bwd``:
  batch (dim 0) or heads (dim 1) sharded, every tensor alike (GQA's fewer
  k/v heads split in the same proportion, which ``vit_param_specs``
  checks divides);
* ``ts::nv12_to_rgb`` and ``ts::resize_*_nv12``: the batch (dim 0);
* ``ts::clip_augment``: clips and their parameter rows (dim 0 of both),
  since each clip is transformed alone (the contrast mean is per clip);
* ``ts::nv12_clip_augment``: the frames of the NV12 planes and the
  parameter rows (dim 0 of all three), over the same mesh dimension, so
  that each rank holds whole clips: its share of the frames is its clips'
  frames, clip_len frames a clip (the operator refuses frames that do not
  split into its rows' clips);
* ``ts::ln_cast`` and its backward (``ops/block_fusions.py``), each
  overload: the rows (any leading dim of x, y, dh, the residual's
  gradient and the saved statistics alike), the parameters replicated, a
  sharded last dim replicated first (a LayerNorm needs its whole row);
  the backward's column sums of sharded rows are partial sums;
* ``ts::bias_gelu`` and its backward: the rows, as above, or the last dim
  with the bias sharded alike (fc1's hidden units over tp); the bias's
  gradient is partial over sharded rows and sharded with the columns.

Anything else is replicated first (DTensor redistributes to the all-
replicate strategy). Importing this module registers the rules.
"""
import torch
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from ..ops import (augment, block_fusions, flash_attention,  # noqa: F401
                   nv12_rgb, resize)


def _rules(n_out, n_tensors, n_scalars, dims):
    rules = [([Replicate()] * n_out,
              [Replicate()] * n_tensors + [None] * n_scalars)]
    for d in dims:
        rules.append(([Shard(d)] * n_out,
                      [Shard(d)] * n_tensors + [None] * n_scalars))
    return rules


@register_sharding(torch.ops.ts.flash_fwd.default)
def _flash_fwd(q, k, v, causal, window, sm_scale):
    return _rules(1, 3, 3, (0, 1))


@register_sharding(torch.ops.ts.flash_fwd.residuals)
def _flash_fwd_residuals(q, k, v, causal, window, sm_scale):
    return _rules(3, 3, 3, (0, 1))


@register_sharding(torch.ops.ts.flash_bwd.default)
def _flash_bwd(q, k, v, o, l, m, dout, causal, window, sm_scale):
    return _rules(3, 7, 3, (0, 1))


@register_sharding(torch.ops.ts.nv12_to_rgb.default)
def _nv12_to_rgb(y, uv, swap_rb, planar, normalization, standard):
    return _rules(1, 2, 4, (0,) if y.ndim > 2 else ())


def _resize(y, uv, dst_w, dst_h, resize_type):
    return _rules(2, 2, 3, (0,) if y.ndim > 2 else ())


for _name in ("resize_bilinear_nv12", "resize_bicubic_nv12",
              "resize_area_down_nv12"):
    register_sharding(getattr(torch.ops.ts, _name).default)(_resize)


@register_sharding(torch.ops.ts.clip_augment.default)
def _clip_augment(clips, params, planar, out_h, out_w, ops, mean, std, unit,
                  bgr, out_dtype):
    return _rules(1, 2, 9, (0,))


@register_sharding(torch.ops.ts.nv12_clip_augment.default)
def _nv12_clip_augment(y, uv, params, swap_rb, normalization, standard,
                       planar, out_h, out_w, ops, mean, std, unit, out_dtype):
    return _rules(1, 3, 11, (0,))


def _row_rules(ndim, outs, ins):
    """All replicated, or the rows (each leading dim d of `ndim`) sharded:
    `outs` and `ins` are per-tensor kinds, "row" (Shard(d)), "param"
    (Replicate, or Partial for an output: a sum over the rows) or None (a
    non-tensor argument)."""
    def spec(kind, d, out):
        if kind is None:
            return None
        if kind == "row":
            return Shard(d)
        return Partial() if out else Replicate()
    rules = [([Replicate()] * len(outs),
              [None if k is None else Replicate() for k in ins])]
    for d in range(ndim - 1):
        rules.append(([spec(k, d, True) for k in outs],
                      [spec(k, d, False) for k in ins]))
    return rules


@register_sharding(torch.ops.ts.ln_cast.default)
def _ln_cast(x, weight, bias, eps, dtype):
    return _row_rules(x.ndim, ["row"] * 3, ["row", "param", "param", None,
                                            None])


@register_sharding(torch.ops.ts.ln_cast.residual)
def _ln_cast_residual(x, y, y_bias, weight, bias, eps):
    return _row_rules(x.ndim, ["row"] * 4, ["row", "row"] + ["param"] * 3
                      + [None])


@register_sharding(torch.ops.ts.ln_cast_bwd.default)
def _ln_cast_bwd(dh, x, mean, rstd, weight):
    return _row_rules(x.ndim, ["row", "param", "param"], ["row"] * 4
                      + ["param"])


@register_sharding(torch.ops.ts.ln_cast_bwd.residual)
def _ln_cast_bwd_residual(dh, dres, x, mean, rstd, weight):
    return _row_rules(x.ndim, ["row"] + ["param"] * 3, ["row"] * 5
                      + ["param"])


@register_sharding(torch.ops.ts.bias_gelu.default)
def _bias_gelu(y, bias):
    last = y.ndim - 1
    return (_row_rules(y.ndim, ["row"], ["row", "param"])
            + [([Shard(last)], [Shard(last), Shard(0)])])


@register_sharding(torch.ops.ts.bias_gelu_bwd.default)
def _bias_gelu_bwd(dg, y, bias):
    last = y.ndim - 1
    return (_row_rules(y.ndim, ["row", "param"], ["row", "row", "param"])
            + [([Shard(last), Shard(0)], [Shard(last), Shard(last),
                                          Shard(0)])])
