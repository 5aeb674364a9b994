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
  split into its rows' clips).

Anything else is replicated first (DTensor redistributes to the all-
replicate strategy). Importing this module registers the rules.
"""
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from ..ops import augment, flash_attention, nv12_rgb, resize  # noqa: F401


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
