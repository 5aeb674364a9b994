"""Weight-only int8 quantization of a model's ``state_dict``.

Port of the JAX package's ``models/quantize.py``. Matmul and conv weights
are stored as int8 with f32 scales per OUTPUT channel (scale = max|w| /
127, round half to even as ``jnp.round``, clip to ±127); everything else
passes through. Serving dequantizes inside its graphed call:

    qstate = quantize_weights(model)
    serve = cuda_graph(lambda x: functional_call(
        model, dequantize_weights(qstate), (x,)))

so the int8 tensors are what lives on the card, as they are what lives in
HBM under the reference's ``jit``.

Which leaves, and which axes, are the reference's:

* quantized: what flax calls ``kernel`` (the port's ``weight`` of two or
  more dims, except an ``nn.Embedding``'s table) and the MoE stacks
  ``w1``/``w2``, if floating and of at least ``min_size`` elements; never
  embeddings, positional tables, biases or norm weights;
* the output channel is flax's last kernel axis, which is axis 0 of the
  port's [out, in] Linear and [out, in, k...] conv weights: their scale
  has shape [out, 1, ...];
* attention's query/key/value kernels are flax ``(D, H, dh)``, whose scale
  is taken over D and H: one per dh, SHARED across heads. The port's
  ``(H*dh, D)`` weight keeps that scale, shape ``(1, dh, 1)`` against the
  weight viewed as ``(H, dh, D)``;
* MoE ``w1``/``w2`` keep flax's ``(e, d, f)`` layout, so their scale is
  taken over every axis but the last and shared across experts.

A record is ``{"q": int8 tensor in the weight's shape, "scale": f32}``.
"""
import numpy as np
import torch
from torch import nn

from .video_vit import MHA


def _is_record(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale"}


def _kernels(model: nn.Module) -> dict:
    """name -> (the view of the weight its scale is taken over, the dims
    reduced), for every leaf of the state_dict that the reference would
    quantize (``min_size`` aside)."""
    heads, embeds = {}, set()
    for prefix, mod in model.named_modules():
        dot = f"{prefix}." if prefix else ""
        if isinstance(mod, MHA):
            for proj, h in (("query", mod.num_heads), ("key", mod.kv_heads),
                            ("value", mod.kv_heads)):
                heads[f"{dot}{proj}.weight"] = (h, mod.head_dim)
        elif isinstance(mod, nn.Embedding):
            embeds.add(f"{dot}weight")
    out = {}
    for name, p in model.state_dict().items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("w1", "w2"):
            out[name] = (tuple(p.shape), tuple(range(p.ndim - 1)))
        elif leaf == "weight" and p.ndim >= 2 and name not in embeds:
            if name in heads:
                h, dh = heads[name]
                out[name] = ((h, dh, p.shape[1]), (0, 2))
            else:
                out[name] = (tuple(p.shape), tuple(range(1, p.ndim)))
    return out


def quantize_weights(model: nn.Module, min_size: int = 256) -> dict:
    """`model`'s state_dict with int8 records in place of its matmul and
    conv weights (see the module's docstring); other leaves are the
    state_dict's own tensors."""
    kernels = _kernels(model)
    out = {}
    for name, p in model.state_dict().items():
        if (name not in kernels or not p.is_floating_point()
                or p.numel() < min_size):
            out[name] = p
            continue
        view, dims = kernels[name]
        w = p.detach().float().reshape(view)
        scale = w.abs().amax(dim=dims, keepdim=True) / 127.0
        scale = torch.where(scale == 0, torch.ones_like(scale), scale)
        q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        out[name] = {"q": q.reshape(p.shape), "scale": scale}
    return out


def _dequantize(record, dtype):
    q, scale = record["q"], record["scale"]
    w = q.float()
    if scale.ndim != q.ndim:    # query/key/value: q as (H, dh, D)
        w = w.view(-1, scale.shape[1], q.shape[-1])
    return (w * scale).reshape(q.shape).to(dtype)


def dequantize_weights(qstate: dict, dtype=torch.float32) -> dict:
    """A state_dict for ``load_state_dict`` or ``functional_call``: each
    record as q * scale in `dtype`, other leaves as they are."""
    return {k: _dequantize(v, dtype) if _is_record(v) else v
            for k, v in qstate.items()}


def quantized_bytes(state: dict) -> int:
    """The parameter bytes of a (possibly quantized) state."""
    return int(sum(t.numel() * t.element_size()
                   for v in state.values()
                   for t in (v.values() if _is_record(v) else (v,))))


def quantization_error(state_dict: dict, qstate: dict) -> float:
    """The worst relative L2 error over the quantized leaves (f64)."""
    worst = 0.0
    for name, record in qstate.items():
        if not _is_record(record):
            continue
        w = state_dict[name].detach().double().cpu()
        r = _dequantize(record, torch.float64).cpu()
        denom = float(w.norm())
        if denom > 0:
            worst = max(worst, float((w - r).norm()) / denom)
    return worst


def qstate_from_flax(qtree, model: nn.Module, state_dict_from_flax) -> dict:
    """The reference's ``quantize_weights`` tree (numpy leaves) in the
    port's layout, through the model's converter (``models/convert.py``):
    each record's q goes where its kernel goes, and its scale into the
    shape ``quantize_weights`` gives it."""
    def leaves(tree, record, other=np.asarray):
        if _is_record(tree):
            return record(tree)
        if isinstance(tree, dict):
            return {k: leaves(v, record, other) for k, v in tree.items()}
        return other(tree)

    plain = state_dict_from_flax(leaves(qtree, lambda r: np.asarray(
        r["q"], np.float32)))
    marks = state_dict_from_flax(leaves(
        qtree, lambda r: np.ones(np.shape(r["q"]), np.float32),
        lambda x: np.zeros(np.shape(x), np.float32)))
    # Each scale broadcast to its kernel's shape goes through the same
    # layout change; one element along each reduced dim is the scale.
    scales = state_dict_from_flax(leaves(qtree, lambda r: np.broadcast_to(
        np.asarray(r["scale"], np.float32), np.shape(r["q"]))))
    kernels = _kernels(model)
    out = {}
    for name, value in plain.items():
        if not bool((marks[name] == 1).all()) or name not in kernels:
            out[name] = value
            continue
        view, dims = kernels[name]
        scale = scales[name].reshape(view)
        for d in dims:
            scale = scale.narrow(d, 0, 1)
        out[name] = {"q": value.to(torch.int8), "scale": scale.contiguous()}
    return out
