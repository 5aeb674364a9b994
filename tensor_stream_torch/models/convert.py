"""Weights from the JAX package's flax models into the port's modules.

Each converter takes a flax parameter tree as nested dicts of numpy
arrays (``{"params": {...}}`` or the inner dict) and returns the port
model's ``state_dict`` (f32 CPU tensors; ``load_state_dict`` copies them
to the device):

* ``vit_state_dict_from_flax``: ``VideoViT``, both block kinds
  (``ln_s/attn_s/ln_t/attn_t/ln_m/mlp`` and ``ln_a/attn/ln_m/mlp``),
  ``tubelet``, ``pos_spatial``, ``pos_temporal``, ``ln_f`` and ``head``;
* ``dit_state_dict_from_flax``: ``VideoDiT`` (both conditionings; adaLN's
  blocks hold ``adaLN``, ``attn_s``, ``attn_t``, ``fc1``, ``fc2``), its
  ``time_mlp1/2`` and ``label_embed``;
* ``moe_state_dict_from_flax``: ``VideoMoE`` (``moe.router`` and the
  stacked ``w1``, ``b1``, ``w2``, ``b2``, kept in flax's (e, ...) layout);
* ``pp_params_from_flax``: the pipeline's (outer, stage) trees of
  ``init_pp_params`` (flax's stage leaves stacked [S, L, ...]) -> the
  port's ``parallel.init_pp_params`` dicts, each block converted as
  ``vit_state_dict_from_flax`` converts it;
* ``vae_state_dict_from_flax`` and ``transformer_net_state_dict_from_flax``:
  the convolutional models, whose flax submodules have automatic names
  (``CausalConv3D_0``, ``ResBlock_1``, ``GroupNorm_0``, ``ConvLayer_3``,
  ...). They map in their order of creation to the port's lists
  (``convs.0``, ``blocks.1``, ``norms.0``, ...), and a ``Conv_0`` inside
  a conv wrapper holds the wrapper's own weight and bias.

Layouts:

* Dense kernel ``(in, out)`` -> Linear weight ``(out, in)``;
* DenseGeneral ``query/key/value`` kernel ``(D, H, dh)`` -> ``(H*dh, D)``,
  bias ``(H, dh)`` -> ``(H*dh,)``;
* ``out`` kernel ``(H, dh, D)`` -> ``(D, H*dh)``;
* Conv kernel ``(t, p, p, C, D)`` -> the patch matrix ``(D, t*p*p*C)``,
  in the patch order of ``tubelet_embed``;
* Conv kernel ``(kt, kh, kw, in, out)`` or ``(kh, kw, in, out)`` of the
  convolutional models -> ``(out, in, kt, kh, kw)`` or ``(out, in, kh, kw)``;
* LayerNorm, GroupNorm and InstanceNorm ``scale`` -> ``weight``;
* ``Embed.embedding`` -> ``weight``.

This module imports neither jax nor flax.
"""
import re

import numpy as np
import torch


def _kernel_to_weight(name, kernel):
    if name == "out":                       # (H, dh, D)
        return kernel.reshape(-1, kernel.shape[-1]).T
    if kernel.ndim == 3:                    # query/key/value (D, H, dh)
        return kernel.reshape(kernel.shape[0], -1).T
    return kernel.reshape(-1, kernel.shape[-1]).T   # Dense, Conv


def _module(name, leaves, prefix, out):
    for key, value in leaves.items():
        if isinstance(value, dict):
            sub = f"blocks.{key[5:]}" if key.startswith("block") else key
            _module(key, value, f"{prefix}{sub}.", out)
            continue
        arr = np.asarray(value, dtype=np.float32)
        if key == "kernel":
            out[f"{prefix}weight"] = _kernel_to_weight(name, arr)
        elif key in ("scale", "embedding"):
            out[f"{prefix}weight"] = arr
        elif key == "bias":
            out[f"{prefix}bias"] = arr.reshape(-1)
        else:                   # pos_spatial, pos_temporal; MoE w1, b1, ...
            out[f"{prefix}{key}"] = arr


def _tensors(out):
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in out.items()}


def _inner(params):
    return params["params"] if "params" in params else params


def vit_state_dict_from_flax(params) -> dict:
    """flax VideoViT params (numpy leaves) -> the port's state_dict."""
    out = {}
    _module("", _inner(params), "", out)
    return _tensors(out)


def dit_state_dict_from_flax(params) -> dict:
    """flax VideoDiT params -> the port's ``VideoDiT`` state_dict."""
    return vit_state_dict_from_flax(params)


def moe_state_dict_from_flax(params) -> dict:
    """flax VideoMoE params -> the port's ``VideoMoE`` state_dict."""
    return vit_state_dict_from_flax(params)


def _leaf_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _leaf_map(fn, v) for k, v in tree.items()}
    return fn(np.asarray(tree))


def pp_params_from_flax(outer, stage):
    """The JAX ``init_pp_params`` trees -> (outer, stage) as the port's
    ``parallel.init_pp_params`` returns them: outer {name: tensor} of the
    embedding and head, stage {block-relative name: [S, L, ...] tensor}."""
    inner = _inner(stage)
    first = inner
    while isinstance(first, dict):
        first = next(iter(first.values()))
    n_stages, per = np.asarray(first).shape[:2]
    blocks = [[vit_state_dict_from_flax(
        {"block0": _leaf_map(lambda x: x[s, i], inner)})
        for i in range(per)] for s in range(n_stages)]
    prefix = len("blocks.0.")
    stacked = {name[prefix:]: torch.stack([torch.stack(
        [blocks[s][i][name] for i in range(per)]) for s in range(n_stages)])
        for name in blocks[0][0]}
    return vit_state_dict_from_flax(outer), stacked


_AUTO_NAME = re.compile(r"^(\w+)_(\d+)$")


def _conv_module(leaves, names, prefix, out):
    for key, value in leaves.items():
        if isinstance(value, dict):
            auto = _AUTO_NAME.match(key)
            if key == "Conv_0":             # the wrapper's own conv
                sub = prefix
            elif auto and auto.group(1) in names:
                sub = f"{prefix}{names[auto.group(1)]}.{auto.group(2)}."
            else:
                sub = f"{prefix}{key}."
            _conv_module(value, names, sub, out)
            continue
        arr = np.asarray(value, dtype=np.float32)
        if key == "kernel":                 # (..., in, out) -> (out, in, ...)
            out[f"{prefix}weight"] = np.moveaxis(arr, (-1, -2), (0, 1))
        elif key == "scale":
            out[f"{prefix}weight"] = arr
        else:
            out[f"{prefix}{key}"] = arr


def vae_state_dict_from_flax(params) -> dict:
    """flax VideoVAE params -> the port's ``VideoVAE`` state_dict."""
    out = {}
    _conv_module(_inner(params), {"CausalConv3D": "convs",
                                  "ResBlock": "blocks",
                                  "GroupNorm": "norms"}, "", out)
    return _tensors(out)


def transformer_net_state_dict_from_flax(params) -> dict:
    """flax TransformerNet params -> the port's ``TransformerNet``
    state_dict."""
    out = {}
    _conv_module(_inner(params), {"ConvLayer": "convs",
                                  "InstanceNorm": "norms",
                                  "ResidualBlock": "blocks",
                                  "UpsampleConvLayer": "ups"}, "", out)
    return _tensors(out)
