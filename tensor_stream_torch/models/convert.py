"""Weights from the JAX package's flax VideoViT into the port's VideoViT.

``vit_state_dict_from_flax(params)`` takes the flax parameter tree as
nested dicts of numpy arrays (``{"params": {...}}`` or the inner dict) and
returns the ``state_dict`` of ``models.video_vit.VideoViT``. It covers
both block kinds (``ln_s/attn_s/ln_t/attn_t/ln_m/mlp`` and
``ln_a/attn/ln_m/mlp``), ``tubelet``, ``pos_spatial``, ``pos_temporal``,
``ln_f`` and ``head``. Layouts:

* Dense kernel ``(in, out)`` -> Linear weight ``(out, in)``;
* DenseGeneral ``query/key/value`` kernel ``(D, H, dh)`` -> ``(H*dh, D)``,
  bias ``(H, dh)`` -> ``(H*dh,)``;
* ``out`` kernel ``(H, dh, D)`` -> ``(D, H*dh)``;
* Conv kernel ``(t, p, p, C, D)`` -> the patch matrix ``(D, t*p*p*C)``,
  in the patch order of ``tubelet_embed``;
* LayerNorm ``scale`` -> ``weight``.

This module imports neither jax nor flax.
"""
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
        elif key == "scale":
            out[f"{prefix}weight"] = arr
        elif key == "bias":
            out[f"{prefix}bias"] = arr.reshape(-1)
        else:                               # pos_spatial, pos_temporal
            out[f"{prefix}{key}"] = arr


def vit_state_dict_from_flax(params) -> dict:
    """flax VideoViT params (numpy leaves) -> the port's state_dict (f32
    CPU tensors; ``model.load_state_dict`` copies them to the device)."""
    if "params" in params:
        params = params["params"]
    out = {}
    _module("", params, "", out)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}
