"""The port's int8 weight quantization (tensor_stream_torch/models/
quantize.py) against the JAX package's on the CPU.

Bytes: the reference's ``quantize_weights`` tree, brought into the port's
layout by ``qstate_from_flax`` (each record through the model's own
converter), must equal the port's ``quantize_weights`` of the same
weights: every int8 byte and every f32 scale, for a VideoViT (whose
query/key/value scales are shared across heads), a class-conditional
VideoDiT (its label embedding stays f32) and a VideoMoE (whose w1/w2
scales are shared across experts). The reference's own checks
(tests/test_quantize.py) are repeated on the port: the round-trip error,
the footprint and the logits of the quantized serving forward
(``functional_call`` on the dequantized state: top-1 agreement, relative
max logit error < 0.05).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from tensor_stream_tpu.models import latent_diffusion as jld
from tensor_stream_tpu.models import moe as jmoe
from tensor_stream_tpu.models import quantize as jq
from tensor_stream_tpu.models import video_vit as jvit
from tensor_stream_torch.models import (VideoDiT, VideoMoE, VideoViT,
                                        dequantize_weights,
                                        dit_state_dict_from_flax,
                                        moe_state_dict_from_flax,
                                        quantization_error, quantize_weights,
                                        quantized_bytes,
                                        vit_state_dict_from_flax)
from tensor_stream_torch.models.quantize import qstate_from_flax

CLIP = (4, 4, 32, 32, 3)
VIT = dict(num_classes=10, depth=2, dim=64, num_heads=2, patch=8,
           tubelet_t=2)


def vit_pair(dim=64):
    cfg = {**VIT, "dim": dim}
    jm = jvit.VideoViT(compute_dtype=jnp.float32, **cfg)
    params = jvit.init_vit(jax.random.PRNGKey(0), jm, CLIP)
    params = jax.tree_util.tree_map(np.asarray, params)
    tm = VideoViT(compute_dtype=torch.float32, frames=CLIP[1], size=CLIP[2],
                  device="cpu", **cfg)
    tm.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    return jm, params, tm, vit_state_dict_from_flax


def dit_pair():
    lat = (2, 4, 8, 8, 8)
    jm = jld.VideoDiT(depth=2, dim=32, num_heads=2, num_classes=3,
                      compute_dtype=jnp.float32)
    t = jnp.zeros((2,), jnp.int32)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros(lat), t, t)
    rng = np.random.default_rng(2)
    params = jax.tree_util.tree_map(   # adaLN and head live, not zero
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)
    tm = VideoDiT(lat[1:], depth=2, dim=32, num_heads=2, num_classes=3,
                  compute_dtype=torch.float32, device="cpu")
    tm.load_state_dict(dit_state_dict_from_flax(params), strict=True)
    return jm, params, tm, dit_state_dict_from_flax


def moe_pair():
    clip = (2, 4, 16, 16, 3)
    cfg = dict(num_classes=2, num_experts=4, depth=1, dim=32, num_heads=2,
               patch=8, tubelet_t=2)
    jm = jmoe.VideoMoE(compute_dtype=jnp.float32, **cfg)
    params = jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(3), jnp.zeros(clip)))
    tm = VideoMoE(compute_dtype=torch.float32, frames=clip[1], size=clip[2],
                  device="cpu", **cfg)
    tm.load_state_dict(moe_state_dict_from_flax(params), strict=True)
    return jm, params, tm, moe_state_dict_from_flax


@pytest.mark.parametrize("make", [vit_pair, dit_pair, moe_pair],
                         ids=["vit", "dit", "moe"])
def test_quantize_weights_byte_equal_to_jax(make):
    _, params, tm, convert = make()
    qtree = jax.tree_util.tree_map(np.asarray, jq.quantize_weights(params))
    want = qstate_from_flax(qtree, tm, convert)
    got = quantize_weights(tm)
    assert set(got) == set(want)
    records = 0
    for name, w in want.items():
        g = got[name]
        if isinstance(w, dict):
            records += 1
            assert isinstance(g, dict), name
            assert g["q"].dtype == torch.int8 and g["q"].shape == \
                tm.state_dict()[name].shape, name
            assert torch.equal(g["q"], w["q"]), name
            assert g["scale"].shape == w["scale"].shape, name
            assert torch.equal(g["scale"].view(torch.int32),
                               w["scale"].view(torch.int32)), name
        else:
            assert not isinstance(g, dict), name
            assert torch.equal(g, w), name
    assert records >= 8
    assert quantized_bytes(got) == jq.quantized_bytes(qtree)
    assert quantized_bytes(tm.state_dict()) == jq.quantized_bytes(params)
    np.testing.assert_allclose(
        quantization_error(tm.state_dict(), got),
        jq.quantization_error(params, qtree), rtol=1e-6)


def test_what_is_left_in_f32():
    """Embeddings, positional tables, biases and norm weights pass
    through; the MoE stacks and the attention kernels are quantized."""
    _, _, dit, _ = dit_pair()
    q = quantize_weights(dit)
    assert not isinstance(q["label_embed.weight"], dict)
    assert not isinstance(q["pos_spatial"], dict)
    assert isinstance(q["blocks.0.attn_s.query.weight"], dict)
    assert q["blocks.0.attn_s.query.weight"]["scale"].shape == (1, 16, 1)
    assert isinstance(q["blocks.0.fc1.weight"], dict)
    _, _, moe, _ = moe_pair()
    q = quantize_weights(moe)
    assert q["blocks.0.moe.w1"]["scale"].shape == (1, 1, 128)
    assert not isinstance(q["blocks.0.moe.b1"], dict)
    assert not isinstance(q["blocks.0.ln_m.weight"], dict)


def test_roundtrip_error_bounded():
    _, _, tm, _ = vit_pair()
    q = quantize_weights(tm)
    err = quantization_error(tm.state_dict(), q)
    assert 0 < err < 1e-2, err
    deq = dequantize_weights(q)
    assert torch.equal(deq["blocks.0.mlp.fc1.bias"],
                       tm.state_dict()["blocks.0.mlp.fc1.bias"])


def test_footprint_shrinks():
    _, _, tm, _ = vit_pair(dim=128)
    q = quantize_weights(tm)
    assert quantized_bytes(q) < quantized_bytes(tm.state_dict()) / 2.5
    k = q["blocks.0.mlp.fc1.weight"]
    assert k["q"].dtype == torch.int8 and k["scale"].dtype == torch.float32


def test_quantized_serving_forward_matches_jax():
    """functional_call on the dequantized state (the port's dequantize
    inside the served call) against the reference's serve(): logits
    within 1e-4, and the reference's own checks against the f32 model."""
    jm, params, tm, _ = vit_pair()
    clips = np.array(jax.random.uniform(jax.random.PRNGKey(1), CLIP))
    qtree = jq.quantize_weights(params)
    want_q = np.asarray(jm.apply(jq.dequantize_weights(qtree),
                                 jnp.asarray(clips)))
    q = quantize_weights(tm)
    x = torch.from_numpy(clips)
    with torch.no_grad():
        got_q = functional_call(tm, dequantize_weights(q), (x,)).numpy()
        f32 = tm(x).numpy()
    np.testing.assert_allclose(got_q, want_q, rtol=1e-4,
                               atol=1e-4 * np.abs(want_q).max())
    assert (got_q.argmax(-1) == f32.argmax(-1)).all()
    rel = np.abs(got_q - f32).max() / max(np.abs(f32).max(), 1e-9)
    assert rel < 0.05, rel
