"""The port's VideoViT (tensor_stream_torch/models) against the JAX
package's flax VideoViT, on the CPU, at a tiny size.

The flax parameters are initialized, shifted by seeded numpy noise (so
biases and LayerNorm scales are not their trivial init), converted with
``vit_state_dict_from_flax`` and loaded strictly; the same numpy clips go
through ``VideoViT.apply`` and the port's forward. The JAX flash path
runs the Pallas kernel in interpret mode (``flash_impl="pallas"``).

Tolerances: f32 compute 1e-4 (the same f32 math, reduction order apart);
bf16 compute 2e-2 (bf16 has 8 mantissa bits, and XLA's fused elementwise
ops and torch's separate ones round at different points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_stream_tpu.models.video_vit import VideoViT as FlaxViT
from tensor_stream_torch.models import VideoViT, vit_state_dict_from_flax

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 1e-4, "bf16": 2e-2}
BASE = dict(num_classes=7, depth=2, dim=64, num_heads=2, patch=8,
            tubelet_t=2)


def flax_params(model, clips, seed):
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(clips))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)


def pair(frames=4, size=16, dtype="f32", residual="f32", seed=0, **kw):
    """(flax model, params, port model with the converted weights, clips)."""
    jdt, tdt = DTYPES[dtype]
    jres, tres = DTYPES[residual]
    cfg = {**BASE, **kw}
    jax_kw = dict(cfg)
    if jax_kw.get("use_flash"):
        jax_kw["flash_impl"] = "pallas"
    clips = np.random.default_rng(seed).standard_normal(
        (2, frames, size, size, 3)).astype(np.float32)
    jm = FlaxViT(compute_dtype=jdt, residual_dtype=jres, **jax_kw)
    params = flax_params(jm, clips, seed + 1)
    tm = VideoViT(compute_dtype=tdt, residual_dtype=tres, frames=frames,
                  size=size, device="cpu", **cfg)
    tm.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    return jm, params, tm, clips


def check(dtype, **kw):
    jm, params, tm, clips = pair(dtype=dtype, **kw)
    want = np.asarray(jm.apply(params, jnp.asarray(clips)))
    with torch.no_grad():
        got = tm(torch.from_numpy(clips))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])
    return got


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("use_flash", [False, True], ids=["materialized",
                                                          "flash"])
@pytest.mark.parametrize("attention", ["factorized", "joint"])
def test_forward_matches_flax(attention, use_flash, dtype):
    check(dtype, attention=attention, use_flash=use_flash)


VARIANTS = [
    ("gqa_factorized", dict(num_heads=4, num_kv_heads=2)),
    ("mqa_joint", dict(num_heads=4, num_kv_heads=1, attention="joint")),
    ("causal_temporal_window", dict(causal=True, temporal_window=2,
                                    frames=8)),
    ("causal_full", dict(causal=True, frames=8)),
    ("spatial_window", dict(spatial_window=3)),
    # The serving configuration: bf16 compute and a bf16 residual stream.
    ("joint_bf16_residual", dict(attention="joint", dtype="bf16",
                                 residual="bf16")),
]


@pytest.mark.parametrize("use_flash", [False, True], ids=["materialized",
                                                          "flash"])
@pytest.mark.parametrize("name,kw", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_variants_match_flax(name, kw, use_flash):
    kw = {"dtype": "f32", **kw}
    got = check(use_flash=use_flash, **kw)
    if kw.get("causal"):
        assert got.shape == (2, kw["frames"] // 2, BASE["num_classes"])


def test_state_dict_layouts():
    """Each flax layout lands where the port's forward reads it: the
    converted q projection and out projection reproduce flax's
    DenseGeneral einsums, and the tubelet matrix its Conv3D."""
    jm, params, tm, clips = pair()
    p = params["params"]
    sd = vit_state_dict_from_flax(params)
    assert set(sd) == set(tm.state_dict())
    x = np.random.default_rng(5).standard_normal((3, 64)).astype(np.float32)
    attn = p["block0"]["attn_s"]
    want_q = np.einsum("nd,dhk->nhk", x, attn["query"]["kernel"]).reshape(3, -1)
    got_q = x @ sd["blocks.0.attn_s.query.weight"].numpy().T
    np.testing.assert_allclose(got_q, want_q, rtol=1e-5, atol=1e-5)
    o = np.random.default_rng(6).standard_normal((3, 2, 32)).astype(np.float32)
    want_o = np.einsum("nhk,hkd->nd", o, attn["out"]["kernel"])
    got_o = o.reshape(3, -1) @ sd["blocks.0.attn_s.out.weight"].numpy().T
    np.testing.assert_allclose(got_o, want_o, rtol=1e-5, atol=1e-5)
    assert sd["tubelet.weight"].shape == (64, 2 * 8 * 8 * 3)
    assert sd["blocks.0.ln_s.weight"].shape == (64,)
    joint = vit_state_dict_from_flax(
        pair(attention="joint")[1])
    assert {k.split(".")[2] for k in joint if k.startswith("blocks.0.")} \
        == {"ln_a", "attn", "ln_m", "mlp"}


@pytest.mark.parametrize("kw,match", [
    (dict(attention="joint", causal=True), "causal needs factorized"),
    (dict(temporal_window=2), "temporal_window requires causal"),
    (dict(attention="joint", spatial_window=3), "spatial_window requires"),
    (dict(num_heads=4, num_kv_heads=3), "must divide"),
    (dict(attention="ring"), "attention must be"),
], ids=["joint_causal", "window_no_causal", "joint_spatial_window",
        "kv_heads", "attention"])
def test_config_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        VideoViT(**{**BASE, **kw}, frames=4, size=16, device="cpu")


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VideoViT(**BASE, frames=4, size=16)


def test_seeded_init_is_reproducible():
    a = VideoViT(**BASE, frames=4, size=16, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    b = VideoViT(**BASE, frames=4, size=16, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_flash_forward_trains():
    """With grad enabled and trainable weights the flash core is
    differentiable: every parameter gets the gradient of the same model on
    the materialized path (f32 compute: the same math up to reduction
    order, so within 1e-4 of the model's largest gradient; the key biases'
    gradients are 0 up to rounding, so no per-parameter scale)."""
    _, _, tm, clips = pair(use_flash=True)
    twin = VideoViT(compute_dtype=torch.float32, frames=4, size=16,
                    device="cpu", **BASE)
    twin.load_state_dict(tm.state_dict())
    for model in (tm, twin):
        model(torch.from_numpy(clips)).square().sum().backward()
    scale = max(float(q.grad.abs().max()) for q in twin.parameters())
    for (name, p), q in zip(tm.named_parameters(), twin.parameters()):
        assert p.grad is not None, name
        torch.testing.assert_close(p.grad, q.grad, atol=1e-4 * scale,
                                   rtol=1e-4, msg=name)
