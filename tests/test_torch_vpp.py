"""The port's VPP (ops/vpp.py) against the JAX package's, on the CPU.

Same tolerances as tests/test_torch_color.py: RGB outputs within one u8
step (>= 99.99% equal), every other format byte-exact; bfloat16 outputs
within one u8 step plus one bf16 rounding step.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_stream_tpu import enums as jenums
from tensor_stream_tpu.ops import vpp as jvpp
from tensor_stream_torch.enums import ColorStandard, FourCC, Planes
from tensor_stream_torch.ops import vpp

from test_torch_color import assert_rgb_close

W, H = 128, 36


def nv12(h, w, seed, n=None):
    rng = np.random.default_rng(seed)
    lead = () if n is None else (n,)
    return (rng.integers(0, 256, lead + (h, w), np.uint8),
            rng.integers(0, 256, lead + (h // 2, w), np.uint8))


def both_configs(**kw):
    """The same config in both packages (enum values carried across)."""
    jkw = dict(kw)
    for key, enum in (("fourcc", jenums.FourCC), ("planes", jenums.Planes),
                      ("resize_type", jenums.ResizeType),
                      ("standard", jenums.ColorStandard)):
        if key in kw:
            jkw[key] = enum(kw[key].value)
    return vpp.VPPConfig(**kw), jvpp.VPPConfig(**jkw)


def assert_matches(got, want, fourcc):
    got = np.asarray(got)
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:
        want = want.astype(np.float32)
        assert got.dtype == np.float32 and got.shape == want.shape
        diff = np.abs(got - want)
        assert diff.max() <= 1.0 / 255 + 2.0 ** -8
        assert (diff == 0).mean() >= 0.9999
    elif fourcc in (FourCC.RGB24, FourCC.BGR24):
        assert_rgb_close(got, want)
    else:
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


CROPS = [(0, 0, 0, 0), (4, 2, 100, 30), (0, 0, W, H)]
RESIZES = [(0, 0), (64, 24), (256, 48), (W, H)]


def test_output_shape_and_dtype_match_jax():
    names = {torch.uint8: "uint8", torch.float32: "float32",
             torch.bfloat16: "bfloat16", torch.float16: "float16"}
    for four, planes, crop, (rw, rh), norm, dtype in itertools.product(
            FourCC, Planes, CROPS, RESIZES, (False, True),
            ("", "bfloat16")):
        cfg, jcfg = both_configs(src_width=W, src_height=H, crop=crop,
                                 width=rw, height=rh, fourcc=four,
                                 planes=planes, normalization=norm,
                                 dtype=dtype)
        assert cfg.output_size() == jcfg.output_size()
        assert cfg.output_shape() == jcfg.output_shape()
        assert names[cfg.output_dtype()] == jnp.dtype(jcfg.output_dtype()).name
        assert cfg.normalization == jcfg.normalization


def test_config_checks_match_jax():
    for kw in (dict(dtype="int8"), dict(width=63, height=24)):
        with pytest.raises(ValueError):
            vpp.VPPConfig(W, H, **kw)
        with pytest.raises(ValueError):
            jvpp.VPPConfig(W, H, **kw)


CASES = [
    ("full_rgb_merged", dict(fourcc=FourCC.RGB24)),
    ("full_bgr_planar_norm", dict(fourcc=FourCC.BGR24, planes=Planes.PLANAR,
                                  normalization=True,
                                  standard=ColorStandard.BT709)),
    ("crop_rgb", dict(crop=(4, 2, 100, 30), fourcc=FourCC.RGB24)),
    ("nearest_down", dict(width=64, height=24, fourcc=FourCC.RGB24,
                          planes=Planes.PLANAR, normalization=True)),
    ("nearest_up", dict(width=256, height=48, fourcc=FourCC.BGR24,
                        standard=ColorStandard.BT601_FULL)),
    ("crop_nearest_y800", dict(crop=(8, 4, 72, 36), width=32, height=16,
                               fourcc=FourCC.Y800, normalization=True)),
    ("crop_nearest_uyvy", dict(crop=(8, 4, 72, 36), width=96, height=40,
                               fourcc=FourCC.UYVY)),
    ("nearest_yuv444", dict(width=64, height=24, fourcc=FourCC.YUV444,
                            normalization=True)),
    ("nearest_nv12", dict(width=64, height=24, fourcc=FourCC.NV12)),
    ("crop_hsv", dict(crop=(4, 2, 100, 30), fourcc=FourCC.HSV,
                      standard=ColorStandard.BT709_FULL)),
    ("bf16_full", dict(fourcc=FourCC.RGB24, planes=Planes.PLANAR,
                       normalization=True, dtype="bfloat16")),
    ("bf16_nearest", dict(width=64, height=24, fourcc=FourCC.RGB24,
                          dtype="bfloat16")),
]


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_vpp_numpy_matches_jax(name, kw):
    cfg, jcfg = both_configs(src_width=W, src_height=H, **kw)
    y, uv = nv12(H, W, seed=len(name))
    got = vpp.vpp_numpy(cfg, y, uv, device="cpu")
    want = jvpp.vpp_numpy(jcfg, y, uv)
    if cfg.fourcc == FourCC.HSV:
        assert got.shape == want.shape
        assert np.abs(got - np.asarray(want)).max() <= 1e-6
        return
    assert_matches(got, want, cfg.fourcc)


@pytest.mark.parametrize("name,kw", [CASES[1], CASES[3], CASES[6],
                                     CASES[11]],
                         ids=[CASES[i][0] for i in (1, 3, 6, 11)])
def test_batched_flat_with_post_fn_matches_jax(name, kw):
    """One flat staging buffer (all Y planes, then all UV planes) through
    build_vpp_batched_flat with a post_fn, in both packages."""
    n = 3
    cfg, jcfg = both_configs(src_width=W, src_height=H, **kw)
    ys, uvs = nv12(H, W, seed=11, n=n)
    flat = np.concatenate([ys.reshape(-1), uvs.reshape(-1)])
    got = vpp.build_vpp_batched_flat(
        cfg, n, "cpu", post_fn=lambda t: t.flip(0))(torch.from_numpy(flat))
    want = jvpp.build_vpp_batched_flat(
        jcfg, n, post_fn=lambda t: t[::-1])(jnp.asarray(flat))
    assert tuple(got.shape) == (n, *cfg.output_shape())
    if got.dtype == torch.bfloat16:
        got = got.to(torch.float32)
    assert_matches(got.numpy(), jax.device_get(want), cfg.fourcc)
    batched = vpp.build_vpp_batched(cfg, "cpu")(torch.from_numpy(ys),
                                                torch.from_numpy(uvs))
    assert torch.equal(batched.flip(0), got.to(batched.dtype))


def test_auto_standard_must_be_resolved():
    with pytest.raises(ValueError, match="AUTO"):
        vpp.make_vpp_fn(vpp.VPPConfig(W, H, standard=ColorStandard.AUTO))
    vpp.make_vpp_fn(vpp.VPPConfig(W, H, fourcc=FourCC.Y800,
                                  standard=ColorStandard.AUTO))
