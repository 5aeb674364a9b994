"""The port's plain torch colour conversions against the JAX package's
ops/color.py, the native host converter and the Pallas kernel in
interpret mode.

Tolerances:
- Y800, NV12-merge, UYVY and YUV444: byte-exact (integer math and exact
  table lookups on both sides).
- RGB24/BGR24 against JAX: at most one u8 step (1/255 + 1e-7 in f32) and
  at least 99.99% of values equal. XLA may contract the G channel's
  `gv*vi + gu*ui + 0.5` into an FMA, which moves a truncation-boundary
  pixel by one step (docs/PARITY.md "Float-contraction freedom";
  tests/test_pallas.py). The port computes every op in source order, as
  the native converter does (built -ffp-contract=off), so against
  ts_vpp_convert_host it must be byte-exact.
- HSV: 1e-6 absolute (docs/PARITY.md).
"""
import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_stream_tpu.ops import color as jcolor
from tensor_stream_tpu.ops.pallas_color import build_pallas_nv12_to_rgb
from tensor_stream_torch import _build, _native
from tensor_stream_torch.ops import color, nv12_rgb

SIZES = [(64, 256), (36, 128), (24, 256)]  # (H, W); 36 and 24: H % 16 != 0
STANDARDS = [0, 1, 2, 3]
U8_STEP = 1.0 / 255 + 1e-7


def nv12(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (h, w), np.uint8),
            rng.integers(0, 256, (h // 2, w), np.uint8))


def assert_rgb_close(got, want):
    """The documented one-step contraction freedom on RGB outputs."""
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert diff.max() <= (U8_STEP if got.dtype == np.float32 else 1)
    assert (diff == 0).mean() >= 0.9999


def native_rgb(y, uv, fourcc, planar, norm, standard):
    lib = _native.load()
    h, w = y.shape
    out = np.empty(3 * h * w, np.float32 if norm else np.uint8)
    rc = lib.ts_vpp_convert_host(y.ctypes.data, uv.ctypes.data, w, h,
                                 0, 0, 0, 0, 0, 0, 0, fourcc,
                                 0 if planar else 1, int(norm), standard,
                                 out.ctypes.data)
    assert rc == 0
    return out.reshape((3, h, w) if planar else (h, w, 3))


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("standard", STANDARDS)
@pytest.mark.parametrize("h,w", SIZES)
def test_rgb_matches_jax_and_native(h, w, standard, norm):
    y, uv = nv12(h, w, seed=h * 10 + standard)
    ty, tuv = torch.from_numpy(y), torch.from_numpy(uv)
    for swap_rb in (False, True):
        for planar in (False, True):
            got = color.nv12_to_rgb(ty, tuv, swap_rb, planar, norm,
                                    standard).numpy()
            want = jcolor.nv12_to_rgb(jnp.asarray(y), jnp.asarray(uv),
                                      swap_rb, planar, norm, standard)
            assert_rgb_close(got, want)
            fourcc = 2 if swap_rb else 1
            assert np.array_equal(
                got, native_rgb(y, uv, fourcc, planar, norm, standard))


@pytest.mark.parametrize("standard", STANDARDS)
@pytest.mark.parametrize("h,w", SIZES)
def test_rgb_channels_match_jax(h, w, standard):
    y, uv = nv12(h, w, seed=7 + standard)
    got = color.nv12_to_rgb_channels(torch.from_numpy(y),
                                     torch.from_numpy(uv), standard)
    want = jcolor.nv12_to_rgb_channels(jnp.asarray(y), jnp.asarray(uv),
                                       standard)
    for g, wv in zip(got, want):
        assert g.dtype == torch.int32
        assert_rgb_close(g.numpy(), np.asarray(wv))


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("h,w", SIZES)
def test_yuv_formats_byte_exact(h, w, norm):
    y, uv = nv12(h, w, seed=h + w)
    ty, tuv = torch.from_numpy(y), torch.from_numpy(uv)
    jy, juv = jnp.asarray(y), jnp.asarray(uv)
    pairs = [
        (color.nv12_to_y800(ty, norm), jcolor.nv12_to_y800(jy, norm)),
        (color.nv12_merge(ty, tuv, norm), jcolor.nv12_merge(jy, juv, norm)),
        (color.nv12_to_uyvy(ty, tuv, norm),
         jcolor.nv12_to_uyvy(jy, juv, norm)),
    ]
    for as_float in (False, True):
        uyvy = color.nv12_to_uyvy(ty, tuv, False, as_float=as_float)
        juyvy = jcolor.nv12_to_uyvy(jy, juv, False, as_float=as_float)
        pairs.append((uyvy, juyvy))
        for float_mode in ((False, True) if not as_float else (True,)):
            for n in ((False,) if not float_mode else (False, True)):
                pairs.append((color.uyvy_to_yuv444(uyvy, w, h, n, float_mode),
                              jcolor.uyvy_to_yuv444(juyvy, w, h, n,
                                                    float_mode)))
    for got, want in pairs:
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def test_batched_planes_equal_per_frame():
    """The port's ops take leading batch dims; each frame of a batch is
    the single-frame result (the JAX package vmaps instead)."""
    ys, uvs = zip(*(nv12(36, 128, seed=s) for s in range(3)))
    ty = torch.from_numpy(np.stack(ys))
    tuv = torch.from_numpy(np.stack(uvs))
    batched = [color.nv12_to_rgb(ty, tuv, True, True, True, 1),
               color.uyvy_to_yuv444(color.nv12_to_uyvy(ty, tuv, False),
                                    128, 36, False, False),
               color.nv12_to_hsv(ty, tuv, 2)]
    for k in range(3):
        single = [color.nv12_to_rgb(ty[k], tuv[k], True, True, True, 1),
                  color.uyvy_to_yuv444(color.nv12_to_uyvy(ty[k], tuv[k],
                                                          False),
                                       128, 36, False, False),
                  color.nv12_to_hsv(ty[k], tuv[k], 2)]
        for b, s in zip(batched, single):
            assert torch.equal(b[k], s)


@pytest.mark.parametrize("standard", STANDARDS)
@pytest.mark.parametrize("h,w", SIZES)
def test_hsv_matches_jax(h, w, standard):
    y, uv = nv12(h, w, seed=3 * h + standard)
    got = color.nv12_to_hsv(torch.from_numpy(y), torch.from_numpy(uv),
                            standard).numpy()
    want = np.asarray(jcolor.nv12_to_hsv(jnp.asarray(y), jnp.asarray(uv),
                                         standard))
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("planar,norm,standard", [
    (True, True, 0), (False, False, 1), (True, False, 2), (False, True, 3)])
def test_plain_matches_pallas_interpret(planar, norm, standard):
    """The kernel's plain version against the Pallas kernel it replaces,
    run in interpret mode as tests/test_pallas.py runs it on the CPU."""
    h, w = 64, 256
    y, uv = nv12(h, w, seed=5)
    fn = build_pallas_nv12_to_rgb(h, w, False, planar, norm, block_rows=16,
                                  interpret=True, standard=standard)
    got = nv12_rgb.nv12_to_rgb_plain(torch.from_numpy(y), torch.from_numpy(uv),
                                     False, planar, norm, standard)
    assert_rgb_close(got.numpy(), fn(y, uv))


def test_division_table_is_correctly_rounded():
    assert np.array_equal(color._DIV255.view(np.uint32),
                          jcolor._DIV255.view(np.uint32))
    assert np.array_equal(color._DIV16_255.view(np.uint32),
                          jcolor._DIV16_255.view(np.uint32))
    exact = np.arange(256, dtype=np.float64) / 255
    assert np.array_equal(color._DIV255, exact.astype(np.float32))


def test_coefficients_match_jax_and_kernel_source():
    """The port's f32 matrix constants equal the JAX package's bit for
    bit, and so do the hex-float literals of the CUDA kernel's table."""
    for std in STANDARDS:
        ours = np.array(color._STANDARD_COEFS[std], np.float32)
        theirs = np.array(jcolor._STANDARD_COEFS[std], np.float32)
        assert np.array_equal(ours.view(np.uint32), theirs.view(np.uint32))
    # The table lives in csrc/nv12.cuh, which nv12_rgb.cu includes.
    text = ""
    for src in _build.sources_of("nv12_rgb"):
        with open(src) as f:
            text += f.read()
    table = text[text.index("kCoefs[4]"):text.index("};", text.index("kCoefs[4]"))]
    lits = re.findall(r"-?0x[0-9a-f.]+p[+-]\d+f", table)
    assert len(lits) == 24
    values = np.array([float.fromhex(s[:-1]) for s in lits], np.float32)
    want = np.array([color._STANDARD_COEFS[s] for s in STANDARDS],
                    np.float32).reshape(-1)
    assert np.array_equal(values.view(np.uint32), want.view(np.uint32))
