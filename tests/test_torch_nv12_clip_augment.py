"""The operator ``ts::nv12_clip_augment`` (ops/augment.py) on the CPU: the
NV12 conversion and the clip augmentation in one operator, the route of
``ops/vpp.py::build_vpp_clip_augment``.

The kernel itself (csrc/clip_augment.cu, Nv12ClipApply) runs only on the
card, where chip_smoke.py's ``nv12_clip_augment_vs_plain`` phase holds it
against the two-kernel chain and the plain version. Here:

* the operator on CPU tensors is ``nv12_to_rgb_plain`` followed by
  ``clip_augment_plain``, bit for bit;
* ``build_vpp_clip_augment`` on the CPU agrees with the JAX package's VPP
  and augmentation, given the parameters JAX draws from its keys
  (tests/test_torch_augment.py's f32 bound, 1e-4);
* the fake gives the real output's shape, dtype and strides; the CUDA
  body refuses what the kernel does not take; the launch plan's stages
  hold every row a block's taps can touch;
* the kernel's tap conversion (csrc/nv12.cuh Rgb on its hex-float tables,
  then the value table) emulated in torch, followed by the emulated
  augmentation of tests/test_torch_clip_augment.py, equals the plain
  version, and ``chip_smoke.augment_rule`` fails it with the chroma of
  the wrong quad;
* an augmented VPP calls the fused operator once a batch and the NV12
  conversion never; the identity calls no augmentation operator;
* the DTensor rule on 2 gloo ranks keeps each rank's clips whole.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import chip_smoke
from tensor_stream_tpu import enums as jenums
from tensor_stream_tpu.ops import augment as jaug
from tensor_stream_tpu.ops import vpp as jvpp
from tensor_stream_torch import _build
from tensor_stream_torch.enums import FourCC, Planes, ResizeType
from tensor_stream_torch.ops import augment as aug
from tensor_stream_torch.ops import nv12_rgb, vpp
from tensor_stream_torch.ops.augment import AugmentConfig
from test_torch_augment import jax_params
from test_torch_clip_augment import emulate
from torch_spawn import start

F32, BF16, F16, U8 = torch.float32, torch.bfloat16, torch.float16, torch.uint8
SPATIAL = dict(width=24, height=20, scale=(0.3, 1.0), ratio=(0.75, 4 / 3),
               hflip=0.5)
JITTER = dict(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.05)
NORM = dict(mean=(0.45, 0.45, 0.45), std=(0.225, 0.225, 0.225))
BENCH = AugmentConfig(**SPATIAL, **JITTER, **NORM, erase=0.5)
U8_CFG = AugmentConfig(**SPATIAL, **JITTER, erase=0.5)
B, T, SH, SW = 4, 3, 30, 40

# (name, config, frames a clip, source (h, w), planar, swap R/B,
# normalization, colour standard, output dtype).
CASES = [
    ("planar_rgb_f32", BENCH, T, (SH, SW), True, False, True, 0, F32),
    ("merged_bgr_f32", BENCH, T, (SH, SW), False, True, True, 1, F32),
    ("planar_rgb_bf16", BENCH, T, (SH, SW), True, False, True, 2, BF16),
    ("merged_bgr_f16", BENCH, T, (SH, SW), False, True, True, 3, F16),
    ("planar_u8", U8_CFG, T, (SH, SW), True, False, False, 0, U8),
    ("merged_bgr_u8", U8_CFG, T, (SH, SW), False, True, False, 1, U8),
    ("u8_to_f32_normalized", AugmentConfig(
        **SPATIAL, **JITTER, mean=(114.75,) * 3, std=(57.375,) * 3),
     T, (SH, SW), True, False, False, 0, F32),
    ("no_contrast", AugmentConfig(**SPATIAL, saturation=0.4, hue=0.05,
                                  **NORM, erase=0.5),
     T, (SH, SW), True, False, True, 0, F32),
    ("contrast_only", AugmentConfig(contrast=0.4), T, (SH, SW), True, False,
     True, 0, F32),
    ("jitter_no_spatial", AugmentConfig(**JITTER, **NORM), T, (SH, SW),
     False, True, True, 0, F32),
    ("erase_flip", AugmentConfig(**{**SPATIAL, "hflip": 1.0}, **NORM,
                                 erase=1.0),
     T, (SH, SW), True, False, True, 0, F32),
    ("frames_t1", BENCH, 1, (SH, SW), True, False, True, 0, F32),
    ("w42_planar_f32", AugmentConfig(**{**SPATIAL, "width": 42,
                                        "height": 30}, **JITTER, **NORM),
     T, (48, 64), True, False, True, 1, F32),
    ("flip_only_w42", AugmentConfig(hflip=1.0), T, (30, 42), False, False,
     False, 0, U8),
    ("edge_rects", AugmentConfig(**SPATIAL, **JITTER, **NORM, erase=1.0),
     T, (SH, SW), True, False, True, 0, F32),
]
IDS = [c[0] for c in CASES]
CASE = dict(zip(IDS, CASES))


def nv12(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (n, h, w), np.uint8)),
            torch.from_numpy(rng.integers(0, 256, (n, h // 2, w),
                                          np.uint8)))


def inputs(case, seed=0):
    """A case's seeded planes and parameter rows ("edge_rects" moves the
    crop and erase rects onto the frame's edges, as chip_smoke.py's case
    of that name does)."""
    name, cfg, t, (h, w) = case[:4]
    y, uv = nv12(B * t, h, w, seed)
    ids = np.stack([np.zeros(B, np.int64), np.arange(B)], axis=1)
    p = aug.sample_clip_params(cfg, h, w, seed, ids)
    if name == "edge_rects":
        col = {k: i for i, k in enumerate(aug.PARAMS)}
        out_w, out_h = cfg.output_size(w, h)
        p[0, col["y0"]], p[0, col["x0"]] = 0, w - p[0, col["rect_w"]]
        p[1, col["y0"]], p[1, col["x0"]] = h - p[1, col["rect_h"]], 0
        p[2, :4] = (0, 0, h, w)
        p[3, :4] = (h - 1, w - 1, 1, 1)
        p[:, col["erase_y0"]] = out_h - p[:, col["erase_h"]]
        p[:, col["erase_x0"]] = out_w - p[:, col["erase_w"]]
    return y, uv, torch.from_numpy(p)


def op_args(case, y, uv, params):
    _, cfg, _, (h, w), planar, swap, norm, standard, out_dt = case
    out_w, out_h = cfg.output_size(w, h)
    return (y, uv, params, swap, norm, standard, planar, out_h, out_w,
            aug.op_flags(cfg), list(cfg.mean or (0.0,) * 3),
            list(cfg.std or (1.0,) * 3), 1.0 if norm else 255.0, out_dt)


def chain(args):
    """nv12_to_rgb_plain, then clip_augment_plain: the operator's plain
    version written out."""
    (y, uv, params, swap, norm, standard, planar, out_h, out_w, ops, mean,
     std, unit, out_dt) = args
    rgb = nv12_rgb.nv12_to_rgb_plain(y, uv, swap, planar, norm, standard)
    rgb = rgb.reshape((params.shape[0], -1) + tuple(rgb.shape[1:]))
    return aug.clip_augment_plain(rgb, params, planar, out_h, out_w, ops,
                                  mean, std, unit, swap, out_dt)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_operator_on_the_cpu_is_the_plain_composition(case):
    args = op_args(case, *inputs(case))
    got = torch.ops.ts.nv12_clip_augment(*args)
    want = chain(args)
    assert got.dtype == case[8] and got.is_contiguous()
    assert torch.equal(got, want)
    _, cfg, _, (h, w), planar, swap, norm, standard, out_dt = case
    fn = aug.make_nv12_clip_augment_fn(cfg, h, w, planar, swap, norm,
                                       standard, out_dt)
    assert torch.equal(fn(*args[:3]), want)
    if case[0] in ("erase_flip", "edge_rects"):  # the erase fired
        p = args[2]
        assert bool((p[:, aug.PARAMS.index("erase")] > 0.5).all())
        assert bool((got == 0).any())
    if case[0] == "erase_flip":
        assert bool((args[2][:, aug.PARAMS.index("flip")] > 0.5).all())


@pytest.mark.parametrize("norm", [True, False], ids=["f32", "u8"])
@pytest.mark.parametrize("standard", [0, 1, 2, 3])
def test_every_colour_standard(standard, norm):
    cfg = BENCH if norm else U8_CFG
    case = ("std", cfg, T, (SH, SW), False, standard % 2 == 1, norm,
            standard, F32 if norm else U8)
    args = op_args(case, *inputs(case, seed=standard))
    assert torch.equal(torch.ops.ts.nv12_clip_augment(*args), chain(args))


# ------------------------------------------------ against the JAX package

# (VPP source (w, h), resize target (w, h) or None, augmentation, planar,
# BGR).
VPP_CASES = [
    ((40, 30), None, BENCH, True, False),
    ((64, 48), (32, 24), AugmentConfig(**{**SPATIAL, "width": 16,
                                          "height": 12}, **JITTER, **NORM,
                                       erase=0.5), False, True),
]


@pytest.mark.parametrize("src,size,cfg,planar,bgr", VPP_CASES,
                         ids=["unresized_30x40", "bilinear_64x48_to_32x24"])
def test_vpp_clip_augment_matches_jax_with_its_draws(src, size, cfg, planar,
                                                     bgr):
    (w, h), clips, clip_len, seed = src, 4, 2, 7
    kw = dict(src_width=w, src_height=h, normalization=True)
    if size:
        kw.update(width=size[0], height=size[1])
    port = vpp.VPPConfig(**kw, resize_type=ResizeType.BILINEAR,
                         fourcc=FourCC.BGR24 if bgr else FourCC.RGB24,
                         planes=Planes.PLANAR if planar else Planes.MERGED)
    ref = jvpp.VPPConfig(**kw, resize_type=jenums.ResizeType.BILINEAR,
                         fourcc=(jenums.FourCC.BGR24 if bgr
                                 else jenums.FourCC.RGB24),
                         planes=(jenums.Planes.PLANAR if planar
                                 else jenums.Planes.MERGED))
    y, uv = nv12(clips * clip_len, h, w, 5)
    flat = np.concatenate([y.numpy().ravel(), uv.numpy().ravel()])
    ids = np.stack([np.full(clips, 2, np.int64), np.arange(clips) + 10], 1)
    want = np.asarray(jvpp.build_vpp_clip_augment(
        ref, jaug.AugmentConfig(**cfg.__dict__), clips, clip_len, seed)(
        jnp.asarray(flat), jnp.asarray(ids, jnp.int32)))
    # The parameters JAX drew: fold_in(fold_in(key(seed), epoch), id).
    out_w, out_h = port.output_size()
    base = jax.random.key(seed)
    params = np.stack([jax_params(cfg, jax.random.fold_in(
        jax.random.fold_in(base, int(e)), int(i)), out_h, out_w)
        for e, i in ids])
    fn = vpp.build_vpp_clip_augment(port, cfg, clips, clip_len, seed,
                                    device="cpu")
    got = fn.graphed(torch.from_numpy(flat), torch.from_numpy(params))
    assert got.dtype == F32 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4
    assert (want == 0).any()  # JAX's erase draws fired


# ------------------------------------------------ fake, checks and plan

@pytest.mark.parametrize("planar", [True, False], ids=["planar", "merged"])
@pytest.mark.parametrize("out_dt", [F32, BF16, F16, U8],
                         ids=["f32", "bf16", "f16", "u8"])
def test_fake_matches_the_real_op(planar, out_dt):
    case = ("fake", BENCH, T, (SH, SW), planar, False, True, 0, out_dt)
    args = op_args(case, *inputs(case))
    real = torch.ops.ts.nv12_clip_augment(*args)
    with FakeTensorMode() as mode:
        fake = torch.ops.ts.nv12_clip_augment(*[
            mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
            for a in args])
    assert (tuple(fake.shape), fake.dtype, fake.stride()) == (
        tuple(real.shape), real.dtype, real.stride())
    assert tuple(real.shape) == ((B, T, 3, 20, 24) if planar
                                 else (B, T, 20, 24, 3))
    torch.library.opcheck(torch.ops.ts.nv12_clip_augment, args,
                          test_utils=("test_schema", "test_faketensor"))


def test_cuda_body_refuses_what_the_kernel_does_not_take():
    """The wrapper of the kernel checks the planes, then the device: CPU
    tensors, odd sizes, a uv plane of another shape, planes that are not
    contiguous, frames that do not split into the clips and planes that
    are not uint8 all raise; it never falls back."""
    case = CASE["planar_rgb_f32"]
    y, uv, params = inputs(case)
    with pytest.raises(ValueError, match="CUDA"):
        aug._nv12_clip_augment_cuda(*op_args(case, y, uv, params))
    odd_y, odd_uv = nv12(B * T, 29, SW, 0)
    wide_y, wide_uv = nv12(B * T, SH, 2 * SW, 0)
    bad = [((odd_y, odd_uv[:, :14], params), ValueError, "even"),
           ((y, uv[:, :-1], params), ValueError, "uv of shape"),
           ((wide_y[:, :, ::2], wide_uv[:, :, ::2], params), ValueError,
            "contiguous"),
           ((y, uv, torch.cat([params, params[:1]])), ValueError, "split"),
           ((y, uv, params[:, :10]), ValueError, "params"),
           ((y.to(torch.int16), uv, params), TypeError, "uint8")]
    for planes, err, match in bad:
        with pytest.raises(err, match=match):
            aug._nv12_clip_augment_cuda(*op_args(case, *planes))
    with pytest.raises(ValueError, match="resolved"):
        aug._nv12_clip_augment_cuda(*op_args(
            case[:7] + (4,) + case[8:], y, uv, params))


def test_graph_replays_advance_the_fused_counts():
    from tensor_stream_torch import graphs
    names = {(mod.__name__, name) for mod, name in graphs.COUNTERS}
    for name in ("nv12_launches", "nv12_launches_by_pass",
                 "nv12_launches_by_mode"):
        assert (aug.__name__, name) in names
    aug.reset_counts()
    assert aug.nv12_launches == 0
    assert set(aug.nv12_launches_by_pass.values()) == {0}
    assert set(aug.nv12_launches_by_mode.values()) == {0}


def kernel_rows(cfg, params, h, w, band):
    """For each parameter row and band of `band` output rows, the Y rows
    and the UV rows Nv12ClipApply stages, and the columns it converts
    (its ylo .. yhi, their chroma rows, xa .. xb), as Coord and MakeTaps
    compute them in float32."""
    out_w, out_h = cfg.output_size(w, h)
    spatial = bool(aug.op_flags(cfg) & (aug.OP_BITS["resize"]
                                        | aug.OP_BITS["flip"]))
    col = {k: i for i, k in enumerate(aug.PARAMS)}
    f32 = np.float32
    for row in params:
        y0, x0, rh, rw = row[:4]

        def taps(j, n, start, extent, size, flip):
            u = (f32(j) + f32(0.5)) * (f32(extent) / f32(n))
            if flip:
                u = f32(extent) - u
            lo = np.floor(f32(start) + u - f32(0.5))
            return (int(np.clip(lo, 0, size - 1)),
                    int(np.clip(lo + 1, 0, size - 1)))
        flip = row[col["flip"]] > 0.5 and cfg.hflip > 0
        xs = [taps(j, out_w, x0, rw, w, flip) for j in (0, out_w - 1)]
        xa = min(xs[0][0], xs[1][0])
        xb = max(xs[0][1], xs[1][1]) + 1
        for r0 in range(0, out_h, band):
            r1 = min(out_h, r0 + band) - 1
            lo, hi = ((taps(r0, out_h, y0, rh, h, False)[0],
                       taps(r1, out_h, y0, rh, h, False)[1]) if spatial
                      else (r0, r1))
            yield hi - lo + 1, (hi >> 1) - (lo >> 1) + 1, (
                xb - xa if spatial else w)


PLAN_CASES = [  # (source h, w), config
    ((224, 224), chip_smoke.BENCH_AUG),
    ((1080, 1920), chip_smoke.BENCH_AUG),
    ((240, 1280), AugmentConfig(**{**chip_smoke.AUG_SPATIAL,
                                   "height": 112})),
    ((48, 64), AugmentConfig(width=42, height=30, scale=(0.05, 1.0),
                             ratio=(0.2, 5.0))),
    ((224, 224), AugmentConfig(**chip_smoke.AUG_JITTER)),
]


@pytest.mark.parametrize("src,cfg", PLAN_CASES,
                         ids=["bench", "1080p", "wide", "w42", "no_spatial"])
def test_plan_stages_hold_every_row_the_taps_touch(src, cfg):
    """The plan's stages hold the rows that every band of every drawn
    rect touches, so no block of a sampled batch leaves the staged path
    (the kernel gathers from device memory where they would not fit)."""
    h, w = src
    out_w, out_h = cfg.output_size(w, h)
    ops = aug.op_flags(cfg)
    plan = aug.nv12_plan(h, w, out_h, out_w, ops, True)
    assert plan["smem"] <= aug.NV12_SMEM
    if plan["mode"] == "gather":  # 1280 and 1920 wide: rows too wide
        assert plan["stage_y"] == plan["rgb"] == 0 and w >= 1280
        return
    assert plan["threads"] <= 256 and plan["band"] >= 1
    ids = np.stack([np.zeros(64, np.int64), np.arange(64)], axis=1)
    params = aug.sample_clip_params(cfg, h, w, 3, ids)
    for ny, nuv, cw in kernel_rows(cfg, params, h, w, plan["band"]):
        assert ny * w <= plan["stage_y"] and nuv * w <= plan["stage_uv"]
        assert ny * cw * 16 <= plan["rgb"]


def test_plan_gathers_where_staging_cannot_copy():
    ops = aug.op_flags(BENCH)
    assert aug.nv12_plan(30, 40, 20, 24, ops, True)["mode"] == \
        "gather"  # W % 16
    assert aug.nv12_plan(224, 224, 224, 224, ops, False)[
        "mode"] == "gather"  # unaligned planes
    assert aug.nv12_plan(1080, 1920, 224, 224, ops, True)[
        "mode"] == "gather"  # rows too wide
    head = aug.nv12_plan(224, 224, 224, 224, ops, True)
    assert (head["mode"], head["band"], head["threads"]) == (
        "staged", 8, 224)


# ------------------------------------------------ the kernel's arithmetic

def header_tables():
    """kCoefs ([4, 6]) and kDiv255 ([256]) of csrc/nv12.cuh, parsed from
    their hex-float literals."""
    with open(os.path.join(_build.SRC_DIR, "nv12.cuh")) as f:
        text = f.read()

    def table(name, n):
        start = text.index(name)
        lits = re.findall(r"-?0x[0-9a-f.]+p[+-]\d+f",
                          text[start:text.index("};", start)])
        assert len(lits) == n
        return np.array([float.fromhex(s[:-1]) for s in lits], np.float32)
    return table("kCoefs[4]", 24).reshape(4, 6), table("kDiv255[256]", 256)


def emulate_taps(y, uv, standard, swap, norm, fault=None):
    """The kernel's tap conversion of every pixel (Nv12Pixel: Rgb of
    csrc/nv12.cuh in its _rn order, the swap, the value table) in float32
    torch ops on the header's tables: [N, H, W, 3]. `fault`
    "wrong_quad" takes each pixel's chroma from the next quad to the
    right."""
    coefs, div255 = header_tables()
    rv, bu, gv, gu, yc, yo = (torch.tensor(c) for c in coefs[standard])
    n, h, w = y.shape
    cols = torch.arange(w) & ~1
    if fault == "wrong_quad":
        cols = (cols + 2).clamp(max=w - 2)
    c = uv[:, torch.arange(h) >> 1]
    ui = (c[:, :, cols].to(torch.int32) - 128).to(F32)
    vi = (c[:, :, cols + 1].to(torch.int32) - 128).to(F32)
    yf = torch.clamp_min(y.to(F32) - yo, 0.0) * yc

    def channel(x):
        return torch.trunc(yf + x).clamp(0, 255).to(torch.int64)
    r = channel(vi * rv + 0.5)
    b = channel(ui * bu + 0.5)
    g = channel((vi * gv + ui * gu) + 0.5)
    if swap:
        r, b = b, r
    val = torch.from_numpy(div255) if norm else torch.arange(256).to(F32)
    return val[torch.stack([r, g, b], dim=-1)]


def emulated(case, fault=None):
    args = op_args(case, *inputs(case))
    (y, uv, params, swap, norm, standard, planar, out_h, out_w, ops, mean,
     std, unit, out_dt) = args
    vals = emulate_taps(y, uv, standard, swap, norm, fault)
    clips = vals.reshape((B, -1) + tuple(vals.shape[1:]))
    if planar:
        clips = torch.movedim(clips, -1, 2)
    consts = aug.pack_constants(tuple(mean), tuple(std), unit, swap)
    got = emulate(clips, params, planar, out_h, out_w, ops, consts, out_dt)
    return got, aug.nv12_clip_augment_plain(*args), out_dt


@pytest.mark.parametrize("case", [CASE[k] for k in (
    "planar_rgb_f32", "merged_bgr_f16", "merged_bgr_u8", "w42_planar_f32",
    "jitter_no_spatial")], ids=["planar_rgb_f32", "merged_bgr_f16",
                                "merged_bgr_u8", "w42_planar_f32",
                                "jitter_no_spatial"])
def test_kernel_tap_conversion_is_the_plain_version(case):
    got, want, out_dt = emulated(case)
    assert torch.equal(got, want)
    assert chip_smoke.augment_rule(got, want, out_dt)[0]


def test_augment_rule_sees_chroma_from_the_wrong_quad():
    case = CASE["planar_rgb_f32"]
    sound, want, out_dt = emulated(case)
    assert chip_smoke.augment_rule(sound, want, out_dt)[0]
    faulty, want, out_dt = emulated(case, "wrong_quad")
    passed, nums = chip_smoke.augment_rule(faulty, want, out_dt)
    assert not passed, nums


# ------------------------------------------------ the route of the VPP

def vpp_cfg(**kw):
    return vpp.VPPConfig(src_width=SW, src_height=SH, fourcc=FourCC.RGB24,
                         planes=Planes.PLANAR, normalization=True, **kw)


@pytest.mark.parametrize("crop", [None, (4, 2, 36, 26)],
                         ids=["full", "cropped"])
def test_augmented_vpp_calls_the_fused_operator_alone(monkeypatch, crop):
    """One ts::nv12_clip_augment a batch; neither ts::nv12_to_rgb nor
    ts::clip_augment (the chain it replaces) is called. The bytes are the
    chain's: the VPP, then the augmentation."""
    cfg = vpp_cfg(**({"crop": crop} if crop else {}))
    calls = []
    real = aug._NV12_OP

    def counted(*args):
        calls.append(args)
        return real(*args)

    def refuse(*args):
        raise AssertionError("the augmented VPP ran the two-kernel chain")
    fn = vpp.build_vpp_clip_augment(cfg, BENCH, 2, T, 3, device="cpu")
    y, uv = nv12(2 * T, SH, SW, 1)
    flat = torch.cat([y.reshape(-1), uv.reshape(-1)])
    ids = np.array([[0, 1], [0, 2]])
    rgb = vpp.build_vpp_batched_flat(cfg, 2 * T, device="cpu")(flat)
    out_w, out_h = cfg.output_size()
    params = torch.from_numpy(aug.sample_clip_params(BENCH, out_h, out_w, 3,
                                                     ids))
    want = aug.make_clip_augment_fn(BENCH, out_h, out_w, True)(
        rgb.reshape((2, T) + tuple(rgb.shape[1:])), params)
    monkeypatch.setattr(aug, "_NV12_OP", counted)
    monkeypatch.setattr(aug, "_OP", refuse)
    monkeypatch.setattr(nv12_rgb, "_OP", refuse)
    for _ in range(2):
        got = fn(flat, ids)
    assert len(calls) == 2
    assert torch.equal(got, want)


def test_identity_vpp_calls_no_augmentation_operator(monkeypatch):
    def refuse(*args):
        raise AssertionError("the identity called an augmentation operator")
    monkeypatch.setattr(aug, "_NV12_OP", refuse)
    monkeypatch.setattr(aug, "_OP", refuse)
    cfg = vpp_cfg()
    fn = vpp.build_vpp_clip_augment(cfg, AugmentConfig(), 2, T, 0,
                                    device="cpu")
    y, uv = nv12(2 * T, SH, SW, 2)
    flat = torch.cat([y.reshape(-1), uv.reshape(-1)])
    plain = vpp.build_vpp_batched_flat(cfg, 2 * T, device="cpu")(flat)
    got = fn(flat, np.array([[0, 0], [0, 1]]))
    assert torch.equal(got, plain.view(got.shape))
    with pytest.raises(ValueError, match="identity"):
        aug.make_nv12_clip_augment_fn(AugmentConfig(), SH, SW, True, False,
                                      True, 0)


# ------------------------------------------------ the DTensor rule

RULE_CASE = ("rule", BENCH, T, (SH, SW), True, False, True, 0, F32)


def _ranks(rank, world):
    from tensor_stream_torch.parallel import make_mesh
    from tensor_stream_torch.parallel.sharding import distribute
    mesh = make_mesh(axes=("dp",), device="cpu")
    args = op_args(RULE_CASE, *inputs(RULE_CASE, seed=4))
    got = torch.ops.ts.nv12_clip_augment(
        *(distribute(a, mesh, ("dp",)) for a in args[:3]), *args[3:])
    return ([str(p) for p in got.placements], got.to_local().numpy(),
            got.full_tensor().numpy())


def test_dtensor_rule_keeps_each_ranks_clips(tmp_path):
    """ts::nv12_clip_augment on planes and rows sharded over "dp" (2 gloo
    ranks): the rule keeps them sharded, each rank's share is its two
    clips of the unsharded output, and the whole equals it."""
    ranks = start(_ranks, 2, tmp_path)
    want = torch.ops.ts.nv12_clip_augment(
        *op_args(RULE_CASE, *inputs(RULE_CASE, seed=4))).numpy()
    for rank, (placements, local, whole) in enumerate(ranks.results()):
        assert placements == ["S(0)"]
        np.testing.assert_array_equal(local, want[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(whole, want)
