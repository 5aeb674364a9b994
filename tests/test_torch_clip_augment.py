"""The operator ``ts::clip_augment`` (ops/augment.py) on the CPU: its
plain version, its fake, the constants its CUDA kernel is given, and the
rule chip_smoke.py holds the kernel to.

The kernel itself (csrc/clip_augment.cu) runs only on the card, where
chip_smoke.py's ``clip_augment_vs_plain`` phase holds it against
``clip_augment_plain`` over the cases of ``chip_smoke.AUG_CASES``. Here:

* the operator on CPU tensors is the plain version, bit for bit, over the
  same kinds of case at a small size, and ``make_clip_augment_fn`` calls
  it (the identity config calls nothing);
* the fake gives the real output's shape, dtype and strides;
* ``pack_constants`` (the kernel's gray weights, YIQ matrices with the
  BGR permutation, mean, std, unit) reproduces the plain version's
  numbers: ``emulate`` below, the kernel's per-pixel arithmetic written in
  torch on those constants, equals the plain version bit for bit;
* ``chip_smoke.augment_rule`` fails the emulated kernel with each of four
  faults (the contrast mean over one frame, the flip one column over,
  the erase rect one row low, u8 rounded half up).

tests/test_torch_augment.py holds the plain version to the JAX package.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import chip_smoke
from tensor_stream_torch import graphs
from tensor_stream_torch.ops import augment as aug
from tensor_stream_torch.ops.augment import AugmentConfig

F32, BF16, F16, U8 = torch.float32, torch.bfloat16, torch.float16, torch.uint8
SPATIAL = dict(width=24, height=20, scale=(0.3, 1.0), ratio=(0.75, 4 / 3),
               hflip=0.5)
JITTER = dict(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.05)
NORM = dict(mean=(0.45, 0.45, 0.45), std=(0.225, 0.225, 0.225))
BENCH = AugmentConfig(**SPATIAL, **JITTER, **NORM, erase=0.5)
U8_CFG = AugmentConfig(**SPATIAL, **JITTER, erase=0.5)
B, T, SH, SW = 4, 3, 30, 40

# (name, config, frames, source (h, w), planar, input dtype, output dtype,
# unit, bgr): chip_smoke.AUG_CASES's kinds at a small size.
CASES = [
    ("planar_rgb_f32", BENCH, T, (SH, SW), True, F32, F32, 1.0, False),
    ("merged_bgr_f32", BENCH, T, (SH, SW), False, F32, F32, 1.0, True),
    ("planar_rgb_bf16", BENCH, T, (SH, SW), True, F32, BF16, 1.0, False),
    ("merged_bgr_bf16", BENCH, T, (SH, SW), False, F32, BF16, 1.0, True),
    ("planar_bgr_f16", BENCH, T, (SH, SW), True, F32, F16, 1.0, True),
    ("planar_rgb_u8", U8_CFG, T, (SH, SW), True, U8, U8, 255.0, False),
    ("merged_bgr_u8", U8_CFG, T, (SH, SW), False, U8, U8, 255.0, True),
    ("u8_to_f32_normalized", AugmentConfig(
        **SPATIAL, **JITTER, mean=(114.75,) * 3, std=(57.375,) * 3),
     T, (SH, SW), True, U8, F32, 255.0, False),
    ("bf16_input", BENCH, T, (SH, SW), False, BF16, F32, 1.0, False),
    ("erase_flip", AugmentConfig(**{**SPATIAL, "hflip": 1.0}, **NORM,
                                 erase=1.0),
     T, (SH, SW), True, F32, F32, 1.0, False),
    ("contrast_only", AugmentConfig(contrast=0.4), T, (SH, SW), True, F32,
     F32, 1.0, False),
    ("jitter_no_spatial", AugmentConfig(**JITTER, **NORM), T, (SH, SW),
     False, F32, F32, 1.0, True),
    ("frames_t1", BENCH, 1, (SH, SW), True, F32, F32, 1.0, False),
    ("w42_planar_f32", AugmentConfig(**{**SPATIAL, "width": 42,
                                        "height": 30}, **JITTER, **NORM),
     T, (48, 64), True, F32, F32, 1.0, False),
    ("flip_only_w42", AugmentConfig(hflip=1.0), T, (30, 42), False, U8, U8,
     255.0, False),
    ("u8_halving", AugmentConfig(width=SW // 2, height=SH // 2), T,
     (SH, SW), True, U8, U8, 255.0, False),
    ("wide_source", AugmentConfig(**SPATIAL, **JITTER, **NORM, erase=0.5),
     2, (24, 300), False, F32, F32, 1.0, False),
]
IDS = [c[0] for c in CASES]


def inputs(case, seed=0):
    _, cfg, t, (h, w), planar, in_dt, _, _, _ = case
    rng = np.random.default_rng(seed)
    shape = (B, t, 3, h, w) if planar else (B, t, h, w, 3)
    if in_dt == U8:
        clips = torch.from_numpy(rng.integers(0, 256, shape, np.uint8))
    else:
        clips = torch.from_numpy(rng.random(shape, np.float32)).to(in_dt)
    ids = np.stack([np.zeros(B, np.int64), np.arange(B)], axis=1)
    return clips, torch.from_numpy(aug.sample_clip_params(cfg, h, w, seed,
                                                          ids))


def op_args(case, clips, params):
    _, cfg, _, (h, w), planar, _, out_dt, unit, bgr = case
    out_w, out_h = cfg.output_size(w, h)
    return (clips, params, planar, out_h, out_w, aug.op_flags(cfg),
            list(cfg.mean or (0.0,) * 3), list(cfg.std or (1.0,) * 3), unit,
            bgr, out_dt)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_operator_on_the_cpu_is_the_plain_version(case):
    clips, params = inputs(case)
    args = op_args(case, clips, params)
    got = torch.ops.ts.clip_augment(*args)
    want = aug.clip_augment_plain(*args)
    assert got.dtype == case[6] and got.is_contiguous()
    assert torch.equal(got, want)
    _, cfg, _, (h, w), planar, _, out_dt, unit, bgr = case
    fn = aug.make_clip_augment_fn(cfg, h, w, planar, unit, bgr, out_dt)
    assert torch.equal(fn(clips, params), want)


def test_identity_calls_no_operator(monkeypatch):
    """AugmentConfig() is the cast alone: the operator (the kernel on the
    card) is not called."""
    def refuse(*args):
        raise AssertionError("the identity called ts::clip_augment")
    monkeypatch.setattr(aug, "_OP", refuse)
    clips = torch.rand(2, 3, 8, 6, 3)
    params = torch.zeros(2, len(aug.PARAMS))
    fn = aug.make_clip_augment_fn(AugmentConfig(), 8, 6, False,
                                  out_dtype=BF16)
    assert torch.equal(fn(clips, params), clips.to(BF16))
    assert aug.op_flags(AugmentConfig()) == 0


def test_op_flags_name_each_operation():
    assert aug.op_flags(BENCH) == sum(1 << k for k in range(len(aug.OPS)))
    assert aug.op_flags(AugmentConfig(hflip=0.5)) == 1 << aug.OPS.index(
        "flip")
    assert aug.op_flags(AugmentConfig(width=8, height=8)) == 1
    assert aug.op_flags(AugmentConfig(contrast=0.1, **NORM)) == (
        1 << aug.OPS.index("contrast") | 1 << aug.OPS.index("normalize"))


@pytest.mark.parametrize("planar", [True, False], ids=["planar", "merged"])
@pytest.mark.parametrize("out_dt", [F32, BF16, F16, U8],
                         ids=["f32", "bf16", "f16", "u8"])
def test_fake_matches_the_real_op(planar, out_dt):
    case = ("fake", BENCH, T, (SH, SW), planar, F32, out_dt, 1.0, False)
    args = op_args(case, *inputs(case))
    real = torch.ops.ts.clip_augment(*args)
    with FakeTensorMode() as mode:
        fake = torch.ops.ts.clip_augment(*[
            mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
            for a in args])
    assert (tuple(fake.shape), fake.dtype, fake.stride()) == (
        tuple(real.shape), real.dtype, real.stride())
    assert tuple(real.shape) == ((B, T, 3, 20, 24) if planar
                                 else (B, T, 20, 24, 3))
    torch.library.opcheck(torch.ops.ts.clip_augment, args,
                          test_utils=("test_schema", "test_faketensor"))


def test_launch_dims_check_what_the_kernel_takes():
    ops = aug.op_flags(BENCH)
    dims = aug.launch_dims((16, 8, 3, 224, 224), F32, (16, 14), True, 224,
                           224, ops, F32)
    assert dims.tolist() == [16, 8, 224, 224, 224, 224, ops, 1, 0, 0, 32]
    flip = 1 << aug.OPS.index("flip")
    dims = aug.launch_dims((2, 1, 30, 42, 3), U8, (2, 14), False, 30, 42,
                           flip, U8)
    assert dims.tolist()[6:] == [flip, 0, 1, 3, 30]  # a block a source row
    good = ((2, 8, 3, 20, 20), F32, (2, 14), True, 20, 20, ops, F32)
    bad = [(0, (2, 8, 3, 20), ValueError, "expected"),
           (0, (2, 8, 4, 20, 20), ValueError, "expected"),
           (1, torch.float64, TypeError, "reads"),
           (2, (3, 14), ValueError, "params"),
           (7, torch.float64, TypeError, "writes"),
           (0, (2, 8, 3, 20, 60000), ValueError, "shared memory")]
    for i, value, err, match in bad:
        args = list(good)
        args[i] = value
        with pytest.raises(err, match=match):
            aug.launch_dims(*args)
    with pytest.raises(ValueError, match="grid"):
        aug.launch_dims((70000, 8, 3, 20, 20), F32, (70000, 14), True, 20,
                        20, ops, F32)
    with pytest.raises(ValueError, match="spatial"):
        aug.launch_dims((2, 8, 3, 20, 20), F32, (2, 14), True, 10, 10,
                        1 << aug.OPS.index("contrast"), F32)


def test_cuda_kernel_refuses_cpu_tensors():
    """On the CPU the dispatcher runs the plain version; the kernel's
    wrapper itself takes CUDA tensors only and never falls back."""
    case = CASES[0]
    with pytest.raises(ValueError, match="CUDA"):
        aug._clip_augment_cuda(*op_args(case, *inputs(case)))


def test_graph_replays_advance_the_kernel_counts():
    names = {(mod.__name__, name) for mod, name in graphs.COUNTERS}
    assert (aug.__name__, "launches") in names
    assert (aug.__name__, "launches_by_pass") in names
    aug.reset_counts()
    assert aug.launches == 0 and set(aug.launches_by_pass.values()) == {0}


@pytest.mark.parametrize("bgr", [False, True], ids=["rgb", "bgr"])
def test_packed_constants_are_the_plain_versions(bgr):
    k = aug.pack_constants((0.1, 0.2, 0.3), (0.4, 0.5, 0.6), 255.0, bgr)
    assert k.dtype == np.float32 and k.shape == (28,)
    gray, yiq, inv = aug.channel_mixes(bgr)
    assert np.array_equal(k[:3], gray) and np.array_equal(
        k[3:12], yiq.reshape(-1)) and np.array_equal(k[12:21],
                                                     inv.reshape(-1))
    assert np.array_equal(k[21:], np.float32([0.1, 0.2, 0.3, 0.4, 0.5, 0.6,
                                              255.0]))
    rgb = aug.pack_constants((0.0,) * 3, (1.0,) * 3, 1.0, False)
    if bgr:  # gray weights and YIQ columns reversed, YIQ->RGB rows
        assert np.array_equal(k[:3], rgb[:3][::-1])
        assert np.array_equal(k[3:12].reshape(3, 3),
                              rgb[3:12].reshape(3, 3)[:, ::-1])
        assert np.array_equal(k[12:21].reshape(3, 3),
                              rgb[12:21].reshape(3, 3)[::-1])
    # The YIQ pair inverts in either channel order.
    m = k[12:21].reshape(3, 3).astype(np.float64) @ k[3:12].reshape(
        3, 3).astype(np.float64)
    np.testing.assert_allclose(m, np.eye(3), atol=1e-6)


def emulate(clips, params, planar, out_h, out_w, ops, consts, out_dtype,
            fault=None):
    """The kernel's per-pixel arithmetic (csrc/clip_augment.cu: Coord,
    MakeTaps, Lerp, Colour, the erase compares, the cast) in float32
    torch ops, one rounding a step as its _rn intrinsics round, on the
    packed constants; the clip's mean gray as torch sums it. `fault`
    emulates a kernel at fault: "frame_mean" (contrast against each
    frame's mean gray), "flip_shift" (a flipped clip read one column to
    the right), "erase_low" (the erase rect one row low) or "half_up"
    (u8 rounded half up)."""
    on = {k: bool(ops & bit) for k, bit in aug.OP_BITS.items()}
    k = torch.from_numpy(consts.copy())
    gray, yiq, inv = k[:3], k[3:12].view(3, 3), k[12:21].view(3, 3)
    mean, std, unit = k[21:24], k[24:27], k[27]
    x = clips.to(F32)
    x = torch.movedim(x, 2, -1) if planar else x  # [B, T, H, W, 3]
    b, t, h, w, _ = x.shape
    p = params.to(F32)
    col = {n: i for i, n in enumerate(aug.PARAMS)}
    if on["resize"] or on["flip"]:
        if on["rect"]:
            y0, x0, rh, rw = (p[:, i:i + 1] for i in range(4))
        else:
            y0, x0 = torch.zeros(b, 1), torch.zeros(b, 1)
            rh, rw = torch.full((b, 1), float(h)), torch.full((b, 1),
                                                              float(w))
        flip = (p[:, col["flip"]:col["flip"] + 1] > 0.5) & on["flip"]

        def coord(n, start, extent, fl):
            u = (torch.arange(n, dtype=F32) + 0.5) * (extent / n)
            u = torch.where(fl, extent - u, u)
            return (start + u) - 0.5

        def taps(c, size):
            lo = torch.floor(c)
            i = lo.to(torch.int64)
            return i.clamp(0, size - 1), (i + 1).clamp(0, size - 1), c - lo
        ys = coord(out_h, y0, rh, torch.zeros_like(flip))
        xs = coord(out_w, x0, rw, flip)
        if fault == "flip_shift":
            xs = torch.where(flip, xs + 1.0, xs)
        y_0, y_1, ty = taps(ys, h)
        x_0, x_1, tx = taps(xs, w)
        bi = torch.arange(b)[:, None, None, None]
        ti = torch.arange(t)[None, :, None, None]

        def tap(yi, xi):
            return x[bi, ti, yi[:, None, :, None], xi[:, None, None, :]]
        ty = ty[:, None, :, None, None]
        tx = tx[:, None, None, :, None]

        def lerp(a, c, f):
            return a * (1.0 - f) + c * f
        x = lerp(lerp(tap(y_0, x_0), tap(y_1, x_0), ty),
                 lerp(tap(y_0, x_1), tap(y_1, x_1), ty), tx)

    def per_clip(name):
        return p[:, col[name]].view(b, 1, 1, 1, 1)

    def dot(v, wt):
        return (v[..., 0] * wt[0] + v[..., 1] * wt[1]
                + v[..., 2] * wt[2])[..., None]
    if on["brightness"]:
        x = x * per_clip("brightness")
    if on["contrast"]:
        g = dot(x, gray)
        m = (g.mean(dim=(2, 3, 4), keepdim=True) if fault == "frame_mean"
             else g.flatten(1).mean(dim=1).view(b, 1, 1, 1, 1))
        x = (x - m) * per_clip("contrast") + m
    if on["saturation"]:
        g = dot(x, gray)
        x = g + (x - g) * per_clip("saturation")
    if on["hue"]:
        theta = per_clip("theta")
        c, s = torch.cos(theta), torch.sin(theta)
        lum, i0, q0 = dot(x, yiq[0]), dot(x, yiq[1]), dot(x, yiq[2])
        i1, q1 = c * i0 - s * q0, s * i0 + c * q0
        x = torch.cat([lum * inv[ch, 0] + i1 * inv[ch, 1] + q1 * inv[ch, 2]
                       for ch in range(3)], dim=-1)
    if on["brightness"] or on["contrast"] or on["saturation"] or on["hue"]:
        x = torch.minimum(torch.maximum(x, torch.tensor(0.0)), unit)
    if on["normalize"]:
        x = (x - mean) / std
    if on["erase"]:
        rows = torch.arange(out_h, dtype=F32) - float(fault == "erase_low")
        cols = torch.arange(out_w, dtype=F32)
        e = {n: p[:, col[n]:col[n] + 1] for n in (
            "erase_y0", "erase_x0", "erase_h", "erase_w")}
        ey0, ex0 = e["erase_y0"], e["erase_x0"]
        ey1, ex1 = ey0 + e["erase_h"], ex0 + e["erase_w"]
        in_y = (rows >= ey0) & (rows < ey1)
        in_x = (cols >= ex0) & (cols < ex1)
        do = (p[:, col["erase"]] > 0.5).view(b, 1, 1, 1)
        inside = do & in_y[:, None, :, None] & in_x[:, None, None, :]
        x = torch.where(inside[..., None], 0.0, x)
    if planar:
        x = torch.movedim(x, -1, 2)
    if out_dtype == U8:
        r = (torch.floor(x + 0.5) if fault == "half_up" else torch.round(x))
        return r.clamp(0.0, 255.0).to(U8).contiguous()
    return x.to(out_dtype).contiguous()


def emulated_case(case, fault=None, clips=None):
    c, params = inputs(case)
    clips = c if clips is None else clips
    args = op_args(case, clips, params)
    consts = aug.pack_constants(tuple(args[6]), tuple(args[7]), args[8],
                                args[9])
    got = emulate(clips, params, *args[2:6], consts, args[10], fault)
    return got, aug.clip_augment_plain(*args), args[10]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_arithmetic_on_packed_constants_is_the_plain_version(case):
    got, want, out_dt = emulated_case(case)
    assert torch.equal(got, want)
    assert chip_smoke.augment_rule(got, want, out_dt)[0]


def clips_of_changing_frames(case):
    """Frames of a clip at rising brightness, so that each frame's mean
    gray is far from the clip's."""
    clips, _ = inputs(case)
    ramp = (torch.arange(case[2], dtype=F32) + 1.0) / case[2]
    return clips * ramp.view(1, -1, 1, 1, 1)


CASE = dict(zip(IDS, CASES))
FAULTS = [("frame_mean", CASE["planar_rgb_f32"]),
          ("flip_shift", CASE["erase_flip"]),
          ("erase_low", CASE["erase_flip"]),
          ("half_up", CASE["u8_halving"])]


@pytest.mark.parametrize("fault,case", FAULTS, ids=[f for f, _ in FAULTS])
def test_augment_rule_sees_kernel_faults(fault, case):
    """chip_smoke.augment_rule passes the kernel's arithmetic and fails it
    with each fault: a check that cannot fail proves nothing."""
    clips = clips_of_changing_frames(case) if fault == "frame_mean" else None
    sound, want, out_dt = emulated_case(case, None, clips)
    assert chip_smoke.augment_rule(sound, want, out_dt)[0]
    faulty, want, out_dt = emulated_case(case, fault, clips)
    passed, nums = chip_smoke.augment_rule(faulty, want, out_dt)
    assert not passed, nums


def test_augment_rule_bounds():
    rule = chip_smoke.augment_rule
    want = torch.linspace(-2.0, 2.0, 1000)
    assert rule(want + 9e-5, want, F32)[0]
    assert not rule(want + 2e-4, want, F32)[0]
    wb = want.to(BF16)
    step = (wb.to(F32) * (1 + 2.0 ** -8)).to(BF16)  # at most one bf16 step
    assert rule(step, wb, BF16)[0]
    assert not rule((wb.to(F32) * 1.02).to(BF16), wb, BF16)[0]
    wu = torch.arange(200, dtype=torch.int32).to(U8).repeat(10)
    one = wu.clone()
    one[:15] += 1  # 0.75% of the values one apart
    assert rule(one, wu, U8)[0]
    assert not rule(wu + 1, wu, U8)[0]  # every value
    two = wu.clone()
    two[0] += 2
    assert not rule(two, wu, U8)[0]
    assert not rule(wu.to(F32), wu, U8)[0]
    assert not rule(want[:10], want, F32)[0]
