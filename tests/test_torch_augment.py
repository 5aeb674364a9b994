"""The port's augmentation (ops/augment.py) against the JAX package's, on
the CPU.

The port draws each clip's parameters on the host and applies them on the
device; the JAX package draws inside its program from a jax.random key.
So ``apply_clip_augment`` is held to JAX's ``make_clip_augment_fn`` with
the parameters that JAX draws from the same key, in the order JAX splits
it (``jax_params`` below). Tolerances: the two sum the clip's mean gray in
another order and XLA may contract a multiply into an add, so float32
outputs (at unit 1.0, after mean/std) agree within 1e-4 absolute, bf16
outputs within that plus one bf16 rounding step, and u8 outputs within 1.

The rest pins the closed forms and invariants (identity, an exact mirror,
gray fixed points, per-clip consistency, a deterministic sampler) and
AugmentConfig's validation, which raises the JAX package's errors.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_stream_tpu.ops import augment as jaug
from tensor_stream_torch.ops import augment as aug
from tensor_stream_torch.ops.augment import AugmentConfig

BENCH = dict(width=24, height=20, scale=(0.3, 1.0), ratio=(0.75, 4 / 3),
             hflip=0.5, brightness=0.4, contrast=0.4, saturation=0.4,
             hue=0.05)
NORM = dict(mean=(0.45, 0.45, 0.45), std=(0.225, 0.225, 0.225))
B, T, SH, SW = 4, 3, 30, 40


def jax_params(cfg, key, src_h, src_w):
    """The parameter row that JAX's make_clip_augment_fn draws from `key`
    (ops/augment.py:226 and its _sample_rect, _factor and erase draws)."""
    jcfg = jaug.AugmentConfig(**cfg.__dict__)
    out_w, out_h = cfg.output_size(src_w, src_h)
    k_rect, k_flip, k_b, k_c, k_s, k_h, k_e = jax.random.split(key, 7)
    row = {"rect_h": src_h, "rect_w": src_w, "brightness": 1.0,
           "contrast": 1.0, "saturation": 1.0}
    if cfg.width and cfg.samples_rect:
        y0, x0, rh, rw = jaug._sample_rect(k_rect, jcfg, src_h, src_w)
        row.update(y0=y0, x0=x0, rect_h=rh, rect_w=rw)
    if cfg.hflip > 0:
        row["flip"] = jax.random.uniform(k_flip) < cfg.hflip
    for name, k in (("brightness", k_b), ("contrast", k_c),
                    ("saturation", k_s)):
        half = getattr(cfg, name)
        if half > 0:
            row[name] = jax.random.uniform(k, minval=max(0.0, 1.0 - half),
                                           maxval=1.0 + half)
    row["theta"] = 2.0 * math.pi * cfg.hue * jax.random.uniform(
        k_h, minval=-1.0, maxval=1.0)
    if cfg.erase > 0:
        ke_p, ke_a, ke_r, ke_y, ke_x = jax.random.split(k_e, 5)
        area = out_h * out_w * jax.random.uniform(
            ke_a, minval=cfg.erase_scale[0], maxval=cfg.erase_scale[1])
        r = jnp.exp(jax.random.uniform(
            ke_r, minval=math.log(cfg.erase_ratio[0]),
            maxval=math.log(cfg.erase_ratio[1])))
        ew = jnp.clip(jnp.sqrt(area * r), 1.0, float(out_w))
        eh = jnp.clip(jnp.sqrt(area / r), 1.0, float(out_h))
        row.update(erase_y0=jax.random.uniform(ke_y) * (out_h - eh),
                   erase_x0=jax.random.uniform(ke_x) * (out_w - ew),
                   erase_h=eh, erase_w=ew,
                   erase=jax.random.uniform(ke_p) < cfg.erase)
    out = np.zeros(len(aug.PARAMS), np.float32)
    for name, value in row.items():
        out[aug.PARAMS.index(name)] = np.float32(np.asarray(value))
    return out


def clips_of(planar, u8, seed=0, b=B):
    rng = np.random.default_rng(seed)
    shape = (b, T, 3, SH, SW) if planar else (b, T, SH, SW, 3)
    if u8:
        return rng.integers(0, 256, shape, np.uint8)
    return rng.random(shape).astype(np.float32)


def run_both(cfg, clips, planar, unit, bgr, out_dtype, seed=11):
    keys = [jax.random.fold_in(jax.random.key(seed), i)
            for i in range(clips.shape[0])]
    params = np.stack([jax_params(cfg, k, SH, SW) for k in keys])
    jdt = {torch.uint8: jnp.uint8, torch.float32: jnp.float32,
           torch.bfloat16: jnp.bfloat16}[out_dtype]
    jfn = jaug.make_clip_augment_fn(jaug.AugmentConfig(**cfg.__dict__), SH,
                                    SW, planar, unit, bgr, jdt)
    want = jax.jit(jax.vmap(jfn))(clips, jnp.stack(keys))
    got = aug.apply_clip_augment(cfg, torch.from_numpy(clips),
                                 torch.from_numpy(params), planar, unit,
                                 bgr, out_dtype)
    return got, np.asarray(want.astype(jnp.float32) if jdt != jnp.uint8
                           else want)


CASES = [  # (planar, bgr, out dtype)
    (True, False, torch.float32), (False, True, torch.float32),
    (True, True, torch.uint8), (False, False, torch.uint8),
    (True, False, torch.bfloat16), (False, True, torch.bfloat16)]


@pytest.mark.parametrize("planar,bgr,out_dtype", CASES,
                         ids=[f"{'planar' if p else 'merged'}-"
                              f"{'bgr' if b else 'rgb'}-{str(d)[6:]}"
                              for p, b, d in CASES])
def test_apply_matches_jax_with_its_draws(planar, bgr, out_dtype):
    u8 = out_dtype == torch.uint8
    if u8:  # u8-valued input, unit 255; mean/std needs a float output
        cfg = AugmentConfig(**BENCH, erase=0.5)
        unit = 255.0
    else:
        cfg = AugmentConfig(**BENCH, **NORM, erase=0.5)
        unit = 1.0
    clips = clips_of(planar, u8)
    got, want = run_both(cfg, clips, planar, unit, bgr, out_dtype)
    assert got.dtype == out_dtype
    assert tuple(got.shape) == want.shape
    if u8:
        diff = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert diff.max() <= 1
        return
    got = got.to(torch.float32).numpy()
    tol = 1e-4
    if out_dtype == torch.bfloat16:
        # One bf16 step at the value's scale (7 stored mantissa bits).
        tol = tol + np.abs(want) * 2.0 ** -7
    assert np.all(np.abs(got - want) <= tol)
    # The erase and flip draws of JAX's keys did fire somewhere.
    assert (want == 0).any()


def test_frame_fn_is_the_clip_fn_of_one_frame():
    cfg = AugmentConfig(**BENCH, **NORM)
    frames = torch.from_numpy(clips_of(True, False)[:, 0])
    params = torch.from_numpy(aug.sample_clip_params(
        cfg, SH, SW, 3, np.stack([np.zeros(B), np.arange(B)], 1)))
    got = aug.make_frame_augment_fn(cfg, SH, SW, True)(frames, params)
    want = aug.make_clip_augment_fn(cfg, SH, SW, True)(frames[:, None],
                                                       params)[:, 0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("u8", [False, True])
def test_identity_changes_nothing(u8):
    cfg = AugmentConfig()
    assert cfg.identity
    clips = torch.from_numpy(clips_of(False, u8))
    params = torch.from_numpy(aug.sample_clip_params(cfg, SH, SW, 0,
                                                     [[0, 1]] * B))
    assert torch.equal(aug.apply_clip_augment(cfg, clips, params, False),
                       clips)


@pytest.mark.parametrize("planar", [True, False])
def test_hflip_is_an_exact_mirror(planar):
    """A same-size flip samples at integer coordinates: t = 0, so the
    result is the mirror bit for bit."""
    cfg = AugmentConfig(hflip=1.0)
    clips = torch.from_numpy(clips_of(planar, False))
    params = torch.from_numpy(aug.sample_clip_params(
        cfg, SH, SW, 5, np.stack([np.zeros(B), np.arange(B)], 1)))
    assert bool((params[:, aug.PARAMS.index("flip")] == 1).all())
    got = aug.apply_clip_augment(cfg, clips, params, planar)
    assert torch.equal(got, clips.flip(-1 if planar else -2))


def test_gray_is_a_fixed_point_of_saturation_and_hue():
    g = clips_of(False, False)[..., :1]
    g = torch.from_numpy(np.broadcast_to(g, g.shape[:-1] + (3,)).copy())
    cfg = AugmentConfig(saturation=0.9, hue=0.5)
    params = torch.from_numpy(aug.sample_clip_params(
        cfg, SH, SW, 1, np.stack([np.zeros(B), np.arange(B)], 1)))
    got = aug.apply_clip_augment(cfg, g, params, False)
    torch.testing.assert_close(got, g, atol=2e-6, rtol=0)


def test_one_transform_a_clip():
    """A clip of one repeated frame comes out as one repeated frame, and
    two clips with different draws differ."""
    cfg = AugmentConfig(**BENCH, **NORM, erase=0.5)
    one = clips_of(True, False)[:, :1]
    clips = torch.from_numpy(np.repeat(one, T, axis=1))
    params = torch.from_numpy(aug.sample_clip_params(
        cfg, SH, SW, 2, np.stack([np.zeros(B), np.arange(B)], 1)))
    got = aug.apply_clip_augment(cfg, clips, params, True)
    for t in range(1, T):
        assert torch.equal(got[:, t], got[:, 0])
    same = torch.from_numpy(np.repeat(one[:1], B, axis=0).repeat(T, 1))
    out = aug.apply_clip_augment(cfg, same, params, True)
    assert not torch.equal(out[0], out[1])


def test_sampler_is_deterministic_per_clip():
    """The same (aug_seed, epoch, identity) gives the same row, whatever
    the other clips of the batch; another epoch or seed another row."""
    cfg = AugmentConfig(**BENCH, **NORM, erase=0.5)
    ids = np.array([[0, 4], [0, 9], [1, 4], [0, 4]])
    a = aug.sample_clip_params(cfg, SH, SW, 7, ids)
    assert a.shape == (4, len(aug.PARAMS)) and a.dtype == np.float32
    assert np.array_equal(a, aug.sample_clip_params(cfg, SH, SW, 7, ids))
    assert np.array_equal(a[0], a[3])
    assert np.array_equal(a[1], aug.sample_clip_params(cfg, SH, SW, 7,
                                                       ids[1:2])[0])
    assert not np.array_equal(a[0], a[1]) and not np.array_equal(a[0], a[2])
    assert not np.array_equal(a[0], aug.sample_clip_params(
        cfg, SH, SW, 8, ids[:1])[0])


def test_sampler_draws_inside_the_jax_ranges():
    cfg = AugmentConfig(**BENCH, **NORM, erase=0.5)
    n = 400
    p = aug.sample_clip_params(cfg, SH, SW, 0,
                               np.stack([np.zeros(n), np.arange(n)], 1))
    col = {k: p[:, i] for i, k in enumerate(aug.PARAMS)}
    area = col["rect_h"] * col["rect_w"] / (SH * SW)
    assert (col["rect_w"] >= 1).all() and (col["rect_w"] <= SW).all()
    assert (col["rect_h"] >= 1).all() and (col["rect_h"] <= SH).all()
    assert (col["y0"] >= 0).all() and (col["y0"] + col["rect_h"] <= SH
                                       + 1e-4).all()
    assert (col["x0"] >= 0).all() and (col["x0"] + col["rect_w"] <= SW
                                       + 1e-4).all()
    assert area.max() <= 1.0 + 1e-6 and area.min() >= 0.25
    for name in ("brightness", "contrast", "saturation"):
        assert (col[name] >= 0.6).all() and (col[name] <= 1.4).all()
    assert np.abs(col["theta"]).max() <= 2 * math.pi * 0.05 + 1e-6
    for name in ("flip", "erase"):
        assert set(np.unique(col[name])) == {0.0, 1.0}
        assert 0.35 < col[name].mean() < 0.65


BAD = [
    (dict(width=224), "together"),
    (dict(width=8, height=8, scale=(0.0, 1.0)), "scale"),
    (dict(width=8, height=8, scale=(0.5, 1.5)), "exceed the frame"),
    (dict(scale=(0.5, 1.0)), "static output size"),
    (dict(ratio=(2.0, 1.0)), "ratio"),
    (dict(hflip=1.5), "probability"),
    (dict(hue=0.7), "hue"),
    (dict(brightness=-0.1), "brightness"),
    (dict(contrast=-0.1), "contrast"),
    (dict(saturation=-0.1), "saturation"),
    (dict(mean=(0.5, 0.5, 0.5)), "mean/std"),
    (dict(mean=(0.5,), std=(0.5,)), "mean/std"),
    (dict(mean=(0.5,) * 3, std=(0.5, 0.0, 0.5)), "nonzero"),
    (dict(erase=1.5), "erase must"),
    (dict(erase=0.5, erase_scale=(0.0, 0.3)), "erase_scale"),
    (dict(erase=0.5, erase_ratio=(2.0, 1.0)), "erase_ratio"),
]


@pytest.mark.parametrize("kwargs,match", BAD, ids=[m + "-" + str(i)
                                                   for i, (_, m)
                                                   in enumerate(BAD)])
def test_config_validation_matches_jax(kwargs, match):
    with pytest.raises(ValueError, match=match) as ours:
        AugmentConfig(**kwargs)
    with pytest.raises(ValueError) as theirs:
        jaug.AugmentConfig(**kwargs)
    assert str(ours.value) == str(theirs.value)
