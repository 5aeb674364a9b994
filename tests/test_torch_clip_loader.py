"""The port's clip loaders (ClipLoader, ClipDataset) and FrameLoader's
augmentation against the JAX package's loaders, on the CPU, over
tests/fixtures/bbb_720x480_RGB24_250.h264 (IDR every 25 frames).

Both packages drive the same native ClipReader, so the clip order of an
epoch (numpy's default_rng(seed + epoch), uniform and segment shuffle) and
the bytes of every batch must be the same: NV12 output (the decoded, or
resized, planes as they are) is compared byte for byte, with the resize
on the host and on the device. Augmented batches cannot match JAX's draws
(jax.random), so they are held to determinism and to resume instead.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_stream_tpu as jts
from tensor_stream_torch import (AugmentConfig, ClipDataset, ClipLoader,
                                 FourCC, FrameLoader, Planes, ResizeType)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "bbb_720x480_RGB24_250.h264")
# 10 clip starts (0, 25, ..., 225) of 4 frames: three batches of 3 an epoch.
KW = dict(clip_len=4, batch=3, clip_step=25, seed=5, workers=1)
GEOMETRY = {"native": dict(),
            "host_resize": dict(host_resize=True, width=96, height=64,
                                resize_type=ResizeType.BILINEAR),
            "device_resize": dict(width=96, height=64,
                                  resize_type=ResizeType.BICUBIC)}
AUG = AugmentConfig(width=48, height=40, scale=(0.3, 1.0),
                    ratio=(0.75, 4 / 3), hflip=0.5, brightness=0.4,
                    contrast=0.4, saturation=0.4, hue=0.05,
                    mean=(0.45,) * 3, std=(0.225,) * 3, erase=0.5)
AUG_KW = dict(pixel_format=FourCC.RGB24, planes_pos=Planes.PLANAR,
              normalization=True)


def jax_kwargs(kw):
    out = dict(kw)
    for key, enum in (("resize_type", jts.ResizeType),
                      ("pixel_format", jts.FourCC),
                      ("planes_pos", jts.Planes)):
        if key in out:
            out[key] = enum(out[key].value)
    return out


def epoch(loader):
    """(batches as numpy, their clip identities) of one epoch."""
    out, ids = [], []
    for clips, which in loader:
        out.append(np.asarray(clips))
        ids.append([tuple(int(v) for v in np.atleast_1d(w)) for w in which])
    return out, ids


@pytest.mark.parametrize("shuffle", [True, "segment"])
@pytest.mark.parametrize("geometry", list(GEOMETRY))
def test_clip_loader_matches_jax(shuffle, geometry):
    kw = dict(KW, shuffle=shuffle, pixel_format=FourCC.NV12,
              **GEOMETRY[geometry])
    with ClipLoader(FIXTURE, device="cpu", **kw) as ours, \
            jts.ClipLoader(FIXTURE, **jax_kwargs(kw)) as theirs:
        got, got_ids = epoch(ours)
        want, want_ids = epoch(theirs)
        assert len(ours) == len(theirs) == 3
    assert got_ids == want_ids and len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert np.array_equal(g, w)


@pytest.mark.parametrize("shuffle", [True, "segment"])
def test_clip_dataset_matches_jax(shuffle):
    kw = dict(KW, batch=4, shuffle=shuffle, pixel_format=FourCC.NV12,
              drop_partial=False, **GEOMETRY["host_resize"])
    files = [FIXTURE, FIXTURE]
    with ClipDataset(files, device="cpu", **kw) as ours, \
            jts.ClipDataset(files, **jax_kwargs(kw)) as theirs:
        got, got_ids = epoch(ours)
        want, want_ids = epoch(theirs)
        assert ours.state() == theirs.state()
        assert (ours.state()["epoch"], ours.state()["start_clip"]) == (0, 20)
    assert got_ids == want_ids and len(got) == 5  # 20 clips, a tail of 0
    assert got[-1].shape[0] == 4
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_rgb_clips_within_the_colour_rule_of_jax():
    """RGB after a device resize: the bytes of the resize are exact, and
    the colour conversion keeps the packages' one-step rule
    (tests/test_torch_color.py)."""
    kw = dict(KW, shuffle=False, pixel_format=FourCC.RGB24,
              planes_pos=Planes.MERGED, **GEOMETRY["device_resize"])
    with ClipLoader(FIXTURE, device="cpu", **kw) as ours, \
            jts.ClipLoader(FIXTURE, **jax_kwargs(kw)) as theirs:
        got, _ = next(ours)
        want, _ = next(theirs)
    diff = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.9999


def test_clip_loader_resume_replays_the_same_batches():
    kw = dict(KW, shuffle=True, pixel_format=FourCC.RGB24,
              planes_pos=Planes.PLANAR, normalization=True, augment=AUG,
              **GEOMETRY["device_resize"])
    with ClipLoader(FIXTURE, device="cpu", **kw) as first:
        b0, s0 = next(first)
        state = first.state()
        b1, s1 = next(first)
    assert state["epoch"] == 0 and state["start_clip"] == 3
    with ClipLoader(FIXTURE, device="cpu", epoch=state["epoch"],
                    start_clip=state["start_clip"], **kw) as resumed:
        r1, t1 = next(resumed)
    assert t1 == s1 and torch.equal(r1, b1)
    with ClipLoader(FIXTURE, device="cpu", **kw) as again:
        a0, _ = next(again)
    assert torch.equal(a0, b0)
    assert tuple(b0.shape) == (3, 4, 3, 40, 48) and b0.dtype == torch.float32
    # One draw a clip: clips differ from each other and from the plain VPP.
    assert not torch.equal(b0[0], b0[1])


def test_clip_loader_epochs_reshuffle_and_redraw():
    kw = dict(KW, shuffle=True, pixel_format=FourCC.RGB24,
              planes_pos=Planes.PLANAR, normalization=True, augment=AUG,
              **GEOMETRY["host_resize"])
    with ClipLoader(FIXTURE, device="cpu", **kw) as loader:
        e0, ids0 = epoch(loader)
        e1, ids1 = epoch(loader)
        assert loader.state()["epoch"] == 1
    # drop_partial: 9 of the 10 starts an epoch, each once.
    for ids in (ids0, ids1):
        flat = sum(ids, [])
        assert len(set(flat)) == len(flat) == 9
    assert ids0 != ids1
    with ClipLoader(FIXTURE, device="cpu", epoch=1, **kw) as loader:
        r1, rid1 = epoch(loader)
    assert rid1 == ids1
    assert all(np.array_equal(a, b) for a, b in zip(r1, e1))


def test_identity_augment_equals_the_plain_vpp():
    kw = dict(KW, shuffle=True, **AUG_KW, **GEOMETRY["host_resize"])
    with ClipLoader(FIXTURE, device="cpu", augment=AugmentConfig(),
                    **kw) as aug, ClipLoader(FIXTURE, device="cpu",
                                             **kw) as plain:
        a, sa = next(aug)
        p, sp = next(plain)
    assert sa == sp and torch.equal(a, p)


def test_frame_loader_augment_is_deterministic_and_resumes():
    kw = dict(batch=4, augment=AUG, aug_seed=3, device="cpu", **AUG_KW)
    with FrameLoader(FIXTURE, **kw) as first:
        x0, i0 = next(first)
        x1, i1 = next(first)
        ckpt = first.checkpoint()
    assert i1 == [5, 6, 7, 8] and ckpt["next_index"] == 9
    assert tuple(x0.shape) == (4, 3, 40, 48) and x0.dtype == torch.float32
    with FrameLoader(FIXTURE, start_frame=5, **kw) as resumed:
        r1, j1 = next(resumed)
    assert j1 == i1 and torch.equal(r1, x1)
    with FrameLoader(FIXTURE, **kw) as again:
        a0, _ = next(again)
    assert torch.equal(a0, x0)
    with FrameLoader(FIXTURE, **dict(kw, aug_seed=4)) as other:
        o0, _ = next(other)
    assert not torch.equal(o0, x0)


@pytest.mark.parametrize("make", ["frame", "clip"])
def test_augment_needs_rgb_and_a_float_tensor_for_mean(make):
    def build(**kw):
        if make == "frame":
            return FrameLoader(FIXTURE, batch=2, device="cpu", **kw)
        return ClipLoader(FIXTURE, device="cpu", **KW, **kw)
    with pytest.raises(ValueError, match="RGB24/BGR24"):
        build(augment=AUG, pixel_format=FourCC.NV12)
    with pytest.raises(ValueError, match="float tensor"):
        build(augment=AUG, pixel_format=FourCC.RGB24)


def test_unshuffled_partial_tail_and_len():
    kw = dict(KW, shuffle=False, drop_partial=False, pixel_format=FourCC.Y800)
    with ClipLoader(FIXTURE, device="cpu", **kw) as loader:
        batches, ids = epoch(loader)
        assert len(loader) == 4
    assert [len(b) for b in batches] == [3, 3, 3, 1]
    assert sum(ids, []) == [(s,) for s in range(0, 250, 25)]
    assert batches[0].shape[1:] == (4, 1, 480, 720)
    assert isinstance(batches[0], np.ndarray)
    assert jnp.dtype(batches[0].dtype) == jnp.uint8
