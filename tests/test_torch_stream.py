"""The port's TensorStreamConverter and FrameLoader against the JAX
package's, on the in-repo fixtures, with device="cpu".

Both packages drive the same native decoder, so the NV12 bytes are the
same; the outputs then differ at most by the RGB contraction freedom
documented in tests/test_torch_color.py (one u8 step, >= 99.99% equal).
"""
import os

import jax
import numpy as np
import pytest

import tensor_stream_tpu as jts
import tensor_stream_torch as pts
from tensor_stream_torch.ops import nv12_rgb

from test_torch_color import assert_rgb_close

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
BBB = os.path.join(FIXTURES, "bbb_720x480_RGB24_250.h264")
HEADLINE = os.path.join(FIXTURES, "bench_1920x1080_gop25_200.h264")
SWITCH = os.path.join(FIXTURES, "switch_320x240_480x360_24.h264")


def kwargs_for(pkg, **kw):
    """Enum-valued keyword arguments rebuilt from `pkg`'s own enums."""
    out = {}
    for key, value in kw.items():
        if hasattr(value, "value") and hasattr(pkg, type(value).__name__):
            value = getattr(pkg, type(value).__name__)(value.value)
        out[key] = value
    return out


def host(t):
    return np.asarray(jax.device_get(t)) if isinstance(t, jax.Array) \
        else t.numpy()


READ_CASES = [
    ("merged_u8", dict(pixel_format=pts.FourCC.RGB24)),
    ("planar_f32", dict(pixel_format=pts.FourCC.BGR24,
                        planes_pos=pts.Planes.PLANAR, normalization=True)),
    ("crop_nearest", dict(pixel_format=pts.FourCC.RGB24,
                          crop_coords=(40, 20, 680, 460), width=320,
                          height=224)),
    ("y800", dict(pixel_format=pts.FourCC.Y800, width=360, height=240)),
]


@pytest.mark.parametrize("name,kw", READ_CASES, ids=[c[0] for c in READ_CASES])
def test_read_matches_jax(name, kw):
    outs = []
    for pkg, extra in ((pts, {"device": "cpu"}), (jts, {})):
        r = pkg.TensorStreamConverter(
            BBB, framerate_mode=pkg.FrameRate.BLOCKING, **extra)
        r.initialize()
        r.start()
        try:
            t, index = r.read(return_index=True, **kwargs_for(pkg, **kw))
            outs.append((host(t), index))
        finally:
            r.stop()
    (got, gi), (want, wi) = outs
    assert gi == wi == 1
    if kw["pixel_format"] == pts.FourCC.Y800:
        assert np.array_equal(got, want)
    else:
        assert_rgb_close(got, want)


def test_read_batch_host_resize_matches_jax():
    kw = dict(host_resize=True, width=224, height=224,
              resize_type=pts.ResizeType.BILINEAR,
              pixel_format=pts.FourCC.RGB24, planes_pos=pts.Planes.PLANAR,
              normalization=True, return_index=True)
    outs = []
    for pkg, extra in ((pts, {"device": "cpu"}), (jts, {})):
        r = pkg.TensorStreamConverter(
            BBB, framerate_mode=pkg.FrameRate.BLOCKING, **extra)
        r.initialize()
        r.start()
        try:
            got = [r.read_batch(6, **kwargs_for(pkg, **kw)) for _ in range(2)]
            outs.append([(host(t), idx) for t, idx in got])
        finally:
            r.stop()
    for (got, gi), (want, wi) in zip(*outs):
        assert gi == wi
        assert got.shape == (6, 3, 224, 224)
        assert_rgb_close(got, want)
    assert outs[0][1][1] == list(range(7, 13))


def test_read_batch_full_frame_matches_jax():
    outs = []
    for pkg, extra in ((pts, {"device": "cpu"}), (jts, {})):
        r = pkg.TensorStreamConverter(
            BBB, framerate_mode=pkg.FrameRate.BLOCKING, **extra)
        r.initialize()
        r.start()
        try:
            t, idx = r.read_batch(3, return_index=True,
                                  pixel_format=pkg.FourCC.BGR24)
            outs.append((host(t), idx))
        finally:
            r.stop()
    (got, gi), (want, wi) = outs
    assert gi == wi == [1, 2, 3] and got.shape == (3, 480, 720, 3)
    assert_rgb_close(got, want)


HEADLINE_KW = dict(batch=8, prefetch=3, host_resize=True, width=224,
                   height=224, pixel_format=pts.FourCC.RGB24,
                   planes_pos=pts.Planes.PLANAR, normalization=True)


def take(loader, n):
    out = []
    try:
        for _ in range(n):
            t, idx = next(loader)
            out.append((host(t), idx))
        return out, loader.checkpoint()
    finally:
        loader.close()


def test_headline_loader_matches_jax():
    """The headline FrameLoader config (1080p, host resize to 224x224,
    planar f32) at batch 8: two batches from each package."""
    ours, ckpt = take(pts.FrameLoader(HEADLINE, device="cpu", **HEADLINE_KW),
                      2)
    theirs, jckpt = take(jts.FrameLoader(
        HEADLINE, **kwargs_for(jts, **HEADLINE_KW)), 2)
    assert ckpt == jckpt == {"stream_url": HEADLINE, "next_index": 17}
    for (got, gi), (want, wi) in zip(ours, theirs):
        assert gi == wi and got.shape == (8, 3, 224, 224)
        assert got.dtype == np.float32
        assert_rgb_close(got, want)
    assert nv12_rgb.launches == 0


LOADER_KW = dict(batch=4, prefetch=2, host_resize=True, width=160,
                 height=96, pixel_format=pts.FourCC.BGR24,
                 planes_pos=pts.Planes.MERGED)


@pytest.mark.parametrize("first,second", [(jts, pts), (pts, jts)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_checkpoint_resumes_across_packages(first, second):
    """A checkpoint taken from one package's loader resumes the other's
    at the same frame with the same bytes as the first package's own
    resumed loader."""

    def loader(pkg, **kw):
        extra = {"device": "cpu"} if pkg is pts else {}
        return pkg.FrameLoader(BBB, **extra, **kwargs_for(pkg, **LOADER_KW),
                               **kw)

    _, ckpt = take(loader(first), 2)
    assert ckpt["next_index"] == 9
    [(resumed, ri)] = take(loader(second, start_frame=ckpt["next_index"]),
                           1)[0]
    [(own, oi)] = take(loader(first, start_frame=ckpt["next_index"]), 1)[0]
    assert ri == oi == [9, 10, 11, 12]
    assert_rgb_close(resumed, own)


def test_segment_parallel_matches_serial():
    kw = dict(LOADER_KW, batch=8, device="cpu")
    serial, _ = take(pts.FrameLoader(BBB, **kw), 3)
    parallel, ckpt = take(pts.FrameLoader(BBB, segment_parallel=2, **kw), 3)
    assert ckpt["next_index"] == 25
    for (a, ia), (b, ib) in zip(serial, parallel):
        assert ia == ib
        assert np.array_equal(a, b)


def test_full_frame_loader_latches_renegotiation():
    """Without host_resize the loader cannot change geometry mid-stream:
    it fails with guidance, and again on the next call (latched)."""
    loader = pts.FrameLoader(SWITCH, batch=8, prefetch=1, device="cpu",
                             pixel_format=pts.FourCC.RGB24, buffer_size=32)
    batches = 0
    try:
        with pytest.raises(RuntimeError, match="host_resize"):
            for _ in range(10):
                next(loader)
                batches += 1
        with pytest.raises(RuntimeError, match="host_resize"):
            next(loader)
    finally:
        loader.close()
    assert batches >= 1


def test_loader_end_of_stream_and_drop_partial():
    kw = dict(LOADER_KW, batch=96, device="cpu")
    with pts.FrameLoader(BBB, **kw) as loader:
        sizes = [len(idx) for _, idx in loader]
    assert sizes == [96, 96, 58]
    loader = pts.FrameLoader(BBB, drop_partial=True, **kw)
    try:
        sizes = [t.shape[0] for t, _ in loader]
        assert sizes == [96, 96]
        with pytest.raises(StopIteration):
            next(loader)  # the end is latched
    finally:
        loader.close()


def test_dump_and_processed_tap_write_tensor_bytes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    r = pts.TensorStreamConverter(BBB, framerate_mode=pts.FrameRate.BLOCKING,
                                  enable_dumps=True, device="cpu")
    r.initialize()
    r.start()
    try:
        t = r.read(name="tap", pixel_format=pts.FourCC.RGB24, width=64,
                   height=32)
        r.dump(t, name="out", pixel_format=pts.FourCC.RGB24)
    finally:
        r.stop()
    data = t.numpy().tobytes()
    assert (tmp_path / "Processed_tap.yuv").read_bytes() == data
    assert (tmp_path / "out.yuv").read_bytes() == data


def test_augment_is_not_ported_yet():
    """augment= is ported (tests/test_torch_clip_loader.py holds it): a
    FrameLoader takes an AugmentConfig and refuses, before it opens the
    stream, what the JAX loader refuses."""
    with pytest.raises(ValueError, match="RGB24/BGR24"):
        pts.FrameLoader(BBB, augment=pts.AugmentConfig(hflip=1.0),
                        pixel_format=pts.FourCC.NV12, device="cpu")
    with jts.FrameLoader(BBB, batch=2, augment=jts.AugmentConfig(hflip=1.0),
                         pixel_format=jts.FourCC.RGB24) as theirs, \
            pts.FrameLoader(BBB, batch=2, augment=pts.AugmentConfig(
                hflip=1.0), device="cpu") as ours:
        want, want_idx = next(theirs)
        got, got_idx = next(ours)
    # hflip=1.0 mirrors every frame whatever the draw, so the two agree
    # within the packages' colour rule.
    assert got_idx == want_idx
    assert_rgb_close(got.numpy(), np.asarray(want))
