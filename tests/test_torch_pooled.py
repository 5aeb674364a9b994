"""The port's PooledStreamLoader and StreamInferencer(pipeline="pooled" |
"fused") (tensor_stream_torch/data.py, serving.py) against the JAX
package's, on the CPU, over the in-repo fixtures.

Tolerances: the loader's bytes and indices are equal (both packages drain
the same native pool and run the same host resize; the plain colour math
of these configurations matched JAX's bytes here). The brightness model's
outputs are held at the JAX package's own rule for this check
(tests/test_serving.py, rtol = atol = 1e-6: a mean over the same frames
in another reduction order). The tiny flax-converted VideoViT is held at
tests/test_torch_serving.py's 1e-4: f32 model math in another reduction
order, through 2 blocks.
"""
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tensor_stream_torch as pts
import tensor_stream_tpu as jts
from tensor_stream_tpu.models.video_vit import VideoViT as FlaxViT
from tensor_stream_tpu.serving import StreamInferencer as JaxInferencer
from tensor_stream_torch import (FourCC, FrameLoader, Planes,
                                 PooledStreamLoader, ResizeType)
from tensor_stream_torch.enums import ColorStandard
from tensor_stream_torch.models import VideoViT, vit_state_dict_from_flax
from tensor_stream_torch.serving import StreamInferencer

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
BBB = os.path.join(FIXTURES, "bbb_720x480_RGB24_250.h264")        # 250
HEADLINE = os.path.join(FIXTURES, "bench_1920x1080_gop25_200.h264")  # 200
SHORT = os.path.join(FIXTURES, "synthetic_320x240_30_bt709full.h264")  # 30
SWITCH = os.path.join(FIXTURES, "switch_320x240_480x360_24.h264")

LOADER_CASES = {
    "y800_bilinear": dict(pixel_format="Y800", planes_pos="PLANAR",
                          width=96, height=64, resize_type="BILINEAR"),
    "rgb24_merged_norm": dict(pixel_format="RGB24", planes_pos="MERGED",
                              normalization=True, width=96, height=64),
}


def kwargs_for(pkg, **kw):
    """`kw` with enum names turned into `pkg`'s enums."""
    out = dict(kw)
    for key, enum in (("pixel_format", pkg.FourCC),
                      ("planes_pos", pkg.Planes),
                      ("resize_type", pkg.ResizeType)):
        if key in out:
            out[key] = enum[out[key]]
    return out


def ticks(loader, n):
    try:
        return [(np.array(t), idx) for t, idx in (next(loader)
                                                  for _ in range(n))]
    finally:
        loader.close()


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_pooled_loader_matches_jax(case):
    kw = LOADER_CASES[case]
    got = ticks(PooledStreamLoader([BBB, HEADLINE], per_stream=4, workers=2,
                                   host_resize=True, device="cpu",
                                   **kwargs_for(pts, **kw)), 3)
    want = ticks(jts.PooledStreamLoader([BBB, HEADLINE], per_stream=4,
                                        workers=2, host_resize=True,
                                        **kwargs_for(jts, **kw)), 3)
    for k, ((g, gi), (w, wi)) in enumerate(zip(got, want)):
        frames = list(range(4 * k + 1, 4 * k + 5))
        assert gi == wi == {0: frames, 1: frames}
        assert g.shape == w.shape and g.dtype == w.dtype
        assert g.shape[0] == 8
        assert np.array_equal(g, w)


def test_pooled_rows_match_frame_loader():
    """Stream k's rows of two ticks are a standalone FrameLoader's first
    batch of 8 over the same stream."""
    kw = dict(pixel_format=FourCC.Y800, planes_pos=Planes.PLANAR, width=96,
              height=64, resize_type=ResizeType.BILINEAR, host_resize=True,
              device="cpu")
    got = ticks(PooledStreamLoader([BBB, HEADLINE], per_stream=4, workers=2,
                                   **kw), 2)
    for k, path in enumerate((BBB, HEADLINE)):
        (want, idx), = ticks(FrameLoader(path, batch=8, **kw), 1)
        assert idx == list(range(1, 9))
        rows = np.concatenate([t[4 * k:4 * k + 4] for t, _ in got])
        assert np.array_equal(rows, want)


def test_end_of_stream_latches_stop_iteration():
    """30 frames a stream, 8 a tick: three ticks, then StopIteration on
    every later next(), as in the JAX loader."""
    kw = dict(per_stream=8, host_resize=True, width=64, height=48)
    seen = {}
    for name, make in (
            ("torch", lambda: PooledStreamLoader([SHORT, SHORT], device="cpu",
                                                 **kw)),
            ("jax", lambda: jts.PooledStreamLoader([SHORT, SHORT], **kw))):
        loader = make()
        try:
            seen[name] = [idx for _, idx in loader]
            for _ in range(2):
                with pytest.raises(StopIteration):
                    next(loader)
        finally:
            loader.close()
    assert seen["torch"] == seen["jax"]
    assert [i[0] for i in seen["torch"]] == [[1, 2, 3, 4, 5, 6, 7, 8],
                                            list(range(9, 17)),
                                            list(range(17, 25))]


def test_renegotiation_latches_runtime_error():
    """Full-frame staging is sized for the first geometry: a stream that
    switches resolution raises RuntimeError on every later next(), after
    as many ticks as the JAX loader serves."""
    served = {}
    for name, make in (
            ("torch", lambda: PooledStreamLoader([SWITCH], per_stream=4,
                                                 device="cpu")),
            ("jax", lambda: jts.PooledStreamLoader([SWITCH], per_stream=4))):
        loader = make()
        try:
            n = 0
            with pytest.raises(RuntimeError, match="resolution"):
                while True:
                    batch, _ = next(loader)
                    assert tuple(batch.shape) == (4, 240, 320, 3)
                    n += 1
            with pytest.raises(RuntimeError, match="resolution"):
                next(loader)
            served[name] = n
        finally:
            loader.close()
    assert served["torch"] == served["jax"] > 0


def test_close_with_parked_drain_returns():
    """A looping pool with prefetch 1 and no consumer: the drain parks on
    the full queue or on the staging pool; close() wakes it and returns,
    and the thread is gone."""
    loader = PooledStreamLoader([BBB, BBB], per_stream=4, host_resize=True,
                                width=64, height=48, loop=True, prefetch=1,
                                device="cpu")
    next(loader)
    time.sleep(0.5)
    assert loader._thread.is_alive()
    t0 = time.monotonic()
    closer = threading.Thread(target=loader.close)
    closer.start()
    closer.join(timeout=15)
    assert not closer.is_alive(), "close() hung"
    assert time.monotonic() - t0 < 15
    assert not loader._thread.is_alive()
    with pytest.raises(StopIteration):
        next(loader)
    loader.close()  # a second close is a no-op


def test_geometry_and_colorimetry_agreement():
    """Without host_resize the streams must share one geometry (the JAX
    loader's ValueError); ColorStandard.AUTO resolves to the standard
    the JAX loader detects."""
    for make in (lambda: PooledStreamLoader([BBB, HEADLINE], device="cpu"),
                 lambda: jts.PooledStreamLoader([BBB, HEADLINE])):
        with pytest.raises(ValueError, match="geometry"):
            make()
    kw = dict(per_stream=2, host_resize=True, width=64, height=48)
    with PooledStreamLoader([SHORT, SHORT], device="cpu",
                            color_standard=ColorStandard.AUTO, **kw) as ours:
        std = ours.params.color_standard
    theirs = jts.PooledStreamLoader([SHORT, SHORT],
                                    color_standard=jts.ColorStandard.AUTO,
                                    **kw)
    try:
        assert std.value == theirs.params.color_standard.value
    finally:
        theirs.close()
    assert std is not ColorStandard.AUTO


# ------------------------------------------------------------- serving

SIDE = 32
KW = dict(width=SIDE, height=SIDE, host_resize=True, device="cpu",
          pixel_format=FourCC.RGB24, planes_pos=Planes.MERGED,
          normalization=True)
JAX_KW = dict(width=SIDE, height=SIDE, host_resize=True,
              pixel_format=jts.FourCC.RGB24, planes_pos=jts.Planes.MERGED,
              normalization=True)
VIT = dict(num_classes=5, depth=2, dim=64, num_heads=2, patch=8,
           tubelet_t=2, attention="joint", use_flash=True)
CLIP = 4


def brightness(batch):
    return batch.float().mean(dim=(1, 2, 3))


def jax_brightness(batch):
    return batch.astype(jnp.float32).mean(axis=(1, 2, 3))


def collect(eng, **kw):
    with eng:
        return [(r.stream, list(r.frames), np.array(r.outputs))
                for r in eng.stream(**kw)]


def assert_same(got, want, tol):
    assert [(s, f) for s, f, _ in got] == [(s, f) for s, f, _ in want]
    for (_, _, g), (_, _, w) in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("pipeline", ["pooled", "fused"])
def test_brightness_matches_per_stream_and_jax(pipeline):
    got = collect(StreamInferencer([BBB, BBB], brightness, per_stream=3,
                                   pipeline=pipeline, **KW), max_batches=3)
    per_stream = collect(StreamInferencer([BBB, BBB], brightness,
                                          per_stream=3, **KW), max_batches=3)
    want = collect(JaxInferencer([BBB, BBB], jax_brightness, per_stream=3,
                                 pipeline=pipeline, **JAX_KW), max_batches=3)
    assert [f for _, f, _ in got[:2]] == [[1, 2, 3]] * 2
    assert_same(got, per_stream, 1e-6)
    assert_same(got, want, 1e-6)


def tiny_vit():
    """The flax model with seeded noise on its weights, and the port's
    model with the same weights."""
    clips0 = np.zeros((1, CLIP, SIDE, SIDE, 3), np.float32)
    jm = FlaxViT(compute_dtype=jnp.float32, flash_impl="pallas", **VIT)
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32),
        jm.init(jax.random.PRNGKey(0), jnp.asarray(clips0)))
    tm = VideoViT(compute_dtype=torch.float32, frames=CLIP, size=SIDE,
                  device="cpu", **VIT)
    tm.load_state_dict(vit_state_dict_from_flax(params), strict=True)

    def jax_serve(batch):
        return jm.apply(params, batch.reshape((-1, CLIP) + batch.shape[1:]))

    def serve(batch):
        return tm(batch.view(-1, CLIP, SIDE, SIDE, 3))
    return serve, jax_serve


@pytest.mark.parametrize("pipeline", ["pooled", "fused"])
def test_vit_matches_per_stream_and_jax(pipeline):
    serve, jax_serve = tiny_vit()
    got = collect(StreamInferencer([BBB, BBB], serve, per_stream=CLIP,
                                   pipeline=pipeline, **KW), max_batches=2)
    per_stream = collect(StreamInferencer([BBB, BBB], serve,
                                          per_stream=CLIP, **KW),
                         max_batches=2)
    want = collect(JaxInferencer([BBB, BBB], jax_serve, per_stream=CLIP,
                                 pipeline=pipeline, **JAX_KW), max_batches=2)
    assert [s for s, _, _ in got] == [0, 1, 0, 1]
    assert all(g.shape == (1, VIT["num_classes"]) for _, _, g in got)
    assert_same(got, per_stream, 1e-4)
    assert_same(got, want, 1e-4)


@pytest.mark.parametrize("pipeline", ["pooled", "fused"])
def test_inflight_depth_preserves_results(pipeline):
    """inflight=3 yields the same sequence as the default depth, the final
    drain's tail included."""
    def run(inflight):
        return collect(StreamInferencer([BBB, BBB], brightness, per_stream=3,
                                        pipeline=pipeline, **KW),
                       max_batches=4, inflight=inflight)
    want = run(1)
    got = run(3)
    assert len(got) == 8
    assert_same(got, want, 0)


def test_fused_runs_to_the_end_of_a_stream():
    seen = []
    with StreamInferencer([SHORT, SHORT], brightness, per_stream=8,
                          pipeline="fused", **KW) as eng:
        eng.run(lambda r: seen.append((r.stream, r.frames[0])),
                max_batches=100)
        stats = eng.stats()
    assert seen == [(0, 1), (1, 1), (0, 9), (1, 9), (0, 17), (1, 17)]
    assert stats["frames"] == {0: 24, 1: 24}


@pytest.mark.parametrize("pipeline", ["pooled", "fused"])
@pytest.mark.parametrize("kw", [
    dict(loader=object()), dict(carry=torch.zeros(1)), dict(on_end="drop")],
    ids=["loader", "carry", "drop"])
def test_pooled_argument_errors_match_jax(pipeline, kw):
    jax_kw = {k: (jnp.zeros(1) if k == "carry" else v) for k, v in kw.items()}
    for make in (lambda: StreamInferencer([BBB], lambda x: x, **kw,
                                          pipeline=pipeline),
                 lambda: JaxInferencer([BBB], lambda x: x, **jax_kw,
                                       pipeline=pipeline)):
        with pytest.raises(ValueError, match="stateless"):
            make()
