"""The port's streaming step (tensor_stream_torch/models/streaming.py)
against the JAX package's, on the CPU, at the tiny configuration of
tests/test_streaming.py: 2 clips of 8 frames of 32², depth 2, dim 32,
patch 8, tubelet 2.

The flax parameters are initialized, shifted by seeded numpy noise (so
biases and LayerNorm scales are not their trivial init) and converted
with ``vit_state_dict_from_flax``; the same numpy clips go through both
packages. The JAX side runs under matmul precision "highest".

Tolerances: f32 rtol 2e-5 / atol 2e-6, tests/test_streaming.py's rule for
two programs of the same f32 math that sum in different orders; bf16
0.05 with equal argmax, its bf16 rule. The engine-level test takes 1e-4,
as tests/test_torch_serving.py does: the two packages' RGB may differ by
one u8 step on rare pixels.
"""
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_stream_tpu import FourCC as JFourCC
from tensor_stream_tpu import Planes as JPlanes
from tensor_stream_tpu.models import streaming as jstreaming
from tensor_stream_tpu.models.video_vit import VideoViT as FlaxViT
from tensor_stream_tpu.serving import StreamInferencer as JaxInferencer
from tensor_stream_torch import FourCC, Planes
from tensor_stream_torch.models import (VideoViT, clone_cache,
                                        init_stream_cache,
                                        stream_cache_from_jax, stream_step,
                                        vit_state_dict_from_flax)
from tensor_stream_torch.serving import StreamInferencer

B, T, SIDE = 2, 8, 32
TUB = 2
STEPS = T // TUB
CFG = dict(num_classes=3, depth=2, dim=32, num_heads=2, patch=8,
           tubelet_t=TUB, causal=True)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
F32 = dict(rtol=2e-5, atol=2e-6)
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
BBB = os.path.join(FIXTURES, "bbb_720x480_RGB24_250.h264")    # 250 frames
SHORT = os.path.join(FIXTURES, "synthetic_320x240_30_bt709full.h264")  # 30


@pytest.fixture(autouse=True)
def highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def pair(dtype="f32", seed=0, **kw):
    """(flax model, params, port model with the converted weights)."""
    jdt, tdt = DTYPES[dtype]
    cfg = {**CFG, **kw}
    jm = FlaxViT(compute_dtype=jdt, **cfg)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((B, T, SIDE, SIDE, 3), jnp.float32))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)
    tm = VideoViT(compute_dtype=tdt, frames=T, size=SIDE, device="cpu", **cfg)
    tm.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), tm


def clips_of(seed=1, n_frames=T):
    return np.random.default_rng(seed).uniform(
        0, 1, (B, n_frames, SIDE, SIDE, 3)).astype(np.float32)


def tubelet(clips, t):
    return clips[:, t * TUB:(t + 1) * TUB]


def jax_stream(jm, params, clips, max_steps, cache=None, first=0):
    """Per-step logits [B, steps, C] of the JAX stream, and its cache."""
    if cache is None:
        cache = jstreaming.init_stream_cache(jm, params, B, max_steps)
    step = jax.jit(partial(jstreaming.stream_step, jm, params))
    out = []
    for t in range(first, clips.shape[1] // TUB):
        cache, logits = step(cache, jnp.asarray(tubelet(clips, t)))
        out.append(np.asarray(logits))
    return np.stack(out, axis=1), cache


def port_stream(tm, clips, max_steps, cache=None, first=0):
    """Per-step logits [B, steps, C] of the port's stream, and its cache."""
    if cache is None:
        cache = init_stream_cache(tm, B, max_steps)
    out = []
    with torch.no_grad():
        for t in range(first, clips.shape[1] // TUB):
            cache, logits = stream_step(tm, cache,
                                        torch.from_numpy(tubelet(clips, t)))
            out.append(logits.numpy())
    return np.stack(out, axis=1), cache


@pytest.mark.parametrize("kv_heads", [None, 2], ids=["mha", "gqa_4_to_2"])
def test_stream_matches_jax_stream_f32(kv_heads):
    """Per-step f32 logits equal the JAX stream_step's; under GQA the
    cache holds only the kv heads."""
    heads = 2 if kv_heads is None else 4
    jm, params, tm = pair(num_heads=heads, num_kv_heads=kv_heads)
    clips = clips_of()
    want, jcache = jax_stream(jm, params, clips, STEPS)
    got, cache = port_stream(tm, clips, STEPS)
    np.testing.assert_allclose(got, want, **F32)
    assert int(cache["t"]) == int(jcache["t"]) == STEPS
    k = cache["blocks"][0]["k"]
    assert tuple(k.shape) == tuple(jcache["blocks"][0]["k"].shape) == (
        B, (SIDE // 8) ** 2, STEPS, kv_heads or heads, 32 // heads)
    for blk, jblk in zip(cache["blocks"], jcache["blocks"]):
        for name in ("k", "v"):
            np.testing.assert_allclose(blk[name].numpy(),
                                       np.asarray(jblk[name]), **F32)


def test_stream_matches_jax_batch_causal_f32():
    """The port's stream reproduces the JAX batch causal forward's
    per-step logits."""
    jm, params, tm = pair()
    clips = clips_of()
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(clips)))
    got, _ = port_stream(tm, clips, STEPS)
    np.testing.assert_allclose(got, want, **F32)


def test_stream_matches_jax_stream_bf16():
    """bf16 compute: the cache is bf16, logits agree to the bf16 rule and
    the argmax is equal at every step."""
    jm, params, tm = pair(dtype="bf16")
    clips = clips_of()
    want, _ = jax_stream(jm, params, clips, STEPS)
    got, cache = port_stream(tm, clips, STEPS)
    assert cache["blocks"][0]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_ring_slot_matches_a_large_cache():
    """Past max_steps step t overwrites slot t % S: block-0 k depends only
    on the current frames, so it equals a large cache's entry t; before
    the wrap the two runs agree everywhere, and both agree with the JAX
    ring."""
    jm, params, tm = pair()
    S, n_steps = 3, 5
    clips = clips_of(seed=2, n_frames=n_steps * TUB)
    ring = init_stream_cache(tm, B, S)
    big = init_stream_cache(tm, B, n_steps)
    jring = jstreaming.init_stream_cache(jm, params, B, S)
    jstep = jax.jit(partial(jstreaming.stream_step, jm, params))
    with torch.no_grad():
        for t in range(n_steps):
            frames = torch.from_numpy(tubelet(clips, t))
            ring, ring_logits = stream_step(tm, ring, frames)
            big, big_logits = stream_step(tm, big, frames)
            jring, jlogits = jstep(jring, jnp.asarray(tubelet(clips, t)))
            np.testing.assert_allclose(ring_logits.numpy(),
                                       np.asarray(jlogits), **F32)
            if t < S:
                np.testing.assert_allclose(ring_logits.numpy(),
                                           big_logits.numpy(), **F32)
            np.testing.assert_allclose(
                ring["blocks"][0]["k"][:, :, t % S].numpy(),
                big["blocks"][0]["k"][:, :, t].numpy(), rtol=1e-5, atol=1e-6,
                err_msg=f"step {t}")
    np.testing.assert_allclose(ring["blocks"][1]["v"].numpy(),
                               np.asarray(jring["blocks"][1]["v"]), **F32)


def test_windowed_twin_matches_ring_beyond_wrap():
    """The port's VideoViT(temporal_window=S) through flash_attention's
    plain version is the batch twin of a max_steps=S ring: equal per-step
    logits at every step, past the wrap too, where the unwindowed causal
    model diverges from the ring."""
    S = 2
    jm, params, tm = pair()
    state = tm.state_dict()
    twins = {}
    for name, window in (("windowed", S), ("full", None)):
        twin = VideoViT(compute_dtype=torch.float32, frames=T, size=SIDE,
                        device="cpu", use_flash=True, flash_impl="plain",
                        temporal_window=window, **CFG)
        twin.load_state_dict(state, strict=True)
        twins[name] = twin
    clips = clips_of()
    got, _ = port_stream(tm, clips, S)
    with torch.no_grad():
        want = twins["windowed"](torch.from_numpy(clips)).numpy()
        full = twins["full"](torch.from_numpy(clips)).numpy()
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got[:, :S], full[:, :S], **F32)
    assert not np.allclose(got[:, S:], full[:, S:], rtol=1e-3, atol=1e-3)


def test_clamp_past_positional_extent_matches_jax():
    """A ring longer than the positional table keeps serving: steps past
    the extent take its last row, finite and equal to the JAX stream."""
    jm, params, tm = pair()
    clips = clips_of(seed=3, n_frames=(STEPS + 3) * TUB)
    want, _ = jax_stream(jm, params, clips, STEPS + 3)
    got, cache = port_stream(tm, clips, STEPS + 3)
    assert np.isfinite(got).all()
    assert int(cache["t"]) == STEPS + 3
    np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_jax_cache_carries_over(dtype):
    """A JAX cache after 2 steps, carried by stream_cache_from_jax (bit
    for bit), continues in the port for 2 more steps as JAX's own 4-step
    run does."""
    jm, params, tm = pair(dtype=dtype)
    clips = clips_of(seed=4)
    want, _ = jax_stream(jm, params, clips, STEPS)
    _, jcache = jax_stream(jm, params, clips[:, :2 * TUB], STEPS)
    carried = stream_cache_from_jax(
        jax.tree_util.tree_map(np.asarray, jcache), device="cpu")
    assert int(carried["t"]) == 2 and carried["t"].dtype == torch.int64
    k = carried["blocks"][1]["k"]
    assert k.dtype == DTYPES[dtype][1]
    assert np.array_equal(k.float().numpy(),
                          np.asarray(jcache["blocks"][1]["k"], np.float32))
    got, cache = port_stream(tm, clips, STEPS, cache=carried, first=2)
    assert int(cache["t"]) == STEPS
    if dtype == "f32":
        np.testing.assert_allclose(got, want[:, 2:], **F32)
    else:
        np.testing.assert_allclose(got, want[:, 2:], rtol=0.05, atol=0.05)
        assert (got.argmax(-1) == want[:, 2:].argmax(-1)).all()


def test_step_updates_in_place_and_clone_keeps_state():
    """stream_step returns the cache it was given, updated; clone_cache
    keeps a state that later steps leave alone."""
    _, _, tm = pair()
    clips = torch.from_numpy(clips_of())
    cache = init_stream_cache(tm, B, STEPS)
    with torch.no_grad():
        out, _ = stream_step(tm, cache, clips[:, :TUB])
        kept = clone_cache(cache)
        stream_step(tm, cache, clips[:, TUB:2 * TUB])
    assert out is cache and int(cache["t"]) == 2 and int(kept["t"]) == 1
    assert not kept["blocks"][0]["k"][:, :, 1].any()
    assert cache["blocks"][0]["k"][:, :, 1].any()


def engine_kwargs(jax_side):
    if jax_side:
        return dict(width=SIDE, height=SIDE, host_resize=True,
                    pixel_format=JFourCC.RGB24, planes_pos=JPlanes.MERGED,
                    normalization=True)
    return dict(width=SIDE, height=SIDE, host_resize=True, device="cpu",
                pixel_format=FourCC.RGB24, planes_pos=Planes.MERGED,
                normalization=True)


def test_stream_inferencer_carry_matches_jax_engine():
    """StreamInferencer(carry=cache) with stream_step over two fixture
    streams, inflight 2, past the ring's wrap: the port's engine yields
    the JAX engine's (stream, frames) sequence and per-tick logits."""
    jm, params, tm = pair()
    ticks, S = 4, 2
    jcache = jstreaming.init_stream_cache(jm, params, 2, S)
    jstep = jax.jit(partial(jstreaming.stream_step, jm, params))
    with JaxInferencer([BBB, SHORT], jstep, per_stream=TUB, carry=jcache,
                       **engine_kwargs(True)) as eng:
        want = [(r.stream, list(r.frames), np.asarray(r.outputs))
                for r in eng.stream(max_batches=ticks, inflight=2)]
    cache = init_stream_cache(tm, 2, S)
    with StreamInferencer([BBB, SHORT], partial(stream_step, tm),
                          per_stream=TUB, carry=cache,
                          **engine_kwargs(False)) as eng:
        got = [(r.stream, list(r.frames), r.outputs.clone())
               for r in eng.stream(max_batches=ticks, inflight=2)]
        assert int(eng.carry["t"]) == ticks
    assert [(s, f) for s, f, _ in got] == [(s, f) for s, f, _ in want]
    assert [f for _, f, _ in got[:2]] == [[1, 2], [1, 2]]
    for (_, _, g), (_, _, w) in zip(got, want):
        assert tuple(g.shape) == (1, CFG["num_classes"])
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4)


def test_on_end_drop_with_a_stream_cache_raises_in_both():
    """Known limit of both engines: on_end="drop" slices every carry leaf
    on axis 0 when a stream ends, and the cache's 0-d step counter has no
    axis 0. SHORT ends after 15 ticks; both packages raise there."""
    jm, params, tm = pair()
    jcache = jstreaming.init_stream_cache(jm, params, 2, STEPS)
    jstep = jax.jit(partial(jstreaming.stream_step, jm, params))
    with pytest.raises(IndexError):
        with JaxInferencer([BBB, SHORT], jstep, per_stream=TUB, carry=jcache,
                           on_end="drop", **engine_kwargs(True)) as eng:
            list(eng.stream())
    cache = init_stream_cache(tm, 2, STEPS)
    with pytest.raises(IndexError):
        with StreamInferencer([BBB, SHORT], partial(stream_step, tm),
                              per_stream=TUB, carry=cache, on_end="drop",
                              **engine_kwargs(False)) as eng:
            list(eng.stream())


def test_non_causal_model_is_refused():
    tm = VideoViT(compute_dtype=torch.float32, frames=T, size=SIDE,
                  device="cpu", **{**CFG, "causal": False})
    cache = init_stream_cache(tm, B, STEPS)
    with pytest.raises(ValueError, match="causal"):
        stream_step(tm, cache, torch.zeros((B, TUB, SIDE, SIDE, 3)))


def test_frames_must_be_one_tubelet():
    _, _, tm = pair()
    cache = init_stream_cache(tm, B, STEPS)
    with pytest.raises(ValueError, match="one tubelet"):
        stream_step(tm, cache, torch.zeros((B, 2 * TUB, SIDE, SIDE, 3)))
