"""The port's StreamInferencer and MultiStreamLoader
(tensor_stream_torch/serving.py, data.py) against the JAX package's, on
the CPU, over two copies of tests/fixtures/bbb_720x480_RGB24_250.h264.

The model test serves a tiny joint-attention flash VideoViT: flax weights
(shifted by seeded noise) converted into the port, f32 compute, JAX's
flash kernel in Pallas interpret mode. Both engines must yield the same
(stream, frames) sequence and logits within 1e-4: the two packages decode
the same NV12 bytes, their RGB may differ by one u8 step on rare pixels
(the contraction freedom of tests/test_torch_color.py), and the f32 model
math differs in reduction order only.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_stream_tpu import FourCC as JFourCC
from tensor_stream_tpu import Planes as JPlanes
from tensor_stream_tpu.models.video_vit import VideoViT as FlaxViT
from tensor_stream_tpu.serving import StreamInferencer as JaxInferencer
from tensor_stream_torch import FourCC, FrameLoader, Planes
from tensor_stream_torch.data import MultiStreamLoader
from tensor_stream_torch.models import VideoViT, vit_state_dict_from_flax
from tensor_stream_torch.serving import StreamInferencer

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
BBB = os.path.join(FIXTURES, "bbb_720x480_RGB24_250.h264")    # 250 frames
SHORT = os.path.join(FIXTURES, "synthetic_320x240_30_bt709full.h264")  # 30

SIDE = 32
KW = dict(width=SIDE, height=SIDE, host_resize=True, device="cpu",
          pixel_format=FourCC.RGB24, planes_pos=Planes.MERGED,
          normalization=True)
JAX_KW = dict(width=SIDE, height=SIDE, host_resize=True,
              pixel_format=JFourCC.RGB24, planes_pos=JPlanes.MERGED,
              normalization=True)
VIT = dict(num_classes=5, depth=2, dim=64, num_heads=2, patch=8,
           tubelet_t=2, attention="joint", use_flash=True)
CLIP = 4


def brightness(batch):
    return batch.float().mean(dim=(1, 2, 3))


def collect(eng, **kw):
    return [(r.stream, list(r.frames), r.outputs.clone())
            for r in eng.stream(**kw)]


def test_vit_logits_match_jax_stream_inferencer():
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

    with JaxInferencer([BBB, BBB], jax_serve, per_stream=CLIP,
                       **JAX_KW) as eng:
        want = [(r.stream, list(r.frames), np.asarray(r.outputs))
                for r in eng.stream(max_batches=3)]
    with StreamInferencer([BBB, BBB], serve, per_stream=CLIP, **KW) as eng:
        got = collect(eng, max_batches=3)
    assert [(s, f) for s, f, _ in got] == [(s, f) for s, f, _ in want]
    assert [f for _, f, _ in got[:2]] == [[1, 2, 3, 4]] * 2
    for (_, _, g), (_, _, w) in zip(got, want):
        assert tuple(g.shape) == (1, VIT["num_classes"])
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=1e-4)


def test_identity_demux_matches_a_single_loader():
    """infer_fn=identity over two copies of one stream: each stream's
    results carry its own frame clock, and the tensors equal a standalone
    FrameLoader's."""
    with FrameLoader(BBB, batch=3, **KW) as ref:
        want = {}
        for _ in range(2):
            tensors, idx = next(ref)
            want.update(zip(idx, tensors))
    with StreamInferencer([BBB, BBB], lambda x: x, per_stream=3,
                          **KW) as eng:
        results = list(eng.stream(max_batches=2))
    assert [r.stream for r in results] == [0, 1, 0, 1]
    for r in results:
        assert r.frames == [r.frames[0] + k for k in range(3)]
        for k, i in enumerate(r.frames):
            assert torch.equal(r.outputs[k], want[i])


def test_multi_stream_loader_concatenates_streams():
    with MultiStreamLoader([BBB, BBB], per_stream=2, **KW) as loader:
        batch, indices = next(loader)
    assert tuple(batch.shape) == (4, SIDE, SIDE, 3)
    assert indices == {0: [1, 2], 1: [1, 2]}
    assert torch.equal(batch[:2], batch[2:])


def test_stats_and_inflight_depth():
    """stats count batches and frames per stream; inflight=3 pipelines
    three ticks deep and yields the same results as the default depth."""
    with StreamInferencer([BBB, BBB], brightness, per_stream=2,
                          **KW) as eng:
        want = collect(eng, max_batches=4)
        stats = eng.stats()
    assert stats["batches"] == 4
    assert stats["frames"] == {0: 8, 1: 8}
    assert stats["total_frames"] == 16
    assert stats["latency_ms"]["p50"] >= 0 and stats["fps"] > 0
    with StreamInferencer([BBB, BBB], brightness, per_stream=2,
                          **KW) as eng:
        got = collect(eng, max_batches=4, inflight=3)
    assert [(s, f) for s, f, _ in got] == [(s, f) for s, f, _ in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        assert torch.equal(a, b)


def test_on_end_drop_matches_jax():
    """Streams of different lengths with on_end='drop': the short one is
    evicted and the long one served to its end, as in the JAX engine."""
    with StreamInferencer([SHORT, BBB], lambda x: x, per_stream=8,
                          on_end="drop", **KW) as eng:
        got = [(r.stream, list(r.frames)) for r in eng.stream()]
        stats = eng.stats()
    with JaxInferencer([SHORT, BBB], lambda x: x, per_stream=8,
                       on_end="drop", **JAX_KW) as eng:
        want = [(r.stream, list(r.frames)) for r in eng.stream()]
    assert got == want
    assert stats["frames"] == {0: 30, 1: 250}
    assert got[-1][0] == 1
    assert sum(1 for s, _ in got if s == 0) == 4    # 3 full ticks + 6
    assert sum(1 for s, _ in got if s == 1) == 32   # 31 full ticks + 2


def test_on_end_drop_evicts_carry_rows():
    """Stateful drop mode: a stream's carry row is sliced out when the
    stream ends, so batch rows and carry rows stay aligned."""
    def infer(carry, batch):
        assert batch.shape[:2] == (carry.shape[0], 8)
        return carry + 1.0, carry[:, None]

    with StreamInferencer([SHORT, BBB], infer, per_stream=8, on_end="drop",
                          carry=torch.zeros(2), **KW) as eng:
        results = list(eng.stream())
        final = eng.carry
    assert final.shape == (0,)
    # The short stream gives 3 full ticks, the long one 31; its last
    # output is its carry before the 31st increment.
    last = results[-1]
    assert last.stream == 1 and tuple(last.outputs.shape) == (1, 1)
    assert float(last.outputs[0, 0]) == 30.0
    assert sum(1 for r in results if r.stream == 0) == 3


def test_stateful_stop_mode_stacks_streams():
    seen = []

    def infer(carry, batch):
        seen.append(tuple(batch.shape))
        return carry + batch.float().mean(dim=(1, 2, 3, 4)), carry[:, None]

    with StreamInferencer([BBB, BBB], infer, per_stream=2,
                          carry=torch.zeros(2), **KW) as eng:
        results = list(eng.stream(max_batches=3))
        carry = eng.carry
    assert seen == [(2, 2, SIDE, SIDE, 3)] * 3
    assert [r.stream for r in results] == [0, 1] * 3
    assert float(carry[0]) == float(carry[1]) > 0


def test_run_drives_to_exhaustion():
    seen = []
    with StreamInferencer([SHORT], lambda x: x, per_stream=8, **KW) as eng:
        eng.run(lambda r: seen.append(len(r.frames)), max_batches=100)
    assert seen == [8, 8, 8, 6]


@pytest.mark.parametrize("kw,exc,match", [
    (dict(pipeline="sharded"), ValueError, "pipeline must be"),
    (dict(pipeline="pooled", carry=torch.zeros(1)), ValueError, "stateless"),
    (dict(pipeline="fused", on_end="drop"), ValueError, "stateless"),
    (dict(on_end="later"), ValueError, "on_end must be"),
    (dict(on_end="drop", loader=object()), ValueError, "engine-owned"),
], ids=["unknown", "pooled", "fused", "on_end", "drop_with_loader"])
def test_argument_errors(kw, exc, match):
    with pytest.raises(exc, match=match):
        StreamInferencer([BBB], lambda x: x, **kw)


def test_inflight_validated():
    with StreamInferencer([BBB], lambda x: x, per_stream=2, **KW) as eng:
        with pytest.raises(ValueError, match="inflight"):
            list(eng.stream(inflight=0))
