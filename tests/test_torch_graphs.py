"""tensor_stream_torch/graphs.py (cuda_graph) and the paths that use it,
on the CPU: CPU inputs call the function directly in both forms, the
launch-count arithmetic a replay applies, the signature a capture is keyed
on, the carry check, the fused VPP and the train step (eager on the CPU,
refusing changed hyperparameters once captured). The capture and replay
themselves need a card: the `gpu` tests below, and chip_smoke.py's
serving, pooled, streaming and training phases, which hold every graphed
path bit for bit against its eager run."""
import types

import numpy as np
import pytest
import torch

from tensor_stream_torch import FourCC, Planes, cuda_graph, graphs
from tensor_stream_torch.models import VideoViT, make_vit_train_step
from tensor_stream_torch.models.video_vit import _GraphedStep
from tensor_stream_torch.ops import flash_attention, nv12_rgb
from tensor_stream_torch.ops.vpp import build_vpp_batched_flat
from tensor_stream_torch.tensor_stream import FrameParameters


def test_stateless_form_calls_fn_directly_on_cpu():
    calls = []

    def fn(x, scale):
        calls.append(x)
        return {"y": x * scale}

    g = cuda_graph(fn)
    x = torch.arange(4.0)
    for _ in range(3):
        out = g(x, 2.0)
        assert torch.equal(out["y"], x * 2)
    assert len(calls) == 3 and all(c is x for c in calls)
    assert (g.captures, g.replays, g.graphs) == (0, 0, [])


def test_stateful_form_calls_fn_directly_on_cpu():
    def step(carry, x):
        carry["t"].add_(1)
        carry["acc"].add_(x)
        return carry, carry["acc"] * 1.0

    g = cuda_graph(step, carry=True)
    carry = {"t": torch.zeros((), dtype=torch.int64), "acc": torch.zeros(2)}
    for k in range(3):
        got, out = g(carry, torch.ones(2))
        assert got is carry
        assert torch.equal(out, torch.full((2,), k + 1.0))
    assert int(carry["t"]) == 3
    assert (g.captures, g.replays) == (0, 0)


def fake_counters():
    a = types.SimpleNamespace(__name__="a", launches=3,
                              by_kind={"x": 1, "y": 0})
    b = types.SimpleNamespace(__name__="b", launches=0)
    return a, b, ((a, "launches"), (a, "by_kind"), (b, "launches"))


def test_launch_count_arithmetic():
    """What a capture added comes back out (times -1) and goes in again
    at each replay (times 1)."""
    a, b, counters = fake_counters()
    before = graphs.snapshot(counters)
    a.launches += 2
    a.by_kind["y"] += 2
    b.launches += 12
    delta = graphs.difference(graphs.snapshot(counters), before)
    assert delta == {("a", "launches"): 2, ("a", "by_kind"): {"x": 0, "y": 2},
                     ("b", "launches"): 12}
    graphs.add(delta, -1, counters)
    assert graphs.snapshot(counters) == before
    graphs.add(delta, 1, counters)
    graphs.add(delta, 2, counters)
    assert (a.launches, a.by_kind, b.launches) == (9, {"x": 1, "y": 6}, 36)
    assert before[("a", "by_kind")] == {"x": 1, "y": 0}  # a copy


def test_counters_cover_every_kernel_counter():
    """Every count the kernels' reset_counts() zeroes is one a replay
    advances."""
    names = {(mod.__name__, name) for mod, name in graphs.COUNTERS}
    for mod in (nv12_rgb, flash_attention):
        for name, value in vars(mod).items():
            if name.startswith("_") or not isinstance(value, (int, dict)):
                continue
            if isinstance(value, bool) or name.isupper():
                continue
            if isinstance(value, dict) and not all(
                    isinstance(v, int) for v in value.values()):
                continue
            assert (mod.__name__, name) in names, name
    snap = graphs.snapshot()
    graphs.add(graphs.difference(snap, snap))
    assert graphs.snapshot() == snap


def test_signature_keys_shapes_dtypes_strides_and_values():
    x = torch.zeros(2, 3)
    sig = graphs.signature
    assert sig((x, 1)) == sig((torch.ones(2, 3), 1))
    assert sig((x, 1)) != sig((x, 2))
    assert sig((x,)) != sig((torch.zeros(3, 2),))
    assert sig((x,)) != sig((x.double(),))
    assert sig((x,)) != sig((torch.zeros(3, 2).t(),))
    assert sig({"a": x}) != sig({"b": x})
    hash(sig(({"t": x, "blocks": [{"k": x}]}, x)))


def test_carry_check_wants_the_same_tensors():
    carry = {"t": torch.zeros(()), "k": torch.zeros(3)}
    graphs._check_carry((carry, torch.zeros(1)), dict(carry))
    with pytest.raises(ValueError, match="in place"):
        graphs._check_carry(({"t": carry["t"], "k": carry["k"].clone()},
                             None), carry)
    with pytest.raises(TypeError, match="carry, out"):
        graphs._check_carry(carry, carry)


def test_fused_vpp_runs_post_fn_on_cpu():
    """With a post_fn the flat VPP goes through cuda_graph, which calls it
    directly on the CPU: the same result as the VPP then post_fn."""
    cfg = FrameParameters(pixel_format=FourCC.RGB24, planes_pos=Planes.MERGED,
                          normalization=True).to_config(16, 8)
    flat = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, 3 * 16 * 8 * 3 // 2, dtype=np.uint8))

    def post(x):
        return x.mean(dim=(1, 2, 3))

    fused = build_vpp_batched_flat(cfg, 3, "cpu", post_fn=post)
    want = post(build_vpp_batched_flat(cfg, 3, "cpu")(flat))
    assert torch.equal(fused(flat), want)
    assert fused.graphed.captures == 0
    assert build_vpp_batched_flat(cfg, 3, "cpu", post_fn=post) is not fused


def tiny_model():
    return VideoViT(2, depth=1, dim=32, num_heads=2, patch=8, frames=4,
                    size=16, attention="joint", use_flash=True, device="cpu",
                    compute_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0))


def test_train_step_is_eager_on_the_cpu():
    """On the CPU the step is the plain function: it trains, clears the
    gradients, and its losses equal the eager step's that the graph
    wrapper holds."""
    clips = torch.rand(2, 4, 16, 16, 3, generator=torch.Generator()
                       .manual_seed(1))
    mask = torch.tensor([True, False])
    losses = []
    for wrapped in (False, True):
        model = tiny_model()
        opt = torch.optim.SGD(model.parameters(), lr=1e-2, momentum=0.9)
        step = make_vit_train_step(model, opt)
        assert not isinstance(step, _GraphedStep)
        if wrapped:
            step = _GraphedStep(step, opt).graphed.fn
        losses.append([float(step(clips, mask)[0]) for _ in range(3)])
        assert all(p.grad is None for p in model.parameters())
    assert losses[0] == losses[1]
    assert losses[0][2] < losses[0][0]


class _CapturingStub:
    """Stands in for the CudaGraph: its first call counts as a capture."""

    def __init__(self):
        self.captures = 0

    def __call__(self, *args):
        self.captures = 1
        return args


def test_graphed_step_refuses_changed_hyperparameters():
    model = tiny_model()
    opt = torch.optim.SGD(model.parameters(), lr=1e-2, momentum=0.9)
    step = _GraphedStep(lambda clips, mask: None, opt)
    step.graphed = _CapturingStub()
    step(1, 2)
    step(1, 2)
    opt.param_groups[0]["lr"] = 5e-3
    with pytest.raises(ValueError, match="hyperparameters changed"):
        step(1, 2)
    opt.param_groups[0]["lr"] = 1e-2
    opt.param_groups[0]["momentum"] = 0.5
    with pytest.raises(ValueError, match="hyperparameters changed"):
        step(1, 2)


@pytest.mark.gpu
def test_replays_match_eager_on_the_card():
    """A graphed flash forward and a graphed in-place step equal their
    eager runs bit for bit, each replay adds the capture's launches, and
    outputs are copies out of the graph's memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    gen = torch.Generator().manual_seed(3)
    qs = [(torch.randn((1, 2, 128, 64), generator=gen) * 2).to(
        "cuda", torch.bfloat16) for _ in range(4)]

    def attend(q):
        return flash_attention.flash_attention(q, q, q)

    g = cuda_graph(attend)
    with torch.no_grad():
        want = [attend(q) for q in qs]
        flash_attention.reset_counts()
        got = [g(q) for q in qs]
    assert (g.captures, g.replays) == (1, 3)
    assert flash_attention.launches == 4
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert got[2].data_ptr() != got[3].data_ptr()

    def step(carry, x):
        carry["t"].add_(1)
        carry["acc"].mul_(0.5).add_(x)
        return carry, carry["acc"] * carry["t"]

    eager = {"t": torch.zeros((), dtype=torch.int64, device="cuda"),
             "acc": torch.zeros(8, device="cuda")}
    carry = {k: v.clone() for k, v in eager.items()}
    gs = cuda_graph(step, carry=True)
    xs = [torch.randn(8, generator=gen).cuda() for _ in range(5)]
    for x in xs:
        _, want = step(eager, x)
        _, got = gs(carry, x)
        assert torch.equal(got, want)
    assert int(carry["t"]) == 5 and (gs.captures, gs.replays) == (1, 4)
