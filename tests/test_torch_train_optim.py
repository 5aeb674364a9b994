"""The port's one graphed train step (tensor_stream_torch/models/_train.py)
with the optimizers its reference is trained with: Adam and AdamW (optax's
adam/adamw in the JAX package's tests and examples), and a learning-rate
schedule (optax keeps one inside the jitted step).

On the CPU: the capturable switch, the build-time error for an optimizer
whose state was made without it, and the hyperparameter guard (a tensor lr
that a scheduler fills in place is the graph's own input; a float that
changes after the capture raises). On the card (``gpu``): Adam and AdamW,
each driven by a LambdaLR on a tensor lr, through the graphed ViT step,
bit-equal to an eager twin in every loss and parameter over 6 steps; and
a step's own generator registered with its graph: every replay draws
new diffusion timesteps and noise, the bytes an eager twin seeded alike
draws. This file imports no JAX, so its ``gpu`` tests also run where only
the port is installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_train_optim.py
"""
import numpy as np
import pytest
import torch

from tensor_stream_torch.graphs import cuda_graph
from tensor_stream_torch.models import (DiffusionSchedule, VideoViT,
                                        make_vit_train_step)
from tensor_stream_torch.models._train import (_GraphedStep,
                                               graphed_train_step,
                                               make_capturable)
from tensor_stream_torch.models.latent_diffusion import diffusion_draws

OPTIMIZERS = {"adam": torch.optim.Adam, "adamw": torch.optim.AdamW}


def tiny_model(device="cpu", dtype=torch.float32):
    return VideoViT(2, depth=1, dim=32, num_heads=2, patch=8, frames=4,
                    size=16, attention="joint", device=device,
                    compute_dtype=dtype,
                    generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_make_capturable_switches_every_group(name):
    model = tiny_model()
    params = list(model.parameters())
    opt = OPTIMIZERS[name]([{"params": params[:3]},
                            {"params": params[3:], "lr": 1e-4}], lr=1e-3)
    assert not any(g["capturable"] for g in opt.param_groups)
    make_capturable(opt)
    assert all(g["capturable"] for g in opt.param_groups)
    assert opt.defaults["capturable"]
    make_capturable(opt)            # idempotent


def test_make_capturable_leaves_sgd_alone():
    opt = torch.optim.SGD(tiny_model().parameters(), lr=1e-2, momentum=0.9)
    before = [dict((k, v) for k, v in g.items() if k != "params")
              for g in opt.param_groups]
    make_capturable(opt)
    after = [dict((k, v) for k, v in g.items() if k != "params")
             for g in opt.param_groups]
    assert before == after and "capturable" not in after[0]


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_state_made_without_capturable_raises_at_build(name):
    """An optimizer that already stepped without capturable holds host
    state a graph cannot replay: building the graphed step raises, before
    any capture, and says what to do."""
    model = tiny_model()
    opt = OPTIMIZERS[name](model.parameters(), lr=1e-3)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    with pytest.raises(ValueError, match="capturable=True"):
        make_capturable(opt)
    with pytest.raises(ValueError, match="before the optimizer's first"):
        graphed_train_step(lambda: None, opt, torch.device("cuda", 0))


def test_cpu_step_is_the_step_and_keeps_the_optimizer():
    """On the CPU the step runs eagerly: graphed_train_step returns it as
    it is and switches nothing (capturable Adam has no CPU kernels)."""
    model = tiny_model()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def step():
        return None
    assert graphed_train_step(step, opt, "cpu") is step
    assert not opt.param_groups[0]["capturable"]
    assert make_vit_train_step(model, opt).__name__ == "step"


class _CapturingStub:
    """Stands in for the CudaGraph: its first call counts as a capture."""

    def __init__(self):
        self.captures = 0

    def __call__(self, *args):
        self.captures = 1
        return args


def test_scheduled_tensor_lr_passes_the_guard():
    """A LambdaLR over a tensor lr changes it in place (fill_): the graph
    reads the new value, so the guard lets it through; a new tensor in its
    place, or a float hyperparameter changed after the capture, raises."""
    model = tiny_model()
    lr = torch.tensor(1e-3)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda e: 0.5 ** e)
    step = _GraphedStep(lambda x: None, opt)
    step.graphed = _CapturingStub()
    step(1)
    for _ in range(3):
        opt.step()      # no gradients: changes nothing, keeps the order
        sched.step()
        step(1)
    assert opt.param_groups[0]["lr"] is lr
    assert float(lr) == pytest.approx(1e-3 * 0.5 ** 3)
    opt.param_groups[0]["lr"] = torch.tensor(1e-3)
    with pytest.raises(ValueError, match="hyperparameters changed"):
        step(1)
    opt.param_groups[0]["lr"] = lr
    step(1)
    opt.param_groups[0]["betas"] = (0.8, 0.999)
    with pytest.raises(ValueError, match="hyperparameters changed"):
        step(1)


def _ramp_batch(device):
    rng = np.random.default_rng(2)
    ramp = np.linspace(0, 1, 4, dtype=np.float32)
    clips = rng.uniform(0, .25, (4, 4, 16, 16, 3)).astype(np.float32)
    clips = torch.from_numpy(clips + ramp[None, :, None, None, None])
    return clips.to(device), torch.tensor([True, False, True, False],
                                          device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_graphed_adam_with_schedule_equals_eager_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    clips, mask = _ramp_batch("cuda")
    runs = []
    for graphed in (True, False):
        model = tiny_model("cuda", torch.bfloat16)
        opt = OPTIMIZERS[name](model.parameters(),
                               lr=torch.tensor(3e-3, device="cuda"))
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda e: 0.8 ** e)
        step = make_vit_train_step(model, opt)
        assert isinstance(step, _GraphedStep)
        call = step if graphed else step.graphed.fn
        losses = []
        for _ in range(6):
            losses.append(call(clips, mask)[0])
            sched.step()
        torch.cuda.synchronize()
        if graphed:
            assert (step.graphed.captures, step.graphed.replays) == (1, 5)
        runs.append((torch.stack(losses), [p.detach().clone()
                                           for p in model.parameters()]))
    (la, pa), (lb, pb) = runs
    assert torch.equal(la, lb), (la, lb)
    for a, b in zip(pa, pb):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float(la[-1]) < float(la[0])


@pytest.mark.gpu
def test_graphed_draws_differ_by_replay_and_match_an_eager_twin():
    """A CUDA graph that registers the step's generator draws new t and ε
    at every replay, the bytes an eager twin seeded alike draws."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    sched = DiffusionSchedule(100, device="cuda")
    latents = torch.randn((2, 4, 4, 4, 4), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    twin = torch.Generator(device="cuda").manual_seed(5)

    def draw(x):
        return diffusion_draws(sched, x, gen, 0.5)
    graphed = cuda_graph(draw, generators=(gen,))
    got = [graphed(latents) for _ in range(4)]
    want = [diffusion_draws(sched, latents, twin, 0.5) for _ in range(4)]
    assert (graphed.captures, graphed.replays) == (1, 3)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    for k in range(3):
        assert not torch.equal(got[k][1], got[k + 1][1])
