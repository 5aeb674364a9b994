"""One graphed train step for every model of the port.

``graphed_train_step(step, optimizer, device)`` is what the JAX package's
``jax.jit`` of a train step becomes: on CUDA the step goes behind
``graphs.cuda_graph`` (the first call is eager and makes the optimizer's
lazy state, the second captures forward, backward, ``optimizer.step()``
and ``zero_grad`` and replays, later calls replay; results come back as
copies); on the CPU it is the step itself.

Before the first call it turns on ``capturable`` in every param group of
an optimizer that has the flag (Adam, AdamW, ...): their ``step()``
refuses a capture otherwise, and state made without it lives on the host.
An optimizer that already has such state cannot be switched, and building
the step raises then, not the capture later.

Hyperparameters are baked into the graph. A float that changes after the
capture (``lr = 5e-3``) makes the next call raise. A hyperparameter held in
a device tensor (``lr=torch.tensor(1e-3, device="cuda")``) is read by the
replay, so a scheduler that changes it in place (``lr_scheduler`` fills a
tensor lr) drives the graphed step as optax's schedules drive the jitted
one; such a tensor is compared by identity.

``generators``: CUDA ``torch.Generator``s the step draws from (diffusion's
t and noise, the VAE's reparameterisation). Each is registered with the
step's graph, so every replay draws new numbers, the numbers an eager step
would draw from a generator in the same state.
"""
from typing import Sequence

import torch

from ..graphs import cuda_graph


def make_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Sets ``capturable=True`` in every param group that has the flag
    (and in the defaults, for groups added later). Raises ValueError if
    the optimizer already holds state made without it."""
    groups = [g for g in optimizer.param_groups if "capturable" in g]
    if any(not g["capturable"] for g in groups) and optimizer.state:
        raise ValueError(
            f"{type(optimizer).__name__} already has state made with "
            "capturable=False, which a CUDA graph cannot replay: build the "
            "train step before the optimizer's first step, or build the "
            "optimizer with capturable=True")
    for g in groups:
        g["capturable"] = True
    if "capturable" in optimizer.defaults:
        optimizer.defaults["capturable"] = True


def hyperparameters(optimizer: torch.optim.Optimizer) -> list:
    """Each group's settings but its params: tensors stand as themselves
    (compared by identity, since a replay reads them), the rest by value."""
    return [{k: (_Same(v) if isinstance(v, torch.Tensor) else v)
             for k, v in group.items() if k != "params"}
            for group in optimizer.param_groups]


class _Same:
    """A tensor that equals only itself."""

    def __init__(self, tensor):
        self.tensor = tensor

    def __eq__(self, other):
        return isinstance(other, _Same) and other.tensor is self.tensor

    def __repr__(self):
        return f"tensor@{self.tensor.data_ptr():#x}"


class _GraphedStep:
    """A train step behind ``cuda_graph``, refusing to replay a graph
    whose baked hyperparameters are no longer the optimizer's.
    ``graphed`` is the CudaGraph (its replays and graphs; ``graphed.fn``
    is the step, eager)."""

    def __init__(self, step, optimizer, generators: Sequence = ()):
        self.graphed = cuda_graph(step, generators=generators)
        self.optimizer = optimizer
        self._captured = None

    def __call__(self, *args):
        now = hyperparameters(self.optimizer)
        if self._captured is not None and now != self._captured:
            raise ValueError(
                f"optimizer hyperparameters changed from {self._captured} "
                f"to {now} after the step was captured; build a new step")
        captures = self.graphed.captures
        out = self.graphed(*args)
        if self.graphed.captures != captures:
            self._captured = now
        return out


def graphed_train_step(step, optimizer, device, generators: Sequence = ()):
    """`step` on CUDA behind a CUDA graph (see the module's docstring),
    with `optimizer` made capturable first; on the CPU `step` itself."""
    if torch.device(device).type != "cuda":
        return step
    make_capturable(optimizer)
    return _GraphedStep(step, optimizer, generators)


def step_generator(device, seed: int = 0) -> torch.Generator:
    """A generator on `device` seeded with `seed`, for a step's draws."""
    return torch.Generator(device=device).manual_seed(seed)
