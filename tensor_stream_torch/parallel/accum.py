"""Gradient accumulation: large effective batches without the memory.

The port of the JAX package's ``parallel/accum.py``.
``accumulate_gradients(loss_fn, n_accum)`` turns a per-microbatch loss
into a function that returns the gradients (and the mean aux) over an
``[n_accum * mb, ...]`` batch. It walks the microbatches in order and
takes each one's gradients with ``torch.autograd.grad``, which frees that
microbatch's activations before the next forward: the activations of only
one microbatch are alive at a time, where the JAX package scans the
microbatches under ``lax.scan``.

    grad_fn = accumulate_gradients(loss_fn, n_accum=4)
    (loss, aux), grads = grad_fn(model, big_batch, labels)
    # grads: {name: tensor} == the full batch's gradients of a mean loss,
    #        to reduction-order tolerance, at 1/4 the activation memory.

It keeps the JAX order: the microbatches' gradients, losses and auxes
are summed, the first microbatch's first, and the sums multiplied by
``1 / n_accum``. Nothing in it waits for the device, so a train step that
runs ``grad_fn``, writes the gradients to ``.grad`` and calls
``optimizer.step()`` is captured whole by ``models._train.
graphed_train_step``: the n microbatches' forwards and backwards in one
CUDA graph.
"""
from typing import Callable

import torch

from ..graphs import tree_map


def _zip_map(fn, a, b):
    """``fn`` over the tensors of two trees of one structure."""
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_zip_map(fn, x, y) for x, y in zip(a, b))
    return a


def accumulate_gradients(loss_fn: Callable, n_accum: int):
    """``loss_fn(model, *batch_args)`` returns a loss, or ``(loss, aux)``;
    every tensor of ``batch_args`` has the same leading axis, which
    ``n_accum`` must divide. Returns ``grad_fn(model, *batch_args) ->
    ((loss, aux), grads)``: ``grads`` maps the name of each parameter that
    requires grad to its gradient (zeros where the loss does not reach
    it), and loss, aux and grads are averaged over the ``n_accum``
    microbatches; aux is a 0-d zero when ``loss_fn`` returns none. Loss
    and aux come back detached."""
    if n_accum < 1:
        raise ValueError(f"n_accum must be >= 1, got {n_accum}")

    def split(x):
        b = x.shape[0]
        if b % n_accum:
            raise ValueError(f"batch {b} not divisible by "
                             f"n_accum={n_accum}")
        return x.reshape((n_accum, b // n_accum) + tuple(x.shape[1:]))

    def value_and_grad(names, params, model, batch_args):
        out = loss_fn(model, *batch_args)
        loss, aux = out if isinstance(out, tuple) else (
            out, torch.zeros((), device=out.device))
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        return (loss.detach(), tree_map(torch.Tensor.detach, aux),
                dict(zip(names, grads)))

    def grad_fn(model, *batch_args):
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        names = [n for n, _ in named]
        params = [p for _, p in named]
        micro = tree_map(split, batch_args)
        loss, aux, grads = value_and_grad(
            names, params, model, tree_map(lambda x: x[0], micro))
        if n_accum == 1:
            return (loss, aux), grads
        for i in range(1, n_accum):
            l_i, a_i, g_i = value_and_grad(
                names, params, model, tree_map(lambda x: x[i], micro))
            grads = {n: grads[n] + g_i[n] for n in names}
            aux = _zip_map(torch.add, aux, a_i)
            loss = loss + l_i
        inv = 1.0 / n_accum
        return ((loss * inv, tree_map(lambda x: x * inv, aux)),
                {n: g * inv for n, g in grads.items()})

    return grad_fn
