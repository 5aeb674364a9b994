"""The port's gradient accumulation (tensor_stream_torch/parallel/accum.py)
against the JAX package's ``accumulate_gradients``, on the CPU, at the
JAX test's size (tests/test_grad_accum.py: depth 1, dim 16, 8 clips of
4 x 16², patch 8).

The flax parameters are initialized, shifted by seeded numpy noise and
converted with ``vit_state_dict_from_flax``; the JAX gradient tree goes
through the same converter, so each gradient is compared by name. Both
sides take the softmax cross-entropy of the same clips and labels in f32,
JAX at "highest" matmul precision, as the JAX test pins it.

Tolerances: loss, aux and every gradient at rtol 1e-5 / atol 1e-7, the
JAX test's own (the same f32 math in another reduction order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensor_stream_tpu.models.video_vit import VideoViT as FlaxViT
from tensor_stream_tpu.parallel.accum import \
    accumulate_gradients as jax_accumulate
from tensor_stream_torch.models import (VideoViT, vit_loss,
                                        vit_state_dict_from_flax)
from tensor_stream_torch.models._train import graphed_train_step
from tensor_stream_torch.parallel import accumulate_gradients

CFG = dict(num_classes=2, depth=1, dim=16, num_heads=2, patch=8,
           tubelet_t=2)
CLIP = (8, 4, 16, 16, 3)
LABELS = np.array([0, 1, 1, 0, 1, 0, 0, 1])


def pair(seed=0):
    """(flax model, its params, the port's model with them), f32."""
    clips = clips_of(seed)
    jm = FlaxViT(compute_dtype=jnp.float32, **CFG)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(clips))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)
    tm = VideoViT(compute_dtype=torch.float32, frames=CLIP[1],
                  size=CLIP[2], device="cpu", **CFG)
    tm.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    return jm, params, tm


def clips_of(seed):
    return np.random.default_rng(seed + 10).uniform(0, 1, CLIP).astype(
        np.float32)


def jax_loss(jm):
    def loss_fn(p, x, y):
        logits = jm.apply(p, x)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, (logits.argmax(-1) == y).mean()
    return loss_fn


def torch_loss(model, x, y):
    logits = model(x)
    loss = torch.nn.functional.cross_entropy(logits, y)
    return loss, (logits.argmax(-1) == y).float().mean()


def assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("n_accum", [1, 2, 4, 8])
def test_matches_jax_accumulate_gradients(n_accum):
    """Loss, aux and every gradient of the port's accumulation against
    the JAX package's at the same n_accum."""
    jm, params, tm = pair()
    clips = clips_of(1)
    with jax.default_matmul_precision("highest"):
        (jl, jacc), jgrads = jax.jit(jax_accumulate(jax_loss(jm), n_accum))(
            params, jnp.asarray(clips), jnp.asarray(LABELS))
    (loss, acc), grads = accumulate_gradients(torch_loss, n_accum)(
        tm, torch.from_numpy(clips), torch.from_numpy(LABELS))
    assert loss.shape == () and not loss.requires_grad
    assert_close(loss, jl)
    assert_close(acc, jacc)
    want = vit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           jgrads))
    assert set(grads) == set(want) == {n for n, _ in tm.named_parameters()}
    for name, w in want.items():
        assert_close(grads[name], w)


@pytest.mark.parametrize("n_accum", [2, 4])
def test_matches_the_full_batch_backward(n_accum):
    """The mean of the microbatch means is the full batch's mean: the
    gradients equal one backward over all 8 clips, to reduction order."""
    _, _, tm = pair()
    clips, labels = torch.from_numpy(clips_of(2)), torch.from_numpy(LABELS)
    torch_loss(tm, clips, labels)[0].backward()
    (_, _), grads = accumulate_gradients(torch_loss, n_accum)(tm, clips,
                                                             labels)
    for name, p in tm.named_parameters():
        torch.testing.assert_close(grads[name], p.grad, rtol=1e-5,
                                   atol=1e-7, msg=name)


def test_loss_without_aux_and_a_parameter_it_does_not_reach():
    """A bare loss gets a 0-d zero aux; a parameter the loss does not
    reach gets zeros, as jax.grad gives."""
    w = torch.nn.Linear(3, 1, bias=False)
    unused = torch.nn.Linear(3, 1)
    model = torch.nn.ModuleDict({"w": w, "unused": unused})
    x = torch.arange(12.0).reshape(4, 3)
    (loss, aux), grads = accumulate_gradients(
        lambda m, x: m["w"](x).sum(), 2)(model, x)
    assert aux.shape == () and float(aux) == 0.0
    torch.testing.assert_close(loss, model["w"](x).sum().detach() / 2)
    torch.testing.assert_close(grads["w.weight"], x.sum(0, keepdim=True) / 2)
    assert torch.equal(grads["unused.weight"], torch.zeros(1, 3))


def test_divisibility_and_n_accum_errors():
    model = torch.nn.Linear(2, 1)
    grad_fn = accumulate_gradients(lambda m, x: m(x).sum(), 3)
    with pytest.raises(ValueError, match="not divisible"):
        grad_fn(model, torch.ones((8, 2)))
    with pytest.raises(ValueError, match="n_accum"):
        accumulate_gradients(lambda m, x: m(x).sum(), 0)


def test_one_trained_step_matches_optax():
    """A step that writes the accumulated gradients to .grad and calls
    SGD(momentum 0.9) through graphed_train_step (eager on the CPU)
    against optax.sgd on JAX's accumulated gradients: the loss and every
    parameter after one step, each within 1e-5 of its own scale."""
    lr = 0.1
    jm, params, tm = pair()
    clips = clips_of(3)
    with jax.default_matmul_precision("highest"):
        (jl, _), jgrads = jax.jit(jax_accumulate(jax_loss(jm), 4))(
            params, jnp.asarray(clips), jnp.asarray(LABELS))
    tx = optax.sgd(lr, momentum=0.9)
    updates, _ = tx.update(jgrads, tx.init(params))
    params = optax.apply_updates(params, updates)
    opt = torch.optim.SGD(tm.parameters(), lr=lr, momentum=0.9)
    grad_fn = accumulate_gradients(torch_loss, 4)
    named = dict(tm.named_parameters())

    def step(x, y):
        (loss, _), grads = grad_fn(tm, x, y)
        for name, g in grads.items():
            named[name].grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss
    loss = graphed_train_step(step, opt, "cpu")(torch.from_numpy(clips),
                                                torch.from_numpy(LABELS))
    assert_close(loss, jl)
    want = vit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           params))
    for name, p in tm.named_parameters():
        w = want[name]
        torch.testing.assert_close(p.detach(), w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()),
                                   msg=name)


def test_accumulated_adam_steps_descend():
    """vit_loss through accumulate_gradients and Adam learns the flip
    task on a fixed batch over 5 steps, as the JAX test_trains_a_step."""
    _, _, tm = pair()
    opt = torch.optim.Adam(tm.parameters(), lr=1e-2)
    grad_fn = accumulate_gradients(vit_loss, 4)
    clips = torch.from_numpy(clips_of(4))
    mask = torch.from_numpy(LABELS.astype(bool))
    losses = []
    for _ in range(5):
        (loss, _), grads = grad_fn(tm, clips, mask)
        for name, p in tm.named_parameters():
            p.grad = grads[name]
        opt.step()
        losses.append(float(loss))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
