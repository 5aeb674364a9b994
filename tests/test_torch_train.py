"""The port's VideoViT training step (tensor_stream_torch/models:
``vit_loss``, ``make_vit_train_step``, ``init_vit``, ``remat``) against the
JAX package's, on the CPU, at a tiny size (depth 2, dim 64, 4 frames of
32², patch 8, tubelet 2: 32 tokens).

The flax parameters are initialized and shifted by seeded numpy noise,
then converted with ``vit_state_dict_from_flax``; the JAX gradient tree
goes through the same converter (each leaf's transpose and reshape is
linear, so it maps gradients as it maps weights), so every parameter's
gradient is compared by name. The JAX side is the loss of
``make_vit_train_step`` (``loss_fn``, tensor_stream_tpu/models/
video_vit.py:538-543) on the same clips, time-reversed where the mask is
set; its flash path runs the Pallas forward in interpret mode and the
``_flash_bwd`` VJP.

Tolerances: f32 compute, the same math up to reduction order: loss and
accuracy 1e-5, each gradient within 1e-4 of the model's largest gradient
(some are 0 up to rounding: a key bias does not move the softmax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensor_stream_tpu.models.video_vit import VideoViT as FlaxViT
from tensor_stream_torch.models import (VideoViT, init_vit,
                                        make_vit_train_step, vit_loss,
                                        vit_state_dict_from_flax)

BASE = dict(num_classes=7, depth=2, dim=64, num_heads=2, patch=8,
            tubelet_t=2)
FRAMES, SIZE = 4, 32
CLIP = (4, FRAMES, SIZE, SIZE, 3)
MASK = np.array([True, False, True, False])
GRAD_TOL = 1e-4


def flax_params(model, clips, seed):
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(clips))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)


def clips_of(seed):
    return np.random.default_rng(seed).standard_normal(CLIP).astype(
        np.float32)


def pair(seed=0, **kw):
    """(flax model, its params, the port's model with them), f32."""
    cfg = {**BASE, **kw}
    jax_kw = dict(cfg)
    if jax_kw.get("use_flash"):
        jax_kw["flash_impl"] = "pallas"
    jm = FlaxViT(compute_dtype=jnp.float32, **jax_kw)
    params = flax_params(jm, clips_of(seed), seed + 1)
    tm = VideoViT(compute_dtype=torch.float32, frames=FRAMES, size=SIZE,
                  device="cpu", **cfg)
    tm.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    return jm, params, tm


def jax_loss_fn(jm):
    """make_vit_train_step's task and loss_fn, on the host's clips."""
    def loss_fn(params, clips, flip_mask):
        x = jnp.where(flip_mask[:, None, None, None, None],
                      jnp.flip(clips, axis=1), clips)
        labels = flip_mask.astype(jnp.int32)
        logits = jm.apply(params, x)
        loss = -jnp.take_along_axis(
            jax.nn.log_softmax(logits), labels[:, None], axis=1).mean()
        acc = (logits.argmax(-1) == labels).mean()
        return loss, acc
    return loss_fn


def assert_grads_close(tm, jgrads):
    want = vit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           jgrads))
    got = {name: p.grad for name, p in tm.named_parameters()}
    assert set(got) == set(want)
    scale = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        assert got[name] is not None, name
        torch.testing.assert_close(got[name], w, atol=GRAD_TOL * scale,
                                   rtol=GRAD_TOL, msg=name)


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["materialized", "flash"])
@pytest.mark.parametrize("attention", ["joint", "factorized"])
def test_loss_and_grads_match_jax(attention, use_flash):
    jm, params, tm = pair(attention=attention, use_flash=use_flash)
    clips = clips_of(3)
    (jl, jacc), jgrads = jax.value_and_grad(jax_loss_fn(jm), has_aux=True)(
        params, jnp.asarray(clips), jnp.asarray(MASK))
    loss, acc = vit_loss(tm, torch.from_numpy(clips), torch.from_numpy(MASK))
    loss.backward()
    assert loss.shape == () and acc.shape == ()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(acc), float(jacc), rtol=1e-5, atol=1e-5)
    assert_grads_close(tm, jgrads)


def test_two_sgd_momentum_steps_match_optax():
    """make_vit_train_step with torch SGD(momentum=0.9) against optax.sgd
    with the same momentum on the JAX gradients: losses and parameters
    after two steps (two masks, so the momentum carries a different
    gradient), each parameter within 1e-4 of its own scale."""
    lr = 0.05
    jm, params, tm = pair(attention="joint", use_flash=True)
    tx = optax.sgd(lr, momentum=0.9)
    opt_state = tx.init(params)
    step = make_vit_train_step(tm, torch.optim.SGD(tm.parameters(), lr=lr,
                                                   momentum=0.9))
    grad_fn = jax.value_and_grad(jax_loss_fn(jm), has_aux=True)
    clips = clips_of(5)
    for mask in (MASK, ~MASK):
        (jl, _), grads = grad_fn(params, jnp.asarray(clips), jnp.asarray(mask))
        updates, opt_state = tx.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        loss, _ = step(torch.from_numpy(clips), torch.from_numpy(mask))
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5,
                                   atol=1e-5)
    want = vit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           params))
    for name, p in tm.named_parameters():
        assert p.grad is None, name          # zero_grad(set_to_none=True)
        w = want[name]
        torch.testing.assert_close(p.detach(), w, rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["materialized", "flash"])
@pytest.mark.parametrize("attention", ["joint", "factorized"])
def test_remat_grads_equal_exactly(attention, use_flash):
    """remat recomputes the same ops: in f32 on the CPU every gradient
    equals the non-remat model's bit for bit (as the JAX package's
    test_remat_grads_match_exactly)."""
    _, _, tm = pair(attention=attention, use_flash=use_flash)
    twin = VideoViT(compute_dtype=torch.float32, frames=FRAMES, size=SIZE,
                    device="cpu", remat=True, attention=attention,
                    use_flash=use_flash, **BASE)
    twin.load_state_dict(tm.state_dict())
    clips, mask = torch.from_numpy(clips_of(6)), torch.from_numpy(MASK)
    losses = []
    for model in (tm, twin):
        loss, _ = vit_loss(model, clips, mask)
        loss.backward()
        losses.append(loss)
    assert torch.equal(losses[0], losses[1])
    for (name, a), b in zip(tm.named_parameters(), twin.parameters()):
        assert torch.equal(a.grad, b.grad), name


def test_remat_only_with_grad():
    """Under no_grad a remat model runs its blocks plainly (nothing to
    recompute) and gives the same logits."""
    _, _, tm = pair(attention="joint", use_flash=True)
    twin = VideoViT(compute_dtype=torch.float32, frames=FRAMES, size=SIZE,
                    device="cpu", remat=True, attention="joint",
                    use_flash=True, **BASE)
    twin.load_state_dict(tm.state_dict())
    clips = torch.from_numpy(clips_of(7))
    with torch.no_grad():
        assert torch.equal(tm(clips), twin(clips))


def test_init_vit_is_deterministic_in_its_generator():
    kw = dict(compute_dtype=torch.float32, frames=FRAMES, size=SIZE,
              device="cpu", attention="joint", **BASE)
    model = VideoViT(**kw)
    a = {k: v.clone() for k, v in
         init_vit(torch.Generator().manual_seed(5), model, CLIP).items()}
    b = init_vit(torch.Generator().manual_seed(5), model, CLIP)
    built = VideoViT(generator=torch.Generator().manual_seed(5), **kw)
    for name, value in built.state_dict().items():
        assert torch.equal(a[name], value) and torch.equal(b[name], value)
    c = init_vit(torch.Generator().manual_seed(6), model, CLIP)
    assert not torch.equal(c["tubelet.weight"], a["tubelet.weight"])
    with pytest.raises(ValueError, match="do not fit"):
        init_vit(torch.Generator(), model, (4, FRAMES, SIZE, SIZE + 8, 3))


def test_step_descends_on_the_ramp_batch():
    """The training configuration's kind (bf16 compute and residual, joint
    attention on the flash path, remat) learns: the loss falls over 8
    steps on a memorizable batch whose brightness ramps over time, as the
    JAX package's test_sharded_bf16_step_descends sets it up."""
    model = VideoViT(compute_dtype=torch.bfloat16,
                     residual_dtype=torch.bfloat16, attention="joint",
                     use_flash=True, remat=True, frames=FRAMES, size=SIZE,
                     device="cpu", generator=torch.Generator().manual_seed(0),
                     **{**BASE, "num_classes": 2, "dim": 32})
    step = make_vit_train_step(model, torch.optim.Adam(model.parameters(),
                                                       lr=3e-3))
    rng = np.random.default_rng(2)
    ramp = np.linspace(0, 1, FRAMES, dtype=np.float32)
    clips = torch.from_numpy(
        rng.uniform(0, .25, CLIP).astype(np.float32)
        + ramp[None, :, None, None, None])
    mask = torch.from_numpy(MASK)
    losses = [float(step(clips, mask)[0]) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("fault", [None, "no_delta"])
def test_smoke_grad_rule_sees_faults(fault, monkeypatch):
    """chip_smoke's first-step gradient gate (first_step_grads,
    grad_summary) at the tiny size in bf16, the card's training dtype:
    the flash path (the plain forward and backward here) against the
    materialized path from the same weights and clips passes; a flash
    backward that drops delta fails it."""
    import chip_smoke
    from tensor_stream_torch.ops import flash_attention as fa
    if fault == "no_delta":
        bwd = fa.flash_attention_bwd

        def no_delta(q, k, v, o, l, m, do, **kw):
            return bwd(q, k, v, torch.zeros_like(o), l, m, do, **kw)
        monkeypatch.setattr(fa, "flash_attention_bwd", no_delta)
    clips, mask = torch.from_numpy(clips_of(3)), torch.from_numpy(MASK)
    grads = {}
    for use_flash in (True, False):
        model = VideoViT(compute_dtype=torch.bfloat16,
                         residual_dtype=torch.bfloat16, attention="joint",
                         use_flash=use_flash, frames=FRAMES, size=SIZE,
                         device="cpu", **BASE)
        init_vit(torch.Generator().manual_seed(0), model, CLIP)
        opt = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
        grads[use_flash] = chip_smoke.first_step_grads(model, opt)
        step = make_vit_train_step(model, opt)
        step(clips, mask)
        step(clips, mask)  # the hook took the first step's only
    summary = chip_smoke.grad_summary(grads[True], grads[False],
                                      torch.bfloat16)
    key_biases = [n for n, _ in model.named_parameters()
                  if n.endswith(chip_smoke.ZERO_GRAD_SUFFIX)]
    assert len(key_biases) == BASE["depth"]
    assert summary["leaves"] == len(list(model.parameters())) - len(
        key_biases)
    assert summary["ok"] == (fault is None), summary
