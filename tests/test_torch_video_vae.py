"""The port's causal VideoVAE (tensor_stream_torch/models/video_vae.py)
against the JAX package's on the CPU, at a small size (base 8, latent 4,
clips of 2 x 4 x 16 x 16 x 3).

The flax parameters are initialized and shifted by seeded numpy noise,
then converted with ``vae_state_dict_from_flax``; the port is fed the
reference's own reparameterisation draw (``jax.random.normal(rng,
mean.shape)``, as ``VideoVAE.__call__`` draws it), so the whole forward,
``vae_loss`` and every gradient can be compared.

Tolerances: f32 on both sides, the same math up to the order of the
convolutions' sums: outputs within 1e-4 of their largest value, the loss
within 1e-5 relative, each gradient within 1e-4 of the largest gradient
(GRAD_TOL). One bf16 forward within 2e-2 of its scale (the port's TOL,
tests/test_torch_video_vit.py): bf16 convs round each product's inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tensor_stream_tpu.models import video_vae as jax_vae
from tensor_stream_torch.models import VideoVAE, vae_state_dict_from_flax
from tensor_stream_torch.models.video_vae import (make_vae_train_step,
                                                  vae_loss)

CLIP = (2, 4, 16, 16, 3)
BASE, LATENT = 8, 4
TOL = 1e-4
GRAD_TOL = 1e-4
BF16_TOL = 2e-2


def clips_of(seed):
    return np.random.default_rng(seed).uniform(0, 1, CLIP).astype(np.float32)


def pair(dtype=torch.float32, seed=0):
    jm = jax_vae.VideoVAE(base=BASE, latent=LATENT,
                          compute_dtype=(jnp.float32 if dtype == torch.float32
                                         else jnp.bfloat16))
    key = jax.random.PRNGKey(seed)
    params = jm.init(key, jnp.zeros(CLIP), key)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)
    tm = VideoVAE(base=BASE, latent=LATENT, compute_dtype=dtype, device="cpu")
    tm.load_state_dict(vae_state_dict_from_flax(params), strict=True)
    return jm, params, tm


def jax_noise(rng):
    return np.array(jax.random.normal(rng, (CLIP[0], CLIP[1] // 2,
                                              CLIP[2] // 4, CLIP[3] // 4,
                                              LATENT)))


def close(got, want, tol):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_forward_matches_jax(dtype):
    jm, params, tm = pair(dtype)
    x, rng = clips_of(3), jax.random.PRNGKey(7)
    want = jm.apply(params, jnp.asarray(x), rng)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), noise=torch.from_numpy(jax_noise(rng)))
    tol = TOL if dtype == torch.float32 else BF16_TOL
    for g, w, name in zip(got, want, ("recon", "mean", "logvar")):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        close(g.numpy(), np.asarray(w), tol)


def test_encode_decode_match_jax():
    jm, params, tm = pair()
    x = clips_of(4)
    mean, logvar = jm.apply(params, jnp.asarray(x),
                            method=jax_vae.VideoVAE.encode)
    recon = jm.apply(params, mean, method=jax_vae.VideoVAE.decode)
    with torch.no_grad():
        tmean, tlogvar = tm.encode(torch.from_numpy(x))
        trecon = tm.decode(torch.from_numpy(np.asarray(mean)))
    close(tmean.numpy(), np.asarray(mean), TOL)
    close(tlogvar.numpy(), np.asarray(logvar), TOL)
    close(trecon.numpy(), np.asarray(recon), TOL)


def test_loss_and_grads_match_jax():
    jm, params, tm = pair()
    x, rng = clips_of(5), jax.random.PRNGKey(11)

    def loss_fn(p):
        recon, mean, logvar = jm.apply(p, jnp.asarray(x), rng)
        return jax_vae.vae_loss(recon, jnp.asarray(x), mean, logvar,
                                kl_weight=0.1)
    (jl, (jrec, jkl)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    clips = torch.from_numpy(x)
    recon, mean, logvar = tm(clips, noise=torch.from_numpy(jax_noise(rng)))
    loss, (rec, kl) = vae_loss(recon, clips, mean, logvar, kl_weight=0.1)
    loss.backward()
    for g, w in ((loss, jl), (rec, jrec), (kl, jkl)):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-5)
    want = vae_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           jgrads))
    assert set(want) == {n for n, _ in tm.named_parameters()}
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in tm.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, msg=name)


def test_encoder_is_causal():
    """The reference's law on the port: changing frames >= 2 leaves the
    latents of the first latent step (frames 0-1) exactly as they were,
    and changes the later ones."""
    _, _, tm = pair()
    x = torch.from_numpy(clips_of(6))
    y = x.clone()
    y[:, 2:] = torch.from_numpy(clips_of(7))[:, 2:]
    with torch.no_grad():
        mx, _ = tm.encode(x)
        my, _ = tm.encode(y)
    assert torch.equal(mx[:, 0], my[:, 0])
    assert not torch.equal(mx[:, 1], my[:, 1])


def test_group_norm_is_per_frame():
    """The norm's statistics never cross frames: scaling one frame's
    input leaves every other frame's output unchanged."""
    _, _, tm = pair()
    norm = tm.encoder.blocks[0].norms[0]
    x = torch.randn(2, BASE, 4, 8, 8, generator=torch.Generator()
                    .manual_seed(0))
    y = x.clone()
    y[:, :, 3] *= 5.0
    with torch.no_grad():
        a, b = norm(x), norm(y)
    assert torch.equal(a[:, :, :3], b[:, :, :3])


def test_train_step_descends_and_draws_from_its_generator():
    """make_vae_train_step on the CPU (eager): the loss falls over 6 Adam
    steps on one batch, and two steps built alike with generators seeded
    alike give the same losses."""
    losses = []
    for _ in range(2):
        _, _, tm = pair()
        step = make_vae_train_step(
            tm, torch.optim.Adam(tm.parameters(), lr=1e-3),
            generator=torch.Generator().manual_seed(4))
        clips = torch.from_numpy(clips_of(8))
        losses.append([step(clips)[0].item() for _ in range(6)])
    assert losses[0] == losses[1]
    assert np.isfinite(losses[0]).all() and losses[0][-1] < losses[0][0]


def test_adam_trajectory_matches_jax_where_both_diverge():
    """At base 32 (the module default), Adam at the example's lr 1e-3
    (python_examples/latent_video_generation.py:70, set there for base 16)
    blows the loss up within its first steps, in the JAX package as in the
    port: from the same weights, clips and reparameterisation draws, the
    two trajectories agree step by step. Divergent steps amplify the
    sums' rounding, so the losses are held within 1e-3 relative."""
    clip = (1, 8, 32, 32, 3)
    jm = jax_vae.VideoVAE(base=32, latent=8, compute_dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(key, jnp.zeros(clip), key))
    clips = np.random.default_rng(0).uniform(0, 1, clip).astype(np.float32)
    tx = optax.adam(1e-3)
    state = tx.init(params)
    tm = VideoVAE(base=32, latent=8, compute_dtype=torch.float32,
                  device="cpu")
    tm.load_state_dict(vae_state_dict_from_flax(params), strict=True)
    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    def loss_fn(p, rng):
        recon, mean, logvar = jm.apply(p, jnp.asarray(clips), rng)
        return jax_vae.vae_loss(recon, jnp.asarray(clips), mean, logvar)[0]
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    want, got = [], []
    for i in range(4):
        rng = jax.random.PRNGKey(10 + i)
        loss, grads = grad_fn(params, rng)
        updates, state = tx.update(grads, state)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))
        noise = np.array(jax.random.normal(rng, (1, 4, 8, 8, 8)))
        recon, mean, logvar = tm(torch.from_numpy(clips),
                                 noise=torch.from_numpy(noise))
        tloss = vae_loss(recon, torch.from_numpy(clips), mean, logvar)[0]
        tloss.backward()
        opt.step()
        opt.zero_grad()
        got.append(tloss.item())
    print("losses, jax", want, "port", got)
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert max(want[1:]) > 10 * want[0], want
