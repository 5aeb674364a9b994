"""The port's latent diffusion (tensor_stream_torch/models/
latent_diffusion.py) against the JAX package's on the CPU, at a small size
(VideoDiT depth 2, dim 32, 2 heads over latents [2, 4, 4, 4, 4]; a
schedule of 100 steps).

The flax parameters are initialized and shifted by seeded numpy noise (so
that the zero-init adaLN and head are live), then converted with
``dit_state_dict_from_flax``. ``diffusion_loss`` is fed the draws that the
JAX step makes from its rng (``jax.random.split`` into t, ε and the
label-dropout mask, tensor_stream_tpu/models/latent_diffusion.py:237-243),
and ``ddim_sample`` the initial noise that the JAX sampler draws.

Tolerances: f32, the same math up to reduction order: forward outputs
and samples within 1e-4 of their largest value, the loss within 1e-5
relative, each gradient within 1e-4 of the largest gradient (GRAD_TOL);
the bf16 forward within 2e-2 of its scale (the port's TOL); the schedule
table bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_stream_tpu.models import latent_diffusion as jld
from tensor_stream_torch.models import (DiffusionSchedule, VideoDiT,
                                        ddim_sample, diffusion_loss,
                                        dit_state_dict_from_flax,
                                        make_conditional_diffusion_train_step,
                                        make_ddim_sampler,
                                        make_diffusion_train_step)
from tensor_stream_torch.models.latent_diffusion import (cosine_alpha_bar,
                                                         timestep_embedding)

LAT = (2, 4, 4, 4, 4)
T = 100
TOL = 1e-4
GRAD_TOL = 1e-4
BF16_TOL = 2e-2
KW = dict(depth=2, dim=32, num_heads=2)


def latents_of(seed):
    return np.random.default_rng(seed).standard_normal(LAT).astype(
        np.float32)


def pair(dtype=torch.float32, seed=0, **kw):
    jm = jld.VideoDiT(compute_dtype=(jnp.float32 if dtype == torch.float32
                                     else jnp.bfloat16), **KW, **kw)
    z = jnp.zeros(LAT)
    t = jnp.zeros((LAT[0],), jnp.int32)
    args = (z, t) + ((t,) if kw.get("num_classes") else ())
    params = jm.init(jax.random.PRNGKey(seed), *args)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)
    tm = VideoDiT(LAT[1:], compute_dtype=dtype, device="cpu", **KW, **kw)
    tm.load_state_dict(dit_state_dict_from_flax(params), strict=True)
    return jm, params, tm


def close(got, want, tol):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale)


def test_schedule_table_is_bit_equal():
    for steps in (100, 1000):
        want = np.asarray(jld.DiffusionSchedule(steps).alpha_bar)
        got = DiffusionSchedule(steps, device="cpu").alpha_bar.numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want)
    np.testing.assert_array_equal(jld.cosine_alpha_bar(50),
                                  cosine_alpha_bar(50))


def test_schedule_ops_match_jax():
    js, ts = jld.DiffusionSchedule(T), DiffusionSchedule(T, device="cpu")
    x0, noise, eps = latents_of(1), latents_of(2), latents_of(3)
    t, tp = np.array([80, 37]), np.array([60, 0])
    pairs = [(js.q_sample(x0, t, noise),
              ts.q_sample(*map(torch.from_numpy, (x0, t, noise)))),
             (js.x0_from_eps(x0, t, eps),
              ts.x0_from_eps(*map(torch.from_numpy, (x0, t, eps)))),
             (js.ddim_step(x0, t, tp, eps),
              ts.ddim_step(*map(torch.from_numpy, (x0, t, tp, eps))))]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_timestep_embedding_matches_jax():
    """Within 1e-5: at t = 999 the arguments reach 999 rad, where XLA's
    and torch's f32 sin and cos differ by an ulp of the argument (6e-5)
    times the derivative."""
    t = np.array([0, 1, 37, 999])
    want = np.asarray(jld.timestep_embedding(jnp.asarray(t), 32))
    got = timestep_embedding(torch.from_numpy(t), 32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [{}, {"conditioning": "in_context"},
                                {"num_classes": 3}],
                         ids=["adaln", "in_context", "conditional"])
def test_forward_matches_jax(kw):
    jm, params, tm = pair(**kw)
    z, t = latents_of(4), np.array([5, 71])
    y = (np.array([2, 3]),) if kw.get("num_classes") else ()
    want = jm.apply(params, jnp.asarray(z), jnp.asarray(t),
                    *map(jnp.asarray, y))
    with torch.no_grad():
        got = tm(torch.from_numpy(z), torch.from_numpy(t),
                 *map(torch.from_numpy, y))
    assert got.shape == LAT and got.dtype == torch.float32
    close(got, want, TOL)


def test_bf16_forward_matches_jax():
    jm, params, tm = pair(torch.bfloat16)
    z, t = latents_of(5), np.array([9, 50])
    want = jm.apply(params, jnp.asarray(z), jnp.asarray(t))
    with torch.no_grad():
        got = tm(torch.from_numpy(z), torch.from_numpy(t))
    close(got, want, BF16_TOL)


@pytest.mark.parametrize("conditional", [False, True])
def test_loss_and_grads_match_jax_with_its_draws(conditional):
    kw = {"num_classes": 3} if conditional else {}
    jm, params, tm = pair(**kw)
    sched = jld.DiffusionSchedule(T)
    latents = latents_of(6)
    labels = np.array([0, 2])
    # The JAX step's draws (tensor_stream_tpu/models/latent_diffusion.py
    # :237-245), with label dropout 0.5 so that the mask matters.
    rt, rn, rd = jax.random.split(jax.random.PRNGKey(9), 3)
    t = jax.random.randint(rt, (LAT[0],), 1, T + 1)
    noise = jax.random.normal(rn, LAT)
    y = ((jnp.where(jax.random.uniform(rd, (LAT[0],)) < 0.5, 3, labels),)
         if conditional else ())
    xt = sched.q_sample(jnp.asarray(latents), t, noise)

    def loss_fn(p):
        return jnp.mean((jm.apply(p, xt, t, *y) - noise) ** 2)
    jl, jgrads = jax.value_and_grad(loss_fn)(params)
    loss = diffusion_loss(tm, DiffusionSchedule(T, device="cpu"),
                          torch.from_numpy(latents),
                          torch.from_numpy(np.array(t)),
                          torch.from_numpy(np.array(noise)),
                          *(torch.from_numpy(np.array(v)) for v in y))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = dit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           jgrads))
    assert set(want) == {n for n, _ in tm.named_parameters()}
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in tm.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, msg=name)


@pytest.mark.parametrize("w", [0.0, 2.0])
def test_ddim_sample_matches_jax_from_its_noise(w):
    jm, params, tm = pair(num_classes=3)
    labels = np.array([1, 3])
    rng = jax.random.PRNGKey(12)
    want = jld.ddim_sample(jm, params, jld.DiffusionSchedule(T), rng, LAT,
                           n_steps=4, y=jnp.asarray(labels),
                           guidance_scale=w)
    noise = torch.from_numpy(np.array(jax.random.normal(rng, LAT)))
    sched = DiffusionSchedule(T, device="cpu")
    got = ddim_sample(tm, sched, noise, n_steps=4,
                      y=torch.from_numpy(labels), guidance_scale=w)
    close(got, want, TOL)
    sampler = make_ddim_sampler(tm, sched, n_steps=4, guidance_scale=w)
    assert torch.equal(sampler(noise, torch.from_numpy(labels)), got)


def test_unconditional_ddim_matches_jax():
    jm, params, tm = pair()
    rng = jax.random.PRNGKey(13)
    want = jld.ddim_sample(jm, params, jld.DiffusionSchedule(T), rng, LAT,
                           n_steps=3)
    noise = torch.from_numpy(np.array(jax.random.normal(rng, LAT)))
    got = ddim_sample(tm, DiffusionSchedule(T, device="cpu"), noise,
                      n_steps=3)
    close(got, want, TOL)


def test_adaln_blocks_are_identity_at_init():
    """adaLN-zero on the port: every block returns its input bit for bit
    and the model predicts exactly 0 at init."""
    tm = VideoDiT(LAT[1:], depth=3, dim=32, num_heads=2,
                  compute_dtype=torch.float32, device="cpu")
    z = torch.from_numpy(latents_of(7))
    t = torch.tensor([5, 50])
    x = torch.randn(2, 4, 16, 32, generator=torch.Generator().manual_seed(1))
    c = torch.randn(2, 32, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        for block in tm.blocks:
            assert torch.equal(block(x, c), x)
        assert torch.equal(tm(z, t), torch.zeros(LAT))


def test_cfg_weight_zero_is_the_conditional_sample():
    """w = 0 gives the plain conditional sample, and one guided step is
    the closed-form (1 + w)·ε(y) − w·ε(∅) step."""
    _, _, tm = pair(num_classes=3)
    sched = DiffusionSchedule(T, device="cpu")
    noise, labels = torch.from_numpy(latents_of(8)), torch.tensor([0, 2])
    a = ddim_sample(tm, sched, noise, n_steps=3, y=labels,
                    guidance_scale=0.0)
    b = ddim_sample(tm, sched, noise, n_steps=3, y=labels)
    assert torch.equal(a, b)
    w = 2.0
    got = ddim_sample(tm, sched, noise, n_steps=1, y=labels,
                      guidance_scale=w)
    t_top = torch.full((2,), T)
    with torch.no_grad():
        eps = ((1 + w) * tm(noise, t_top, labels)
               - w * tm(noise, t_top, torch.full((2,), 3)))
    want = sched.ddim_step(noise, t_top, torch.zeros(2, dtype=torch.long),
                           eps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("conditional", [False, True])
def test_train_steps_descend(conditional):
    """Both steps on the CPU (eager): the loss falls over 10 Adam steps on
    one batch, as the JAX package's test_adaln_trains_and_conditions; two
    steps built alike with generators seeded alike give the same losses."""
    runs = []
    for _ in range(2):
        kw = {"num_classes": 3} if conditional else {}
        tm = VideoDiT(LAT[1:], compute_dtype=torch.float32, device="cpu",
                      **KW, **kw)
        opt = torch.optim.Adam(tm.parameters(), lr=2e-3)
        sched = DiffusionSchedule(T, device="cpu")
        gen = torch.Generator().manual_seed(2)
        z = torch.from_numpy(latents_of(9))
        if conditional:
            step = make_conditional_diffusion_train_step(tm, sched, opt,
                                                         generator=gen)
            args = (z, torch.tensor([0, 2]))
        else:
            step = make_diffusion_train_step(tm, sched, opt, generator=gen)
            args = (z,)
        runs.append([step(*args).item() for _ in range(10)])
    assert runs[0] == runs[1]
    assert np.isfinite(runs[0]).all() and runs[0][-1] < runs[0][0], runs[0]


def test_conditional_step_needs_classes():
    tm = VideoDiT(LAT[1:], compute_dtype=torch.float32, device="cpu", **KW)
    with pytest.raises(ValueError, match="num_classes"):
        make_conditional_diffusion_train_step(
            tm, DiffusionSchedule(T, device="cpu"),
            torch.optim.SGD(tm.parameters(), lr=1e-3))

