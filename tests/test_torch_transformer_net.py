"""The port's TransformerNet (tensor_stream_torch/models/transformer_net.py)
against the JAX package's on the CPU, at a small size (2 images of 32² in
[0, 255]; the widths are the model's own, 32-64-128 channels).

The flax parameters are initialized and shifted by seeded numpy noise
(so that the instance norms' scales and biases are not 1 and 0), then
converted with ``transformer_net_state_dict_from_flax``; the flax
gradient tree goes through the same converter.

Tolerances: f32 on both sides, the same math up to the order of the
convolutions' sums: the forward within 1e-4 of the output's largest
value, the loss within 1e-5 relative, each gradient within 1e-4 of the
largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tensor_stream_tpu.models import transformer_net as jax_tn
from tensor_stream_torch.models import (TransformerNet, gram_matrix,
                                        style_transfer_loss,
                                        transformer_net_state_dict_from_flax)
from tensor_stream_torch.models.transformer_net import init_params

SHAPE = (2, 32, 32, 3)
TOL = 1e-4
GRAD_TOL = 1e-4


def images(seed, shape=SHAPE):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(
        np.float32)


def pair(seed=0):
    params = jax_tn.init_params(jax.random.PRNGKey(seed), 32, 32, 2)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape))
        .astype(np.float32), params)
    tm = TransformerNet(device="cpu")
    tm.load_state_dict(transformer_net_state_dict_from_flax(params),
                       strict=True)
    return params, tm


def test_forward_matches_jax():
    params, tm = pair()
    x = images(3)
    want = np.asarray(jax_tn.TransformerNet().apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == SHAPE
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def test_converter_covers_every_parameter():
    params, tm = pair()
    sd = transformer_net_state_dict_from_flax(params)
    assert set(sd) == set(tm.state_dict())
    assert sd["convs.0.weight"].shape == (32, 3, 9, 9)
    assert sd["blocks.4.norms.1.weight"].shape == (128,)
    assert sd["ups.1.weight"].shape == (32, 64, 3, 3)


def test_gram_matrix_matches_jax():
    f = np.random.default_rng(4).standard_normal((2, 6, 5, 7)).astype(
        np.float32)
    want = np.asarray(jax_tn.gram_matrix(jnp.asarray(f)))
    got = gram_matrix(torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_style_loss_and_grads_match_jax():
    params, tm = pair()
    content = images(5)
    grams = np.array(jax_tn.gram_matrix(jnp.asarray(images(6))))
    model = jax_tn.TransformerNet()
    jl, jgrads = jax.value_and_grad(
        lambda p: jax_tn.style_transfer_loss(model.apply, p,
                                             jnp.asarray(content),
                                             jnp.asarray(grams)))(params)
    loss = style_transfer_loss(tm, torch.from_numpy(content),
                               torch.from_numpy(grams))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = transformer_net_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jgrads))
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in tm.named_parameters():
        torch.testing.assert_close(p.grad, want[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, msg=name)


def test_init_params_is_deterministic_in_its_generator():
    a = TransformerNet(device="cpu", generator=torch.Generator().manual_seed(2))
    b = TransformerNet(device="cpu")
    sd = init_params(torch.Generator().manual_seed(2), b)
    for name, value in a.state_dict().items():
        assert torch.equal(value, sd[name]), name
    assert torch.equal(sd["norms.0.weight"], torch.ones(32))
    c = init_params(torch.Generator().manual_seed(3), b)
    assert not torch.equal(c["convs.0.weight"], a.state_dict()[
        "convs.0.weight"])
