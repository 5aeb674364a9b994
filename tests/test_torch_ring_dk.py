"""The ring's bf16 dK: the port's reverse ring against ``jax.vjp`` of the
JAX ring, on the CPU.

The port's ring backward (``ops/ring_attention.py::_ring_backward``) sums
each hop's dK, which the flash backward returns in the input dtype, in f32
and casts once at home. The JAX ring (``tensor_stream_tpu/ops/
ring_attention.py``) is autodiff of a ``lax.scan`` whose K/V blocks rotate
by ``ppermute``: a hop's dK is the cotangent of a bf16 block, so it is
rounded to bf16 at every hop too, and the running sum travels in bf16. So
in bf16 both rings leave their own single call's dK by some 4e-3 to 6e-3
(relative norm), more than the 1e-3 that chip_smoke.py's ``dk_cast``
holds one flash call to. These tests pin that: the two rings agree within
the flash gradient rule's bound, the JAX ring is itself that far from the
JAX single call, and the port's ring is no further from the f32 gradient
than the JAX ring, give or take what the port's contract (dS rounded
to bf16) adds to one call already.

The port runs ``virtual_ring_bwd`` (every ring position in one process,
the hops on the ``ts`` operators' CPU kernels, the plain flash forward
and backward); the JAX ring runs ``ring_attention_sharded`` on 4 of the
8 virtual CPU devices that tests/conftest.py sets up. Inputs are
chip_smoke.py's: q and k of std 2, v and dO of std 1, made with numpy
from a seed and rounded to bf16 alike on both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import chip_smoke
from tensor_stream_tpu.ops.flash_attention import _reference
from tensor_stream_tpu.ops.ring_attention import ring_attention_sharded
from tensor_stream_torch.ops import ring_attention as ra

RANKS = 4
SHAPE = (1, 2, 256, 64)  # 4 positions of 64 tokens
GRADS = ("dq", "dk", "dv")
# The flash gradient rule's relative-norm bound in bf16 (chip_smoke.py).
GRAD_REL = chip_smoke.FLASH_GRAD_REL[torch.bfloat16]
DK_CAST_REL = chip_smoke.FLASH_DK_CAST_REL
# How much further from the f32 gradient the port's ring may sit than the
# JAX ring: one flash call of the port already sits up to 13% further from
# it than the JAX single call, having rounded dS to bf16.
PORT_OVER_JAX = 1.25


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    stds = (chip_smoke.FLASH_QK_STD, chip_smoke.FLASH_QK_STD,
            chip_smoke.FLASH_V_STD, 1.0)
    return [(rng.standard_normal(SHAPE) * s).astype(np.float32)
            for s in stds]


@pytest.fixture(scope="module", params=[False, True], ids=["full", "causal"])
def grads(request):
    """Every gradient of one case: the port's ring, the JAX ring and single
    call, all in bf16, and the JAX single call in f32."""
    causal = request.param
    q, k, v, do = _inputs(7 + causal)
    scale = SHAPE[-1] ** -0.5
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), ("cp",))
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    jdo = jnp.asarray(do, jnp.bfloat16)

    def jax_grads(fn, args, cot):
        return [np.asarray(g.astype(jnp.float32))
                for g in jax.vjp(fn, *args)[1](cot)]

    out = {
        "jax_ring": jax_grads(lambda *a: ring_attention_sharded(
            mesh, *a, seq_axis="cp", causal=causal), bf, jdo),
        "jax_single": jax_grads(
            lambda *a: _reference(*a, causal, scale), bf, jdo),
        "f32": jax_grads(lambda *a: _reference(*a, causal, scale),
                         [jnp.asarray(x) for x in (q, k, v)],
                         jnp.asarray(do))}
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    o, l, m = ra.virtual_ring(tq, tk, tv, RANKS, causal=causal)
    out["port_ring"] = [g.float().numpy() for g in ra.virtual_ring_bwd(
        tq, tk, tv, o, l, m, tdo, RANKS, causal=causal)]
    return {key: dict(zip(GRADS, gs)) for key, gs in out.items()}


@pytest.mark.parametrize("name", GRADS)
def test_port_ring_agrees_with_jax_ring(grads, name):
    """The two rings' gradients in bf16 within the flash gradient rule's
    relative-norm bound (measured 3.6e-3 to 6.4e-3)."""
    assert _rel(grads["port_ring"][name],
                grads["jax_ring"][name]) <= GRAD_REL


def test_jax_ring_dk_leaves_its_single_call_too(grads):
    """The reference's own ring sits further from its single call's bf16
    dK than dk_cast allows one call (measured 4.0e-3 and 4.1e-3): the gap
    is the ring's per-hop bf16 dK, the reference's design as much as the
    port's, not a fault of the port's summation. The port's ring is held
    to the JAX ring and to f32 by the tests around this one."""
    assert _rel(grads["jax_ring"]["dk"],
                grads["jax_single"]["dk"]) > DK_CAST_REL


@pytest.mark.parametrize("name", GRADS)
def test_port_ring_is_as_close_to_f32_as_jax_ring(grads, name):
    """Against the f32 gradient, the port's ring is within PORT_OVER_JAX
    of the JAX ring's error (measured 0.99 to 1.14 times it)."""
    f32 = grads["f32"][name]
    assert (_rel(grads["port_ring"][name], f32)
            <= PORT_OVER_JAX * _rel(grads["jax_ring"][name], f32))
