"""The port's flash backward (tensor_stream_torch/ops/flash_attention.py)
against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through ``jax.vjp`` of
the JAX ``flash_attention(..., impl="pallas")`` (the Pallas forward in
interpret mode and the tile-recomputing ``_flash_bwd``, as
tests/test_flash_attention.py runs them) and through the port's
``flash_attention_fwd`` and ``flash_attention_bwd``, which run their plain
versions on CPU tensors. Tolerances are tests/test_flash_attention.py's
gradient rule: its forward tolerance (bf16 2e-2, f32 2e-5 on the CPU) at a
scale of 10, since a gradient accumulates one more chain of products. The
CUDA kernel runs only on the card (chip_smoke.py holds it against the
plain version there, under ``chip_smoke.bwd_rule``, which the last tests
here show failing a broken backward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tensor_stream_tpu.ops import flash_attention as jfa
from test_torch_flash import _swizzle_fault
from tensor_stream_torch.ops import flash_attention as fa

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 2e-5, "bf16": 2e-2}
GRAD_SCALE = 10.0


def make(b, h, hk, sq, sk, d, seed):
    """q, k, v of std 1 and dO of std 1, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, hk, sk, d), (b, hk, sk, d),
                          (b, h, sq, d))]


def close(got, want, dtype, what):
    t = TOL[dtype] * GRAD_SCALE
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=t, rtol=t,
                               err_msg=what)


CASES = [
    # name, (b, h, hk, sq, sk, d), causal, window
    ("full", (1, 2, 2, 128, 128, 32), False, None),
    ("causal", (1, 2, 2, 128, 128, 64), True, None),
    ("window_causal", (1, 2, 2, 256, 256, 32), True, 40),
    ("window_symmetric", (1, 2, 2, 256, 256, 32), False, 40),
    ("gqa_4_to_2", (1, 4, 2, 128, 128, 32), False, None),
    ("ragged_cross_100_to_300", (1, 1, 1, 100, 300, 64), False, None),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape,causal,window", CASES,
                         ids=[c[0] for c in CASES])
def test_bwd_plain_matches_jax_vjp(name, shape, causal, window, dtype):
    arrays = make(*shape, seed=len(name))
    jdt, tdt = DTYPES[dtype]
    jq, jk, jv, jdo = [jnp.asarray(a, jdt) for a in arrays]
    _, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, causal=causal, window=window, impl="pallas"), jq, jk, jv)
    want = vjp(jdo)
    q, k, v, do = [torch.from_numpy(a).to(tdt) for a in arrays]
    o, l, m = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    got = fa.flash_attention_bwd(q, k, v, o, l, m, do, causal=causal,
                                 window=window)
    for what, g, w, like in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert g.dtype == tdt and g.shape == like.shape
        close(g, w, dtype, what)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape,causal,window", CASES,
                         ids=[c[0] for c in CASES])
def test_autograd_matches_plain_autograd(name, shape, causal, window, dtype):
    """Gradients through flash_attention with requires_grad (the
    autograd.Function, whose backward is flash_attention_bwd) against
    torch autograd of flash_attention_plain, on the layout the model hands
    it: [B, S, H, d] leaves seen through a transpose."""
    arrays = make(*shape, seed=len(name) + 7)
    tdt = DTYPES[dtype][1]

    def leaves():
        return [torch.from_numpy(a).to(tdt).transpose(1, 2).contiguous()
                .requires_grad_(True) for a in arrays[:3]]
    do = torch.from_numpy(arrays[3]).to(tdt)
    grads = []
    for fn in (lambda q, k, v: fa.flash_attention(q, k, v, causal=causal,
                                                  window=window),
               lambda q, k, v: fa.flash_attention_plain(q, k, v, causal,
                                                        window)):
        xs = leaves()
        out = fn(*[x.transpose(1, 2) for x in xs])
        out.backward(do)
        grads.append([x.grad for x in xs])
    for what, g, w in zip(("dq", "dk", "dv"), *grads):
        assert g.dtype == tdt
        close(g, w.float().numpy(), dtype, what)


def test_no_grad_launches_nothing_new_and_keeps_no_residuals(monkeypatch):
    """Under no_grad (serving, streaming) the op calls the residual-free
    forward and nothing of the backward; with grad it keeps residuals."""
    seen = []
    real = fa._dispatch

    def spy(*args):
        seen.append(args[-1])               # the `residuals` flag
        return real(*args)
    monkeypatch.setattr(fa, "_dispatch", spy)
    q, k, v = [torch.from_numpy(a).requires_grad_(True)
               for a in make(1, 2, 2, 16, 16, 32, seed=1)[:3]]
    fa.reset_counts()
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    fa.flash_attention(q.detach(), k.detach(), v.detach())
    assert seen == [False, False]
    fa.flash_attention(q, k, v).sum().backward()
    assert seen == [False, False, True]
    assert fa.bwd_launches == 0 and fa.launches == 0  # the CPU launches none
    assert q.grad is not None and k.grad is not None and v.grad is not None


def test_bwd_impl_cuda_on_cpu_raises_and_plain_forces_plain():
    q, k, v, do = [torch.from_numpy(a) for a in make(1, 2, 1, 24, 24, 32, 2)]
    o, l, m = fa.flash_attention_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd(q, k, v, o, l, m, do, causal=True,
                               impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        fa.flash_attention_bwd(q, k, v, o, l, m, do, impl="pallas")
    got = fa.flash_attention_bwd(q, k, v, o, l, m, do, causal=True,
                                 impl="plain")
    want = fa.flash_attention_bwd_plain(q, k, v, o, l, m, do, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fa.bwd_launches == 0


def test_plain_bwd_is_autograd_of_the_plain_forward_in_f64_terms():
    """In f32 the plain backward is the exact gradient of the plain forward
    up to f32 rounding: held against autograd in f64 at 1e-4 relative."""
    q, k, v, do = [torch.from_numpy(a)
                   for a in make(2, 4, 2, 40, 56, 32, seed=4)]
    o, l, m = fa.flash_attention_fwd(q, k, v, sm_scale=0.2)
    got = fa.flash_attention_bwd_plain(q, k, v, o, l, m, do, sm_scale=0.2)
    xs = [t.double().requires_grad_(True) for t in (q, k, v)]
    kk = xs[1].repeat_interleave(2, dim=1)
    vv = xs[2].repeat_interleave(2, dim=1)
    p = torch.softmax(xs[0] @ kk.transpose(-1, -2) * 0.2, dim=-1)
    (p @ vv).backward(do.double())
    for g, x in zip(got, xs):
        torch.testing.assert_close(g.double(), x.grad, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_bwd_kernel_matches_plain_on_the_card():
    """The backward kernel against flash_attention_bwd_plain on the same
    CUDA tensors and residuals, under chip_smoke.bwd_rule (chip_smoke.py
    runs the full case list), and two launches give the same bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for dtype in (torch.bfloat16, torch.float32):
        for causal, window in ((False, None), (True, None), (True, 33),
                               (False, 33)):
            q, k, v = chip_smoke._flash_case(2, 4, 2, 200, 200, 64, dtype, 3)
            do = chip_smoke._grad_out(2, 4, 200, 64, dtype, 4)
            o, l, m = fa.flash_attention_fwd(q, k, v, causal=causal,
                                             window=window)
            before = fa.bwd_launches
            got = fa.flash_attention_bwd(q, k, v, o, l, m, do, causal=causal,
                                         window=window)
            again = fa.flash_attention_bwd(q, k, v, o, l, m, do,
                                           causal=causal, window=window)
            assert fa.bwd_launches == before + 2
            want = fa.flash_attention_bwd_plain(q, k, v, o, l, m, do, causal,
                                                window)
            checks, errs = chip_smoke.bwd_rule(got, want)
            assert all(checks.values()), errs
            for x, y in zip(got, again):
                assert chip_smoke.bytes_equal(x, y)


# ------------------------------------------------ the card's rule can fail

def _broken_bwd(q, k, v, o, l, m, do, fault):
    """The plain backward with one fault: "no_delta" drops delta from dS
    (delta = rowsum(dO * o) is 0 for o = 0), "one_head" sums dK and dV
    over the first head of each GQA group only."""
    if fault == "no_delta":
        return fa.flash_attention_bwd_plain(q, k, v, torch.zeros_like(o), l,
                                            m, do)
    first = torch.arange(0, q.shape[1], q.shape[1] // k.shape[1])
    dq, _, _ = fa.flash_attention_bwd_plain(q, k, v, o, l, m, do)
    _, dk, dv = fa.flash_attention_bwd_plain(
        q[:, first], k, v, o[:, first], l[:, first], m[:, first],
        do[:, first])
    return dq, dk, dv


def _regrouped_bwd(q, k, v, o, l, m, do):
    """The plain backward with its kv sums in another order: each kv half
    on its own (with the full rows' l and m), dQ the sum of the halves'."""
    half = k.shape[2] // 2
    parts = [fa.flash_attention_bwd_plain(q, k[:, :, sl], v[:, :, sl], o, l,
                                          m, do)
             for sl in (slice(0, half), slice(half, None))]
    dq = (parts[0][0].float() + parts[1][0].float()).to(q.dtype)
    dk = torch.cat([parts[0][1], parts[1][1]], dim=2)
    dv = torch.cat([parts[0][2], parts[1][2]], dim=2)
    return dq, dk, dv


def _card_like_inputs(dtype):
    """The card check's inputs at a CPU size: q and k of std 2."""
    gen = torch.Generator().manual_seed(11)
    q = (torch.randn((1, 4, 192, 64), generator=gen) * 2).to(dtype)
    k = (torch.randn((1, 2, 192, 64), generator=gen) * 2).to(dtype)
    v = torch.randn((1, 2, 192, 64), generator=gen).to(dtype)
    do = torch.randn((1, 4, 192, 64), generator=gen).to(dtype)
    return q, k, v, do


def _wgmma_fault_bwd(q, k, v, o, l, m, do, fault):
    """flash_attention_bwd_plain's arithmetic with one fault the wgmma
    design (csrc/flash_bwd.cu) could make: "swizzled_q" and "swizzled_do"
    read Q (in S and dK) or dO (in dP and dV) as a wgmma descriptor
    without TMA's 128-byte swizzle would (_swizzle_fault: one 128-byte
    row at d = 64), with delta from the true dO as DeltaTiles reads it;
    "ds_f32" leaves dS in f32 for dQ and dK; "stats_transposed" takes m,
    l_inv and delta at the kv index, where Dkv, whose S^T has kv rows,
    must take them at the q index (needs Sq == Sk)."""
    scale = q.shape[-1] ** -0.5
    dt = q.dtype
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    g = h // hk
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    delta = (do.float() * o.float()).sum(dim=-1)
    qs = _swizzle_fault(q) if fault == "swizzled_q" else q
    dos = (_swizzle_fault(do) if fault == "swizzled_do" else do).float()
    s = torch.matmul(qs.float(), kf.transpose(-1, -2)) * scale
    l_inv = torch.where(l == 0, torch.ones_like(l), 1.0 / l)
    at = (lambda x: x[..., None, :]) if fault == "stats_transposed" else (
        lambda x: x[..., None])
    p = torch.exp(s - at(m)) * at(l_inv)
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), dos)
    dp = torch.matmul(dos, vf.transpose(-1, -2))
    ds = p * (dp - at(delta)) * scale
    if fault != "ds_f32":
        ds = ds.to(dt).float()
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qs.float())
    return (dq.to(dt), dk.view(b, hk, g, sk, d).sum(dim=2).to(dt),
            dv.view(b, hk, g, sk, d).sum(dim=2).to(dt))


# The rows of _card_like_inputs that "tail_p" takes as Sq: the last 64-row
# q tile holds 32 of them.
TAIL_SQ = 160


def _tail_p_bwd(q, k, v, do):
    """The fault "tail_p": the last partial q tile's rows past Sq (=
    TAIL_SQ) are not zero-filled (the tile reads on into the rows after
    the head's last, as a map over the flattened heads would) and their P
    is not zeroed, so they reach dK and dV."""
    o, l, m = fa.flash_attention_fwd(q, k, v)
    dq, dk, dv = fa.flash_attention_bwd_plain(q, k, v, o, l, m, do)
    return dq[:, :, :TAIL_SQ], dk, dv


# The checks of chip_smoke.bwd_rule that each fault must fail, by dtype;
# in f32 dS has no cast to leave out.
FAULT_FAILS = {
    "no_delta": {"dq_rel", "dk_rel"},
    "one_head": {"dk_rel", "dv_rel"},
    "swizzled_q": {"dq_rel", "dk_rel", "dv_rel"},
    "swizzled_do": {"dq_rel", "dk_rel", "dv_rel"},
    "ds_f32": {torch.bfloat16: {"dk_cast"}, torch.float32: set()},
    "stats_transposed": {"dq_rel", "dk_rel", "dv_rel"},
    "tail_p": {"dk_rel", "dv_rel"},
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("fault", [None, "no_delta", "one_head",
                                   "swizzled_q", "swizzled_do", "ds_f32",
                                   "stats_transposed", "tail_p"])
def test_smoke_bwd_rule_sees_faults(fault, dtype):
    """chip_smoke.bwd_rule passes the plain backward with its dQ summed
    over two kv halves (another rounding, as a tiled kernel's) and fails a
    backward that drops delta or a head of each GQA group, and each fault
    of the wgmma design: Q or dO read without the swizzle, dS left in f32
    (bf16 only: f32 has no cast, so it must pass), the row statistics at
    the transposed index, the last partial q tile's rows past Sq reaching
    dK and dV. Inputs of std 2 for q and k, so m varies along a row."""
    q, k, v, do = _card_like_inputs(dtype)
    if fault == "tail_p":
        got = _tail_p_bwd(q, k, v, do)
        q, do = q[:, :, :TAIL_SQ], do[:, :, :TAIL_SQ]
    o, l, m = fa.flash_attention_fwd(q, k, v)
    want = fa.flash_attention_bwd_plain(q, k, v, o, l, m, do)
    if fault is None:
        got = _regrouped_bwd(q, k, v, o, l, m, do)
        checks, errs = chip_smoke.bwd_rule(got, want)
        assert all(checks.values()), errs
        return
    if fault in ("no_delta", "one_head"):
        got = _broken_bwd(q, k, v, o, l, m, do, fault)
    elif fault != "tail_p":
        got = _wgmma_fault_bwd(q, k, v, o, l, m, do, fault)
    checks, errs = chip_smoke.bwd_rule(got, want)
    failed = {c for c, passed in checks.items() if not passed}
    want_failed = FAULT_FAILS[fault]
    if isinstance(want_failed, dict):
        want_failed = want_failed[dtype]
        if not want_failed:
            assert not failed, errs
    assert want_failed <= failed, errs


def test_wgmma_fault_bwd_without_a_fault_is_the_plain_backward():
    """The fault emulation's arithmetic is flash_attention_bwd_plain's,
    bit for bit, when no fault is switched on."""
    q, k, v, do = _card_like_inputs(torch.bfloat16)
    o, l, m = fa.flash_attention_fwd(q, k, v)
    got = _wgmma_fault_bwd(q, k, v, o, l, m, do, None)
    want = fa.flash_attention_bwd_plain(q, k, v, o, l, m, do)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 32),
                                     (torch.float32, 64)],
                         ids=["bf16_d64", "bf16_d32", "f32_d64"])
def test_bwd_design_counts_stay_zero_on_the_cpu(dtype, d):
    """On CPU tensors the backward runs its plain version, directly and
    through autograd, and no design's launch count moves; the counts name
    the five designs and reset_counts zeroes them."""
    fa.reset_counts()
    assert fa.bwd_launches_by_design == dict.fromkeys(
        ("wgmma", "mma_sync", "f32", "short", "mid"), 0)
    q, k, v, do = [torch.from_numpy(a).to(dtype)
                   for a in make(1, 2, 1, 40, 40, d, seed=d)]
    o, l, m = fa.flash_attention_fwd(q, k, v)
    fa.flash_attention_bwd(q, k, v, o, l, m, do)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention(*leaves, causal=True).backward(do)
    assert all(t.grad is not None for t in leaves)
    assert fa.bwd_launches == 0
    assert set(fa.bwd_launches_by_design.values()) == {0}
    fa.bwd_launches_by_design["wgmma"] = 3
    fa.reset_counts()
    assert set(fa.bwd_launches_by_design.values()) == {0}
