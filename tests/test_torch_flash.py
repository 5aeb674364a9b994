"""The port's flash attention (tensor_stream_torch/ops/flash_attention.py)
against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed (bf16 inputs round the same
f32 values to bf16 in both frameworks), go through the port's plain
version and through the JAX ``_reference`` and the Pallas kernel in
interpret mode (``impl="pallas"``, as tests/test_flash_attention.py runs
it). Tolerances are those of tests/test_flash_attention.py on the CPU:
bf16 2e-2 (outputs quantize to 8 mantissa bits; the two sides round P and
reduce in different orders), f32 2e-5 (the same f32 math up to reduction
order). The CUDA kernel itself runs only on the card: the ``gpu`` test
in tests/test_torch_package.py and chip_smoke.py hold it against the
plain version there; here, a torch emulation of the kernel's numerics
shows that chip_smoke.py's rule for that comparison can see its faults.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tensor_stream_tpu.ops import flash_attention as jfa
from tensor_stream_torch.ops import flash_attention as fa

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": 2e-5, "bf16": 2e-2}


def make(b, h, hk, sq, sk, d, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * 0.5).astype(np.float32)
            for shape in ((b, h, sq, d), (b, hk, sk, d), (b, hk, sk, d))]


def to_jax(arrays, dtype):
    return [jnp.asarray(a, DTYPES[dtype][0]) for a in arrays]


def to_torch(arrays, dtype):
    return [torch.from_numpy(a).to(DTYPES[dtype][1]) for a in arrays]


def close(got, want, dtype, what="o"):
    t = TOL[dtype]
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32),
                               atol=t, rtol=t, err_msg=what)


CASES = [
    # name, (b, h, hk, sq, sk, d), causal, window
    ("full_128", (1, 2, 2, 128, 128, 32), False, None),
    ("causal_128", (1, 2, 2, 128, 128, 32), True, None),
    ("ragged_100", (2, 2, 2, 100, 100, 32), False, None),
    ("ragged_causal_200", (1, 2, 2, 200, 200, 64), True, None),
    ("window_causal", (1, 2, 2, 256, 256, 32), True, 40),
    ("window_symmetric", (1, 2, 2, 256, 256, 32), False, 40),
    ("window_ragged", (1, 1, 1, 200, 200, 32), False, 17),
    ("gqa_4_to_2", (1, 4, 2, 128, 128, 32), False, None),
    ("mqa_causal", (1, 4, 1, 100, 100, 32), True, None),
    ("cross_96_to_160", (2, 2, 2, 96, 160, 32), False, None),
    ("cross_gqa", (1, 4, 2, 64, 200, 64), False, None),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape,causal,window", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_jax_reference(name, shape, causal, window, dtype):
    arrays = make(*shape, seed=len(name))
    want = jfa._reference(*to_jax(arrays, dtype), causal,
                          shape[-1] ** -0.5, window)
    got = fa.flash_attention(*to_torch(arrays, dtype), causal=causal,
                             window=window)
    assert got.dtype == DTYPES[dtype][1] and got.shape == want.shape
    close(got, want, dtype)


PALLAS_CASES = [
    # name, (b, h, hk, s, s, d), causal, window, block_q/block_k
    ("ragged_causal", (1, 2, 2, 200, 200, 32), True, None, None),
    ("gqa", (1, 4, 2, 128, 128, 32), False, None, None),
    # _fwd_padded picks _band_kernel: band 256 <= min(sk_pad 512, 4608).
    ("band_kernel_causal", (1, 1, 1, 512, 512, 32), True, 16, 128),
    ("band_kernel_symmetric", (1, 1, 1, 512, 512, 32), False, 16, 128),
    # A band wider than the sequence: the banded-grid _kernel instead.
    ("banded_grid_symmetric", (1, 1, 1, 256, 256, 32), False, 200, 128),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape,causal,window,block", PALLAS_CASES,
                         ids=[c[0] for c in PALLAS_CASES])
def test_residuals_match_pallas_interpret(name, shape, causal, window, block,
                                          dtype):
    """o, l and m against the Pallas kernels' own (interpret mode): l, m
    are the residuals _fwd_padded saves, at the padded length there."""
    arrays = make(*shape, seed=len(name) + 1)
    sq, d = shape[3], shape[-1]
    bq = bk = block or min(256, -(-sq // 128) * 128)
    jq, jk, jv = to_jax(arrays, dtype)
    jo, jl, jm = jfa._fwd_padded(jq, jk, jv, causal, window, d ** -0.5, bq,
                                 bk, True)
    o, l, m = fa.flash_attention_fwd(*to_torch(arrays, dtype), causal=causal,
                                     window=window)
    close(o, jo, dtype)
    close(m, np.asarray(jm)[:, :, :sq], "f32", "m")
    # The Pallas kernel sums bf16-rounded p for bf16 inputs (its
    # ones-augmented V column); the port keeps the f32 sum of p.
    close(l, np.asarray(jl)[:, :, :sq], dtype, "l")
    # The public entry point through the Pallas kernel agrees as well.
    want = jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                               block_q=block, block_k=block, impl="pallas")
    close(o, want, dtype)


def test_plain_residuals_are_row_sum_and_max():
    q, k, v = to_torch(make(1, 2, 2, 50, 70, 32, seed=3), "f32")
    o, l, m = fa.flash_attention_plain(q, k, v, sm_scale=0.3, residuals=True)
    s = torch.matmul(q, k.transpose(-1, -2)) * 0.3
    torch.testing.assert_close(m, s.amax(-1), rtol=0, atol=0)
    torch.testing.assert_close(l, torch.exp(s - m[..., None]).sum(-1))
    torch.testing.assert_close(
        o, fa.flash_attention(q, k, v, sm_scale=0.3), rtol=0, atol=0)


def test_auto_on_cpu_is_the_plain_version():
    q, k, v = to_torch(make(1, 2, 1, 40, 40, 32, seed=5), "bf16")
    launches = fa.launches
    for impl in ("auto", "plain"):
        got = fa.flash_attention(q, k, v, causal=True, window=9, impl=impl)
        torch.testing.assert_close(
            got, fa.flash_attention_plain(q, k, v, True, 9), rtol=0, atol=0)
    assert fa.launches == launches


def test_plain_mask_uses_finite_mask_value():
    """Masked logits are -0.7*f32max, not -inf, as in the JAX module: a
    fully masked row (possible only through band_mask misuse) stays
    finite instead of NaN."""
    assert fa.MASK_VALUE == jfa._MASK_VALUE
    mask = fa.band_mask(6, 6, True, 2, "cpu")
    want = np.tril(np.ones((6, 6), bool)) & ~np.tril(np.ones((6, 6), bool),
                                                      -2)
    np.testing.assert_array_equal(mask.numpy(), want)
    assert fa.band_mask(4, 4, False, None, "cpu") is None


ARG_ERRORS = [
    ("rank", ((1, 2, 8), (1, 2, 8, 32), (1, 2, 8, 32)), {}, ValueError,
     "bad attention shapes"),
    ("kv_mismatch", ((1, 2, 8, 32), (1, 2, 8, 32), (1, 2, 9, 32)), {},
     ValueError, "bad attention shapes"),
    ("head_dim", ((1, 2, 8, 32), (1, 2, 8, 16), (1, 2, 8, 16)), {},
     ValueError, "bad attention shapes"),
    ("gqa_multiple", ((1, 3, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32)), {},
     ValueError, "multiple of kv"),
    ("causal_cross", ((1, 2, 8, 32), (1, 2, 9, 32), (1, 2, 9, 32)),
     {"causal": True}, ValueError, "equal q/kv"),
    ("window_zero", ((1, 2, 8, 32),) * 3, {"window": 0}, ValueError,
     "window must be"),
    ("window_cross", ((1, 2, 8, 32), (1, 2, 9, 32), (1, 2, 9, 32)),
     {"window": 4}, ValueError, "window requires"),
    ("impl", ((1, 2, 8, 32),) * 3, {"impl": "pallas"}, ValueError,
     "unknown impl"),
    ("cuda_on_cpu", ((1, 2, 8, 32),) * 3, {"impl": "cuda"}, ValueError,
     "CUDA device"),
]


@pytest.mark.parametrize("name,shapes,kw,exc,match", ARG_ERRORS,
                         ids=[c[0] for c in ARG_ERRORS])
def test_argument_errors(name, shapes, kw, exc, match):
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(exc, match=match):
        fa.flash_attention(q, k, v, **kw)


def _bshd_views(s, h, d, dtype):
    """MHA's [B, S, H, d] projection seen as [B, H, S, d]."""
    return torch.zeros(2, s, h, d, dtype=dtype).transpose(1, 2)


MISALIGNED = [
    ("last_dim_strided", lambda: torch.zeros(1, 2, 8, 64)[..., ::2],
     "last dim"),
    ("base_offset_bf16", lambda: torch.zeros(1, 2, 8, 33,
                                             dtype=torch.bfloat16)[..., 1:],
     "16-byte aligned"),
    ("seq_stride_f32", lambda: torch.zeros(1, 2, 8, 34)[..., :32],
     "16-byte aligned"),
]


def test_model_layout_is_aligned():
    """The views MHA hands the kernel pass the check without a copy."""
    for dtype in (torch.bfloat16, torch.float32):
        for d in fa.HEAD_DIMS:
            fa.check_aligned(q=_bshd_views(100, 3, d, dtype))


@pytest.mark.parametrize("name,make_t,match", MISALIGNED,
                         ids=[c[0] for c in MISALIGNED])
def test_misaligned_input_raises(name, make_t, match):
    """The wrapper makes no silent copy of a view the kernel cannot load."""
    with pytest.raises(ValueError, match=match):
        fa.check_aligned(q=make_t())


def _tiled_fwd(q, k, v, drop_tile=None, lost_cols=()):
    """The kernel's numerics in torch: 64-wide kv tiles, online m and l in
    f32, unnormalized P rounded to v's dtype before P@V. `drop_tile`
    skips one kv tile; `lost_cols` zeroes those columns of each tile's P
    in P@V only (a fault in the P fragment or V's shared-memory layout)."""
    scale = q.shape[-1] ** -0.5
    m = torch.full(q.shape[:3], fa.MASK_VALUE)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    for t, start in enumerate(range(0, k.shape[2], 64)):
        if t == drop_tile:
            continue
        s = torch.matmul(q.float(), k[:, :, start:start + 64].float()
                         .transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = p.to(v.dtype).float()
        pv[..., list(lost_cols)] = 0
        acc = acc * alpha[..., None] + pv @ v[:, :, start:start + 64].float()
        m = m_new
    return (acc / l[..., None]).to(q.dtype), l, m


SMOKE_RULE_CASES = [
    # name, fault, checks the fault must fail (None: it must pass all)
    ("kernel_numerics", {}, None),
    ("dropped_kv_tile", {"drop_tile": 7}, {"o", "o_rel", "l", "m"}),
    ("lost_p_columns", {"lost_cols": (0, 2, 4, 6)}, {"o", "o_rel"}),
]


@pytest.mark.parametrize("name,fault,fails", SMOKE_RULE_CASES,
                         ids=[c[0] for c in SMOKE_RULE_CASES])
def test_smoke_flash_rule_sees_kernel_faults(name, fault, fails):
    """chip_smoke.py's kernel-vs-plain rule, on its inputs at the headline
    length (S=1568, bf16), passes the kernel's numerics and fails a
    kernel that drops a kv tile or loses P columns in P@V. The last shows
    only in o: l and m never see P@V."""
    gen = torch.Generator().manual_seed(0)
    std = (chip_smoke.FLASH_QK_STD,) * 2 + (chip_smoke.FLASH_V_STD,)
    q, k, v = ((torch.randn((1, 2, 1568, 64), generator=gen) * s)
               .to(torch.bfloat16) for s in std)
    want = fa.flash_attention_plain(q, k, v, residuals=True)
    checks, errs = chip_smoke.flash_rule(_tiled_fwd(q, k, v, **fault), want)
    failed = {c for c, passed in checks.items() if not passed}
    assert failed == (fails or set()), errs


@pytest.mark.parametrize("which", [0, 1, 2])
def test_requires_grad_is_refused(which):
    """The flash backward is not ported: no input that requires grad goes
    through, on any impl, and nothing routes it to the plain version."""
    qkv = [torch.zeros(1, 2, 8, 32) for _ in range(3)]
    qkv[which].requires_grad_(True)
    for impl in ("auto", "plain"):
        with pytest.raises(NotImplementedError, match="queue 2 item 4"):
            fa.flash_attention(*qkv, impl=impl)
    with torch.no_grad():
        assert fa.flash_attention(*qkv).shape == (1, 2, 8, 32)
