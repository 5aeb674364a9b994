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


LOG2E = 1.4426950408889634
DESIGNS = {
    # The mma.sync kernel of the first port: 64 q rows x 64 kv columns a
    # block, softmax in natural units with expf.
    "mma_sync": {"bq": 64, "bk": 64, "base2": False},
    # The wgmma kernel at d <= 64: 192 q rows (three consumer warpgroups)
    # x 128 kv columns, softmax as exp2(s * scale*log2e - m * scale*log2e)
    # on the raw dot products, m scaled once at the end.
    "wgmma": {"bq": 192, "bk": 128, "base2": True},
}


def _swizzle_fault(k):
    """K as a kernel would read it with the 128-byte swizzle left out of
    its descriptor: in kv row r, 16-byte chunk j holds chunk j ^ (r % 8)."""
    s, d = k.shape[-2], k.shape[-1]
    r = torch.arange(s)[:, None]
    j = torch.arange(d // 8)[None, :]
    src = ((j ^ (r % 8)) * 8)[..., None] + torch.arange(8)
    return torch.gather(k, -1, src.reshape(s, d).expand(k.shape))


def _tiled_fwd(q, k, v, bq=64, bk=64, base2=False, causal=False,
               drop_tile=None, lost_cols=(), swizzled_k=False,
               causal_tiles_short=0):
    """The kernel's numerics in torch: q tiles of `bq` rows, each looping
    over kv tiles of `bk` up to the causal bound (KvRange), online m and l
    in f32, masked logits -0.7 * f32max, unnormalized P rounded to v's
    dtype before P@V; `base2` takes the wgmma kernel's exp2 form. Faults:
    `drop_tile` skips one kv tile; `lost_cols` zeroes those columns of each
    tile's P in P@V only (a fault in the P fragment or V's layout);
    `swizzled_k` reads K with the swizzle left out (_swizzle_fault);
    `causal_tiles_short` ends the causal loop that many q tiles early."""
    scale = q.shape[-1] ** -0.5
    c2 = scale * LOG2E
    sq, sk = q.shape[2], k.shape[2]
    kk = _swizzle_fault(k) if swizzled_k else k
    o = torch.empty(q.shape, dtype=q.dtype)
    l_out = torch.empty(q.shape[:3])
    m_out = torch.empty(q.shape[:3])
    for q0 in range(0, sq, bq):
        qt = q[:, :, q0:q0 + bq].float()
        rows = torch.arange(q0, q0 + qt.shape[2])[:, None]
        hi = sk
        if causal:
            hi = min(sk, q0 + bq - causal_tiles_short * bq)
        m = torch.full(qt.shape[:3], -float("inf"))
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        for t, k0 in enumerate(range(0, max(hi, 0), bk)):
            if t == drop_tile:
                continue
            cols = torch.arange(k0, min(k0 + bk, sk))[None, :]
            s = torch.matmul(qt, kk[:, :, k0:k0 + bk].float()
                             .transpose(-1, -2))
            if not base2:
                s = s * scale
            if causal:
                s = torch.where(cols <= rows, s,
                                torch.tensor(fa.MASK_VALUE))
            m_new = torch.maximum(m, s.amax(-1))
            if base2:
                alpha = torch.exp2((m - m_new) * c2)
                mc = torch.where(m_new > fa.MASK_VALUE, m_new * c2,
                                 torch.zeros(()))
                p = torch.exp2(s * c2 - mc[..., None])
            else:
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = p.to(v.dtype).float()
            pv[..., list(lost_cols)] = 0
            acc = (acc * alpha[..., None]
                   + pv @ v[:, :, k0:k0 + bk].float())
            m = m_new
        inv = torch.where(l == 0, torch.ones(()), 1 / l)
        o[:, :, q0:q0 + bq] = (acc * inv[..., None]).to(q.dtype)
        l_out[:, :, q0:q0 + bq] = l
        m_out[:, :, q0:q0 + bq] = m * scale if base2 else m
    return o, l_out, m_out


ALL_CHECKS = {"o", "o_rel", "l", "m"}
SMOKE_RULE_CASES = [
    # name, design, causal, fault, checks the fault must fail (None: it
    # must pass all)
    ("kernel_numerics", "mma_sync", False, {}, None),
    ("dropped_kv_tile", "mma_sync", False, {"drop_tile": 7}, ALL_CHECKS),
    ("lost_p_columns", "mma_sync", False, {"lost_cols": (0, 2, 4, 6)},
     {"o", "o_rel"}),
    ("wgmma_kernel_numerics", "wgmma", False, {}, None),
    ("wgmma_causal_numerics", "wgmma", True, {}, None),
    ("wgmma_dropped_kv_tile", "wgmma", False, {"drop_tile": 5}, ALL_CHECKS),
    ("wgmma_lost_p_columns", "wgmma", False, {"lost_cols": (0, 2, 4, 6)},
     {"o", "o_rel"}),
    ("wgmma_swizzled_k", "wgmma", False, {"swizzled_k": True}, ALL_CHECKS),
    # One q tile short in the causal bound, at the 128-row tile (d = 128)
    # and the 192-row tile (d <= 64): each tile loses its diagonal block.
    ("wgmma_causal_tile_short_bq128", "wgmma", True,
     {"bq": 128, "causal_tiles_short": 1}, ALL_CHECKS),
    ("wgmma_causal_tile_short_bq192", "wgmma", True,
     {"causal_tiles_short": 1}, ALL_CHECKS),
]


@pytest.mark.parametrize("name,design,causal,fault,fails", SMOKE_RULE_CASES,
                         ids=[c[0] for c in SMOKE_RULE_CASES])
def test_smoke_flash_rule_sees_kernel_faults(name, design, causal, fault,
                                             fails):
    """chip_smoke.py's kernel-vs-plain rule, on its inputs at the headline
    length (S=1568, bf16), passes the numerics of both kernel designs (the
    mma.sync one and the wgmma one, causal too) and fails each of their
    faults: a dropped kv tile, P columns lost in P@V (only o sees it: l and
    m never see P@V), K read without its swizzle, a causal loop one q tile
    short."""
    gen = torch.Generator().manual_seed(0)
    std = (chip_smoke.FLASH_QK_STD,) * 2 + (chip_smoke.FLASH_V_STD,)
    q, k, v = ((torch.randn((1, 2, 1568, 64), generator=gen) * s)
               .to(torch.bfloat16) for s in std)
    want = fa.flash_attention_plain(q, k, v, causal=causal, residuals=True)
    got = _tiled_fwd(q, k, v, causal=causal, **{**DESIGNS[design], **fault})
    checks, errs = chip_smoke.flash_rule(got, want)
    failed = {c for c, passed in checks.items() if not passed}
    assert failed == (fails or set()), errs


def test_swizzle_fault_permutes_chunks_within_rows():
    k = torch.arange(2 * 16 * 64, dtype=torch.float32).reshape(1, 2, 16, 64)
    got = _swizzle_fault(k)
    assert torch.equal(got[..., 0, :], k[..., 0, :])
    assert torch.equal(got[..., 8, :], k[..., 8, :])
    assert torch.equal(got[0, 0, 3, 8:16], k[0, 0, 3, 16:24])  # 1 ^ 3 = 2
    assert torch.equal(got.sort(-1).values, k.sort(-1).values)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_requires_grad_flows_through(which):
    """The op is differentiable on every impl: the one input that requires
    grad gets autograd's gradient of flash_attention_plain (f32, so the
    same math up to reduction order: 2e-5 at the gradient scale of 10),
    and no_grad still runs the forward alone."""
    qkv = [torch.from_numpy(a) for a in make(1, 2, 2, 24, 24, 32, seed=which)]
    do = torch.from_numpy(make(1, 2, 2, 24, 24, 32, seed=9)[0])
    x = qkv[which].clone().requires_grad_(True)
    args = [x if i == which else t for i, t in enumerate(qkv)]
    fa.flash_attention_plain(*args, causal=True).backward(do)
    want = x.grad
    for impl in ("auto", "plain"):
        x.grad = None
        fa.flash_attention(*args, causal=True, impl=impl).backward(do)
        torch.testing.assert_close(x.grad, want, atol=2e-4, rtol=2e-4)
    with torch.no_grad():
        assert fa.flash_attention(*args).shape == (1, 2, 24, 32)
