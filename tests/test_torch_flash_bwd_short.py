"""The flash backward at short sequences (Sq, Sk <= 64), on the CPU: the
port's plain backward against the JAX package's at the shapes the short
backward design (``csrc/flash_bwd.cu``, ``FlashBwdShort``) serves, and a
torch emulation of that design's arithmetic against chip_smoke.py's rule.

(a) The same inputs, made with numpy from a seed, go through ``jax.vjp``
of the JAX ``flash_attention(impl="pallas")`` (the Pallas forward in
interpret mode and ``_flash_bwd``) and through the port's
``flash_attention_fwd`` and ``flash_attention_bwd``, which run their plain
versions on CPU tensors, at tests/test_torch_flash_bwd.py's tolerances.

(b) ``_short_bwd`` does in torch what the kernel does: delta =
rowsum(dO * o) and the bias b = m log2(e) + log2(l) (l == 0: m log2(e)) of
each row, P = exp2(S scale log2(e) - b) where Live keeps the (row, col)
pair and 0 elsewhere, dS = (P (dP - delta)) scale rounded to bf16; dQ
summed over the 16-column kv chunks in order; dK and dV summed, for each
kv head, over the 16-row q chunks of each q head of its group in order,
the group's heads shared out over the launch's `split` warps (q head g to
warp g % split) and the warps' partials added in order. Heads packed
several to a 16-row tile (MHA at S <= 8) sum the same products: only
their diagonal blocks are live. It must lie within
chip_smoke.bwd_rule of the plain version, on the rule's own inputs (q, k
of std 2).

(c) The rule fails the emulation with a fault of the kind the kernel could
have: dK and dV summed over the next kv head's group, a kv slice's rows
shifted by one, delta taken from the neighbouring q head, a column past
the band's edge leaking into P.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tensor_stream_tpu.ops import flash_attention as jfa
from tensor_stream_torch.ops import flash_attention as fa
from test_torch_flash_bwd import DTYPES, close, make

LOG2E = 1.4426950408889634

SHORT_BWD_CASES = [
    # name, (b, h, hk, sq, sk, d), causal, window
    # The factorized ViT-B's temporal attention at 8 and 16 frames.
    ("vit_b_temporal_4", (2, 4, 4, 4, 4, 64), False, None),
    ("vit_b_temporal_8", (2, 4, 4, 8, 8, 64), False, None),
    # The streaming twin's temporal band, MHA and GQA 6:2.
    ("twin_band", (2, 6, 6, 16, 16, 64), True, 8),
    ("twin_band_gqa", (2, 6, 2, 16, 16, 64), True, 8),
    ("ragged_band_13", (2, 6, 2, 13, 13, 64), True, 5),
    ("cross_16_to_48", (2, 4, 2, 16, 48, 64), False, None),
    ("full_8_d32", (2, 4, 4, 8, 8, 32), False, None),
    ("causal_64_d128", (1, 2, 2, 64, 64, 128), True, None),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape,causal,window", SHORT_BWD_CASES,
                         ids=[c[0] for c in SHORT_BWD_CASES])
def test_plain_bwd_matches_jax_vjp_at_short_s(name, shape, causal, window,
                                              dtype):
    arrays = make(*shape, seed=len(name) + 3)
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


def warps_a_kv_slice(h, hk, sq, sk):
    """The warps of a FlashBwdShort block that share a kv slice, q head g
    of a group on warp g % split (csrc/flash_bwd.cu, PlanShortBwd): 4
    warps over as many kv heads as give each a 16-row q tile, no more than
    give each a kv slice of its own. 1 where FlashBwdPacked serves (MHA
    self-attention at S <= 8, a tile a warp)."""
    if h == hk and sq == sk and sq <= 8:
        return 1
    tk, tq, group = -(-sk // 16), -(-sq // 16), h // hk
    heads = min(1 if group * tq >= 4 else 4 // (group * tq), 4 // tk)
    return min(4 // (heads * tk), group)


def live(rows, cols, sq, sk, causal, window, edge=0):
    """csrc/flash_bwd.cu's Live; `edge` moves the band's low edge that many
    columns further back (a fault)."""
    ok = (rows < sq) & (cols < sk)
    if causal:
        ok = ok & (cols <= rows)
    if window:
        if causal:
            ok = ok & (cols > rows - window - edge)
        else:
            ok = ok & ((cols - rows).abs() < window + edge)
    return ok


def _pad(t, rows):
    out = torch.zeros(t.shape[:2] + (rows,) + t.shape[3:], dtype=t.dtype)
    out[:, :, :t.shape[2]] = t
    return out


def _short_bwd(q, k, v, o, l, m, do, causal=False, window=None, fault=None):
    """The short design's numerics in torch; the faults as the module's
    docstring lists them: "next_group", "slice_shift", "delta_head",
    "band_leak"."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group, dt = h // hk, q.dtype
    scale = d ** -0.5
    c2 = scale * LOG2E
    split = warps_a_kv_slice(h, hk, sq, sk)
    sqp, skp = 16 * -(-sq // 16), 16 * -(-sk // 16)
    qf, dof = _pad(q, sqp).float(), _pad(do, sqp).float()
    kf = _pad(k, skp).float().repeat_interleave(group, dim=1)
    vf = _pad(v, skp).float().repeat_interleave(group, dim=1)
    delta = _pad((do.float() * o.float()).sum(-1)[..., None], sqp)[..., 0]
    if fault == "delta_head":
        delta = delta.roll(1, dims=1)
    bias = m * LOG2E + torch.where(l == 0, torch.zeros(()), torch.log2(l))
    bias = _pad(bias[..., None], sqp)[..., 0]
    rows = torch.arange(sqp)[:, None]
    cols = torch.arange(skp)[None, :]
    keep = live(rows, cols, sq, sk, causal, window,
                1 if fault == "band_leak" else 0)
    s = qf @ kf.transpose(-1, -2)
    dp = dof @ vf.transpose(-1, -2)
    p = torch.where(keep, torch.exp2(s * c2 - bias[..., None]),
                    torch.zeros(()))
    ds = ((p * (dp - delta[..., None])) * scale).to(dt).float()
    pc = p.to(dt).float()

    dq = torch.zeros((b, h, sqp, d))
    for kc in range(0, skp, 16):
        dq += ds[..., kc:kc + 16] @ kf[:, :, kc:kc + 16]
    dk = torch.zeros((b, hk, skp, d))
    dv = torch.zeros((b, hk, skp, d))
    for j in range(hk):
        src = (j + 1) % hk if fault == "next_group" else j
        parts = []
        for sp in range(split):
            pk = torch.zeros((b, skp, d))
            pv = torch.zeros((b, skp, d))
            for gi in range(sp, group, split):
                hh = src * group + gi
                for qc in range(0, sqp, 16):
                    rows_ = slice(qc, qc + 16)
                    pk += ds[:, hh, rows_].transpose(-1, -2) @ qf[:, hh,
                                                                  rows_]
                    pv += pc[:, hh, rows_].transpose(-1, -2) @ dof[:, hh,
                                                                   rows_]
            parts.append((pk, pv))
        for pk, pv in parts:
            dk[:, j] += pk
            dv[:, j] += pv
    if fault == "slice_shift":
        dk = dk.view(b, hk, skp // 16, 16, d).roll(1, dims=3).view(dk.shape)
        dv = dv.view(b, hk, skp // 16, 16, d).roll(1, dims=3).view(dv.shape)
    return (dq[:, :, :sq].to(dt), dk[:, :, :sk].to(k.dtype),
            dv[:, :, :sk].to(v.dtype))


def _rule_inputs(b, h, hk, sq, sk, d, seed, causal=False, window=None):
    """chip_smoke's inputs (q, k of std 2, v and dO of std 1) in bf16, and
    the plain forward's o, l and m."""
    gen = torch.Generator().manual_seed(seed)
    stds = (chip_smoke.FLASH_QK_STD, chip_smoke.FLASH_QK_STD,
            chip_smoke.FLASH_V_STD, 1.0)
    q, k, v, do = [(torch.randn((b, heads, s, d), generator=gen) * std)
                   .to(torch.bfloat16)
                   for heads, s, std in zip((h, hk, hk, h), (sq, sk, sk, sq),
                                            stds)]
    o, l, m = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    return q, k, v, o, l, m, do


EMULATED_CASES = SHORT_BWD_CASES + [
    ("mqa_64_d128_band", (1, 12, 1, 64, 64, 128), True, 20),
    ("symmetric_band_40_d32", (2, 4, 4, 40, 40, 32), False, 6),
]


@pytest.mark.parametrize("name,shape,causal,window", EMULATED_CASES,
                         ids=[c[0] for c in EMULATED_CASES])
def test_short_bwd_design_is_within_the_smoke_rule(name, shape, causal,
                                                   window):
    args = _rule_inputs(*shape, seed=len(name), causal=causal, window=window)
    want = fa.flash_attention_bwd_plain(*args, causal, window)
    got = _short_bwd(*args, causal, window)
    checks, errs = chip_smoke.bwd_rule(got, want)
    assert all(checks.values()), errs


def test_gqa_warps_share_their_kv_slice():
    """The order of dK and dV's sums at the main paths: ViT-B's temporal
    heads and the twin's MHA band give each kv slice one warp; the twin's
    GQA band (one kv head a block) shares its slice over its 3 q heads'
    warps; MQA at S = 64 gives each of 4 kv slices one warp."""
    assert warps_a_kv_slice(12, 12, 4, 4) == 1
    assert warps_a_kv_slice(6, 6, 16, 16) == 1
    assert warps_a_kv_slice(6, 2, 16, 16) == 3
    assert warps_a_kv_slice(12, 1, 64, 64) == 1


FAULTS = [
    # name, (b, h, hk, s, s, d), causal, window, fault, checks it must fail
    ("dk_over_the_next_group", (4, 6, 2, 16, 16, 64), True, 8, "next_group",
     {"dk", "dk_rel", "dv", "dv_rel", "dk_cast"}),
    ("kv_slice_rows_shifted", (4, 6, 6, 16, 16, 64), True, 8, "slice_shift",
     {"dk", "dk_rel", "dv", "dv_rel", "dk_cast"}),
    ("delta_from_the_wrong_head", (4, 6, 6, 16, 16, 64), True, 8,
     "delta_head", {"dq_rel", "dk_rel", "dk_cast"}),
    ("masked_column_in_p", (4, 6, 6, 16, 16, 64), True, 8, "band_leak",
     {"dq_rel", "dk_rel", "dv_rel", "dk_cast"}),
]


@pytest.mark.parametrize("name,shape,causal,window,fault,fails", FAULTS,
                         ids=[c[0] for c in FAULTS])
def test_smoke_bwd_rule_sees_short_design_faults(name, shape, causal, window,
                                                 fault, fails):
    """chip_smoke.bwd_rule, on its inputs at the twin's temporal band,
    fails each fault of the short design in (at least) the checks listed."""
    args = _rule_inputs(*shape, seed=5, causal=causal, window=window)
    want = fa.flash_attention_bwd_plain(*args, causal, window)
    got = _short_bwd(*args, causal, window, fault)
    checks, errs = chip_smoke.bwd_rule(got, want)
    assert fails <= {c for c, ok in checks.items() if not ok}, errs


def test_short_bwd_design_takes_the_shapes_up_to_64():
    """chip_smoke.bwd_design names "short" exactly where the kernel's rule
    (csrc/flash_bwd.cu, Design) sends bf16: Sq and Sk <= 64, any d; past
    64 d = 64 goes to "mid" up to 256 and "wgmma" beyond."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert chip_smoke.bwd_design(bf16, 64, 1568, 12, 12, 4, 4) == "short"
    assert chip_smoke.bwd_design(bf16, 128, 2, 12, 1, 64, 64) == "short"
    assert chip_smoke.bwd_design(bf16, 32, 2, 4, 4, 16, 48) == "short"
    assert chip_smoke.bwd_design(bf16, 64, 2, 4, 4, 16, 65) == "mid"
    assert chip_smoke.bwd_design(bf16, 64, 32, 12, 12, 196, 196) == "mid"
    assert chip_smoke.bwd_design(bf16, 64, 4, 12, 12, 257, 257) == "wgmma"
    assert chip_smoke.bwd_design(bf16, 128, 2, 4, 4, 65, 65) == "mma_sync"
    assert chip_smoke.bwd_design(f32, 64, 2, 4, 4, 4, 4) == "f32"


def test_short_bwd_counts_stay_zero_on_the_cpu():
    """On CPU tensors the backward at short S runs its plain version,
    directly and through autograd, and no design's count moves."""
    fa.reset_counts()
    args = _rule_inputs(2, 6, 2, 16, 16, 64, seed=9, causal=True, window=8)
    fa.flash_attention_bwd(*args, causal=True, window=8)
    q, k, v = (t.clone().requires_grad_(True) for t in args[:3])
    fa.flash_attention(q, k, v, causal=True, window=8).backward(args[-1])
    assert q.grad is not None and k.grad is not None
    assert fa.bwd_launches == 0 and fa.launches == 0
    assert set(fa.bwd_launches_by_design.values()) == {0}
