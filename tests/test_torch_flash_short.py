"""The flash forward at short sequences (Sq, Sk <= 64), on the CPU: the
port's plain version against the JAX package's kernels at the shapes the
short design (``csrc/flash_fwd.cu``, ``FlashFwdShort``) serves, and a torch
emulation of that design's arithmetic against chip_smoke.py's rule.

(a) The same inputs, made with numpy from a seed, go through
``flash_attention_plain`` (``flash_attention_fwd`` on CPU tensors) and the
JAX package's Pallas kernel in interpret mode (``_fwd_padded``, its
residuals, and ``flash_attention(impl="pallas")``), as
tests/test_torch_flash.py does at longer sequences, at its tolerances.

(b) ``_short_fwd`` does in torch what the kernel does: a 16-row tile of
one q head against the kv head its block packs it with (q head h of kv
head h // (H / Hk)), the column pairs KvRange gives the tile, masked by
Live with -0.7 * f32max, one softmax pass over the whole row in base 2
on the raw dot products, l the f32 sum of p, P cast to bf16 before P V
in f32, o = acc * (l == 0 ? 1 : 1/l) and m the row max times the scale.
It must lie within chip_smoke.flash_rule of the plain version, on the
rule's own inputs (q, k of std 2).

(c) The rule fails the emulation with a fault of the kind the kernel
could have: the band's edge a column off, a packed q head reading the
wrong kv head, l summed over the masked columns, a head's rows written
to the next head.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from tensor_stream_tpu.ops import flash_attention as jfa
from tensor_stream_torch.ops import flash_attention as fa
from test_torch_flash import close, make, to_jax, to_torch

LOG2E = 1.4426950408889634

SHORT_CASES = [
    # name, (b, h, hk, sq, sk, d), causal, window
    # The streaming twin's temporal band at a narrow batch, MHA and GQA.
    ("twin_band", (4, 6, 6, 16, 16, 64), True, 8),
    ("twin_band_gqa", (4, 6, 2, 16, 16, 64), True, 8),
    # The factorized ViT's temporal attention at 16 frames, tubelet 2.
    ("full_8", (2, 4, 4, 8, 8, 32), False, None),
    ("ragged_band_13", (2, 6, 2, 13, 13, 64), True, 5),
    ("cross_16_to_48", (2, 4, 2, 16, 48, 64), False, None),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape,causal,window", SHORT_CASES,
                         ids=[c[0] for c in SHORT_CASES])
def test_plain_matches_pallas_interpret_at_short_s(name, shape, causal,
                                                   window, dtype):
    """o, l and m against the Pallas kernel's (interpret mode, one
    128-row tile: the banded-grid ``_kernel``, the band being wider than
    the padded sequence), and o against the public entry point."""
    arrays = make(*shape, seed=len(name) + 7)
    sq, d = shape[3], shape[-1]
    jq, jk, jv = to_jax(arrays, dtype)
    jo, jl, jm = jfa._fwd_padded(jq, jk, jv, causal, window, d ** -0.5, 128,
                                 128, True)
    o, l, m = fa.flash_attention_fwd(*to_torch(arrays, dtype), causal=causal,
                                     window=window)
    close(o, jo, dtype)
    close(m, np.asarray(jm)[:, :, :sq], "f32", "m")
    # The Pallas kernel sums bf16-rounded p for bf16 inputs; the port
    # keeps the f32 sum of p.
    close(l, np.asarray(jl)[:, :, :sq], dtype, "l")
    close(o, jfa.flash_attention(jq, jk, jv, causal=causal, window=window,
                                 impl="pallas"), dtype)


def kv_range(r0, sk, causal, window):
    """csrc/flash_fwd.cu's KvRange for q rows [r0, r0 + 16)."""
    lo, hi = 0, sk
    if causal:
        hi = min(hi, r0 + 16)
    if window:
        lo = max(r0 - (window - 1), 0)
        if not causal:
            hi = min(hi, r0 + 16 + window - 1)
    return lo, hi


def live(rows, cols, sk, causal, window, edge=0):
    """csrc/flash_fwd.cu's Live; `edge` moves the band's low edge that
    many columns further back (a fault)."""
    ok = cols < sk
    if causal:
        ok = ok & (cols <= rows)
    if window:
        if causal:
            ok = ok & (cols > rows - window - edge)
        else:
            ok = ok & ((cols - rows).abs() < window + edge)
    return ok


def _short_fwd(q, k, v, causal=False, window=None, band_edge_off=0,
               wrong_kv_head=False, l_over_masked=False, rows_to_next=False):
    """The short design's numerics in torch, tile by tile; the faults as
    the module's docstring lists them."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    scale = d ** -0.5
    c2 = scale * LOG2E
    heads = torch.arange(h)
    kv = heads % hk if wrong_kv_head else heads // group
    kf, vf = k.float()[:, kv], v[:, kv]
    o = torch.empty(q.shape, dtype=q.dtype)
    l_out = torch.empty(q.shape[:3])
    m_out = torch.empty(q.shape[:3])
    for r0 in range(0, sq, 16):
        rows = torch.arange(r0, r0 + 16)[:, None]
        cols = torch.arange(64)[None, :]
        lo, hi = kv_range(r0, sk, causal, window)
        plo, phi = lo // 16, -(-hi // 16)
        qt = torch.zeros((b, h, 16, d))
        qt[:, :, :min(16, sq - r0)] = q[:, :, r0:r0 + 16].float()
        kt = torch.zeros((b, h, 64, d))
        kt[:, :, :sk] = kf
        s = qt @ kt.transpose(-1, -2)  # raw dot products
        computed = (cols >= 16 * plo) & (cols < 16 * phi)
        keep = computed & live(rows, cols, sk, causal, window, band_edge_off)
        masked = torch.where(keep, s, torch.tensor(fa.MASK_VALUE))
        mx = masked.amax(-1)
        mc = torch.where(mx > fa.MASK_VALUE, mx * c2, torch.zeros(()))
        p = torch.exp2(masked * c2 - mc[..., None])
        if l_over_masked:
            l = torch.where(computed, torch.exp2(s * c2 - mc[..., None]),
                            torch.zeros(())).sum(-1)
        else:
            l = p.sum(-1)
        vt = torch.zeros((b, h, 64, d))
        vt[:, :, :sk] = vf.float()
        acc = p.to(v.dtype).float() @ vt
        inv = torch.where(l == 0, torch.ones(()), 1 / l)
        n = min(16, sq - r0)
        o[:, :, r0:r0 + n] = (acc * inv[..., None]).to(q.dtype)[:, :, :n]
        l_out[:, :, r0:r0 + n] = l[:, :, :n]
        m_out[:, :, r0:r0 + n] = (mx * scale)[:, :, :n]
    if rows_to_next:
        o = o.roll(1, dims=1)
    return o, l_out, m_out


def _rule_inputs(b, h, hk, sq, sk, d, seed):
    gen = torch.Generator().manual_seed(seed)
    stds = (chip_smoke.FLASH_QK_STD, chip_smoke.FLASH_QK_STD,
            chip_smoke.FLASH_V_STD)
    return [(torch.randn((b, heads, s, d), generator=gen) * std)
            .to(torch.bfloat16)
            for heads, s, std in zip((h, hk, hk), (sq, sk, sk), stds)]


EMULATED_CASES = SHORT_CASES + [
    ("full_64_d128", (2, 6, 6, 64, 64, 128), False, None),
    ("symmetric_band_40", (2, 4, 4, 40, 40, 32), False, 6),
    ("band_past_one_tile_gqa", (2, 6, 2, 64, 64, 64), True, 8),
    ("mha_32", (2, 4, 4, 32, 32, 64), False, None),
]


@pytest.mark.parametrize("name,shape,causal,window", EMULATED_CASES,
                         ids=[c[0] for c in EMULATED_CASES])
def test_short_design_is_within_the_smoke_rule(name, shape, causal, window):
    q, k, v = _rule_inputs(*shape, seed=len(name))
    want = fa.flash_attention_plain(q, k, v, causal, window, residuals=True)
    got = _short_fwd(q, k, v, causal, window)
    checks, errs = chip_smoke.flash_rule(got, want)
    assert all(checks.values()), errs


def test_fwd_design_counts_stay_zero_on_the_cpu():
    """On CPU tensors the forward runs its plain version and no design's
    launch count moves; the counts name the four designs and
    reset_counts zeroes them."""
    fa.reset_counts()
    assert fa.launches_by_design == dict.fromkeys(
        ("tiled", "short", "f32", "mid"), 0)
    q, k, v = to_torch(make(2, 6, 2, 16, 16, 64, seed=4), "bf16")
    fa.flash_attention_fwd(q, k, v, causal=True, window=8)
    fa.flash_attention(q, k, v)
    assert fa.launches == 0
    assert set(fa.launches_by_design.values()) == {0}


def test_short_design_takes_the_shapes_up_to_64():
    """chip_smoke.fwd_design names "short" exactly where the kernel's
    rule (csrc/flash_fwd.cu, Design) sends bf16: Sq and Sk <= 64; past
    that, up to 256, the "mid" design at d <= 64, else "tiled"."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert chip_smoke.fwd_design(bf16, 64, 16, 16) == "short"
    assert chip_smoke.fwd_design(bf16, 128, 64, 64) == "short"
    assert chip_smoke.fwd_design(bf16, 64, 16, 65) == "mid"
    assert chip_smoke.fwd_design(bf16, 128, 196, 196) == "tiled"
    assert chip_smoke.fwd_design(f32, 64, 16, 16) == "f32"


FAULTS = [
    # name, (b, h, hk, s, s, d), causal, window, fault, checks it must fail
    ("band_edge_one_column_off", (8, 6, 6, 16, 16, 64), True, 8,
     {"band_edge_off": 1}, {"o", "o_rel", "l", "m"}),
    ("gqa_wrong_kv_head", (8, 6, 2, 16, 16, 64), True, 8,
     {"wrong_kv_head": True}, {"o", "o_rel", "l", "m"}),
    ("l_over_masked_columns", (8, 6, 6, 16, 16, 64), True, 8,
     {"l_over_masked": True}, {"o", "o_rel", "l"}),
    ("rows_to_the_next_head", (8, 6, 6, 16, 16, 64), True, 8,
     {"rows_to_next": True}, {"o", "o_rel"}),
]


@pytest.mark.parametrize("name,shape,causal,window,fault,fails", FAULTS,
                         ids=[c[0] for c in FAULTS])
def test_smoke_rule_sees_short_design_faults(name, shape, causal, window,
                                             fault, fails):
    """chip_smoke.py's rule, on its inputs at the twin's temporal shape,
    fails each fault of the short design in the checks it can see: an l
    summed over masked columns leaves the row max right, and a head's
    rows written to the next head leave l and m right (the kernel writes
    them by index)."""
    q, k, v = _rule_inputs(*shape, seed=3)
    want = fa.flash_attention_plain(q, k, v, causal, window, residuals=True)
    got = _short_fwd(q, k, v, causal, window, **fault)
    checks, errs = chip_smoke.flash_rule(got, want)
    assert {c for c, ok in checks.items() if not ok} == fails, errs
