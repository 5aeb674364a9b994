"""The flash backward at mid-length sequences (64 < max(Sq, Sk) <= 256,
d = 64), on the CPU: the port's plain backward against the JAX package's
at the shapes the mid backward design (``csrc/flash_bwd.cu``,
``FlashBwdMid``) serves, and a torch emulation of that design's
arithmetic against chip_smoke.py's rule.

(a) The same inputs, made with numpy from a seed, go through ``jax.vjp``
of the JAX ``flash_attention(impl="pallas")`` (the Pallas forward in
interpret mode and ``_flash_bwd``) and through the port's
``flash_attention_fwd`` and ``flash_attention_bwd``, which run their plain
versions on CPU tensors, at tests/test_torch_flash_bwd.py's tolerances.

(b) ``_mid_bwd`` does in torch what the kernel does: delta =
rowsum(dO * o) and the bias b = m log2(e) + log2(l) (l == 0: m log2(e))
of each row (past Sq b = +inf, delta 0); for each q head of a kv head's
group in order and each of its 64-row q tiles in order, and each 64-row
kv slice that KvRange leaves live for the tile, S^T = K Q^T and dP^T =
V dO^T, P^T = exp2(S^T scale log2(e) - b) where the pair is live (kv rows
past Sk dropped too) and 0 elsewhere, dS^T = P^T (dP^T scale - delta
scale); P^T and dS^T rounded to bf16, dV += P^T dO and dK += dS^T Q
summed in that order; then the tile's dQ = sum over its live slices, in
kv order, of dS K. It must lie within chip_smoke.bwd_rule of the plain
version, on the rule's own inputs (q, k of std 2).

(c) The rule fails the emulation with a fault of the kind the design
could have: a kv slice dropped from dQ's sum, dS left in f32 before dK
and dQ, a q head of a GQA group reading the next kv head.
"""
import os

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from tensor_stream_tpu.ops import flash_attention as jfa
from tensor_stream_torch.ops import flash_attention as fa
from test_torch_flash_bwd import DTYPES, close, make
from test_torch_flash_bwd_short import live

LOG2E = 1.4426950408889634
TILE = 64  # rows of a q tile and of a kv slice (csrc/flash_bwd.cu kStep)

MID_BWD_CASES = [
    # name, (b, h, hk, sq, sk, d), causal, window
    # The factorized ViT-B's spatial attention (196 tokens a frame), MHA
    # and GQA, narrowed.
    ("spatial_196", (1, 2, 2, 196, 196, 64), False, None),
    ("spatial_196_gqa", (1, 4, 2, 196, 196, 64), False, None),
    ("causal_200", (1, 2, 2, 200, 200, 64), True, None),
    ("band_150_w32", (1, 2, 2, 150, 150, 64), False, 32),
    ("cross_100_to_196", (1, 4, 2, 100, 196, 64), False, None),
    ("edge_65", (1, 2, 2, 65, 65, 64), True, None),
    ("edge_256", (1, 2, 2, 256, 256, 64), False, None),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape,causal,window", MID_BWD_CASES,
                         ids=[c[0] for c in MID_BWD_CASES])
def test_plain_bwd_matches_jax_vjp_at_mid_s(name, shape, causal, window,
                                            dtype):
    arrays = make(*shape, seed=len(name) + 5)
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


def kv_range(q0, sk, causal, window):
    """csrc/flash_bwd.cu's KvRange for q rows [q0, q0 + TILE)."""
    lo, hi = 0, sk
    if causal:
        hi = min(hi, q0 + TILE)
    if window:
        lo = max(q0 - (window - 1), 0)
        if not causal:
            hi = min(hi, q0 + TILE + window - 1)
    return lo, hi


def _pad(t, rows, value=0.0):
    out = torch.full(t.shape[:2] + (rows,) + t.shape[3:], value,
                     dtype=t.dtype)
    out[:, :, :t.shape[2]] = t
    return out


def _mid_bwd(q, k, v, o, l, m, do, causal=False, window=None, fault=None):
    """The mid design's numerics in torch; the faults as the module's
    docstring lists them: "slice_dropped", "ds_f32", "next_kv_head"."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group, dt = h // hk, q.dtype
    scale = d ** -0.5
    c2 = scale * LOG2E
    tiles, slices = -(-sq // TILE), -(-sk // TILE)
    qf, dof = _pad(q, tiles * TILE).float(), _pad(do, tiles * TILE).float()
    kf, vf = _pad(k, slices * TILE).float(), _pad(v, slices * TILE).float()
    delta = (do.float() * o.float()).sum(-1)[..., None]
    delta = _pad(delta, tiles * TILE)[..., 0]
    bias = m * LOG2E + torch.log2(torch.where(l == 0, torch.ones(()), l))
    bias = _pad(bias[..., None], tiles * TILE, float("inf"))[..., 0]
    dq = torch.zeros((b, h, tiles * TILE, d))
    dk = torch.zeros((b, hk, slices * TILE, d))
    dv = torch.zeros((b, hk, slices * TILE, d))
    for hh in range(h):
        j = hh // group
        if fault == "next_kv_head" and hh % group:
            j = (j + 1) % hk
        for t in range(tiles):
            q0 = t * TILE
            lo, hi = kv_range(q0, sk, causal, window)
            qs = slice(q0, q0 + TILE)
            rows = torch.arange(q0, q0 + TILE)[None, :]  # q, as columns
            ds_tiles = []
            for s in range(slices):
                k0 = s * TILE
                if not (k0 < hi and k0 + TILE > lo):
                    continue
                ks = slice(k0, k0 + TILE)
                kv_rows = torch.arange(k0, k0 + TILE)[:, None]
                sT = kf[:, j, ks] @ qf[:, hh, qs].transpose(-1, -2)
                dpT = vf[:, j, ks] @ dof[:, hh, qs].transpose(-1, -2)
                keep = live(rows, kv_rows, sq, sk, causal, window)
                pT = torch.where(keep, torch.exp2(sT * c2 - bias[:, hh, None,
                                                                  qs]),
                                 torch.zeros(()))
                dsT = pT * (dpT * scale - delta[:, hh, None, qs] * scale)
                pT = pT.to(dt).float()
                if fault != "ds_f32":
                    dsT = dsT.to(dt).float()
                dv[:, j, ks] += pT @ dof[:, hh, qs]
                dk[:, j, ks] += dsT @ qf[:, hh, qs]
                ds_tiles.append((ks, dsT))
            if fault == "slice_dropped":
                ds_tiles = ds_tiles[:-1]
            for ks, dsT in ds_tiles:
                dq[:, hh, qs] += dsT.transpose(-1, -2) @ kf[:, j, ks]
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


EMULATED_CASES = MID_BWD_CASES + [
    ("causal_band_256_gqa", (1, 6, 2, 256, 256, 64), True, 70),
    ("cross_16_to_100", (2, 4, 4, 16, 100, 64), False, None),
]


@pytest.mark.parametrize("name,shape,causal,window", EMULATED_CASES,
                         ids=[c[0] for c in EMULATED_CASES])
def test_mid_bwd_design_is_within_the_smoke_rule(name, shape, causal,
                                                 window):
    args = _rule_inputs(*shape, seed=len(name), causal=causal, window=window)
    want = fa.flash_attention_bwd_plain(*args, causal, window)
    got = _mid_bwd(*args, causal, window)
    checks, errs = chip_smoke.bwd_rule(got, want)
    assert all(checks.values()), errs


FAULTS = [
    # name, (b, h, hk, s, s, d), causal, window, fault, checks it must fail
    ("kv_slice_dropped_from_dq", (2, 4, 4, 196, 196, 64), False, None,
     "slice_dropped", {"dq", "dq_rel"}),
    ("ds_left_in_f32", (2, 4, 4, 196, 196, 64), False, None, "ds_f32",
     {"dk_cast"}),
    ("gqa_next_kv_head", (2, 6, 2, 196, 196, 64), False, None,
     "next_kv_head", {"dq_rel", "dk", "dk_rel", "dv", "dv_rel", "dk_cast"}),
]


@pytest.mark.parametrize("name,shape,causal,window,fault,fails", FAULTS,
                         ids=[c[0] for c in FAULTS])
def test_smoke_bwd_rule_sees_mid_design_faults(name, shape, causal, window,
                                               fault, fails):
    """chip_smoke.bwd_rule, on its inputs at the spatial shape, fails each
    fault of the mid design in (at least) the checks listed."""
    args = _rule_inputs(*shape, seed=7, causal=causal, window=window)
    want = fa.flash_attention_bwd_plain(*args, causal, window)
    got = _mid_bwd(*args, causal, window, fault)
    checks, errs = chip_smoke.bwd_rule(got, want)
    assert fails <= {c for c, ok in checks.items() if not ok}, errs


def test_mid_bwd_design_takes_d64_from_65_to_256():
    """chip_smoke.bwd_design names "mid" exactly where the kernel's rule
    (csrc/flash_bwd.cu, Design) sends bf16: 64 < max(Sq, Sk) <= 256 at
    d = 64, without GQA at any batch and under GQA from
    MID_MIN_KV_HEADS (batch, kv head) pairs, "wgmma" under that; d = 32
    and 128 there stay "mma_sync", longer sequences "wgmma"."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert chip_smoke.MID_MIN_KV_HEADS == 72
    assert chip_smoke.bwd_design(bf16, 64, 2, 4, 4, 65, 65) == "mid"
    assert chip_smoke.bwd_design(bf16, 64, 2, 4, 4, 16, 100) == "mid"
    assert chip_smoke.bwd_design(bf16, 64, 32, 12, 12, 196, 196) == "mid"
    assert chip_smoke.bwd_design(bf16, 64, 1, 12, 12, 196, 196) == "mid"
    assert chip_smoke.bwd_design(bf16, 64, 1, 1, 1, 256, 256) == "mid"
    assert chip_smoke.bwd_design(bf16, 64, 2, 4, 4, 64, 64) == "short"
    assert chip_smoke.bwd_design(bf16, 64, 2, 4, 4, 256, 257) == "wgmma"
    assert chip_smoke.bwd_design(bf16, 32, 2, 4, 4, 196, 196) == "mma_sync"
    assert chip_smoke.bwd_design(bf16, 128, 2, 4, 4, 196, 196) == "mma_sync"
    assert chip_smoke.bwd_design(f32, 64, 2, 4, 4, 196, 196) == "f32"
    # GQA: a block runs its group's q heads in turn, so a grid of fewer
    # than 72 blocks stays on "wgmma".
    assert chip_smoke.bwd_design(bf16, 64, 32, 6, 2, 196, 196) == "wgmma"
    assert chip_smoke.bwd_design(bf16, 64, 16, 12, 4, 196, 196) == "wgmma"
    assert chip_smoke.bwd_design(bf16, 64, 18, 12, 4, 196, 196) == "mid"
    assert chip_smoke.bwd_design(bf16, 64, 32, 12, 4, 100, 196) == "mid"
    assert chip_smoke.bwd_design(bf16, 64, 36, 6, 2, 196, 196) == "mid"
    assert "mid" in fa.BWD_DESIGNS
    assert chip_smoke.factorized_launches(1, True)["flash_bwd_by_design"] == {
        d: 12 if d in ("short", "mid") else 0 for d in fa.BWD_DESIGNS}


def test_mid_bwd_counts_stay_zero_on_the_cpu():
    """On CPU tensors the backward at mid S runs its plain version,
    directly and through autograd, and no design's count moves."""
    fa.reset_counts()
    args = _rule_inputs(1, 6, 2, 196, 196, 64, seed=9)
    fa.flash_attention_bwd(*args)
    q, k, v = (t.clone().requires_grad_(True) for t in args[:3])
    fa.flash_attention(q, k, v).backward(args[-1])
    assert q.grad is not None and k.grad is not None
    assert fa.bwd_launches == 0 and fa.launches == 0
    assert set(fa.bwd_launches_by_design.values()) == {0}


def test_mid_bwd_rule_matches_the_kernel_source():
    """chip_smoke's copy of the backward's routing bounds is the one
    csrc/flash_bwd.cu compiles (its Design reads kMidMax and
    kMidMinKvHeads)."""
    src = open(os.path.join(os.path.dirname(fa.__file__), "..", "csrc",
                            "flash_bwd.cu")).read()
    assert (f"constexpr long long kMidMinKvHeads = "
            f"{chip_smoke.MID_MIN_KV_HEADS};") in src
    assert f"constexpr int kMidMax = {chip_smoke.MID_MAX};" in src
    assert ("(H == Hk || static_cast<long long>(B) * Hk >= "
            "kMidMinKvHeads)") in src
