"""The flash forward at mid-length sequences (64 < max(Sq, Sk) <= 256,
d <= 64), on the CPU: the port's plain version against the JAX package's
kernels at the shapes the mid design (``csrc/flash_fwd.cu``,
``FlashFwdMid``) serves, and a torch emulation of that design's
arithmetic against chip_smoke.py's rule.

(a) The same inputs, made with numpy from a seed, go through
``flash_attention_plain`` (``flash_attention_fwd`` on CPU tensors) and the
JAX package's Pallas kernel in interpret mode (``_fwd_padded``, its
residuals, and ``flash_attention(impl="pallas")``), at
tests/test_torch_flash.py's tolerances.

(b) ``_mid_fwd`` does in torch what the kernel does: a 64-row tile (a
warpgroup's task) of one q head against its kv head (h // (H / Hk)), over
kv chunks of 64 columns from the one holding the first column KvRange
gives the tile to the one holding its last, that last chunk cut to 16
columns (the kernel's kMidTail) where no more of it is live (the uncut
chunk is held to the rule too), every column of a chunk computed and,
where TileNeedsMask says so, the ones Live drops masked with -0.7 *
f32max; m and l kept online in base 2 on the raw dot products (alpha =
exp2((m_old - m_new) scale log2(e)), l = l alpha + sum p, the accumulator
rescaled by alpha), P cast to bf16 before P V in f32, o = acc * (l == 0 ?
1 : 1/l) and m the row max times the scale. It must lie within
chip_smoke.flash_rule of the plain version, on the rule's own inputs (q,
k of std 2).

(c) The rule fails the emulation with a fault of the kind the design could
have: the accumulator not rescaled when the row max grows, l not
rescaled, a chunk's last 16 columns dropped, a q head of a GQA group
reading the next kv head.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from tensor_stream_tpu.ops import flash_attention as jfa
from tensor_stream_torch.ops import flash_attention as fa
from test_torch_flash import close, make, to_jax, to_torch
from test_torch_flash_short import live

LOG2E = 1.4426950408889634

MID_CASES = [
    # name, (b, h, hk, sq, sk, d), causal, window
    # The factorized ViT-B's spatial attention (196 tokens a frame), MHA
    # and GQA, narrowed.
    ("spatial_196", (1, 2, 2, 196, 196, 64), False, None),
    ("spatial_196_gqa", (1, 4, 2, 196, 196, 64), False, None),
    ("causal_200", (1, 2, 2, 200, 200, 64), True, None),
    ("band_150_w32", (1, 2, 2, 150, 150, 64), False, 32),
    ("cross_100_to_196", (1, 4, 2, 100, 196, 64), False, None),
    ("edge_65", (1, 2, 2, 65, 65, 32), True, None),
    ("edge_256", (1, 2, 2, 256, 256, 64), False, None),
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name,shape,causal,window", MID_CASES,
                         ids=[c[0] for c in MID_CASES])
def test_plain_matches_pallas_interpret_at_mid_s(name, shape, causal, window,
                                                 dtype):
    """o, l and m against the Pallas kernel's (interpret mode, 128-row
    tiles), and o against the public entry point."""
    arrays = make(*shape, seed=len(name) + 11)
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


ROWS = 64  # q rows a task (a warpgroup's wgmma tile)
CHUNK = 64  # kv columns a chunk
TAIL = 16  # csrc/flash_fwd.cu's kMidTail


def kv_range(q0, sk, causal, window):
    """csrc/flash_fwd.cu's KvRange for q rows [q0, q0 + ROWS)."""
    lo, hi = 0, sk
    if causal:
        hi = min(hi, q0 + ROWS)
    if window:
        lo = max(q0 - (window - 1), 0)
        if not causal:
            hi = min(hi, q0 + ROWS + window - 1)
    return lo, hi


def tile_needs_mask(q0, k0, bk, sk, causal, window):
    """csrc/flash_fwd.cu's TileNeedsMask for q rows [q0, q0 + ROWS) and kv
    columns [k0, k0 + bk)."""
    need = k0 + bk > sk
    if causal:
        need |= k0 + bk - 1 > q0
    if window:
        need |= k0 <= q0 + ROWS - 1 - window
        if not causal:
            need |= k0 + bk - 1 >= q0 + window
    return need


def _mid_fwd(q, k, v, causal=False, window=None, tail=TAIL,
             no_rescale=False, l_no_rescale=False, drop_last_pair=False,
             next_kv_head=False):
    """The mid design's numerics in torch, task by task and chunk by chunk
    (the last chunk `tail` columns wide where no more of it is live); the
    faults as the module's docstring lists them."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    scale = d ** -0.5
    c2 = scale * LOG2E
    kv = torch.arange(h) // group
    if next_kv_head:
        kv = (kv + torch.arange(h) % group) % hk
    skp = CHUNK * -(-sk // CHUNK)
    kf = torch.zeros((b, h, skp, d))
    kf[:, :, :sk] = k.float()[:, kv]
    vf = torch.zeros((b, h, skp, d))
    vf[:, :, :sk] = v.float()[:, kv]
    mask = torch.tensor(fa.MASK_VALUE)
    o = torch.empty(q.shape, dtype=q.dtype)
    l_out = torch.empty(q.shape[:3])
    m_out = torch.empty(q.shape[:3])
    for r0 in range(0, sq, ROWS):
        n = min(ROWS, sq - r0)
        rows = torch.arange(r0, r0 + ROWS)[:, None]
        qt = torch.zeros((b, h, ROWS, d))
        qt[:, :, :n] = q[:, :, r0:r0 + n].float()
        lo, hi = kv_range(r0, sk, causal, window)
        last = (hi - 1) // CHUNK * CHUNK
        acc = torch.zeros((b, h, ROWS, d))
        m_run = torch.full((b, h, ROWS), -np.inf)
        l_run = torch.zeros((b, h, ROWS))
        for c0 in range(lo // CHUNK * CHUNK, hi, CHUNK):
            bk = tail if c0 == last and hi - last <= tail else CHUNK
            cols = torch.arange(c0, c0 + bk)[None, :]
            s = qt @ kf[:, :, c0:c0 + bk].transpose(-1, -2)
            keep = torch.ones((ROWS, bk), dtype=torch.bool)
            if drop_last_pair:
                keep = keep & (cols < c0 + bk - 16)
            if tile_needs_mask(r0, c0, bk, sk, causal, window):
                keep = keep & live(rows, cols, sk, causal, window)
            s = torch.where(keep, s, mask)
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp2((m_run - m_new) * c2)
            m_run = m_new
            mc = torch.where(m_new > fa.MASK_VALUE, m_new * c2,
                             torch.zeros(()))
            p = torch.exp2(s * c2 - mc[..., None])
            l_run = (l_run if l_no_rescale else l_run * alpha) + p.sum(-1)
            if not no_rescale:
                acc = acc * alpha[..., None]
            acc = acc + p.to(v.dtype).float() @ vf[:, :, c0:c0 + bk]
        inv = torch.where(l_run == 0, torch.ones(()), 1 / l_run)
        o[:, :, r0:r0 + n] = (acc * inv[..., None]).to(q.dtype)[:, :, :n]
        l_out[:, :, r0:r0 + n] = l_run[:, :, :n]
        m_out[:, :, r0:r0 + n] = (m_run * scale)[:, :, :n]
    return o, l_out, m_out


def _rule_inputs(b, h, hk, sq, sk, d, seed):
    gen = torch.Generator().manual_seed(seed)
    stds = (chip_smoke.FLASH_QK_STD, chip_smoke.FLASH_QK_STD,
            chip_smoke.FLASH_V_STD)
    return [(torch.randn((b, heads, s, d), generator=gen) * std)
            .to(torch.bfloat16)
            for heads, s, std in zip((h, hk, hk), (sq, sk, sk), stds)]


EMULATED_CASES = MID_CASES + [
    ("symmetric_band_100_d32", (1, 2, 2, 100, 100, 32), False, 20),
    ("causal_band_256_gqa", (1, 6, 2, 256, 256, 64), True, 70),
    ("cross_16_to_100", (2, 4, 4, 16, 100, 32), False, None),
]


@pytest.mark.parametrize("tail", [TAIL, CHUNK])
@pytest.mark.parametrize("name,shape,causal,window", EMULATED_CASES,
                         ids=[c[0] for c in EMULATED_CASES])
def test_mid_design_is_within_the_smoke_rule(name, shape, causal, window,
                                             tail):
    q, k, v = _rule_inputs(*shape, seed=len(name))
    want = fa.flash_attention_plain(q, k, v, causal, window, residuals=True)
    got = _mid_fwd(q, k, v, causal, window, tail)
    checks, errs = chip_smoke.flash_rule(got, want)
    assert all(checks.values()), errs


FAULTS = [
    # name, (b, h, hk, s, s, d), causal, window, fault, checks it must fail
    ("accumulator_not_rescaled", (2, 4, 4, 196, 196, 64), False, None,
     {"no_rescale": True}, {"o", "o_rel"}),
    ("l_not_rescaled", (2, 4, 4, 196, 196, 64), False, None,
     {"l_no_rescale": True}, {"o", "o_rel", "l"}),
    ("chunk_pair_dropped", (2, 4, 4, 196, 196, 64), True, None,
     {"drop_last_pair": True}, {"o", "o_rel", "l", "m"}),
    ("gqa_next_kv_head", (2, 6, 2, 196, 196, 64), False, None,
     {"next_kv_head": True}, {"o", "o_rel", "l", "m"}),
]


@pytest.mark.parametrize("name,shape,causal,window,fault,fails", FAULTS,
                         ids=[c[0] for c in FAULTS])
def test_smoke_rule_sees_mid_design_faults(name, shape, causal, window,
                                           fault, fails):
    """chip_smoke.flash_rule, on its inputs at the spatial shape, fails
    each fault of the mid design in the checks it can see."""
    q, k, v = _rule_inputs(*shape, seed=3)
    want = fa.flash_attention_plain(q, k, v, causal, window, residuals=True)
    got = _mid_fwd(q, k, v, causal, window, **fault)
    checks, errs = chip_smoke.flash_rule(got, want)
    assert fails <= {c for c, ok in checks.items() if not ok}, errs


def test_mid_design_takes_the_shapes_from_65_to_256():
    """chip_smoke.fwd_design names "mid" exactly where the kernel's rule
    (csrc/flash_fwd.cu, Design) sends bf16: 64 < max(Sq, Sk) <= 256 at
    d <= 64; d = 128 there stays "tiled"."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert chip_smoke.fwd_design(bf16, 32, 65, 65) == "mid"
    assert chip_smoke.fwd_design(bf16, 64, 16, 100) == "mid"
    assert chip_smoke.fwd_design(bf16, 64, 196, 196) == "mid"
    assert chip_smoke.fwd_design(bf16, 64, 256, 256) == "mid"
    assert chip_smoke.fwd_design(bf16, 128, 196, 196) == "tiled"
    assert chip_smoke.fwd_design(bf16, 128, 256, 256) == "tiled"
    assert chip_smoke.fwd_design(bf16, 64, 64, 64) == "short"
    assert chip_smoke.fwd_design(bf16, 64, 256, 257) == "tiled"
    assert chip_smoke.fwd_design(bf16, 64, 1568, 1568) == "tiled"
    assert chip_smoke.fwd_design(f32, 64, 196, 196) == "f32"


def test_mid_counts_stay_zero_on_the_cpu():
    """On CPU tensors the forward at mid S runs its plain version and no
    design's launch count moves."""
    fa.reset_counts()
    q, k, v = to_torch(make(1, 6, 2, 196, 196, 64, seed=4), "bf16")
    fa.flash_attention_fwd(q, k, v, causal=True)
    fa.flash_attention(q, k, v)
    assert fa.launches == 0
    assert set(fa.launches_by_design.values()) == {0}
