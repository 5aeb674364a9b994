"""The packed short flash forward (``csrc/flash_fwd.cu``, ``FlashFwdPacked``:
MHA self-attention at S <= 8, 16 // S heads a 16-row tile), on the CPU.

(a) The port's plain forward against the JAX package's Pallas kernel in
interpret mode at S = 4, d = 64, MHA (the factorized ViT-B's temporal
attention at a narrow batch), at tests/test_torch_flash.py's tolerances.

(b) ``_packed_fwd`` does in torch what the kernel does: tile t holds the
heads [t pack, (t + 1) pack) of the flat order b * H + h, head i at rows
[i S, (i + 1) S), zeros in the spare rows; the raw dot products over the
tile, masked to each head's diagonal block and Live with -0.7 * f32max;
the row max and exp2 in f32; l summed as the kernel sums it (each lane its
four columns 2c, 2c + 1, 8 + 2c, 9 + 2c in that order, then lanes c ^ 1,
then c ^ 2); P cast to bf16 before P V in f32; o = acc * (l == 0 ? 1 :
1/l), m the row max times the scale; no spare row written. It must lie
within chip_smoke.flash_rule of the plain version on the rule's inputs.

(c) The rule fails the emulation with each fault a packed kernel could
have: a head that sees its neighbours' keys, l summed over the other
heads' columns, a spare row written over the next tile's first head, a
band edge one column off.

(d) The plan's mirror (``fa.short_fwd_plan``, ``packed_tile_rows``,
``packed_warp_tiles``) covers every (batch, head, row) once, routes only
MHA self-attention at S <= 8 to the packed kernel, and holds the
constants that ``csrc/flash_fwd.cu`` compiles.
"""
import itertools
import os

import numpy as np
import pytest
import torch

import chip_smoke
from tensor_stream_tpu.ops import flash_attention as jfa
from tensor_stream_torch.ops import flash_attention as fa
from test_torch_flash import close, make, to_jax, to_torch

LOG2E = 1.4426950408889634
MASK = torch.tensor(fa.MASK_VALUE, dtype=torch.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_matches_pallas_interpret_at_s4(causal, dtype):
    """o, l and m of the plain forward against the Pallas kernel's
    (``_fwd_padded``, interpret mode, one 128-row tile), and o against the
    public entry point, at [2, 4, 4, 64]."""
    arrays = make(2, 4, 4, 4, 4, 64, seed=11 + causal)
    jq, jk, jv = to_jax(arrays, dtype)
    jo, jl, jm = jfa._fwd_padded(jq, jk, jv, causal, None, 64 ** -0.5, 128,
                                 128, True)
    o, l, m = fa.flash_attention_fwd(*to_torch(arrays, dtype), causal=causal)
    close(o, jo, dtype)
    close(m, np.asarray(jm)[:, :, :4], "f32", "m")
    # The Pallas kernel sums bf16-rounded p for bf16 inputs; the port
    # keeps the f32 sum of p.
    close(l, np.asarray(jl)[:, :, :4], dtype, "l")
    close(o, jfa.flash_attention(jq, jk, jv, causal=causal, impl="pallas"),
          dtype)


def live(rows, cols, causal, window, edge=0):
    """csrc/flash_fwd.cu's Live within a head (cols < Sk always holds
    there); `edge` widens the band by that many columns (a fault)."""
    ok = torch.ones(torch.broadcast_shapes(rows.shape, cols.shape),
                    dtype=torch.bool)
    if causal:
        ok = ok & (cols <= rows)
    if window:
        if causal:
            ok = ok & (cols > rows - window - edge)
        else:
            ok = ok & ((cols - rows).abs() < window + edge)
    return ok


def packed_mask(s, pack, causal, window, neighbour_keys=False, edge=0):
    """[16, 16] LivePacked of a tile: row rq and column rk of one head of
    the tile's `pack`, and Live there; with `neighbour_keys` a row sees
    the other heads' keys too (a fault)."""
    r = torch.arange(16)
    hq, hk = (r // s)[:, None], (r // s)[None, :]
    same = (hq == hk) | neighbour_keys
    return (same & (hq < pack) & (hk < pack)
            & live(r[:, None] - hq * s, r[None, :] - hk * s, causal, window,
                   edge))


def kernel_row_sum(p):
    """The kernel's l over a [.., 16] row: lane c's columns 2c, 2c + 1,
    8 + 2c, 9 + 2c summed from 0 in that order, then the quad's partial
    sums over xor 1 and xor 2."""
    lanes = []
    for c in range(4):
        acc = torch.zeros(p.shape[:-1])
        for col in (2 * c, 2 * c + 1, 8 + 2 * c, 9 + 2 * c):
            acc = acc + p[..., col]
        lanes.append(acc)
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def _packed_fwd(q, k, v, causal=False, window=None, neighbour_keys=False,
                l_over_other_heads=False, spare_row_written=False,
                band_edge_off=0):
    """FlashFwdPacked's numerics in torch, all tiles at once; the faults
    as the module's docstring lists them."""
    b, h, s, d = q.shape
    heads, pack = b * h, 16 // s
    tiles = -(-heads // pack)
    scale = d ** -0.5
    c2 = scale * LOG2E

    def tiled(x):
        flat = torch.zeros((tiles * pack, s, d), dtype=torch.float32)
        flat[:heads] = x.reshape(heads, s, d).float()
        out = torch.zeros((tiles, 16, d))
        out[:, :pack * s] = flat.reshape(tiles, pack * s, d)
        return out
    qt, kt, vt = tiled(q), tiled(k), tiled(v)
    sc = qt @ kt.transpose(-1, -2)  # raw dot products
    mask = packed_mask(s, pack, causal, window, neighbour_keys,
                       band_edge_off)
    masked = torch.where(mask, sc, MASK)
    mx = masked.amax(-1)
    mc = torch.where(mx > MASK, mx * c2, torch.zeros(()))
    p = torch.exp2(masked * c2 - mc[..., None])
    if l_over_other_heads:
        heads_of_tile = packed_mask(s, pack, False, None, True)
        l = kernel_row_sum(torch.where(
            heads_of_tile, torch.exp2(sc * c2 - mc[..., None]),
            torch.zeros(())))
    else:
        l = kernel_row_sum(p)
    acc = p.to(torch.bfloat16).float() @ vt
    inv = torch.where(l == 0, torch.ones(()), 1 / l)
    o_t = (acc * inv[..., None]).to(q.dtype)
    m_t = mx * scale
    rows = pack * s
    o = o_t[:, :rows].reshape(tiles * pack, s, d)[:heads].clone()
    l_out = l[:, :rows].reshape(tiles * pack, s)[:heads].clone()
    m_out = m_t[:, :rows].reshape(tiles * pack, s)[:heads].clone()
    if spare_row_written:
        # Tile t's first spare row lands on head (t + 1) pack, row 0.
        for t in range(tiles):
            head = (t + 1) * pack
            if head < heads:
                o[head, 0], l_out[head, 0] = o_t[t, rows], l[t, rows]
                m_out[head, 0] = m_t[t, rows]
    return (o.reshape(q.shape), l_out.reshape(q.shape[:3]),
            m_out.reshape(q.shape[:3]))


def _rule_inputs(b, h, s, d, seed):
    """chip_smoke's flash inputs (q, k of std 2, v of std 1), bf16, MHA."""
    gen = torch.Generator().manual_seed(seed)
    stds = (chip_smoke.FLASH_QK_STD, chip_smoke.FLASH_QK_STD,
            chip_smoke.FLASH_V_STD)
    return [(torch.randn((b, h, s, d), generator=gen) * std).to(torch.bfloat16)
            for std in stds]


MODES = {"full": (False, None), "causal": (True, None),
         "band": (True, "half"), "symmetric_band": (False, "half")}
EMULATED = ([(s, mode, 64) for s, mode in itertools.product(
    (1, 2, 3, 4, 5, 7, 8), ("full", "causal", "band"))]
    + [(s, mode, 32) for s, mode in itertools.product(
        (3, 4, 8), ("full", "causal", "symmetric_band"))])


@pytest.mark.parametrize("s,mode,d", EMULATED,
                         ids=[f"s{s}_{m}_d{d}" for s, m, d in EMULATED])
def test_packed_design_is_within_the_smoke_rule(s, mode, d):
    """The emulation at 7 batches of 5 heads (35 heads: the last tile
    part-filled at every S but 3), band W = ceil(S / 2)."""
    causal, window = MODES[mode]
    window = -(-s // 2) if window else None
    q, k, v = _rule_inputs(7, 5, s, d, seed=s + d)
    want = fa.flash_attention_plain(q, k, v, causal, window, residuals=True)
    got = _packed_fwd(q, k, v, causal, window)
    checks, errs = chip_smoke.flash_rule(got, want)
    assert all(checks.values()), errs


FAULTS = [
    # name, S, causal, window, fault, checks it must fail
    ("neighbour_keys", 4, False, None, {"neighbour_keys": True},
     {"o", "o_rel", "l", "m"}),
    ("l_over_other_heads", 4, False, None, {"l_over_other_heads": True},
     {"o", "o_rel", "l"}),
    ("spare_row_over_next_head", 3, True, None, {"spare_row_written": True},
     {"o", "o_rel", "l", "m"}),
    ("band_edge_one_column_off", 8, True, 3, {"band_edge_off": 1},
     {"o", "o_rel", "l", "m"}),
]


@pytest.mark.parametrize("name,s,causal,window,fault,fails", FAULTS,
                         ids=[f[0] for f in FAULTS])
def test_smoke_rule_sees_packed_design_faults(name, s, causal, window, fault,
                                              fails):
    """chip_smoke.py's rule, on its inputs at 64 sequences of ViT-B's 12
    heads, fails each fault in the checks it can see: l summed over the
    other heads' columns leaves the row max right."""
    q, k, v = _rule_inputs(64, 12, s, 64, seed=5)
    want = fa.flash_attention_plain(q, k, v, causal, window, residuals=True)
    got = _packed_fwd(q, k, v, causal, window, **fault)
    checks, errs = chip_smoke.flash_rule(got, want)
    assert {c for c, ok in checks.items() if not ok} == fails, errs


COVER = [(1568, 12, 4, 132)] + [(7, 5, s, 132) for s in range(1, 9)] + [
    (3, 1, 1, 1)]


@pytest.mark.parametrize("b,h,s,sms", COVER,
                         ids=[f"b{b}_h{h}_s{s}_sms{n}" for b, h, s, n in COVER])
def test_packed_plan_covers_every_row_once(b, h, s, sms):
    """Every (flat head, row) of the packed plan lies in exactly one tile,
    at a tile row below 16 and distinct in it, where l's and m's index
    t pack s + row is head * S + row of the head; and every tile is taken
    by exactly one warp of one block: the factorized ViT-B's [1568, 12, 4,
    64] on 132 SMs, S = 1 to 8 at 35 heads, and 3 heads of S = 1 on one
    SM (a 16-head tile, part-filled, on a one-block grid)."""
    plan = fa.short_fwd_plan(b, h, h, s, s, 64, sms)
    assert plan["kernel"] == "FlashFwdPacked"
    pack = plan["pack"]
    assert pack == 16 // s and plan["heads"] == fa.PACK_WARPS * pack
    heads = b * h
    seen = np.zeros((heads, s), dtype=np.int64)
    for t in range(plan["tiles"]):
        rows = fa.packed_tile_rows(t, pack, s, heads)
        tile_rows = [r for r, _, _ in rows]
        assert len(set(tile_rows)) == len(tile_rows)
        assert all(0 <= r < pack * s <= 16 for r in tile_rows)
        for r, head, lr in rows:
            assert t * pack * s + r == head * s + lr
            seen[head, lr] += 1
    assert (seen == 1).all()
    taken = np.zeros(plan["tiles"], dtype=np.int64)
    for block in range(plan["blocks"]):
        for warp in range(plan["warps"]):
            for t in fa.packed_warp_tiles(plan, block, warp):
                taken[t] += 1
    assert (taken == 1).all()
    assert plan["blocks"] <= sms * fa.PACK_BLOCKS_PER_SM
    assert fa.short_fwd_plan(b, h, h, s, s, 128, sms)["blocks"] <= sms * 2


def test_factorized_shape_plan():
    """The factorized ViT-B's temporal forward: 4 heads a tile, 4,704
    tiles over a persistent grid of 396 blocks of 4 warps on 132 SMs
    (2.97 tiles a warp), 55,296 bytes of ring a block at d = 64; at d =
    128 two blocks an SM of 104,448 bytes."""
    plan = fa.short_fwd_plan(1568, 12, 12, 4, 4, 64, 132)
    assert plan == {"kernel": "FlashFwdPacked", "pack": 4, "heads": 16,
                    "tiles": 4704, "blocks": 396, "smem": 55296,
                    "stages": 2, "warps": 4}
    wide = fa.short_fwd_plan(784, 12, 12, 8, 8, 128, 132)
    assert (wide["blocks"], wide["smem"]) == (264, 104448)


ROUTES = [
    # (b, h, hk, sq, sk, d), kernel
    ((1568, 12, 12, 4, 4, 64), "FlashFwdPacked"),
    ((784, 12, 12, 8, 8, 128), "FlashFwdPacked"),
    ((64, 12, 12, 1, 1, 32), "FlashFwdPacked"),
    ((392, 6, 2, 4, 4, 64), "FlashFwdShort"),     # GQA
    ((64, 4, 4, 4, 8, 64), "FlashFwdShort"),      # cross-attention
    ((392, 6, 6, 9, 9, 64), "FlashFwdShort"),     # S > 8
    ((392, 6, 6, 16, 16, 64), "FlashFwdShort"),   # the twin's band
]


@pytest.mark.parametrize("shape,kernel", ROUTES,
                         ids=[f"{r[1]}_{'_'.join(map(str, r[0]))}"
                              for r in ROUTES])
def test_packed_route(shape, kernel):
    """Only MHA self-attention at S <= PACK_MAX packs; GQA, cross-attention
    and S > 8 stay on FlashFwdShort; both are the "short" design, whose
    launch counts do not tell them apart."""
    b, h, hk, sq, sk, d = shape
    assert fa.short_fwd_plan(*shape, 132)["kernel"] == kernel
    assert chip_smoke.fwd_design(torch.bfloat16, d, sq, sk) == "short"


def test_packed_plan_matches_the_kernel_source():
    """The mirror's constants and rules are the ones csrc/flash_fwd.cu
    compiles (PlanShort, SmemPacked, SmemShort, Packed)."""
    src = open(os.path.join(os.path.dirname(fa.__file__), "..", "csrc",
                            "flash_fwd.cu")).read()
    for line in (f"constexpr int kPackMax = {fa.PACK_MAX};",
                 f"constexpr int kPackWarps = {fa.PACK_WARPS};",
                 f"constexpr int kPackStages = {fa.PACK_STAGES};",
                 f"constexpr int kPackBlocksPerSm = {fa.PACK_BLOCKS_PER_SM};",
                 "  return D <= 64 ? kPackBlocksPerSm : 2;",
                 f"constexpr int kShortWarps = {fa.SHORT_WARPS};",
                 f"constexpr int kShortPad = {fa.SHORT_PAD};",
                 "  return p.H == p.Hk && p.Sq == p.Sk && p.Sq <= kPackMax;",
                 "    x.pack = 16 / p.Sq;",
                 "    x.heads = kPackWarps * x.pack;",
                 "  return kPackWarps * kPackStages * 3 * 16 * (D + kShortPad)"
                 " * 2;",
                 "  return (2 * heads * ((sk + 15) / 16 * 16) + kShortWarps * "
                 "16) *"):
        assert line in src, line
