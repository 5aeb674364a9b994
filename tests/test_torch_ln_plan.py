"""The launch plan of ``ts::ln_cast_bwd`` (csrc/block_fusions.cu,
``LnCastBwd``) and the fixed order of its column sums, on the CPU.

``ops/block_fusions.py::ln_bwd_plan`` mirrors the kernel's row-to-block
assignment: block g of G takes the rows [g R / G, (g + 1) R / G) in tiles of
up to 8 consecutive rows, tile t into ring slot t mod stages. The tests
walk that plan for each row count of ``chip_smoke.LN_CASES`` (and 1, 7 and
6,272 rows) and check that every row lands in exactly one block, tile and
slot.

Then the column sums (dgamma = sum dh xhat, dbeta = sum dh, the bias's db =
sum C(dx)) are emulated in torch in the kernel's order: in each block,
thread t owns 8 columns and the tile rows t div (D/8) + k S (S = 256 div
(D/8) subsets), summing them tile by tile in f32; the subsets are added in
subset order into the block's partial row; ``ColumnSums`` adds the partial
rows as eight strided runs of blocks, then the runs in turn; db is rounded
to the compute dtype last. Held to the plain version (ATen's
``native_layer_norm_backward`` and torch's sum) under chip_smoke's rules:
FUSION_SUM_REL for dgamma and dbeta, FUSION_DB_REL for db (the order
differs; on the card nvcc may also fuse a product into its sum). The same
inputs summed twice give the same bytes; a plan that drops a tile, or a
subset of a tile's rows, breaks the rule.
"""
import pytest
import torch

import chip_smoke
from tensor_stream_torch.ops import block_fusions as bf

EPS = 1e-6
SMS = 132  # an H100 SXM's SMs: the grid the card's launch takes
ROW_COUNTS = sorted({1, 7, 6272} | {
    int(torch.tensor(c[1]).prod()) for c in chip_smoke.LN_CASES})


@pytest.mark.parametrize("rows", ROW_COUNTS)
def test_every_row_in_one_block_tile_and_slot(rows):
    blocks = bf.ln_bwd_blocks(rows, SMS)
    assert 1 <= blocks <= SMS * bf.LN_BWD_BLOCKS_PER_SM
    assert blocks == min(-(-rows // bf.LN_TILE),
                         SMS * bf.LN_BWD_BLOCKS_PER_SM)
    for stages in (2, 3, 4):
        plan = bf.ln_bwd_plan(rows, blocks, stages)
        assert len(plan) == blocks
        seen = []
        for tiles in plan:
            assert tiles, "every block of the grid has rows"
            for t, (slot, tile) in enumerate(tiles):
                assert slot == t % stages
                assert 1 <= len(tile) <= bf.LN_TILE
                assert tile.step == 1
                # only a block's last tile may be short
                assert len(tile) == bf.LN_TILE or t == len(tiles) - 1
                seen += list(tile)
        assert seen == list(range(rows)), "each row once, in block order"
        sizes = [sum(len(t) for _, t in tiles) for tiles in plan]
        assert max(sizes) - min(sizes) <= 1, "blocks balanced to a row"


@pytest.mark.parametrize("rows", ROW_COUNTS)
def test_the_forward_streams_rows_only_where_a_warp_has_more_than_one(rows):
    """ts::ln_cast's route: the ring where its grid's warps (3 blocks of 8
    an SM) would each take more than one row, the wave plan below; the
    training steps' 6,272 rows go to the ring, a serving tick's 3,136 to
    the wave."""
    warps = SMS * bf.LN_FWD_BLOCKS_PER_SM * 8
    assert bf.ln_fwd_plan(rows, SMS) == ("ring" if rows > warps else "wave")
    assert bf.ln_fwd_plan(6272, SMS) == "ring"
    assert bf.ln_fwd_plan(3136, SMS) == "wave"


def _inputs(case, seed=120):
    """A LN_CASES case's residual-overload backward inputs on the CPU:
    (dh, x', mean, rstd, weight, dres, compute dtype), and the plain
    version's outputs."""
    name, lead, d, xdt, cdt, y_layout = case
    x, y, yb, w, b = chip_smoke.ln_case_inputs(lead, d, xdt, cdt, y_layout,
                                               seed, "cpu")
    xp, h, mean, rstd = bf.ln_cast_plain(x, w, b, EPS, cdt, y, yb)
    src = x if xp is None else xp
    dh = chip_smoke._seeded(h.shape, seed + 5).to(cdt)
    dres = None if y is None else chip_smoke._seeded(h.shape,
                                                     seed + 6).to(xdt)
    want = bf.ln_cast_bwd_plain(dh, src, mean, rstd, w, dres,
                                None if y is None else cdt)
    return dh, src, mean, rstd, dres, cdt, want


def kernel_column_sums(dh, xp, mean, rstd, dx, cdt, blocks,
                       plan=None):
    """dgamma, dbeta (and db, with dx) in LnCastBwd's and ColumnSums'
    order (module docstring), f32; `plan` defaults to ln_bwd_plan."""
    d = xp.shape[-1]
    g = dh.reshape(-1, d).float()
    rows = g.shape[0]
    xn = ((xp.reshape(-1, d).float() - mean.reshape(-1, 1))
          * rstd.reshape(-1, 1))
    terms = [g * xn, g]
    if dx is not None:
        terms.append(dx.reshape(-1, d).to(cdt).float())
    # A zero row for the padding of the index table.
    table = torch.cat([torch.stack(terms),
                       torch.zeros(len(terms), 1, d)], dim=1)
    chunks, subsets = bf.ln_bwd_subsets(d)
    plan = bf.ln_bwd_plan(rows, blocks) if plan is None else plan
    seqs = [[[r for _, tile in tiles for r in list(tile)[s::subsets]]
             for s in range(subsets)] for tiles in plan]
    steps = max(len(q) for b in seqs for q in b)
    idx = torch.full((len(plan), subsets, steps), rows, dtype=torch.long)
    for gi, b in enumerate(seqs):
        for s, q in enumerate(b):
            idx[gi, s, :len(q)] = torch.tensor(q, dtype=torch.long)
    acc = torch.zeros(len(terms), len(plan), subsets, d)
    for i in range(steps):           # each thread's rows, in order
        acc = acc + table[:, idx[:, :, i]]
    partial = torch.zeros(len(terms), len(plan), d)
    for s in range(subsets):         # the subsets, in subset order
        partial = partial + acc[:, :, s]
    out = torch.zeros(len(terms), d)
    for w in range(8):               # ColumnSums: 8 strided runs
        run = torch.zeros(len(terms), d)
        for gi in range(w, len(plan), 8):
            run = run + partial[:, gi]
        out = out + run
    sums = list(out)
    if dx is not None:
        sums[2] = sums[2].to(cdt).float()
    return sums


@pytest.mark.parametrize("case", chip_smoke.LN_CASES,
                         ids=[c[0] for c in chip_smoke.LN_CASES])
def test_column_sums_in_the_kernel_order_hold_the_rules(case):
    dh, xp, mean, rstd, dres, cdt, want = _inputs(case)
    rows = mean.numel()
    dx = want[0] if dres is not None else None
    got = kernel_column_sums(dh, xp, mean, rstd, dx, cdt,
                             bf.ln_bwd_blocks(rows, SMS))
    for g, w in zip(got[:2], want[1:3]):
        assert chip_smoke.rel_norm(g, w) <= chip_smoke.FUSION_SUM_REL
    if dres is not None:
        assert chip_smoke.rel_norm(got[2], want[3]) <= \
            chip_smoke.FUSION_DB_REL[cdt]


@pytest.mark.parametrize("case", [c for c in chip_smoke.LN_CASES
                                  if c[0] in ("vit_b_ln_t", "d64_odd")],
                         ids=["vit_b_ln_t", "d64_odd"])
def test_the_same_inputs_sum_to_the_same_bytes(case):
    dh, xp, mean, rstd, dres, cdt, want = _inputs(case, seed=130)
    blocks = bf.ln_bwd_blocks(mean.numel(), SMS)
    first = kernel_column_sums(dh, xp, mean, rstd, want[0], cdt, blocks)
    again = kernel_column_sums(dh.clone(), xp.clone(), mean.clone(),
                               rstd.clone(), want[0].clone(), cdt, blocks)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_a_lost_tile_or_subset_breaks_the_rule():
    """The rules see a plan that skips a block's last tile, or the rows of
    one subset of every tile (a thread of the column phase idle)."""
    case = next(c for c in chip_smoke.LN_CASES if c[0] == "vit_b_ln_t")
    dh, xp, mean, rstd, dres, cdt, want = _inputs(case, seed=140)
    rows = mean.numel()
    blocks = bf.ln_bwd_blocks(rows, SMS)
    plan = bf.ln_bwd_plan(rows, blocks)
    lost_tile = [tiles[:-1] if g == 0 else tiles
                 for g, tiles in enumerate(plan)]
    subsets = bf.ln_bwd_subsets(xp.shape[-1])[1]
    lost_subset = [[(slot, [r for i, r in enumerate(t) if i % subsets])
                    for slot, t in tiles] for tiles in plan]
    for bad in (lost_tile, lost_subset):
        got = kernel_column_sums(dh, xp, mean, rstd, want[0], cdt, blocks,
                                 plan=bad)
        assert chip_smoke.rel_norm(got[1], want[2]) > \
            chip_smoke.FUSION_SUM_REL
