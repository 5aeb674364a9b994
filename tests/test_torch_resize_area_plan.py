"""The AREA-down kernel's plan (ops/resize.py area_plan) on the CPU.

csrc/resize_nv12.cu's resize_area_down_nv12 cuts a launch into blocks of
one plane of one frame, a band of output rows and a tile of output
columns, and stages the source bytes that the block's taps read in shared
memory. Its bytes can only equal the plain version's if every tap lies in
what the block staged. These tests hold the plan's band and tile
arithmetic to that, and walk it in torch as the kernel does (each block's
staged image built from the planes, the taps read at their offsets into
it, the plain blend), byte for byte against _area_down_plain, at the CRC,
fuzz, headline and large-tap geometries, an unaligned crop, a width that
is not a multiple of the tile and a batch of crops.
"""
import numpy as np
import pytest
import torch

from tensor_stream_torch.enums import ResizeType
from tensor_stream_torch.ops import resize
from tensor_stream_torch.ops.crop import crop_nv12

# (name, frames, source (w, h), crop or None, target (w, h), batch the plan
# is made for)
GEOMETRIES = [
    ("crc_480x360", 1, (1080, 608), None, (480, 360), 1),
    ("crc_540x304", 1, (1080, 608), None, (540, 304), 1),
    ("crc_crop_320x240", 1, (1080, 608), (120, 60, 960, 540), (320, 240), 1),
    ("fuzz_52x36", 2, (64, 48), None, (52, 36), 2),
    ("fuzz_64x18", 2, (100, 76), None, (64, 18), 2),
    ("headline", 1, (1920, 1080), None, (224, 224), 128),
    ("large_taps", 1, (1920, 1080), None, (64, 36), 1),
    ("unaligned_crop", 1, (1080, 608), (6, 2, 966, 542), (200, 120), 1),
    ("ragged_tile", 1, (1080, 608), None, (300, 170), 1),
    ("batch_of_crops", 3, (1080, 608), (100, 50, 1000, 590), (224, 224), 3),
]
IDS = [g[0] for g in GEOMETRIES]


def planes_of(frames, src, crop, seed):
    """Seeded [N, H, W] / [N, H/2, W] planes, and their crop's view."""
    w, h = src
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(rng.integers(0, 256, (frames, h, w), np.uint8))
    uv = torch.from_numpy(rng.integers(0, 256, (frames, h // 2, w),
                                       np.uint8))
    if crop is not None:
        y, uv = crop_nv12(y, uv, *crop)
    return y, uv


def setup(name):
    _, frames, src, crop, (dw, dh), n = GEOMETRIES[IDS.index(name)]
    y, uv = planes_of(frames, src, crop, IDS.index(name))
    sh, sw = y.shape[-2:]
    r = resize.NV12Resize(sw, sh, dw, dh, ResizeType.AREA)
    assert r.kernel == "resize_area_down_nv12"
    return r, r.area_plan(n), y, uv


def blocks(r, plan):
    """Every block of one frame as the kernel locates it: (plane, step,
    output rows, output columns, band (its index in the plan's tables),
    (first source row, rows), (first source column, columns))."""
    sw, _ = r.src
    dw, dh = r.dst
    spans = plan.spans.reshape(-1, 2)
    nbands = sum(plan.bands)
    steps = resize.area_steps(r.planes, sw)
    for k in range(2):
        out_h = dh if k == 0 else dh // 2
        out_w = r.planes[k]["cols"].shape[0]
        for b in range(plan.bands[k]):
            band = b + (0 if k == 0 else plan.bands[0])
            rows = np.arange(b * plan.band, min((b + 1) * plan.band, out_h))
            for t in range(plan.tiles):
                col_span = spans[nbands + k * plan.tiles + t]
                cols = np.arange(t * plan.tile,
                                 min((t + 1) * plan.tile, out_w))
                yield (k, steps[k], rows, cols, band, spans[band],
                       col_span)


def mod16(img, row, col):
    return (img.data_ptr() + int(row) * img.stride(0) + int(col)) % 16


def stage(img, first, count, col_lo, ncols, plan, sw):
    """The kernel's Stage: rows [first, first + count) of a [H, W] view
    into a flat image, row k's first byte at k * step + shift (step =
    pitch + the view's row pitch mod 16, shift the first row's first
    byte's address mod 16), its 16-byte chunks around it, the row's last
    byte repeated past its end. Returns the image, which bytes hold a
    column, and the shift; fails if a row's chunks reach another row's
    columns or leave the frame's shared bytes."""
    step = plan.pitch + img.stride(0) % 16
    shift = mod16(img, first, col_lo)
    size = count * (plan.pitch + 16) + 16
    smem = torch.zeros(size, dtype=torch.uint8)
    owner = torch.full((size,), -1)
    inside = min(col_lo + ncols, sw) - col_lo
    chunks = []
    for k in range(count):
        row = first + k
        at = k * step + shift
        head = mod16(img, row, col_lo)
        assert (at - head) % 16 == 0, "a chunk off 16-byte alignment"
        # The last chunk is copied byte by byte where columns repeat after
        # the row's end, so no copy lands on them.
        end = head + inside
        chunks.append((k, at - head, at - head + (
            end // 16 if ncols > inside else (end + 15) // 16) * 16))
        src = img[row]
        smem[at:at + inside] = src[col_lo:col_lo + inside]
        smem[at + inside:at + ncols] = src[sw - 1]
        owner[at:at + ncols] = k
    for k, lo, hi in chunks:
        assert 0 <= lo and hi <= size, "a chunk leaves the shared bytes"
        mine = owner[lo:hi]
        assert bool(((mine == -1) | (mine == k)).all()), \
            "a chunk overwrites another row"
    return smem, owner >= 0, shift, step


def blend(p, wy, wx, div=None):
    """The plain version's order: y taps outer, x inner, w2d = wy*wx,
    div += w2d, acc = fmaf(p, w2d, acc), (int)(acc / div); with `div`
    given, the registers variant's (the host's sums). p is [rows, columns,
    ty, tx] float32."""
    acc = torch.zeros(p.shape[:2])
    summed = torch.zeros(p.shape[:2])
    for ti in range(p.shape[2]):
        for tj in range(p.shape[3]):
            w2d = wy[:, ti][:, None] * wx[:, tj][None, :]
            summed = summed + w2d
            acc = resize._fmaf(p[:, :, ti, tj], w2d, acc)
    return resize._trunc_u8(acc / (summed if div is None else div))


def walk(r, plan, y, uv):
    """The kernel's arithmetic in torch: each block stages its bytes and
    reads its taps at their offsets into them, the registers variant from
    the plan's tap table; fails if a tap reads a byte the block did not
    stage, or a word read leaves the frame's shared bytes."""
    sw, sh = r.src
    dw, dh = r.dst
    ty = r.planes[0]["rows"].shape[1]
    tx = r.planes[0]["cols"].shape[1]
    n = y.shape[0]
    out = [torch.zeros((n, dh, dw), dtype=torch.uint8),
           torch.zeros((n, dh // 2, dw), dtype=torch.uint8)]
    flat = torch.from_numpy(resize.area_div(r.planes))
    divs = [flat[:dh * dw].view(dh, dw), flat[dh * dw:].view(dh // 2, -1)]
    band_taps = torch.from_numpy(plan.taps).view(-1, plan.band, ty, 2)
    for f in range(n):
        imgs = (y[f], uv[f])
        for k, (c0, step), rows, cols, band, (rlo, nr), (clo, nc) in blocks(
                r, plan):
            if nc == 0:
                continue
            img, t = imgs[k], r.planes[k]
            src_h = sh if k == 0 else sh // 2
            wx = torch.as_tensor(t["col_w"][cols])
            off = torch.as_tensor(c0[cols] - clo)          # [C]
            taps = off[:, None] + step * torch.arange(tx)  # [C, tx]
            if plan.variant == "registers":
                smem, written, shift, row_step = stage(img, rlo, nr, clo, nc,
                                                       plan, sw)
                tab = band_taps[band][:len(rows)]          # [R, ty, 2]
                assert torch.equal(tab[..., 0] + rlo, torch.as_tensor(
                    t["rows"][rows]))
                wy = tab[..., 1].contiguous().view(torch.float32)
                base = tab[..., 0] * row_step + shift      # [R, ty]
                at = base[:, None, :, None] + taps[None, :, None, :]
                # The words a thread reads: from at & ~3, kWords of them.
                span = step * (tx - 1) + 1
                last = (base[:, None, :] + off[None, :, None]) // 4 * 4 + \
                    4 * ((span + 3) // 4 + 1) - 1
                assert bool((last < smem.numel()).all()), "a word leaves"
                assert bool(written[at].all()), "a tap left the staged band"
                p = smem[at].float()
                div = divs[k][rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1]
            else:  # one output row a block, rows staged in chunks
                trows = t["rows"][rows][0].tolist()
                wy = torch.as_tensor(t["row_w"][rows])
                p = torch.empty((1, len(cols), ty, tx))
                lo = hi = 0
                for ti, row in enumerate(trows):
                    if not lo <= row < hi:
                        lo, hi = row, min(row + plan.rows, src_h)
                        smem, written, shift, row_step = stage(
                            img, lo, hi - lo, clo, nc, plan, sw)
                    at = (row - lo) * row_step + shift + taps
                    assert bool(written[at].all()), "a tap left its chunk"
                    p[0, :, ti] = smem[at].float()
                div = None  # the table variant sums its own
            out[k][f][rows[0]:rows[-1] + 1, cols[0]:cols[-1] + 1] = \
                blend(p, wy, wx, div)
    return out


@pytest.mark.parametrize("name", IDS)
def test_every_tap_lies_in_its_blocks_band_and_tile(name):
    r, plan, _, _ = setup(name)
    sw, _ = r.src
    tx = r.planes[0]["cols"].shape[1]
    assert plan.smem <= resize.AREA_SMEM_LIMIT < 227 * 1024 + 1
    assert plan.tile <= resize.AREA_THREADS and plan.pitch % 16 == 0
    seen = [np.zeros(r.planes[k]["cols"].shape[0] * len(r.planes[k]["rows"]),
                     bool) for k in range(2)]
    for k, (c0, step), rows, cols, _, (rlo, nr), (clo, nc) in blocks(r,
                                                                      plan):
        trows = r.planes[k]["rows"][rows]
        tcols = r.planes[k]["cols"][cols]
        if cols.size == 0:
            assert nc == 0
            continue
        assert rlo <= trows.min() and trows.max() < rlo + nr
        if plan.variant == "registers":
            assert nr <= plan.rows
        # Each tap unclamped lies in the tile's columns, and its clamped
        # column is the staged byte there.
        unclamped = c0[cols][:, None] + step * np.arange(tx)
        assert clo <= unclamped.min() and unclamped.max() < clo + nc
        assert np.array_equal(np.minimum(unclamped, sw - 1), tcols)
        assert nc + 31 <= plan.pitch
        seen[k].reshape(-1, r.planes[k]["cols"].shape[0])[
            np.ix_(rows, cols)] = True
    assert all(s.all() for s in seen), "an output no block writes"


@pytest.mark.parametrize("name", IDS)
def test_walk_of_the_plan_matches_plain(name):
    r, plan, y, uv = setup(name)
    want = r.plain(y, uv)
    got = walk(r, plan, y, uv)
    for g, w, what in zip(got, want, ("Y", "UV")):
        bad = int((g != w).sum())
        assert bad == 0, f"{name} {what} ({plan.variant}): {bad} bytes differ"


def test_table_variant_restages_in_chunks():
    """A chunk shorter than an output's row taps: the block restages as
    the taps reach rows past it, and the bytes stay the plain version's."""
    r, plan, y, uv = setup("large_taps")
    assert plan.variant == "table" and plan.rows >= 30
    small = plan._replace(rows=7, smem=plan.smem - (plan.rows - 7) *
                          plan.pitch)
    got = walk(r, small, y, uv)
    want = r.plain(y, uv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plan_picks_variant_band_and_tile():
    """The headline keeps 9 column taps in registers, 2 frames and 2
    output rows a block (10 staged rows of a 1952-byte pitch a frame);
    30 column taps go to the table variant; a width of 300 takes two
    tiles of 160 columns, the second ragged."""
    r, plan, _, _ = setup("headline")
    assert (plan.variant, plan.band, plan.frames, plan.tile,
            plan.tiles) == ("registers", 2, 2, 224, 1)
    assert (plan.pitch, plan.rows) == (1952, 10)  # 1920 + 31, to 16
    assert plan.smem <= resize.AREA_SMEM_TARGET
    assert resize.area_launch_blocks(plan, 128) >= \
        resize.AREA_MIN_BLOCKS * 132
    r, plan, _, _ = setup("large_taps")
    assert (plan.variant, plan.band, plan.frames) == ("table", 1, 1)
    r, plan, _, _ = setup("ragged_tile")
    assert (plan.tile, plan.tiles) == (160, 2) and 300 % plan.tile


def test_band_too_tall_for_a_tile_goes_to_the_table_variant():
    """An extreme anisotropic cut (135 row taps of a 1920-wide row) still
    has a plan within the card's shared memory."""
    r = resize.NV12Resize(1920, 1080, 1800, 8, ResizeType.AREA)
    plan = r.area_plan(1)
    assert plan.smem <= resize.AREA_SMEM_LIMIT
    r = resize.NV12Resize(1920, 1080, 2, 2, ResizeType.AREA)
    plan = r.area_plan(1)
    assert plan.variant == "table" and plan.smem <= resize.AREA_SMEM_LIMIT


def test_launch_arguments_follow_the_entry_point():
    """The values passed after the tables are those the C entry takes
    (csrc/resize_nv12.cu ts_resize_area_down_nv12), in its order."""
    r, plan, _, _ = setup("headline")
    args = resize.area_args(plan, 99, 1234, 77, 1920, 1080, 224)
    assert len(args) == len(resize.AREA_ARGS)
    named = dict(zip(resize.AREA_ARGS, args))
    assert named == dict(div=99, spans=1234, taps=77, sw=1920, sh=1080,
                         uvw=224,
                         band=plan.band, tile=plan.tile,
                         frames=plan.frames, pitch=plan.pitch,
                         rows=plan.rows, smem=plan.smem, variant=0)
    with open(resize._build.SRC_DIR + "/resize_nv12.cu") as f:
        src = f.read()
    entry = src[src.index('int ts_resize_area_down_nv12('):]
    entry = entry[:entry.index(")")]
    # TS_RESIZE_ARGS (the tables and the stream), then one comma an argument.
    assert entry.startswith("int ts_resize_area_down_nv12(TS_RESIZE_ARGS,")
    assert entry.count(",") == len(resize.AREA_ARGS)


@pytest.mark.parametrize("name", IDS)
def test_host_sums_of_weights_are_the_blends(name):
    """area_div, which the registers variant divides by, is bit for bit
    the sum the plain version accumulates."""
    r, _, _, _ = setup(name)
    dw, dh = r.dst
    flat = torch.from_numpy(resize.area_div(r.planes))
    for k, want_shape in enumerate(((dh, dw), (dh // 2, -1))):
        t = r.planes[k]
        wy, wx = torch.as_tensor(t["row_w"]), torch.as_tensor(t["col_w"])
        want = None
        for ti in range(wy.shape[1]):
            for tj in range(wx.shape[1]):
                w2d = wy[:, ti][:, None] * wx[:, tj][None, :]
                want = w2d if want is None else want + w2d
        got = (flat[:dh * dw] if k == 0 else flat[dh * dw:]).view(
            *want_shape)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_columns_that_do_not_step_are_refused():
    r = resize.NV12Resize(64, 48, 40, 30, ResizeType.AREA)
    planes = [dict(p) for p in r.planes]
    cols = planes[0]["cols"].copy()
    cols[3, 1] += 1
    planes[0]["cols"] = cols
    with pytest.raises(ValueError, match="do not step"):
        resize.area_plan(planes, 64, 48, 40, 30)


def test_area_split_cuts_are_in_the_kernel_source():
    """chip_smoke.area_split times the AREA kernel with one part cut out
    of a copy of its source; each cut must name text that the source
    holds exactly once."""
    import chip_smoke
    with open(resize._build.SRC_DIR + "/resize_nv12.cu") as f:
        src = f.read()
    for name, cut in chip_smoke.AREA_SPLIT.items():
        assert cut is None or src.count(cut[0]) == 1, name
