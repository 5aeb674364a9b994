"""The port's device resize (ops/resize.py) on the CPU: the plain BILINEAR,
BICUBIC and AREA versions, which the CUDA kernels of csrc/resize_nv12.cu
equal byte for byte on the card (chip_smoke.py, phase resize_vs_plain).

Held to the native host resize (csrc/vpp_host.cpp, whose explicit fmaf
order reproduces every reference CRC) at the 19 CRC geometries of
tests/test_resize_crc.py, crops included, on a seeded 1080x608 frame of
several contents, and at the fuzz geometries; and to the JAX package's
device resize (jax.jit(resize_nv12)), which the JAX suite pins to the same
bytes. Every comparison is byte-exact.
"""
import fractions

import jax
import numpy as np
import pytest
import torch

from tensor_stream_tpu import enums as jenums
from tensor_stream_tpu.ops import vpp as jvpp
from tensor_stream_tpu.ops.resize import resize_nv12 as jax_resize_nv12
from tensor_stream_torch.enums import FourCC, Planes, ResizeType
from tensor_stream_torch.ops import resize, vpp
from tensor_stream_torch.ops.crop import crop_nv12
from tensor_stream_torch.utils.crc import av_crc32

from test_resize_crc import CASES, _host_resize_nv12

R = jenums.ResizeType
W, H = 1080, 608
FUZZ = [((64, 48), (52, 36)), ((64, 48), (100, 76)), ((100, 76), (64, 18)),
        ((56, 34), (146, 108))]


def frame(content, h=H, w=W, seed=0):
    """A seeded NV12 frame: uniform random bytes, a flat field, a 0/255
    checker or ramps. Flat and half-tone fields put the most outputs on
    the rounding boundaries of the bicubic and AREA blends."""
    i, j = np.mgrid[:h, :w]
    ci, cj = np.mgrid[:h // 2, :w]
    if content == "random":
        rng = np.random.default_rng(seed)
        return (rng.integers(0, 256, (h, w), np.uint8),
                rng.integers(0, 256, (h // 2, w), np.uint8))
    if content == "flat":
        return (np.full((h, w), 77, np.uint8), np.full((h // 2, w), 160,
                                                        np.uint8))
    if content == "checker":
        return (((i + j) % 2 * 255).astype(np.uint8),
                ((ci + cj // 2) % 2 * 255).astype(np.uint8))
    return ((i + j) % 256).astype(np.uint8), ((3 * cj + ci) % 256).astype(
        np.uint8)


CONTENTS = ("random", "flat", "checker", "ramp")


def port_resize(y, uv, kwargs, w=W, h=H):
    """Crop (a strided view) + the port's resize, as ops/vpp.py runs it."""
    y, uv = torch.from_numpy(y), torch.from_numpy(uv)
    crop = kwargs.get("crop", (0, 0, 0, 0))
    if crop != (0, 0, 0, 0):
        y, uv = crop_nv12(y, uv, *crop)
        w, h = crop[2] - crop[0], crop[3] - crop[1]
    fn = resize.make_resize_fn(w, h, kwargs["width"], kwargs["height"],
                               ResizeType(kwargs.get("resize_type",
                                                     R.NEAREST).value))
    oy, ouv = fn(y, uv)
    return oy.numpy(), ouv.numpy()


def assert_bytes_equal(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    bad = int((got != want).sum())
    assert bad == 0, f"{what}: {bad} bytes differ"


@pytest.mark.parametrize("name,kwargs,want,_", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_host_at_crc_geometries(native, name, kwargs, want, _):
    for content in CONTENTS:
        y, uv = frame(content)
        oy, ouv = _host_resize_nv12(native, y, uv, kwargs)
        gy, guv = port_resize(y, uv, kwargs)
        assert_bytes_equal(gy, oy, f"{content} Y")
        assert_bytes_equal(guv, ouv, f"{content} UV")


@pytest.mark.parametrize("algo", [R.NEAREST, R.BILINEAR, R.BICUBIC, R.AREA])
def test_plain_matches_host_fuzz(native, algo):
    """Awkward non-dyadic geometries, up, down and anisotropic."""
    rng = np.random.default_rng(1234 + algo.value)
    for (sw, sh), (dw, dh) in FUZZ:
        for _ in range(4):
            y = rng.integers(0, 256, (sh, sw), np.uint8)
            uv = rng.integers(0, 256, (sh // 2, sw), np.uint8)
            kw = dict(width=dw, height=dh, resize_type=algo)
            oy, ouv = _host_resize_nv12(native, y, uv, kw)
            gy, guv = port_resize(y, uv, kw, sw, sh)
            assert_bytes_equal(gy, oy, f"{(sw, sh, dw, dh)} Y")
            assert_bytes_equal(guv, ouv, f"{(sw, sh, dw, dh)} UV")


@pytest.mark.parametrize("algo", [R.BILINEAR, R.BICUBIC, R.AREA])
def test_plain_matches_jax_device_resize_fuzz(algo):
    rng = np.random.default_rng(77 + algo.value)
    for (sw, sh), (dw, dh) in FUZZ:
        y = rng.integers(0, 256, (sh, sw), np.uint8)
        uv = rng.integers(0, 256, (sh // 2, sw), np.uint8)
        jy, juv = jax.jit(lambda a, b, _sw=sw, _sh=sh, _dw=dw, _dh=dh:
                          jax_resize_nv12(a, b, _sw, _sh, _dw, _dh, algo))(
                              y, uv)
        kw = dict(width=dw, height=dh, resize_type=algo)
        gy, guv = port_resize(y, uv, kw, sw, sh)
        assert_bytes_equal(gy, np.asarray(jy), f"{(sw, sh, dw, dh)} Y")
        assert_bytes_equal(guv, np.asarray(juv), f"{(sw, sh, dw, dh)} UV")


def test_batched_planes_resize_each_frame():
    """Leading batch dims: each frame resizes as it would alone."""
    rng = np.random.default_rng(3)
    ys = rng.integers(0, 256, (3, 48, 64), np.uint8)
    uvs = rng.integers(0, 256, (3, 24, 64), np.uint8)
    for algo in (ResizeType.BILINEAR, ResizeType.BICUBIC, ResizeType.AREA):
        fn = resize.make_resize_fn(64, 48, 40, 30, algo)
        by, buv = fn(torch.from_numpy(ys), torch.from_numpy(uvs))
        for k in range(3):
            oy, ouv = fn(torch.from_numpy(ys[k]), torch.from_numpy(uvs[k]))
            assert torch.equal(by[k], oy) and torch.equal(buv[k], ouv)


# A seeded 128x72 frame: crops of the CRC cases' kinds (corner, centre and
# far edge, up and down) at a size JAX compiles quickly.
CROP_CASES = [
    ("area_up_left", dict(crop=(0, 0, 40, 30), width=120, height=68,
                          resize_type=ResizeType.AREA)),
    ("area_up_right", dict(crop=(80, 40, 128, 72), width=96, height=64,
                           resize_type=ResizeType.AREA)),
    ("area_down_center", dict(crop=(16, 8, 112, 64), width=40, height=22,
                              resize_type=ResizeType.AREA)),
    ("bilinear_center", dict(crop=(10, 6, 90, 50), width=52, height=36,
                             resize_type=ResizeType.BILINEAR)),
    ("bicubic_center", dict(crop=(10, 6, 90, 50), width=130, height=70,
                            resize_type=ResizeType.BICUBIC)),
]


@pytest.mark.parametrize("name,kw", CROP_CASES, ids=[c[0] for c in CROP_CASES])
def test_crop_resize_vpp_matches_jax(name, kw):
    """Crop + resize through make_vpp_fn (NV12 output: the resized planes
    as they are) equals the JAX package's vpp_numpy byte for byte."""
    y, uv = frame("random", 72, 128, seed=len(name))
    jkw = dict(kw, resize_type=jenums.ResizeType(kw["resize_type"].value),
               fourcc=jenums.FourCC.NV12, planes=jenums.Planes.PLANAR)
    got = vpp.vpp_numpy(vpp.VPPConfig(128, 72, fourcc=FourCC.NV12,
                                      planes=Planes.PLANAR, **kw),
                        y, uv, device="cpu")
    want = jvpp.vpp_numpy(jvpp.VPPConfig(128, 72, **jkw), y, uv)
    assert_bytes_equal(got, np.asarray(want), name)


@pytest.mark.parametrize("name,kwargs,want,_", CASES,
                         ids=[c[0] for c in CASES])
def test_crc_cases_on_bbb_frame0(bbb_frame0, name, kwargs, want, _):
    """The reference's CRCs through the port's VPP (skips where the
    reference's bbb resource is absent, as the JAX cases do)."""
    y, uv, w, h = bbb_frame0
    kw = dict(kwargs)
    for key, enum in (("fourcc", FourCC), ("planes", Planes),
                      ("resize_type", ResizeType)):
        if key in kw:
            kw[key] = enum(kw[key].value)
    out = vpp.vpp_numpy(vpp.VPPConfig(src_width=w, src_height=h, **kw), y,
                        uv, device="cpu")
    assert av_crc32(out) in want


def test_kernel_tables_pack_both_planes():
    """The kernel reads each table kind as the Y plane's rows (or
    columns) followed by the UV plane's, the UV columns interleaving U
    and V taps."""
    # AREA's taps are ceil(1080/224) rows and ceil(1920/224) columns.
    for algo, row_taps, col_taps in ((ResizeType.BILINEAR, 2, 2),
                                     (ResizeType.BICUBIC, 4, 4),
                                     (ResizeType.AREA, 5, 9)):
        r = resize.NV12Resize(1920, 1080, 224, 224, algo)
        planes, (rows, cols, row_w, col_w) = r._tables(torch.device("cpu"))
        assert rows.dtype == cols.dtype == torch.int32
        assert tuple(rows.shape) == (224 + 112, row_taps)
        assert tuple(cols.shape) == (2 * 224, col_taps)
        assert row_w.shape[0] == 224 + 112 and col_w.shape[0] == 2 * 224
        uv = planes[1]
        # U of chroma column j at 2j, V at 2j + 1, one step apart.
        assert torch.equal(uv["cols"][1::2] - uv["cols"][0::2],
                           torch.ones_like(uv["cols"][0::2]))
        assert int(rows[:224].max()) <= 1079 and int(rows[224:].max()) <= 539


def _fma_exact(x, y, z):
    """fmaf(x, y, z) rounded to float32 from the exact rational value."""
    exact = fractions.Fraction(float(x)) * fractions.Fraction(float(y)) + \
        fractions.Fraction(float(z))
    c = np.float32(float(exact))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c,
                 np.nextafter(c, np.float32(np.inf))):
        err = abs(fractions.Fraction(float(cand)) - exact)
        key = (err, int(np.float32(cand).view(np.int32)) & 1)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


def test_fmaf_is_correctly_rounded():
    """The plain versions' fmaf: one rounding of x*y + z, including the
    cases where float64's own rounding of the sum would round twice."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, 400).astype(np.float32)
    y = (rng.random(400) * 2 - 0.5).astype(np.float32)
    z = (rng.random(400) * 300).astype(np.float32)
    # Ties after the first rounding: z a half-ulp of x*y's scale away.
    x[:50] = np.float32(1 + 2 ** -23)
    y[:50] = np.float32(1 + 2 ** -23)
    z[:50] = np.float32(2 ** -24) * np.float32(rng.integers(-3, 4, 50))
    got = resize._fmaf(torch.from_numpy(x), torch.from_numpy(y),
                       torch.from_numpy(z)).numpy()
    want = np.array([_fma_exact(a, b, c) for a, b, c in zip(x, y, z)],
                    np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_cuda_launch_refuses_cpu_planes():
    r = resize.NV12Resize(64, 48, 32, 24, ResizeType.BILINEAR)
    y = torch.zeros((48, 64), dtype=torch.uint8)
    uv = torch.zeros((24, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        r(y, uv, impl="cuda")
    before = dict(resize.launches)
    r(y, uv)  # CPU planes: the plain version, no launch counted
    assert resize.launches == before


def test_one_object_a_geometry_whose_tables_outlive_other_geometries():
    """NV12Resize(...) is the registry the operators look their geometry
    up in: the caller's object is the op's, and its tables (whose
    pointers a captured CUDA graph holds) survive any number of other
    geometries."""
    r = resize.NV12Resize(64, 48, 32, 24, ResizeType.AREA)
    assert resize.NV12Resize(64, 48, 32, 24, ResizeType.AREA.value) is r
    assert resize.make_resize_fn(64, 48, 32, 24, ResizeType.AREA) is r
    ptrs = [t.data_ptr() for t in r._tables("cpu")[1]]
    rng = np.random.default_rng(4)
    for dw in range(2, 162, 2):  # 80 other geometries through the op
        y = torch.from_numpy(rng.integers(0, 256, (1, 48, 64), np.uint8))
        uv = torch.from_numpy(rng.integers(0, 256, (1, 24, 64), np.uint8))
        resize.make_resize_fn(64, 48, dw, 8, ResizeType.BILINEAR)(y, uv)
    assert resize.NV12Resize(64, 48, 32, 24, ResizeType.AREA) is r
    assert [t.data_ptr() for t in r._tables("cpu")[1]] == ptrs


def test_planes_of_another_source_raise():
    r = resize.NV12Resize(64, 48, 32, 24, ResizeType.BILINEAR)
    y = torch.zeros((2, 24, 32), dtype=torch.uint8)
    uv = torch.zeros((2, 12, 32), dtype=torch.uint8)
    with pytest.raises(ValueError, match="do not match the 64x48 source"):
        r(y, uv)
    with pytest.raises(ValueError, match="do not match"):
        r(torch.zeros((2, 48, 64), dtype=torch.uint8), uv)


@pytest.mark.gpu
def test_a_captured_resize_replays_after_other_geometries():
    """A CUDA graph captured over a resize replays on its tables after
    80 other geometries were made and run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    r = resize.NV12Resize(64, 48, 32, 24, ResizeType.BILINEAR)
    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.integers(0, 256, (2, 48, 64), np.uint8)).cuda()
    uv = torch.from_numpy(rng.integers(0, 256, (2, 24, 64), np.uint8)).cuda()
    r(y, uv)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = r(y, uv)
    for dw in range(2, 162, 2):
        resize.NV12Resize(64, 48, dw, 8, ResizeType.BILINEAR)(y, uv)
    torch.cuda.empty_cache()
    graph.replay()
    torch.cuda.synchronize()
    want = r.plain(y, uv)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card():
    """Each kernel against its plain version on CUDA tensors, byte for
    byte, a crop's strided view included (chip_smoke.py runs the full
    matrix of geometries and contents)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    y, uv = frame("random")
    y, uv = torch.from_numpy(y).cuda(), torch.from_numpy(uv).cuda()
    for kwargs in ({"width": 480, "height": 360},
                   {"width": 1920, "height": 1080},
                   {"crop": (120, 60, 960, 540), "width": 320,
                    "height": 240},
                   # AREA-down's table variant (30 x 17 taps) and a crop
                   # whose rows start off 16-byte alignment.
                   {"width": 36, "height": 36},
                   {"crop": (6, 2, 966, 542), "width": 200, "height": 120}):
        for algo in (ResizeType.BILINEAR, ResizeType.BICUBIC,
                     ResizeType.AREA):
            a, b, w, h = y, uv, W, H
            if "crop" in kwargs:
                a, b = crop_nv12(y, uv, *kwargs["crop"])
                x0, y0, x1, y1 = kwargs["crop"]
                w, h = x1 - x0, y1 - y0
            r = resize.NV12Resize(w, h, kwargs["width"], kwargs["height"],
                                  algo)
            before = resize.launches[r.kernel]
            got = r(a, b)
            assert resize.launches[r.kernel] == before + 1
            want = r.plain(a, b)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
