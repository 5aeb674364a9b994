"""The NV12 -> RGB kernel's parts that the CPU can check: its x/255 table
against IEEE division, the choice of kernel variant from shapes and
pointers, and that chip_smoke.py, the card's check, loads no JAX.

The table must equal the quotients bit for bit: the vector kernel reads
x/255 from it where the plain version (ops/color.py) takes the same
correctly rounded values from its own table.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tensor_stream_torch.ops import color, nv12_rgb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "tensor_stream_torch", "csrc", "nv12_rgb.cu")
HEADER = os.path.join(ROOT, "tensor_stream_torch", "csrc", "nv12.cuh")


def kernel_table() -> np.ndarray:
    """The 256 hex float literals of kDiv255 in nv12.cuh (the header of
    nv12_rgb.cu and clip_augment.cu), as float32."""
    with open(HEADER) as f:
        text = f.read()
    start = text.index("kDiv255[256]")
    body = text[start:text.index("};", start)]
    lits = re.findall(r"-?0x[0-9a-f.]+p[+-]\d+f", body)
    assert len(lits) == 256
    values = np.array([float.fromhex(s[:-1]) for s in lits], np.float64)
    table = values.astype(np.float32)
    assert np.array_equal(table.astype(np.float64), values)  # exact in f32
    return table


def test_div255_table_is_the_ieee_quotient():
    want = np.arange(256, dtype=np.float32) / np.float32(255)
    assert np.array_equal(kernel_table().view(np.uint32), want.view(np.uint32))


def test_div255_table_is_correctly_rounded():
    """Each entry is the float32 nearest to x/255 (never a tie: x/255 has
    an infinite binary expansion unless x is 0 or 255)."""
    table = kernel_table()
    exact = np.arange(256, dtype=np.float64) / 255
    err = np.abs(table.astype(np.float64) - exact)
    for side in (np.inf, -np.inf):
        neighbour = np.nextafter(table, np.float32(side)).astype(np.float64)
        assert (err <= np.abs(neighbour - exact)).all()


def test_div255_table_matches_the_plain_version():
    """The plain version's x/255 on every channel value, as torch divides
    and as ops/color.py looks it up."""
    x = torch.arange(256, dtype=torch.float32)
    table = torch.from_numpy(kernel_table())
    assert torch.equal((x / 255).view(torch.int32), table.view(torch.int32))
    lut = color._norm255_int(torch.arange(256, dtype=torch.int32))
    assert torch.equal(lut.view(torch.int32), table.view(torch.int32))


def test_plain_rgb_output_values_are_table_entries():
    """Every f32 value nv12_to_rgb_plain writes is kDiv255[u8 value] for
    the u8 result of the same conversion."""
    rng = np.random.default_rng(4)
    y = torch.from_numpy(rng.integers(0, 256, (2, 8, 32), np.uint8))
    uv = torch.from_numpy(rng.integers(0, 256, (2, 4, 32), np.uint8))
    table = torch.from_numpy(kernel_table())
    for planar in (True, False):
        u8 = nv12_rgb.nv12_to_rgb_plain(y, uv, False, planar, False, 1)
        f32 = nv12_rgb.nv12_to_rgb_plain(y, uv, False, planar, True, 1)
        assert torch.equal(f32.view(torch.int32),
                           table[u8.long()].view(torch.int32))


@pytest.mark.parametrize("bias", [0, 128])
def test_byte_to_float_through_its_bit_pattern_is_exact(bias):
    """The vector kernel's ByteF: the float with bits 0x4B0000bb is
    2^23 + bb, and subtracting 2^23 + bias (exact in f32) gives
    float(bb - bias) bit for bit, as the edge kernel's cast does."""
    b = np.arange(256, dtype=np.uint32)
    pattern = (np.uint32(0x4B000000) | b).view(np.float32)
    got = pattern - np.float32(8388608.0 + bias)
    want = (b.astype(np.int64) - bias).astype(np.float32)
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


A = 0x7F00_0000_0000  # a 256-byte aligned base, as the caching allocator's


@pytest.mark.parametrize("h,w,y,uv,out,want", [
    # The main paths: headline batch of 128, 1080p, serving's 16 frames;
    # UV is the flat staging view at byte N*H*W.
    (224, 224, A, A + 128 * 224 * 224, A, "vector"),
    (1080, 1920, A, A + 1920 * 1080, A, "vector"),
    (224, 224, A, A + 16 * 224 * 224, A, "vector"),
    (16, 16, A, A + 256, A, "vector"),
    # W % 16 != 0 with every pointer aligned.
    (240, 322, A, A + 4 * 240 * 322, A, "edge"),
    (36, 130, A, A + 1024, A, "edge"),
    (10, 8, A, A + 1024, A, "edge"),
    # Flat staging of 3 frames of 10x326: UV at byte 9780, 4 past a
    # 16-byte boundary, and W % 16 != 0 (the smoke's edge shape).
    (10, 326, A, A + 3 * 10 * 326, A, "edge"),
    # W % 16 == 0, but one plane or the output off a 16-byte boundary.
    (10, 320, A, A + 8, A, "edge"),
    (10, 320, A + 4, A + 4096, A, "edge"),
    (10, 320, A, A + 4096, A + 2, "edge"),
    (10, 320, A + 16, A + 4096 + 48, A + 256, "vector"),
    # Wider than a row pair the vector kernel holds in shared memory.
    (64, 4096, A, A + 2 ** 20, A, "vector"),
    (64, 4112, A, A + 2 ** 20, A, "edge"),
    # Taller than the vector kernel's grid and 32-bit frame index allow.
    (65536, 16, A, A + 2 ** 20, A, "edge"),
    (65534, 4096, A, A + 2 ** 30, A, "vector"),
    (65534, 16, A, A + 2 ** 20, A, "vector"),
])
def test_variant_selector(h, w, y, uv, out, want):
    assert nv12_rgb.variant(h, w, y, uv, out) == want


def test_variant_of_the_flat_staging_views():
    """build_vpp_batched_flat's views: the UV plane lies N*H*W bytes into
    the buffer, so its alignment follows N*H*W, whatever W is."""
    for n, h, w in ((128, 224, 224), (3, 10, 320), (1, 1080, 1920),
                    (3, 10, 326), (1, 2, 24)):
        flat = torch.zeros(n * h * w * 3 // 2, dtype=torch.uint8)
        y = flat[:n * h * w].view(n, h, w)
        uv = flat[n * h * w:].view(n, h // 2, w)
        assert uv.data_ptr() - y.data_ptr() == n * h * w
        base = y.data_ptr() % 16  # the allocator's base is aligned
        assert base == 0
        want = "vector" if w % 16 == 0 and (n * h * w) % 16 == 0 else "edge"
        assert nv12_rgb.variant(h, w, y.data_ptr(), uv.data_ptr(),
                                16 * 1024) == want


def test_counts_reset_together():
    nv12_rgb.launches_by_variant["edge"] += 1
    nv12_rgb.launches += 1
    nv12_rgb.reset_counts()
    assert nv12_rgb.launches == 0
    assert nv12_rgb.launches_by_variant == {"vector": 0, "edge": 0}
    assert tuple(nv12_rgb.launches_by_variant) == nv12_rgb.VARIANTS


def test_source_has_one_entry_point_per_variant():
    with open(SOURCE) as f:
        text = f.read()
    for entry in nv12_rgb._ENTRY.values():
        assert re.search(rf'extern "C" int {entry}\(', text), entry
    assert set(nv12_rgb._ENTRY) == set(nv12_rgb.VARIANTS)


def test_chip_smoke_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, chip_smoke; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'tensor_stream_tpu'))))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_fails_without_a_card():
    """With no CUDA device the smoke prints no result and exits non-zero
    (this machine has none; on a card this test has nothing to show)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
