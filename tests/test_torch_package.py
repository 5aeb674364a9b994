"""The PyTorch port's package boundary: what it imports, its copies of the
JAX package's enums, device selection, the kernel wrapper's CPU dispatch
and the build settings of its CUDA sources."""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import tensor_stream_tpu.enums as jax_enums
from tensor_stream_torch import _build, _device, enums
from tensor_stream_torch.ops import flash_attention, nv12_rgb
from tensor_stream_torch.ops.vpp import VPPConfig, build_vpp, vpp_numpy
from tensor_stream_torch.utils import crc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tensor_stream_torch")
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "bbb_720x480_RGB24_250.h264")


def test_import_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, tensor_stream_torch, tensor_stream_torch.data, "
            "tensor_stream_torch.utils.crc, tensor_stream_torch.serving, "
            "tensor_stream_torch.models, "
            "tensor_stream_torch.models.video_vae, "
            "tensor_stream_torch.models.latent_diffusion, "
            "tensor_stream_torch.models.moe, "
            "tensor_stream_torch.models.quantize, "
            "tensor_stream_torch.models.transformer_net, "
            "tensor_stream_torch.models._train, "
            "tensor_stream_torch.ops.metrics, "
            "tensor_stream_torch.ops.flash_attention, "
            "tensor_stream_torch.ops.resize, tensor_stream_torch.ops.augment, "
            "tensor_stream_torch.ops.mix, tensor_stream_torch.graphs, "
            "tensor_stream_torch.checkpoint, tensor_stream_torch.export, "
            "tensor_stream_torch.video_writer, "
            "tensor_stream_torch.parallel, "
            "tensor_stream_torch.parallel.accum, "
            "tensor_stream_torch.parallel.sharding, "
            "tensor_stream_torch.parallel.pipeline, "
            "tensor_stream_torch.parallel._rules, "
            "tensor_stream_torch.ops.ring_attention, "
            "tensor_stream_torch.utils.torch_data, "
            "tensor_stream_torch.utils.torch_interop; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'tensor_stream_tpu'))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_no_package_file_names_jax_or_the_jax_package():
    imports = re.compile(r"^\s*(import|from)\s+(jax|tensor_stream_tpu)\b",
                         re.MULTILINE)
    seen = 0
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith((".py", ".cu", ".cuh")):
                continue
            with open(os.path.join(dirpath, name)) as f:
                text = f.read()
            seen += 1
            assert "tensor_stream_tpu" not in text, name
            assert not imports.search(text), name
    assert seen >= 10


@pytest.mark.parametrize("name", [
    "StatusLevel", "LogsLevel", "LogsType", "FourCC", "ResizeType", "Planes",
    "ColorStandard", "FrameRate"])
def test_enum_matches_jax_copy(name):
    ours = [(m.name, m.value) for m in getattr(enums, name)]
    theirs = [(m.name, m.value) for m in getattr(jax_enums, name)]
    assert ours == theirs


def test_channels_by_fourcc_matches_jax_copy():
    for f in enums.FourCC:
        assert (enums.channels_by_fourcc(f) ==
                jax_enums.channels_by_fourcc(jax_enums.FourCC(f.value)))


def test_entry_points_without_device_take_cuda(tmp_path):
    """device=None means cuda:N: without a CUDA device every entry point
    raises instead of dropping to the CPU on its own (a serving artifact's
    load and a restore without a template included)."""
    from tensor_stream_torch import (ClipDataset, ClipLoader, FrameLoader,
                                     TensorStreamConverter,
                                     TrainCheckpointer, export_inference,
                                     load_inference)
    cfg = VPPConfig(64, 32)
    if torch.cuda.is_available():
        assert _device.resolve_device() == torch.device("cuda", 0)
        return
    y = np.zeros((32, 64), np.uint8)
    uv = np.zeros((16, 64), np.uint8)
    artifact = str(tmp_path / "vpp.pt2")
    export_inference(lambda a, b: a + b, (torch.ones(2), torch.ones(2)),
                     artifact)
    TrainCheckpointer(str(tmp_path)).save(1, {"w": torch.ones(2)})
    from tensor_stream_torch.models import (DiffusionSchedule,
                                            TransformerNet, VideoDiT,
                                            VideoMoE, VideoVAE, VideoViT)
    from tensor_stream_torch.serving import StreamInferencer
    for call in (lambda: TensorStreamConverter(FIXTURE),
                 lambda: FrameLoader(FIXTURE, batch=2),
                 lambda: ClipLoader(FIXTURE, clip_len=2),
                 lambda: ClipDataset([FIXTURE], clip_len=2),
                 lambda: StreamInferencer([FIXTURE], lambda x: x),
                 lambda: VideoViT(10, depth=1, dim=32, num_heads=1, patch=8,
                                  frames=2, size=16),
                 lambda: VideoVAE(base=8, latent=4),
                 lambda: VideoDiT((2, 4, 4, 4), depth=1, dim=32,
                                  num_heads=1),
                 lambda: VideoMoE(2, depth=1, dim=32, num_heads=1, patch=8,
                                  frames=2, size=16),
                 lambda: TransformerNet(),
                 lambda: DiffusionSchedule(10),
                 lambda: build_vpp(cfg),
                 lambda: vpp_numpy(cfg, y, uv),
                 lambda: load_inference(artifact),
                 lambda: TrainCheckpointer(str(tmp_path)).restore(),
                 lambda: _device.resolve_device("cuda:0")):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert _device.resolve_device("cpu") == torch.device("cpu")
    # The stream cache follows the model's device: a model that names a
    # card gets its cache there, which raises here.
    from tensor_stream_torch.models import init_stream_cache
    m = VideoViT(10, depth=1, dim=32, num_heads=1, patch=8, frames=2,
                 size=16, causal=True, device="cpu")
    assert init_stream_cache(m, 1, 2)["t"].device == torch.device("cpu")
    m.device = torch.device("cuda", 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_stream_cache(m, 1, 2)


def test_all_is_the_jax_packages_but_the_sharded_loaders():
    """The port's public names: the JAX package's (the three Sharded*
    loaders too, since the parallel slice ported them), plus the port's
    own VPPConfig, cuda_graph and channels_by_fourcc; each one
    importable."""
    import tensor_stream_torch
    import tensor_stream_tpu
    sharded = {"ShardedClipDataset", "ShardedClipLoader",
               "ShardedStreamLoader"}
    own = {"VPPConfig", "cuda_graph", "channels_by_fourcc"}
    assert sharded <= set(tensor_stream_tpu.__all__)
    assert sharded <= set(tensor_stream_torch.__all__)
    assert set(tensor_stream_torch.__all__) == (
        set(tensor_stream_tpu.__all__) | own)
    assert len(tensor_stream_torch.__all__) == len(
        set(tensor_stream_torch.__all__))
    for name in tensor_stream_torch.__all__:
        assert getattr(tensor_stream_torch, name) is not None, name


def test_parallel_exports_the_jax_packages_names():
    """``parallel`` holds every name of the JAX package's ``parallel``
    (its __init__ imports them), plus ``shard_pp_params``, the shard_fn
    that the JAX ``make_pp_train_step`` returns and that torch needs
    before the optimizer is built."""
    import tensor_stream_torch.parallel as ours
    import tensor_stream_tpu.parallel as theirs
    jax_names = {n for n in vars(theirs) if not n.startswith("_")
                 and callable(getattr(theirs, n))}
    assert jax_names == {
        "make_mesh", "vpp_batch_sharded", "make_train_state",
        "build_train_step", "multi_stream_round_robin", "param_sharding",
        "make_pp_mesh", "init_pp_params", "pp_apply", "make_pp_train_step",
        "accumulate_gradients"}
    assert set(ours.__all__) == jax_names | {"shard_pp_params"}
    for name in ours.__all__:
        assert callable(getattr(ours, name)), name


def test_wrapper_runs_plain_on_cpu_and_never_counts():
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.integers(0, 256, (2, 8, 16), np.uint8))
    uv = torch.from_numpy(rng.integers(0, 256, (2, 4, 16), np.uint8))
    before = nv12_rgb.launches
    got = nv12_rgb.nv12_to_rgb(y, uv, False, True, True, 0)
    vpp_numpy(VPPConfig(16, 8, fourcc=enums.FourCC.BGR24), y[0].numpy(),
              uv[0].numpy(), device="cpu")
    assert nv12_rgb.launches == before == 0
    assert torch.equal(got, nv12_rgb.nv12_to_rgb_plain(y, uv, False, True,
                                                       True, 0))


def test_wrapper_rejects_a_tensor_off_cpu_and_cuda():
    y = torch.empty((8, 16), dtype=torch.uint8, device="meta")
    uv = torch.empty((4, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        nv12_rgb.nv12_to_rgb(y, uv, False, True, False, 0)


def test_cuda_build_flags_pin_rounding():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in _build.SOURCE_FLAGS["nv12_rgb"]
    assert "-fmad=false" in _build.SOURCE_FLAGS["resize_nv12"]
    for extra in _build.SOURCE_FLAGS.values():
        flags += " " + " ".join(extra)
    assert "fast_math" not in flags and "fast-math" not in flags
    assert _build.SOURCES == ("nv12_rgb", "flash_fwd", "flash_bwd",
                              "resize_nv12", "clip_augment", "block_fusions")
    for name in _build.SOURCES:
        assert os.path.exists(os.path.join(_build.SRC_DIR, f"{name}.cu"))


def test_build_staleness_follows_included_headers(tmp_path, monkeypatch):
    """A library is rebuilt when its .cu or any csrc/ file that it
    includes, directly or through another header, is newer than it; a
    system header is not followed."""
    src, out = tmp_path / "csrc", tmp_path / "build"
    src.mkdir()
    out.mkdir()
    monkeypatch.setattr(_build, "SRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(out))
    (src / "k.cu").write_text('#include <cuda.h>\n  # include "a.cuh"\n')
    (src / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (src / "b.cuh").write_text('#include "a.cuh"\n')  # a cycle ends
    (src / "other.cuh").write_text("")
    assert _build._stale("k")  # never built
    lib = out / "libk.so"
    lib.write_text("")
    for f in ("k.cu", "a.cuh", "b.cuh", "other.cuh"):
        os.utime(src / f, (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert sorted(os.path.basename(f) for f in _build.sources_of("k")) == [
        "a.cuh", "b.cuh", "k.cu"]
    assert not _build._stale("k")
    os.utime(src / "other.cuh", (3000, 3000))
    assert not _build._stale("k")  # not included
    os.utime(src / "b.cuh", (3000, 3000))
    assert _build._stale("k")


def test_flash_source_includes_its_hopper_header():
    assert os.path.join(_build.SRC_DIR, "sm90.cuh") in _build.sources_of(
        "flash_fwd")


def test_flash_bwd_rebuilds_when_its_hopper_header_changes(tmp_path,
                                                           monkeypatch):
    """flash_bwd.cu includes csrc/sm90.cuh (its wgmma and TMA wrappers):
    a library built after both is fresh, and stale again once the header
    is newer, whatever the time of the other sources."""
    src, out = tmp_path / "csrc", tmp_path / "build"
    shutil.copytree(_build.SRC_DIR, src)
    out.mkdir()
    monkeypatch.setattr(_build, "SRC_DIR", str(src))
    monkeypatch.setattr(_build, "BUILD_DIR", str(out))
    assert os.path.join(str(src), "sm90.cuh") in _build.sources_of(
        "flash_bwd")
    lib = out / "libflash_bwd.so"
    lib.write_text("")
    for f in os.listdir(src):
        os.utime(src / f, (1000, 1000))
    os.utime(lib, (2000, 2000))
    assert not _build._stale("flash_bwd")
    os.utime(src / "nv12_rgb.cu", (3000, 3000))
    assert not _build._stale("flash_bwd")  # not included
    os.utime(src / "sm90.cuh", (3000, 3000))
    assert _build._stale("flash_bwd")


def test_crc_matches_jax_copy():
    from tensor_stream_tpu.utils.crc import av_crc32
    data = np.random.default_rng(3).integers(0, 256, 4096, np.uint8)
    assert crc.av_crc32(data) == av_crc32(data)
    assert crc.av_crc32(data.tobytes()) == av_crc32(data.tobytes())


@pytest.mark.gpu
def test_kernel_matches_plain_on_the_card():
    """Bit-equal to the plain version on CUDA tensors, planar and merged,
    u8 and f32, under both variants: W % 16 != 0 (edge), aligned views
    with W % 16 == 0 (vector), and flat staging whose UV plane is off a
    16-byte boundary (edge). chip_smoke.py runs the full matrix at the
    headline shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(1)
    for n, h, w, want_variant in ((3, 36, 130, "edge"), (2, 36, 160, "vector"),
                                  (3, 10, 326, "edge")):
        flat = torch.from_numpy(rng.integers(0, 256, n * h * w * 3 // 2,
                                             np.uint8)).cuda()
        y = flat[:n * h * w].view(n, h, w)
        uv = flat[n * h * w:].view(n, h // 2, w)
        for planar in (True, False):
            for norm in (False, True):
                for standard in range(4):
                    before = nv12_rgb.launches_by_variant[want_variant]
                    got = nv12_rgb.nv12_to_rgb(y, uv, True, planar, norm,
                                               standard)
                    assert (nv12_rgb.launches_by_variant[want_variant]
                            == before + 1)
                    want = nv12_rgb.nv12_to_rgb_plain(y, uv, True, planar,
                                                      norm, standard)
                    assert torch.equal(got.view(torch.uint8),
                                       want.view(torch.uint8))


def test_flash_wrapper_rejects_a_tensor_off_cpu_and_cuda():
    q = torch.empty((1, 2, 8, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention.flash_attention(q, q, q)


@pytest.mark.gpu
def test_flash_kernel_matches_plain_on_the_card():
    """o within the bf16/f32 tolerances of tests/test_flash_attention.py
    elementwise and 1e-2/2e-5 as a relative norm, l and m (f32 in both)
    at 2e-5 (chip_smoke.py runs the full case list). q and k of std 2
    peak the softmax so |o| is near 1 and the bf16 rule can see a fault."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator().manual_seed(2)
    for dtype, tol, rel in ((torch.bfloat16, 2e-2, 1e-2),
                            (torch.float32, 2e-5, 2e-5)):
        for causal, window in ((False, None), (True, None), (True, 33),
                               (False, 33)):
            q, k, v = ((torch.randn((2, 4, 200, 64), generator=gen) * std)
                       .to("cuda", dtype) for std in (2.0, 2.0, 1.0))
            before = flash_attention.launches
            o, l, m = flash_attention.flash_attention_fwd(
                q, k, v, causal=causal, window=window)
            assert flash_attention.launches == before + 1
            wo, wl, wm = flash_attention.flash_attention_plain(
                q, k, v, causal, window, residuals=True)
            torch.testing.assert_close(o.float(), wo.float(), atol=tol,
                                       rtol=tol)
            err = (o.double() - wo.double()).norm() / wo.double().norm()
            assert float(err) <= rel
            for g, w in ((l, wl), (m, wm)):
                torch.testing.assert_close(g, w, atol=2e-5, rtol=2e-5)
