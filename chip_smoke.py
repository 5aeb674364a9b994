#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of tensor_stream_torch from the sources in this
checkout (one nvcc per source, all at once), holds each against its plain
torch version on the card, drives the port's main paths and times the
kernels:

* the headline FrameLoader: 1080p H.264 -> native decode -> host resize
  to 224x224 -> one pinned H2D copy per batch of 128 -> NV12->RGB planar
  f32 on the card (the nv12_rgb kernel); and the same loader with the
  resize on the card (1080p NV12 -> BILINEAR, BICUBIC or AREA -> 224²:
  the resize_nv12 kernels, each first held byte for byte against its
  plain version at the reference's CRC geometries, crops included, and
  AREA-down at geometries that exercise its plan, whose candidate plans
  are also timed against each other);
* clip augmentation: bench.py::bench_device_augment's configuration
  (16 clips of 8 frames of 224², RandomResizedCrop, flip, ColorJitter,
  normalize), from 224² frames and from 1080p through the device
  resize, as one CUDA graph a batch, bit-equal to the eager run;
* serving: two streams of 224x224 NV12 frames -> MultiStreamLoader ->
  StreamInferencer, one 16-frame clip a stream a tick, into a VideoViT at
  ViT-B width (dim 768, depth 12, 12 heads, patch 16, tubelet 2, joint
  space-time attention over 1568 tokens, bf16) whose every attention runs
  the flash_fwd kernel: eagerly, through cuda_graph, and fused
  (pipeline="fused": a SyntheticPool's VPP and the model one CUDA graph a
  tick), the graphed logits bit-equal to the eager ones at every tick;
* pooled: bench.py::bench_serving's configuration (two streams, 8 frames
  of 224² RGB merged u8 a stream a tick, inflight 2, the mean model)
  per-stream, pooled and fused, frames and means bit-equal to the
  per-stream engine's, one NV12 launch a pooled tick;
* streaming: the same two streams, one tubelet of 2 frames a stream a
  tick, through StreamInferencer(carry=...) into stream_step, the causal
  VideoViT of bench.py's stateful serving benchmark (dim 384, depth 4, 6
  heads, MHA and GQA with 2 kv heads, a ring KV cache of 16 steps),
  eagerly and through cuda_graph(..., carry=True), bit-equal at every
  tick past the ring's wrap, and held against its windowed causal batch
  twin, whose spatial and temporal attention run the flash_fwd kernel in
  its full and band modes;
* training: bench.py's joint training configurations (ViT-B width, 16
  frames, B=4 at 224² and B=1 at 448² with remat) through init_vit and
  make_vit_train_step with SGD, flash and materialized attention, every
  flash attention's gradient from the flash_bwd kernel; the step replayed
  as a CUDA graph, bit-equal to the eager step in every loss and
  parameter;
* the model layer: latent_video_generation.py's pipeline (seeded 1080p
  NV12 through the clip path's device program, the BILINEAR resize
  kernel and NV12->RGB, to 4 clips of 8 frames of 256²; VideoVAE and
  VideoDiT at their module defaults trained with Adam through their
  graphed steps, the DiT unconditionally and class-conditionally; DDIM
  sampling of 25 steps, with guidance, as one CUDA graph; the decoder),
  VideoMoE's graphed training step, TransformerNet styling two streams
  through MultiStreamLoader, and the ViT-B serving model with int8
  weights dequantized inside its graph. Every graphed step and sampler
  is bit-equal to its eager twin.

A graph replay adds to the kernels' launch counts what its capture
recorded (tensor_stream_torch/graphs.py), so every path's counts stay
checkable under replay.

Prints one JSON object per phase, then the "kernels" line, then the
card's name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}. Any failure exits non-zero before the last
line. Needs one CUDA device; imports nothing of JAX.

Where the machine cannot build the native decoder (libtsingest.so needs
FFmpeg's development libraries), the main-path phase says so on a line
of its own and drives the same FrameLoader staging, copy, event rotation
and batched VPP from seeded NV12 frames of the same shape instead; the
serving paths always run on seeded NV12 (SyntheticFrameLoader,
SyntheticPool).

To time another checkout's kernels against this one's on the same card
(for example the parent commit, unpacked with git archive into dist/),
in alternating processes:

    python3 -c "import chip_smoke as c; c.nv12_ab('dist/parent')"
    python3 -c "import chip_smoke as c; c.flash_ab('dist/parent')"
    python3 -c "import chip_smoke as c; c.flash_bwd_ab('dist/parent')"
    python3 -c "import chip_smoke as c; c.resize_ab('dist/parent')"

and the AREA-down kernel whole and in parts (staging only, blend only,
the launch floor), each a copy of its source with one part cut out:

    python3 -c "import chip_smoke as c; c.area_split()"
"""
import contextlib
import ctypes
import inspect
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np
import torch
from torch.func import functional_call
from torch.utils._python_dispatch import TorchDispatchMode

from tensor_stream_torch import _build, _native, serving
from tensor_stream_torch._device import staging_buffer
from tensor_stream_torch.data import (FrameLoader, MultiStreamLoader,
                                      PooledStreamLoader)
from tensor_stream_torch.enums import FourCC, FrameRate, Planes, ResizeType
from tensor_stream_torch.graphs import CudaGraph, cuda_graph
from tensor_stream_torch.models import (
    DiffusionSchedule, TransformerNet, VideoDiT, VideoMoE, VideoVAE, VideoViT,
    clone_cache, dequantize_weights, init_stream_cache, init_vit,
    make_conditional_diffusion_train_step, make_ddim_sampler,
    make_diffusion_train_step, make_moe_train_step, make_vae_train_step,
    make_vit_train_step, moe_loss, quantization_error, quantize_weights,
    quantized_bytes, stream_step)
from tensor_stream_torch.models.moe import MoEMLP
from tensor_stream_torch.ops import flash_attention as fa
from tensor_stream_torch.ops import nv12_rgb
from tensor_stream_torch.ops import resize as resize_ops
from tensor_stream_torch.ops.augment import AugmentConfig, sample_clip_params
from tensor_stream_torch.ops.crop import crop_nv12
from tensor_stream_torch.ops.metrics import psnr, ssim
from tensor_stream_torch.serving import StreamInferencer
from tensor_stream_torch.ops.vpp import (VPPConfig, build_vpp,
                                         build_vpp_batched_flat,
                                         build_vpp_clip_augment)
from tensor_stream_torch.tensor_stream import (FrameParameters,
                                               TensorStreamConverter)

HERE = os.path.dirname(os.path.abspath(__file__))
HEADLINE = os.path.join(HERE, "tests", "fixtures",
                        "bench_1920x1080_gop25_200.h264")
HEADLINE_FRAMES = 200
READ_FIXTURE = os.path.join(HERE, "tests", "fixtures",
                            "bbb_720x480_RGB24_250.h264")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989.4e12  # dense tensor cores, the same sheet (SXM5)
F32_FLOP_PER_S = 67e12     # outside the tensor cores
BATCH = 128
SIDE = 224
# Kernel-vs-plain shapes: the headline batch, one 1080p frame and frames
# of 226 rows, whose last band of 113 row pairs is shorter than the others
# (the vector variant), a ragged width that is not a multiple of 4, and a
# batch whose flat staging puts the UV plane off a 16-byte boundary
# (3*10*326 = 9780 bytes of Y) with W % 16 != 0 (the edge variant, on both
# counts).
CHECK_SHAPES = ((BATCH, SIDE, SIDE), (1, 1080, 1920), (2, 226, SIDE),
                (4, 240, 322), (3, 10, 326))
# Timed NV12 conversions, (n, h, w, planar, normalization): the headline
# loader's batch, one 1080p frame merged u8, one serving stream's clip and
# one streaming stream's tubelet, merged f32.
NV12_TIMED = ((BATCH, SIDE, SIDE, True, True), (1, 1080, 1920, False, False),
              (16, SIDE, SIDE, False, True), (2, SIDE, SIDE, False, True))
STEADY_BATCHES = 40

# Serving: ViT-B width with joint space-time attention (bench.py's flash
# configuration), two streams, one 16-frame clip a stream a tick.
VIT = dict(num_classes=1000, depth=12, dim=768, num_heads=12, patch=16,
           tubelet_t=2, hidden_mult=4, attention="joint", use_flash=True,
           frames=16, size=SIDE)
STREAMS = 2
CLIP = 16
WARMUP_TICKS = 2
TIMED_TICKS = 24
FLASH_HEADLINE = (2, 12, 1568, 64)  # B, H, S = 8*196 tokens, d
# Kernel against plain, as tests/test_flash_attention.py on the CPU: bf16
# outputs quantize to 8 mantissa bits and the two round P at different
# points; f32 differs only in reduction order. That rule holds o
# elementwise; l and m are f32 in both, so they are held at the f32 rule
# whatever the input dtype.
FLASH_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
# o as a whole: ||got - want|| / ||want||. A bf16 kernel with the right
# numerics lands near 3e-3 (each output rounds to 8 bits, P rounds at a
# different point); one that drops a kv tile of 25 or loses a few P
# columns in P@V lands far above 1e-2 (tests/test_torch_flash.py emulates
# all three on the CPU at S=1568 under this rule).
FLASH_O_REL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}
# Inputs: q and k of std 2 give logits of std 4, so each row's softmax is
# peaked and |o| is about 0.4 (v of std 1). At std 0.5 the softmax over
# 1568 keys is nearly flat, |o| is about 0.01 and the bf16 rule's 2e-2
# would pass a wrong P@V.
FLASH_QK_STD, FLASH_V_STD = 2.0, 1.0
# Serving logits, flash kernel against the plain attention, as a share of
# the largest plain logit (the reasons are at their use in phase_serving;
# on an H100 the errors measured were 0.11% and 2.4e-7 of that scale).
BF16_LOGIT_REL = 1e-2
F32_LOGIT_REL = 1e-5

# Streaming: bench.py's stateful serving configuration (bench.py:529-548),
# nothing cut: a causal VideoViT of depth 4, dim 384, 6 heads (MHA, or GQA
# with 2 kv heads), 400 classes, bf16 compute; a ring of 16 steps, the
# positional extent of 32 frames; two streams of one tubelet (2 frames of
# 224²) a tick, inflight 2. 8 warm-up ticks and 48 timed take t to 56, so
# the ring wraps and the positional clamp bites on the card. Each model is
# served twice, in the order MHA, GQA, GQA, MHA, so that the order of the
# runs does not bias their throughput ratio.
STREAM_VIT = dict(num_classes=400, depth=4, dim=384, num_heads=6, patch=16,
                  tubelet_t=2, causal=True, frames=32, size=SIDE)
STREAM_KV = {"mha": None, "gqa": 2}
STREAM_ORDER = ("mha", "gqa", "gqa", "mha")
TUBELET = STREAM_VIT["tubelet_t"]
STREAM_RING = 16
STREAM_WARMUP_TICKS = 8
STREAM_TIMED_TICKS = 48
STREAM_INFLIGHT = 2
# The twin check: a ring of 8 steps fed 16 steps against VideoViT(...,
# temporal_window=8, use_flash=True) over the same 32 frames a stream.
TWIN_RING = 8
TWIN_STEPS = 16


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def seeded_nv12(n, h, w, seed):
    """Flat NV12 staging bytes: n Y planes, then n UV planes."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, n * h * w * 3 // 2, dtype=np.uint8)


def split(flat, n, h, w):
    y_size = n * h * w
    return flat[:y_size].view(n, h, w), flat[y_size:].view(n, h // 2, w)


def bitwise_equal(a, b):
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(a, b):
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def kernel_bytes(n, h, w, normalization):
    """Bytes the conversion must move: NV12 in once, RGB out once."""
    return n * h * w * (1.5 + (12 if normalization else 3))


# ----------------------------------------------------------------- phases

def phase_env():
    smi = nvidia_smi()
    t0 = time.monotonic()
    built = _build.build_all()
    build_s = time.monotonic() - t0
    ptxas = []
    for name in _build.SOURCES:
        with open(_build.log_path(name)) as f:
            ptxas += [ln.strip() for ln in f
                      if any(w in ln for w in ("registers", "spill",
                                               "Performance"))]
    emit({"phase": "env", "nvidia_smi": smi, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_s": round(build_s, 3), "built": sorted(built),
          "ptxas": ptxas})
    return smi


def phase_kernel_vs_plain(device):
    """Every {RGB24, BGR24} x {planar, merged} x {u8, f32} x standard, at
    each check shape: the kernel must equal the plain version bit for bit
    on the same CUDA tensors, and both variants must have run."""
    worst = 0.0
    cases = 0
    variants = []
    for shape_i, (n, h, w) in enumerate(CHECK_SHAPES):
        flat = torch.from_numpy(seeded_nv12(n, h, w, 100 + shape_i)).to(device)
        y, uv = split(flat, n, h, w)
        ran = set()
        for swap_rb in (False, True):
            for planar in (True, False):
                for norm in (False, True):
                    for standard in range(4):
                        before = dict(nv12_rgb.launches_by_variant)
                        got = nv12_rgb.nv12_to_rgb(y, uv, swap_rb, planar,
                                                   norm, standard)
                        went = {v: nv12_rgb.launches_by_variant[v] - n0
                                for v, n0 in before.items()}
                        if sorted(went.values()) != [0, 1]:
                            raise AssertionError("kernel did not launch")
                        ran.add(max(went, key=went.get))
                        want = nv12_rgb.nv12_to_rgb_plain(
                            y, uv, swap_rb, planar, norm, standard)
                        torch.cuda.synchronize()
                        err = max_abs_err(got, want)
                        worst = max(worst, err)
                        if not bitwise_equal(got, want):
                            raise AssertionError(
                                f"kernel != plain at N={n} {h}x{w} "
                                f"swap_rb={swap_rb} planar={planar} "
                                f"norm={norm} standard={standard}: max abs "
                                f"err {err}")
                        cases += 1
        variants.append(sorted(ran))
    emit({"phase": "kernel_vs_plain", "kernel": "nv12_rgb", "cases": cases,
          "shapes": [list(s) for s in CHECK_SHAPES], "variants": variants,
          "tolerance": "bitwise", "max_abs_err": worst})
    if {v for ran in variants for v in ran} != set(nv12_rgb.VARIANTS):
        raise AssertionError(f"variants run {variants}: each of "
                             f"{nv12_rgb.VARIANTS} must run")
    return worst


def seeded_frames(seed, h, w, count):
    """`count` seeded NV12 frames: Y [count, h, w] and UV [count, h/2, w]."""
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, 256, (count, h, w), np.uint8)
    return ys, rng.integers(0, 256, (count, h // 2, w), np.uint8)


class SyntheticFrameLoader(FrameLoader):
    """The FrameLoader with its native drain replaced by seeded NV12
    frames: the same pinned staging pool, one non_blocking copy per
    batch, batched VPP and event rotation (FrameLoader._next_async /
    _recycle), fed without a decoder."""

    POOL = 16  # distinct seeded frames, cycled

    def __init__(self, total, batch, prefetch, cfg, device, seed=7):
        self.device = device
        self.device_index = device.index or 0
        self.batch = batch
        self.prefetch = prefetch
        self.host_resize = False
        self.drop_partial = False
        self.augment = None
        self.stream_url = f"synthetic:{seed}"
        self.reader = None
        self._segmented = None
        self._next_index = 1
        self._cfg = cfg
        self._w, self._h = cfg.src_width, cfg.src_height
        self._ys, self._uvs = seeded_frames(seed, self._h, self._w, self.POOL)
        self._total = total
        self._cursor = 0
        self._start_common()

    def staging_bytes(self, first, got):
        """The staging buffer the drain writes for frames first..first+got-1."""
        ids = [(first - 1 + k) % self.POOL for k in range(got)]
        pad = self.batch - got
        ys = np.concatenate([self._ys[ids], np.zeros((pad, self._h, self._w),
                                                     np.uint8)])
        uvs = np.concatenate([self._uvs[ids],
                              np.zeros((pad, self._h // 2, self._w), np.uint8)])
        return np.concatenate([ys.reshape(-1), uvs.reshape(-1)])

    def _fill_batch(self, buf):
        if self._cursor >= self._total:
            return 0, 0
        got = min(self.batch, self._total - self._cursor)
        first = self._cursor + 1
        dst = buf.numpy()
        y_size = self.batch * self._h * self._w
        ys = dst[:y_size].reshape(self.batch, self._h, self._w)
        uvs = dst[y_size:].reshape(self.batch, self._h // 2, self._w)
        ids = (first - 1 + np.arange(got)) % self.POOL
        ys[:got] = self._ys[ids]
        uvs[:got] = self._uvs[ids]
        self._cursor += got
        return got, first

    def close(self):
        if self._stop.is_set():
            return
        self._stop.set()
        while self._pending:
            self._recycle(*self._pending.popleft())
        self._pool.put(None)
        self._drain_unblock()
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            raise RuntimeError("synthetic drain thread did not stop")


def headline_kwargs():
    return dict(batch=BATCH, prefetch=3, host_resize=True, width=SIDE,
                height=SIDE, pixel_format=FourCC.RGB24,
                planes_pos=Planes.PLANAR, normalization=True)


def check_batch(x, got, device):
    want_shape = (got, 3, SIDE, SIDE)
    if (tuple(x.shape) != want_shape or x.dtype != torch.float32
            or x.device != device):
        raise AssertionError(f"batch {tuple(x.shape)} {x.dtype} on "
                             f"{x.device}; want {want_shape} float32 on "
                             f"{device}")
    if not bool(torch.isfinite(x).all()):
        raise AssertionError("non-finite values in a batch")


def drive_loader(loader, device):
    """Iterates `loader` to its end with the kernel's counts at 0; returns
    (first batch on the host, batches, frames, seconds, launches), where
    launches is {"total": n, "vector": n, "edge": n}."""
    nv12_rgb.reset_counts()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    first = None
    batches = frames = 0
    for x, idx in loader:
        check_batch(x, len(idx), device)
        if first is None:
            first = (x.cpu(), idx)
        batches += 1
        frames += len(idx)
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {"total": nv12_rgb.launches, **nv12_rgb.launches_by_variant}
    loader.close()
    if launches["total"] != batches:
        raise AssertionError(f"{launches} kernel launches for {batches} "
                             "batches: the main path bypassed the kernel")
    return first, batches, frames, seconds, launches


def phase_main_path_decoded(device):
    first, batches, frames, seconds, launches = drive_loader(
        FrameLoader(HEADLINE, device=device, **headline_kwargs()), device)
    if frames != HEADLINE_FRAMES:
        raise AssertionError(f"{frames} frames, want {HEADLINE_FRAMES}")
    # The same first batch through the plain version on the CPU (the
    # decode and host resize are deterministic, so the staging bytes are
    # the same).
    cpu = FrameLoader(HEADLINE, device="cpu", **headline_kwargs())
    try:
        want, want_idx = next(cpu)
    finally:
        cpu.close()
    if want_idx != first[1] or not bitwise_equal(first[0], want):
        raise AssertionError("first headline batch differs from the CPU "
                             "plain run")
    reads = []
    for label, kw in (
            ("merged_u8", dict(pixel_format=FourCC.RGB24,
                               planes_pos=Planes.MERGED)),
            ("planar_f32", dict(pixel_format=FourCC.RGB24,
                                planes_pos=Planes.PLANAR,
                                normalization=True)),
            ("crop_nearest", dict(pixel_format=FourCC.BGR24,
                                  crop_coords=(40, 20, 680, 460),
                                  width=320, height=224))):
        outs = {}
        for key, dev in (("card", device), ("cpu", torch.device("cpu"))):
            r = TensorStreamConverter(READ_FIXTURE, device=dev,
                                      framerate_mode=FrameRate.BLOCKING)
            r.initialize()
            r.start()
            try:
                before = nv12_rgb.launches
                t, index = r.read(return_index=True, **kw)
                outs[key] = (t.cpu(), index,
                                  nv12_rgb.launches - before)
            finally:
                r.stop()
        (g, gi, launched), (c, ci, _) = outs["card"], outs["cpu"]
        if gi != ci or not bitwise_equal(g, c):
            raise AssertionError(f"read {label}: card differs from CPU")
        reads.append({"read": label, "shape": list(g.shape),
                      "dtype": str(g.dtype), "kernel_launches": launched})
    emit({"phase": "main_path", "decode": "native", "batches": batches,
          "frames": frames, "seconds": seconds,
          "frames_per_s": frames / seconds, "kernel_launches": launches,
          "first_batch": "bitwise equal to the CPU plain run",
          "reads": reads})
    return batches, frames, seconds, launches


def phase_main_path_synthetic(device, why):
    emit({"phase": "main_path", "decode": "unavailable", "why": why})
    cfg = FrameParameters(pixel_format=FourCC.RGB24,
                          planes_pos=Planes.PLANAR,
                          normalization=True).to_config(SIDE, SIDE)
    loader = SyntheticFrameLoader(HEADLINE_FRAMES, BATCH, 3, cfg, device)
    first, batches, frames, seconds, launches = drive_loader(loader, device)
    (x, idx) = first
    staging = torch.from_numpy(loader.staging_bytes(idx[0], len(idx)))
    want = build_vpp_batched_flat(cfg, BATCH, "cpu")(staging)[:len(idx)]
    if not bitwise_equal(x, want):
        raise AssertionError("first batch differs from the CPU plain run "
                             "on the same staging bytes")
    # The three read() configs of the 720x480 fixture, through build_vpp
    # on seeded frames of that size: card against CPU.
    reads = []
    h, w = 480, 720
    flat = torch.from_numpy(seeded_nv12(1, h, w, 11))
    for label, kw in (
            ("merged_u8", dict(pixel_format=FourCC.RGB24,
                               planes_pos=Planes.MERGED)),
            ("planar_f32", dict(pixel_format=FourCC.RGB24,
                                planes_pos=Planes.PLANAR,
                                normalization=True)),
            ("crop_nearest", dict(pixel_format=FourCC.BGR24,
                                  crop_coords=(40, 20, 680, 460),
                                  width=320, height=224))):
        rcfg = FrameParameters(**kw).to_config(w, h)
        y, uv = split(flat, 1, h, w)
        before = nv12_rgb.launches
        g = build_vpp(rcfg, device)(y[0], uv[0]).cpu()
        launched = nv12_rgb.launches - before
        c = build_vpp(rcfg, "cpu")(y[0], uv[0])
        if not bitwise_equal(g, c):
            raise AssertionError(f"read config {label}: card differs from CPU")
        reads.append({"read": label, "shape": list(g.shape),
                      "dtype": str(g.dtype), "kernel_launches": launched})
    emit({"phase": "main_path", "decode": "synthetic", "batches": batches,
          "frames": frames, "seconds": seconds,
          "frames_per_s": frames / seconds, "kernel_launches": launches,
          "first_batch": "bitwise equal to the CPU plain run",
          "reads": reads})
    return batches, frames, seconds, launches


HOLD_CYCLES = 1_000_000  # about 0.5 ms of an H100's SM clock


def time_ms(fn, device, iters=100, warmup=20, hold=True):
    """Per-call ms over `iters` calls after `warmup`: (median, p10, p90).
    CUDA events around each call, with L2 (50 MB) flushed before each so
    the inputs come from HBM as they do after the H2D copy of a batch.
    With `hold`, a spin kernel keeps the card busy while the host enqueues
    the call, so the events bracket the device's time alone and not the
    host's (Python, ctypes, the tensor-map encoding); without it a call
    whose host work is slower than the device is timed at the host's
    pace."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    p10, p50, p90 = np.percentile(times, [10, 50, 90])
    return float(p50), float(p10), float(p90)


def phase_times(device, smi, main):
    """The kernel at NV12_TIMED beside its byte bound, its plain version
    and the write floor: out.zero_() on an output of the same shape and
    type, the practical floor of the writes alone (not a library call for
    this function)."""
    rows = []
    for (n, h, w, planar, norm) in NV12_TIMED:
        flat = torch.from_numpy(seeded_nv12(n, h, w, 5)).to(device)
        y, uv = split(flat, n, h, w)
        out = nv12_rgb.nv12_to_rgb(y, uv, False, planar, norm, 0)
        which = nv12_rgb.variant(h, w, y.data_ptr(), uv.data_ptr(),
                                 out.data_ptr())
        ms, p10, p90 = time_ms(lambda: nv12_rgb.nv12_to_rgb(
            y, uv, False, planar, norm, 0), device)
        plain_ms = time_ms(lambda: nv12_rgb.nv12_to_rgb_plain(
            y, uv, False, planar, norm, 0), device, iters=30, warmup=5)[0]
        floor_ms = time_ms(out.zero_, device)[0]
        nbytes = kernel_bytes(n, h, w, norm)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"shape": [n, h, w], "layout": "planar" if planar
                     else "merged", "dtype": "f32" if norm else "u8",
                     "variant": which, "ms": ms, "p10_ms": p10,
                     "p90_ms": p90, "plain_ms": plain_ms,
                     "write_floor_ms": floor_ms,
                     "bytes": nbytes, "bound_ms": bound_ms,
                     "bound_by": "bytes", "share_of_bound": bound_ms / ms})
    batches, frames, seconds, _ = main
    # Steady state of the device half alone (staging fill from memory,
    # H2D, VPP, event rotation), over more batches than the fixture has.
    cfg = FrameParameters(pixel_format=FourCC.RGB24, planes_pos=Planes.PLANAR,
                          normalization=True).to_config(SIDE, SIDE)
    _, s_batches, s_frames, s_seconds, _ = drive_loader(SyntheticFrameLoader(
        STEADY_BATCHES * BATCH, BATCH, 3, cfg, device, seed=9), device)
    emit({"phase": "times", "card": smi, "kernel": rows,
          "main_path_frames_per_s": frames / seconds,
          "main_path_seconds": seconds,
          "vpp_share_of_main_path": batches * rows[0]["ms"] / 1e3 / seconds,
          "steady_batches": s_batches,
          "steady_frames_per_s": s_frames / s_seconds,
          "steady_ms_per_batch": s_seconds / s_batches * 1e3,
          "vpp_share_of_steady": rows[0]["ms"] * s_batches / 1e3 / s_seconds,
          "library_ms": None,
          "library_note": "no single PyTorch call computes NV12->RGB"})
    return rows


# ------------------------------------------------- resize and clip phases

RESIZE_ALGOS = (ResizeType.BILINEAR, ResizeType.BICUBIC, ResizeType.AREA)
# tests/test_resize_crc.py:37-95, the reference's 19 CRC cases on a 1080x608
# frame, as (crop, width, height): 8 distinct geometries, each run through
# all three kernels (the crops are strided views the kernels read in place).
RESIZE_SRC = (1080, 608)
RESIZE_CRC_GEOMETRIES = (
    (None, 480, 360), (None, 540, 304), (None, 1920, 1080),
    (None, 720, 480), ((0, 0, 320, 240), 1920, 1080),
    ((320, 240, 720, 480), 1920, 1080), ((720, 480, 1080, 608), 1920, 1080),
    ((120, 60, 960, 540), 320, 240))
# tests/test_resize_crc.py:179-180: up, down and anisotropic, non-dyadic.
RESIZE_FUZZ = (((64, 48), (52, 36)), ((64, 48), (100, 76)),
               ((100, 76), (64, 18)), ((56, 34), (146, 108)))
RESIZE_CONTENTS = ("random", "flat", "checker", "ramp")
HEADLINE_SRC = (1920, 1080)
# AREA-down geometries that exercise its plan (ops/resize.py area_plan), as
# (frames, source, crop, target): the table variant (30 column taps), a crop
# whose rows start off 16-byte alignment, a width that is no multiple of
# the column tile (two tiles of 160), and a batch of crops read through
# the batch stride.
AREA_PLAN_GEOMETRIES = ((1, HEADLINE_SRC, None, (64, 36)),
                        (1, RESIZE_SRC, (6, 2, 966, 542), (200, 120)),
                        (1, RESIZE_SRC, None, (300, 170)),
                        (3, RESIZE_SRC, (100, 50, 1000, 590), (224, 224)))
RESIZED_BATCHES = 6
# bench.py::bench_device_augment (bench.py:284-320): 16 clips of 8 frames of
# 224² RGB24 planar, normalized, with this AugmentConfig.
AUG_CLIPS, AUG_CLIP_LEN = 16, 8
BENCH_AUG = AugmentConfig(width=SIDE, height=SIDE, scale=(0.3, 1.0),
                          ratio=(0.75, 4 / 3), hflip=0.5, brightness=0.4,
                          contrast=0.4, saturation=0.4, hue=0.05,
                          mean=(0.45, 0.45, 0.45), std=(0.225, 0.225, 0.225))
AUG_CALLS = 8  # a warm-up, a capture and 6 replays
F64_FLOP_PER_S = 34e12  # H100 SXM FP64 outside the tensor cores (data sheet)


def resize_content(content, n, h, w, seed):
    """Flat NV12 staging of n frames: uniform random bytes, a flat field, a
    0/255 checker or ramps. Flat and half-tone fields put the most outputs
    on the rounding boundaries of the bicubic and AREA blends."""
    if content == "random":
        return seeded_nv12(n, h, w, seed)
    i, j = np.mgrid[:h, :w]
    ci, cj = np.mgrid[:h // 2, :w]
    if content == "flat":
        y, uv = np.full((h, w), 77), np.full((h // 2, w), 160)
    elif content == "checker":
        y, uv = (i + j) % 2 * 255, (ci + cj // 2) % 2 * 255
    else:
        y, uv = (i + j) % 256, (3 * cj + ci) % 256
    y = np.broadcast_to(y.astype(np.uint8), (n, h, w))
    uv = np.broadcast_to(uv.astype(np.uint8), (n, h // 2, w))
    return np.concatenate([y.reshape(-1), uv.reshape(-1)])


def area_variant_launched(before):
    """The AREA-down variant launched since the counts were `before`."""
    ran = [k for k, v in resize_ops.area_launches_by_variant.items()
           if v != before[k]]
    return ran[0] if len(ran) == 1 else None


def check_resize(device, flat, n, h, w, crop, dw, dh, algo):
    """One kernel launch against the plain version on the same CUDA
    planes: (kernel, AREA-down variant or None, differing bytes, max abs
    difference)."""
    y, uv = split(flat, n, h, w)
    sw, sh = w, h
    if crop is not None:
        y, uv = crop_nv12(y, uv, *crop)
        sw, sh = crop[2] - crop[0], crop[3] - crop[1]
    r = resize_ops.NV12Resize(sw, sh, dw, dh, algo)
    before = resize_ops.launches[r.kernel]
    variants = dict(resize_ops.area_launches_by_variant)
    gy, guv = r(y, uv)
    if resize_ops.launches[r.kernel] != before + 1:
        raise AssertionError(f"{r.kernel} did not launch")
    variant = area_variant_launched(variants)
    if (variant is None) != (r.kernel != "resize_area_down_nv12"):
        raise AssertionError(f"{r.kernel}: AREA variants launched "
                             f"{resize_ops.area_launches_by_variant}")
    wy, wuv = r.plain(y, uv)
    torch.cuda.synchronize()
    bad = int((gy != wy).sum()) + int((guv != wuv).sum())
    return (r.kernel, variant, bad,
            max(max_abs_err(gy, wy), max_abs_err(guv, wuv)))


def phase_resize_vs_plain(device):
    """Each resize kernel against its plain version on the card, byte for
    byte: the 19 CRC geometries (crops included) and the 4 fuzz
    geometries in four contents, and the main path's batch (N=128,
    1920x1080 -> 224²) in two; every algorithm at every geometry. AREA
    also at AREA_PLAN_GEOMETRIES in four contents; both of its variants
    must run."""
    worst = dict.fromkeys(resize_ops.KERNELS, 0.0)
    cases = dict.fromkeys(resize_ops.KERNELS, 0)
    area_cases = dict.fromkeys(resize_ops.AREA_VARIANTS, 0)
    failures = []

    def run_all(flat, n, h, w, crop, dw, dh, label, algos=RESIZE_ALGOS):
        for algo in algos:
            kernel, variant, bad, err = check_resize(device, flat, n, h, w,
                                                     crop, dw, dh, algo)
            cases[kernel] += 1
            if variant is not None:
                area_cases[variant] += 1
            worst[kernel] = max(worst[kernel], err)
            if bad:
                failures.append(f"{kernel} ({algo.name}, {variant}) {label}: "
                                f"{bad} bytes differ")

    sw, sh = RESIZE_SRC
    for k, content in enumerate(RESIZE_CONTENTS):
        flat = torch.from_numpy(resize_content(content, 1, sh, sw,
                                               60 + k)).to(device)
        for crop, dw, dh in RESIZE_CRC_GEOMETRIES:
            run_all(flat, 1, sh, sw, crop, dw, dh,
                    f"{content} {sw}x{sh} crop {crop} -> {dw}x{dh}")
        for (fw, fh), (dw, dh) in RESIZE_FUZZ:
            fflat = torch.from_numpy(resize_content(content, 2, fh, fw,
                                                    70 + k)).to(device)
            run_all(fflat, 2, fh, fw, None, dw, dh,
                    f"{content} N=2 {fw}x{fh} -> {dw}x{dh}")
        for frames, (aw, ah), crop, (dw, dh) in AREA_PLAN_GEOMETRIES:
            aflat = torch.from_numpy(resize_content(content, frames, ah, aw,
                                                    75 + k)).to(device)
            run_all(aflat, frames, ah, aw, crop, dw, dh,
                    f"{content} N={frames} {aw}x{ah} crop {crop} -> "
                    f"{dw}x{dh}", algos=(ResizeType.AREA,))
    hw, hh = HEADLINE_SRC
    for k, content in enumerate(("random", "flat")):
        flat = torch.from_numpy(resize_content(content, BATCH, hh, hw,
                                               80 + k)).to(device)
        run_all(flat, BATCH, hh, hw, None, SIDE, SIDE,
                f"{content} N={BATCH} {hw}x{hh} -> {SIDE}x{SIDE}")
        del flat
    emit({"phase": "resize_vs_plain", "cases": cases,
          "geometries": {"crc": [list(g) for g in RESIZE_CRC_GEOMETRIES],
                         "fuzz": [list(g) for g in RESIZE_FUZZ],
                         "area_plan": [[f, list(src), crop, list(dst)]
                                       for f, src, crop, dst in
                                       AREA_PLAN_GEOMETRIES],
                         "main_path": [BATCH, hw, hh, SIDE, SIDE]},
          "area_cases_by_variant": area_cases,
          "contents": list(RESIZE_CONTENTS), "tolerance": "0 bytes",
          "differing_cases": len(failures), "max_abs_err": worst})
    if failures:
        raise AssertionError("resize kernel != plain: "
                             + "; ".join(failures[:8]))
    if not all(area_cases.values()):
        raise AssertionError(f"an AREA-down variant never ran: {area_cases}")
    return worst


def resized_cfg(algo):
    """The headline loader with the resize on the card."""
    return FrameParameters(width=SIDE, height=SIDE, resize_type=algo,
                           pixel_format=FourCC.RGB24,
                           planes_pos=Planes.PLANAR,
                           normalization=True).to_config(*HEADLINE_SRC)


def resize_counts():
    return {"nv12_rgb": nv12_rgb.launches, **resize_ops.launches}


def reset_resize_counts():
    nv12_rgb.reset_counts()
    resize_ops.reset_counts()


def phase_resized_main_path(device, smi, main):
    """The headline loader with the resize moved onto the card:
    SyntheticFrameLoader, seeded 1080p NV12, batches of 128, device
    resize to 224², RGB24 planar normalized, once per algorithm. Each
    batch is one resize launch and one NV12 launch; the first batch is
    bit-equal to the plain versions on the card on the same staging
    bytes."""
    hw, hh = HEADLINE_SRC
    runs = {}
    for algo in RESIZE_ALGOS:
        cfg = resized_cfg(algo)
        kernel = resize_ops.NV12Resize(hw, hh, SIDE, SIDE, algo).kernel
        loader = SyntheticFrameLoader(RESIZED_BATCHES * BATCH, BATCH, 3, cfg,
                                      device, seed=13)
        reset_resize_counts()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        first = None
        batches = frames = 0
        for x, idx in loader:
            check_batch(x, len(idx), device)
            if first is None:
                first = (x, idx)
            batches += 1
            frames += len(idx)
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = resize_counts()
        by_variant = dict(resize_ops.area_launches_by_variant)
        loader.close()
        want = {"nv12_rgb": batches, **dict.fromkeys(resize_ops.KERNELS, 0),
                kernel: batches}
        if launches != want:
            raise AssertionError(f"resized main path {algo.name}: launches "
                                 f"{launches}, want {want}")
        x, idx = first
        staging = torch.from_numpy(loader.staging_bytes(idx[0],
                                                        len(idx))).to(device)
        y, uv = split(staging, BATCH, hh, hw)
        py, puv = resize_ops.NV12Resize(hw, hh, SIDE, SIDE, algo).plain(y, uv)
        plain = nv12_rgb.nv12_to_rgb_plain(py, puv, False, True, True, 0)
        if not bitwise_equal(x, plain[:len(idx)]):
            raise AssertionError(f"resized main path {algo.name}: first "
                                 "batch differs from the plain versions")
        vpp = build_vpp_batched_flat(cfg, BATCH, device)
        dev_ms = time_ms(lambda: vpp(staging), device, iters=30, warmup=5)[0]
        if not runs:
            # Where a batch's time goes besides the VPP (the same for every
            # algorithm): the synthetic fill of the pinned staging on the
            # host and its copy to the card.
            buf = staging_buffer(staging.numel(), device)
            loader._cursor = 0
            t0 = time.monotonic()
            loader._fill_batch(buf)
            fill_ms = (time.monotonic() - t0) * 1e3
            copy_ms = time_ms(lambda: staging.copy_(buf, non_blocking=True),
                              device, iters=10, warmup=2)[0]
            del buf
        runs[algo.name] = {
            "kernel": kernel, "batches": batches, "frames": frames,
            "seconds": seconds, "frames_per_s": frames / seconds,
            "ms_per_batch": seconds / batches * 1e3,
            "device_ms_per_batch": dev_ms,
            "launches_per_batch": {k: v / batches
                                   for k, v in launches.items()},
            "launches": launches, "area_launches_by_variant": by_variant,
            "first_batch": "bitwise equal to the plain versions"}
        del loader, staging, y, uv, x, first
    head_fps = main[1] / main[2]
    emit({"phase": "resized_main_path", "card": smi,
          "config": {"batch": BATCH, "source": list(HEADLINE_SRC),
                     "target": [SIDE, SIDE], "host_resize": False,
                     "output": "RGB24 planar f32"},
          "runs": runs, "host_fill_ms_per_batch": fill_ms,
          "h2d_copy_ms_per_batch": copy_ms,
          "host_resize_headline_frames_per_s": head_fps,
          "vs_host_resize_headline": {k: r["frames_per_s"] / head_fps
                                      for k, r in runs.items()}})
    return runs


def aug_cfg(source):
    """(a) bench_device_augment's 224² frames; (b) 1080p frames through
    the device BILINEAR resize to 224², ClipLoader(host_resize=False)'s
    VPP."""
    kw = dict(fourcc=FourCC.RGB24, planes=Planes.PLANAR, normalization=True)
    if source == "224":
        return VPPConfig(src_width=SIDE, src_height=SIDE, **kw)
    return VPPConfig(*HEADLINE_SRC, width=SIDE, height=SIDE,
                     resize_type=ResizeType.BILINEAR, **kw)


def aug_ids(k):
    """Batch k's (epoch, clip identity) rows: clips 16k .. 16k+15."""
    return np.stack([np.zeros(AUG_CLIPS, np.int64),
                     np.arange(AUG_CLIPS) + AUG_CLIPS * k], axis=1)


def repeated_frame_staging(n, h, w, clip_len, seed):
    """Staging whose frames repeat within each clip of clip_len."""
    y, uv = seeded_frames(seed, h, w, n // clip_len)
    y, uv = np.repeat(y, clip_len, axis=0), np.repeat(uv, clip_len, axis=0)
    return np.concatenate([y.reshape(-1), uv.reshape(-1)])


def clip_augment_run(device, source):
    cfg = aug_cfg(source)
    n = AUG_CLIPS * AUG_CLIP_LEN
    h, w = cfg.src_height, cfg.src_width
    flat = torch.from_numpy(seeded_nv12(n, h, w, 41)).to(device)
    fn = build_vpp_clip_augment(cfg, BENCH_AUG, AUG_CLIPS, AUG_CLIP_LEN, 0,
                                device)
    graph = fn.graphed
    reset_resize_counts()
    outs = [fn(flat, aug_ids(k)) for k in range(AUG_CALLS)]
    torch.cuda.synchronize()
    graphed_launches = resize_counts()
    check_replays(graph, AUG_CALLS, f"clip_augment {source}")
    want_shape = (AUG_CLIPS, AUG_CLIP_LEN, 3, SIDE, SIDE)
    for o in outs:
        if tuple(o.shape) != want_shape or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"clip_augment {source}: output "
                                 f"{tuple(o.shape)} or non-finite values")
    reset_resize_counts()
    for k, o in enumerate(outs):
        params = torch.from_numpy(sample_clip_params(
            BENCH_AUG, SIDE, SIDE, 0, aug_ids(k))).to(device)
        if not bitwise_equal(graph.fn(flat, params), o):
            raise AssertionError(f"clip_augment {source}: batch {k}, "
                                 "graphed != eager")
    eager_launches = resize_counts()
    if not bitwise_equal(fn(flat, aug_ids(0)), outs[0]):
        raise AssertionError(f"clip_augment {source}: the same ids gave "
                             "other bytes")
    # The identity config is the plain VPP, bit for bit.
    plain_vpp = build_vpp_batched_flat(cfg, n, device)
    plain = plain_vpp(flat)
    ident = build_vpp_clip_augment(cfg, AugmentConfig(), AUG_CLIPS,
                                   AUG_CLIP_LEN, 0, device)(flat, aug_ids(0))
    if not bitwise_equal(ident, plain.view(want_shape)):
        raise AssertionError(f"clip_augment {source}: identity != plain VPP")
    # One transform a clip: a clip of one repeated frame stays so.
    rep = torch.from_numpy(repeated_frame_staging(n, h, w, AUG_CLIP_LEN,
                                                  43)).to(device)
    out = fn(rep, aug_ids(1))
    if not all(bitwise_equal(out[:, t], out[:, 0])
               for t in range(1, AUG_CLIP_LEN)):
        raise AssertionError(f"clip_augment {source}: the frames of a "
                             "repeated-frame clip differ")
    aug_ms = time_ms(graph.graphs[0].replay, device, iters=50)[0]
    plain_ms = time_ms(lambda: plain_vpp(flat), device, iters=50)[0]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for k in range(20):
        fn(flat, aug_ids(k))
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / 20
    per_call = {k: v / AUG_CALLS for k, v in graphed_launches.items()}
    return {"source": f"{w}x{h}", "config": "bench_device_augment",
            "clips": AUG_CLIPS, "clip_len": AUG_CLIP_LEN,
            "graphed_launches": graphed_launches,
            "eager_launches": eager_launches, "launches_per_batch": per_call,
            "captures": graph.captures, "replays": graph.replays,
            "graphed_vs_eager": f"bitwise equal in all {AUG_CALLS} batches",
            "device_ms_per_batch": aug_ms,
            "device_frames_per_s": n / aug_ms * 1e3,
            "plain_vpp_device_ms": plain_ms,
            "augment_device_ms": aug_ms - plain_ms,
            "wall_ms_per_call": wall * 1e3, "wall_frames_per_s": n / wall}


def phase_clip_augment(device, smi):
    """bench_device_augment's configuration, (a) on 224² frames and (b)
    from 1080p through the device bilinear resize; graphed and eager
    bit-equal; identity = plain VPP; one transform a clip; the same ids
    the same bytes."""
    runs = {src: clip_augment_run(device, src) for src in ("224", "1080p")}
    emit({"phase": "clip_augment", "card": smi,
          "augment": {k: v for k, v in BENCH_AUG.__dict__.items()},
          "runs": runs})
    return runs


# The timed resizes: each kernel at the headline batch and at one frame of
# the upscale 1080x608 -> 1920x1080 (AREA upscales through the bilinear
# kernel, and its own kernel is timed at 1080x608 -> 480x360 instead).
RESIZE_TIMED = (
    (ResizeType.BILINEAR, BATCH, HEADLINE_SRC, (SIDE, SIDE)),
    (ResizeType.BICUBIC, BATCH, HEADLINE_SRC, (SIDE, SIDE)),
    (ResizeType.AREA, BATCH, HEADLINE_SRC, (SIDE, SIDE)),
    (ResizeType.BILINEAR, 1, RESIZE_SRC, (1920, 1080)),
    (ResizeType.BICUBIC, 1, RESIZE_SRC, (1920, 1080)),
    (ResizeType.AREA, 1, RESIZE_SRC, (1920, 1080)),
    (ResizeType.AREA, 1, RESIZE_SRC, (480, 360)))


def resize_work(r, n):
    """(bytes, operations, peak rate) of one launch: the output written once
    plus every 32-byte sector of the source that the taps touch read once
    (frames and planes start 32-byte aligned in the flat staging); float64
    operations for bicubic, float32 otherwise."""
    sw, sh = r.src
    dw, dh = r.dst
    sectors = 0
    for plane, pitch in zip(r.planes, (sw, sw)):
        rows = np.unique(plane["rows"])
        cols = np.unique(plane["cols"])
        addr = rows[:, None] * pitch + cols[None, :]
        sectors += np.unique(addr // 32).size
    outputs = dw * dh * 3 // 2
    if r.kernel == "resize_bicubic_nv12":
        ops, rate = 35, F64_FLOP_PER_S  # 4 x (4 mul + 3 add) + 4 + 3
    elif r.kernel == "resize_bilinear_nv12":
        ops, rate = 13, F32_FLOP_PER_S  # 2 sub, 6 mul, 3 fma (2 each)
    else:
        ops, rate = 4 * r.planes[0]["rows"].shape[1] * \
            r.planes[0]["cols"].shape[1] + 1, F32_FLOP_PER_S
    return n * (sectors * 32 + outputs), n * outputs * ops, rate


def sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def area_plan_row(r, n, device):
    """The AREA-down plan a launch of `n` frames takes, for a result row."""
    return plan_row(r.area_plan(n, sm_count(device)), n)


def plan_row(plan, n):
    return {"variant": plan.variant, "band": plan.band,
            "frames": plan.frames, "tile": plan.tile, "smem": plan.smem,
            "blocks": resize_ops.area_launch_blocks(plan, n)}


def phase_resize_times(device, smi):
    """Each kernel at RESIZE_TIMED beside its bound and its plain version;
    AREA rows name the plan they launched, and at the headline batch the
    time a torch reduction takes to read the same source once."""
    rows = []
    for algo, n, (sw, sh), (dw, dh) in RESIZE_TIMED:
        flat = torch.from_numpy(seeded_nv12(n, sh, sw, 90)).to(device)
        y, uv = split(flat, n, sh, sw)
        r = resize_ops.NV12Resize(sw, sh, dw, dh, algo)
        ms, p10, p90 = time_ms(lambda: r(y, uv), device)
        plain_ms = time_ms(lambda: r.plain(y, uv), device, iters=10,
                           warmup=2)[0]
        nbytes, ops, rate = resize_work(r, n)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / rate * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        rows.append({"kernel": r.kernel, "algo": algo.name,
                     "shape": [n, sw, sh, dw, dh], "ms": ms, "p10_ms": p10,
                     "p90_ms": p90, "plain_ms": plain_ms, "bytes": nbytes,
                     "ops": ops, "bound_ms": bound_ms,
                     "bound_by": "bytes" if bytes_ms >= ops_ms
                     else "operations", "share_of_bound": bound_ms / ms,
                     "library_ms": None})
        if r.kernel == "resize_area_down_nv12":
            rows[-1].update(area_plan_row(r, n, device))
            if n == BATCH:
                words = flat.view(torch.int32)
                rows[-1]["read_floor_ms"] = time_ms(
                    lambda: torch.amax(words), device)[0]
        del flat, y, uv
    emit({"phase": "resize_times", "card": smi, "rows": rows,
          "library_note": "no PyTorch call computes the reference's "
                          "NV12-domain resize"})
    return rows


# The AREA-down plans timed against each other: the registers variant at
# the three widest column tiles, each band of output rows, one frame a
# block and two, and the table variant, at the headline batch and at one
# frame.
AREA_VARIANT_SHAPES = ((BATCH, HEADLINE_SRC, (SIDE, SIDE)),
                       (1, RESIZE_SRC, (480, 360)))


def phase_area_variants(device, smi):
    """resize_area_down_nv12 under each plan of AREA_VARIANT_SHAPES: the
    time of each, its staged bytes and blocks, each held byte for byte to
    the plain version. Evidence for what bounds the kernel (ncu cannot run
    on the card's machine): how its time moves with the band, and against
    the read floor of phase_resize_times."""
    rows = []
    for n, (sw, sh), (dw, dh) in AREA_VARIANT_SHAPES:
        flat = torch.from_numpy(seeded_nv12(n, sh, sw, 90)).to(device)
        y, uv = split(flat, n, sh, sw)
        r = resize_ops.NV12Resize(sw, sh, dw, dh, ResizeType.AREA)
        want = r.plain(y, uv)
        key = (n, sm_count(device))
        chosen = r.area_plan(*key)
        plans = [resize_ops.area_blocks(r.planes, sw, sh, dw, dh, band,
                                        tile, "registers", frames)
                 for tile in resize_ops.area_tiles(dw)[:3]
                 for band in resize_ops.AREA_BANDS
                 for frames in sorted({1, min(2, n)})]
        plans.append(resize_ops.area_blocks(r.planes, sw, sh, dw, dh, 1,
                                            chosen.tile, "table"))
        for plan in plans:
            if plan.smem > resize_ops.AREA_SMEM_LIMIT:
                continue
            r._plans[key] = plan
            got = r(y, uv)
            torch.cuda.synchronize()
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"AREA plan {plan.variant} band "
                                     f"{plan.band}: bytes differ")
            ms, p10, p90 = time_ms(lambda: r(y, uv), device)
            rows.append({"shape": [n, sw, sh, dw, dh], **plan_row(plan, n),
                         "chosen": plan_row(plan, n) == plan_row(chosen, n),
                         "ms": ms,
                         "p10_ms": p10, "p90_ms": p90})
        r._plans[key] = chosen
        del flat, y, uv, want
    emit({"phase": "area_variants", "card": smi, "rows": rows,
          "tolerance": "0 bytes"})
    return rows


# ------------------------------------------------------------ flash phases

def _flash_case(b, h, hk, sq, sk, d, dtype, seed, layout="bhsd"):
    """Seeded q, k, v on the card; layout "bshd" hands the kernel the
    [B, S, H, d] views the model's projections give it."""
    gen = torch.Generator().manual_seed(seed)

    def make(heads, s, std):
        if layout == "bshd":
            t = torch.randn((b, s, heads, d), generator=gen) * std
            return t.to("cuda", dtype).transpose(1, 2)
        return (torch.randn((b, heads, s, d), generator=gen) * std).to(
            "cuda", dtype)
    return (make(h, sq, FLASH_QK_STD), make(hk, sk, FLASH_QK_STD),
            make(hk, sk, FLASH_V_STD))


def _within(got, want, tol):
    """assert_allclose's rule: |got - want| <= tol + tol * |want|."""
    diff = (got.double() - want.double()).abs()
    return bool((diff <= tol + tol * want.double().abs()).all())


def _rel_norm(got, want):
    want = want.double()
    return float((got.double() - want).norm() / want.norm())


def flash_rule(got, want):
    """The kernel's (o, l, m) against the plain version's: o elementwise
    at its dtype's rule and as a relative norm, l and m at the f32 rule.
    Returns ({check: passed}, {error: value})."""
    (o, l, m), (wo, wl, wm) = got, want
    f32_tol = FLASH_TOL[torch.float32]
    errs = {"o": max_abs_err(o, wo), "o_rel": _rel_norm(o, wo),
            "o_mean_abs": float(wo.float().abs().mean()),
            "l": max_abs_err(l, wl), "m": max_abs_err(m, wm)}
    checks = {"o": _within(o, wo, FLASH_TOL[o.dtype]),
              "o_rel": errs["o_rel"] <= FLASH_O_REL[o.dtype],
              "l": _within(l, wl, f32_tol), "m": _within(m, wm, f32_tol)}
    return checks, errs


FLASH_CASES = [
    # name, (b, h, hk, sq, sk, d), causal, window, layout
    ("full", (2, 4, 4, 512, 512, 64), False, None, "bhsd"),
    ("causal", (2, 4, 4, 512, 512, 64), True, None, "bhsd"),
    ("full_d32", (1, 4, 4, 384, 384, 32), False, None, "bhsd"),
    ("causal_d128", (1, 4, 4, 384, 384, 128), True, None, "bhsd"),
    ("window_causal", (1, 4, 4, 1024, 1024, 64), True, 100, "bhsd"),
    ("window_symmetric", (1, 4, 4, 1024, 1024, 64), False, 100, "bhsd"),
    # The JAX dispatch picks _band_kernel here (S=1024, W=64, block_q=256:
    # band 384 <= min(1024, 4608)); on the card it is the band mode.
    ("band_kernel_causal", (1, 2, 2, 1024, 1024, 64), True, 64, "bhsd"),
    ("band_kernel_symmetric", (1, 2, 2, 1024, 1024, 64), False, 64, "bhsd"),
    ("gqa_12_to_4", (2, 12, 4, 640, 640, 64), False, None, "bhsd"),
    ("mqa_12_to_1", (2, 12, 1, 640, 640, 64), True, None, "bhsd"),
    ("ragged_100", (2, 3, 3, 100, 100, 64), False, None, "bhsd"),
    ("ragged_200_causal", (2, 3, 3, 200, 200, 64), True, None, "bhsd"),
    ("ragged_1568_window", (1, 2, 2, 1568, 1568, 64), False, 77, "bhsd"),
    ("cross_300_to_777", (2, 4, 2, 300, 777, 64), False, None, "bhsd"),
    ("model_layout", (2, 12, 12, 1568, 1568, 64), False, None, "bshd"),
    # The streaming twin's attention (B = 2 clips x 16 steps spatially,
    # 2 clips x 196 tokens temporally), as the factorized block's views.
    ("twin_spatial", (32, 6, 6, 196, 196, 64), False, None, "bshd"),
    ("twin_spatial_gqa", (32, 6, 2, 196, 196, 64), False, None, "bshd"),
    ("twin_temporal", (392, 6, 6, 16, 16, 64), True, 8, "bshd"),
    ("twin_temporal_gqa", (392, 6, 2, 16, 16, 64), True, 8, "bshd"),
    ("headline", (2, 12, 12, 1568, 1568, 64), False, None, "bhsd"),
    # The training paths' forwards with residuals, as the model's views.
    ("train", (4, 12, 12, 1568, 1568, 64), False, None, "bshd"),
    ("train_long", (1, 12, 12, 6272, 6272, 64), False, None, "bshd"),
    # Batch x heads past 65535 (factorized temporal attention over 28 or
    # more 224² clips): the grid is (tiles, heads, batch).
    ("grid_bh_over_65535", (5600, 12, 12, 16, 16, 64), True, None, "bshd"),
]
# Cases held in bf16 only (the model's dtype at the training shapes).
BF16_ONLY = ("headline", "train", "train_long")


def phase_flash_vs_plain():
    """The flash kernel against flash_attention_plain on the same CUDA
    tensors, o, l and m, in bf16 and f32: o elementwise and as a whole,
    l and m at the f32 rule. TF32 is off for the plain version's f32
    products (its stated numerics are full f32). Returns the worst o error
    of the cases without a window and of those with one (the band mode)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    worst = {"no_window": 0.0, "window": 0.0}
    for i, (name, shape, causal, window, layout) in enumerate(FLASH_CASES):
        dtypes = (torch.bfloat16,) if name in BF16_ONLY else \
            (torch.bfloat16, torch.float32)
        for dtype in dtypes:
            q, k, v = _flash_case(*shape, dtype, 200 + i, layout)
            before = fa.launches
            o, l, m = fa.flash_attention_fwd(q, k, v, causal=causal,
                                             window=window)
            if fa.launches != before + 1:
                raise AssertionError(f"flash {name}: kernel did not launch")
            wo, wl, wm = fa.flash_attention_plain(q, k, v, causal, window,
                                                  residuals=True)
            torch.cuda.synchronize()
            checks, errs = flash_rule((o, l, m), (wo, wl, wm))
            ok = all(checks.values())
            mode = "no_window" if window is None else "window"
            worst[mode] = max(worst[mode], errs["o"])
            rows.append({"case": name, "shape": list(shape),
                         "dtype": str(dtype).split(".")[-1],
                         "causal": causal, "window": window,
                         "layout": layout, "tol": FLASH_TOL[dtype], **errs,
                         "ok": ok})
            if not ok:
                emit({"phase": "flash_vs_plain", "cases": rows})
                raise AssertionError(f"flash kernel != plain: {rows[-1]}")
    emit({"phase": "flash_vs_plain", "allow_tf32": False,
          "inputs": {"qk_std": FLASH_QK_STD, "v_std": FLASH_V_STD},
          "tolerance": {"o_bf16": FLASH_TOL[torch.bfloat16],
                        "o_f32": FLASH_TOL[torch.float32],
                        "o_rel_norm_bf16": FLASH_O_REL[torch.bfloat16],
                        "o_rel_norm_f32": FLASH_O_REL[torch.float32],
                        "l_m": FLASH_TOL[torch.float32]},
          "cases": rows})
    return worst


# The flash backward against its plain version, as
# tests/test_flash_attention.py holds gradients (:300-301): the forward's
# elementwise rule at 10 times its scale, since a gradient accumulates one
# more chain of products. Beside it each gradient as a whole, ||got - want||
# / ||want||, at the forward's bound in bf16 (dS and P round to bf16 at the
# same points in both, so the kernel measured at most 1.8e-4 on an H100)
# and 1e-4 in f32 (sums in another order, amplified where dP - delta
# cancels; measured at most 7e-7). A backward that drops delta, or a head
# of a GQA group, lands at order 1 (tests/test_torch_flash_bwd.py emulates
# both on the CPU under this rule).
FLASH_GRAD_SCALE = 10.0
FLASH_GRAD_REL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# The contract rounds dS to bf16 before dK = dS^T Q (and dQ = dS K). The
# kernel rounds it where the plain version does, and sums each dK row in
# f32 over one block's steps, so in bf16 their dK agree far inside
# FLASH_GRAD_REL (measured at most 2.2e-4 on an H100, PERF.md). A kernel
# that left dS in f32 lands 2.6e-3 away, under FLASH_GRAD_REL
# (tests/test_torch_flash_bwd.py emulates it on the CPU), so bf16 dK is
# also held to this bound. dQ is not: a tiled sum that rounds dQ twice
# lands as far (2.8e-3) and is still a valid reading of the contract's
# rounding.
FLASH_DK_CAST_REL = 1e-3

FLASH_BWD_CASES = [
    # name, (b, h, hk, sq, sk, d), causal, window, layout
    ("train", (4, 12, 12, 1568, 1568, 64), False, None, "bshd"),
    ("train_long", (1, 12, 12, 6272, 6272, 64), False, None, "bshd"),
    ("causal", (2, 4, 4, 512, 512, 64), True, None, "bhsd"),
    ("window_causal", (1, 4, 4, 1024, 1024, 64), True, 100, "bhsd"),
    ("window_symmetric", (1, 4, 4, 1024, 1024, 64), False, 100, "bhsd"),
    ("gqa_12_to_4", (2, 12, 4, 640, 640, 64), False, None, "bshd"),
    ("ragged_cross_100_to_300", (2, 4, 2, 100, 300, 64), False, None,
     "bhsd"),
    ("full_d32", (1, 4, 4, 384, 384, 32), False, None, "bhsd"),
    ("causal_d128", (1, 4, 4, 384, 384, 128), True, None, "bhsd"),
    ("grid_bh_over_65535", (5600, 12, 12, 16, 16, 64), True, None, "bshd"),
]


def _grad_out(b, h, sq, d, dtype, seed, layout="bhsd"):
    """A seeded dL/do of std 1 in the layout of _flash_case's q."""
    gen = torch.Generator().manual_seed(seed)
    if layout == "bshd":
        return torch.randn((b, sq, h, d), generator=gen).to(
            "cuda", dtype).transpose(1, 2)
    return torch.randn((b, h, sq, d), generator=gen).to("cuda", dtype)


def bwd_rule(got, want):
    """The kernel's (dq, dk, dv) against the plain version's: each
    elementwise at the gradient rule and as a relative norm, and bf16 dK
    as a relative norm within FLASH_DK_CAST_REL ("dk_cast": dS rounded
    to bf16 where the contract rounds it). Returns ({check: passed},
    {error: value})."""
    checks, errs = {}, {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        errs[name] = max_abs_err(g, w)
        errs[name + "_rel"] = _rel_norm(g, w)
        errs[name + "_mean_abs"] = float(w.float().abs().mean())
        checks[name] = _within(g, w, FLASH_TOL[w.dtype] * FLASH_GRAD_SCALE)
        checks[name + "_rel"] = errs[name + "_rel"] <= FLASH_GRAD_REL[w.dtype]
    if want[1].dtype == torch.bfloat16:
        checks["dk_cast"] = errs["dk_rel"] <= FLASH_DK_CAST_REL
    return checks, errs


def bytes_equal(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


# Which flash backward design serves which inputs (csrc/flash_bwd.cu).
BWD_DESIGN_NOTES = {
    "wgmma": "bf16 at d = 64: TMA ring, warp-specialised wgmma",
    "mma_sync": "bf16 at d = 32 and 128: mma.sync, cp.async stages",
    "f32": "f32: FMAs (no TF32)"}


def bwd_design(dtype, d):
    """The backward design that must serve (dtype, head dim): "wgmma" for
    bf16 at d = 64, "mma_sync" for bf16 at d = 32 and 128, "f32"."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if d == 64 else "mma_sync"


def phase_flash_bwd_vs_plain():
    """The flash backward kernel against flash_attention_bwd_plain on the
    same CUDA tensors and the same residuals (the forward kernel's o, l,
    m), in bf16 and f32 (the training shapes in bf16), q and k of std 2;
    each case launched twice, and the two must be the same bytes and go
    through the design bwd_design names. Returns the worst elementwise
    error of each design."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    worst = dict.fromkeys(fa.BWD_DESIGNS, 0.0)
    for i, (name, shape, causal, window, layout) in enumerate(
            FLASH_BWD_CASES):
        b, h, hk, sq, sk, d = shape
        dtypes = (torch.bfloat16,) if name in BF16_ONLY else \
            (torch.bfloat16, torch.float32)
        for dtype in dtypes:
            q, k, v = _flash_case(*shape, dtype, 300 + i, layout)
            do = _grad_out(b, h, sq, d, dtype, 400 + i, layout)
            o, l, m = fa.flash_attention_fwd(q, k, v, causal=causal,
                                             window=window)
            design = bwd_design(dtype, d)
            before = fa.bwd_launches_by_design[design]
            got = fa.flash_attention_bwd(q, k, v, o, l, m, do, causal=causal,
                                         window=window)
            again = fa.flash_attention_bwd(q, k, v, o, l, m, do,
                                           causal=causal, window=window)
            if fa.bwd_launches_by_design[design] != before + 2:
                raise AssertionError(f"flash bwd {name}: the {design} "
                                     "kernels did not launch")
            want = fa.flash_attention_bwd_plain(q, k, v, o, l, m, do, causal,
                                                window)
            torch.cuda.synchronize()
            checks, errs = bwd_rule(got, want)
            checks["deterministic"] = all(bytes_equal(x, y)
                                          for x, y in zip(got, again))
            ok = all(checks.values())
            worst[design] = max(worst[design], errs["dq"], errs["dk"],
                                errs["dv"])
            rows.append({"case": name, "shape": list(shape),
                         "dtype": str(dtype).split(".")[-1],
                         "design": design,
                         "causal": causal, "window": window,
                         "layout": layout,
                         "tol": FLASH_TOL[dtype] * FLASH_GRAD_SCALE,
                         "rel_bound": FLASH_GRAD_REL[dtype], **errs,
                         "failed": [c for c, v in checks.items() if not v],
                         "ok": ok})
            del q, k, v, do, o, l, m, got, again, want
            if not ok:
                emit({"phase": "flash_bwd_vs_plain", "cases": rows})
                raise AssertionError(f"flash bwd != plain: {rows[-1]}")
    emit({"phase": "flash_bwd_vs_plain", "allow_tf32": False,
          "worst_by_design": worst,
          "inputs": {"qk_std": FLASH_QK_STD, "v_std": FLASH_V_STD,
                     "do_std": 1.0},
          "tolerance": {"bf16": FLASH_TOL[torch.bfloat16] * FLASH_GRAD_SCALE,
                        "f32": FLASH_TOL[torch.float32] * FLASH_GRAD_SCALE,
                        "rel_norm_bf16": FLASH_GRAD_REL[torch.bfloat16],
                        "rel_norm_f32": FLASH_GRAD_REL[torch.float32],
                        "dk_rel_norm_bf16_cast": FLASH_DK_CAST_REL},
          "deterministic": "two launches a case, compared byte for byte",
          "cases": rows})
    return worst


STREAM_SEED = 31  # stream k of every synthetic source draws seed 31 + k


class SyntheticStreams(MultiStreamLoader):
    """MultiStreamLoader over SyntheticFrameLoaders: the card's machine
    has no FFmpeg, so each stream is seeded NV12 frames through the same
    FrameLoader staging, copy and VPP (by default merged RGB f32,
    normalized)."""

    def __init__(self, n_streams, per_stream, frames, device, cfg=None):
        self.loaders = [SyntheticFrameLoader(frames, per_stream, 2,
                                             cfg or serving_cfg(), device,
                                             seed=STREAM_SEED + k)
                        for k in range(n_streams)]


class SyntheticPool(PooledStreamLoader):
    """PooledStreamLoader with its native pool replaced by seeded NV12
    frames: the same pinned staging pool, fill thread, one non_blocking
    copy a tick, batched VPP (and post_fn graph), event rotation and
    latched end of stream. Stream "synthetic:k" holds the frames of
    SyntheticFrameLoader(seed=STREAM_SEED + k) at the target size, as
    the native host resize would deliver them; each stream holds
    `frames` frames."""

    def __init__(self, stream_urls, per_stream=8, frames=0, **kwargs):
        self._frames = int(frames)
        super().__init__(stream_urls, per_stream=per_stream, **kwargs)

    def _open_pool(self, stream_urls, workers, loop, buffer_size,
                   fast_decode):
        self._w, self._h = self.params.width, self.params.height
        self._sources = [seeded_frames(
            STREAM_SEED + int(str(url).rsplit(":", 1)[1]), self._h, self._w,
            SyntheticFrameLoader.POOL) for url in stream_urls]
        self._cursor = 0

    def _fill_tick(self, buf):
        n = self.per_stream
        if self._cursor + n > self._frames:
            return None
        dst = buf.numpy()
        y_total = self.global_batch * self._h * self._w
        ys = dst[:y_total].reshape(-1, self._h, self._w)
        uvs = dst[y_total:].reshape(-1, self._h // 2, self._w)
        ids = (self._cursor + np.arange(n)) % SyntheticFrameLoader.POOL
        for k, (y, uv) in enumerate(self._sources):
            ys[k * n:(k + 1) * n] = y[ids]
            uvs[k * n:(k + 1) * n] = uv[ids]
        first = self._cursor + 1
        self._cursor += n
        return {k: list(range(first, first + n))
                for k in range(len(self._sources))}


@contextlib.contextmanager
def synthetic_pool():
    """Engines built inside it get a SyntheticPool where pipeline="pooled"
    or "fused" would open the native pool."""
    real = serving.PooledStreamLoader
    serving.PooledStreamLoader = SyntheticPool
    try:
        yield
    finally:
        serving.PooledStreamLoader = real


def synthetic_urls():
    return [f"synthetic:{k}" for k in range(STREAMS)]


def pooled_engine(pipeline, infer_fn, per_stream, frames, device, **kwargs):
    """StreamInferencer(pipeline=...) over STREAMS SyntheticPool streams of
    `frames` 224² frames each, at the host-resize target size."""
    with synthetic_pool():
        return StreamInferencer(synthetic_urls(), infer_fn,
                                per_stream=per_stream, pipeline=pipeline,
                                frames=frames, host_resize=True, width=SIDE,
                                height=SIDE, device=device, **kwargs)


def serving_cfg():
    """The serving loaders' VPP: 224² RGB merged f32, normalized."""
    return FrameParameters(pixel_format=FourCC.RGB24,
                           planes_pos=Planes.MERGED,
                           normalization=True).to_config(SIDE, SIDE)


def drive_engine(eng, warmup, timed, inflight=1):
    """`warmup` then `timed` ticks of `eng` with the kernels' counts at 0
    just before; returns (results, seconds of the timed ticks, launches,
    NV12 launches by variant, result waits of the timed ticks in ms)."""
    nv12_rgb.reset_counts()
    fa.reset_counts()
    results = list(eng.stream(max_batches=warmup, inflight=inflight))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    results += list(eng.stream(max_batches=timed, inflight=inflight))
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    launches = {"nv12_rgb": nv12_rgb.launches, "flash_fwd": fa.launches}
    lat = np.asarray(eng._lat_ms[warmup:])
    return (results, seconds, launches, dict(nv12_rgb.launches_by_variant),
            lat)


def by_tick(results, n_streams):
    """Outputs of an engine's results as [ticks, n_streams, ...]."""
    outs = torch.stack([r.outputs for r in results])
    return outs.reshape(-1, n_streams, *outs.shape[1:])


def check_clocks(results, ticks, per_stream, label):
    if [r.stream for r in results] != list(range(STREAMS)) * ticks:
        raise AssertionError(f"{label}: results out of stream order")
    for k in range(STREAMS):
        frames = [f for r in results if r.stream == k for f in r.frames]
        if frames != list(range(1, ticks * per_stream + 1)):
            raise AssertionError(f"{label}: stream {k}'s frame clock "
                                 f"{frames[:4]}...")


def pace(seconds, ticks, lat, device_ms=None, graph=None):
    """A timed run's ms a tick, result waits, the host's ms a tick (the
    wall time less the result waits) and, given the device's ms a tick,
    the idle share; a graphed run's captures and replays."""
    ms = seconds / ticks * 1e3
    row = {"ms_per_tick": ms,
           "result_wait_ms": {"p50": float(np.percentile(lat, 50)),
                              "p95": float(np.percentile(lat, 95))},
           "host_ms_a_tick": ms - float(lat.sum()) / ticks}
    if device_ms is not None:
        row.update(device_ms_a_tick=device_ms, idle_share=1 - device_ms / ms)
    if graph is not None:
        row.update(captures=graph.captures, replays=graph.replays)
    return row


def check_replays(graph, calls, label):
    """A graphed path's `calls` calls: a warm-up, one capture, and a replay
    for every call but the warm-up."""
    if graph is not None and (graph.captures, graph.replays) != (1,
                                                                 calls - 1):
        raise AssertionError(f"{label}: {graph.captures} captures and "
                             f"{graph.replays} replays over {calls} calls")


def bit_equal_ticks(got, want):
    """[ticks, ...] against [ticks, ...]: each tick bit for bit."""
    return [bitwise_equal(g, w) if g.dtype != torch.bfloat16
            else torch.equal(g.view(torch.int16), w.view(torch.int16))
            for g, w in zip(got, want)]


def vit(device, dtype, flash_impl="auto"):
    """The serving model with weights from seed 0: the bf16 one and the
    f32 one are the same parameters."""
    return VideoViT(compute_dtype=dtype, residual_dtype=dtype,
                    flash_impl=flash_impl, device=device,
                    generator=torch.Generator().manual_seed(0), **VIT).eval()


def logits_check(model, clips, got, rel):
    """The model's logits with the flash kernel (`got`) against the same
    model, built with flash_impl="plain" and the same weights, on the
    same clips: a max abs error within `rel` of the largest plain logit,
    and the same argmax on every row whose plain top-2 margin exceeds
    twice that error (a closer pair can swap under the error measured; a
    random-weight model has such near ties among its 1000 classes)."""
    plain = vit(model.device, model.compute_dtype, flash_impl="plain")
    plain.load_state_dict(model.state_dict())
    before = fa.launches
    with torch.no_grad():
        want = plain(clips)
    if fa.launches != before:
        raise AssertionError("the plain reference model launched the kernel")
    del plain
    return logit_rule(got, want, rel)


def logit_rule(got, want, rel):
    """Logits [..., classes] against a reference's: the max abs error within
    `rel` of the largest reference logit, and the same argmax on every row
    whose reference top-2 margin exceeds twice that error."""
    got = got.reshape(-1, got.shape[-1])
    want = want.reshape(-1, want.shape[-1])
    err = max_abs_err(got, want)
    tol = rel * float(want.abs().max())
    top2 = want.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    decided = margin > 2 * err
    same = got.argmax(-1) == want.argmax(-1)
    return {"max_abs_err": err, "bound": tol, "rel_bound": rel,
            "max_abs_logit": float(want.abs().max()),
            "argmax_flash": got.argmax(-1).tolist(),
            "argmax_plain": want.argmax(-1).tolist(),
            "plain_top2_margin": margin.tolist(),
            "rows_decided": int(decided.sum()),
            "ok": err <= tol and bool((same | ~decided).all())}


def serve_vit(device, model, graphed, pipeline="per-stream"):
    """One run of ViT-B joint serving, WARMUP_TICKS + TIMED_TICKS ticks,
    with the kernels' counts at 0 just before: eager or through
    cuda_graph over SyntheticStreams, or pipeline="fused" over a
    SyntheticPool (the VPP and the model one graph). Checks launches
    (NV12: one a stream a tick, or one a tick fused; 12 flash a tick),
    streams, frame clocks and shapes; returns (logits [ticks, streams,
    classes], the run's row, the first tick's clips)."""
    first = {}

    def serve(batch):  # [n*16, 224, 224, 3] -> logits [n, 1000]
        clips = batch.view(-1, CLIP, SIDE, SIDE, 3)
        if not graphed and "clips" not in first:
            first["clips"] = clips.clone()
        return model(clips)

    ticks = WARMUP_TICKS + TIMED_TICKS
    if pipeline == "fused":
        eng = pooled_engine("fused", serve, CLIP, ticks * CLIP, device,
                            pixel_format=FourCC.RGB24,
                            planes_pos=Planes.MERGED, normalization=True)
        loader, graph = eng.loader, eng.loader._vpp.graphed
        want_nv12 = ticks
    else:
        loader = SyntheticStreams(STREAMS, CLIP, ticks * CLIP, device)
        graph = cuda_graph(serve) if graphed else None
        eng = StreamInferencer(synthetic_urls(), graph or serve,
                               per_stream=CLIP, loader=loader)
        want_nv12 = ticks * STREAMS
    label = f"serving {pipeline}{' graphed' if graphed else ''}"
    try:
        results, seconds, launches, variants, lat = drive_engine(
            eng, WARMUP_TICKS, TIMED_TICKS)
        device_ms = (time_ms(graph.graphs[0].replay, device, iters=10,
                             warmup=2)[0] if graph is not None else None)
    finally:
        eng.close()
        loader.close()
    check_replays(graph, ticks, label)
    if launches != {"nv12_rgb": want_nv12,
                    "flash_fwd": ticks * VIT["depth"]}:
        raise AssertionError(f"{label}: launches {launches} over {ticks} "
                             "ticks: the serving path bypassed a kernel")
    check_clocks(results, ticks, CLIP, label)
    if any(tuple(r.outputs.shape) != (1, VIT["num_classes"])
           for r in results):
        raise AssertionError(f"{label}: wrong output shapes")
    logits = by_tick(results, STREAMS)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: non-finite logits")
    frames = TIMED_TICKS * STREAMS * CLIP
    row = {"pipeline": pipeline, "graphed": graphed, "launches": launches,
           "nv12_rgb_by_variant": variants, "seconds": seconds,
           "frames_per_s": frames / seconds,
           **pace(seconds, TIMED_TICKS, lat, device_ms, graph)}
    return logits, row, first.get("clips")


def phase_serving(device):
    """StreamInferencer over two streams into the ViT-B joint model, every
    attention through the flash kernel, 2 warm-up ticks and 24 timed, three
    times: eager, through cuda_graph, and pipeline="fused" (the VPP and the
    model one graph a tick). The graphed logits must equal the eager ones
    and the fused ones the graphed ones, bit for bit at every tick."""
    model = vit(device, torch.bfloat16)
    got_eager, eager, clips = serve_vit(device, model, False)
    got_graphed, graphed, _ = serve_vit(device, model, True)
    got_fused, fused, _ = serve_vit(device, model, True, "fused")
    graphed["bit_equal_to_eager"] = bit_equal_ticks(got_graphed, got_eager)
    fused["bit_equal_to_graphed"] = bit_equal_ticks(got_fused, got_graphed)
    got = got_eager[0]
    # bf16: the flash and plain paths round P to bf16 at different points
    # (unnormalized in the kernel, normalized in the plain version) in each
    # of 12 layers, and the residual stream is bf16 (8 mantissa bits), so
    # per-layer differences of about one bf16 step compound through the
    # depth: 1% of the logit scale allows for a few such steps.
    bf16 = logits_check(model, clips, got, BF16_LOGIT_REL)
    # The forward alone on the first tick's clips: with CUDA events around
    # an eager call (paced by the host when its launches are slower than
    # the device), the host's time to enqueue it, and the device's own
    # time from a CUDA-graph replay of it.
    with torch.no_grad():
        forward_ms = time_ms(lambda: model(clips), device, iters=10,
                             warmup=2, hold=False)
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(clips)
            enqueue.append((time.perf_counter() - t0) * 1e3)
        forward = cuda_graph(model)
        for _ in range(2):  # warm-up, capture
            forward(clips)
        graph_enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            forward(clips)
            graph_enqueue.append((time.perf_counter() - t0) * 1e3)
        graph_ms = time_ms(forward.graphs[0].replay, device, iters=10,
                           warmup=2)
        del forward
    del model
    eager["device_ms_a_tick"] = graph_ms[0]
    eager["idle_share"] = 1 - graph_ms[0] / eager["ms_per_tick"]
    # f32: the f32 kernel against the plain f32 path, tight: the only
    # difference is the order of f32 sums.
    model32 = vit(device, torch.float32)
    with torch.no_grad():
        before = fa.launches
        got32 = model32(clips)
        if fa.launches != before + VIT["depth"]:
            raise AssertionError("f32 model bypassed the kernel")
    f32 = logits_check(model32, clips, got32, F32_LOGIT_REL)
    del model32
    out = {"phase": "serving", "streams": STREAMS,
           "clip": [CLIP, SIDE, SIDE, 3],
           "model": VIT, "compute": "bf16", "residual": "bf16",
           "warmup_ticks": WARMUP_TICKS, "timed_ticks": TIMED_TICKS,
           **eager, "graphed_run": graphed, "fused_run": fused,
           "forward_ms": forward_ms[0], "forward_p10_ms": forward_ms[1],
           "forward_p90_ms": forward_ms[2],
           "forward_enqueue_ms": float(np.median(enqueue)),
           "forward_graph_call_enqueue_ms": float(np.median(graph_enqueue)),
           "forward_device_ms": graph_ms[0],
           "forward_device_p10_ms": graph_ms[1],
           "forward_device_p90_ms": graph_ms[2],
           "logits_bf16": bf16, "logits_f32": f32}
    emit(out)
    if not (bf16["ok"] and f32["ok"]):
        raise AssertionError("serving logits disagree with the plain path")
    if not all(graphed["bit_equal_to_eager"]):
        raise AssertionError("graphed serving logits differ from eager ones: "
                             f"{graphed['bit_equal_to_eager']}")
    if not all(fused["bit_equal_to_graphed"]):
        raise AssertionError("fused serving logits differ from the graphed "
                             f"ones: {fused['bit_equal_to_graphed']}")
    return out


# ------------------------------------------------------------ pooled

# bench.py::bench_serving's configuration (:462-505): two streams, 8
# frames a stream a tick, 224² RGB merged u8 after a host resize,
# inflight 2, the mean model; pooled and fused, against the per-stream
# engine. Seeded NV12 at 224² stands in for the decode and host resize.
POOL_PER_STREAM = 8
POOL_WARMUP_TICKS = 3
POOL_TIMED_TICKS = 200
POOL_INFLIGHT = 2


def pool_cfg():
    return FrameParameters(pixel_format=FourCC.RGB24,
                           planes_pos=Planes.MERGED).to_config(SIDE, SIDE)


def mean_model(batch):
    """bench_serving's model: each frame's mean, in f32."""
    return batch.float().mean(dim=(1, 2, 3))


def identity(batch):
    return batch


def pool_run(device, pipeline, infer_fn):
    """POOL_WARMUP_TICKS + POOL_TIMED_TICKS ticks of bench_serving's
    configuration through `pipeline` (per-stream over SyntheticStreams,
    pooled or fused over a SyntheticPool) with the kernels' counts at 0
    just before. Returns (outputs [ticks, streams, per_stream, ...], the
    row, the per-stream loader's synthetic streams or None, the graph
    that served the tick or None)."""
    ticks = POOL_WARMUP_TICKS + POOL_TIMED_TICKS
    frames = ticks * POOL_PER_STREAM
    streams = None
    if pipeline == "per-stream":
        streams = SyntheticStreams(STREAMS, POOL_PER_STREAM, frames, device,
                                   pool_cfg())
        eng = StreamInferencer(synthetic_urls(), infer_fn,
                               per_stream=POOL_PER_STREAM, loader=streams)
    else:
        eng = pooled_engine(pipeline, infer_fn, POOL_PER_STREAM, frames,
                            device, pixel_format=FourCC.RGB24,
                            planes_pos=Planes.MERGED)
    graph = (eng.loader._vpp.graphed if pipeline == "fused"
             else infer_fn if isinstance(infer_fn, CudaGraph) else None)
    try:
        results, seconds, launches, variants, lat = drive_engine(
            eng, POOL_WARMUP_TICKS, POOL_TIMED_TICKS, POOL_INFLIGHT)
    finally:
        eng.close()
        if streams is not None:
            streams.close()
    label = f"pooled phase, {pipeline} {getattr(infer_fn, '__name__', '')}"
    check_replays(graph, ticks, label)
    want = ticks * (STREAMS if pipeline == "per-stream" else 1)
    if launches != {"nv12_rgb": want, "flash_fwd": 0}:
        raise AssertionError(f"{label}: launches {launches} over {ticks} "
                             f"ticks, want {want} NV12")
    if variants["vector"] != want:
        raise AssertionError(f"{label}: NV12 variants {variants}: the "
                             "staging planes (and a graph's static copy) "
                             "must keep the vector variant's alignment")
    check_clocks(results, ticks, POOL_PER_STREAM, label)
    outs = by_tick(results, STREAMS)
    frames = POOL_TIMED_TICKS * STREAMS * POOL_PER_STREAM
    row = {"pipeline": pipeline, "launches": launches,
           "nv12_rgb_by_variant": variants, "seconds": seconds,
           "frames_per_s": frames / seconds,
           **pace(seconds, POOL_TIMED_TICKS, lat, graph=graph)}
    return outs, row, streams, graph


def pool_device_ms(device, pipeline, graph):
    """The device's ms of one tick's work at bench_serving's
    configuration, with the held timer (no copy to the device): per-stream,
    two VPPs of 8 frames, the concatenation and the mean; pooled, one VPP
    of 16 and the mean's graph; fused, the one graph."""
    n = STREAMS * POOL_PER_STREAM
    if pipeline == "fused":
        return time_ms(graph.graphs[0].replay, device)[0]
    flat = torch.from_numpy(seeded_nv12(n, SIDE, SIDE, 13)).to(device)
    if pipeline == "pooled":
        vpp = build_vpp_batched_flat(pool_cfg(), n, device)
        return time_ms(lambda: (vpp(flat), graph.graphs[0].replay()),
                       device)[0]
    vpp = build_vpp_batched_flat(pool_cfg(), POOL_PER_STREAM, device)
    parts = [torch.from_numpy(seeded_nv12(POOL_PER_STREAM, SIDE, SIDE,
                                          14 + k)).to(device)
             for k in range(STREAMS)]
    with torch.no_grad():
        return time_ms(lambda: mean_model(torch.cat([vpp(p) for p in parts])),
                       device)[0]


def phase_pooled(device, smi):
    """bench_serving's configuration pooled and fused. Frames: the
    per-stream engine's (each stream's first and last tick bit-equal to
    the plain NV12 version on the CPU on the same staging bytes), then
    pooled and fused with the identity as the model, bit-equal to them at
    every tick, one NV12 launch a tick. Then the mean model, per-stream
    (eager), pooled (the mean through cuda_graph) and fused (the VPP and
    the mean one graph), timed, their means bit-equal to the per-stream
    engine's at every tick."""
    ref, _, streams, _ = pool_run(device, "per-stream", identity)
    ticks = ref.shape[0]
    cpu_vpp = build_vpp_batched_flat(pool_cfg(), POOL_PER_STREAM, "cpu")
    for k, ld in enumerate(streams.loaders):
        for t in (0, ticks - 1):
            staging = torch.from_numpy(ld.staging_bytes(
                t * POOL_PER_STREAM + 1, POOL_PER_STREAM))
            if not bitwise_equal(ref[t, k].cpu(), cpu_vpp(staging)):
                raise AssertionError(f"pooled phase: stream {k} tick {t}: "
                                     "frames differ from the plain version")
    frames = {}
    for pipeline in ("pooled", "fused"):
        got, row, _, _ = pool_run(device, pipeline, identity)
        row["bit_equal_to_per_stream"] = bit_equal_ticks(got, ref)
        frames[pipeline] = row
        del got
    del ref
    means = {}
    want = None
    for pipeline, infer in (("per-stream", mean_model),
                            ("pooled", cuda_graph(mean_model)),
                            ("fused", mean_model)):
        got, row, _, graph = pool_run(device, pipeline, infer)
        if want is None:
            want = got
        row["bit_equal_to_per_stream"] = bit_equal_ticks(got, want)
        dev_ms = pool_device_ms(device, pipeline, graph)
        row.update(device_ms_a_tick=dev_ms,
                   idle_share=1 - dev_ms / row["ms_per_tick"])
        means[pipeline] = row
    out = {"phase": "pooled", "card": smi,
           "config": {"streams": STREAMS, "per_stream": POOL_PER_STREAM,
                      "frame": [SIDE, SIDE, 3], "dtype": "uint8",
                      "layout": "merged", "host_resize": True,
                      "inflight": POOL_INFLIGHT, "model": "mean",
                      "source": "bench.py::bench_serving (:462-505)"},
           "warmup_ticks": POOL_WARMUP_TICKS, "timed_ticks": POOL_TIMED_TICKS,
           "frames": frames, "mean_model": means,
           "first_and_last_ticks": "bitwise equal to the CPU plain run"}
    emit(out)
    bad = [f"{kind} {p}" for kind, rows in (("frames", frames),
                                            ("means", means))
           for p, r in rows.items() if not all(r["bit_equal_to_per_stream"])]
    if bad:
        raise AssertionError(f"pooled phase: not bit-equal to the per-stream "
                             f"engine: {bad}")
    return out


# ------------------------------------------------------------ streaming

def stream_vit(device, dtype, kv_heads, **kw):
    """The streaming model with weights from seed 0 (the bf16 and f32
    models of one kv-head count are the same parameters)."""
    return VideoViT(compute_dtype=dtype, num_kv_heads=kv_heads, device=device,
                    generator=torch.Generator().manual_seed(0),
                    **STREAM_VIT, **kw).eval()


def cache_bytes(cache):
    return sum(x.numel() * x.element_size()
               for blk in cache["blocks"] for x in blk.values())


class OpCount(TorchDispatchMode):
    """Counts the ATen ops dispatched inside it (views included)."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def step_times(model, cache, frames, device):
    """One step on a copy of `cache`: the ATen ops it dispatches, the host's
    time to enqueue it eagerly (median of 5, card idle before each), and the
    device's own time from a CUDA-graph replay of it (a measurement only:
    the engine runs eagerly). The capture also shows that the step never
    waits for the card."""
    cache = clone_cache(cache)
    with torch.no_grad():
        with OpCount() as count:
            stream_step(model, cache, frames)
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream_step(model, cache, frames)
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the default stream
            stream_step(model, cache, frames)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            stream_step(model, cache, frames)
        device_ms = time_ms(graph.replay, device, iters=20, warmup=3)
        del graph
    return count.ops, float(np.median(enqueue)), device_ms


def serve_stream(device, name, model, graphed):
    """Two SyntheticStreams through StreamInferencer(carry=...) into
    stream_step, eagerly or through cuda_graph(..., carry=True), for
    STREAM_WARMUP_TICKS + STREAM_TIMED_TICKS ticks at inflight 2 from a
    zeroed cache, with the kernels' counts at 0 just before. Checks
    launches, streams, frame clocks, shapes, finite logits, t and the
    first tick's frames against the plain NV12 version; returns (logits
    [ticks, streams, classes], first tick's batch, row, result waits of
    the timed ticks in ms)."""
    cache = init_stream_cache(model, STREAMS, STREAM_RING)
    first = {}

    def infer(carry, batch):  # [2, 2, 224, 224, 3] -> logits [2, 400]
        if not first:
            first["batch"] = batch.clone()
        return stream_step(model, carry, batch)

    graph = cuda_graph(partial(stream_step, model), carry=True) \
        if graphed else None
    ticks = STREAM_WARMUP_TICKS + STREAM_TIMED_TICKS
    loader = SyntheticStreams(STREAMS, TUBELET, ticks * TUBELET, device)
    eng = StreamInferencer(synthetic_urls(), graph or infer,
                           per_stream=TUBELET, loader=loader, carry=cache)
    label = f"streaming {name}{' graphed' if graphed else ''}"
    try:
        results, seconds, launches, nv12_variants, lat = drive_engine(
            eng, STREAM_WARMUP_TICKS, STREAM_TIMED_TICKS, STREAM_INFLIGHT)
        if not graphed:
            # The plain NV12 version on the CPU, on the staging bytes of
            # the first tick.
            for k, ld in enumerate(loader.loaders):
                staging = torch.from_numpy(ld.staging_bytes(1, TUBELET))
                want = build_vpp_batched_flat(serving_cfg(), TUBELET, "cpu")(
                    staging)
                if not bitwise_equal(first["batch"][k].cpu(), want):
                    raise AssertionError(f"{label}: stream {k}'s first "
                                         "frames differ from the plain "
                                         "version")
    finally:
        loader.close()
    if launches != {"nv12_rgb": ticks * STREAMS, "flash_fwd": 0}:
        raise AssertionError(f"{label}: launches {launches} over "
                             f"{ticks} ticks, want 2 NV12 a tick and no flash")
    check_clocks(results, ticks, TUBELET, label)
    if any(tuple(r.outputs.shape) != (1, STREAM_VIT["num_classes"])
           for r in results):
        raise AssertionError(f"{label}: wrong shapes")
    logits = by_tick(results, STREAMS)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{label}: non-finite logits")
    if int(eng.carry["t"]) != ticks:
        raise AssertionError(f"{label}: t={int(eng.carry['t'])} after "
                             f"{ticks} ticks")
    check_replays(graph, ticks, label)
    row = {"kv_cache_mib": cache_bytes(eng.carry) / 2 ** 20,
           "launches": launches, "nv12_rgb_by_variant": nv12_variants,
           "ticks": ticks, "seconds": seconds,
           **tick_rates(STREAM_TIMED_TICKS, seconds, lat),
           **pace(seconds, STREAM_TIMED_TICKS, lat, graph=graph)}
    if graphed:
        # The device's time of one step: the engine's own graph, replayed
        # (the replays step the cache on past the run).
        device_ms = time_ms(graph.graphs[0].replay, device, iters=20,
                            warmup=3)
        frames = torch.zeros((STREAMS, TUBELET, SIDE, SIDE, 3),
                             device=device)
        enqueue = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            graph(eng.carry, frames)
            enqueue.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        row.update(step_call_enqueue_ms=float(np.median(enqueue)))
    else:
        ops, enqueue_ms, device_ms = step_times(model, eng.carry,
                                                first["batch"], device)
        row.update(step_aten_ops=ops, step_enqueue_ms=enqueue_ms)
    row.update(step_device_ms=device_ms[0],
               step_device_p10_ms=device_ms[1],
               step_device_p90_ms=device_ms[2],
               idle_share=1 - device_ms[0] / row["ms_per_tick"])
    return logits, first.get("batch"), row, lat


def tick_rates(ticks, seconds, lat):
    """bench.py's serving rates over `ticks` timed ticks (one step of each
    stream a tick) and the result waits `lat` (ms)."""
    return {"steps_per_s_a_stream": ticks / seconds,
            "frames_per_s": ticks * STREAMS * TUBELET / seconds,
            "ms_per_tick": seconds / ticks * 1e3,
            "result_wait_ms": {"p50": float(np.percentile(lat, 50)),
                               "p95": float(np.percentile(lat, 95))}}


def twin_clips(device, first_batch):
    """[2, 32, 224, 224, 3]: the first TWIN_STEPS ticks that fresh
    SyntheticStreams (the served streams' seeds) deliver, through the same
    staging, copy and VPP; its first tick must equal the served one."""
    loader = SyntheticStreams(STREAMS, TUBELET, TWIN_STEPS * TUBELET, device)
    try:
        ticks = [batch.view(STREAMS, TUBELET, SIDE, SIDE, 3)
                 for batch, _ in loader]
    finally:
        loader.close()
    if len(ticks) != TWIN_STEPS or not bitwise_equal(ticks[0], first_batch):
        raise AssertionError("twin clips differ from the served frames")
    return torch.cat(ticks, dim=1)


def twin_check(model, clips, name, dtype):
    """The ring (max_steps TWIN_RING) fed TWIN_STEPS steps against the
    windowed causal batch twin on the flash kernel, per step, past the
    wrap too; the unwindowed twin must track the ring before the wrap and
    not after it. Returns the row; `ok` is the verdict."""
    rel = BF16_LOGIT_REL if dtype == torch.bfloat16 else F32_LOGIT_REL
    cache = init_stream_cache(model, STREAMS, TWIN_RING)
    depth = STREAM_VIT["depth"]
    twins = {}
    for kind, window in (("windowed", TWIN_RING), ("unwindowed", None)):
        twin = stream_vit(model.device, dtype, STREAM_KV[name],
                          temporal_window=window, use_flash=True)
        twin.load_state_dict(model.state_dict())
        twins[kind] = twin
    tubelets = [clips[:, s * TUBELET:(s + 1) * TUBELET]
                for s in range(TWIN_STEPS)]
    with torch.no_grad():
        got = torch.stack([stream_step(model, cache, f)[1] for f in tubelets],
                          dim=1)
        before = dict(fa.launches_by_mode)
        want = twins["windowed"](clips)
        modes = {m: fa.launches_by_mode[m] - before[m] for m in fa.MODES}
        full = twins["unwindowed"](clips)
    torch.cuda.synchronize()
    if modes != {"full": depth, "causal": 0, "band": depth}:
        raise AssertionError(f"twin {name} {dtype}: flash launches {modes}, "
                             f"want {depth} full and {depth} band")
    rule = logit_rule(got, want, rel)
    steps = (got.double() - want.double()).abs().amax(dim=(0, 2))
    before_wrap = max_abs_err(got[:, :TWIN_RING], full[:, :TWIN_RING])
    past_wrap = max_abs_err(got[:, TWIN_RING:], full[:, TWIN_RING:])
    return {"kv": name, "dtype": str(dtype).split(".")[-1],
            "flash_launches_by_mode": modes,
            "max_abs_err": rule["max_abs_err"], "bound": rule["bound"],
            "rel_bound": rel, "max_abs_logit": rule["max_abs_logit"],
            "rows_decided": rule["rows_decided"],
            "max_abs_err_by_step": steps.tolist(),
            "unwindowed_err_before_wrap": before_wrap,
            "unwindowed_err_past_wrap": past_wrap,
            "ok": (rule["ok"] and before_wrap <= rule["bound"]
                   and past_wrap > rule["bound"])}


def pool_stream_runs(rs, lats):
    """A model's runs of one kind, pooled: rates over all their timed
    ticks, means of the per-run step times."""
    seconds = sum(r["seconds"] for r in rs)
    ticks = STREAM_TIMED_TICKS * len(rs)
    lat = np.concatenate(lats)
    out = {"seconds": seconds, **tick_rates(ticks, seconds, lat),
           "host_ms_a_tick": float(np.mean([r["host_ms_a_tick"]
                                            for r in rs])),
           "idle_share": float(np.mean([r["idle_share"] for r in rs]))}
    for key in ("step_enqueue_ms", "step_call_enqueue_ms", "step_device_ms"):
        if key in rs[0]:
            out[key] = float(np.mean([r[key] for r in rs]))
    return out


def phase_streaming(device, smi):
    """Stateful live-stream serving at bench.py's configuration, MHA and
    GQA, each run eagerly and through cuda_graph from the same zeroed
    cache and frames (logits bit-equal at every tick, past the ring's
    wrap); then the twin check at full width in bf16 and f32 (TF32
    off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {(name, g): [] for name in STREAM_KV for g in (False, True)}
    lats = {key: [] for key in runs}
    twins = []
    equal = {name: [] for name in STREAM_KV}
    band_launches = full_launches = 0
    for name in STREAM_ORDER:
        model = stream_vit(device, torch.bfloat16, STREAM_KV[name])
        logits = {}
        for graphed in (False, True):
            logits[graphed], batch, row, lat = serve_stream(
                device, name, model, graphed)
            runs[name, graphed].append(row)
            lats[name, graphed].append(lat)
            if not graphed:
                first_batch = batch
        equal[name].append(bit_equal_ticks(logits[True], logits[False]))
        del logits
        if len(runs[name, False]) > 1:
            continue
        # The twin check, once a model.
        clips = twin_clips(device, first_batch)
        model32 = stream_vit(device, torch.float32, STREAM_KV[name])
        model32.load_state_dict(model.state_dict())
        for m, dtype in ((model, torch.bfloat16), (model32, torch.float32)):
            twins.append(twin_check(m, clips, name, dtype))
            band_launches += twins[-1]["flash_launches_by_mode"]["band"]
            full_launches += twins[-1]["flash_launches_by_mode"]["full"]
        del model32, clips
    pooled = {}
    for name in STREAM_KV:
        eager = runs[name, False]
        pooled[name] = {
            "kv_heads": STREAM_KV[name] or STREAM_VIT["num_heads"],
            "kv_cache_mib": eager[0]["kv_cache_mib"],
            **pool_stream_runs(eager, lats[name, False]), "runs": eager,
            "graphed": {**pool_stream_runs(runs[name, True],
                                           lats[name, True]),
                        "runs": runs[name, True],
                        "bit_equal_to_eager": equal[name]}}
    mha, gqa = pooled["mha"]["graphed"], pooled["gqa"]["graphed"]
    kv_mha, kv_gqa = pooled["mha"]["kv_cache_mib"], pooled["gqa"]["kv_cache_mib"]
    out = {"phase": "streaming", "card": smi, "streams": STREAMS,
           "tubelet": [TUBELET, SIDE, SIDE, 3], "model": STREAM_VIT,
           "compute": "bf16", "residual": "f32", "max_steps": STREAM_RING,
           "inflight": STREAM_INFLIGHT, "warmup_ticks": STREAM_WARMUP_TICKS,
           "timed_ticks": STREAM_TIMED_TICKS, "order": STREAM_ORDER,
           "mha": pooled["mha"], "gqa": pooled["gqa"],
           "serving_model_source": "graphed runs",
           "serving_model_steps_per_s": gqa["steps_per_s_a_stream"],
           "serving_model_fps": gqa["frames_per_s"],
           "serving_model_kv_mb": kv_gqa,
           "serving_model_kv_mb_mha": kv_mha,
           "serving_model_kv_ratio": kv_mha / kv_gqa,
           "serving_model_gqa_vs_mha": gqa["steps_per_s_a_stream"]
               / mha["steps_per_s_a_stream"],
           "twin": {"ring": TWIN_RING, "steps": TWIN_STEPS,
                    "clips": [STREAMS, TWIN_STEPS * TUBELET, SIDE, SIDE, 3],
                    "cases": twins},
           "flash_launches": {"full": full_launches, "band": band_launches}}
    emit(out)
    bad = [t for t in twins if not t["ok"]]
    if bad:
        raise AssertionError(f"twin check failed: {bad}")
    for name, runs_equal in equal.items():
        if not all(all(e) for e in runs_equal):
            raise AssertionError(f"streaming {name}: graphed logits differ "
                                 f"from eager ones: {runs_equal}")
    return out


def flash_flops(b, h, live_pairs, d):
    """4·d FLOP per live (row, col) pair a head: Q K^T and P V."""
    return 4.0 * b * h * live_pairs * d


# flash_times: the headline in both layouts the model can hand the kernel,
# the band mode where the JAX dispatch picks _band_kernel, and the streaming
# twin's spatial (full) and temporal (band) attention as its views.
FLASH_TIMED = [
    # name, (b, h, s, d), causal, window, layout[, kv heads]
    ("headline", FLASH_HEADLINE, False, None, "bhsd"),
    ("headline_model_layout", FLASH_HEADLINE, False, None, "bshd"),
    ("band_causal", (1, 2, 1024, 64), True, 64, "bhsd"),
    ("band_symmetric", (1, 2, 1024, 64), False, 64, "bhsd"),
    ("twin_spatial", (32, 6, 196, 64), False, None, "bshd"),
    ("twin_temporal", (392, 6, 16, 64), True, TWIN_RING, "bshd"),
    ("twin_temporal_gqa", (392, 6, 16, 64), True, TWIN_RING, "bshd", 2),
]


def time_flash(device, name, shape, causal, window, layout, kv_heads=None):
    """Kernel, plain version and scaled_dot_product_attention (a yardstick
    only: the port never calls it; it gets the boolean band mask where
    there is one, and GQA's kv heads as they are) on the same bf16 inputs.
    The bound counts the live (row, col) pairs that band_mask counts, each
    input read once and o written once."""
    b, h, s, d = shape
    hk = kv_heads or h
    q, k, v = _flash_case(b, h, hk, s, s, d, torch.bfloat16, 7, layout)
    mask = fa.band_mask(s, s, causal, window, q.device)
    live = s * s if mask is None else int(mask.sum())
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = {"enable_gqa": True} if hk != h else {}
    with torch.no_grad():
        ms, p10, p90 = time_ms(lambda: fa.flash_attention(
            q, k, v, causal=causal, window=window), device)
        plain_ms = time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal, window), device, iters=30, warmup=5)[0]
        library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, **gqa),
                             device)[0]
    flops = flash_flops(b, h, live, d)
    # q and o at h heads, k and v at hk, each moved once.
    nbytes = 2 * b * (h + hk) * s * d * q.element_size()
    flop_ms = flops / BF16_FLOP_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    return {"case": name, "shape": list(shape), "kv_heads": hk,
            "dtype": "bf16",
            "causal": causal, "window": window, "layout": layout,
            "live_pairs_a_head": live, "ms": ms, "p10_ms": p10,
            "p90_ms": p90, "plain_ms": plain_ms, "library_ms": library_ms,
            "flops": flops, "bytes": nbytes, "flop_bound_ms": flop_ms,
            "byte_bound_ms": byte_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "share_of_bound": bound_ms / ms, "library_over_kernel":
                library_ms / ms, "tflop_per_s": flops / ms / 1e9}


def phase_flash_times(device, smi, serving):
    """The flash kernel's times (FLASH_TIMED); the headline row's numbers
    also stand at the top level."""
    rows = [time_flash(device, *case) for case in FLASH_TIMED]
    head = rows[0]
    out = {"phase": "flash_times", "card": smi, **head,
           "library": "torch.nn.functional.scaled_dot_product_attention",
           "cases": rows,
           "forward_device_ms": serving["forward_device_ms"],
           "flash_share_of_forward":
               VIT["depth"] * head["ms"] / serving["forward_device_ms"]}
    emit(out)
    return out


# ------------------------------------------------------------- training

# bench.py's joint training configurations (bench_vit_train_joint,
# :748-821, and bench_vit_train_joint_long, :822-899), nothing cut:
# VideoViT at ViT-B width with joint space-time attention, bf16 compute and
# residual, SGD lr 1e-3 momentum 0.9; clips of 16 frames, B=4 at 224²
# (attention at [4, 12, 1568, 64]) and B=1 at 448² with remat on both paths
# (attention at [1, 12, 6272, 64]). Each runs with flash attention and on
# the materialized path from the same weights (init_vit, seed 0) and the
# same clips: the ramp batch of the JAX package's
# test_sharded_bf16_step_descends (brightness ramps over time, so the
# arrow-of-time task is learnable and the loss must fall), flip mask
# [T, F, T, F] cut to the batch.
TRAIN_VIT = dict(num_classes=1000, depth=12, dim=768, num_heads=12,
                 patch=16, tubelet_t=2, hidden_mult=4, attention="joint",
                 frames=16)
TRAIN_CONFIGS = (("joint", 4, 224, False), ("joint_long", 1, 448, True))
TRAIN_LR, TRAIN_MOMENTUM = 1e-3, 0.9
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
# The loss of the two paths on the first step: the bf16 model rule of
# tests/test_torch_video_vit.py (2e-2, as assert_allclose's atol and rtol).
TRAIN_LOSS_TOL = 2e-2
# The first step's gradients, flash against materialized on the same
# weights and clips: ||g_flash - g_mat|| / ||g_mat|| for each parameter;
# (worst, median) of them against these bounds, set from an H100's
# readings (PERF.md, Findings). In bf16 the worst leaves are the
# query and key weights: their gradient comes through dS, which the flash
# contract rounds to bf16 before dQ and dK. That left the plain flash
# path (the same cast points in torch ops) 0.127 from the f32 model's
# gradient where the materialized path (f32 dS) stayed within 0.020, so
# the bound sits at about twice the largest reading (0.158). In f32 both
# paths compute the same sums in other orders (read: 6.4e-6, 1.3e-7).
TRAIN_GRAD_BOUNDS = {torch.bfloat16: (0.3, 1e-2), torch.float32: (1e-4, 1e-5)}
FLASH_BWD_TIMED = (("train_joint", (4, 12, 1568, 64)),
                   ("train_joint_long", (1, 12, 6272, 64)))


def train_flops(batch, size):
    """bench.py's FLOP count of one step (:800-803): 3x the forward's
    dense layers, the O(S^2) score products and the tubelet embedding; a
    recompute (flash's backward, remat) is not counted."""
    dim, depth, mult = TRAIN_VIT["dim"], TRAIN_VIT["depth"], \
        TRAIN_VIT["hidden_mult"]
    patch, tub = TRAIN_VIT["patch"], TRAIN_VIT["tubelet_t"]
    s_joint = (TRAIN_VIT["frames"] // tub) * (size // patch) ** 2
    n_tok = batch * s_joint
    per_block = (8 * dim * dim + 4 * mult * dim * dim) * n_tok \
        + 4 * n_tok * s_joint * dim
    embed = 2 * n_tok * (patch * patch * 3 * tub) * dim
    return 3 * (depth * per_block + embed), n_tok, s_joint


def ramp_clips(batch, size, device):
    """The memorizable batch: uniform noise in [0, 0.25) plus a brightness
    ramp from 0 to 1 over the 16 frames, and its flip mask."""
    frames = TRAIN_VIT["frames"]
    rng = np.random.default_rng(2)
    ramp = np.linspace(0, 1, frames, dtype=np.float32)
    clips = (rng.uniform(0, .25, (batch, frames, size, size, 3))
             .astype(np.float32) + ramp[None, :, None, None, None])
    mask = np.array([True, False, True, False])[:batch]
    return (torch.from_numpy(clips).to(device),
            torch.from_numpy(mask).to(device))


def kernel_ms(prof):
    """{kernel name: device ms} of a torch.profiler run: the device's own
    records (kernels, copies, sets), not the ranges that record_function
    and the ATen ops mark on the device's timeline (is_user_annotation),
    which would count their kernels twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return {e.key: e.self_device_time_total / 1e3
            for e in prof.key_averages()
            if e.device_type == cuda and not e.is_user_annotation
            and e.self_device_time_total > 0}


def first_step_grads(model, opt):
    """Fills the returned dict with an f32 CPU copy of every parameter's
    gradient as the optimizer first sees it (the train step's own
    backward), by name; the hook then removes itself."""
    params = list(model.named_parameters())
    grads = {}

    def hook(optimizer, args, kwargs):
        handle.remove()
        grads.update({n: p.grad.detach().float().cpu() for n, p in params
                      if p.grad is not None})
    handle = opt.register_step_pre_hook(hook)
    return grads


# A key projection's bias adds the same vector to every key of a row's
# scores, a constant the softmax ignores: its gradient is 0 in exact
# arithmetic, so a relative norm there measures rounding alone.
ZERO_GRAD_SUFFIX = ".key.bias"


def grad_rule(got, want):
    """Each parameter's ||got - want|| / ||want|| (f64) over the names of
    `want` but the key biases (ZERO_GRAD_SUFFIX); a name missing from
    `got` counts as infinitely far. Returns (worst, its name, {name:
    relative norm})."""
    rel = {}
    for name, w in want.items():
        if name.endswith(ZERO_GRAD_SUFFIX):
            continue
        g = got.get(name)
        if g is None or g.shape != w.shape:
            rel[name] = float("inf")
            continue
        w = w.double()
        rel[name] = float((g.double() - w).norm() / w.norm().clamp_min(
            torch.finfo(torch.float64).tiny))
    worst = max(rel, key=rel.get)
    return rel[worst], worst, rel


def grad_summary(got, want, dtype, top=5):
    """grad_rule's worst and median leaf against TRAIN_GRAD_BOUNDS[dtype],
    and the `top` leaves furthest apart."""
    worst, leaf, rel = grad_rule(got, want)
    median = float(np.median(list(rel.values())))
    bound_worst, bound_median = TRAIN_GRAD_BOUNDS[dtype]
    return {"leaves": len(rel), "worst_rel_norm": worst, "worst_leaf": leaf,
            "median_rel_norm": median,
            "top": dict(sorted(rel.items(), key=lambda kv: -kv[1])[:top]),
            "bound_worst": bound_worst, "bound_median": bound_median,
            "ok": worst <= bound_worst and median <= bound_median}


def eager_step(model, opt):
    """make_vit_train_step's step without its CUDA graph."""
    return make_vit_train_step(model, opt).graphed.fn


def first_grads(device, size, remat, clips, mask, dtype, use_flash,
                flash_impl="auto"):
    """The first step's gradients of make_vit_train_step from train_run's
    weights and clips, in `dtype` (compute and residual); flash_impl
    "plain" runs the flash path's plain versions (the kernels' cast
    points, in torch ops, no launch)."""
    model = VideoViT(compute_dtype=dtype, residual_dtype=dtype,
                     use_flash=use_flash, flash_impl=flash_impl,
                     remat=remat, size=size, device=device, **TRAIN_VIT)
    init_vit(torch.Generator().manual_seed(0), model, tuple(clips.shape))
    opt = torch.optim.SGD(model.parameters(), lr=TRAIN_LR,
                          momentum=TRAIN_MOMENTUM)
    grads = first_step_grads(model, opt)
    eager_step(model, opt)(clips, mask)
    del model, opt
    torch.cuda.empty_cache()
    return grads


def train_run(device, name, batch, size, remat, use_flash, clips, mask,
              graphed=True):
    """TRAIN_WARMUP + TRAIN_STEPS steps of make_vit_train_step (through
    its CUDA graph, or eagerly with `graphed` False) with the kernels'
    counts at 0 just before; returns the run's row (an "outcome" of "OOM"
    where the card's memory ran out), the first step's gradients
    (first_step_grads) and every parameter after those steps on the host
    (both None after an OOM). A graphed run's row has its device ms a
    step from its own graph, replayed (the replays train the model on,
    after the parameters were read)."""
    flops, n_tok, s_joint = train_flops(batch, size)
    row = {"config": name, "use_flash": use_flash, "remat": remat,
           "graphed": graphed, "batch": batch, "size": size,
           "tokens": s_joint}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        model = VideoViT(compute_dtype=torch.bfloat16,
                         residual_dtype=torch.bfloat16, use_flash=use_flash,
                         remat=remat, size=size, device=device, **TRAIN_VIT)
        init_vit(torch.Generator().manual_seed(0), model, tuple(clips.shape))
        opt = torch.optim.SGD(model.parameters(), lr=TRAIN_LR,
                              momentum=TRAIN_MOMENTUM)
        step = (make_vit_train_step(model, opt) if graphed
                else eager_step(model, opt))
        grads = first_step_grads(model, opt)
        fa.reset_counts()
        out = [step(clips, mask) for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out += [step(clips, mask) for _ in range(TRAIN_STEPS)]
        torch.cuda.synchronize()
        seconds = time.monotonic() - t0
        launches = {"flash_fwd": fa.launches,
                    "flash_fwd_recompute": fa.recompute_launches,
                    "flash_bwd": fa.bwd_launches,
                    "flash_bwd_by_design": dict(fa.bwd_launches_by_design),
                    "dout_copies": fa.dout_copies}
        peak = torch.cuda.max_memory_allocated()
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        enqueue = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step(clips, mask)
            enqueue.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        if graphed:
            row.update(captures=step.graphed.captures,
                       replays=step.graphed.replays)
            device_ms = time_ms(step.graphed.graphs[0].replay, device,
                                iters=5, warmup=1)[0]
    except torch.cuda.OutOfMemoryError as e:
        row.update(outcome="OOM", error=str(e)[:200])
        return row, None, None
    finally:
        model = opt = step = None
        torch.cuda.empty_cache()
    step_ms = seconds / TRAIN_STEPS * 1e3
    row.update(
        outcome="ran", steps=len(out), warmup=TRAIN_WARMUP,
        timed_steps=TRAIN_STEPS,
        loss=[float(l) for l, _ in out], acc=[float(a) for _, a in out],
        step_ms=step_ms, tokens_per_s=n_tok / (step_ms / 1e3),
        flops_a_step=flops,
        mfu=flops / (step_ms / 1e3) / BF16_FLOP_PER_S,
        peak_memory_gib=peak / 2 ** 30, launches=launches,
        step_enqueue_ms=float(np.median(enqueue)))
    if graphed:
        row.update(step_device_ms=device_ms,
                   device_time_source="cuda_graph_replay",
                   idle_share=1 - device_ms / step_ms)
    return row, grads, params


def params_equal(got, want):
    """Names of the parameters whose bytes differ (all f32)."""
    return [n for n, w in want.items()
            if n not in got or not bitwise_equal(got[n], w)]


TRAIN_RUNS = (("flash", True, True), ("flash_eager", True, False),
              ("materialized", False, True))  # (key, use_flash, graphed)


def phase_training(device, smi):
    """bench.py's joint training configurations through init_vit and
    make_vit_train_step, each for 2 + 8 steps: flash through the step's
    CUDA graph, flash eagerly, materialized through the graph. Launches
    (12 flash forwards and 12 backwards a step, every backward through the
    wgmma design, 24 forwards with remat, none on the materialized path),
    step ms, tokens/s, MFU against the bf16 peak, peak memory, host ms,
    device ms (graph replay), replays and idle share; gates: the graphed
    flash run bit-equal to the eager one (every loss, every parameter
    after the 10 steps), a finite loss at every step, the two paths'
    first losses within the bf16 model rule, their first-step gradients
    leaf by leaf within TRAIN_GRAD_BOUNDS of each other, in bf16 and
    again with the model in f32, the flash path's loss falling over its
    first 8 steps. Printed beside them, to tell the kernels' part from
    the flash contract's: the bf16 first step of the flash path's plain
    versions against the kernels', and each bf16 path against the model
    in f32 on the materialized path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    depth = TRAIN_VIT["depth"]
    runs, failures = [], []
    for name, batch, size, remat in TRAIN_CONFIGS:
        clips, mask = ramp_clips(batch, size, device)
        rows, grads, params = {}, {}, {}
        for key, use_flash, graphed in TRAIN_RUNS:
            row, grads[key], params[key] = train_run(
                device, name, batch, size, remat, use_flash, clips, mask,
                graphed)
            rows[key] = row
            runs.append(row)
            if row["outcome"] != "ran":
                if use_flash:
                    failures.append(f"{name} {key}: {row['outcome']}")
                continue
            n = row["steps"]
            fwd = depth * n * (2 if remat else 1) if use_flash else 0
            want = {"flash_fwd": fwd,
                    "flash_fwd_recompute": depth * n if use_flash and remat
                    else 0,
                    "flash_bwd": depth * n if use_flash else 0}
            # bf16 at d = 64: every backward goes through the wgmma design.
            want["flash_bwd_by_design"] = {
                d: want["flash_bwd"] if d == "wgmma" else 0
                for d in fa.BWD_DESIGNS}
            got = {k: row["launches"][k] for k in want}
            if got != want:
                failures.append(f"{name} {key}: launches {got}, want {want}")
            if graphed and (row["captures"], row["replays"]) != (1, n + 2):
                failures.append(f"{name} {key}: {row['captures']} captures, "
                                f"{row['replays']} replays over {n} + 3 "
                                "steps, want 1 and all but the first")
            if not np.isfinite(row["loss"]).all():
                failures.append(f"{name} {key}: loss {row['loss']}")
        eager = rows["flash_eager"]
        rows["flash"]["graphed_vs_eager"] = check = {}
        if eager["outcome"] == "ran" and rows["flash"]["outcome"] == "ran":
            eager["idle_share"] = (1 - rows["flash"]["step_device_ms"]
                                   / eager["step_ms"])
            check["losses_bit_equal"] = (rows["flash"]["loss"]
                                         == eager["loss"])
            check["params_differing"] = params_equal(params["flash"],
                                                     params["flash_eager"])
            check["params"] = len(params["flash_eager"])
            if not check["losses_bit_equal"] or check["params_differing"]:
                failures.append(f"{name}: graphed flash steps differ from "
                                f"eager ones: {check}")
        del params
        grads = {True: grads["flash"], False: grads["materialized"]}
        rows = {True: rows["flash"], False: rows["materialized"]}
        flash, plain = rows[True], rows[False]
        if flash["outcome"] == "ran":
            losses = flash["loss"]
            flash["descends_over_8"] = losses[7] < losses[0]
            if not flash["descends_over_8"]:
                failures.append(f"{name}: loss did not fall over 8 steps "
                                f"{losses[:8]}")
        if flash["outcome"] == "ran" and plain["outcome"] == "ran":
            a, b = flash["loss"][0], plain["loss"][0]
            flash["first_loss_vs_materialized"] = {
                "flash": a, "materialized": b, "abs_err": abs(a - b),
                "bound": TRAIN_LOSS_TOL + TRAIN_LOSS_TOL * abs(b)}
            if abs(a - b) > TRAIN_LOSS_TOL + TRAIN_LOSS_TOL * abs(b):
                failures.append(f"{name}: first loss {a} (flash) against "
                                f"{b} (materialized)")
            flash["speedup_over_materialized"] = (plain["step_ms"]
                                                  / flash["step_ms"])
            grads["plain"] = first_grads(device, size, remat, clips, mask,
                                         torch.bfloat16, True, "plain")
            for use_flash in (True, False):
                grads["f32", use_flash] = first_grads(
                    device, size, remat, clips, mask, torch.float32,
                    use_flash)
            f32 = grads["f32", False]
            for key, got, want, dtype, gate in (
                    ("first_grads_vs_materialized", grads[True],
                     grads[False], torch.bfloat16, True),
                    ("f32_first_grads_vs_materialized", grads["f32", True],
                     f32, torch.float32, True),
                    ("first_grads_vs_plain_flash", grads[True],
                     grads["plain"], torch.bfloat16, False),
                    ("flash_vs_f32_materialized", grads[True], f32,
                     torch.bfloat16, False),
                    ("plain_flash_vs_f32_materialized", grads["plain"], f32,
                     torch.bfloat16, False),
                    ("materialized_vs_f32_materialized", grads[False], f32,
                     torch.bfloat16, False)):
                flash[key] = grad_summary(got, want, dtype)
                if gate and not flash[key]["ok"]:
                    failures.append(f"{name}: {key}: {flash[key]}")
        del clips, mask, grads
    out = {"phase": "training", "card": smi,
           "model": TRAIN_VIT, "compute": "bf16", "residual": "bf16",
           "optimizer": {"sgd_lr": TRAIN_LR, "momentum": TRAIN_MOMENTUM},
           "peak_flop_per_s": BF16_FLOP_PER_S,
           "peak_source": "NVIDIA H100 SXM5 data sheet, dense bf16",
           "flops": "bench.py:800-803 (no recompute counted)",
           "runs": runs, "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"training phase failed: {failures}")
    return out


BWD_SPLIT_CALLS = 20


def bwd_split(call):
    """{kernel: device ms a call} of the backward's kernels (Delta, Dkv,
    Dq) over BWD_SPLIT_CALLS calls under torch.profiler."""
    call()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(BWD_SPLIT_CALLS):
            call()
        torch.cuda.synchronize()
    split = {}
    for key, ms in kernel_ms(prof).items():
        name = bwd_kernel(key)
        if name is not None:
            split[name] = split.get(name, 0.0) + ms / BWD_SPLIT_CALLS
    return split


def time_flash_bwd(device, name, shape):
    """The backward kernel at a training shape (bf16, the model's [B, S,
    H, d] views, residuals from the forward kernel) beside its plain
    version and the backward of scaled_dot_product_attention (a yardstick
    only: the port never calls it), and its kernels apart (bwd_split).
    The bound counts the five products, 10 * B*H*S*S*d FLOP, and each
    input (q, k, v, o, dO, l, m) read and each gradient written once; the
    seven products the two kernels run (S and dP in both) are beside
    it."""
    b, h, s, d = shape
    q, k, v = _flash_case(b, h, h, s, s, d, torch.bfloat16, 8, "bshd")
    do = _grad_out(b, h, s, d, torch.bfloat16, 9, "bshd")
    o, l, m = fa.flash_attention_fwd(q, k, v)
    before = dict(fa.bwd_launches_by_design)
    ms, p10, p90 = time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, l, m,
                                                          do), device)
    designs = [x for x in fa.BWD_DESIGNS
               if fa.bwd_launches_by_design[x] != before[x]]
    split = bwd_split(lambda: fa.flash_attention_bwd(q, k, v, o, l, m, do))
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, l, m, do), device, iters=10, warmup=2)[0]
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves)
    library_ms = time_ms(lambda: torch.autograd.grad(
        out, leaves, do, retain_graph=True), device)[0]
    del out, leaves
    flops = 10.0 * b * h * s * s * d
    nbytes = 8 * b * h * s * d * q.element_size() + 2 * b * h * s * 4
    flop_ms = flops / BF16_FLOP_PER_S * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    run_flops = 14.0 * b * h * s * s * d
    return {"case": name, "shape": list(shape), "dtype": "bf16",
            "layout": "bshd", "designs": designs, "split_ms": split,
            "ms": ms, "p10_ms": p10, "p90_ms": p90,
            "plain_ms": plain_ms, "library_ms": library_ms, "flops": flops,
            "bytes": nbytes, "flop_bound_ms": flop_ms,
            "byte_bound_ms": byte_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
            "share_of_bound": bound_ms / ms,
            "library_over_kernel": library_ms / ms,
            "tflop_per_s": flops / ms / 1e9,
            "seven_product_flops": run_flops,
            "seven_product_bound_ms": run_flops / BF16_FLOP_PER_S * 1e3,
            "seven_product_tflop_per_s": run_flops / ms / 1e9}


# The flash backward's kernels (csrc/flash_bwd.cu), each name before any
# that it contains.
BWD_KERNELS = ("DeltaTiles", "Delta", "DkvWgmma", "DqWgmma", "DkvBf16",
               "DqBf16", "DkvF32", "DqF32")


def bwd_kernel(key):
    """The flash backward kernel a device record's name holds, or None."""
    return next((w for w in BWD_KERNELS if w in key), None)


def kernel_group(key):
    """The group a device record of train_profile counts under: the flash
    backward (its three kernels of any design), the flash forward, cuBLAS
    GEMMs or the rest."""
    if bwd_kernel(key) is not None:
        return "flash_bwd"
    if "FlashFwd" in key:
        return "flash_fwd"
    if any(w in key.lower() for w in ("gemm", "xmma", "cutlass", "nvjet",
                                       "sm90")):
        return "gemm"
    return "other"


def train_profile(device, name, use_flash, replay_ms, top=8):
    """Where a training step's device time goes: one eager step of a
    TRAIN_CONFIGS run after 3 warm-up steps, under torch.profiler; the
    device's records (kernel_ms) summed by group (the flash kernels,
    cuBLAS GEMMs, the rest) and the `top` kernels, in ms, beside
    `replay_ms`, the phase training's graph replay of the same step."""
    _, batch, size, remat = next(c for c in TRAIN_CONFIGS if c[0] == name)
    clips, mask = ramp_clips(batch, size, device)
    model = VideoViT(compute_dtype=torch.bfloat16,
                     residual_dtype=torch.bfloat16, use_flash=use_flash,
                     remat=remat, size=size, device=device, **TRAIN_VIT)
    step = eager_step(model, torch.optim.SGD(
        model.parameters(), lr=TRAIN_LR, momentum=TRAIN_MOMENTUM))
    for _ in range(3):
        step(clips, mask)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(clips, mask)
        torch.cuda.synchronize()
    kernels = kernel_ms(prof)
    del model, step, clips, mask, prof
    torch.cuda.empty_cache()

    groups = {}
    for key, ms in kernels.items():
        groups[kernel_group(key)] = groups.get(kernel_group(key), 0.0) + ms
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    device_ms = sum(kernels.values())
    return {"config": name, "use_flash": use_flash, "device_ms": device_ms,
            "graph_replay_ms": replay_ms,
            "device_over_replay": device_ms / replay_ms,
            "groups_ms": groups, "kernels": len(kernels),
            "top_ms": dict(ranked)}


def phase_train_profile(device, training):
    """train_profile of each training run that ran; the sum of a step's
    device records should come within a few % of its graph replay (the
    replay adds the gaps between kernels)."""
    rows = [train_profile(device, r["config"], r["use_flash"],
                          r["step_device_ms"])
            for r in training["runs"]
            if r["outcome"] == "ran" and r["graphed"]]
    out = {"phase": "train_profile", "source": "torch.profiler, "
           "device records without user annotations", "runs": rows}
    emit(out)
    return out


def phase_flash_bwd_times(device, smi):
    rows = [time_flash_bwd(device, *case) for case in FLASH_BWD_TIMED]
    out = {"phase": "flash_bwd_times", "card": smi, **rows[0],
           "library": "backward of "
                      "torch.nn.functional.scaled_dot_product_attention",
           "cases": rows}
    emit(out)
    return out


# The training shapes as the model hands them over ([B, S, H, d] views),
# seeded as time_flash_bwd seeds them; needs nothing of the other
# checkout but its wrapper.
FLASH_BWD_AB_SNIPPET = """
import json, numpy as np, torch
from tensor_stream_torch.ops import flash_attention as fa
HOLD_CYCLES = {hold}
{timer}
dev = torch.device("cuda", 0)
rows = []
for b, h, s, d in {shapes}:
    gen = torch.Generator().manual_seed(8)
    q, k, v = [(torch.randn((b, s, h, d), generator=gen) * std).to(
        dev, torch.bfloat16).transpose(1, 2) for std in {stds}]
    do = torch.randn((b, s, h, d), generator=gen).to(
        dev, torch.bfloat16).transpose(1, 2)
    o, l, m = fa.flash_attention_fwd(q, k, v)
    rows.append(time_ms(lambda: fa.flash_attention_bwd(q, k, v, o, l, m, do),
                        dev))
print(json.dumps(rows))
"""

FLASH_AB_SNIPPET = """
import json, numpy as np, torch, chip_smoke as c
from tensor_stream_torch.ops import flash_attention as fa
HOLD_CYCLES = {hold}
{timer}
q, k, v = c._flash_case(*{shape}, torch.bfloat16, 7, {layout!r})
print(json.dumps(time_ms(lambda: fa.flash_attention(q, k, v),
                         torch.device("cuda", 0))))
"""

# Seeds as seeded_nv12 (seed 5, as phase_times) so both checkouts convert
# the same bytes; needs nothing of the other checkout but its wrapper.
NV12_AB_SNIPPET = """
import json, numpy as np, torch
from tensor_stream_torch.ops import nv12_rgb
HOLD_CYCLES = {hold}
{timer}
dev = torch.device("cuda", 0)
rows = []
for n, h, w, planar, norm in {shapes}:
    rng = np.random.default_rng(5)
    flat = torch.from_numpy(rng.integers(0, 256, n * h * w * 3 // 2,
                                         dtype=np.uint8)).to(dev)
    y = flat[:n * h * w].view(n, h, w)
    uv = flat[n * h * w:].view(n, h // 2, w)
    rows.append(time_ms(lambda: nv12_rgb.nv12_to_rgb(y, uv, False, planar,
                                                     norm, 0), dev))
print(json.dumps(rows))
"""


# Seeds as phase_resize_times (seeded_nv12, seed 90); needs nothing of the
# other checkout but its NV12Resize.
RESIZE_AB_SNIPPET = """
import json, numpy as np, torch
from tensor_stream_torch.enums import ResizeType
from tensor_stream_torch.ops import resize
HOLD_CYCLES = {hold}
{timer}
dev = torch.device("cuda", 0)
rows = []
for algo, n, (sw, sh), (dw, dh) in {shapes}:
    rng = np.random.default_rng(90)
    flat = torch.from_numpy(rng.integers(0, 256, n * sh * sw * 3 // 2,
                                         dtype=np.uint8)).to(dev)
    y = flat[:n * sh * sw].view(n, sh, sw)
    uv = flat[n * sh * sw:].view(n, sh // 2, sw)
    r = resize.NV12Resize(sw, sh, dw, dh, ResizeType[algo])
    rows.append(time_ms(lambda: r(y, uv), dev))
    del flat, y, uv
print(json.dumps(rows))
"""


# The parts of resize_area_down_nv12 timed apart (area_split): the kernel
# as it is, then copies of its source with one part cut out, each one
# replacement in csrc/resize_nv12.cu.
AREA_SPLIT = {
    "kernel": None,
    "staging_only": ("  if (b.j < 0) return;\n",
                     "  if (b.j < 0 || b.j >= 0) return;\n"),
    "blend_only": ("Stage(smem + a.taps_bytes + f * a.rows_bytes,\n"
                   "                                b.src + f * b.batch, b, "
                   "b.row_lo, b.nrows)",
                   "Mod16(b.src + f * b.batch, b.pitch, b.row_lo, "
                   "b.col_lo)"),
    "launch_floor": ("  if (b.ncols == 0) return;",
                     "  if (b.ncols >= 0) return;"),
}


def area_split(device=None):
    """resize_area_down_nv12 at AREA_VARIANT_SHAPES under its chosen plan,
    whole and in parts: staging only (every block stages its bands, then
    stops), blend only (no source copied: the taps blend whatever the
    shared memory holds) and the launch floor (each block locates itself
    and stops). ncu cannot run on the card's machine; these times say
    which part bounds the kernel. Builds each cut copy with nvcc under
    build/; the kernel's bytes are checked in phase_resize_vs_plain."""
    device = device or torch.device("cuda", 0)
    src = open(os.path.join(_build.SRC_DIR, "resize_nv12.cu")).read()
    out_dir = os.path.join(_build.BUILD_DIR, "area_split")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, cut in AREA_SPLIT.items():
        text = src
        if cut is not None:
            if text.count(cut[0]) != 1:
                raise AssertionError(f"area_split {name}: the line to cut "
                                     "is not in resize_nv12.cu")
            text = text.replace(cut[0], cut[1])
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS,
             *_build.SOURCE_FLAGS["resize_nv12"], "-I", _build.SRC_DIR,
             "-o", so, cu], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"area_split {name}: nvcc failed:\n{log}")
        fns[name] = resize_ops.bind(ctypes.CDLL(so))
    rows = []
    kept = resize_ops._lib()
    try:
        for n, (sw, sh), (dw, dh) in AREA_VARIANT_SHAPES:
            flat = torch.from_numpy(seeded_nv12(n, sh, sw, 90)).to(device)
            y, uv = split(flat, n, sh, sw)
            r = resize_ops.NV12Resize(sw, sh, dw, dh, ResizeType.AREA)
            for name in AREA_SPLIT:
                resize_ops._FNS = fns[name]
                ms, p10, p90 = time_ms(lambda: r(y, uv), device)
                rows.append({"shape": [n, sw, sh, dw, dh], "part": name,
                             **area_plan_row(r, n, device), "ms": ms,
                             "p10_ms": p10, "p90_ms": p90})
            del flat, y, uv
    finally:
        resize_ops._FNS = kept
    emit({"phase": "area_split", "card": nvidia_smi(), "rows": rows})
    return rows


def ab_turns(other_root, code, blocks):
    """Runs `code` in the checkout at `other_root` (for example the parent
    commit, unpacked with git archive) and in this one, on one card in
    turns: other, this, this, other, `blocks` times. Each turn is its own
    process, which builds its checkout's kernels; `code` times them with
    this checkout's time_ms and prints one JSON value last. Returns
    ({"other": [...], "this": [...]}, order, roots)."""
    roots = {"other": os.path.abspath(other_root), "this": HERE}
    order = ["other", "this", "this", "other"] * blocks
    got = {"other": [], "this": []}
    for which in order:
        out = subprocess.run([sys.executable, "-c", code], cwd=roots[which],
                             check=True, capture_output=True, text=True,
                             timeout=600)
        got[which].append(json.loads(out.stdout.strip().splitlines()[-1]))
    return got, order, roots


def flash_ab(other_root, blocks=1):
    """The headline flash time of the checkout at `other_root` against
    this one's (ab_turns). Prints and returns {"other": [...], "this":
    [...]} of (median, p10, p90) ms."""
    b, h, s, d = FLASH_HEADLINE
    code = FLASH_AB_SNIPPET.format(hold=HOLD_CYCLES,
                                   timer=inspect.getsource(time_ms),
                                   shape=(b, h, h, s, s, d), layout="bhsd")
    got, order, roots = ab_turns(other_root, code, blocks)
    emit({"phase": "flash_ab", "card": nvidia_smi(),
          "shape": list(FLASH_HEADLINE), "order": order, **got,
          "roots": roots})
    return got


def flash_bwd_ab(other_root, blocks=1):
    """The flash backward's time at each training shape (FLASH_BWD_TIMED)
    in the checkout at `other_root` against this one's (ab_turns). Prints
    and returns {"other": [...], "this": [...]}: a list a turn of (median,
    p10, p90) ms a shape."""
    shapes = [shape for _, shape in FLASH_BWD_TIMED]
    code = FLASH_BWD_AB_SNIPPET.format(
        hold=HOLD_CYCLES, timer=inspect.getsource(time_ms), shapes=shapes,
        stds=(FLASH_QK_STD, FLASH_QK_STD, FLASH_V_STD))
    got, order, roots = ab_turns(other_root, code, blocks)
    emit({"phase": "flash_bwd_ab", "card": nvidia_smi(),
          "shapes": [list(s) for s in shapes], "order": order, **got,
          "roots": roots})
    return got


def nv12_ab(other_root, blocks=1):
    """The NV12 kernel's time at each NV12_TIMED shape in the checkout at
    `other_root` against this one's (ab_turns). Prints and returns
    {"other": [...], "this": [...]}: a list a turn of (median, p10, p90)
    ms a shape."""
    code = NV12_AB_SNIPPET.format(hold=HOLD_CYCLES,
                                  timer=inspect.getsource(time_ms),
                                  shapes=NV12_TIMED)
    got, order, roots = ab_turns(other_root, code, blocks)
    emit({"phase": "nv12_ab", "card": nvidia_smi(),
          "shapes": [list(s) for s in NV12_TIMED], "order": order, **got,
          "roots": roots})
    return got


def resize_ab(other_root, blocks=1):
    """Each RESIZE_TIMED shape in the checkout at `other_root` against
    this one's (ab_turns), with the AREA-down plan this checkout launches
    there. Prints and returns {"other": [...], "this": [...]}: a list a
    turn of (median, p10, p90) ms a shape."""
    shapes = [(a.name, n, src, dst) for a, n, src, dst in RESIZE_TIMED]
    code = RESIZE_AB_SNIPPET.format(hold=HOLD_CYCLES,
                                    timer=inspect.getsource(time_ms),
                                    shapes=shapes)
    got, order, roots = ab_turns(other_root, code, blocks)
    device = torch.device("cuda", 0)
    plans = []
    for a, n, (sw, sh), (dw, dh) in RESIZE_TIMED:
        r = resize_ops.NV12Resize(sw, sh, dw, dh, a)
        plans.append(area_plan_row(r, n, device)["variant"]
                     if r.kernel == "resize_area_down_nv12" else None)
    median = {k: [float(np.median([turn[i][0] for turn in v]))
                  for i in range(len(shapes))] for k, v in got.items()}
    emit({"phase": "resize_ab", "card": nvidia_smi(),
          "shapes": [list(s) for s in shapes], "area_variants": plans,
          "order": order, **got, "median_ms": median,
          "other_over_this": [o / t for o, t in zip(median["other"],
                                                    median["this"])],
          "roots": roots})
    return got


# --------------------------------------------------------- the model layer
# python_examples/latent_video_generation.py's pipeline: 1080p NV12 through
# the clip path's device program (the BILINEAR resize kernel and NV12->RGB,
# merged, normalized, no augmentation) to its batch of 4 clips of 8 frames,
# at 256² (multi_stream_inference.py's default size); the module defaults
# VideoVAE(base=32, latent=8) and VideoDiT(depth=4, dim=192, num_heads=3),
# bf16, trained with Adam. The DiT takes the example's lr, 2e-4. The VAE
# takes 1e-4: at base 32 the example's 1e-3 (set for base 16 at 64²)
# diverges in the first Adam steps, in the JAX package as in the port
# (tests/test_torch_video_vae.py::
# test_adam_trajectory_matches_jax_where_both_diverge).
GEN_CLIPS, GEN_CLIP_LEN, GEN_SIDE = 4, 8, 256
GEN_VAE = dict(base=32, latent=8)
GEN_DIT = dict(depth=4, dim=192, num_heads=3)
GEN_VAE_LR, GEN_DIT_LR = 1e-4, 2e-4
GEN_CLASSES, GEN_LABEL_DROPOUT = 10, 0.1
GEN_TIMESTEPS, GEN_DDIM_STEPS, GEN_GUIDANCE = 1000, 25, 3.0
MODEL_WARMUP, MODEL_STEPS = 2, 8
# A card forward in bf16 against the port's own f32 forward on the CPU from
# the same weights, as a relative L2 norm of the outputs. Each bf16 layer
# on the path rounds its input and its weights (2^-8 relative each), and
# independent roundings add in quadrature: the VAE's encode and decode
# chain 16 convs, sqrt(2 * 16) * 2^-8 = 2.2e-2 (a CPU run at base 8 lands
# at 1.7e-2); the bound is about twice that. The DiT's sublayers add into
# an f32 residual behind gates, and sits far below it.
MODEL_F32_REL = 5e-2
# VideoMoE at its defaults (4 experts, depth 4, dim 192, 3 heads, patch 16,
# tubelet 2), bf16, B=4 clips of 16 x 224²: 1568 tokens a group, capacity
# 490; the arrow-of-time task on the ramp batch, Adam as the JAX package's
# test_moe_train_step_descends.
MOE_BATCH, MOE_LR = 4, 3e-3
# multi_stream_inference.py: two streams, 4 frames a stream a tick at 256²,
# planar and normalized, x255 NHWC into TransformerNet.
STYLE_PER_STREAM, STYLE_SIDE = 4, 256
STYLE_WARMUP, STYLE_TICKS = 2, 24
# serving_inference.py's int8 serving: top-1 against the f32 weights'
# logits and the relative max logit error of tests/test_quantize.py:53-70.
QUANT_REL = 0.05


def expect_launches(label, got, want):
    if got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}: the "
                             "path bypassed a kernel")


@contextlib.contextmanager
def cudnn_flags(**flags):
    """torch.backends.cudnn's `flags` (deterministic, allow_tf32) for the
    block's duration. The conv phases compare graphed and eager steps bit
    for bit, which needs cuDNN's deterministic algorithms (a weight
    gradient summed with atomics differs by run)."""
    before = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in before.items():
            setattr(torch.backends.cudnn, k, v)


def as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def outputs_equal(a, b):
    return all(bitwise_equal(x, y) for x, y in zip(as_tuple(a),
                                                   as_tuple(b)))


def profile_call(fn, args, top=6):
    """The device's records (kernel_ms) of one call of `fn` under
    torch.profiler: their sum, by kernel_group ("gemm" takes cuDNN's
    implicit-GEMM convolutions too) and the `top` kernels, in ms."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn(*args)
        torch.cuda.synchronize()
    kernels = kernel_ms(prof)
    groups = {}
    for key, ms in kernels.items():
        groups[kernel_group(key)] = groups.get(kernel_group(key), 0.0) + ms
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ms": sum(kernels.values()), "groups_ms": groups,
            "kernels": len(kernels), "top_ms": dict(ranked)}


def train_twins(label, build, make_step, args, device):
    """MODEL_WARMUP + MODEL_STEPS steps of a model's train step through its
    CUDA graph, then as many of the same step eagerly on a twin built
    alike (`build()` -> (model, optimizer); `make_step(model, optimizer,
    generator)`; both generators seeded 1). Gates: every output of every
    step and every parameter after the steps bit-equal, one capture and a
    replay for every call but the first, finite losses. One more eager
    step of the twin runs under the profiler. Returns (the row, the
    graphed model, its step)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    calls = MODEL_WARMUP + MODEL_STEPS

    def gen():
        return torch.Generator(device=device).manual_seed(1)
    model, opt = build()
    step = make_step(model, opt, gen())
    out = [step(*args) for _ in range(MODEL_WARMUP)]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out += [step(*args) for _ in range(MODEL_STEPS)]
    torch.cuda.synchronize()
    seconds = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    check_replays(step.graphed, calls, label)
    enqueue = []
    for _ in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(*args)
        enqueue.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    device_ms = time_ms(step.graphed.graphs[0].replay, device, iters=5,
                        warmup=1)[0]
    twin, twin_opt = build()
    eager = make_step(twin, twin_opt, gen()).graphed.fn
    twin_out = [eager(*args) for _ in range(calls)]
    steps_equal = [outputs_equal(a, b) for a, b in zip(out, twin_out)]
    differing = params_equal({n: p.detach() for n, p in
                              twin.named_parameters()}, params)
    profile = profile_call(eager, args)
    del twin, twin_opt, eager, twin_out, params
    losses = [float(as_tuple(o)[0]) for o in out]
    step_ms = seconds / MODEL_STEPS * 1e3
    row = {"steps": calls, "loss": losses, "step_ms": step_ms,
           "host_ms_a_call": float(np.median(enqueue)),
           "step_device_ms": device_ms,
           "device_time_source": "cuda_graph_replay",
           "idle_share": 1 - device_ms / step_ms,
           "peak_memory_gib": peak / 2 ** 30,
           "captures": step.graphed.captures,
           "replays": step.graphed.replays,
           "graphed_vs_eager": {"steps_bit_equal": all(steps_equal),
                                "params_differing": differing,
                                "params": len(list(model.parameters()))},
           "finite": bool(np.isfinite(losses).all()),
           "descends": float(np.mean(losses[-4:])) < losses[0],
           "eager_step_profile": profile}
    if not all(steps_equal) or differing:
        raise AssertionError(f"{label}: graphed steps differ from eager "
                             f"ones: steps {steps_equal}, params "
                             f"{differing[:5]}")
    if not row["finite"]:
        raise AssertionError(f"{label}: losses {losses}")
    return row, model, step


def adam_build(make_model, lr):
    def build():
        model = make_model()
        return model, torch.optim.Adam(model.parameters(), lr=lr)
    return build


def generation_clips(device):
    """4 clips of 8 frames of 256² RGB merged f32 from seeded 1080p NV12,
    through build_vpp_clip_augment with no augmentation (the clip path's
    device program: the BILINEAR resize kernel, then NV12->RGB)."""
    cfg = VPPConfig(*HEADLINE_SRC, width=GEN_SIDE, height=GEN_SIDE,
                    resize_type=ResizeType.BILINEAR, fourcc=FourCC.RGB24,
                    planes=Planes.MERGED, normalization=True)
    n = GEN_CLIPS * GEN_CLIP_LEN
    flat = torch.from_numpy(seeded_nv12(n, HEADLINE_SRC[1], HEADLINE_SRC[0],
                                        47)).to(device)
    fn = build_vpp_clip_augment(cfg, AugmentConfig(), GEN_CLIPS,
                                GEN_CLIP_LEN, 0, device)
    ids = np.stack([np.zeros(GEN_CLIPS, np.int64),
                    np.arange(GEN_CLIPS)], axis=1)
    clips = fn(flat, ids)
    want = (GEN_CLIPS, GEN_CLIP_LEN, GEN_SIDE, GEN_SIDE, 3)
    if tuple(clips.shape) != want or not bool(torch.isfinite(clips).all()):
        raise AssertionError(f"generation: clips {tuple(clips.shape)}")
    return clips


def f32_cpu_check(label, model, cpu_model, fn):
    """`fn(model, on)` on the card (bf16) against `fn(cpu_model, "cpu")`
    with the card model's weights in f32 on the CPU."""
    cpu_model.load_state_dict({k: v.cpu() for k, v in
                               model.state_dict().items()})
    with torch.no_grad():
        got = fn(model, model.device).float()
        want = fn(cpu_model, torch.device("cpu"))
    err = _rel_norm(got.cpu(), want)
    row = {"rel_norm": err, "bound": MODEL_F32_REL,
           "max_abs_err": max_abs_err(got.cpu(), want),
           "max_abs": float(want.abs().max())}
    if not err <= MODEL_F32_REL:
        raise AssertionError(f"{label}: bf16 card forward against the f32 "
                             f"CPU forward: {row}")
    return row


def sample_run(label, sampler, noise, y, device):
    """The graphed DDIM sampler: its warm-up and its first replay against
    the eager sampler, bit for bit; ms a batch (graph replay) and one
    graphed call's wall ms."""
    args = (noise,) if y is None else (noise, y)
    eager = sampler.fn(*args)
    warm = sampler(*args)
    got = sampler(*args)
    check_replays(sampler, 2, label)
    if not (bitwise_equal(got, eager) and bitwise_equal(warm, eager)):
        raise AssertionError(f"{label}: graphed sampler != eager sampler")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite samples")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    sampler(*args)
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) * 1e3
    ms = time_ms(sampler.graphs[0].replay, device, iters=3, warmup=1)[0]
    return got, {"steps": GEN_DDIM_STEPS, "ms_a_batch": ms,
                 "wall_ms_a_call": wall, "graphed_vs_eager": "bitwise equal"}


@cudnn_flags(deterministic=True)
def phase_generation(device, smi):
    """latent_video_generation.py on the card: clips from 1080p NV12
    through the clip path's device program; the VAE trained (2 + 8 graphed
    Adam steps), its frozen encoder to latents; the DiT trained
    unconditionally and class-conditionally (2 + 8 graphed Adam steps
    each); DDIM (25 steps) unconditional and with guidance w = 3; the
    decoder. Gates: every graphed step and sampler bit-equal to eager,
    finite and falling losses, the bf16 VAE and DiT forwards against the
    port's f32 CPU forwards from the same weights, finite decoded clips
    of the input's shape."""
    reset_resize_counts()
    clips = generation_clips(device)
    torch.cuda.synchronize()
    launches = resize_counts()
    expect_launches("generation", {k: launches[k] for k in (
        "nv12_rgb", "resize_bilinear_nv12")}, {"nv12_rgb": 1,
                                               "resize_bilinear_nv12": 1})
    failures = []
    rows = {}

    def vae_model(dtype=torch.bfloat16, on=device):
        return VideoVAE(**GEN_VAE, compute_dtype=dtype, device=on,
                        generator=torch.Generator().manual_seed(0))
    rows["vae"], vae, vae_step = train_twins(
        "generation vae", adam_build(vae_model, GEN_VAE_LR),
        lambda m, o, g: make_vae_train_step(m, o, generator=g), (clips,),
        device)
    del vae_step
    rows["vae"]["f32_cpu"] = f32_cpu_check(
        "generation vae", vae, vae_model(torch.float32, "cpu"),
        lambda m, on: m.decode(m.encode(clips[:1].to(on))[0]))
    with torch.no_grad():
        latents, _ = vae.encode(clips)
        recon = vae.decode(latents)
    rows["vae"]["psnr_db"] = float(psnr(recon, clips).mean())
    rows["vae"]["ssim"] = float(ssim(recon, clips).mean())
    lat_shape = tuple(latents.shape)
    if lat_shape != (GEN_CLIPS, GEN_CLIP_LEN // 2, GEN_SIDE // 4,
                     GEN_SIDE // 4, GEN_VAE["latent"]):
        raise AssertionError(f"generation: latents {lat_shape}")
    sched = DiffusionSchedule(GEN_TIMESTEPS, device=device)
    labels = torch.from_numpy(np.random.default_rng(5).integers(
        0, GEN_CLASSES, GEN_CLIPS)).to(device)
    samples = {}
    for name, classes in (("dit", 0), ("dit_conditional", GEN_CLASSES)):
        def dit_model(dtype=torch.bfloat16, on=device, classes=classes):
            return VideoDiT(lat_shape[1:], **GEN_DIT, num_classes=classes,
                            compute_dtype=dtype, device=on,
                            generator=torch.Generator().manual_seed(0))
        if classes:
            args = (latents, labels)

            def make(m, o, g):
                return make_conditional_diffusion_train_step(
                    m, sched, o, GEN_LABEL_DROPOUT, generator=g)
        else:
            args = (latents,)

            def make(m, o, g):
                return make_diffusion_train_step(m, sched, o, generator=g)
        rows[name], dit, dit_step = train_twins(
            f"generation {name}", adam_build(dit_model, GEN_DIT_LR), make,
            args, device)
        del dit_step
        t_check = torch.full((1,), GEN_TIMESTEPS // 2, device=device)
        y_check = labels[:1] if classes else None
        rows[name]["f32_cpu"] = f32_cpu_check(
            f"generation {name}", dit, dit_model(torch.float32, "cpu"),
            lambda m, on: m(latents[:1].to(on), t_check.to(on),
                            None if y_check is None else y_check.to(on)))
        noise = torch.randn(lat_shape, device=device, generator=torch.
                            Generator(device=device).manual_seed(3))
        w = GEN_GUIDANCE if classes else 0.0
        sampler = make_ddim_sampler(dit, sched, GEN_DDIM_STEPS, w)
        samples[name], rows[name]["ddim"] = sample_run(
            f"generation {name} ddim", sampler, noise,
            labels if classes else None, device)
        rows[name]["ddim"]["guidance_scale"] = w
        del sampler, dit
    # Falls: the mean of the last 4 losses under the first (a diffusion
    # step's loss moves with its t, drawn anew every step).
    for name in ("vae", "dit", "dit_conditional"):
        if not rows[name]["descends"]:
            failures.append(f"{name}: loss did not fall over "
                            f"{rows[name]['steps']} steps "
                            f"{rows[name]['loss']}")
    decoded = {}
    with torch.no_grad():
        for name, z in samples.items():
            out = vae.decode(z)
            decoded[name] = tuple(out.shape)
            if (out.shape != clips.shape
                    or not bool(torch.isfinite(out).all())):
                failures.append(f"{name}: decoded {tuple(out.shape)} or "
                                "non-finite")
    out = {"phase": "generation", "card": smi,
           "clips": list(clips.shape), "latents": list(lat_shape),
           "input_launches": {"nv12_rgb": launches["nv12_rgb"],
                              "resize_bilinear_nv12":
                              launches["resize_bilinear_nv12"]},
           "vae": {**GEN_VAE, "adam_lr": GEN_VAE_LR},
           "dit": {**GEN_DIT, "adam_lr": GEN_DIT_LR,
                   "tokens_a_frame": lat_shape[2] * lat_shape[3],
                   "num_classes": GEN_CLASSES,
                   "label_dropout": GEN_LABEL_DROPOUT},
           "compute": "bf16", "cudnn_deterministic": True,
           "runs": rows, "decoded": decoded, "failures": failures}
    emit(out)
    if failures:
        raise AssertionError(f"generation phase failed: {failures}")
    return out


def dropped_share(model, clips):
    """Each MoE layer's share of routed tokens dropped at capacity, from
    one forward of `model` on `clips` (its own routing, recomputed in a
    pre-hook)."""
    shares = []

    def hook(mod, inputs):
        _, _, mask, keep, _ = mod.route(inputs[0])
        shares.append(1.0 - float(keep.sum() / mask.sum()))
    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, MoEMLP)]
    try:
        with torch.no_grad():
            model(clips)
    finally:
        for h in hooks:
            h.remove()
    return shares


def phase_moe_training(device, smi):
    """VideoMoE at its defaults, bf16, through make_moe_train_step with
    Adam on the ramp batch: 2 + 8 graphed steps against an eager twin (bit
    for bit); step ms, tokens/s, the aux loss, the dropped share."""
    clips, mask = ramp_clips(MOE_BATCH, SIDE, device)

    def model():
        return VideoMoE(2, frames=TRAIN_VIT["frames"], size=SIDE,
                        device=device,
                        generator=torch.Generator().manual_seed(0))
    row, moe, step = train_twins(
        "moe_training", adam_build(model, MOE_LR),
        lambda m, o, g: make_moe_train_step(m, o), (clips, mask), device)
    del step
    layer = moe.blocks[0].moe
    tokens = (TRAIN_VIT["frames"] // moe.tubelet_t) * (SIDE // moe.patch) ** 2
    with torch.no_grad():
        aux = float(moe_loss(moe, clips, mask)[2])
    row.update(tokens_a_group=tokens, capacity=layer.capacity(tokens),
               tokens_per_s=MOE_BATCH * tokens / (row["step_ms"] / 1e3),
               aux_after=aux, dropped_share=dropped_share(moe, clips))
    out = {"phase": "moe_training", "card": smi, "batch": MOE_BATCH,
           "experts": layer.num_experts, "adam_lr": MOE_LR,
           "compute": "bf16", **row}
    emit(out)
    return out


def style_cfg():
    return FrameParameters(pixel_format=FourCC.RGB24,
                           planes_pos=Planes.PLANAR,
                           normalization=True).to_config(STYLE_SIDE,
                                                         STYLE_SIDE)


def style_run(device, net, graphed):
    ticks = STYLE_WARMUP + STYLE_TICKS

    def stylize(batch):   # [8, 3, 256, 256] in [0, 1] -> NHWC in [0, 255]
        return net(batch.permute(0, 2, 3, 1) * 255.0)
    loader = SyntheticStreams(STREAMS, STYLE_PER_STREAM,
                              ticks * STYLE_PER_STREAM, device, style_cfg())
    graph = cuda_graph(stylize) if graphed else None
    eng = StreamInferencer(synthetic_urls(), graph or stylize,
                           per_stream=STYLE_PER_STREAM, loader=loader)
    label = f"style{' graphed' if graphed else ''}"
    try:
        with torch.no_grad():
            results, seconds, launches, _, lat = drive_engine(
                eng, STYLE_WARMUP, STYLE_TICKS)
        device_ms = (time_ms(graph.graphs[0].replay, device, iters=10,
                             warmup=2)[0] if graph is not None else None)
    finally:
        eng.close()
        loader.close()
    check_replays(graph, ticks, label)
    expect_launches(label, launches, {"nv12_rgb": ticks * STREAMS,
                                      "flash_fwd": 0})
    check_clocks(results, ticks, STYLE_PER_STREAM, label)
    outs = by_tick(results, STREAMS)
    if (outs.shape[2:] != (STYLE_PER_STREAM, STYLE_SIDE, STYLE_SIDE, 3)
            or not bool(torch.isfinite(outs).all())):
        raise AssertionError(f"{label}: outputs {tuple(outs.shape)}")
    frames = STYLE_TICKS * STREAMS * STYLE_PER_STREAM
    return outs, {"graphed": graphed, "launches": launches,
                  "frames_per_s": frames / seconds,
                  **pace(seconds, STYLE_TICKS, lat, device_ms, graph)}


def phase_style(device, smi):
    """multi_stream_inference.py: two seeded NV12 streams through
    MultiStreamLoader, 4 frames of 256² a stream a tick, into
    TransformerNet, eagerly and through cuda_graph, bit-equal at every
    tick; frames/s and ms a tick."""
    net = TransformerNet(device=device,
                         generator=torch.Generator().manual_seed(0)).eval()
    # The model is f32, as the reference's: its convolutions run without
    # TF32 (as after phase training, whatever ran before).
    with cudnn_flags(deterministic=True, allow_tf32=False):
        eager, eager_row = style_run(device, net, False)
        graphed, graphed_row = style_run(device, net, True)
    same = bit_equal_ticks(graphed, eager)
    out = {"phase": "style", "card": smi, "streams": STREAMS,
           "frames_a_stream_a_tick": STYLE_PER_STREAM, "side": STYLE_SIDE,
           "compute": "f32, no TF32",
           "eager": eager_row, "graphed": graphed_row,
           "graphed_vs_eager": f"bitwise equal in {sum(same)} of "
                               f"{len(same)} ticks"}
    emit(out)
    if not all(same):
        raise AssertionError(f"style: graphed != eager at ticks "
                             f"{[k for k, s in enumerate(same) if not s]}")
    return out


def quant_run(device, infer, label):
    ticks = WARMUP_TICKS + TIMED_TICKS

    def serve(batch):
        return infer(batch.view(-1, CLIP, SIDE, SIDE, 3))
    loader = SyntheticStreams(STREAMS, CLIP, ticks * CLIP, device)
    graph = cuda_graph(serve)
    eng = StreamInferencer(synthetic_urls(), graph, per_stream=CLIP,
                           loader=loader)
    try:
        with torch.no_grad():
            results, seconds, launches, _, lat = drive_engine(
                eng, WARMUP_TICKS, TIMED_TICKS)
        device_ms = time_ms(graph.graphs[0].replay, device, iters=10,
                            warmup=2)[0]
    finally:
        eng.close()
        loader.close()
    check_replays(graph, ticks, label)
    expect_launches(label, launches, {"nv12_rgb": ticks * STREAMS,
                                      "flash_fwd": ticks * VIT["depth"]})
    check_clocks(results, ticks, CLIP, label)
    frames = TIMED_TICKS * STREAMS * CLIP
    return by_tick(results, STREAMS), {
        "launches": launches, "frames_per_s": frames / seconds,
        **pace(seconds, TIMED_TICKS, lat, device_ms, graph)}


def phase_quantized_serving(device, smi):
    """serving_inference.py's int8 path: the ViT-B joint serving model
    with quantize_weights's int8 state, dequantized inside the graphed
    forward (functional_call), served as phase serving serves it, against
    the same model with its f32 weights: the same top-1 on every row, and
    the logit rule at QUANT_REL (max abs error within 5% of the largest
    logit); the weight bytes of both forms and ms a tick."""
    model = vit(device, torch.bfloat16)
    qstate = quantize_weights(model)

    def int8(clips):
        return functional_call(model, dequantize_weights(qstate), (clips,))
    want, f32_row = quant_run(device, model, "quantized_serving f32")
    got, int8_row = quant_run(device, int8, "quantized_serving int8")
    rule = logit_rule(got, want, QUANT_REL)
    top1 = (got.reshape(-1, got.shape[-1]).argmax(-1)
            == want.reshape(-1, want.shape[-1]).argmax(-1))
    out = {"phase": "quantized_serving", "card": smi,
           "model": "ViT-B joint (phase serving's)",
           "weight_bytes": {"f32": quantized_bytes(model.state_dict()),
                            "int8": quantized_bytes(qstate)},
           "quantization_error": quantization_error(model.state_dict(),
                                                    qstate),
           "f32_weights": f32_row, "int8_weights": int8_row,
           "top1_agreement": float(top1.float().mean()),
           "logit_rule": rule}
    emit(out)
    if not rule["ok"] or not bool(top1.all()):
        raise AssertionError(f"quantized_serving: int8 logits against the "
                             f"f32 weights': {rule}, top-1 {top1.tolist()}")
    return out


def run(device):
    smi = phase_env()
    worst = phase_kernel_vs_plain(device)
    try:
        _native.load()
        why = None
    except _native.NativeBuildError as e:  # the machine cannot build it
        why = str(e)
    if why is None:
        main = phase_main_path_decoded(device)
    else:
        main = phase_main_path_synthetic(device, why)
    rows = phase_times(device, smi, main)
    resize_worst = phase_resize_vs_plain(device)
    resized = phase_resized_main_path(device, smi, main)
    clip_aug = phase_clip_augment(device, smi)
    resize_rows = phase_resize_times(device, smi)
    phase_area_variants(device, smi)
    flash_worst = phase_flash_vs_plain()
    serving = phase_serving(device)
    pooled = phase_pooled(device, smi)
    streaming = phase_streaming(device, smi)
    flash = phase_flash_times(device, smi, serving)
    bwd_worst = phase_flash_bwd_vs_plain()
    training = phase_training(device, smi)
    phase_train_profile(device, training)
    bwd = phase_flash_bwd_times(device, smi)
    generation = phase_generation(device, smi)
    phase_moe_training(device, smi)
    style = phase_style(device, smi)
    quant = phase_quantized_serving(device, smi)
    head = rows[0]
    band = next(r for r in flash["cases"] if r["case"] == "twin_temporal")
    twin = streaming["flash_launches"]
    train = {f"train_{r['config']}"
             f"{'' if r['graphed'] else '_eager'}": r["launches"]
             for r in training["runs"]
             if r["use_flash"] and r["outcome"] == "ran"}
    source = "tensor_stream_torch/csrc/flash_fwd.cu"
    serve_runs = {"serving": serving, "serving_graphed":
                  serving["graphed_run"], "serving_fused":
                  serving["fused_run"]}
    pool_runs = {f"pooled_{kind}_{p}": r["launches"]["nv12_rgb"]
                 for kind in ("frames", "mean_model")
                 for p, r in pooled[kind].items()}
    stream_runs = {f"streaming{'_graphed' if g else ''}": sum(
        r["launches"]["nv12_rgb"] for name in STREAM_KV
        for r in (streaming[name]["graphed"] if g else
                  streaming[name])["runs"]) for g in (False, True)}
    # "launches" is each kernel's count summed over the main paths that
    # run it (the headline loader; serving eager, graphed and fused; the
    # pooled phase; streaming eager and graphed; the training runs), each
    # path's count taken from 0 just before it and read just after, a
    # graph replay counting what its capture recorded; every path's count
    # is beside it, the streaming twin's check among them.
    resized_runs = {f"resized_main_path_{a.lower()}": r["launches"]
                    for a, r in resized.items()}
    aug_runs = {f"clip_augment_{src}{'' if g == 'graphed' else '_eager'}":
                r[f"{g}_launches"] for src, r in clip_aug.items()
                for g in ("graphed", "eager")}
    model_runs = {"generation": generation["input_launches"],
                  "style": style["eager"]["launches"],
                  "style_graphed": style["graphed"]["launches"],
                  "quantized_serving_f32": quant["f32_weights"]["launches"],
                  "quantized_serving_int8":
                  quant["int8_weights"]["launches"]}
    nv12_paths = {"main_path": main[3]["total"],
                  **{k: v["nv12_rgb"] for k, v in resized_runs.items()},
                  **{k: v["nv12_rgb"] for k, v in aug_runs.items()},
                  **{k: r["launches"]["nv12_rgb"]
                     for k, r in serve_runs.items()},
                  **pool_runs, **stream_runs,
                  **{k: v["nv12_rgb"] for k, v in model_runs.items()}}

    def resize_entry(kernel, replaces, note):
        paths = {k: v.get(kernel, 0) for k, v in {
            **resized_runs, **aug_runs, **model_runs}.items()
            if v.get(kernel, 0)}
        head = next(r for r in resize_rows if r["kernel"] == kernel
                    and r["shape"][0] == BATCH)
        entry = {"name": kernel, "route": "cuda",
                 "source": "tensor_stream_torch/csrc/resize_nv12.cu",
                 "replaces": replaces, "replaces_note": note,
                 "launches": sum(paths.values()), "launches_by_path": paths,
                 "max_abs_err": resize_worst[kernel],
                 "max_differing_bytes": 0, "shape": head["shape"],
                 "ms": head["ms"], "plain_ms": head["plain_ms"],
                 "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                 "library_ms": None}
        if kernel == "resize_area_down_nv12":
            entry["variant"] = head["variant"]  # at the headline batch
            entry["launches_by_variant"] = {
                v: sum(r["area_launches_by_variant"][v]
                       for r in resized.values())
                for v in resize_ops.AREA_VARIANTS}
        return entry
    fwd_paths = {**{k: r["launches"]["flash_fwd"]
                    for k, r in serve_runs.items()},
                 **{k: v["flash_fwd"] for k, v in train.items()},
                 **{k: v["flash_fwd"] for k, v in model_runs.items()
                    if k.startswith("quantized")}}
    emit({"kernels": [{
        "name": "nv12_rgb", "route": "cuda",
        "source": "tensor_stream_torch/csrc/nv12_rgb.cu",
        "replaces": "tensor_stream_tpu/ops/pallas_color.py:68",
        "launches": sum(nv12_paths.values()),
        "launches_by_path": nv12_paths,
        "launches_by_variant": {v: main[3][v] for v in nv12_rgb.VARIANTS},
        "max_abs_err": worst, "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes", "library_ms": None}, {
        "name": "flash_fwd", "route": "cuda", "source": source,
        "replaces": "tensor_stream_tpu/ops/flash_attention.py:83",
        "launches": sum(fwd_paths.values()),
        "launches_by_path": {**fwd_paths, "streaming_twin": twin["full"]},
        "recompute_launches": {k: v["flash_fwd_recompute"]
                               for k, v in train.items()},
        "max_abs_err": flash_worst["no_window"], "ms": flash["ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"]}, {
        "name": "flash_fwd_band", "route": "cuda", "source": source,
        "replaces": "tensor_stream_tpu/ops/flash_attention.py:230",
        "launches": twin["band"],
        "launches_by_path": {"serving": 0, "streaming_twin": twin["band"]},
        "shape": band["shape"], "window": band["window"],
        "max_abs_err": flash_worst["window"], "ms": band["ms"],
        "plain_ms": band["plain_ms"], "bound_ms": band["bound_ms"],
        "bound_by": band["bound_by"], "library_ms": band["library_ms"]}, {
        "name": "flash_bwd", "route": "cuda",
        "source": "tensor_stream_torch/csrc/flash_bwd.cu",
        "replaces": "tensor_stream_tpu/ops/flash_attention.py:532",
        "replaces_note": "_flash_bwd, the lax.scan VJP of _flash (not a "
                         "Pallas kernel)",
        "design": "wgmma",
        "designs": BWD_DESIGN_NOTES,
        "launches": sum(v["flash_bwd"] for v in train.values()),
        "launches_by_path": {k: v["flash_bwd"] for k, v in train.items()},
        "launches_by_design": {k: v["flash_bwd_by_design"]
                               for k, v in train.items()},
        "shape": bwd["shape"], "max_abs_err": bwd_worst["wgmma"],
        "max_abs_err_by_design": bwd_worst, "ms": bwd["ms"],
        "split_ms": bwd["split_ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "library_ms": bwd["library_ms"]},
        resize_entry("resize_bilinear_nv12",
                     "tensor_stream_tpu/ops/resize.py:187",
                     "resize_bilinear, an XLA fusion (not a Pallas "
                     "kernel); also AREA's upscale branch (:419-421)"),
        resize_entry("resize_bicubic_nv12",
                     "tensor_stream_tpu/ops/resize.py:278",
                     "resize_bicubic, an XLA fusion (not a Pallas kernel)"),
        resize_entry("resize_area_down_nv12",
                     "tensor_stream_tpu/ops/resize.py:404",
                     "resize_area's downscale branch, an XLA fusion (not a "
                     "Pallas kernel)")]})
    print(smi, flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    run(torch.device("cuda", 0))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
