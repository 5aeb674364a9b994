#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA card.

    python3 chip_smoke.py

Builds every CUDA kernel of tensor_stream_torch from the sources in this
checkout, holds each against its plain torch version on the card, drives
the port's main path (the headline FrameLoader: 1080p H.264 -> native
decode -> host resize to 224x224 -> one pinned H2D copy per batch of 128
-> NV12->RGB planar f32 on the card) and times the kernels. Prints one
JSON object per phase, then the "kernels" line, then the card's name and
power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}. Any failure exits non-zero before the last
line. Needs one CUDA device; imports nothing of JAX.

Where the machine cannot build the native decoder (libtsingest.so needs
FFmpeg's development libraries), the main-path phase says so on a line
of its own and drives the same FrameLoader staging, copy, event rotation
and batched VPP from seeded NV12 frames of the same shape instead.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from tensor_stream_torch import _build, _native
from tensor_stream_torch.data import FrameLoader
from tensor_stream_torch.enums import FourCC, FrameRate, Planes
from tensor_stream_torch.ops import nv12_rgb
from tensor_stream_torch.ops.vpp import build_vpp, build_vpp_batched_flat
from tensor_stream_torch.tensor_stream import (FrameParameters,
                                               TensorStreamConverter)

HERE = os.path.dirname(os.path.abspath(__file__))
HEADLINE = os.path.join(HERE, "tests", "fixtures",
                        "bench_1920x1080_gop25_200.h264")
HEADLINE_FRAMES = 200
READ_FIXTURE = os.path.join(HERE, "tests", "fixtures",
                            "bbb_720x480_RGB24_250.h264")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BATCH = 128
SIDE = 224
# Kernel-vs-plain shapes: the headline batch, one 1080p frame, and a
# ragged size whose width is not a multiple of 4.
CHECK_SHAPES = ((BATCH, SIDE, SIDE), (1, 1080, 1920), (4, 240, 322))
STEADY_BATCHES = 40


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
            ptxas += [ln.strip() for ln in f if "registers" in ln]
    emit({"phase": "env", "nvidia_smi": smi, "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_s": round(build_s, 3), "built": sorted(built),
          "ptxas": ptxas})
    return smi


def phase_kernel_vs_plain(device):
    """Every {RGB24, BGR24} x {planar, merged} x {u8, f32} x standard, at
    each check shape: the kernel must equal the plain version bit for bit
    on the same CUDA tensors."""
    worst = 0.0
    cases = 0
    for shape_i, (n, h, w) in enumerate(CHECK_SHAPES):
        flat = torch.from_numpy(seeded_nv12(n, h, w, 100 + shape_i)).to(device)
        y, uv = split(flat, n, h, w)
        for swap_rb in (False, True):
            for planar in (True, False):
                for norm in (False, True):
                    for standard in range(4):
                        before = nv12_rgb.launches
                        got = nv12_rgb.nv12_to_rgb(y, uv, swap_rb, planar,
                                                   norm, standard)
                        if nv12_rgb.launches != before + 1:
                            raise AssertionError("kernel did not launch")
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
    emit({"phase": "kernel_vs_plain", "kernel": "nv12_rgb", "cases": cases,
          "shapes": [list(s) for s in CHECK_SHAPES], "tolerance": "bitwise",
          "max_abs_err": worst})
    return worst


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
        self.stream_url = f"synthetic:{seed}"
        self.reader = None
        self._segmented = None
        self._next_index = 1
        self._cfg = cfg
        self._w, self._h = cfg.src_width, cfg.src_height
        rng = np.random.default_rng(seed)
        self._ys = rng.integers(0, 256, (self.POOL, self._h, self._w), np.uint8)
        self._uvs = rng.integers(0, 256, (self.POOL, self._h // 2, self._w),
                                 np.uint8)
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
    """Iterates `loader` to its end with the kernel's count at 0; returns
    (first batch on the host, batches, frames, seconds, launches)."""
    nv12_rgb.launches = 0
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
    launches = nv12_rgb.launches
    loader.close()
    if launches != batches:
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


def time_ms(fn, device, iters=100, warmup=20):
    """Per-call ms over `iters` calls after `warmup`: (median, p10, p90).
    CUDA events around each call, with L2 (50 MB) flushed before each so
    the inputs come from HBM as they do after the H2D copy of a batch."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
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
    rows = []
    for (n, h, w, planar, norm) in ((BATCH, SIDE, SIDE, True, True),
                                    (1, 1080, 1920, False, False)):
        flat = torch.from_numpy(seeded_nv12(n, h, w, 5)).to(device)
        y, uv = split(flat, n, h, w)
        ms, p10, p90 = time_ms(lambda: nv12_rgb.nv12_to_rgb(
            y, uv, False, planar, norm, 0), device)
        plain_ms = time_ms(lambda: nv12_rgb.nv12_to_rgb_plain(
            y, uv, False, planar, norm, 0), device, iters=30, warmup=5)[0]
        nbytes = kernel_bytes(n, h, w, norm)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({"shape": [n, h, w], "layout": "planar" if planar
                     else "merged", "dtype": "f32" if norm else "u8",
                     "ms": ms, "p10_ms": p10, "p90_ms": p90,
                     "plain_ms": plain_ms,
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
    head = rows[0]
    emit({"kernels": [{
        "name": "nv12_rgb", "route": "cuda",
        "source": "tensor_stream_torch/csrc/nv12_rgb.cu",
        "replaces": "tensor_stream_tpu/ops/pallas_color.py:68",
        "launches": main[3], "max_abs_err": worst, "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": "bytes", "library_ms": None}]})
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
