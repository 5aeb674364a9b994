"""The port's VideoWriter (tensor_stream_torch/video_writer.py) on the CPU,
with the port's own FrameLoader as the decoder: an RGB mp4 round trip
(numpy and torch frames), NV12 pass-through of a decoded fixture, the
port's and the JAX package's writers handing the native encoder the same
bytes for the same frames, and the errors of bad parameters."""
import ctypes
import os

import numpy as np
import pytest
import torch

from tensor_stream_tpu import VideoWriter as JaxVideoWriter
from tensor_stream_tpu import _native as jax_native
from tensor_stream_torch import FourCC, FrameLoader, Planes, VideoWriter
from tensor_stream_torch import _native as torch_native

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "bbb_720x480_RGB24_250.h264")


def decode(path, fourcc=FourCC.RGB24, limit=None):
    """Every frame of `path` through the port's FrameLoader, as numpy:
    RGB24 merged H x W x 3, or NV12 as the contract's [1, H*3/2, W]."""
    frames = []
    with FrameLoader(path, batch=1, pixel_format=fourcc,
                     planes_pos=Planes.MERGED, device="cpu") as loader:
        for t, _ in loader:
            frames.append(t[0].numpy().copy())
            if limit is not None and len(frames) == limit:
                break
    return frames


def gradient_frames(n, w=320, h=240):
    frames = []
    for k in range(n):
        frame = np.zeros((h, w, 3), np.uint8)
        frame[..., 0] = np.linspace(0, 255, w, dtype=np.uint8)[None, :]
        frame[..., 1] = np.linspace(0, 255, h, dtype=np.uint8)[:, None]
        frame[..., 2] = (k * 12) % 256
        frames.append(frame)
    return frames


def test_rgb_roundtrip_mp4(tmp_path):
    """Synthetic RGB frames, half as numpy and half as torch tensors ->
    mp4 -> decode: count, geometry, and content within the lossy
    encode's loose tolerance (the JAX test's bound)."""
    path = str(tmp_path / "out.mp4")
    frames = gradient_frames(20)
    with VideoWriter(path, (320, 240), fps=25) as wr:
        for k, f in enumerate(frames):
            wr.write(torch.from_numpy(f) if k % 2 else f)
        assert wr.frames_written == 20
    decoded = decode(path)
    assert len(decoded) == 20
    assert decoded[0].shape == (240, 320, 3)
    for k in (0, 10, 19):
        err = np.abs(decoded[k].astype(int) - frames[k].astype(int)).mean()
        assert err < 12, f"frame {k}: mean abs err {err}"


def test_nv12_passthrough_roundtrip(tmp_path):
    """A fixture's first 10 NV12 frames re-encoded as they are (torch
    planes, no RGB round trip) and decoded again: count, geometry and a
    near-identical Y plane."""
    originals = decode(FIXTURE, FourCC.NV12, limit=10)
    h = originals[0].shape[1] * 2 // 3
    w = originals[0].shape[2]
    path = str(tmp_path / "re.mkv")
    with VideoWriter(path, (w, h), fps=30) as wr:
        for f in originals:
            plane = torch.from_numpy(f[0])
            wr.write_nv12(plane[:h], plane[h:])
    redecoded = decode(path, FourCC.NV12)
    assert len(redecoded) == 10
    assert redecoded[0].shape == originals[0].shape
    y0 = originals[0][0, :h].astype(int)
    y1 = redecoded[0][0, :h].astype(int)
    assert np.abs(y0 - y1).mean() < 4


class _Recorder:
    """A native library that records what a writer hands the encoder (the
    create arguments and each RGB frame's bytes) and passes every call
    on."""

    def __init__(self, lib):
        self._lib = lib
        self.calls = []

    def ts_writer_create(self, *args):
        self.calls.append(("create",) + args[1:])  # all but the path
        self._size = args[1] * args[2] * 3
        return self._lib.ts_writer_create(*args)

    def ts_writer_write_rgb(self, handle, ptr):
        self.calls.append(("rgb", ctypes.string_at(ptr, self._size)))
        return self._lib.ts_writer_write_rgb(handle, ptr)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def test_port_and_jax_writers_feed_the_encoder_the_same_bytes(
        tmp_path, monkeypatch):
    """The same frames through both packages' writers, which share the
    native encoder: each hands the encoder the same arguments and the
    same bytes for every frame, and each file decodes to 12 frames of the
    source within the lossy encode's bound. The encoded bytes themselves
    are the encoder's: on a loaded machine libx264 gives one of several
    byte streams from run to run for the same input, in either package
    (and more so with frame threads, three at 160 x 96), so the test
    compares what the port controls, the encoder's input."""
    frames = gradient_frames(12, 64, 48)
    recorders = {}
    for name, module in (("torch", torch_native), ("jax", jax_native)):
        real = module.load()
        recorders[name] = _Recorder(real)
        monkeypatch.setattr(module, "load",
                            lambda rec=recorders[name]: rec)
    for name, writer in (("torch", VideoWriter), ("jax", JaxVideoWriter)):
        path = str(tmp_path / f"{name}.mp4")
        with writer(path, (64, 48), fps=24) as wr:
            for k, f in enumerate(frames):
                wr.write(torch.from_numpy(f) if name == "torch" and k % 2
                         else f)
            assert wr.frames_written == 12
        decoded = decode(path)
        assert len(decoded) == 12
        for got, want in zip(decoded, frames):
            assert np.abs(got.astype(int) - want.astype(int)).mean() < 12
    ours, theirs = recorders["torch"].calls, recorders["jax"].calls
    assert len(ours) == len(theirs) == 13
    assert ours[0] == theirs[0] == ("create", 64, 48, 24, 1, b"libx264",
                                    2_000_000)
    assert ours[1:] == theirs[1:]
    assert ours[1][1] == frames[0].tobytes()


def test_writer_rejects_bad_params(tmp_path):
    with pytest.raises(RuntimeError):
        VideoWriter(str(tmp_path / "x.mp4"), (321, 240))  # odd width
    with pytest.raises(RuntimeError):
        VideoWriter(str(tmp_path / "x.mp4"), (320, 240), codec="nope")
    with VideoWriter(str(tmp_path / "ok.mp4"), (320, 240)) as wr:
        with pytest.raises(ValueError):
            wr.write(np.zeros((240, 100, 3), np.uint8))
        with pytest.raises(ValueError):
            wr.write(torch.zeros((240, 320, 4), dtype=torch.uint8))
        with pytest.raises(TypeError):
            wr.write(torch.zeros((240, 320, 3)))
        with pytest.raises(ValueError):
            wr.write_nv12(np.zeros((240, 320), np.uint8),
                          np.zeros((100, 320), np.uint8))
        assert wr.frames_written == 0
