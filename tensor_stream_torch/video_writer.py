"""In-process encoded video writer (the write side of the pipeline).

The port of the JAX package's ``video_writer.py``: frames are encoded in
this process through libavcodec (``csrc/video_writer.cpp`` in
libtsingest.so, over the port's own ctypes bindings), with no
subprocess and no GPU encoder:

    with VideoWriter("out.mp4", (640, 360), fps=30) as wr:
        for frames, _ in loader:
            wr.write(styled(frames)[0])   # HxWx3 uint8 RGB

The container follows the path's extension (mp4, mkv, flv, ...); the
codec defaults to libx264. A frame on the card costs one copy to the
host, into a pinned buffer the writer keeps.
"""
from fractions import Fraction

import numpy as np
import torch

from . import _native


def _host_u8(frame, staging, key):
    """`frame` (numpy, or a torch tensor on the CPU or on CUDA) as a
    C-contiguous uint8 numpy array; a CUDA frame is copied into the pinned
    tensor ``staging[key]``, made on first use."""
    if isinstance(frame, torch.Tensor):
        if frame.dtype != torch.uint8:
            raise TypeError(f"frames must be uint8, got {frame.dtype}")
        if frame.device.type == "cuda":
            host = staging.get(key)
            if host is None or host.shape != frame.shape:
                host = staging[key] = torch.empty(
                    frame.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(frame)
            return host.numpy()
        return np.ascontiguousarray(frame.numpy())
    return np.ascontiguousarray(np.asarray(frame), dtype=np.uint8)


class VideoWriter:
    def __init__(self, path, size, fps=30, codec="libx264",
                 bitrate=2_000_000):
        self._handle = None
        self._lib = _native.load()
        self._staging = {}  # pinned host copies of CUDA frames
        w, h = int(size[0]), int(size[1])
        self.size = (w, h)
        fr = Fraction(fps).limit_denominator(100000)
        handle = self._lib.ts_writer_create(
            str(path).encode(), w, h, fr.numerator, fr.denominator,
            codec.encode(), int(bitrate))
        if not handle:
            raise RuntimeError(
                f"cannot open video writer for {path} ({w}x{h}, {codec}); "
                "dimensions must be even and the container/codec supported")
        self._handle = handle

    def write(self, frame):
        """Encodes one RGB24 frame: H x W x 3 uint8, numpy or a torch
        tensor on the CPU or on CUDA."""
        arr = _host_u8(frame, self._staging, "rgb")
        want = (self.size[1], self.size[0], 3)
        if arr.shape != want:
            raise ValueError(f"frame shape {arr.shape} != {want}")
        rc = self._lib.ts_writer_write_rgb(self._handle, arr.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"encode failed: {rc}")

    def write_nv12(self, y, uv):
        """Encodes one tightly packed NV12 frame (no RGB round trip): the
        Y and UV planes as numpy or torch tensors."""
        w, h = self.size
        ya = _host_u8(y, self._staging, "y")
        uva = _host_u8(uv, self._staging, "uv")
        if ya.size != w * h or uva.size != w * h // 2:
            raise ValueError(
                f"NV12 planes for {w}x{h} need {w*h}/{w*h//2} bytes, got "
                f"{ya.size}/{uva.size}")
        rc = self._lib.ts_writer_write_nv12(self._handle, ya.ctypes.data,
                                            uva.ctypes.data)
        if rc != 0:
            raise RuntimeError(f"encode failed: {rc}")

    @property
    def frames_written(self):
        return int(self._lib.ts_writer_frames(self._handle))

    def close(self):
        if self._handle is not None:
            self._lib.ts_writer_close(self._handle)
            self._lib.ts_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        self.close()
