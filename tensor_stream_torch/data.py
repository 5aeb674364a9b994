"""FrameLoader: a prefetching iterator from a video stream to device batches;
MultiStreamLoader: several FrameLoaders stacked into one batch a tick;
PooledStreamLoader: many streams on one native worker pool, one flat
staging buffer and one VPP dispatch a tick.

Port of the JAX package's ``data.py:53-420`` and ``:1399-1679``. Decode
runs in native producer threads, the drain (plus the optional native host
resize) in a loader thread, both outside the GIL; the caller's thread
only ships each filled pinned staging buffer to the device in one
``non_blocking`` copy and queues the batched VPP. Host decode, the copy and device compute
overlap.

    loader = FrameLoader("video.mp4", batch=16, width=224, height=224,
                         pixel_format=FourCC.RGB24,
                         planes_pos=Planes.PLANAR, normalization=True,
                         host_resize=True)
    for tensors, indices in loader:        # [16, 3, 224, 224] f32 on cuda:0
        train_step(tensors)

Each yielded batch is a tensor of its own, safe to hold across
iterations: staging buffers rotate on the host, each behind the CUDA
event recorded after the VPP that read it.
"""
import collections
import ctypes
import queue
import threading
import time

import torch

from . import _native
from ._device import (record_event, resolve_device, ship, staging_buffer,
                      wait_event)
from .enums import ColorStandard, FrameRate
from .ops.vpp import build_vpp_batched_flat
from .tensor_stream import (FrameParameters, TensorStreamConverter,
                            host_resize_algo)

# Queue sentinel: the drain hit a mid-stream resolution switch on the
# fixed-geometry (full-frame) path.
_RENEGOTIATED = object()


def _wait_detected_standard(lib, handle, index_baseline, deadline):
    """Waits (until `deadline`, monotonic) for the frame counter to move
    past `index_baseline`, then returns the stream's detected
    ColorStandard value, or None if no frame decoded in time."""
    while time.monotonic() < deadline:
        if lib.ts_pipeline_frame_index(handle) > index_baseline:
            return lib.ts_pipeline_detected_standard(handle)
        time.sleep(0.02)
    return None


class FrameLoader:
    """Iterates device-resident batches over a stream.

    `device=None` means ``cuda:<device_index>`` and raises when no CUDA
    device is present; ``device="cpu"`` runs the plain CPU path."""

    def __init__(self,
                 stream_url,
                 batch=16,
                 prefetch=2,
                 host_resize=False,
                 loop=False,
                 buffer_size=None,
                 decode_threads=0,
                 device_index=0,
                 drop_partial=False,
                 start_frame=1,
                 fast_decode=False,
                 segment_parallel=0,
                 augment=None,
                 aug_seed=None,
                 device=None,
                 **frame_kwargs):
        if augment is not None:
            raise NotImplementedError(
                "augment= is not ported yet (ROADMAP.md queue 1, clip and "
                "augment path)")
        self.device = resolve_device(device, device_index)
        self.device_index = self.device.index or 0
        self.batch = int(batch)
        self.prefetch = max(1, int(prefetch))
        self.host_resize = bool(host_resize)
        self.drop_partial = bool(drop_partial)
        self.stream_url = stream_url
        self.params = FrameParameters(**frame_kwargs)
        if self.host_resize:
            self._algo = host_resize_algo(self.params)
        self.reader = None
        self._segmented = None
        if int(segment_parallel) > 0:
            # GOP/segment-parallel decode (csrc/segment_reader.h): N
            # decoders over keyframe-split chunks of a seekable file,
            # stitched bit-exactly into serial frame order.
            self._init_segmented(int(segment_parallel), buffer_size, loop,
                                 decode_threads, fast_decode, start_frame)
            self._start_common()
            return
        self.reader = TensorStreamConverter(
            stream_url, framerate_mode=FrameRate.FAST,
            buffer_size=buffer_size or 4 * self.batch,
            decode_threads=decode_threads, loop=loop,
            fast_decode=fast_decode, device=self.device)
        self.reader.initialize(repeat_number=3)
        # Checkpoint/resume: iteration starts at `start_frame` (1-based).
        if int(start_frame) > 1:
            self.reader.seek_frame(int(start_frame) - 1)
        self._next_index = int(start_frame)
        # Register the cursor BEFORE the producer starts so the no-drop
        # window opens at the first frame.
        self.reader._lib.ts_pipeline_register_cursor(self.reader._handle,
                                                     b"loader")
        # seek_frame pre-sets the absolute frame counter, so "a frame has
        # decoded" means the counter moved past this value.
        index_baseline = self.reader._lib.ts_pipeline_frame_index(
            self.reader._handle)
        self.reader.start()
        if self.params.color_standard is ColorStandard.AUTO:
            # Colorimetry comes from decoded frames; wait (bounded) for the
            # first one before the VPP is built.
            detected = _wait_detected_standard(
                self.reader._lib, self.reader._handle, index_baseline,
                time.monotonic() + 10.0)
            if detected is None:
                self.close()
                raise RuntimeError(
                    "color_standard=AUTO: no frame decoded within 10s to "
                    "detect colorimetry from; pass an explicit standard")
            self.params.color_standard = ColorStandard(detected)
        w, h = self.reader.frame_size
        if self.host_resize:
            self._w, self._h = self.params.width, self.params.height
        else:
            self._w, self._h = w, h
        self._cfg = self._device_params().to_config(self._w, self._h)
        self._start_common()

    def _device_params(self):
        """Frame parameters of the device VPP: after a host resize the
        frames arrive at target size, with no resize stage left."""
        if not self.host_resize:
            return self.params
        return FrameParameters(pixel_format=self.params.pixel_format,
                               planes_pos=self.params.planes_pos,
                               normalization=self.params.normalization,
                               color_standard=self.params.color_standard,
                               dtype=self.params.dtype)

    def _start_common(self):
        self._vpp = build_vpp_batched_flat(self._cfg, self.batch, self.device)
        # Rotating staging pool: one buffer per in-flight batch plus one
        # being filled, so the drain never writes a buffer still in use.
        n_bufs = self.prefetch + 2
        size = self.batch * self._w * self._h * 3 // 2
        self._pool = queue.Queue()
        for _ in range(n_bufs):
            self._pool.put(staging_buffer(size, self.device))
        self._filled = queue.Queue(maxsize=self.prefetch)
        self._pending = collections.deque()  # (buf, event) awaiting compute
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _init_segmented(self, workers, buffer_size, loop, decode_threads,
                        fast_decode, start_frame):
        if self.params.color_standard is ColorStandard.AUTO:
            raise ValueError(
                "segment_parallel does not support color_standard=AUTO "
                "(workers decode chunks out of order; pass the stream's "
                "standard explicitly)")
        lib = _native.load()
        dst_w = self.params.width if self.host_resize else 0
        dst_h = self.params.height if self.host_resize else 0
        algo = self._algo if self.host_resize else 0
        handle = lib.ts_segmented_create(
            str(self.stream_url).encode(), workers,
            buffer_size or 4 * self.batch, int(bool(loop)), dst_w, dst_h,
            algo, decode_threads or 1, int(bool(fast_decode)), 0)
        if not handle:
            raise RuntimeError(
                f"segment_parallel: cannot keyframe-split {self.stream_url} "
                "(not a seekable file, or no decodable frames); use the "
                "serial loader for live sources")
        self._segmented = handle
        self._seg_lib = lib
        if int(start_frame) > 1:
            lib.ts_segmented_seek_frame(handle, int(start_frame))
        self._next_index = int(start_frame)
        self._w = lib.ts_segmented_out_width(handle)
        self._h = lib.ts_segmented_out_height(handle)
        self._cfg = self._device_params().to_config(self._w, self._h)
        if lib.ts_segmented_start(handle) != 0:
            raise RuntimeError("segment_parallel: start failed")

    # ------------------------------------------------------------- internal

    def _fill_batch(self, buf):
        """Drains up to `batch` frames into `buf` (all Y planes, then all
        UV planes); returns (frames got or a TS_* status, first index)."""
        y_ptr = buf.data_ptr()
        uv_ptr = y_ptr + self.batch * self._w * self._h
        first = ctypes.c_int(0)
        if self._segmented is not None:
            got = self._seg_lib.ts_segmented_get_batch(
                self._segmented, self.batch, y_ptr, uv_ptr,
                ctypes.byref(first))
        elif self.host_resize:
            got = self.reader._lib.ts_pipeline_get_batch_resized(
                self.reader._handle, b"loader", self.batch, self._w,
                self._h, self._algo, y_ptr, uv_ptr, ctypes.byref(first))
        else:
            got = self.reader._lib.ts_pipeline_get_batch(
                self.reader._handle, b"loader", self.batch, y_ptr, uv_ptr,
                ctypes.byref(first))
        return got, first.value

    def _drain(self):
        while not self._stop.is_set():
            buf = self._pool.get()
            if buf is None or self._stop.is_set():
                break
            got, first = self._fill_batch(buf)
            if got == _native.TS_RENEGOTIATE:
                # Mid-stream resolution switch: the full-frame staging and
                # VPP are sized for the init geometry (host_resize=True
                # rides through switches); surface a clear error.
                self._filled.put(_RENEGOTIATED)
                break
            if got <= 0:
                self._filled.put(None)  # end-of-stream sentinel
                break
            self._filled.put((buf, got, first))

    # ------------------------------------------------------------ iteration

    def __iter__(self):
        return self

    def _next_async(self):
        """Ships and converts the next batch without waiting on the device.
        Returns (tensors, indices, buf, event); the buffer goes back to the
        pool through _recycle once its event has completed."""
        while True:
            item = self._filled.get()
            if item is None:
                # Latch: re-put the sentinel so a repeated next() raises
                # StopIteration again instead of blocking.
                self._filled.put(item)
                raise StopIteration
            if item is _RENEGOTIATED:
                self._filled.put(item)
                raise RuntimeError(
                    "stream resolution changed mid-stream; use "
                    "FrameLoader(host_resize=True, width=..., height=...) "
                    "to ride through switches, or restart the loader for "
                    "the new geometry")
            buf, got, first = item
            if got < self.batch and self.drop_partial:
                self._pool.put(buf)
                continue
            tensors = self._vpp(ship(buf, self.device))
            event = record_event(self.device)
            if got < self.batch:
                tensors = tensors[:got]
            return tensors, list(range(first, first + got)), buf, event

    def _recycle(self, buf, event):
        wait_event(event)
        self._pool.put(buf)

    def checkpoint(self):
        """Resumable position: pass ``start_frame=ckpt["next_index"]`` to
        a new FrameLoader over the same stream to continue exactly where
        this one stopped. The same dict as the JAX package's loader, so a
        checkpoint moves between the two."""
        return {"stream_url": self.stream_url,
                "next_index": self._next_index}

    def __next__(self):
        tensors, indices, buf, event = self._next_async()
        self._next_index = indices[-1] + 1
        # Back-pressure after `prefetch` batches: a buffer is recycled once
        # an OLDER batch's event has completed.
        self._pending.append((buf, event))
        if len(self._pending) > self.prefetch:
            self._recycle(*self._pending.popleft())
        return tensors, indices

    def close(self):
        if self.reader is None and self._segmented is None:
            return  # already closed (both paths)
        self._stop.set()
        while self._pending:
            buf, event = self._pending.popleft()
            self._recycle(buf, event)
        try:
            self._pool.put_nowait(None)  # unblock a drain waiting for a buffer
        except queue.Full:
            pass
        # Stop (but do not yet destroy) the native side: wakes a drain
        # parked inside the native call. Only after the drain thread is
        # joined is it safe to destroy the handle.
        if self._segmented is not None:
            self._seg_lib.ts_segmented_stop(self._segmented)
            self._drain_unblock()
            self._thread.join(timeout=10)
            self._seg_lib.ts_segmented_destroy(self._segmented)
            self._segmented = None
            return
        if self.reader._handle is not None:
            self.reader._lib.ts_pipeline_stop(self.reader._handle)
        self._drain_unblock()
        self._thread.join(timeout=10)
        self.reader.stop()
        self.reader = None

    def _drain_unblock(self):
        # The drain may be blocked on the bounded _filled queue; pop one
        # item so its put() completes and it can observe _stop.
        try:
            self._filled.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def fps(self):
        if self._segmented is not None:
            raise AttributeError("segment_parallel loaders free-run; the "
                                 "source fps is not tracked")
        return self.reader.fps

    @property
    def frame_size(self):
        if self._segmented is not None:
            return (self._seg_lib.ts_segmented_width(self._segmented),
                    self._seg_lib.ts_segmented_height(self._segmented))
        return self.reader.frame_size


class MultiStreamLoader:
    """Batches frames from several streams into one device batch.

    Port of the JAX package's ``data.py:1399-1451``. Each stream runs its
    own FrameLoader (native producer + drain); iteration yields
    ``(tensors [n_streams*per_stream, ...], indices {stream: [...]})``,
    concatenated on the device. It ends when any stream is exhausted
    (``loop=True`` never ends).

        loader = MultiStreamLoader(["cam1.mp4", "cam2.mp4"], per_stream=8,
                                   width=224, height=224, host_resize=True,
                                   pixel_format=FourCC.RGB24,
                                   planes_pos=Planes.PLANAR,
                                   normalization=True, loop=True)
        for batch, indices in loader:   # [16, 3, 224, 224] on cuda:0
            logits = model(batch)
    """

    def __init__(self, stream_urls, per_stream=8, **loader_kwargs):
        # Each stream's aug_seed is offset, as in the JAX package, so that
        # streams at the same frame index would draw independent transforms.
        base_seed = loader_kwargs.pop("aug_seed", None) or 0
        self.loaders = [FrameLoader(url, batch=per_stream,
                                    aug_seed=base_seed + k, **loader_kwargs)
                        for k, url in enumerate(stream_urls)]

    def __iter__(self):
        return self

    def __next__(self):
        parts, indices = [], {}
        for k, loader in enumerate(self.loaders):
            tensors, idx = next(loader)  # StopIteration propagates
            parts.append(tensors)
            indices[k] = idx
        return torch.cat(parts, dim=0), indices

    def close(self):
        for loader in self.loaders:
            loader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class PooledStreamLoader:
    """Many streams, one shared native worker pool, one device dispatch.

    Port of the JAX package's ``data.py:1454-1679``. N streams share M
    pool workers (csrc/stream_pool.cpp): each worker round-robins decode
    iterations over the streams with ring headroom, so the thread count
    is bounded by cores, not streams. A fill thread drains every stream
    into one flat pinned staging buffer (all Y planes, then all UV
    planes); a tick is one ``non_blocking`` copy and one batched VPP over
    ``n_streams * per_stream`` frames.

        loader = PooledStreamLoader(urls, per_stream=4, workers=8,
                                    host_resize=True, width=224,
                                    height=224, pixel_format=FourCC.RGB24,
                                    planes_pos=Planes.PLANAR,
                                    normalization=True, loop=True)
        for batch, indices in loader:   # [len(urls)*4, 3, 224, 224]
            serve(batch)

    All streams must share one geometry unless host_resize unifies them.
    Iteration ends when any stream is exhausted (loop=True never ends);
    a drained stream gives StopIteration on every later next(), a
    mid-stream resolution switch without host_resize a RuntimeError.

    The native pool is set up by ``_open_pool`` and drained by
    ``_fill_tick``; a subclass that feeds frames from elsewhere overrides
    both and keeps the staging, copy and VPP.
    """

    def __init__(self, stream_urls, per_stream=8, workers=0,
                 host_resize=False, loop=False, buffer_size=None,
                 device_index=0, fast_decode=False, post_fn=None,
                 prefetch=2, device=None, **frame_kwargs):
        """`post_fn` ([global_batch, ...] in, anything out) runs in the
        same dispatch as the VPP: on CUDA the two are one CUDA graph
        (ops/vpp.py::build_vpp_batched_flat), and serving's
        pipeline="fused" rides this.

        `prefetch` bounds how many ticks the fill thread runs ahead of the
        consumer: the fill (blocking per-stream batch gets plus the native
        host resize into staging) overlaps the copy and dispatch of
        earlier ticks. The staging pool holds prefetch + 2 buffers, each
        reused only after the event recorded behind the tick that read
        it."""
        self.device = resolve_device(device, device_index)
        self.device_index = self.device.index or 0
        self.params = FrameParameters(**frame_kwargs)
        self.per_stream = int(per_stream)
        self.host_resize = bool(host_resize)
        if self.host_resize:
            self._algo = host_resize_algo(self.params)
        self.prefetch = max(1, int(prefetch))
        self._bufs = queue.Queue()
        self._filled = queue.Queue(maxsize=self.prefetch)
        self._pending = collections.deque()  # (buf, event) in flight
        self._stop = threading.Event()
        self._thread = None
        self._closed = False
        self._lib = None
        self.pool = None
        self.handles = []
        self._open_pool(stream_urls, workers, loop, buffer_size, fast_decode)
        self.n_streams = len(stream_urls)
        self.global_batch = self.n_streams * self.per_stream
        if self.host_resize:
            params = FrameParameters(
                pixel_format=self.params.pixel_format,
                planes_pos=self.params.planes_pos,
                normalization=self.params.normalization,
                color_standard=self.params.color_standard,
                dtype=self.params.dtype)
        else:
            params = self.params
        self._vpp = build_vpp_batched_flat(params.to_config(self._w, self._h),
                                           self.global_batch, self.device,
                                           post_fn=post_fn)
        size = self.global_batch * self._w * self._h * 3 // 2
        for _ in range(self.prefetch + 2):
            self._bufs.put(staging_buffer(size, self.device))
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _open_pool(self, stream_urls, workers, loop, buffer_size,
                   fast_decode):
        """Opens every stream in one native pool, starts it, sets the
        tick geometry (self._w, self._h) and resolves
        ColorStandard.AUTO, which every stream must agree on."""
        self._lib = lib = _native.load()
        self.pool = lib.ts_pool_create(int(workers))
        for url in stream_urls:
            idx = lib.ts_pool_add_stream(
                self.pool, str(url).encode(),
                int(buffer_size or 4 * self.per_stream), int(bool(loop)),
                int(bool(fast_decode)))
            if idx < 0:
                lib.ts_pool_destroy(self.pool)
                self.pool = None
                raise RuntimeError(f"cannot open stream {url}")
            handle = lib.ts_pool_stream(self.pool, idx)
            # The cursor is registered before the start, so the no-drop
            # window opens at frame 1.
            lib.ts_pipeline_register_cursor(handle, b"pool")
            self.handles.append(handle)
        dims = {(lib.ts_pipeline_width(h), lib.ts_pipeline_height(h))
                for h in self.handles}
        if self.host_resize:
            self._w, self._h = self.params.width, self.params.height
        else:
            if len(dims) != 1:
                lib.ts_pool_destroy(self.pool)
                self.pool = None
                raise ValueError(f"streams disagree on geometry {dims}; "
                                 "use host_resize to unify")
            (self._w, self._h), = dims
        if lib.ts_pool_start(self.pool) != 0:
            raise RuntimeError("StreamPool start failed")
        if self.params.color_standard is ColorStandard.AUTO:
            # Colorimetry comes from decoded frames, and the one shared VPP
            # needs every stream to agree on it. A stream that decoded no
            # frame before the deadline is a timeout, not a BT.601
            # detection.
            deadline = time.monotonic() + 10.0
            detected = set()
            for k, handle in enumerate(self.handles):
                std = _wait_detected_standard(lib, handle, 0, deadline)
                if std is None:
                    self.close()
                    raise RuntimeError(
                        f"color_standard=AUTO: stream {k} decoded no frame "
                        "in time to detect colorimetry from; pass an "
                        "explicit standard")
                detected.add(std)
            if len(detected) != 1:
                self.close()
                raise ValueError(
                    f"streams disagree on colorimetry {sorted(detected)}; "
                    "pass an explicit color_standard")
            self.params.color_standard = ColorStandard(detected.pop())

    def _fill_tick(self, buf):
        """Drains one tick into `buf`: per_stream frames a stream, stream
        k's Y planes at k * per_stream frames into the Y half and its UV
        planes likewise into the UV half. Returns {stream: indices}, None
        when a stream has drained (ticks stay rectangular) or
        _RENEGOTIATED on a mid-stream geometry switch without
        host_resize."""
        lib = self._lib
        y_frame = self._w * self._h
        y_total = self.global_batch * y_frame
        base = buf.data_ptr()
        first = ctypes.c_int(0)
        indices = {}
        for k, handle in enumerate(self.handles):
            y_ptr = base + k * self.per_stream * y_frame
            uv_ptr = base + y_total + k * self.per_stream * y_frame // 2
            if self.host_resize:
                got = lib.ts_pipeline_get_batch_resized(
                    handle, b"pool", self.per_stream, self._w, self._h,
                    self._algo, y_ptr, uv_ptr, ctypes.byref(first))
            else:
                got = lib.ts_pipeline_get_batch(
                    handle, b"pool", self.per_stream, y_ptr, uv_ptr,
                    ctypes.byref(first))
            if got == _native.TS_RENEGOTIATE:
                return _RENEGOTIATED
            if got < self.per_stream:
                return None
            indices[k] = list(range(first.value, first.value + got))
        return indices

    def _drain(self):
        """Fill thread: one tick into a staging buffer from the rotating
        pool, pushed to the bounded `_filled` queue; the ctypes calls
        release the GIL. A terminal sentinel ends it."""
        while not self._stop.is_set():
            buf = self._bufs.get()
            if buf is None or self._stop.is_set():
                break
            indices = self._fill_tick(buf)
            if indices is None or indices is _RENEGOTIATED:
                self._filled.put(indices)
                break
            self._filled.put((buf, indices))

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self._filled.get()
        if item is None:
            self._filled.put(item)  # latch: a later next() raises again
            raise StopIteration
        if item is _RENEGOTIATED:
            self._filled.put(item)  # latch
            raise RuntimeError(
                "a stream changed resolution mid-stream; use "
                "PooledStreamLoader(host_resize=True) to ride through "
                "switches, or restart the pool for the new geometry")
        buf, indices = item
        with torch.no_grad():
            tensors = self._vpp(ship(buf, self.device))
        self._pending.append((buf, record_event(self.device)))
        if len(self._pending) > self.prefetch:
            self._recycle(*self._pending.popleft())
        return tensors, indices

    def _recycle(self, buf, event):
        wait_event(event)
        self._bufs.put(buf)

    def close(self):
        """Shuts down in order: stop flag, in-flight buffers back, a
        drain waiting for a buffer woken, the native pool stopped (wakes a
        drain parked in a blocking get), a drain parked on the full queue
        woken, the thread joined, and only then the pool destroyed."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        while self._pending:
            self._recycle(*self._pending.popleft())
        try:
            self._bufs.put_nowait(None)
        except queue.Full:
            pass
        if self.pool is not None:
            self._lib.ts_pool_stop(self.pool)
        try:
            self._filled.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=10)
        if self.pool is not None:
            self._lib.ts_pool_destroy(self.pool)
            self.pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
