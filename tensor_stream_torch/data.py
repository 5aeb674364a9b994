"""FrameLoader: a prefetching iterator from a video stream to device batches;
ClipLoader and ClipDataset: shuffled fixed-length clips from one file or a
corpus, for training video models; ShardedClipLoader, ShardedClipDataset
and ShardedStreamLoader: the same over the ranks of a "dp" mesh, one
process a rank, each batch one DTensor; MultiStreamLoader: several
FrameLoaders stacked into one batch a tick; PooledStreamLoader: many
streams on one native worker pool, one flat staging buffer and one VPP
dispatch a tick.

Port of the JAX package's ``data.py``. Decode
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
import contextlib
import ctypes
import queue
import threading
import time
import warnings

import numpy as np
import torch

from . import _native
from ._device import (record_event, resolve_device, ship, staging_buffer,
                      wait_event)
from .enums import ColorStandard, FourCC, FrameRate
from .ops.vpp import build_vpp_batched_flat, build_vpp_clip_augment
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


def _check_augment(params, augment):
    """The checks of build_vpp_clip_augment, made before any native reader
    exists, so that a bad config leaks no started pipeline."""
    if augment is None:
        return
    if params.pixel_format not in (FourCC.RGB24, FourCC.BGR24):
        raise ValueError(
            "augment requires an RGB24/BGR24 pixel format (got "
            f"{params.pixel_format}) — the transforms are defined on RGB "
            "model inputs")
    if augment.mean and not (params.normalization or params.dtype):
        raise ValueError(
            "mean/std normalization needs a float tensor; pass "
            "normalization=True or dtype='bfloat16'/'float32'")


class FrameLoader:
    """Iterates device-resident batches over a stream.

    `device=None` means ``cuda:<device_index>`` and raises when no CUDA
    device is present; ``device="cpu"`` runs the plain CPU path.

    ``augment`` (an ``AugmentConfig``) applies the training augmentation
    to every frame after the VPP, each frame drawn from (aug_seed, 0,
    its absolute frame index): a loader resumed with ``start_frame``
    replays the same augmented bytes for the same frames."""

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
        self.device = resolve_device(device, device_index)
        self.device_index = self.device.index or 0
        self.batch = int(batch)
        self.prefetch = max(1, int(prefetch))
        self.host_resize = bool(host_resize)
        self.drop_partial = bool(drop_partial)
        self.stream_url = stream_url
        self.augment = augment
        self.aug_seed = 0 if aug_seed is None else int(aug_seed)
        self.params = FrameParameters(**frame_kwargs)
        _check_augment(self.params, augment)
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
        if self.augment is not None:
            # Frames are clips of one frame: [batch, 1, ...] out.
            self._vpp = build_vpp_clip_augment(
                self._cfg, self.augment, self.batch, 1, self.aug_seed,
                self.device)
        else:
            self._vpp = build_vpp_batched_flat(self._cfg, self.batch,
                                               self.device)
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
            flat = ship(buf, self.device)
            if self.augment is not None:
                # Each frame's draw is keyed by its absolute index (epoch
                # 0): resume-exact under start_frame.
                ids = np.zeros((self.batch, 2), np.int64)
                ids[:, 1] = np.arange(first, first + self.batch)
                tensors = self._vpp(flat, ids)[:, 0]
            else:
                tensors = self._vpp(flat)
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


class _ClipLoaderBase:
    """Shared scaffolding of the clip loaders: the native ClipReader, the
    clip-start grid, the deterministic (seed + epoch) epoch order, the
    fill thread, terminal-error latching, the device handoff and
    shutdown. A subclass sets up its sources, fills a staging buffer
    (``_fill``) and hands batches out (``__next__``)."""

    def _init_clip_params(self, clip_len, frame_stride, shuffle, seed,
                          prefetch, host_resize, frame_kwargs):
        """Validates and stores the sampling scalars; returns the (dst_w,
        dst_h, algo) of the native creates (zeros keep the native
        geometry)."""
        self._lib = _native.load()
        self.params = FrameParameters(**frame_kwargs)
        if self.params.color_standard is ColorStandard.AUTO:
            raise ValueError(
                f"{type(self).__name__} does not support "
                "color_standard=AUTO (clips decode out of order; pass "
                "the stream's standard explicitly)")
        self.clip_len = int(clip_len)
        self.frame_stride = max(1, int(frame_stride))
        # shuffle: False = sequential epochs; True/"uniform" = a full
        # permutation; "segment" = keyframe segments permuted, clips in
        # stream order within each (each GOP decodes about once a batch).
        if shuffle not in (True, False, 0, 1, "uniform", "segment"):
            raise ValueError(
                f"shuffle must be True/False/'uniform'/'segment': "
                f"{shuffle!r}")
        self.shuffle_mode = ("segment" if shuffle == "segment"
                             else "uniform" if shuffle else None)
        self.shuffle = self.shuffle_mode is not None
        self._seg_keys = None
        self.seed = int(seed)
        self.prefetch = max(1, int(prefetch))
        if host_resize:
            return (self.params.width, self.params.height,
                    host_resize_algo(self.params))
        return 0, 0, 0

    def _create_reader(self, stream_url, workers, dst_w, dst_h, algo,
                       decode_threads, fast_decode):
        """Opens and scans one source (keyframe table, no decode); returns
        (handle, out_w, out_h, total_frames)."""
        handle = self._lib.ts_clip_create(
            str(stream_url).encode(), int(workers), dst_w, dst_h, algo,
            decode_threads or 1, int(bool(fast_decode)))
        if not handle:
            raise RuntimeError(
                f"{type(self).__name__}: cannot scan {stream_url} (not "
                "a seekable file, or no decodable frames)")
        return (handle,
                self._lib.ts_clip_out_width(handle),
                self._lib.ts_clip_out_height(handle),
                self._lib.ts_clip_total_frames(handle))

    def _starts_grid(self, total_frames, clip_step, label):
        """The clip starts of one source (also sets self.clip_step)."""
        span = (self.clip_len - 1) * self.frame_stride + 1
        if span > total_frames:
            raise ValueError(
                f"clip span {span} exceeds {label} {total_frames} frames")
        self.clip_step = int(clip_step) if clip_step else span
        return np.arange(0, total_frames - span + 1, self.clip_step,
                         dtype=np.int64)

    def _init_augment(self, augment, aug_seed):
        self.augment = augment
        self.aug_seed = self.seed if aug_seed is None else int(aug_seed)

    def _build_vpp(self, cfg, clips):
        """The VPP for `clips` clips: the plain flat-batch VPP, or the VPP
        with augmentation (one CUDA graph a batch on the card)."""
        if self.augment is not None:
            return build_vpp_clip_augment(cfg, self.augment, clips,
                                          self.clip_len, self.aug_seed,
                                          self.device)
        return build_vpp_batched_flat(cfg, clips * self.clip_len,
                                      self.device)

    def _aug_ids(self, epoch, idents, capacity):
        """[capacity, 2] (epoch, clip identity) rows for the augmentation's
        draws; a short batch is padded with its last identity, like the
        decode pad, and the pad rows are sliced off after conversion."""
        ids = np.asarray(idents, np.int64)
        out = np.empty((capacity, 2), np.int64)
        out[:, 0] = epoch
        out[:len(ids), 1] = ids
        out[len(ids):, 1] = ids[-1]
        return out

    def _vpp_config(self, host_resize):
        """The VPP config for the readers' output geometry: after a host
        resize the frames arrive at the target size."""
        if host_resize:
            cfg_params = FrameParameters(
                pixel_format=self.params.pixel_format,
                planes_pos=self.params.planes_pos,
                normalization=self.params.normalization,
                color_standard=self.params.color_standard,
                dtype=self.params.dtype)
            return cfg_params.to_config(self._w, self._h)
        return self.params.to_config(self._w, self._h)

    def _check_batch_fits(self):
        if self.drop_partial and self.batch > len(self.starts):
            raise ValueError(
                f"batch {self.batch} exceeds the {len(self.starts)} "
                "clip starts per epoch — with drop_partial=True every "
                "epoch would yield zero batches; lower batch/clip_step "
                "or pass drop_partial=False")

    def _init_clip_source(self, stream_url, clip_len, frame_stride,
                          clip_step, shuffle, seed, workers, host_resize,
                          decode_threads, fast_decode, prefetch,
                          frame_kwargs):
        """Opens and scans the native ClipReader and computes the start
        grid; returns the VPP config. A failure after the native create
        destroys the handle before it propagates."""
        dst = self._init_clip_params(clip_len, frame_stride, shuffle, seed,
                                     prefetch, host_resize, frame_kwargs)
        self.stream_url = stream_url
        self._handle, self._w, self._h, self.total_frames = \
            self._create_reader(stream_url, workers, *dst, decode_threads,
                                fast_decode)
        try:
            self.starts = self._starts_grid(self.total_frames, clip_step,
                                            label="the stream's")
            return self._vpp_config(host_resize)
        except Exception:
            self._destroy_handle()
            raise

    def _start(self, epoch, start_clip, clips=None):
        """Starts the fill thread; `clips` is what a staging buffer and the
        VPP hold (default the batch; a sharded loader's rank share)."""
        self._clips = self.batch if clips is None else int(clips)
        self._vpp = self._build_vpp(self._cfg, self._clips)
        size = self._clips * self.clip_len * self._w * self._h * 3 // 2
        self._closed = False
        self.epoch = int(epoch)
        self._cursor = int(start_clip)  # clip index within the epoch order
        self._order = self._epoch_order(self.epoch)
        # (epoch, next clip index) as of the last batch handed out: what
        # state() reports (the fill thread runs ahead by `prefetch`).
        self._consumed = (self.epoch, self._cursor)
        self._pool = queue.Queue()
        for _ in range(self.prefetch + 2):
            self._pool.put(staging_buffer(size, self.device))
        self._filled = queue.Queue(maxsize=self.prefetch)
        self._pending = collections.deque()  # (buf, event) in flight
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _destroy_handle(self):
        if self._handle is not None:
            self._lib.ts_clip_destroy(self._handle)
            self._handle = None

    # ------------------------------------------------------------- sampling

    def _segment_table(self, handle):
        """First display frame of every cold-decoder entry point of one
        reader, ascending int64."""
        n = self._lib.ts_clip_segments(handle)
        buf = np.empty(max(n, 1), np.int64)
        self._lib.ts_clip_segment_table(
            handle, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            n)
        return buf[:n]

    def _segment_keys(self):
        """The segment of each element of self.starts."""
        if self._seg_keys is None:
            firsts = self._segment_table(self._handle)
            self._seg_keys = np.searchsorted(firsts, self.starts,
                                             side="right") - 1
        return self._seg_keys

    def _share(self, ids):
        """The part of a batch's clip ids this loader decodes: all."""
        return ids

    def _epoch_order(self, epoch):
        if self.shuffle_mode is None:
            return self.starts
        rng = np.random.default_rng(self.seed + epoch)
        if self.shuffle_mode == "uniform":
            return rng.permutation(self.starts)
        # "segment": the segments permuted, clips in stream order within
        # each, so a segment's run split across batches rides forward.
        keys = self._segment_keys()
        uniq, inv = np.unique(keys, return_inverse=True)
        rank = rng.permutation(len(uniq))[inv]
        return self.starts[np.argsort(rank, kind="stable")]

    def _epoch_done(self):
        """Fill-thread epoch boundary: when the cursor cannot make another
        batch, advance to the next (reshuffled) epoch, queue the
        StopIteration sentinel and return True."""
        if self._cursor >= len(self._order) or \
           (self.drop_partial and
                self._cursor + self.batch > len(self._order)):
            self.epoch += 1
            self._cursor = 0
            self._order = self._epoch_order(self.epoch)
            self._filled.put(None)
            return True
        return False

    def __len__(self):
        """Batches per epoch."""
        n = len(self.starts)
        return n // self.batch if self.drop_partial else -(-n // self.batch)

    # ------------------------------------------------------------ iteration

    def __iter__(self):
        return self

    def _check_latched(self, item):
        """Raises for the epoch-boundary sentinel and the latched terminal
        items (renegotiation, decode error); passes batches through."""
        if item is None:
            raise StopIteration  # epoch boundary; the fill continues
        if item is _RENEGOTIATED:
            self._filled.put(item)
            raise RuntimeError(
                "stream resolution changed mid-stream; use "
                f"{type(self).__name__}(host_resize=True, width=..., "
                "height=...) to ride through switches")
        if isinstance(item, Exception):
            self._filled.put(item)
            raise item

    def state(self):
        """Resumable position: pass epoch=.. start_clip=.. to a new loader
        over the same stream (same seed) to continue; it counts batches
        handed out, not prefetched ones. The JAX package's dict."""
        epoch, cursor = self._consumed
        return {"stream_url": self.stream_url, "epoch": epoch,
                "start_clip": cursor, "seed": self.seed}

    @property
    def frames_decoded(self):
        """Frames decoded natively (IDR warm-up included)."""
        return self._lib.ts_clip_frames_decoded(self._handle)

    def _to_device_batch(self, buf, got, aug_ids=None):
        """One copy of the staging buffer to the device, the VPP (with the
        augmentation, when set) as [batch, clip_len, ...], the partial
        tail sliced off; the buffer rotates back to the pool once the
        event recorded behind the VPP of a later batch has completed."""
        flat = ship(buf, self.device)
        if self.augment is not None:
            tensors = self._vpp(flat, aug_ids)
        else:
            tensors = self._vpp(flat)
            tensors = tensors.reshape((self._clips, self.clip_len)
                                      + tuple(tensors.shape[1:]))
        self._pending.append((buf, record_event(self.device)))
        if got < self._clips:
            tensors = tensors[:got]
        if len(self._pending) > self.prefetch:
            old_buf, old_event = self._pending.popleft()
            wait_event(old_event)
            self._pool.put(old_buf)
        return tensors

    def close(self):
        if getattr(self, "_closed", True):
            return  # never started, or already closed
        self._closed = True
        self._stop.set()
        while self._pending:
            buf, event = self._pending.popleft()
            wait_event(event)
            self._pool.put(buf)
        try:
            self._pool.put_nowait(None)  # wake a fill waiting for a buffer
        except queue.Full:
            pass
        try:
            self._filled.get_nowait()  # wake a fill on the bounded queue
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
        if self._thread.is_alive():
            # A large native batch decode can outlast the first join on a
            # loaded host; destroying the reader under the live call would
            # be a use-after-free. Wait it out, or leak the handle.
            self._thread.join(timeout=120)
            if self._thread.is_alive():
                warnings.warn(
                    f"{type(self).__name__}.close(): fill thread still "
                    "inside a native call; leaking the ClipReader handle")
                return
        self._destroy_handle()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ClipLoader(_ClipLoaderBase):
    """Shuffled fixed-length clip batches from one file, for video-model
    training. Port of the JAX package's ``data.py:802-911``.

    The native ClipReader (csrc/clip_reader.h) seeks each requested clip
    to its nearest IDR entry point, decodes the warm-up and returns bytes
    equal to the serial decode of the same frame indices.

        loader = ClipLoader("video.mp4", clip_len=8, batch=4,
                            host_resize=True, width=224, height=224,
                            pixel_format=FourCC.RGB24,
                            planes_pos=Planes.PLANAR, normalization=True,
                            shuffle=True, seed=0, workers=2)
        for clips, starts in loader:   # [4, 8, 3, 224, 224] f32 on cuda:0
            train_step(clips)

    One pass is one epoch over every clip start (``clip_step`` apart;
    non-overlapping by default), in the order numpy ``default_rng(seed +
    epoch)`` gives, so ``ClipLoader(..., epoch=e, start_clip=k)`` resumes
    where ``state()`` left off. With ``host_resize=False`` and a target
    size the resize runs on the card (ops/resize.py). ``augment`` (an
    ``AugmentConfig``) augments each clip from (aug_seed, epoch, start).
    `device=None` means ``cuda:<device_index>``."""

    def __init__(self, stream_url, clip_len, batch=4, frame_stride=1,
                 clip_step=None, shuffle=True, seed=0, workers=2,
                 host_resize=False, decode_threads=0, fast_decode=False,
                 device_index=0, drop_partial=True, prefetch=2,
                 epoch=0, start_clip=0, augment=None, aug_seed=None,
                 device=None, **frame_kwargs):
        self.batch = int(batch)
        self.drop_partial = bool(drop_partial)
        self.device = resolve_device(device, device_index)
        self.device_index = self.device.index or 0
        self._cfg = self._init_clip_source(
            stream_url, clip_len, frame_stride, clip_step, shuffle, seed,
            workers, host_resize, decode_threads, fast_decode, prefetch,
            frame_kwargs)
        try:
            self._init_augment(augment, aug_seed)
            self._check_batch_fits()
            self._start(epoch, start_clip)
        except Exception:
            self._destroy_handle()
            raise

    def _fill(self):
        capacity = self._clips
        y_size = capacity * self.clip_len * self._w * self._h
        while not self._stop.is_set():
            if self._epoch_done():
                continue
            batch_starts = self._order[self._cursor:self._cursor + self.batch]
            self._cursor += len(batch_starts)
            meta = (self.epoch, self._cursor)
            sub = self._share(batch_starts)
            got = len(sub)
            # The native call and the VPP are fixed-size: a trailing
            # partial batch repeats its last start, sliced off afterwards.
            padded = sub if got == capacity else np.concatenate(
                [sub, np.full(capacity - got, sub[-1], np.int64)])
            padded = np.ascontiguousarray(padded, np.int64)
            buf = self._pool.get()
            if buf is None or self._stop.is_set():
                break
            rc = self._lib.ts_clip_get_batch(
                self._handle,
                padded.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                capacity, self.clip_len, self.frame_stride,
                buf.data_ptr(), buf.data_ptr() + y_size)
            if rc == _native.TS_RENEGOTIATE:
                self._filled.put(_RENEGOTIATED)
                break
            if rc != 0:
                self._filled.put(RuntimeError(
                    f"clip decode failed (code {rc})"))
                break
            self._filled.put((buf, got, batch_starts, meta))

    def __next__(self):
        """(clips, starts): clips a [batch, clip_len, ...frame dims...]
        tensor, starts the 0-based first frame of each clip. Raises
        StopIteration at each epoch boundary; iterating again continues
        into the next (reshuffled) epoch."""
        item = self._filled.get()
        self._check_latched(item)
        buf, got, starts, self._consumed = item
        aug_ids = None if self.augment is None else \
            self._aug_ids(self._consumed[0], starts, self.batch)
        return self._to_device_batch(buf, got, aug_ids), list(starts)


class ClipDataset(_ClipLoaderBase):
    """Globally shuffled clip batches across many files. Port of the JAX
    package's ``data.py:913-1130``.

    Every source is scanned once (keyframe tables, no decode), the
    per-file start grids are concatenated into one global index, and that
    index is shuffled with ``seed + epoch``: each clip of the corpus is
    visited once an epoch. Decoders open lazily per file and at most
    ``max_open`` files keep theirs (least recently used released between
    batches).

        ds = ClipDataset(["a.mp4", "b.mp4"], clip_len=8, batch=4,
                         host_resize=True, width=224, height=224,
                         pixel_format=FourCC.RGB24,
                         planes_pos=Planes.PLANAR, normalization=True)
        for clips, labels in ds:     # clips [4, 8, 3, 224, 224] on cuda:0
            ...                      # labels [(file_idx, start), ...]

    A batch keeps the shuffle's membership, regrouped file-contiguous (one
    native call per touched file); ``labels`` gives every clip's (file
    index, first frame) in yielded order. Without ``host_resize`` all
    files must share one decoded geometry. Epochs, ``state()`` and resume
    are ClipLoader's."""

    def __init__(self, stream_urls, clip_len, batch=4, frame_stride=1,
                 clip_step=None, shuffle=True, seed=0, workers=2,
                 host_resize=False, decode_threads=0, fast_decode=False,
                 device_index=0, drop_partial=True, prefetch=2,
                 epoch=0, start_clip=0, max_open=4, augment=None,
                 aug_seed=None, device=None, **frame_kwargs):
        self.batch = int(batch)
        self.drop_partial = bool(drop_partial)
        self._handles = []
        self.device = resolve_device(device, device_index)
        self.device_index = self.device.index or 0
        self._cfg = self._init_corpus(
            stream_urls, clip_len, frame_stride, clip_step, shuffle, seed,
            workers, host_resize, decode_threads, fast_decode, prefetch,
            max_open, frame_kwargs)
        try:
            self._init_augment(augment, aug_seed)
            self._check_batch_fits()
            self._start(epoch, start_clip)
        except Exception:
            self._destroy_handle()
            raise

    def _init_corpus(self, stream_urls, clip_len, frame_stride, clip_step,
                     shuffle, seed, workers, host_resize, decode_threads,
                     fast_decode, prefetch, max_open, frame_kwargs):
        """Scans every source and builds the global clip index; returns the
        VPP config. Handles already created are destroyed before a
        mid-scan failure propagates."""
        self.stream_urls = [str(u) for u in stream_urls]
        if not self.stream_urls:
            raise ValueError(f"{type(self).__name__} needs >=1 source")
        self.max_open = max(1, int(max_open))
        dst = self._init_clip_params(clip_len, frame_stride, shuffle, seed,
                                     prefetch, host_resize, frame_kwargs)
        try:
            file_of, start_of = [], []
            self._w = self._h = 0
            for fi, url in enumerate(self.stream_urls):
                handle, w, h, total = self._create_reader(
                    url, workers, *dst, decode_threads, fast_decode)
                self._handles.append(handle)
                if fi == 0:
                    self._w, self._h = w, h
                elif (w, h) != (self._w, self._h):
                    raise ValueError(
                        f"{url} decodes to {w}x{h} but "
                        f"{self.stream_urls[0]} to {self._w}x{self._h}; "
                        "pass host_resize=True with width/height to mix "
                        "resolutions")
                starts = self._starts_grid(total, clip_step,
                                           label=f"{url}'s")
                file_of.append(np.full(len(starts), fi, np.int64))
                start_of.append(starts)
            self._file_of = np.concatenate(file_of)
            self._start_of = np.concatenate(start_of)
            # The shuffled unit is the global clip id (a row of the
            # file_of/start_of tables).
            self.starts = np.arange(len(self._file_of), dtype=np.int64)
            self._lru = collections.OrderedDict()  # files with open pools
            return self._vpp_config(host_resize)
        except Exception:
            self._destroy_handle()
            raise

    @property
    def files(self):
        """Sources in label order: a label's file index points here."""
        return list(self.stream_urls)

    @property
    def frames_decoded(self):
        return sum(self._lib.ts_clip_frames_decoded(h)
                   for h in self._handles)

    def _segment_keys(self):
        """shuffle='segment' groups of the global index: the unit is
        (file, segment)."""
        if self._seg_keys is None:
            keys, base = [], 0
            for fi, h in enumerate(self._handles):
                firsts = self._segment_table(h)
                local = self._start_of[self._file_of == fi]
                keys.append(base + np.searchsorted(firsts, local,
                                                   side="right") - 1)
                base += len(firsts)
            self._seg_keys = np.concatenate(keys)
        return self._seg_keys

    def state(self):
        epoch, cursor = self._consumed
        return {"stream_urls": self.files, "epoch": epoch,
                "start_clip": cursor, "seed": self.seed}

    def _destroy_handle(self):
        for h in self._handles:
            self._lib.ts_clip_destroy(h)
        self._handles = []

    def _touch(self, fi):
        """Least-recently-used bookkeeping after a native call on file
        `fi`: release the decoders (the keyframe scans stay) of the files
        beyond max_open. Fill thread only."""
        self._lru[fi] = True
        self._lru.move_to_end(fi)
        while len(self._lru) > self.max_open:
            old, _ = self._lru.popitem(last=False)
            self._lib.ts_clip_release_decoders(self._handles[old])

    def _regroup(self, ids):
        """`ids` file-contiguous, stable: one native call a file."""
        return ids[np.argsort(self._file_of[ids], kind="stable")]

    def _decode_ids_into(self, ids, buf, capacity):
        """Decodes the clips of global ids into `buf` (laid out for
        `capacity` clips), regrouped file-contiguous (stable) with one
        native call per touched file; a short `ids` is padded by
        repeating the last regrouped clip. Returns (regrouped ids, rc,
        failed file index)."""
        got = len(ids)
        ids = self._regroup(ids)
        padded = ids if got == capacity else np.concatenate(
            [ids, np.repeat(ids[-1:], capacity - got)])
        y_frame = self._w * self._h
        uv_frame = (self._h // 2) * self._w
        y_size = capacity * self.clip_len * y_frame
        files = self._file_of[padded]
        base = buf.data_ptr()
        pos = 0
        for fi in np.unique(files):
            sub = np.ascontiguousarray(self._start_of[padded[files == fi]])
            rc = self._lib.ts_clip_get_batch(
                self._handles[fi],
                sub.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                len(sub), self.clip_len, self.frame_stride,
                base + pos * self.clip_len * y_frame,
                base + y_size + pos * self.clip_len * uv_frame)
            self._touch(int(fi))
            if rc != 0:
                return ids, rc, int(fi)
            pos += len(sub)
        return ids, 0, -1

    def _fill(self):
        while not self._stop.is_set():
            if self._epoch_done():
                continue
            ids = self._order[self._cursor:self._cursor + self.batch]
            self._cursor += len(ids)
            meta = (self.epoch, self._cursor)
            sub = self._share(ids)
            buf = self._pool.get()
            if buf is None or self._stop.is_set():
                break
            decoded, rc, fi = self._decode_ids_into(sub, buf, self._clips)
            if rc != 0:
                self._filled.put(
                    _RENEGOTIATED if rc == _native.TS_RENEGOTIATE
                    else RuntimeError(f"clip decode failed (code {rc}, "
                                      f"file {self.stream_urls[fi]})"))
                break
            self._filled.put((buf, len(sub), self._yielded_ids(ids, decoded),
                              meta))

    def _yielded_ids(self, ids, decoded):
        """The global ids a batch yields, in its order: those decoded."""
        return decoded

    def __next__(self):
        """(clips, labels): clips a [batch, clip_len, ...] tensor, labels
        the (file index, first frame) of each clip in the same order.
        Raises StopIteration at each epoch boundary."""
        item = self._filled.get()
        self._check_latched(item)
        buf, got, ids, self._consumed = item
        labels = [(int(self._file_of[i]), int(self._start_of[i]))
                  for i in ids]
        aug_ids = None if self.augment is None else \
            self._aug_ids(self._consumed[0], ids, self.batch)
        return self._to_device_batch(buf, got, aug_ids), labels


def _dp_mesh(mesh, device):
    """(mesh, this rank's place k on its "dp" axis, the axis size, the
    device): `mesh` or a 1-D "dp" mesh over the process group."""
    from .parallel.sharding import make_mesh, mesh_device
    if mesh is None:
        mesh = make_mesh(axes=("dp",), device=device)
    return (mesh, mesh.get_local_rank("dp"), mesh["dp"].size(),
            mesh_device(mesh))


def _global_batch(mesh, local, n):
    """The ranks' equal shares `local` as one DTensor over "dp" (no copy:
    the rank's tensor is the DTensor's local shard)."""
    from torch.distributed.tensor import DTensor

    from .parallel.sharding import spec_placements
    shape = (n * local.shape[0],) + tuple(local.shape[1:])
    return DTensor.from_local(local, mesh, spec_placements(mesh, ("dp",)),
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


class _Sharded:
    """The dp plumbing of the sharded clip loaders, one process a rank:
    every rank draws the same (seed + epoch) order and decodes only its
    own `per_device` clips of each global batch (ranks in "dp" order);
    epoch tails that cannot fill every shard are dropped."""

    def _init_shards(self, per_device, mesh, device):
        self.mesh, self.rank, self.n_shards, self.device = _dp_mesh(mesh,
                                                                    device)
        self.device_index = self.device.index or 0
        self.per_device = int(per_device)
        self.batch = self.per_device * self.n_shards
        self.drop_partial = True

    def _check_shards_fit(self):
        if self.batch > len(self.starts):
            raise ValueError(
                f"global batch {self.batch} (= {self.n_shards} ranks x "
                f"{self.per_device} clips) exceeds the {len(self.starts)} "
                "clip starts per epoch — every epoch would yield zero "
                "batches; lower per_device/clip_step or use fewer ranks")

    def _share(self, ids):
        k, pd = self.rank, self.per_device
        return ids[k * pd:(k + 1) * pd]

    def _sharded_next(self):
        """(global DTensor batch, ids of the whole batch)."""
        item = self._filled.get()
        self._check_latched(item)
        buf, _, ids, self._consumed = item
        aug_ids = None if self.augment is None else self._share(
            self._aug_ids(self._consumed[0], ids, self.batch))
        local = self._to_device_batch(buf, self.per_device, aug_ids)
        return _global_batch(self.mesh, local, self.n_shards), ids


class ShardedClipLoader(_Sharded, ClipLoader):
    """Clip batches from one file, sharded over the ranks of a "dp" mesh
    (data-parallel training). Port of the JAX package's ``data.py:1132``.

        loader = ShardedClipLoader("video.mp4", clip_len=8, per_device=2,
                                   host_resize=True, width=224, height=224,
                                   pixel_format=FourCC.RGB24,
                                   planes_pos=Planes.PLANAR,
                                   normalization=True)
        for clips, starts in loader:  # DTensor [ranks*2, 8, ...] over "dp"
            train_step(clips)

    One process a rank (``mesh``: a mesh with a "dp" axis, default a 1-D
    one over the initialized process group). Every rank samples the same
    shuffled epoch, so no clip is duplicated across ranks; each decodes
    only its own share into its own staging buffer and ships it to its
    own device, and the global batch is ``DTensor.from_local`` of that
    share: no further copy. Epochs, ``state()`` and resume are
    ClipLoader's; ``starts`` are the whole batch's."""

    def __init__(self, stream_url, clip_len, per_device=2, mesh=None,
                 frame_stride=1, clip_step=None, shuffle=True, seed=0,
                 workers=2, host_resize=False, decode_threads=0,
                 fast_decode=False, prefetch=2, epoch=0, start_clip=0,
                 augment=None, aug_seed=None, device=None, **frame_kwargs):
        self._init_shards(per_device, mesh, device)
        self._cfg = self._init_clip_source(
            stream_url, clip_len, frame_stride, clip_step, shuffle, seed,
            workers, host_resize, decode_threads, fast_decode, prefetch,
            frame_kwargs)
        try:
            self._init_augment(augment, aug_seed)
            self._check_shards_fit()
            self._start(epoch, start_clip, self.per_device)
        except Exception:
            self._destroy_handle()
            raise

    def __next__(self):
        """(clips, starts): clips one DTensor [batch, clip_len, ...] over
        "dp", starts the first frame of each clip of the whole batch."""
        clips, starts = self._sharded_next()
        return clips, list(starts)


class ShardedClipDataset(_Sharded, ClipDataset):
    """Globally shuffled clips from many files, sharded over the ranks of
    a "dp" mesh. Port of the JAX package's ``data.py:1218``: ClipDataset's
    corpus-wide (seed + epoch) epoch with ShardedClipLoader's one process
    a rank. Each rank regroups its own share file-contiguous; ``labels``
    are the (file index, first frame) of the whole batch, the shares in
    rank order, each regrouped (every rank computes them: the regrouping
    is deterministic). Augmentation is keyed by the global clip identity,
    as in ClipDataset."""

    def __init__(self, stream_urls, clip_len, per_device=2, mesh=None,
                 frame_stride=1, clip_step=None, shuffle=True, seed=0,
                 workers=2, host_resize=False, decode_threads=0,
                 fast_decode=False, prefetch=2, epoch=0, start_clip=0,
                 max_open=4, augment=None, aug_seed=None, device=None,
                 **frame_kwargs):
        self._handles = []
        self._init_shards(per_device, mesh, device)
        self._cfg = self._init_corpus(
            stream_urls, clip_len, frame_stride, clip_step, shuffle, seed,
            workers, host_resize, decode_threads, fast_decode, prefetch,
            max_open, frame_kwargs)
        try:
            self._init_augment(augment, aug_seed)
            self._check_shards_fit()
            self._start(epoch, start_clip, self.per_device)
        except Exception:
            self._destroy_handle()
            raise

    def _yielded_ids(self, ids, decoded):
        """Every rank's share of `ids`, each regrouped as its rank does."""
        pd = self.per_device
        return np.concatenate([self._regroup(ids[j * pd:(j + 1) * pd])
                               for j in range(self.n_shards)])

    def __next__(self):
        """(clips, labels): clips one DTensor [batch, clip_len, ...] over
        "dp", labels the (file index, first frame) of each clip."""
        clips, ids = self._sharded_next()
        return clips, [(int(self._file_of[i]), int(self._start_of[i]))
                       for i in ids]


class ShardedStreamLoader:
    """N streams -> one DTensor batch over the N ranks of a "dp" mesh
    (data-parallel serving). Port of the JAX package's ``data.py:1303``.

        loader = ShardedStreamLoader([u1, u2, u3, u4], per_stream=8,
                                     width=224, height=224, ...)
        for batch, indices in loader:   # DTensor [32, ...] over "dp"
            logits = model(batch)

    One process a rank: rank k runs stream k's FrameLoader onto its own
    device, and the batch is ``DTensor.from_local`` of its frames (no
    copy). ``indices`` holds every stream's frame indices, gathered from
    the ranks as one fixed-size int64 tensor (-1 for a stream with no
    batch) on a side stream of the device, so the gather waits for no
    frame conversion. Iteration ends on every rank when any stream is
    exhausted; a short final batch ends it too (shards must be
    equal-sized)."""

    def __init__(self, stream_urls, per_stream=8, mesh=None, device=None,
                 **kwargs):
        self.mesh, rank, n, dev = _dp_mesh(mesh, device)
        if len(stream_urls) != n:
            raise ValueError(f"{len(stream_urls)} streams need as many "
                             f"ranks on the 'dp' axis, the mesh has {n}")
        kwargs.setdefault("drop_partial", True)
        # Streams at the same frame index draw independent transforms.
        base_seed = kwargs.pop("aug_seed", None) or 0
        self.loader = FrameLoader(stream_urls[rank], batch=per_stream,
                                  aug_seed=base_seed + rank, device=dev,
                                  **kwargs)
        self.per_stream, self.n_streams = per_stream, n
        self._group = self.mesh.get_group("dp")
        self._side = (torch.cuda.Stream(dev) if dev.type == "cuda"
                      else None)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            tensors, idx = next(self.loader)
        except StopIteration:
            tensors, idx = None, None
        every = self._gather_indices(idx)
        if (every < 0).any():
            raise StopIteration
        return (_global_batch(self.mesh, tensors, self.n_streams),
                dict(enumerate(every.tolist())))

    def _gather_indices(self, idx):
        """[n_streams, per_stream] int64 on the host: every rank's frame
        indices, a row of -1 where a rank's stream had no full batch."""
        mine = np.full(self.per_stream, -1, np.int64)
        if idx is not None and len(idx) == self.per_stream:
            mine[:] = idx
        dev = self.loader.device
        with (torch.cuda.stream(self._side) if self._side is not None
              else contextlib.nullcontext()):
            local = torch.from_numpy(mine).to(dev)
            every = torch.empty(self.n_streams * self.per_stream,
                                dtype=torch.int64, device=dev)
            torch.distributed.all_gather_into_tensor(every, local,
                                                     group=self._group)
            return every.cpu().numpy().reshape(self.n_streams, -1)

    def close(self):
        self.loader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


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
