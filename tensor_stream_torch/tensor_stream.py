"""TensorStreamConverter: the user-facing API, returning torch tensors.

Port of the JAX package's ``tensor_stream.py`` (reference:
tensor_stream/tensor_stream.py:100-341): the same constructor arguments,
the same ``initialize/start/read/param_read/read_batch/dump/stop/
enable_logs/enable_nvtx/skip_analyze/set_timeout`` methods and the same
``(tensor, index)`` return convention; the tensors lie on ``cuda:N``.

The native runtime (demux + software decode + NV12 ring) runs its
producer thread in C++. Each read drains NV12 into a pinned host staging
buffer, ships it to the device in one ``non_blocking`` copy and runs the
VPP on the current stream; the event recorded after the VPP guards the
staging slot until the device has read it.
"""
import ctypes
import dataclasses
import logging

import torch

from . import _native
from ._device import (record_event, resolve_device, ship, staging_buffer,
                      wait_event)
from .enums import (ColorStandard, FourCC, FrameRate, LogsLevel, LogsType,
                    Planes, ResizeType, StatusLevel, channels_by_fourcc)
from .ops.vpp import VPPConfig, build_vpp, build_vpp_batched_flat


class FrameParameters:
    """Per-read frame parameters (reference: tensor_stream.py:101-149)."""

    def __init__(self,
                 width=0,
                 height=0,
                 crop_coords=(0, 0, 0, 0),
                 resize_type=ResizeType.NEAREST,
                 pixel_format=FourCC.RGB24,
                 planes_pos=Planes.MERGED,
                 normalization=None,
                 color_standard=ColorStandard.BT601,
                 dtype=""):
        self.width = width
        self.height = height
        self.crop_coords = tuple(crop_coords)
        self.resize_type = resize_type
        self.pixel_format = pixel_format
        self.planes_pos = planes_pos
        # None means "library decides": False everywhere except HSV, which
        # forces normalization (reference: VideoProcessor.h:39-52).
        self.normalization = normalization
        self.color_standard = color_standard
        # Output dtype override ("bfloat16"/"float16"/"float32"); "" keeps
        # the uint8-or-float32 reference contract.
        self.dtype = dtype

    def to_config(self, src_width: int, src_height: int) -> VPPConfig:
        norm = self.normalization
        if norm is None:
            norm = self.pixel_format == FourCC.HSV
        return VPPConfig(src_width=src_width, src_height=src_height,
                         crop=self.crop_coords, width=self.width,
                         height=self.height, resize_type=self.resize_type,
                         fourcc=self.pixel_format, planes=self.planes_pos,
                         normalization=bool(norm),
                         standard=self.color_standard, dtype=self.dtype)

    def __repr__(self):
        return (f"FrameParameters(\n"
                f"    width={self.width},\n"
                f"    height={self.height},\n"
                f"    crop_coords={self.crop_coords},\n"
                f"    resize_type={self.resize_type},\n"
                f"    pixel_format={self.pixel_format},\n"
                f"    planes_pos={self.planes_pos},\n"
                f"    normalization={self.normalization},\n"
                f"    dtype={self.dtype!r}\n"
                ")")


def host_resize_algo(fp: FrameParameters) -> int:
    """Validates `fp` for the native host-resize path and returns the
    HostResizeAlgo value (csrc/vpp_host.h; values mirror ResizeType)."""
    if not (fp.width and fp.height):
        raise ValueError("host_resize requires width and height")
    if any(fp.crop_coords):
        raise ValueError("host_resize does not support crop")
    rt = (fp.resize_type if isinstance(fp.resize_type, ResizeType)
          else ResizeType(fp.resize_type))
    return rt.value  # all four algorithms have native ports


def tensor_bytes(tensor) -> bytes:
    """The raw bytes of a tensor as it lies in memory, on the host."""
    t = tensor.detach().contiguous().cpu().reshape(-1)
    return t.view(torch.uint8).numpy().tobytes()


class TensorStreamConverter:
    """Starts the decode pipeline and serves post-processed frames as
    torch tensors on `device` (reference: tensor_stream.py:153-339).

    `device=None` means ``cuda:<cuda_device or 0>`` and raises when no
    CUDA device is present; pass ``device="cpu"`` for the plain CPU path.
    """

    # Staging rotation depth: reads can run this many frames ahead of the
    # device before the host waits on the oldest slot's event.
    _STAGING_DEPTH = 4

    def __init__(self,
                 stream_url,
                 max_consumers=5,
                 cuda_device=None,
                 buffer_size=5,
                 framerate_mode=FrameRate.NATIVE,
                 timeout=None,
                 decode_threads=0,
                 loop=False,
                 enable_dumps=False,
                 fast_decode=False,
                 reconnect=False,
                 reconnect_delay=0.5,
                 reconnect_attempts=20,
                 format_options=None,
                 device=None):
        self.device = resolve_device(device, cuda_device)
        self.device_index = self.device.index or 0
        self.log = logging.getLogger(__name__)
        self.log.info("Create TensorStream")
        self._lib = _native.load()
        self._handle = None
        self.thread = None
        ## Frames per second probed from the bitstream (set by initialize()).
        self.fps = None
        ## (width, height) of input frames (set by initialize()).
        self.frame_size = None

        self.stream_url = stream_url
        self.max_consumers = max_consumers
        self.buffer_size = buffer_size
        self.framerate_mode = framerate_mode
        self.decode_threads = decode_threads
        # Replay the stream from the start on EOF.
        self.loop = loop
        # Skip the H.264 in-loop deblocking filter: faster, NOT bit-exact.
        self.fast_decode = fast_decode
        # Re-open a live source that dies mid-stream, with backoff.
        self.reconnect = reconnect
        self.reconnect_delay = reconnect_delay
        self.reconnect_attempts = reconnect_attempts
        # Extra avformat open options, e.g. {"rtsp_flags": "listen"}.
        self.format_options = dict(format_options or {})
        # Debug taps: bitstream.h264 + NV12.yuv from the native side and
        # Processed_<consumer>.yuv from read().
        self.enable_dumps = enable_dumps
        self._buffers = {}  # consumer -> flat NV12 staging slots
        self._dumped_consumers = set()  # Processed_ taps written this run
        self._batch_staging = {}  # (consumer, batch, ...) -> flat staging
        self._retired = []  # stopped handles awaiting safe destruction
        self._started = False
        self.set_timeout(timeout=timeout)
        self._pending_logs = None
        self._pending_trace = False
        self._skip_analyze = False

    # ------------------------------------------------------------ lifecycle

    def initialize(self, repeat_number=1):
        """Builds the native pipeline, retrying up to repeat_number times
        (reference: tensor_stream.py:187-206)."""
        self.log.info("Initialize TensorStream")
        self._reap_retired()
        self._dumped_consumers = set()
        status = StatusLevel.REPEAT.value
        repeat = repeat_number
        while status != StatusLevel.OK.value and repeat > 0:
            self._handle = self._lib.ts_pipeline_create()
            for key, value in self.format_options.items():
                self._lib.ts_pipeline_set_format_option(
                    self._handle, str(key).encode(), str(value).encode())
            status_native = self._lib.ts_pipeline_init_ex2(
                self._handle, str(self.stream_url).encode(),
                int(self.max_consumers), int(self.buffer_size),
                int(self.framerate_mode.value
                    if isinstance(self.framerate_mode, FrameRate)
                    else self.framerate_mode),
                1 if self.enable_dumps else 0, int(self.decode_threads),
                1 if self.loop else 0, 1 if self.fast_decode else 0,
                1 if self.reconnect else 0,
                int(self.reconnect_delay * 1000),
                int(self.reconnect_attempts))
            status = (StatusLevel.OK.value if status_native == _native.TS_OK
                      else StatusLevel.ERROR.value)
            if status != StatusLevel.OK.value:
                self.stop()
                repeat -= 1

        if repeat == 0:
            raise RuntimeError("Can't initialize TensorStream")
        if self._pending_logs is not None:
            self._lib.ts_pipeline_enable_logs(self._handle, self._pending_logs)
        if self._pending_trace:
            self._lib.ts_pipeline_enable_trace(self._handle)
        if self._skip_analyze:
            self._lib.ts_pipeline_skip_analyze(self._handle)
        num = self._lib.ts_pipeline_fps_num(self._handle)
        den = self._lib.ts_pipeline_fps_den(self._handle)
        self.fps = num / den if den else None
        self.frame_size = (self._lib.ts_pipeline_width(self._handle),
                           self._lib.ts_pipeline_height(self._handle))

    def seek_frame(self, skip):
        """Positions the stream so the next delivered frame is number
        ``skip + 1``. Call between initialize() and start()."""
        if self._handle is None:
            raise RuntimeError("TensorStream is not initialized")
        if self._started:
            raise RuntimeError("seek_frame must be called before start()")
        sts = self._lib.ts_pipeline_seek_frame(self._handle, int(skip))
        if sts != _native.TS_OK:
            raise RuntimeError(f"seek_frame({skip}) failed: {sts}")

    def start(self):
        """Starts the producer (parse -> analyze -> decode) loop in a
        native thread; ``self.thread`` stays None (kept for code written
        against the reference)."""
        if self._handle is None:
            raise RuntimeError("TensorStream is not initialized")
        self._lib.ts_pipeline_start(self._handle)
        self._started = True

    def stop(self):
        self.log.info("Stop TensorStream")
        if self._handle is not None:
            self._lib.ts_pipeline_stop(self._handle)
            # Destruction is deferred (see _reap_retired): another thread
            # may still be unwinding a native call on this handle.
            self._retired.append(self._handle)
            self._handle = None
        self._started = False
        if self.thread is not None:
            self.thread.join()
            self.thread = None
        self._buffers.clear()
        self._batch_staging.clear()

    # ---------------------------------------------------------------- config

    def enable_logs(self, level, log_type):
        """Positive level -> file logs.txt, negative -> console
        (reference: tensor_stream.py:211-216)."""
        if level == LogsLevel.NONE:
            return
        value = level.value if log_type == LogsType.FILE else -level.value
        self._pending_logs = value
        if self._handle is not None:
            self._lib.ts_pipeline_enable_logs(self._handle, value)

    def enable_nvtx(self):
        """Host tracing in place of the reference's NVTX switch: spans go
        to trace_host.json (chrome://tracing); device timelines come from
        torch.profiler."""
        self._pending_trace = True
        if self._handle is not None:
            self._lib.ts_pipeline_enable_trace(self._handle)

    def set_timeout(self, timeout):
        """Read timeout in seconds; None disables. Process-global, like
        the reference's timeoutFrame (tensor_stream.py:224-229)."""
        if timeout is None:
            self._lib.ts_set_timeout_ms(-1)
        else:
            self._lib.ts_set_timeout_ms(int(timeout * 1000))

    def _reap_retired(self):
        for h in self._retired:
            self._lib.ts_pipeline_destroy(h)
        self._retired = []

    def __del__(self):
        try:
            if self._handle is not None:
                self._lib.ts_pipeline_stop(self._handle)
                self._lib.ts_pipeline_destroy(self._handle)
                self._handle = None
            self._reap_retired()
        except Exception:
            pass  # interpreter teardown: the native side may be gone

    def skip_analyze(self):
        self._skip_analyze = True
        if self._handle is not None:
            self._lib.ts_pipeline_skip_analyze(self._handle)

    @property
    def stream_errors(self):
        """Accumulated bitstream-health bitmask from the analyzer."""
        if self._handle is None:
            return 0
        return self._lib.ts_pipeline_analyze_errors(self._handle)

    @property
    def reconnects(self):
        """Successful live-source reconnects since start()."""
        if self._handle is None:
            return 0
        return self._lib.ts_pipeline_reconnect_count(self._handle)

    # ----------------------------------------------------------------- read

    def _resolve_standard(self, cfg):
        """Replaces ColorStandard.AUTO with the colorimetry detected from
        the stream's decoded frames (a frame has always been read before
        the VPP config is built)."""
        if cfg.standard is not ColorStandard.AUTO:
            return cfg
        handle = self._handle
        detected = (self._lib.ts_pipeline_detected_standard(handle)
                    if handle is not None else 0)
        return dataclasses.replace(cfg, standard=ColorStandard(detected))

    def _consumer_buffers(self, name, dims=None):
        """Next staging slot of consumer `name`, sized for the geometry it
        has acknowledged: (flat, y view, uv view). Waits for the event of
        the read that last used the slot."""
        st = self._buffers.get(name)
        if dims is None:
            dims = st["dims"] if st is not None else self.frame_size
        w, h = dims
        if st is None or st["dims"] != (w, h):
            st = {"dims": (w, h),
                  "bufs": [staging_buffer(h * w * 3 // 2, self.device)
                           for _ in range(self._STAGING_DEPTH)],
                  "events": [None] * self._STAGING_DEPTH,
                  "slot": 0}
            self._buffers[name] = st
        slot = st["slot"]
        wait_event(st["events"][slot])
        st["events"][slot] = None
        flat = st["bufs"][slot]
        return (flat, flat[:h * w].view(h, w),
                flat[h * w:].view(h // 2, w))

    def _mark_inflight(self, name):
        """Records the event behind the current slot's VPP and rotates.
        Tolerates the state vanishing under a concurrent stop()."""
        st = self._buffers.get(name)
        if st is None:
            return
        st["events"][st["slot"]] = record_event(self.device)
        st["slot"] = (st["slot"] + 1) % self._STAGING_DEPTH

    def _get_nv12(self, name, delay):
        # Snapshot the handle: a concurrent stop() nulls self._handle (the
        # object stays alive until _reap_retired, and a stopped pipeline
        # returns TS_FINISHED).
        handle = self._handle
        if handle is None or self.frame_size is None:
            raise RuntimeError("TensorStream is not initialized")
        if not self._started:
            raise RuntimeError("TensorStream is not started")
        flat, y, uv = self._consumer_buffers(name)
        for _ in range(4):
            index = self._lib.ts_pipeline_get(handle, name.encode(),
                                              int(delay), y.data_ptr(),
                                              uv.data_ptr())
            if index != _native.TS_RENEGOTIATE:
                break
            # Mid-stream resolution switch: adopt the new geometry and
            # retry with right-sized buffers.
            w = ctypes.c_int(0)
            h = ctypes.c_int(0)
            self._lib.ts_pipeline_ack_renegotiate(handle, name.encode(),
                                                  ctypes.byref(w),
                                                  ctypes.byref(h))
            self.frame_size = (self._lib.ts_pipeline_width(handle),
                               self._lib.ts_pipeline_height(handle))
            flat, y, uv = self._consumer_buffers(name, (w.value, h.value))
        if index == _native.TS_FINISHED:
            raise RuntimeError("Decoding finished")
        if index < 0:
            raise RuntimeError(f"TensorStream error: {index}")
        return flat, y.shape, index

    def read(self,
             name="default",
             width=0,
             height=0,
             resize_type=ResizeType.NEAREST,
             crop_coords=(0, 0, 0, 0),
             pixel_format=FourCC.RGB24,
             planes_pos=Planes.MERGED,
             normalization=None,
             delay=0,
             return_index=False,
             color_standard=ColorStandard.BT601,
             dtype=""):
        """Reads the next decoded frame as a tensor
        (reference: tensor_stream.py:248-273)."""
        frame_parameters = FrameParameters(
            width=width, height=height, crop_coords=crop_coords,
            resize_type=resize_type, pixel_format=pixel_format,
            planes_pos=planes_pos, normalization=normalization,
            color_standard=color_standard, dtype=dtype)
        return self.param_read(frame_parameters, name=name, delay=delay,
                               return_index=return_index)

    def param_read(self,
                   frame_parameters: FrameParameters,
                   name="default",
                   delay=0,
                   return_index=False):
        flat, (h, w), index = self._get_nv12(name, delay)
        # Source dims from the staging slot itself: after a mid-stream
        # resolution switch it carries this consumer's geometry.
        cfg = self._resolve_standard(frame_parameters.to_config(w, h))
        dev = ship(flat, self.device)
        tensor = build_vpp(cfg, self.device)(dev[:h * w].view(h, w),
                                             dev[h * w:].view(h // 2, w))
        self._mark_inflight(name)
        if self.enable_dumps:
            # Per-consumer processed-output tap (reference:
            # VideoProcessor.cpp:152-163); the first write after
            # initialize() truncates.
            mode = "ab" if name in self._dumped_consumers else "wb"
            self._dumped_consumers.add(name)
            with open(f"Processed_{name}.yuv", mode) as f:
                f.write(tensor_bytes(tensor))
        if return_index:
            return tensor, index
        return tensor

    def read_batch(self,
                   batch,
                   name="default",
                   host_resize=False,
                   **kwargs):
        """Reads `batch` *consecutive* frames (no-drop cursor semantics
        with producer back-pressure, unlike read()'s latest-frame
        contract) and converts them in one batched VPP, returning a
        leading-batch tensor (and the frame indices with
        return_index=True). Raises "Decoding finished" once the stream is
        drained.

        host_resize=True applies the requested resize (all four
        algorithms) on the host, bit-exactly (csrc/vpp_host.cpp), before
        the copy to the device, which then ships the resized bytes only."""
        handle = self._handle  # snapshot vs concurrent stop(), see _get_nv12
        if handle is None or self.frame_size is None:
            raise RuntimeError("TensorStream is not initialized")
        if not self._started:
            raise RuntimeError("TensorStream is not started")
        return_index = kwargs.pop("return_index", False)
        frame_parameters = FrameParameters(**kwargs)
        if host_resize:
            return self._read_batch_host_resized(
                batch, name, frame_parameters, return_index)
        # Source dims for THIS consumer's cursor (frame_size until a
        # mid-stream resolution switch).
        cw = ctypes.c_int(0)
        ch = ctypes.c_int(0)
        self._lib.ts_pipeline_consumer_dims(handle, name.encode(),
                                            ctypes.byref(cw), ctypes.byref(ch))
        w, h = cw.value, ch.value
        key = (name, int(batch))
        for _ in range(4):
            staging = self._batch_staging_slot(key, batch * h * w * 3 // 2)
            y_size = batch * h * w
            first = ctypes.c_int(0)
            got = self._lib.ts_pipeline_get_batch(
                handle, name.encode(), int(batch), staging.data_ptr(),
                staging.data_ptr() + y_size, ctypes.byref(first))
            if got != _native.TS_RENEGOTIATE:
                break
            # Geometry switch at the cursor: adopt it (the boundary batch
            # was already cut short).
            self._lib.ts_pipeline_ack_renegotiate(handle, name.encode(),
                                                  ctypes.byref(cw),
                                                  ctypes.byref(ch))
            w, h = cw.value, ch.value
        if got == _native.TS_RENEGOTIATE:
            raise RuntimeError(
                "stream geometry did not settle after renegotiation retries")
        if got <= 0:
            raise RuntimeError("Decoding finished")
        cfg = self._resolve_standard(frame_parameters.to_config(w, h))
        return self._convert_batch(key, staging, cfg, batch, got,
                                   first.value, return_index)

    def _read_batch_host_resized(self, batch, name, frame_parameters,
                                 return_index):
        fp = frame_parameters
        dst_w, dst_h = fp.width, fp.height
        algo = host_resize_algo(fp)
        key = (name, int(batch), dst_w, dst_h)
        staging = self._batch_staging_slot(key, batch * dst_w * dst_h * 3 // 2)
        y_size = batch * dst_w * dst_h
        first = ctypes.c_int(0)
        handle = self._handle  # snapshot vs concurrent stop()
        if handle is None:
            raise RuntimeError("TensorStream is not initialized")
        got = self._lib.ts_pipeline_get_batch_resized(
            handle, name.encode(), int(batch), dst_w, dst_h, algo,
            staging.data_ptr(), staging.data_ptr() + y_size,
            ctypes.byref(first))
        if got <= 0:
            raise RuntimeError("Decoding finished")
        # The frames arrive at target size: the device VPP sees them as
        # native-sized input with no resize stage.
        cfg = self._resolve_standard(FrameParameters(
            width=0, height=0, pixel_format=fp.pixel_format,
            planes_pos=fp.planes_pos,
            normalization=fp.normalization,
            color_standard=fp.color_standard,
            dtype=fp.dtype).to_config(dst_w, dst_h))
        return self._convert_batch(key, staging, cfg, batch, got,
                                   first.value, return_index)

    def _convert_batch(self, key, staging, cfg, batch, got, first,
                       return_index):
        tensors = build_vpp_batched_flat(cfg, int(batch), self.device)(
            ship(staging, self.device))
        self._batch_mark_inflight(key)
        if got < batch:
            # Partial final batch: the unfilled rows were converted from
            # stale staging bytes; slice them off.
            tensors = tensors[:got]
        if return_index:
            return tensors, list(range(first, first + got))
        return tensors

    def _batch_staging_slot(self, key, size):
        """Double-buffered flat staging per (consumer, batch) key: the
        native drain fills one buffer while the device may still read the
        other, which is reused only after its event."""
        st = self._batch_staging.get(key)
        if st is None or st["bufs"][0].numel() != size:
            st = {"bufs": [staging_buffer(size, self.device)
                           for _ in range(2)],
                  "events": [None, None], "slot": 0}
            self._batch_staging[key] = st
        slot = st["slot"]
        wait_event(st["events"][slot])
        st["events"][slot] = None
        return st["bufs"][slot]

    def _batch_mark_inflight(self, key):
        st = self._batch_staging.get(key)  # may vanish under stop()
        if st is None:
            return
        st["events"][st["slot"]] = record_event(self.device)
        st["slot"] = (st["slot"] + 1) % 2

    # ----------------------------------------------------------------- dump

    def dump(self,
             tensor,
             name="default",
             width=0,
             height=0,
             crop_coords=(0, 0, 0, 0),
             resize_type=ResizeType.NEAREST,
             pixel_format=FourCC.RGB24,
             planes_pos=Planes.MERGED,
             normalization=None):
        """Appends the raw tensor bytes to <name>.yuv, byte-identical to
        the reference's D2H dump (reference: WrapperPython.cpp:421-456 +
        VideoProcessor.cpp:28-72). Width/height are inferred from the
        tensor shape when not given."""
        shape = tuple(tensor.shape)
        channels = channels_by_fourcc(pixel_format)
        if not width:
            width = shape[1] if channels == 3 else shape[2]
        if not height:
            height = shape[0] if channels == 3 else int(shape[1] / channels)
        count = int(width * height * channels)
        flat = tensor.detach().reshape(-1)[:count]
        with open(f"{name}.yuv", "ab") as f:
            f.write(tensor_bytes(flat))
