"""StreamInferencer: continuous batched inference over many streams.

Port of the JAX package's ``serving.py``. N streams decode into a single
``[N*per_stream, ...]`` batch a tick; one model call serves every stream
at once, and the results demux back to per-stream slices with their frame
indices.

Dispatch stays asynchronous: ``infer_fn`` enqueues its kernels on the
current CUDA stream and returns, a CUDA event is recorded behind them,
and the loop only waits on that event when it drains the batch, up to
``inflight`` ticks later. Host decode of the next tick overlaps device
compute of this one. ``infer_fn`` (and, for "fused", the loader's
dispatch) runs under ``torch.no_grad()``.

The JAX package serves a jitted ``infer_fn``; here the counterpart is an
``infer_fn`` wrapped in ``graphs.cuda_graph``, which the engine runs as
it runs any other. ``pipeline="fused"`` graphs the VPP and ``infer_fn``
together on its own.

    from tensor_stream_torch.graphs import cuda_graph
    from tensor_stream_torch.serving import StreamInferencer
    eng = StreamInferencer(["cam0.mp4", "cam1.mp4"], cuda_graph(serve_fn),
                           per_stream=16, width=224, height=224,
                           pixel_format=FourCC.RGB24,
                           planes_pos=Planes.MERGED, normalization=True,
                           host_resize=True)
    for r in eng.stream(max_batches=100):
        push(r.stream, r.frames, r.outputs)   # per-stream slice
    eng.close()
"""
import time
from collections import deque, namedtuple
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from ._device import record_event, wait_event
from .data import MultiStreamLoader, PooledStreamLoader
from .graphs import leaves as _leaves
from .graphs import tree_map as _map

StreamResult = namedtuple("StreamResult", ("stream", "frames", "outputs"))
StreamResult.__doc__ = """One stream's slice of a served batch.

stream:  index into the engine's stream_urls
frames:  frame indices (this stream's clock) of the rows
outputs: the model outputs for those rows (leading axis = frames)
"""


def _identity(outputs):
    return outputs


class StreamInferencer:
    """Batched many-stream inference with per-stream demux + stats."""

    def __init__(self, stream_urls: Sequence[str], infer_fn: Callable,
                 per_stream: int = 8, loader: Optional[Any] = None,
                 carry: Any = None, on_end: str = "stop",
                 pipeline: str = "per-stream", **loader_kwargs):
        """``infer_fn(batch) -> outputs`` keeps the leading batch axis
        (a tensor, or dicts/lists/tuples of tensors with that axis). Pass
        a prebuilt MultiStreamLoader via ``loader``, or let the engine
        build one from ``stream_urls`` and ``loader_kwargs``.

        Stateful models: pass the initial state as ``carry``; ``infer_fn``
        is then ``infer_fn(carry, batch) -> (carry, outputs)`` with batch
        ``[n_streams, per_stream, ...]`` (stacked per stream). A tick where
        a stream delivers fewer than ``per_stream`` frames ends that
        stream; the partial chunk is discarded.

        ``on_end``: "stop" ends service when any stream ends; "drop"
        evicts exhausted streams (and their carry rows) and serves the
        rest with a smaller batch.

        ``pipeline`` picks the decode and dispatch topology:
          "per-stream" (default): one MultiStreamLoader, a native
            producer and a VPP dispatch per stream a tick; supports
            on_end="drop" and a carry.
          "pooled": one PooledStreamLoader, the streams on one native
            worker pool and one flat staging buffer: one copy and one VPP
            dispatch a tick.
          "fused": pooled, with ``infer_fn`` run inside the loader's
            dispatch (on CUDA the VPP and ``infer_fn`` are one CUDA
            graph): one dispatch a tick; ``infer_fn`` must be stateless
            and must not wait for the device.
        Pooled and fused engines own their loader (pass no ``loader``),
        are stateless and end service when any stream drains."""
        if on_end not in ("stop", "drop"):
            raise ValueError(f"on_end must be 'stop' or 'drop': {on_end}")
        if on_end == "drop" and loader is not None:
            raise ValueError("on_end='drop' needs engine-owned loaders "
                             "(omit the loader argument)")
        if pipeline not in ("per-stream", "pooled", "fused"):
            raise ValueError("pipeline must be 'per-stream', 'pooled' "
                             f"or 'fused': {pipeline!r}")
        if pipeline != "per-stream":
            if loader is not None or carry is not None or on_end != "stop":
                raise ValueError(
                    f"pipeline={pipeline!r} builds its own pooled "
                    "loader and is stateless: omit loader/carry and "
                    "keep on_end='stop'")
        self.pipeline = pipeline
        self.infer_fn = infer_fn
        self.carry = carry
        self._stateful = carry is not None
        self.per_stream = per_stream
        self.on_end = on_end
        self._own_loader = loader is None
        if loader is not None:
            self.loader = loader
        elif pipeline == "per-stream":
            self.loader = MultiStreamLoader(
                stream_urls, per_stream=per_stream, **loader_kwargs)
        else:
            self.loader = PooledStreamLoader(
                stream_urls, per_stream=per_stream,
                post_fn=infer_fn if pipeline == "fused" else None,
                **loader_kwargs)
            if pipeline == "fused":
                # The loader's dispatch already gave the model's outputs.
                self.infer_fn = _identity
        self._n_streams = len(stream_urls)
        self._frames = [0] * self._n_streams
        self._batches = 0
        self._lat_ms = []
        self._t0 = None
        # on_end="drop": alive (stream_id, loader) pairs, sid-sorted;
        # position in this list == row in the stateful carry.
        self._alive = list(enumerate(self.loader.loaders)) \
            if on_end == "drop" else None

    # -------------------------------------------------------------- core

    def stream(self, max_batches: Optional[int] = None, inflight: int = 1):
        """Generator of StreamResult, one per stream per batch, in stream
        order. Up to ``inflight`` model calls stay enqueued before the
        oldest batch's results are awaited (1 = double buffering)."""
        if inflight < 1:
            raise ValueError(f"inflight must be >= 1: {inflight}")
        pending = deque()  # (outputs, indices, event), oldest first
        fetched = 0
        self._t0 = self._t0 or time.perf_counter()
        it = None if self.on_end == "drop" else iter(self.loader)
        while max_batches is None or fetched < max_batches:
            try:
                batch, indices = (self._next_dropping()
                                  if self.on_end == "drop"
                                  else self._next_stop(it))
            except StopIteration:
                break
            fetched += 1
            with torch.no_grad():
                if self._stateful:
                    self.carry, out = self.infer_fn(self.carry, batch)
                else:
                    out = self.infer_fn(batch)
            event = record_event(_leaves(batch)[0].device)
            pending.append((out, indices, event))
            if len(pending) > inflight:
                yield from self._drain(pending.popleft())
        while pending:
            yield from self._drain(pending.popleft())

    def _next_stop(self, it):
        """Stop mode: the loader's flat batch; stateful models get it
        re-stacked to [n_streams, per_stream, ...], and the first ragged
        tick (a partial tail chunk) ends service."""
        batch, indices = next(it)
        if not self._stateful:
            return batch, indices
        if any(len(v) != self.per_stream for v in indices.values()):
            raise StopIteration
        return (batch.reshape((len(indices), self.per_stream)
                              + tuple(batch.shape[1:])), indices)

    def _next_dropping(self):
        """One tick's batch from the alive streams; exhausted streams are
        evicted (their carry row too, before the tick's dispatch, so batch
        rows and carry rows agree). StopIteration when none survive."""
        parts, indices = [], {}
        evicted = 0
        for row, (sid, ld) in enumerate(list(self._alive)):
            try:
                tensors, idx = next(ld)
                if self._stateful and len(idx) != self.per_stream:
                    raise StopIteration  # discard the partial tail
            except StopIteration:
                self._evict(row - evicted, sid, ld)
                evicted += 1
                continue
            parts.append(tensors)
            indices[sid] = idx
        if not parts:
            raise StopIteration
        if self._stateful:
            return torch.stack(parts, dim=0), indices
        return torch.cat(parts, dim=0), indices

    def _evict(self, row, sid, loader):
        """Removes a finished stream: loader closed, carry row sliced out
        (stateful engines), alive list updated."""
        self._alive = [(s, l) for s, l in self._alive if s != sid]
        loader.close()
        if self._stateful and self.carry is not None:
            self.carry = _map(lambda x: torch.cat([x[:row], x[row + 1:]]),
                              self.carry)

    def _drain(self, item):
        outputs, indices, event = item
        t0 = time.perf_counter()
        wait_event(event)
        # Residual device wait after the overlapped host work.
        self._lat_ms.append((time.perf_counter() - t0) * 1e3)
        self._batches += 1
        # Stateless models emit one row per frame; stateful temporal (or
        # clip) models emit one row per stream per tick.
        total = sum(len(v) for v in indices.values())
        lead = _leaves(outputs)[0].shape[0]
        per_stream_rows = lead == len(indices) and lead != total
        row = 0
        for k, stream in enumerate(sorted(indices)):
            frames = indices[stream]
            n = 1 if per_stream_rows else len(frames)
            start = k if per_stream_rows else row
            sl = _map(lambda o: o[start:start + n], outputs)
            self._frames[stream] += len(frames)
            row += n
            yield StreamResult(stream, frames, sl)

    def run(self, callback: Callable[[StreamResult], None],
            max_batches: Optional[int] = None, inflight: int = 1):
        """Drives stream() to completion, invoking callback per result."""
        for r in self.stream(max_batches, inflight=inflight):
            callback(r)

    # ------------------------------------------------------------- stats

    def stats(self) -> dict:
        """Counters: batches, per-stream frames, result-wait latency
        percentiles (ms: the residual device wait after the overlapped
        host work), aggregate frames/s since the first dispatch."""
        lat = np.asarray(self._lat_ms, np.float64)
        total = int(sum(self._frames))
        dt = (time.perf_counter() - self._t0) if self._t0 else 0.0
        return {
            "batches": self._batches,
            "frames": dict(enumerate(self._frames)),
            "total_frames": total,
            "latency_ms": {
                "p50": float(np.percentile(lat, 50)) if lat.size else None,
                "p95": float(np.percentile(lat, 95)) if lat.size else None,
            },
            "fps": (total / dt) if dt > 0 else 0.0,
        }

    def close(self):
        if self._own_loader:
            self.loader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
