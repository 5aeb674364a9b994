"""ctypes bindings to libtsingest.so, the native ingest runtime in csrc/.

The port calls the same C ABI as the JAX package (demux, software decode,
NV12 ring, host resize, host VPP); this module keeps its own signatures so
that nothing of the JAX package is imported. ctypes releases the GIL for
every call, so the native producer and a Python drain thread overlap.
"""
import ctypes
import fcntl
import os
import subprocess
import threading

_LIB = None
_LIB_LOCK = threading.Lock()

# Status codes (csrc/ts_common.h).
TS_OK = 0
TS_REPEAT = -1
TS_UNSUPPORTED = -2
TS_ERROR = -3
TS_EOF = -4
TS_FINISHED = -5
TS_TIMEOUT = -6
# Mid-stream geometry switch: re-query dims via ts_pipeline_ack_renegotiate
# and resize consumer buffers before retrying the read.
TS_RENEGOTIATE = -8


class NativeBuildError(RuntimeError):
    """`make -C csrc` failed: the machine lacks what libtsingest.so needs
    (a C++20 compiler and FFmpeg's development libraries)."""


def lib_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")


def lib_path() -> str:
    return os.path.join(lib_dir(), "libtsingest.so")


def _fresh(path: str) -> bool:
    """True when `path` exists and is newer than every source of csrc/
    (the same test as the JAX package's loader, which then skips make)."""
    if not os.path.exists(path):
        return False
    lib_mtime = os.path.getmtime(path)
    return all(os.path.getmtime(os.path.join(lib_dir(), f)) <= lib_mtime
               for f in os.listdir(lib_dir()) if f.endswith((".cpp", ".h")))


def build() -> None:
    """Builds csrc/libtsingest.so if it is missing or stale.

    Processes that load the library at once (test workers) build it once:
    the build holds a file lock and checks freshness again under it. The
    library is linked under a temporary name and renamed into place, so a
    process that has already mapped the old file never sees it rewritten."""
    path = lib_path()
    if _fresh(path):
        return
    lock_dir = os.path.join(os.path.dirname(lib_dir()), "build")
    os.makedirs(lock_dir, exist_ok=True)
    with open(os.path.join(lock_dir, "libtsingest.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if _fresh(path):
            return
        tmp = f"libtsingest.so.tmp{os.getpid()}"
        proc = subprocess.run(["make", "-C", lib_dir(), f"TARGET={tmp}"],
                              capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(os.path.join(lib_dir(), tmp), path)
            return
        if os.path.exists(os.path.join(lib_dir(), tmp)):
            os.remove(os.path.join(lib_dir(), tmp))
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-6:]
    raise NativeBuildError("make -C csrc failed: " + " | ".join(tail))


def load():
    """Loads (building if stale) and configures the native library."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        build()
        lib = ctypes.CDLL(lib_path())

        c_void_p, c_char_p, c_int = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int
        c_int_p = ctypes.POINTER(ctypes.c_int)

        def sig(name, restype, argtypes):
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes

        sig("ts_pipeline_create", c_void_p, [])
        sig("ts_pipeline_init", c_int,
            [c_void_p, c_char_p, c_int, c_int, c_int, c_int, c_int])
        sig("ts_pipeline_init_ex2", c_int,
            [c_void_p, c_char_p, c_int, c_int, c_int, c_int, c_int, c_int,
             c_int, c_int, c_int, c_int])
        sig("ts_pipeline_seek_frame", c_int, [c_void_p, ctypes.c_longlong])
        sig("ts_pipeline_set_format_option", None,
            [c_void_p, c_char_p, c_char_p])
        sig("ts_pipeline_start", c_int, [c_void_p])
        sig("ts_pipeline_step", c_int, [c_void_p])
        sig("ts_pipeline_get", c_int,
            [c_void_p, c_char_p, c_int, c_void_p, c_void_p])
        sig("ts_pipeline_get_batch", c_int,
            [c_void_p, c_char_p, c_int, c_void_p, c_void_p, c_int_p])
        sig("ts_pipeline_register_cursor", None, [c_void_p, c_char_p])
        sig("ts_pipeline_get_batch_resized", c_int,
            [c_void_p, c_char_p, c_int, c_int, c_int, c_int, c_void_p,
             c_void_p, c_int_p])
        sig("ts_pipeline_ack_renegotiate", c_int,
            [c_void_p, c_char_p, c_int_p, c_int_p])
        sig("ts_pipeline_consumer_dims", None,
            [c_void_p, c_char_p, c_int_p, c_int_p])
        sig("ts_pipeline_detected_standard", c_int, [c_void_p])
        sig("ts_pipeline_stop", None, [c_void_p])
        sig("ts_pipeline_destroy", None, [c_void_p])
        for name in ("width", "height", "fps_num", "fps_den", "frame_index",
                     "analyze_errors", "reconnect_count"):
            sig(f"ts_pipeline_{name}", c_int, [c_void_p])
        sig("ts_pipeline_skip_analyze", None, [c_void_p])
        sig("ts_pipeline_enable_logs", None, [c_void_p, c_int])
        sig("ts_pipeline_enable_trace", None, [c_void_p])
        sig("ts_set_timeout_ms", None, [c_int])
        sig("ts_get_timeout_ms", c_int, [])
        # GOP/segment-parallel reader (seekable files; csrc/segment_reader.h)
        sig("ts_segmented_create", c_void_p,
            [c_char_p, c_int, c_int, c_int, c_int, c_int, c_int, c_int,
             c_int, c_int])
        sig("ts_segmented_start", c_int, [c_void_p])
        sig("ts_segmented_get_batch", c_int,
            [c_void_p, c_int, c_void_p, c_void_p, c_int_p])
        for name in ("width", "height", "out_width", "out_height"):
            sig(f"ts_segmented_{name}", c_int, [c_void_p])
        sig("ts_segmented_seek_frame", None, [c_void_p, ctypes.c_longlong])
        sig("ts_segmented_stop", None, [c_void_p])
        sig("ts_segmented_destroy", None, [c_void_p])
        # Shared worker pool, many streams (csrc/stream_pool.cpp); each
        # stream's handle is a pipeline for the ts_pipeline_* calls.
        sig("ts_pool_create", c_void_p, [c_int])
        sig("ts_pool_add_stream", c_int,
            [c_void_p, c_char_p, c_int, c_int, c_int])
        sig("ts_pool_start", c_int, [c_void_p])
        sig("ts_pool_stream", c_void_p, [c_void_p, c_int])
        sig("ts_pool_stop", None, [c_void_p])
        sig("ts_pool_destroy", None, [c_void_p])
        # Random-access clip reader (seekable files; csrc/clip_reader.h).
        c_ll = ctypes.c_longlong
        sig("ts_clip_create", c_void_p,
            [c_char_p, c_int, c_int, c_int, c_int, c_int, c_int])
        sig("ts_clip_get_batch", c_int,
            [c_void_p, ctypes.POINTER(c_ll), c_int, c_int, c_int, c_void_p,
             c_void_p])
        for name in ("width", "height", "out_width", "out_height",
                     "segments"):
            sig(f"ts_clip_{name}", c_int, [c_void_p])
        sig("ts_clip_total_frames", c_ll, [c_void_p])
        sig("ts_clip_segment_table", c_int,
            [c_void_p, ctypes.POINTER(c_ll), c_int])
        sig("ts_clip_frames_decoded", c_ll, [c_void_p])
        sig("ts_clip_release_decoders", None, [c_void_p])
        sig("ts_clip_destroy", None, [c_void_p])
        # Host VPP (csrc/vpp_convert.cpp): the source-order reference the
        # tests hold the plain torch colour math to.
        sig("ts_vpp_convert_host", c_int,
            [c_void_p, c_void_p, c_int, c_int, c_int, c_int, c_int, c_int,
             c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_void_p])
        sig("ts_vpp_output_elements", ctypes.c_longlong, [c_int, c_int, c_int])
        sig("ts_vpp_is_float", c_int, [c_int, c_int])
        sig("ts_vpp_output_size", None,
            [c_int, c_int, c_int, c_int, c_int, c_int, c_int, c_int,
             c_int_p, c_int_p])
        # In-process encoder (csrc/video_writer.cpp).
        sig("ts_writer_create", c_void_p,
            [c_char_p, c_int, c_int, c_int, c_int, c_char_p, c_int])
        sig("ts_writer_write_rgb", c_int, [c_void_p, c_void_p])
        sig("ts_writer_write_nv12", c_int, [c_void_p, c_void_p, c_void_p])
        sig("ts_writer_frames", c_ll, [c_void_p])
        sig("ts_writer_close", c_int, [c_void_p])
        sig("ts_writer_destroy", None, [c_void_p])

        _LIB = lib
        return _LIB
