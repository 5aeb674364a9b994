"""CRC-32/IEEE oracle identical to the reference tests' av_crc usage
(reference: tests/src/VPPTests.cpp:86-128: av_crc(AV_CRC_32_IEEE, -1, ...)),
computed by calling libavutil directly so the constant tables match."""
import ctypes
import ctypes.util

import numpy as np

_AV_CRC_32_IEEE = 3
_avutil = None
_table = None


def _load():
    global _avutil, _table
    if _avutil is None:
        lib = None
        for cand in ("libavutil.so.57", "libavutil.so",
                     ctypes.util.find_library("avutil")):
            if not cand:
                continue
            try:
                lib = ctypes.CDLL(cand)
            except OSError:
                continue
            break
        if lib is None:
            raise OSError("libavutil not found")
        lib.av_crc_get_table.restype = ctypes.c_void_p
        lib.av_crc_get_table.argtypes = [ctypes.c_int]
        lib.av_crc.restype = ctypes.c_uint32
        lib.av_crc.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                               ctypes.c_void_p, ctypes.c_size_t]
        _avutil, _table = lib, lib.av_crc_get_table(_AV_CRC_32_IEEE)
    return _avutil, _table


def av_crc32(data) -> int:
    """CRC-32/IEEE with init -1, no final xor: the reference oracle."""
    lib, table = _load()
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data)
        return lib.av_crc(table, 0xFFFFFFFF, buf.ctypes.data, buf.nbytes)
    raw = bytes(data)
    return lib.av_crc(table, 0xFFFFFFFF, raw, len(raw))
