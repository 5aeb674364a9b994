"""Public enums of the tensor-stream PyTorch API.

A copy of the JAX package's ``enums.py`` (itself the reference's enum
surface, reference: tensor_stream/tensor_stream.py:15-97): the values are
the same, so a config written for either package means the same thing in
the other. Kept as a copy because this package imports nothing of the
JAX package.
"""
from enum import Enum


class StatusLevel(Enum):
    """Error statuses returned from the native extension."""
    OK = 0
    REPEAT = 1
    ERROR = 2


class LogsLevel(Enum):
    """Logging verbosity (reference: tensor_stream.py:26-34)."""
    NONE = 0
    LOW = 1        # indexes of processed frames
    MEDIUM = 2     # + frame processing duration
    HIGH = 3       # + detailed per-block callstack timing


class LogsType(Enum):
    """Where logs are written (reference: tensor_stream.py:39-43)."""
    FILE = 1
    CONSOLE = 2


class FourCC(Enum):
    """Supported output pixel formats (reference: tensor_stream.py:48-62)."""
    Y800 = 0
    RGB24 = 1
    BGR24 = 2
    NV12 = 3
    UYVY = 4
    YUV444 = 5
    HSV = 6


class ResizeType(Enum):
    """Resize algorithms, applied in the NV12 domain
    (reference: tensor_stream.py:67-75)."""
    NEAREST = 0
    BILINEAR = 1
    BICUBIC = 2
    AREA = 3


class Planes(Enum):
    """RGB memory layout (reference: tensor_stream.py:79-83)."""
    PLANAR = 0
    MERGED = 1


class ColorStandard(Enum):
    """YUV->RGB matrix selection. BT601 is the reference's limited-range
    matrix and the default; the full-range variants map Y 0..255
    directly and drop the 255/224 chroma excursion scale."""
    BT601 = 0
    BT709 = 1
    BT601_FULL = 2
    BT709_FULL = 3
    # Resolve from the stream's VUI colorimetry metadata; unspecified
    # streams fall back to BT.601 limited.
    AUTO = -1


class FrameRate(Enum):
    """Stream reading/pacing modes (reference: tensor_stream.py:87-97)."""
    NATIVE = 0
    NATIVE_SIMPLE = 1
    NATIVE_LOW_DELAY = 2
    FAST = 3
    BLOCKING = 4


def channels_by_fourcc(fourcc: FourCC) -> float:
    """Output channel count per pixel (reference: src/VideoProcessor.cpp:4-26)."""
    if fourcc == FourCC.Y800:
        return 1.0
    if fourcc == FourCC.UYVY:
        return 2.0
    if fourcc == FourCC.NV12:
        return 1.5
    return 3.0
