"""tensor-stream for PyTorch and CUDA: video streams to CUDA tensors.

The port of the JAX package (tensor-stream-tpu) to PyTorch on an NVIDIA
H100. H.264 files and streams are demuxed and decoded on the host by the
same native runtime (csrc/, libtsingest.so over ctypes), kept in an NV12 ring, and
converted on the card (crop -> NV12-domain resize -> colour conversion ->
normalization -> planar/merged layout) into ``torch.Tensor``s on
``cuda:N``. NV12->RGB runs in a hand-written CUDA kernel
(csrc/nv12_rgb.cu), and so do the BILINEAR, BICUBIC and AREA resizes
(csrc/resize_nv12.cu). ``ClipLoader`` and ``ClipDataset`` sample
shuffled clips for training, with on-card augmentation (``AugmentConfig``)
and batch mixes (``mixup``, ``cutmix``, ``mix_labels``); their sharded
forms (``ShardedClipLoader``, ``ShardedClipDataset``,
``ShardedStreamLoader``) hand each rank of a mesh its share of a DTensor
batch, and ``parallel`` holds the meshes, the pipeline and the sharded
steps. ``StreamInferencer`` serves many streams through one
model call a tick; ``models.VideoViT`` is the video transformer it serves
and trains, whose attention runs hand-written CUDA flash-attention kernels
(csrc/flash_fwd.cu, csrc/flash_bwd.cu). ``cuda_graph`` replays a tick or a
training step as one CUDA graph, where the JAX package jits it.
``TrainCheckpointer`` saves and resumes a train state with the loader's
cursor, ``export_inference`` and ``load_inference`` make and reload a
``.pt2`` serving artifact (the kernels are ``ts::`` custom ops, so an
artifact calls them on the card), and ``VideoWriter`` encodes frames.

    from tensor_stream_torch import TensorStreamConverter, FourCC, Planes

Entry points take ``device=None``, meaning ``cuda:<index>``; they raise
when no CUDA device is present unless ``device="cpu"`` is passed.
This package imports nothing of JAX or of the JAX package.
"""
from .checkpoint import TrainCheckpointer
from .data import (ClipDataset, ClipLoader, FrameLoader, MultiStreamLoader,
                   PooledStreamLoader, ShardedClipDataset, ShardedClipLoader,
                   ShardedStreamLoader)
from .enums import (ColorStandard, FourCC, FrameRate, LogsLevel, LogsType,
                    Planes, ResizeType, StatusLevel, channels_by_fourcc)
from .export import export_inference, load_inference
from .graphs import cuda_graph
from .ops.augment import AugmentConfig
from .ops.mix import cutmix, mix_labels, mixup
from .ops.vpp import VPPConfig
from .serving import StreamInferencer, StreamResult
from .tensor_stream import FrameParameters, TensorStreamConverter
from .video_writer import VideoWriter

__version__ = "0.1.0"

__all__ = [
    "TensorStreamConverter", "FrameParameters", "FrameLoader", "VideoWriter",
    "ClipLoader", "ClipDataset", "MultiStreamLoader", "PooledStreamLoader",
    "ShardedClipLoader", "ShardedClipDataset", "ShardedStreamLoader",
    "StreamInferencer", "StreamResult", "VPPConfig", "cuda_graph",
    "AugmentConfig", "mixup", "cutmix", "mix_labels", "TrainCheckpointer",
    "export_inference", "load_inference",
    "StatusLevel", "LogsLevel", "LogsType", "FourCC", "ResizeType", "Planes",
    "FrameRate", "ColorStandard", "channels_by_fourcc",
]
