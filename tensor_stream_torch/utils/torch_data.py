"""torch.utils.data adapter: the port's loaders as an IterableDataset.

The port of the JAX package's ``utils/torch_data.py``. Any loader of the
port (FrameLoader, ClipLoader, ClipDataset, the multi-stream family)
becomes a ``torch.utils.data.IterableDataset`` whose items are
``(torch.Tensor, indices)``, so a torch training loop keeps its
``DataLoader``:

    ds = TorchFrameDataset(lambda: ClipLoader("video.mp4", clip_len=8,
                                              batch=4, width=224,
                                              height=224))
    dl = torch.utils.data.DataLoader(ds, batch_size=None, num_workers=0)
    for clips, starts in dl:          # torch.Tensor [4, 8, 224, 224, 3]
        out = model(clips)

``batch_size=None`` passes the loader's batches through (they are already
batched); ``num_workers`` must stay 0: decode parallelism lives in the
native workers, and a forked worker would duplicate the stream, not
shard it.
"""
from typing import Callable

import torch.utils.data as tud

from .torch_interop import to_torch


class TorchFrameDataset(tud.IterableDataset):
    """IterableDataset over a loader factory (a fresh loader an epoch)."""

    def __init__(self, make_loader: Callable, copy: bool = False):
        """``make_loader()`` returns a fresh loader each call (a new epoch
        re-opens the stream); ``copy=True`` gives each item storage of its
        own (``to_torch``)."""
        self.make_loader = make_loader
        self.copy = copy

    def __iter__(self):
        # get_worker_info() is not None only inside a DataLoader worker
        # process: num_workers >= 1 forked this process.
        if tud.get_worker_info() is not None:
            raise RuntimeError(
                "TorchFrameDataset requires num_workers=0: decode "
                "parallelism lives in the native workers; forked "
                "DataLoader workers would duplicate the stream")
        loader = self.make_loader()
        try:
            for tensors, indices in loader:
                yield to_torch(tensors, copy=self.copy), indices
        finally:
            loader.close()
