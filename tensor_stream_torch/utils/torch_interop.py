"""Anything array-like -> torch.Tensor.

The port of the JAX package's ``utils/torch_interop.py``, whose
``to_torch`` bridges a ``jax.Array`` to torch. The port's loaders already
return ``torch.Tensor``s, so here it is an identity for them, and it
wraps what other code hands over:

    from tensor_stream_torch.utils.torch_interop import to_torch
    batch = to_torch(tensors)        # the same tensor
    batch = to_torch(numpy_frames)   # zero-copy over the array

A numpy array goes through ``torch.from_numpy`` and anything with
``__dlpack__`` (a CuPy or JAX array, say) through DLPack, both zero-copy:
the result aliases the producer's buffer, so pass ``copy=True`` before
mutating it in place.
"""
import numpy as np
import torch


def to_torch(x, copy: bool = False) -> torch.Tensor:
    """``x`` as a ``torch.Tensor``: a tensor as it is (cloned with
    ``copy=True``), a numpy array through ``torch.from_numpy`` (a
    read-only array is copied, since torch tensors are writable), and
    anything with ``__dlpack__`` through DLPack."""
    if isinstance(x, torch.Tensor):
        return x.clone() if copy else x
    if isinstance(x, np.ndarray):
        if copy or not x.flags.writeable:
            x = np.array(x)
        return torch.from_numpy(x)
    if hasattr(x, "__dlpack__"):
        t = torch.utils.dlpack.from_dlpack(x)
        return t.clone() if copy else t
    raise TypeError(f"cannot convert {type(x).__name__} to a torch.Tensor: "
                    "expected a tensor, a numpy array or a DLPack producer")
