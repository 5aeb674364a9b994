"""The port's torch adapters on the CPU: ``utils/torch_interop.to_torch``
(a tensor as it is, numpy and DLPack producers, ``copy``) and
``utils/torch_data.TorchFrameDataset`` (items as the loader's, epochs
through a DataLoader, ``copy=True``, the ``num_workers`` refusal), beside
the JAX package's ``to_torch`` on the same inputs."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.data as tud

from tensor_stream_tpu.utils.torch_interop import to_torch as jax_to_torch
from tensor_stream_torch import FourCC, FrameLoader, Planes
from tensor_stream_torch.utils import torch_data
from tensor_stream_torch.utils.torch_data import TorchFrameDataset
from tensor_stream_torch.utils.torch_interop import to_torch

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "bbb_720x480_RGB24_250.h264")
KW = dict(batch=3, width=64, height=48, pixel_format=FourCC.RGB24,
          planes_pos=Planes.MERGED, host_resize=True, device="cpu")


def make_loader():
    return FrameLoader(FIXTURE, **KW)


def test_tensor_is_returned_as_it_is():
    t = torch.arange(6.0)
    assert to_torch(t) is t
    c = to_torch(t, copy=True)
    assert torch.equal(c, t) and c.data_ptr() != t.data_ptr()


def test_numpy_is_wrapped_without_a_copy():
    a = np.arange(6, dtype=np.float32)
    t = to_torch(a)
    t[0] = 7
    assert a[0] == 7  # aliases the array, as the JAX package's host path
    b = to_torch(a, copy=True)
    b[1] = 9
    assert a[1] == 1
    ro = np.arange(4, dtype=np.int64)
    ro.flags.writeable = False
    assert torch.equal(to_torch(ro), torch.arange(4))  # copied: writable


def test_dlpack_producer_matches_jax_to_torch():
    """A jax.Array (a DLPack producer) converts to the tensor the JAX
    package's to_torch gives."""
    x = jnp.arange(12, dtype=jnp.float32).reshape(3, 4) * 0.5
    got, want = to_torch(x), jax_to_torch(x)
    assert torch.equal(got, want)
    assert torch.equal(to_torch(x, copy=True), want)


def test_unknown_input_raises():
    with pytest.raises(TypeError, match="cannot convert"):
        to_torch([1, 2, 3])


def test_items_match_the_loader():
    with make_loader() as direct:
        want = [(idx, t.clone()) for t, idx in
                (next(direct) for _ in range(2))]
    it = iter(TorchFrameDataset(make_loader))
    for want_idx, want_t in want:
        t, idx = next(it)
        assert isinstance(t, torch.Tensor)
        assert list(idx) == list(want_idx)
        assert torch.equal(t, want_t)
    it.close()


def test_dataloader_passthrough_and_epochs():
    dl = tud.DataLoader(TorchFrameDataset(make_loader), batch_size=None,
                        num_workers=0)

    def first_two():
        out = []
        for t, idx in dl:
            out.append((list(idx), t.clone()))
            if len(out) == 2:
                break
        return out
    a, b = first_two(), first_two()  # each epoch re-opens the stream
    assert [i for i, _ in a] == [i for i, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert torch.equal(x, y)
    assert a[0][1].shape == (3, 48, 64, 3) and a[0][1].dtype == torch.uint8


def test_copy_gives_items_their_own_storage():
    seen = []

    class Loader:
        def __init__(self):
            self.t = torch.zeros(2)

        def __iter__(self):
            seen.append(self.t)
            yield self.t, [0]

        def close(self):
            pass
    t, _ = next(iter(TorchFrameDataset(Loader, copy=True)))
    t.add_(1)
    assert torch.equal(seen[0], torch.zeros(2))
    t, _ = next(iter(TorchFrameDataset(Loader)))
    assert t is seen[1]


def test_refuses_dataloader_workers(monkeypatch):
    """Inside a DataLoader worker (get_worker_info() is set) it raises
    before it opens a loader."""
    opened = []
    monkeypatch.setattr(torch_data.tud, "get_worker_info",
                        lambda: object())
    with pytest.raises(RuntimeError, match="num_workers=0"):
        next(iter(TorchFrameDataset(lambda: opened.append(1))))
    assert not opened
