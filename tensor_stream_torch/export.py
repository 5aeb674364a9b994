"""Serving-artifact export: inference functions to ``.pt2`` artifacts.

The port's counterpart of the JAX package's ``export.py``, which lowers a
jitted function to serialized StableHLO. Here ``torch.export`` traces the
function (the VPP program, a model forward) into an ``ExportedProgram``
whose weights travel inside it, and a serving process reloads it without
the model's Python code: only the artifact, the input tensors and
``import tensor_stream_torch``, which registers the ``ts::`` custom ops
that the artifact calls.

    export_inference(model, (clips,), "model.pt2", batch_poly=True)
    ...
    serve = load_inference("model.pt2")        # no model code needed
    logits = serve(clips_any_batch)

Where the JAX package lowers for ``platforms=("cpu", "tpu")``, one ``.pt2``
runs on both the CPU and the card: the hand-written kernels are custom ops
(``ts::nv12_to_rgb``, ``ts::flash_fwd``, ``ts::resize_*_nv12``) whose CUDA
kernels are the kernels and whose CPU kernels the plain versions, so the
dispatcher picks the kernel when the artifact runs on CUDA tensors, also
for an artifact traced on the CPU. ``load_inference`` moves the program's
weights and constants to the device it runs on.
"""
import io
import os
from typing import Any, Callable, Optional, Tuple

import torch
from torch.export.passes import move_to_device_pass

from ._device import resolve_device
from .ops import flash_attention, nv12_rgb, resize  # noqa: F401 (ts:: ops)


class _Function(torch.nn.Module):
    """A plain function as the module ``torch.export`` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_inference(fn: Callable, example_args: Tuple[Any, ...],
                     path: Optional[str] = None, *,
                     batch_poly: bool = False
                     ) -> torch.export.ExportedProgram:
    """Traces ``fn(*example_args)`` with ``torch.export`` under
    ``torch.no_grad()`` (an inference artifact) and returns the
    ``ExportedProgram``, also written to ``path`` if given.

    ``fn`` is an ``nn.Module`` or a function that closes over its weights
    (a module's parameters and buffers go into the artifact). With
    ``batch_poly=True`` the leading axis of every example argument is one
    shared symbolic dimension ``b``: the artifact then takes any batch
    size, as the JAX package's ``"b, ..."`` does."""
    module = fn if isinstance(fn, torch.nn.Module) else _Function(fn)
    dynamic = None
    if batch_poly:
        b = torch.export.Dim("b")
        dynamic = tuple({0: b} for _ in example_args)
        if isinstance(module, _Function):  # forward(*args): one tuple
            dynamic = (dynamic,)
    with torch.no_grad():
        program = torch.export.export(module, tuple(example_args),
                                      dynamic_shapes=dynamic)
    program.example_inputs = None  # the artifact holds no input data
    if path is not None:
        torch.export.save(program, path)
    return program


def load_inference(path_or_bytes, device=None, device_index: int = 0
                   ) -> Callable:
    """Reloads an artifact of ``export_inference`` (a path, the bytes of
    the file, or an ``ExportedProgram``) onto ``device`` (default
    ``cuda:<device_index>``; ``"cpu"`` when asked) and returns its
    module, its parameters frozen (``requires_grad`` off: an inference
    artifact). Inputs must lie on that device."""
    device = resolve_device(device, device_index)
    if isinstance(path_or_bytes, torch.export.ExportedProgram):
        program = path_or_bytes
    elif isinstance(path_or_bytes, (bytes, bytearray)):
        program = torch.export.load(io.BytesIO(bytes(path_or_bytes)))
    else:
        program = torch.export.load(os.fspath(path_or_bytes))
    module = move_to_device_pass(program, str(device)).module()
    for p in module.parameters():
        p.requires_grad_(False)
    return module
