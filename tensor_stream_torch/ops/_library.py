"""The ``ts`` operator library: each hand-written CUDA kernel of the port
as a dispatcher operator.

``define(schema, cuda, cpu, fake)`` registers ``ts::<name>`` with its CUDA
kernel (the wrapper that launches the hand-written kernel), its CPU
kernel (the plain torch version) and its fake implementation (the
outputs' shapes, dtypes and strides, which ``torch.export`` traces with).
The dispatcher picks the kernel from the inputs' device, so a traced
program holds the operator and not the choice. The operators are
registered with ``torch.library.Library`` directly: ``torch.library.
custom_op``'s Python wrappers cost an eager call about 10 µs more of host
time (on the CPU, against 3 µs here).

``recomputing()`` marks the launches made while a checkpointed block runs
again in the backward; each module that counts its launches reads
``in_recompute()``.
"""
import contextlib

import torch

_LIB = torch.library.Library("ts", "DEF")
_RECOMPUTING = False


def define(schema: str, cuda, cpu, fake):
    """Registers ``ts::<schema>`` (``name`` or ``name.overload``) and
    returns its OpOverload."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"ts::{name}", fake, lib=_LIB)
    op, _, overload = name.partition(".")
    return getattr(getattr(torch.ops.ts, op), overload or "default")


def on_one_device(*tensors, cuda: bool = False):
    """Raises unless the tensors lie all on one CUDA device or, unless
    ``cuda``, all on the CPU: the device rule of every operator's caller,
    checked before the dispatcher picks a kernel."""
    if not cuda and all(t.device.type == "cpu" for t in tensors):
        return
    device = tensors[0].device
    if device.type != "cuda" or any(t.device != device for t in tensors):
        raise ValueError(
            f"tensors on {[str(t.device) for t in tensors]}: the kernel "
            "needs them all on one CUDA device"
            + ("" if cuda else " (or all on the CPU)"))


@contextlib.contextmanager
def recomputing():
    """Marks the kernel launches inside it as a checkpoint's recompute
    (``models/video_vit.py`` enters it when a remat block runs again in the
    backward)."""
    global _RECOMPUTING
    outer, _RECOMPUTING = _RECOMPUTING, True
    try:
        yield
    finally:
        _RECOMPUTING = outer


def in_recompute() -> bool:
    """True inside ``recomputing()``."""
    return _RECOMPUTING
