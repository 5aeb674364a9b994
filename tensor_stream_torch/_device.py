"""Device selection and host staging shared by the entry points.

Every entry point takes ``device=None``, which means ``cuda:<index>``.
Without a CUDA device that raises: the port never drops to the CPU on
its own. ``device="cpu"`` runs the plain torch versions of every op on
the CPU (the tests do this).

Staging is pinned host memory on CUDA, so the native drain writes
straight into it and one ``non_blocking`` copy ships it; a staging slot
is reused only after the event recorded behind the work that read it.
"""
import contextlib

import torch


def resolve_device(device=None, index=0) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain torch path on the CPU")
        return torch.device("cuda", int(index or 0))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{dev} requested but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def staging_buffer(nbytes: int, device: torch.device) -> torch.Tensor:
    """Flat uint8 host buffer; pinned when it feeds a CUDA device."""
    return torch.empty(int(nbytes), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")


def ship(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """One copy of a staging buffer to `device`, asynchronous from pinned
    memory. Always a copy, also on the CPU, so that no output can alias a
    staging buffer that is about to be refilled."""
    out = torch.empty(host.shape, dtype=host.dtype, device=device)
    out.copy_(host, non_blocking=True)
    return out


def record_event(device: torch.device):
    """Event behind all work queued so far on the device's current stream
    (None on the CPU, where the work has already run)."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    return event


def wait_event(event) -> None:
    if event is not None:
        event.synchronize()


@contextlib.contextmanager
def kernel_device(device: torch.device):
    """The guard around a call into a kernel library (``_build.load``):
    `device` current, and its context bound to the calling thread through
    torch's CUDA runtime. The libraries link the CUDA runtime statically;
    on a thread whose first CUDA call was theirs, after a CUDA graph had
    been captured anywhere in the process, every launch failed with
    cudaErrorInvalidValue (an autograd worker thread's first backward,
    on an H100 with torch 2.11); ``torch.cuda.set_device`` binds the
    context first. The guard calls the C entry points behind
    ``torch.cuda.device`` and ``set_device`` directly (their Python
    argument handling was most of an eager call's guard: 8.5 µs on an
    H100's host, ``chip_smoke.fusion_host_split``) and puts the previous
    device back on exit."""
    index = device.index
    prev = torch._C._cuda_getDevice()
    torch._C._cuda_setDevice(index)
    try:
        yield
    finally:
        if prev != index:
            torch._C._cuda_setDevice(prev)


def stream_handle(device: torch.device) -> int:
    """The cudaStream_t of `device`'s current stream, as an int (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building the Stream object)."""
    return torch._C._cuda_getCurrentRawStream(device.index)
