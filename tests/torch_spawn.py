"""Runs a function on N gloo ranks on the CPU, for the port's mesh tests.

``start(fn, world, tmp_path, *args).results()`` (or ``spawn``, which
does both) starts `world` processes
(``torch.multiprocessing``), each with a gloo process group initialized
through a file store in `tmp_path` (no TCP port, so parallel test
workers cannot collide), calls ``fn(rank, world, *args)`` and returns
every rank's result in rank order (each saved with ``torch.save``). A
rank that raises fails the call with its traceback. `fn` must be a
module-level function of a module the children can import; this module
and the port import no JAX, so the children do not load it.
"""
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, tmp, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world)
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"out{rank}.pt"))


class Spawned:
    """Ranks started in the background: the caller computes its own
    references meanwhile, then ``results()`` joins them."""

    def __init__(self, fn, world, tmp_path, args):
        self.tmp, self.world = str(tmp_path), world
        os.makedirs(self.tmp, exist_ok=True)
        self.context = mp.spawn(_entry, (fn, world, self.tmp, args),
                                nprocs=world, join=False)

    def results(self):
        while not self.context.join():
            pass
        return [torch.load(os.path.join(self.tmp, f"out{r}.pt"),
                           weights_only=False) for r in range(self.world)]


def start(fn, world, tmp_path, *args) -> Spawned:
    return Spawned(fn, world, tmp_path, args)


def spawn(fn, world, tmp_path, *args):
    return start(fn, world, tmp_path, *args).results()
