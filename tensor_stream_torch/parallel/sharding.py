"""Meshes, DTensor layouts, the sharded VPP and the sharded training step.

Port of the JAX package's ``parallel/sharding.py``. JAX runs one
controller over a ``Mesh``; torch runs one process per device, so a mesh
here is a ``DeviceMesh`` over an initialized process group, with the JAX
axis names (``"dp"``, ``"mp"``, ``"sp"``, ``"cp"``, ``"ep"``, ``"pp"``):

* ``make_mesh`` factors the world into the same near-square (dp, mp) grid
  and raises without a process group (it never builds a one-process mesh
  on its own);
* a JAX ``PartitionSpec`` is a tuple here, one mesh axis name (or None) a
  tensor dim; ``spec_placements`` turns it into DTensor placements, and
  ``as_dtensor`` lays a tensor out so (``with_sharding_constraint``: a
  DTensor is redistributed; a plain tensor is the whole array, the same on
  every rank, and each rank keeps its own shard without communication);
* ``shard_params`` puts a module's parameters on the mesh by such specs
  (``jax.device_put`` of a parameter tree).

``vpp_batch_sharded`` converts an NV12 batch laid out ("dp", "mp", None):
inside an mp group the rows are all-gathered (the simplest halo) and the
NV12 and resize kernels run on the rank's local batch; the result is laid
out ("dp",). ``param_sharding``, ``make_train_state`` and
``build_train_step`` are the TransformerNet step with its conv output
channels over "mp": DTensor has no strategy for the network's reflection
padding, so the step gathers the weights explicitly (an all-gather over
"mp"), runs the network on the rank's local batch and hands the gradients
back averaged over "dp" and sliced over "mp" (``gathered_params``: what
``local_map`` does, written out).
"""
import math
from functools import lru_cache
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.func import functional_call

from .._device import resolve_device
from ..models._train import graphed_train_step
from ..models.transformer_net import TransformerNet, style_transfer_loss
from ..ops.vpp import VPPConfig, make_vpp_fn
from . import _rules  # noqa: F401  (the ts operators' sharding rules)


def factor(n: int):
    """(dp, mp) with mp the largest divisor of n not above sqrt(n)."""
    mp = next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)
    return n // mp, mp


def make_mesh(n_devices: Optional[int] = None, axes=("dp", "mp"),
              shape: Optional[Sequence[int]] = None,
              device=None) -> DeviceMesh:
    """A mesh over the `n_devices` ranks of the initialized process group
    (default: all of them), named `axes`. Two axes without `shape` get the
    near-square (dp, mp) factoring of the JAX ``make_mesh``. `device`:
    None means this rank's CUDA device (rank modulo the cards), "cpu" a
    CPU mesh (gloo)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized process group: call "
            "torch.distributed.init_process_group (nccl on the cards, gloo "
            "on the CPU) with this process's rank and the world size first")
    world = dist.get_world_size()
    n = int(n_devices or world)
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} "
                         f"processes, this one has {world}")
    if shape is None:
        if len(axes) == 1:
            shape = (n,)
        elif len(axes) == 2:
            shape = factor(n)
        else:
            raise ValueError(f"axes {axes} need an explicit shape")
    if math.prod(shape) != n or len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} does not fit {n} ranks "
                         f"named {tuple(axes)}")
    if device is None:
        dev = resolve_device(None, dist.get_rank()
                             % max(torch.cuda.device_count(), 1))
    else:
        dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def spec_placements(mesh: DeviceMesh, spec) -> list:
    """DTensor placements of a JAX-style spec: ``spec[d]`` names the mesh
    axis (or a tuple of axes) tensor dim d is sharded over, None for
    none. Mesh axes the spec does not name replicate."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, s in enumerate(spec)
                if s == name or (isinstance(s, tuple) and name in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def as_dtensor(x, mesh: DeviceMesh, placements) -> DTensor:
    """`x` laid out as `placements` on `mesh`: a DTensor is redistributed;
    a plain tensor is taken as the whole array, the same on every rank,
    and each rank keeps its shard (no communication). Differentiable."""
    placements = list(placements)
    if isinstance(x, DTensor):
        if list(x.placements) == placements:
            return x
        return x.redistribute(mesh, placements)
    whole = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return whole.redistribute(mesh, placements)


def distribute(x, mesh: DeviceMesh, spec) -> DTensor:
    """``jax.device_put(x, NamedSharding(mesh, P(*spec)))``."""
    return as_dtensor(x, mesh, spec_placements(mesh, spec))


def shard_params(module: torch.nn.Module, mesh: DeviceMesh, specs: dict,
                 optimizer: Optional[torch.optim.Optimizer] = None):
    """Replaces each parameter of `module` with a DTensor parameter laid
    out by ``specs[name]`` (a JAX-style spec; a name it lacks replicates).
    Every rank must hold the same values (made from one seed). An
    `optimizer` over the old parameters is pointed at the new ones; it
    must not have state yet. Returns the module."""
    if optimizer is not None and optimizer.state:
        raise ValueError("the optimizer already has state: shard the "
                         "parameters before its first step")
    swapped = {}
    for mname, mod in module.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(p, DTensor):
                continue
            placements = spec_placements(mesh, specs.get(name, ()))
            local = as_dtensor(p.detach(), mesh, placements).to_local()
            new = torch.nn.Parameter(
                DTensor.from_local(local.clone(), mesh, placements,
                                   run_check=False, shape=p.shape,
                                   stride=p.stride()),
                requires_grad=p.requires_grad)
            mod.register_parameter(pname, new)
            swapped[id(p)] = new
    if optimizer is not None:
        for group in optimizer.param_groups:
            group["params"] = [swapped.get(id(p), p) for p in group["params"]]
    return module


def gathered_params(module: torch.nn.Module, mesh: DeviceMesh,
                    dp_axis: str = "dp", keep: Sequence[str] = ()) -> dict:
    """Each parameter of `module` gathered whole on every rank, but for
    its shards over the mesh axes in `keep`, which stay local (a rank
    computes with its own shard), as a local tensor whose gradient is the
    rank's share of a mean over `dp_axis`: the backward averages it over
    dp and slices it back to the parameter's layout (an all-reduce and,
    for gathered shards, a reduce-scatter). For a step that runs the
    module on local tensors (``torch.func.functional_call``) whose loss
    is a mean over the rank's equal share of the global batch."""
    out = {}
    for name, p in module.named_parameters():
        if isinstance(p, DTensor):
            target = [pl if axis in keep else Replicate()
                      for axis, pl in zip(mesh.mesh_dim_names, p.placements)]
            grad = [Partial("avg") if axis == dp_axis else pl
                    for axis, pl in zip(mesh.mesh_dim_names, target)]
            p = p.redistribute(mesh, target).to_local(grad_placements=grad)
        out[name] = p
    return out


def local_module(module: torch.nn.Module, params: dict):
    """`module` called with `params` (``gathered_params``) in place of its
    own: f(*args) -> ``functional_call(module, params, args)``."""
    def call(*args):
        return functional_call(module, params, args)
    return call


def local_batch(mesh: DeviceMesh, *tensors, axis: str = "dp"):
    """Each tensor (a DTensor, or the whole batch on every rank; None
    passes through) as this rank's share of its dim 0 over `axis`."""
    return tuple(None if t is None else distribute(t, mesh, (axis,))
                 .to_local() for t in tensors)


def mean_over(x: torch.Tensor, mesh: DeviceMesh, axis: str = "dp"):
    """A rank's share of a mean over `axis` (a local 0-d tensor) -> the
    global mean, the same on every rank."""
    placements = [Partial("avg") if name == axis else Replicate()
                  for name in mesh.mesh_dim_names]
    return DTensor.from_local(x, mesh, placements,
                              run_check=False).full_tensor()


# ------------------------------------------------------------- sharded VPP

@lru_cache(maxsize=64)
def _vpp_fn(cfg: VPPConfig):
    return make_vpp_fn(cfg)


def vpp_batch_sharded(cfg: VPPConfig, mesh: DeviceMesh, ys, uvs) -> DTensor:
    """Converts an NV12 batch (ys [N, H, W], uvs [N, H/2, W] u8: DTensors,
    or the whole batch on every rank) laid out ("dp", "mp", None): the
    rows are gathered within each mp group and the VPP (the NV12 kernel,
    and the resize kernels when `cfg` resizes) runs on the rank's local
    batch. Returns [N, ...] laid out ("dp",), byte-equal to ``build_vpp``
    frame by frame. N must divide the dp axis."""
    if ys.shape[0] % mesh["dp"].size():
        raise ValueError(f"batch {ys.shape[0]} must divide mesh axis 'dp'="
                         f"{mesh['dp'].size()}")
    rows = spec_placements(mesh, ("dp", "mp", None))
    batch = spec_placements(mesh, ("dp",))
    y = as_dtensor(as_dtensor(ys, mesh, rows), mesh, batch).to_local()
    uv = as_dtensor(as_dtensor(uvs, mesh, rows), mesh, batch).to_local()
    out = _vpp_fn(cfg)(y, uv)
    shape = (ys.shape[0],) + tuple(out.shape[1:])
    return DTensor.from_local(out, mesh, batch, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


# --------------------------------------------------- sharded training step

def param_sharding(model: torch.nn.Module, mesh: DeviceMesh) -> dict:
    """TransformerNet's layout: each conv kernel's output channels (dim 0
    of [out, in, k, k]) over "mp" when they divide it, each 1-D parameter
    (bias, norm scale) likewise; the rest replicated. {name: spec}."""
    mp = mesh["mp"].size()
    specs = {}
    for name, p in model.named_parameters():
        if p.ndim == 4 and p.shape[0] % mp == 0:
            specs[name] = ("mp", None, None, None)
        elif p.ndim == 1 and p.shape[0] % mp == 0:
            specs[name] = ("mp",)
        else:
            specs[name] = ()
    return specs


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on `mesh`."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_train_state(mesh: DeviceMesh, height=64, width=64, batch=8,
                     learning_rate=1e-3,
                     generator: Optional[torch.Generator] = None):
    """(model, optimizer): a TransformerNet drawn from `generator` (the
    same seed on every rank) on this rank's device, its parameters laid
    out by ``param_sharding``, and Adam over them. `height`, `width` and
    `batch` are the JAX signature's (its init traces a batch); the
    network takes any size."""
    model = TransformerNet(device=mesh_device(mesh), generator=generator)
    shard_params(model, mesh, param_sharding(model, mesh))
    return model, torch.optim.Adam(model.parameters(), lr=learning_rate)


def build_train_step(mesh: DeviceMesh, model: TransformerNet,
                     optimizer: torch.optim.Optimizer,
                     vpp_cfg: Optional[VPPConfig] = None):
    """step(ys, uvs, style_grams) -> loss: the NV12 batch through the
    sharded VPP (``vpp_batch_sharded``; without `vpp_cfg`, ys is the RGB
    content itself, laid out over "dp"), TransformerNet forward and
    backward on the rank's batch with the weights gathered over "mp", and
    the `optimizer` step. The loss is the global batch's, the same on
    every rank. Replayed as a CUDA graph on the card
    (``models/_train.py``)."""
    device = next(model.parameters()).device

    def step(ys, uvs, style_grams):
        if vpp_cfg is not None:
            content = vpp_batch_sharded(vpp_cfg, mesh, ys, uvs)
        else:
            content = distribute(ys, mesh, ("dp",))
        params = gathered_params(model, mesh)
        if isinstance(style_grams, DTensor):
            style_grams = style_grams.full_tensor()
        loss = style_transfer_loss(local_module(model, params),
                                   content.to_local(), style_grams)
        loss.backward()
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return mean_over(loss.detach(), mesh)
    return graphed_train_step(step, optimizer, device)


def multi_stream_round_robin(n_streams: int, mesh: DeviceMesh) -> dict:
    """Stream index -> the global rank that serves it, one pipeline a rank
    in mesh order: the reference's one-GPU-per-instance pattern."""
    ranks = mesh.mesh.flatten().tolist()
    return {i: ranks[i % len(ranks)] for i in range(n_streams)}


__all__ = ["as_dtensor", "build_train_step", "distribute", "factor",
           "gathered_params", "local_batch", "local_module", "make_mesh",
           "make_train_state", "mean_over",
           "multi_stream_round_robin", "param_sharding", "shard_params",
           "spec_placements", "vpp_batch_sharded"]
