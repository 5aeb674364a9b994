"""Pipeline parallelism (GPipe) over VideoViT's blocks.

Port of the JAX package's ``parallel/pipeline.py``. The blocks split into
S stages, one a rank along the mesh's "pp" axis; the stage weights are
the blocks' parameters stacked [S, L, ...] (L = depth / S blocks a stage,
run in order), laid out over "pp" on their leading axis, so each rank
holds only its own stage (``init_pp_params``, ``shard_pp_params``).

``pp_apply`` runs JAX's circulating schedule of M + S - 1 ticks: at tick
t stage 0 takes microbatch min(t, M - 1), every stage applies its blocks
to what it holds, the last stage keeps its result as microbatch t - (S -
1) from tick S - 1 on, and every stage hands its activations to the next
(stage S - 1's to stage 0 is dead weight, overwritten by the next
injection). The bubble is (S - 1) / (M + S - 1). The selections are
``torch.where`` against the stage index, as in JAX, so every rank runs the
same operations and the backward visits the hand-offs in the same order
on every rank. The last stage's outputs reach every stage through a
masked sum over "pp".

torch's point-to-point calls are not differentiable: the hand-off is an
autograd Function (``_Handoff``) whose forward sends to stage s + 1 and
receives from s - 1, and whose backward sends the gradient to s - 1 and
receives from s + 1, in the reverse tick order. The logits come back as a
DTensor of the global batch, so a loss taken on it (DTensor ops) hands
each rank its part of the gradient: the parameters' local views declare
their gradients summed over "dp", the embedding's also over "pp" (only
stage 0 sees it), the head's replicated over "pp" and each stage's
sharded there.
"""
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.func import functional_call

from ..models._train import graphed_train_step
from ..models.video_vit import (VideoViT, flip_clips, init_vit,
                                loss_and_accuracy, tubelet_embed)
from .sharding import distribute, make_mesh, mean_over, spec_placements

OUTER = ("tubelet.weight", "tubelet.bias", "pos_spatial", "pos_temporal",
         "ln_f.weight", "ln_f.bias", "head.weight", "head.bias")
EMBED = OUTER[:4]


def make_pp_mesh(n_devices: Optional[int] = None, pp: Optional[int] = None,
                 axes: Tuple[str, str] = ("dp", "pp"),
                 device=None) -> DeviceMesh:
    """A ("dp", "pp") mesh: pp defaults to the largest divisor of the
    world not above its square root (``make_mesh``'s factoring)."""
    if pp is None:
        return make_mesh(n_devices, axes=axes, device=device)
    n = int(n_devices or dist.get_world_size())
    if n % pp:
        raise ValueError(f"{n} ranks do not split into {pp} stages")
    return make_mesh(n, axes=axes, shape=(n // pp, pp), device=device)


def init_pp_params(generator: Optional[torch.Generator], model: VideoViT,
                   clip_shape, n_stages: int):
    """(outer, stage): the embedding and head parameters {name: tensor},
    and every block parameter stacked [S, L, ...] {block-relative name:
    tensor} (stage s runs blocks s*L .. (s+1)*L - 1). The values are the
    model's own after ``init_vit(generator, ...)`` (None keeps them)."""
    depth = len(model.blocks)
    if depth % n_stages:
        raise ValueError(f"depth={depth} not divisible by stages={n_stages}")
    if model.causal:
        raise ValueError("the pipeline's head pools every token: build the "
                         "model without causal")
    if generator is not None:
        init_vit(generator, model, clip_shape)
    params = dict(model.named_parameters())
    outer = {k: params[k].detach().clone() for k in OUTER}
    per = depth // n_stages
    stage = {}
    for name, _ in model.blocks[0].named_parameters():
        stacked = torch.stack([params[f"blocks.{i}.{name}"].detach()
                               for i in range(depth)])
        stage[name] = stacked.reshape((n_stages, per) + stacked.shape[1:])
    return outer, stage


def shard_pp_params(mesh: DeviceMesh, outer: dict, stage: dict):
    """(outer, stage) as DTensor ``nn.Parameter``s: the outer parameters
    replicated, the stage stacks over "pp" on their leading axis (the
    JAX ``make_pp_train_step``'s shard_fn). Build the optimizer over
    them."""
    def put(x, spec):
        d = distribute(x, mesh, spec)
        local = d.to_local().clone()
        return torch.nn.Parameter(DTensor.from_local(
            local, mesh, d.placements, run_check=False, shape=x.shape,
            stride=x.stride()))
    return ({k: put(v, ()) for k, v in outer.items()},
            {k: put(v, ("pp",)) for k, v in stage.items()})


class _Handoff(torch.autograd.Function):
    """Sends to the next stage, receives from the previous one; the
    backward sends the gradient back the other way."""

    @staticmethod
    def forward(ctx, y, group, nxt, prv):
        ctx.args = (group, nxt, prv)
        return _exchange(y, group, nxt, prv)

    @staticmethod
    def backward(ctx, g):
        group, nxt, prv = ctx.args
        return _exchange(g, group, prv, nxt), None, None, None


def _exchange(t, group, to, frm):
    t = t.contiguous()
    buf = torch.empty_like(t)
    for work in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, to, group),
            dist.P2POp(dist.irecv, buf, frm, group)]):
        work.wait()
    return buf


class _SumOverStages(torch.autograd.Function):
    """The masked broadcast's sum over "pp". Every stage computes the same
    loss from the sum, so each input's gradient is the sum's."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _local(p, mesh, grad):
    if not isinstance(p, DTensor):
        return p
    return p.to_local(grad_placements=grad)


def pp_apply(mesh: DeviceMesh, model: VideoViT, outer: dict, stage: dict,
             clips, n_micro: int = 2):
    """Pipeline-parallel forward: logits of a clip batch (a DTensor, or
    the whole batch on every rank; sharded over "dp"), as a DTensor laid
    out over "dp". `outer` and `stage` as ``init_pp_params`` (or
    ``shard_pp_params``) returns them; `model` gives the structure (its
    own parameters are not read)."""
    names = mesh.mesh_dim_names
    S = mesh["pp"].size()
    s = mesh.get_local_rank("pp")
    group = mesh.get_group("pp")
    nxt = dist.get_global_rank(group, (s + 1) % S)
    prv = dist.get_global_rank(group, (s - 1) % S)

    def grads(pp):
        return [Partial("sum") if n == "dp" else pp for n in names]
    outer_l = {k: _local(v, mesh, grads(Partial("sum") if k in EMBED
                                        else Replicate()))
               for k, v in outer.items()}
    stage_l = {k: _local(v, mesh, grads(Shard(0))) for k, v in stage.items()}
    if not isinstance(next(iter(stage.values())), DTensor):
        stage_l = {k: v[s:s + 1] for k, v in stage_l.items()}
    x = distribute(clips, mesh, ("dp",)).to_local()

    tokens = tubelet_embed(_Stem(model, outer_l), x)
    if model.joint:
        b, tt, n, d = tokens.shape
        tokens = tokens.reshape(b, tt * n, d)
    b = tokens.shape[0]
    if b % n_micro:
        raise ValueError(f"local batch {b} does not split into {n_micro} "
                         "microbatches")
    micro = tokens.reshape((n_micro, b // n_micro) + tokens.shape[1:])
    block, per = model.blocks[0], next(iter(stage_l.values())).shape[1]
    first = torch.full((), s == 0, device=x.device)
    last = torch.full((), s == S - 1, device=x.device)

    def apply_stage(h):
        for i in range(per):
            h = functional_call(block, {k: v[0, i] for k, v in
                                        stage_l.items()}, (h,))
        return h

    ticks = n_micro + S - 1
    state, out = torch.zeros_like(micro[0]), [None] * n_micro
    for t in range(ticks):
        y = apply_stage(torch.where(first, micro[min(t, n_micro - 1)],
                                    state))
        if t >= S - 1:
            out[t - (S - 1)] = torch.where(last, y, torch.zeros_like(y))
        if t < ticks - 1:   # the last tick's hand-off would feed nothing
            state = _Handoff.apply(y, group, nxt, prv) if S > 1 else y
    y = torch.stack(out).reshape(tokens.shape)
    if S > 1:
        y = _SumOverStages.apply(y, group)
    y = functional_call(model.ln_f, {"weight": outer_l["ln_f.weight"],
                                     "bias": outer_l["ln_f.bias"]}, (y,))
    y = y.mean(dim=1) if model.joint else y.mean(dim=(1, 2))
    logits = functional_call(model.head, {"weight": outer_l["head.weight"],
                                          "bias": outer_l["head.bias"]},
                             (y,))
    placements = spec_placements(mesh, ("dp",))
    shape = (clips.shape[0],) + tuple(logits.shape[1:])
    return DTensor.from_local(logits, mesh, placements, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


class _Stem:
    """The model's stem attributes with the outer parameters in place of
    its own, for ``tubelet_embed``."""

    def __init__(self, model, outer):
        self.tubelet_t, self.patch = model.tubelet_t, model.patch
        self.compute_dtype = model.compute_dtype
        self.residual_dtype = model.residual_dtype
        self.pos_spatial = outer["pos_spatial"]
        self.pos_temporal = outer["pos_temporal"]
        self.tubelet = lambda x: functional_call(
            model.tubelet, {"weight": outer["tubelet.weight"],
                            "bias": outer["tubelet.bias"]}, (x,))


def make_pp_train_step(mesh: DeviceMesh, model: VideoViT, outer: dict,
                       stage: dict, optimizer: torch.optim.Optimizer,
                       n_micro: int = 2):
    """step(clips, flip_mask) -> (loss, acc): the arrow-of-time step over a
    ("dp", "pp") mesh through ``pp_apply``, then `optimizer` (built over
    the ``shard_pp_params`` parameters `outer` and `stage`). loss and acc
    are the global batch's. Replayed as a CUDA graph on the card."""
    dp = mesh["dp"].size()

    def step(clips, flip_mask):
        clips = distribute(clips, mesh, ("dp",))
        mask = distribute(flip_mask, mesh, ("dp",)).to_local()
        x = DTensor.from_local(flip_clips(clips.to_local(), mask), mesh,
                               clips.placements, run_check=False,
                               shape=clips.shape, stride=clips.stride())
        logits = pp_apply(mesh, model, outer, stage, x, n_micro).to_local()
        loss, acc = loss_and_accuracy(logits, mask.long())
        (loss / dp).backward()     # the global loss: the ranks' mean
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return mean_over(loss.detach(), mesh), mean_over(acc, mesh)
    device = next(iter(stage.values())).device
    return graphed_train_step(step, optimizer, device)
