"""Ring attention: attention over a token axis sharded across ranks.

Port of the JAX package's ``ops/ring_attention.py``. Each rank holds S/n
query tokens and one K/V block; n hops move the K/V blocks one rank along
the ring (``dist.batch_isend_irecv`` on the mesh dimension's process
group, the counterpart of ``lax.ppermute``), and an online-softmax merge
of each hop's partial attention gives the exact global result.

At each hop (rank r holding block b = (r - i) mod n at hop i):

* without a window, the hop is one call of the flash forward kernel
  (``ts::flash_fwd.residuals``: the normalized partial o and its row sum l
  and row max m) on (q_local, K/V block): the rank's own block in causal
  mode under ``causal``, an earlier block in full mode; a later block under
  ``causal`` is wholly masked and adds nothing, so its compute is skipped
  (the block still rotates);
* with ``window=W`` the band is masked by global position, which the
  kernel's band mode (positions within one block) cannot express off the
  diagonal: every hop runs the plain hop body (``plain_hop``, the JAX
  step). That route is chosen by the argument, never as a fallback.

Each hop's (o, l, m) merges into the running state (``merge``, in f32);
the final o is cast to q's dtype. A ring of one rank is one kernel call
each way, with nothing added. ``launches_by_mode`` counts forward hops by route
("full", "causal": kernel hops; "plain": windowed hops; "skipped": the
wholly masked ones), ``bwd_launches_by_mode`` the backward's.

The backward (``_RingAttention``) runs the ring again: at each hop the
flash backward kernel (``ts::flash_bwd``, or the plain backward under a
window) on the final o, l and m gives this block's dQ share, kept
locally, and its dK and dV shares, which travel with the block (f32) and
reach home after n hops: the counterpart of JAX's transposed ``ppermute``.

``ring_attention`` is the per-rank body; ``ring_attention_sharded`` takes
DTensors (or global tensors and a mesh) with the token axis on the ring's
mesh dimension. ``virtual_ring`` runs n ring positions on one device in
ring order, through the same hop and merge code, so that the ring's
arithmetic can be checked against one kernel call where there is one
card. ``ring_attention_plain`` is the JAX step written out (f32 logits,
global-position masks, the online merge, P in v's dtype), for tests.
"""
from typing import Optional

import torch
import torch.distributed as dist

from . import flash_attention as fa

MODES = ("full", "causal", "plain", "skipped")
launches_by_mode = dict.fromkeys(MODES, 0)
bwd_launches_by_mode = dict.fromkeys(MODES, 0)


def reset_counts():
    for mode in MODES:
        launches_by_mode[mode] = 0
        bwd_launches_by_mode[mode] = 0


# ------------------------------------------------------------------ hops

def _live(sq, sk, q0, k0, causal, window):
    """Whether any (row, col) of a block pair is unmasked; q0/k0 are the
    blocks' first global positions."""
    lo, hi = q0 - (k0 + sk - 1), q0 + sq - 1 - k0     # range of row - col
    if causal:
        return hi >= 0 and (window is None or max(lo, 0) < window)
    if window is None:
        return True
    nearest = 0 if lo <= 0 <= hi else min(abs(lo), abs(hi))
    return nearest < window


def global_mask(sq, sk, q0, k0, causal, window, device):
    """[sq, sk] bool of the live pairs by global position."""
    rel = ((q0 + torch.arange(sq, device=device))[:, None]
           - (k0 + torch.arange(sk, device=device))[None, :])
    if causal:
        mask = rel >= 0
        return mask if window is None else mask & (rel < window)
    return rel.abs() < window


def hop_mode(q_block, k_block, causal, window):
    """The route of one hop: "full", "causal" (kernel), "plain" (window)
    or "skipped" (wholly masked)."""
    if window is not None:
        return "plain"
    if not causal or k_block < q_block:
        return "full"
    return "causal" if k_block == q_block else "skipped"


def plain_hop(state, q, k, v, q0, k0, causal, window, scale):
    """One step of the JAX ring body: f32 logits masked by global position,
    the running max, P = exp(S - m) zeroed where masked and cast to v's
    dtype, P V accumulated in f32. `state` is (o unnormalized, l, m) or
    None; returns the new state."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = None
    if causal or window is not None:
        mask = global_mask(q.shape[2], k.shape[2], q0, k0, causal, window,
                           q.device)
        s = torch.where(mask, s, torch.tensor(fa.MASK_VALUE, device=s.device))
    if state is None:
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        l = torch.zeros(q.shape[:3], dtype=torch.float32, device=q.device)
        m = torch.full(q.shape[:3], fa.MASK_VALUE, device=q.device)
    else:
        o, l, m = state
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return o * corr[..., None] + pv, l, m_new


def _normalized(o, l):
    return o * torch.where(l == 0, 0.0, 1.0 / l)[..., None]


def hop_forward(q, k, v, q_block, k_block, causal, window, scale, impl):
    """One hop's partial attention of the local queries (ring position
    `q_block`) over the K/V block `k_block`: (o normalized, l, m), or None
    for a wholly masked block. Kernel hops run ``ts::flash_fwd.residuals``
    (``impl`` as in ``flash_attention``)."""
    sq, sk = q.shape[2], k.shape[2]
    mode = hop_mode(q_block, k_block, causal, window)
    if mode == "plain" and not _live(sq, sk, q_block * sq, k_block * sk,
                                     causal, window):
        mode = "skipped"
    launches_by_mode[mode] += 1
    if mode == "skipped":
        return None
    if mode == "plain":
        o, l, m = plain_hop(None, q, k, v, q_block * sq, k_block * sk,
                            causal, window, scale)
        return _normalized(o, l), l, m
    return fa._dispatch(q, k, v, mode == "causal", None, scale, impl, True)


def merge(state, part):
    """The online-softmax merge of two normalized partials (o, l, m): the
    running state (None before the first) and a hop's."""
    if part is None or state is None:
        return state if part is None else part
    o_i, l_i, m_i = part
    o, l, m = state
    m_new = torch.maximum(m, m_i)
    a = l * torch.exp(m - m_new)
    b = l_i * torch.exp(m_i - m_new)
    l_new = a + b
    inv = torch.where(l_new == 0, 0.0, 1.0 / l_new)
    o = (o * a[..., None] + o_i.float() * b[..., None]) * inv[..., None]
    return o, l_new, m_new


def hop_backward(q, k, v, o, l, m, do, q_block, k_block, causal, window,
                 scale, impl):
    """One hop of the backward: (dq, dk, dv) of the block pair from the
    final o, l and m, or None for a wholly masked block. Kernel hops run
    ``ts::flash_bwd``; windowed hops the plain backward."""
    sq, sk = q.shape[2], k.shape[2]
    mode = hop_mode(q_block, k_block, causal, window)
    if mode == "plain" and not _live(sq, sk, q_block * sq, k_block * sk,
                                     causal, window):
        mode = "skipped"
    bwd_launches_by_mode[mode] += 1
    if mode == "skipped":
        return None
    if mode == "plain":
        mask = global_mask(sq, sk, q_block * sq, k_block * sk, causal, window,
                           q.device)
        return fa.flash_attention_bwd_plain(q, k, v, o, l, m, do,
                                            sm_scale=scale, mask=mask)
    return fa.flash_attention_bwd(q, k, v, o, l, m, do,
                                  causal=mode == "causal", sm_scale=scale,
                                  impl=impl)


# ------------------------------------------------------------------ rings

class _Comm:
    """The ring of one process: its position ``ranks[0]`` in a process
    group of ``n`` ranks; ``rotate`` hands each tensor to the next rank and
    returns the previous rank's."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        rank = dist.get_rank(group)
        self.ranks = [rank]
        self._next = dist.get_global_rank(group, (rank + 1) % self.n)
        self._prev = dist.get_global_rank(group, (rank - 1) % self.n)

    def rotate(self, held):
        """held: a list (one per tensor kind) of lists (one per ring
        position here) of tensors."""
        out, ops = [], []
        for kind in held:
            t = kind[0].contiguous()
            buf = torch.empty_like(t)
            ops.append(dist.P2POp(dist.isend, t, self._next, self.group))
            ops.append(dist.P2POp(dist.irecv, buf, self._prev, self.group))
            out.append([buf])
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return out


class _VirtualComm:
    """n ring positions in one process: a rotation is a shift of the
    lists (position j takes what position j - 1 held)."""

    def __init__(self, n):
        self.n = n
        self.ranks = list(range(n))

    def rotate(self, held):
        return [kind[-1:] + kind[:-1] for kind in held]


def _ring_forward(comm, qs, ks, vs, causal, window, scale, impl):
    """Runs the ring over the positions of `comm`; returns the lists of
    (o in q's dtype, l, m)."""
    states = [None] * len(qs)
    held = [list(ks), list(vs)]
    for i in range(comm.n):
        for j, r in enumerate(comm.ranks):
            part = hop_forward(qs[j], held[0][j], held[1][j], r,
                               (r - i) % comm.n, causal, window, scale, impl)
            states[j] = merge(states[j], part)
        if i < comm.n - 1:
            held = comm.rotate(held)
    return ([o.to(q.dtype) for (o, _, _), q in zip(states, qs)],
            [s[1] for s in states], [s[2] for s in states])


def _ring_backward(comm, qs, ks, vs, os, ls, ms, dos, causal, window, scale,
                   impl):
    """The reverse ring: dQ sums locally, dK/dV (f32) travel with their
    blocks and are home after n hops. A ring of one is its one hop (the
    diagonal block, always live): the backward's own outputs."""
    if comm.n == 1:
        dq, dk, dv = hop_backward(qs[0], ks[0], vs[0], os[0], ls[0], ms[0],
                                  dos[0], 0, 0, causal, window, scale, impl)
        return [dq], [dk], [dv]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
           for q in qs]
    held = [list(ks), list(vs),
            [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
             for k in ks],
            [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for v in vs]]
    for i in range(comm.n):
        for j, r in enumerate(comm.ranks):
            g = hop_backward(qs[j], held[0][j], held[1][j], os[j], ls[j],
                             ms[j], dos[j], r, (r - i) % comm.n, causal,
                             window, scale, impl)
            if g is not None:
                dqs[j] += g[0]
                held[2][j] = held[2][j] + g[1]
                held[3][j] = held[3][j] + g[2]
        if i < comm.n - 1:
            held = comm.rotate(held)
        elif comm.n > 1:
            held[2:] = comm.rotate(held[2:])
    return ([dq.to(q.dtype) for dq, q in zip(dqs, qs)],
            [dk.to(k.dtype) for dk, k in zip(held[2], ks)],
            [dv.to(v.dtype) for dv, v in zip(held[3], vs)])


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, comm, causal, window, scale, impl):
        (o,), (l,), (m,) = _ring_forward(comm, [q], [k], [v], causal, window,
                                         scale, impl)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.args = (comm, causal, window, scale, impl)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        comm, causal, window, scale, impl = ctx.args
        if impl != "plain" and q.device.type == "cuda" and not fa._aligned(do):
            do = do.contiguous()
        (dq,), (dk,), (dv,) = _ring_backward(comm, [q], [k], [v], [o], [l],
                                             [m], [do], causal, window,
                                             scale, impl)
        return dq, dk, dv, None, None, None, None, None


def _check(q, k, v, causal, window, sm_scale):
    if q.dim() != 4 or k.shape[:2] != q.shape[:2] or v.shape != k.shape:
        raise ValueError(f"bad attention shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if causal and q.shape[2] != k.shape[2]:
        raise ValueError("causal=True requires equal q/kv lengths")
    if window is not None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if q.shape[2] != k.shape[2]:
            raise ValueError("window requires equal q/kv lengths")
        window = int(window)
    if sm_scale is None:
        sm_scale = float(q.shape[-1]) ** -0.5
    return float(sm_scale), window


def ring_attention(q, k, v, *, group, causal: bool = False,
                   window: Optional[int] = None,
                   sm_scale: Optional[float] = None, impl: str = "auto"):
    """The per-rank body: q [b, h, sq_local, d], k/v [b, h, sk_local, d],
    this rank's shards of sequences sharded in rank order over `group`
    (a mesh dimension's process group). Global semantics equal full
    softmax(Q K^T scale) V over the gathered sequence; ``causal`` and
    ``window`` mask by global position. Differentiable (the backward is
    the reverse ring); ``impl`` as in ``flash_attention``."""
    scale, window = _check(q, k, v, causal, window, sm_scale)
    return _RingAttention.apply(q, k, v, _Comm(group), bool(causal), window,
                                scale, impl)


def virtual_ring(q, k, v, n: int, *, causal: bool = False,
                 window: Optional[int] = None,
                 sm_scale: Optional[float] = None, impl: str = "auto"):
    """The ring of `n` positions on one device: the token axis of q/k/v
    [b, h, S, d] split into n blocks, each position's hops run in ring
    order through the same hop and merge code as ``ring_attention``.
    Returns (o, l, m) over the whole sequence."""
    scale, window = _check(q, k, v, causal, window, sm_scale)
    os, ls, ms = _ring_forward(_VirtualComm(n), q.chunk(n, 2), k.chunk(n, 2),
                               v.chunk(n, 2), causal, window, scale, impl)
    return torch.cat(os, 2), torch.cat(ls, 2), torch.cat(ms, 2)


def virtual_ring_bwd(q, k, v, o, l, m, do, n: int, *, causal: bool = False,
                     window: Optional[int] = None,
                     sm_scale: Optional[float] = None, impl: str = "auto"):
    """The reverse ring of ``virtual_ring``: (dq, dk, dv)."""
    scale, window = _check(q, k, v, causal, window, sm_scale)
    parts = [t.chunk(n, 2) for t in (q, k, v, o, do)]
    # The backward kernel takes the statistics contiguous.
    l, m = ([c.contiguous() for c in t.chunk(n, 2)] for t in (l, m))
    parts[4:4] = [l, m]
    dqs, dks, dvs = _ring_backward(_VirtualComm(n), *parts, causal, window,
                                   scale, impl)
    return torch.cat(dqs, 2), torch.cat(dks, 2), torch.cat(dvs, 2)


def ring_attention_plain(q, k, v, *, group, causal: bool = False,
                         window: Optional[int] = None,
                         sm_scale: Optional[float] = None):
    """The JAX ring body written out (``plain_hop`` at every hop, blocks
    rotated n times), forward only: the tests' second reference."""
    scale, window = _check(q, k, v, causal, window, sm_scale)
    comm = _Comm(group)
    r = comm.ranks[0]
    state, held = None, [[k], [v]]
    for i in range(comm.n):
        blk = (r - i) % comm.n
        state = plain_hop(state, q, held[0][0], held[1][0], r * q.shape[2],
                          blk * k.shape[2], causal, window, scale)
        if i < comm.n - 1:
            held = comm.rotate(held)
    o, l, _ = state
    return _normalized(o, l).to(q.dtype)


def ring_attention_sharded(mesh, q, k, v, *, seq_axis: str,
                           batch_axis: Optional[str] = None,
                           head_axis: Optional[str] = None,
                           causal: bool = False,
                           window: Optional[int] = None,
                           sm_scale: Optional[float] = None,
                           impl: str = "auto"):
    """Ring attention on global [b, h, S, d] tensors: DTensors on `mesh`
    (redistributed to the ring's layout) or plain tensors holding the
    whole array on every rank. The token axis shards over `seq_axis`, the
    batch over `batch_axis` and the heads over `head_axis` when given
    (each dp row runs its own ring; each tp rank rings over its own
    heads). Returns a DTensor in that layout."""
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import as_dtensor, spec_placements
    n = mesh[seq_axis].size()
    if q.ndim != 4 or k.shape[:2] != q.shape[:2] or v.shape != k.shape:
        raise ValueError(f"bad attention shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(
            f"sequence lengths {q.shape[2]}/{k.shape[2]} must divide the "
            f"ring size {n} (mesh axis {seq_axis!r})")
    for axis, dim, what in ((batch_axis, 0, "batch"), (head_axis, 1,
                                                       "heads")):
        if axis is not None and q.shape[dim] % mesh[axis].size():
            raise ValueError(f"{what} {q.shape[dim]} must divide mesh axis "
                             f"{axis!r}={mesh[axis].size()}")
    scale, window = _check(q, k, v, causal, window, sm_scale)
    placements = spec_placements(mesh, (batch_axis, head_axis, seq_axis,
                                        None))
    local = [as_dtensor(t, mesh, placements).to_local() for t in (q, k, v)]
    o = ring_attention(*local, group=mesh.get_group(seq_axis), causal=causal,
                       window=window, sm_scale=scale, impl=impl)
    # The kernels write o in q's layout, so its global layout is q's.
    return DTensor.from_local(o, mesh, placements, run_check=False,
                              shape=q.shape, stride=q.stride())
