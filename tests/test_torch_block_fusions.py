"""The ViT blocks' fused seams (tensor_stream_torch/ops/block_fusions.py:
``ts::ln_cast``, its residual overload, ``ts::bias_gelu`` and their
backwards) against the JAX package, on the CPU, where the operators run
their plain versions.

The JAX side is what the flax blocks compute: ``nn.LayerNorm(dtype=f32)``
then ``astype(compute_dtype)``; the residual add ``x + y.astype(x.dtype)``
of a Dense's output (its product plus its bias cast to the compute dtype);
``nn.gelu`` of fc1's output; gradients from ``jax.vjp``. Inputs come from
seeded numpy: x of mean 3 and std 2 (the statistics' cancellation shows),
y and the cotangents std 1, fc1's product std 2 (both GELU tails),
LayerNorm scales 1 + N(0, 0.5), biases N(0, 0.5).

Tolerances, each with its reason:
* x' bit-equal: one rounding of each add, in the same order on both sides;
* h within one spacing of its dtype at the JAX value (bf16: one bf16 step;
  f32: FUSION_STEPS' 64 steps, flax's E[x^2] - E[x]^2 against the port's
  two passes), plus 2^-20 of the largest |h| where h is near 0 (there it
  is a difference of terms near 1 whose f32 rounding exceeds a step of
  the small result): chip_smoke.within_steps, the card's rule;
* g: JAX's GELU in f32 on the same rounded pre-activation, the same rule,
  and its gradients by the rule below; the flax model's own bf16
  ``nn.gelu`` rounds each intermediate to bf16 (more than one step away
  on about 15% of values, and 0 where the port's tail is not), so against
  it g and dy as relative norms within 2^-6;
* gradients: 2e-2 (atol and rtol) in bf16, the bf16 model rule; 1e-4 of
  the largest value in f32 (reduction order). A Dense bias's gradient is
  held to JAX's cotangent of y summed over the rows in f32 and rounded to
  the compute dtype, as torch sums (XLA sums it in bf16, a rounding a row:
  0.383 against an f32 sum of 0.335 over 35 rows, where the port reads
  0.330), within one bf16 step of each term's magnitude summed over the
  rows plus one of the sum: each term is a bf16 value that may sit one
  rounding away from JAX's.

Also: each plain version bit-equal to autograd over the unfused op
sequence the blocks ran before (the models' CPU numbers do not move);
small factorized and joint VideoViTs (depth 2, dim 64) whose forward and
first-step gradients run through the operators (counted) and match the
flax model; and a torch emulation of the CUDA kernels' arithmetic
(csrc/block_fusions.cu: two-pass statistics, the backward's row sums,
ATen's GELU formulas in f32) held by chip_smoke's rules, which reject its
faults.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke
from tensor_stream_tpu.models.video_vit import VideoViT as FlaxViT
from tensor_stream_torch.models import (VideoViT, vit_loss,
                                        vit_state_dict_from_flax)
from tensor_stream_torch.ops import block_fusions as bf

EPS = 1e-6
DT = {"bf16": (torch.bfloat16, jnp.bfloat16),
      "f32": (torch.float32, jnp.float32)}
BF16_RULE = dict(atol=2e-2, rtol=2e-2)


def _np(shape, seed, std=1.0, mean=0.0):
    rng = np.random.default_rng(seed)
    return (mean + std * rng.standard_normal(shape)).astype(np.float32)


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _steps(got, want, dtype):
    """chip_smoke.within_steps of torch `got` against the JAX `want` (both
    in `dtype`)."""
    return chip_smoke.within_steps(got, _t(_f32(want), dtype),
                                   chip_smoke.FUSION_STEPS[dtype])


def _close(got, want, dtype):
    want = _t(_f32(want), torch.float32)
    got = got.float()
    if dtype == torch.bfloat16:
        torch.testing.assert_close(got, want, **BF16_RULE)
    else:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=1e-4)


def _close_bias_grad(got, jdy, dtype):
    """A bias's gradient against JAX's cotangent of y summed over its rows
    in f32 and rounded to `dtype`, within one step of `dtype` at each
    term's magnitude, summed over the rows, plus one step of the sum (f32:
    1e-4 of the largest value)."""
    dy = _t(_f32(jdy), torch.float32).reshape(-1, jdy.shape[-1])
    want = dy.sum(0).to(dtype).float()
    if dtype == torch.float32:
        return _close(got, want.numpy(), dtype)
    step = 2.0 ** -8
    tol = step * dy.abs().sum(0) + step * want.abs()
    assert bool(((got.float() - want).abs() <= tol).all())


def _inputs(lead, d, seed):
    return dict(x=_np((*lead, d), seed, 2.0, 3.0), y=_np((*lead, d), seed + 1),
                yb=_np((d,), seed + 2, 0.5),
                w=1.0 + _np((d,), seed + 3, 0.5), b=_np((d,), seed + 4, 0.5),
                dh=_np((*lead, d), seed + 5), dres=_np((*lead, d), seed + 6))


def _jax_seam(x, y, yb, w, b, cd, residual):
    """(x', h) of the flax block's seam: x' = x + (y + yb.astype(cd))
    .astype(x.dtype) with the residual, h = LayerNorm(dtype=f32) of x'
    cast to cd."""
    ln = nn.LayerNorm(dtype=jnp.float32, param_dtype=jnp.float32)
    params = {"params": {"scale": w, "bias": b}}
    xp = x + (y + yb.astype(cd)).astype(x.dtype) if residual else x
    return xp, ln.apply(params, xp).astype(cd)


ROWS = [("odd_35", (5, 7)), ("vit_like", (2, 3, 4))]


@pytest.mark.parametrize("d", [64, 192, 768])
@pytest.mark.parametrize("rows", ROWS, ids=[r[0] for r in ROWS])
@pytest.mark.parametrize("residual_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("residual", [False, True],
                         ids=["ln_cast", "ln_cast_residual"])
def test_ln_cast_matches_flax(residual, residual_dtype, rows, d):
    lead = rows[1]
    xdt, jxdt = DT[residual_dtype]
    cdt, jcdt = DT["bf16"]
    a = _inputs(lead, d, 10 + d)
    jx, jy = _j(a["x"], jxdt), _j(a["y"], jcdt)
    jargs = (jx, jy, jnp.asarray(a["yb"]), jnp.asarray(a["w"]),
             jnp.asarray(a["b"]))
    (jxp, jh), vjp = jax.vjp(
        lambda x, y, yb, w, b: _jax_seam(x, y, yb, w, b, jcdt, residual),
        *jargs)
    jd = vjp((_j(a["dres"], jxdt) if residual else jnp.zeros_like(jx),
              _j(a["dh"], jcdt)))
    x = _t(a["x"], xdt).requires_grad_()
    y = _t(a["y"], cdt).requires_grad_()
    params = [_t(a[k], torch.float32).requires_grad_()
              for k in ("yb", "w", "b")]
    yb, w, b = params
    if residual:
        xp, h = bf.add_ln_cast(x, y, yb, w, b, EPS)
        torch.autograd.backward([xp, h], [_t(a["dres"], xdt),
                                          _t(a["dh"], cdt)])
        assert torch.equal(xp.detach().float(), _t(_f32(jxp), torch.float32))
        _close(y.grad, jd[1], cdt)
        _close_bias_grad(yb.grad, jd[1], cdt)
    else:
        h = bf.ln_cast(x, w, b, cdt, EPS)
        h.backward(_t(a["dh"], cdt))
    assert h.dtype == cdt and _steps(h.detach(), jh, cdt) <= 1
    _close(x.grad, jd[0], xdt)
    _close(w.grad, jd[3], cdt)
    _close(b.grad, jd[4], cdt)


def test_ln_cast_f32_compute_matches_flax():
    """The f32 model's seam (compute and residual f32): h within 64 f32
    steps, gradients within 1e-4 of their scale."""
    a = _inputs((3, 11), 64, 7)
    args = [jnp.asarray(a[k]) for k in ("x", "y", "yb", "w", "b")]
    (jxp, jh), vjp = jax.vjp(
        lambda *t: _jax_seam(*t, jnp.float32, True), *args)
    jd = vjp((jnp.asarray(a["dres"]), jnp.asarray(a["dh"])))
    ts = [torch.from_numpy(a[k]).requires_grad_()
          for k in ("x", "y", "yb", "w", "b")]
    xp, h = bf.add_ln_cast(*ts, EPS)
    torch.autograd.backward([xp, h], [torch.from_numpy(a["dres"]),
                                      torch.from_numpy(a["dh"])])
    assert torch.equal(xp.detach(), torch.from_numpy(_f32(jxp)))
    assert _steps(h.detach(), jh, torch.float32) <= 1
    for t, g in zip(ts, jd):
        _close(t.grad, g, torch.float32)


@pytest.mark.parametrize("residual_dtype", ["bf16", "f32"])
def test_ln_cast_reads_a_transposed_y(residual_dtype):
    """The temporal sublayer's product [B, N, T, D] goes in as its
    transposed view [B, T, N, D]: the same x', h and gradients as from the
    contiguous copy, and as flax's swapaxes."""
    xdt, jxdt = DT[residual_dtype]
    a = _inputs((2, 3, 5), 64, 30)
    ybnt = np.ascontiguousarray(a["y"].transpose(0, 2, 1, 3))
    y_view = _t(ybnt, torch.bfloat16).transpose(1, 2)
    assert not y_view.is_contiguous()
    outs = {}
    for name, y in (("view", y_view), ("copy", y_view.contiguous())):
        x = _t(a["x"], xdt).requires_grad_()
        y = y.detach().requires_grad_()
        yb = torch.from_numpy(a["yb"]).requires_grad_()
        xp, h = bf.add_ln_cast(x, y, yb, torch.from_numpy(a["w"]),
                               torch.from_numpy(a["b"]), EPS)
        torch.autograd.backward([xp, h], [_t(a["dres"], xdt),
                                          _t(a["dh"], torch.bfloat16)])
        outs[name] = (xp, h, x.grad, y.grad, yb.grad)
    for got, want in zip(outs["view"], outs["copy"]):
        assert torch.equal(got, want)
    jxp, jh = _jax_seam(_j(a["x"], jxdt),
                        jnp.swapaxes(_j(ybnt, jnp.bfloat16), 1, 2),
                        jnp.asarray(a["yb"]), jnp.asarray(a["w"]),
                        jnp.asarray(a["b"]), jnp.bfloat16, True)
    assert torch.equal(outs["view"][0].detach().float(),
                       _t(_f32(jxp), torch.float32))
    assert _steps(outs["view"][1].detach(), jh, torch.bfloat16) <= 1


@pytest.mark.parametrize("n", [256, 768, 3072])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_bias_gelu_matches_flax(dtype, n):
    """g and its gradients against JAX's GELU taken in f32 on the same
    rounded pre-activation (g within one step of the dtype, the
    gradients by the model rule), and against flax's MLP arithmetic,
    nn.gelu of the Dense output in the compute dtype (relative norms:
    in bf16 XLA rounds each of the GELU's intermediates to bf16)."""
    cdt, jcdt = DT[dtype]
    y_np, b_np = _np((7, 5, n), 40 + n, 2.0), _np((n,), 41 + n, 0.5)
    dg_np = _np((7, 5, n), 42 + n)
    jy, jb, jdg = _j(y_np, jcdt), jnp.asarray(b_np), _j(dg_np, jcdt)
    g_flax, vjp = jax.vjp(lambda y, b: nn.gelu(y + b.astype(jcdt)), jy, jb)
    jdy_flax = vjp(jdg)[0]
    g_f32, vjp = jax.vjp(lambda y, b: nn.gelu(
        (y + b.astype(jcdt)).astype(jnp.float32)).astype(jcdt), jy, jb)
    jdy = vjp(jdg)[0]
    y = _t(y_np, cdt).requires_grad_()
    b = torch.from_numpy(b_np).requires_grad_()
    g = bf.bias_gelu(y, b)
    g.backward(_t(dg_np, cdt))
    assert g.dtype == cdt
    assert _steps(g.detach(), g_f32, cdt) <= 1
    _close(y.grad, jdy, cdt)
    _close_bias_grad(b.grad, jdy, cdt)
    rel = 2.0 ** -6 if dtype == "bf16" else 1e-5
    for got, want in ((g.detach(), g_flax), (y.grad, jdy_flax)):
        assert chip_smoke.rel_norm(got, _t(_f32(want), torch.float32)) <= rel


# ------------------------------------------------------------ plain versions

def _unfused_ln(x, y, yb, w, b, cd):
    """The blocks' op sequence before the fusion: Dense's bias add, the
    residual add, F.layer_norm in f32, the cast."""
    xp = x if y is None else x + (y + yb.to(cd)).to(x.dtype)
    return xp, F.layer_norm(xp.float(), w.shape, w, b, EPS).to(cd)


@pytest.mark.parametrize("xdt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("residual", [False, True],
                         ids=["ln_cast", "ln_cast_residual"])
def test_plain_ln_cast_is_the_unfused_sequence(residual, xdt):
    """ts::ln_cast's plain version (the CPU kernel) and its backward, bit
    for bit against autograd over _unfused_ln, every output and gradient."""
    a = _inputs((3, 9), 192, 50)
    cd = torch.bfloat16

    def leaves():
        x = _t(a["x"], xdt).requires_grad_()
        y = _t(a["y"], cd).requires_grad_() if residual else None
        p = [torch.from_numpy(a[k]).requires_grad_()
             for k in ("yb", "w", "b")]
        return x, y, p
    dres, dh = _t(a["dres"], xdt), _t(a["dh"], cd)
    x0, y0, (yb0, w0, b0) = leaves()
    xp0, h0 = _unfused_ln(x0, y0, yb0, w0, b0, cd)
    x1, y1, (yb1, w1, b1) = leaves()
    if residual:
        xp1, h1 = bf.add_ln_cast(x1, y1, yb1, w1, b1, EPS)
        torch.autograd.backward([xp0, h0], [dres, dh])
        torch.autograd.backward([xp1, h1], [dres, dh])
        assert torch.equal(xp0, xp1)
        pairs = [(y0, y1), (yb0, yb1)]
    else:
        h1 = bf.ln_cast(x1, w1, b1, cd, EPS)
        h0.backward(dh)
        h1.backward(dh)
        pairs = []
    assert torch.equal(h0, h1)
    for t0, t1 in [(x0, x1), (w0, w1), (b0, b1)] + pairs:
        assert torch.equal(t0.grad, t1.grad)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_plain_bias_gelu_is_the_unfused_sequence(dtype):
    """ts::bias_gelu's plain version and its backward (the pre-activation
    recomputed) bit for bit against autograd over Dense's bias add then
    F.gelu(approximate="tanh")."""
    y_np, b_np, dg_np = (_np((4, 6, 256), 60, 2.0), _np((256,), 61, 0.5),
                         _np((4, 6, 256), 62))
    outs = []
    for fused in (False, True):
        y = _t(y_np, dtype).requires_grad_()
        b = torch.from_numpy(b_np).requires_grad_()
        g = (bf.bias_gelu(y, b) if fused
             else F.gelu(y + b.to(dtype), approximate="tanh"))
        g.backward(_t(dg_np, dtype))
        outs.append((g, y.grad, b.grad))
    for t0, t1 in zip(*outs):
        assert torch.equal(t0, t1)


# ------------------------------------------------------------ the models

class _OpCount(TorchDispatchMode):
    """Counts the ts:: operators dispatched inside it, by name."""

    def __init__(self):
        super().__init__()
        self.ops = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith("ts."):
            self.ops[name] = self.ops.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


BASE = dict(num_classes=7, depth=2, dim=64, num_heads=2, patch=8,
            tubelet_t=2)
CLIP = (4, 4, 16, 16, 3)
MASK = np.array([True, False, True, False])


def _pair(attention, dtype, residual):
    jcd, tcd = DT[dtype][1], DT[dtype][0]
    jres, tres = DT[residual][1], DT[residual][0]
    clips = _np(CLIP, 3)
    jm = FlaxViT(compute_dtype=jcd, residual_dtype=jres,
                 attention=attention, **BASE)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(clips))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.05 * rng.standard_normal(v.shape))
        .astype(np.float32), params)
    tm = VideoViT(compute_dtype=tcd, residual_dtype=tres, frames=CLIP[1],
                  size=CLIP[2], attention=attention, device="cpu", **BASE)
    tm.load_state_dict(vit_state_dict_from_flax(params), strict=True)
    return jm, params, tm, clips


def _jax_loss(jm):
    def loss_fn(params, clips, flip_mask):
        x = jnp.where(flip_mask[:, None, None, None, None],
                      jnp.flip(clips, axis=1), clips)
        logits = jm.apply(params, x)
        labels = flip_mask.astype(jnp.int32)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                    labels[:, None], axis=1).mean()
    return loss_fn


@pytest.mark.parametrize("attention", ["factorized", "joint"])
def test_vit_step_runs_the_operators_and_matches_flax(attention):
    """One f32 VideoViT step (depth 2, dim 64): every block's LayerNorms
    and MLP activation go through the operators, forward and backward (a
    factorized block 3 ts::ln_cast and 1 ts::bias_gelu, a joint block 2
    and 1), and the loss and every gradient match jax.grad of the flax
    loss within 1e-4 of the largest gradient (tests/test_torch_train.py's
    rule)."""
    jm, params, tm, clips = _pair(attention, "f32", "f32")
    jl, jg = jax.value_and_grad(_jax_loss(jm))(params, jnp.asarray(clips),
                                                jnp.asarray(MASK))
    with _OpCount() as count:
        loss, _ = vit_loss(tm, torch.from_numpy(clips),
                           torch.from_numpy(MASK))
        loss.backward()
    ln = 3 if attention == "factorized" else 2
    depth = BASE["depth"]
    assert count.ops == {
        "ts.ln_cast.default": depth, "ts.ln_cast.residual": (ln - 1) * depth,
        "ts.ln_cast_bwd.default": depth,
        "ts.ln_cast_bwd.residual": (ln - 1) * depth,
        "ts.bias_gelu.default": depth, "ts.bias_gelu_bwd.default": depth}
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5, atol=1e-5)
    want = vit_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jg))
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in tm.named_parameters():
        torch.testing.assert_close(p.grad, want[name], atol=1e-4 * scale,
                                   rtol=1e-4, msg=name)


@pytest.mark.parametrize("attention", ["factorized", "joint"])
def test_vit_bf16_forward_matches_flax(attention):
    """The serving and training configuration (bf16 compute, bf16
    residual): logits within the bf16 model rule of the flax model's."""
    jm, params, tm, clips = _pair(attention, "bf16", "bf16")
    want = np.asarray(jm.apply(params, jnp.asarray(clips)))
    with torch.no_grad(), _OpCount() as count:
        got = tm(torch.from_numpy(clips))
    assert count.ops["ts.bias_gelu.default"] == BASE["depth"]
    np.testing.assert_allclose(got.numpy(), want, **BF16_RULE)


# ------------------------------------------------------------ the kernels

def _kernel_ln(x, y, yb, w, b, cd):
    """csrc/block_fusions.cu's LnCast in torch: the roundings of the
    residual in its order, mean = sum / D, var = sum((v - mean)^2) / D,
    rstd = 1 / sqrt(var + eps), h = (v - mean) rstd w + b in f32."""
    v = x.float()
    xp = None
    if y is not None:
        t = (y.float() + yb.to(cd).float()).to(cd)
        xp = (v + t.to(x.dtype).float()).to(x.dtype)
        v = xp.float()
    d = v.shape[-1]
    mean = v.sum(-1, keepdim=True) / d
    var = ((v - mean) ** 2).sum(-1, keepdim=True) / d
    rstd = 1.0 / torch.sqrt(var + EPS)
    h = ((v - mean) * rstd * w + b).to(cd)
    return xp, h, mean.squeeze(-1), rstd.squeeze(-1)


def _kernel_ln_bwd(dh, x, mean, rstd, w, dres, cd, residual):
    """LnCastBwd in torch: xhat, the two row means of dh w, dx rounded to
    x's dtype, dres added after that rounding, the column sums in f32, db
    of dx in cd, rounded to cd."""
    g = dh.float()
    xn = (x.float() - mean[..., None]) * rstd[..., None]
    gg = g * w
    mg = gg.mean(-1, keepdim=True)
    mgx = (gg * xn).mean(-1, keepdim=True)
    dx = (rstd[..., None] * (gg - mg - xn * mgx)).to(x.dtype)
    if dres is not None:
        dx = (dres.float() + dx.float()).to(x.dtype)
    rows = tuple(range(dx.dim() - 1))
    out = [dx, (g * xn).sum(rows), g.sum(rows)]
    if residual:
        out.append(dx.to(cd).float().sum(rows).to(cd).float())
    return out


def _kernel_gelu(y, b, cd):
    """BiasGelu and BiasGeluBwd's formulas in torch (ATen's, f32)."""
    u = (y.float() + b.to(cd).float()).to(cd).float()
    beta, kappa = 0.7978845608028654, 0.044715
    inner = beta * (u + kappa * u * u * u)
    th = torch.tanh(inner)
    g = 0.5 * u * (1 + th)
    grad = 0.5 * (1 + th) + 0.5 * u * (1 - th * th) * beta * (
        1 + 3 * kappa * u * u)
    return g.to(cd), grad


@pytest.mark.parametrize("case", chip_smoke.LN_CASES,
                         ids=[c[0] for c in chip_smoke.LN_CASES])
def test_kernel_arithmetic_holds_the_smoke_rules(case):
    """The LnCast and LnCastBwd arithmetic, emulated in torch at each of
    chip_smoke's LN_CASES (the card's shapes), against the plain versions
    under chip_smoke's bounds; the faults the rules must reject: the
    residual's gradient dropped, the variance taken with E[x^2] - E[x]^2
    in bf16 (lost), a wrong eps placement."""
    name, lead, d, xdt, cdt, y_layout = case
    x, y, yb, w, b = chip_smoke.ln_case_inputs(lead, d, xdt, cdt, y_layout,
                                               90, "cpu")
    xp_p, h_p, mean_p, rstd_p = bf.ln_cast_plain(x, w, b, EPS, cdt, y, yb)
    xp, h, mean, rstd = _kernel_ln(x, y, yb, w, b, cdt)
    steps = chip_smoke.FUSION_STEPS[cdt]
    assert chip_smoke.within_steps(h, h_p, steps) <= 1
    assert chip_smoke.rel_norm(rstd, rstd_p) <= 1e-5
    src = x if y is None else xp
    if y is not None:
        assert torch.equal(xp, xp_p)
    dh = chip_smoke._seeded(h.shape, 95).to(cdt)
    dres = None if y is None else chip_smoke._seeded(h.shape, 96).to(xdt)
    want = bf.ln_cast_bwd_plain(dh, src, mean, rstd, w, dres,
                                None if y is None else cdt)
    got = _kernel_ln_bwd(dh, src, mean, rstd, w, dres, cdt, y is not None)
    assert chip_smoke.rel_norm(got[0], want[0]) <= \
        chip_smoke.FUSION_GRAD_REL[xdt]
    for g, wt in zip(got[1:3], want[1:3]):
        assert chip_smoke.rel_norm(g, wt) <= chip_smoke.FUSION_SUM_REL
    if y is not None:
        assert chip_smoke.rel_norm(got[3], want[3]) <= \
            chip_smoke.FUSION_DB_REL[cdt]
        lost = _kernel_ln_bwd(dh, src, mean, rstd, w, None, cdt, True)[0]
        assert chip_smoke.rel_norm(lost, want[0]) > \
            chip_smoke.FUSION_GRAD_REL[xdt]
    # Faults: eps outside the square root; the statistics of x before the
    # residual add.
    v = src.float()
    bad = ((v - mean[..., None]) * (1 / (torch.sqrt(
        ((v - mean[..., None]) ** 2).mean(-1, keepdim=True)) + 0.05))
           * w + b).to(cdt)
    assert chip_smoke.within_steps(bad, h_p, steps) > 1
    if y is not None:
        stale = _kernel_ln(x, None, None, w, b, cdt)[1]
        assert chip_smoke.within_steps(stale, h_p, steps) > 1


@pytest.mark.parametrize("case", chip_smoke.GELU_CASES,
                         ids=[c[0] for c in chip_smoke.GELU_CASES])
def test_kernel_gelu_arithmetic_holds_the_smoke_rules(case):
    """BiasGelu and BiasGeluBwd emulated at chip_smoke's GELU_CASES shapes
    against the plain versions under chip_smoke's bounds; the fault: the
    derivative without its tanh' term."""
    name, lead, n, cdt = case
    y = chip_smoke._seeded((*lead, n), 97, 2.0).to(cdt)
    b = chip_smoke._seeded((n,), 98, 0.5)
    dg = chip_smoke._seeded((*lead, n), 99).to(cdt)
    g, grad = _kernel_gelu(y, b, cdt)
    steps = chip_smoke.FUSION_STEPS[cdt]
    assert chip_smoke.within_steps(g, bf.bias_gelu_plain(y, b), steps) <= 1
    dy = (dg.float() * grad).to(cdt)
    want = bf.bias_gelu_bwd_plain(dg, y, b)
    assert chip_smoke.rel_norm(dy, want[0]) <= chip_smoke.FUSION_GRAD_REL[cdt]
    db = dy.float().reshape(-1, n).sum(0).to(cdt).float()
    assert chip_smoke.rel_norm(db, want[1]) <= chip_smoke.FUSION_DB_REL[cdt]
    u = (y.float() + b.to(cdt).float()).to(cdt).float()
    half = (dg.float() * 0.5 * (1 + torch.tanh(
        0.7978845608028654 * (u + 0.044715 * u ** 3)))).to(cdt)
    assert chip_smoke.rel_norm(half, want[0]) > \
        chip_smoke.FUSION_GRAD_REL[cdt]


def test_counts_stay_zero_on_the_cpu():
    bf.reset_counts()
    x = torch.randn(3, 64)
    w, b = torch.ones(64), torch.zeros(64)
    bf.ln_cast(x, w, b, torch.bfloat16, EPS)
    bf.bias_gelu(x, b)
    assert set(bf.launches.values()) == {0}
    assert set(bf.recompute_launches.values()) == {0}


def test_the_wrappers_refuse_what_the_kernel_cannot_read():
    """A CPU tensor beside a CUDA one, a width the kernel does not take
    and rows it cannot read with 16-byte loads raise; nothing falls back."""
    x = torch.randn(4, 64)
    with pytest.raises(ValueError, match="CUDA"):
        bf._ln_cast_cuda(x, torch.ones(64), torch.zeros(64), EPS,
                         torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        bf._rows(torch.randn(4, 66)[:, :64], "x")
    assert tuple(bf._rows(torch.randn(2, 3, 5, 8).transpose(1, 2), "y")) \
        == (5, 3, 120, 8, 40)
    assert tuple(bf._rows(torch.randn(7, 8), "x")) == (1, 7, 0, 0, 8)
