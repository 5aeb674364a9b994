"""The port's serving export (tensor_stream_torch/export.py) on the CPU:
a bit-exact round trip, one batch-polymorphic artifact serving batches 1,
2 and 5, the ts:: custom ops in the exported graphs (and no plain
version inlined in their place), a trace that reads no tensor's storage,
the custom ops' fake implementations against their real ones, and the
loaded artifacts against the JAX package's exported programs
(tests/test_export.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tensor_stream_tpu.enums import FourCC as JFourCC
from tensor_stream_tpu.enums import Planes as JPlanes
from tensor_stream_tpu.enums import ResizeType as JResizeType
from tensor_stream_tpu.export import export_inference as jax_export
from tensor_stream_tpu.export import load_inference as jax_load
from tensor_stream_tpu.models.video_vit import VideoViT as FlaxViT
from tensor_stream_tpu.ops.vpp import VPPConfig as JVPPConfig
from tensor_stream_tpu.ops.vpp import make_vpp_fn as jax_make_vpp_fn
from tensor_stream_torch import export_inference, load_inference
from tensor_stream_torch.enums import FourCC, Planes, ResizeType
from tensor_stream_torch.models import VideoViT, vit_state_dict_from_flax
from tensor_stream_torch.ops import flash_attention as fa
from tensor_stream_torch.ops.vpp import VPPConfig, make_vpp_fn

CFG = dict(num_classes=2, depth=2, dim=32, num_heads=2, patch=8,
           tubelet_t=2)
CLIP = (2, 4, 32, 32, 3)
# The f32 tolerance of tests/test_torch_video_vit.py: the same f32 math in
# another reduction order.
VIT_TOL = 1e-4


def vit(use_flash=True, seed=0):
    return VideoViT(compute_dtype=torch.float32, attention="joint",
                    use_flash=use_flash, frames=CLIP[1], size=CLIP[2],
                    device="cpu", generator=torch.Generator().manual_seed(
                        seed), **CFG)


def clips(b, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).uniform(
        0, 1, (b,) + CLIP[1:]).astype(np.float32))


def vpp_cfg(**kw):
    return dict(src_width=128, src_height=96, width=64, height=64,
                resize_type=ResizeType.BILINEAR, fourcc=FourCC.RGB24,
                planes=Planes.MERGED, normalization=False, **kw)


def nv12(b=None, seed=0):
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    return (torch.from_numpy(rng.integers(0, 255, lead + (96, 128),
                                          np.uint8)),
            torch.from_numpy(rng.integers(0, 255, lead + (48, 128),
                                          np.uint8)))


def targets(program):
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function"]


def test_model_roundtrip_bitexact(tmp_path):
    model = vit()
    path = str(tmp_path / "vit.pt2")
    x = clips(2)
    export_inference(model, (x,), path)
    serve = load_inference(path, device="cpu")
    with torch.no_grad():
        want = model(x)
    got = serve(x)
    assert not got.requires_grad
    assert torch.equal(got, want)


def test_batch_polymorphic_export(tmp_path):
    """Exported once with a symbolic batch, from the file's bytes: serves
    batch 1, 2 and 5, each bit-equal to the module."""
    model = vit()
    path = tmp_path / "vit_poly.pt2"
    export_inference(model, (clips(2),), str(path), batch_poly=True)
    serve = load_inference(path.read_bytes(), device="cpu")
    for b in (1, 2, 5):
        x = clips(b, seed=b)
        got = serve(x)
        with torch.no_grad():
            want = model(x)
        assert got.shape == (b, 2)
        assert torch.equal(got, want)


def test_exported_graphs_call_the_ts_ops():
    """The ViT's attention is one ts::flash_fwd a block (no softmax, no
    mask, no materialized logits inlined); the VPP program is the resize
    op and the NV12 op and nothing else but their outputs' unpacking."""
    program = export_inference(vit(), (clips(2),), batch_poly=True)
    ops = targets(program)
    assert ops.count("ts.flash_fwd.default") == CFG["depth"]
    assert not [t for t in ops if "softmax" in t or "where" in t
                or t.startswith("aten.exp")]
    vpp = export_inference(make_vpp_fn(VPPConfig(**vpp_cfg())), nv12(3),
                           batch_poly=True)
    assert [t for t in targets(vpp) if "getitem" not in t] == [
        "ts.resize_bilinear_nv12.default", "ts.nv12_to_rgb.default"]


def test_export_reads_no_storage(monkeypatch):
    """Tracing the flash ViT and the VPP program on the CPU reads no
    tensor's data_ptr(): the pointer checks live in the ops' CUDA bodies,
    which a trace never runs."""
    model, x = vit(), clips(2)
    fn = make_vpp_fn(VPPConfig(**vpp_cfg()))
    y, uv = nv12(2)

    def refuse(self):
        raise AssertionError("data_ptr() read while tracing")
    monkeypatch.setattr(torch.Tensor, "data_ptr", refuse)
    export_inference(model, (x,), batch_poly=True)
    export_inference(fn, (y, uv), batch_poly=True)


def check_fake(op, args):
    """The op's fake outputs (under a FakeTensorMode) against its real
    ones: shapes, dtypes and strides."""
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args])
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (tuple(r.shape), r.dtype, r.stride()) == (
            tuple(f.shape), f.dtype, f.stride())


def _bshd(b, s, h, d, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, s, h, d), generator=g, dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("op", ["nv12_to_rgb", "flash_fwd", "flash_bwd",
                                "resize_bilinear_nv12", "resize_bicubic_nv12",
                                "resize_area_down_nv12"])
def test_fake_matches_the_real_op(op):
    """torch.library.opcheck on the CPU: the schema, and the fake
    implementation's shapes, dtypes and strides against the real op's
    (a [B, S, H, d] view's stride order for the flash ops; flash_fwd
    with its residuals overload)."""
    if op == "nv12_to_rgb":
        y, uv = nv12(2)
        cases = [(y, uv, False, planar, norm, 1) for planar in (False, True)
                 for norm in (False, True)]
    elif op.startswith("flash"):
        q, k, v = (_bshd(2, 40, 2, 32, torch.float32, s) for s in (1, 2, 3))
        fwd = [(q, k, v, causal, window, 0.2)
               for causal, window in ((False, 0), (True, 0), (True, 9))]
        if op == "flash_fwd":
            # opcheck refuses an operator with overloads: the fakes of
            # ts::flash_fwd and ts::flash_fwd.residuals against the real
            # outputs by hand.
            for args in fwd:
                for overload in (torch.ops.ts.flash_fwd.default,
                                 torch.ops.ts.flash_fwd.residuals):
                    check_fake(overload, args)
            o = torch.ops.ts.flash_fwd(q, k, v, False, 0, 0.2)
            assert o.stride() == q.stride()  # [B, S, H, d] order kept
            return
        else:
            o, l, m = torch.ops.ts.flash_fwd.residuals(q, k, v, True, 0, 0.2)
            do = _bshd(2, 40, 2, 32, torch.float32, 4)
            cases = [(q, k, v, o, l, m, do, True, 0, 0.2)]
    else:
        y, uv = nv12(2)
        kind = {"resize_bilinear_nv12": ResizeType.BILINEAR,
                "resize_bicubic_nv12": ResizeType.BICUBIC,
                "resize_area_down_nv12": ResizeType.AREA}[op]
        cases = [(y, uv, 64, 48, kind.value)]
    for args in cases:
        torch.library.opcheck(getattr(torch.ops.ts, op), args,
                              test_utils=("test_schema", "test_faketensor"))


def test_loaded_vit_matches_jax_load_inference(tmp_path):
    """The flax ViT's weights converted into the port's model: the port's
    loaded artifact against JAX's loaded artifact on the same clips, at
    the f32 tolerance of tests/test_torch_video_vit.py."""
    x = clips(3, seed=4).numpy()
    jm = FlaxViT(compute_dtype=jnp.float32, attention="joint",
                 use_flash=True, flash_impl="pallas", **CFG)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jax_export(lambda c: jm.apply(params, c), (jnp.asarray(x),),
               str(tmp_path / "vit.shlo"), platforms=("cpu",),
               batch_poly=True)
    want = np.asarray(jax_load(str(tmp_path / "vit.shlo"))(jnp.asarray(x)))
    model = vit()
    model.load_state_dict(vit_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    export_inference(model, (clips(2),), str(tmp_path / "vit.pt2"),
                     batch_poly=True)
    got = load_inference(str(tmp_path / "vit.pt2"), device="cpu")(
        torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=VIT_TOL, atol=VIT_TOL)


@pytest.mark.parametrize("resize", ["BILINEAR", "BICUBIC", "AREA"])
def test_exported_vpp_bytes_equal_jax(tmp_path, resize):
    """The VPP program (tests/test_export.py:60's, with each device
    resize) exported by both packages and reloaded: the same bytes."""
    cfg = vpp_cfg()
    cfg["resize_type"] = ResizeType[resize]
    jcfg = JVPPConfig(**{**cfg, "resize_type": JResizeType[resize],
                         "fourcc": JFourCC.RGB24,
                         "planes": JPlanes.MERGED})
    y, uv = nv12(seed=7)
    jvpp = jax_make_vpp_fn(jcfg)
    jax_export(jvpp, (jnp.asarray(y.numpy()), jnp.asarray(uv.numpy())),
               str(tmp_path / "vpp.shlo"), platforms=("cpu",))
    want = np.asarray(jax_load(str(tmp_path / "vpp.shlo"))(
        jnp.asarray(y.numpy()), jnp.asarray(uv.numpy())))
    export_inference(make_vpp_fn(VPPConfig(**cfg)), (y, uv),
                     str(tmp_path / "vpp.pt2"))
    got = load_inference(str(tmp_path / "vpp.pt2"), device="cpu")(y, uv)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_flash_ops_count_no_launch_on_the_cpu():
    """On CPU tensors the ops run the plain versions: no launch counted."""
    before = (fa.launches, fa.bwd_launches)
    export_inference(vit(), (clips(1),))
    load_inference(export_inference(vit(), (clips(1),)), device="cpu")(
        clips(1))
    assert (fa.launches, fa.bwd_launches) == before
