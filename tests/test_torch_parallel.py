"""The port's sharding layer, sharded loaders and meshed checkpoints against
the JAX package, on 4 gloo ranks on the CPU (tests/test_parallel.py and
tests/test_checkpoint.py run the JAX side on 8 devices; here the JAX
loaders take 4 of its CPU devices, so that both packages shard each batch
four ways).

* ``make_mesh``: the near-square factoring, and no mesh without a process
  group; ``multi_stream_round_robin``;
* ``vpp_batch_sharded`` (rows over "mp" gathered, the VPP on each rank's
  batch) byte-equal to the JAX ``vpp_numpy`` frame by frame;
* ``build_train_step``: the TransformerNet step over ("dp", "mp") descends;
* ``ShardedClipLoader``, ``ShardedClipDataset`` and ``ShardedStreamLoader``
  on ``tests/fixtures/``: every rank decodes its own share, and the global
  DTensor batches, starts and labels equal the JAX loaders' (epoch order,
  no clip twice in an epoch, the zero-batch epoch refused, ``state()``
  resume, augmentation keyed by clip identity whatever the shard); their
  RGB bytes within the packages' documented one-step colour rule
  (tests/test_torch_color.py, docs/PARITY.md "Float-contraction
  freedom"), and the port's sharded bytes equal to its single-device
  loader's;
* ``TrainCheckpointer`` on a meshed ViT state (DTensor parameters and Adam
  state): restored bit-equal on the same mesh, and onto a mesh of another
  shape following the template's placements.

One spawn serves every test (a module fixture); the JAX side runs in this
process meanwhile.
"""
import os

import numpy as np
import pytest
import torch

from torch_spawn import start

WORLD = 4
FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
FIX = os.path.join(FIXDIR, "bbb_720x480_RGB24_250.h264")
FILES = [os.path.join(FIXDIR, "synthetic_640x360_120.h265"),
         os.path.join(FIXDIR, "synthetic_640x360_90_vp9.ivf")]
CURSOR = {"stream_url": "x.mp4", "epoch": 2, "start_clip": 13, "seed": 5}


def vpp_cfg(pkg, height):
    return pkg.VPPConfig(src_width=128, src_height=96, width=64,
                         height=height,
                         resize_type=pkg.ResizeType.BILINEAR,
                         fourcc=pkg.FourCC.RGB24, planes=pkg.Planes.MERGED,
                         normalization=True)


def nv12(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 255, (n, 96, 128), np.uint8),
            rng.integers(0, 255, (n, 48, 128), np.uint8))


def loader_kwargs(enums):
    return dict(host_resize=True, width=64, height=64,
                pixel_format=enums.FourCC.RGB24,
                planes_pos=enums.Planes.PLANAR, normalization=True)


U8_STEP = 1.0 / 255 + 1e-7   # tests/test_torch_color.py


def colour_rule(got, want):
    """The one-step colour rule of RGB bytes between the packages."""
    diff = np.abs(np.asarray(got) - np.asarray(want))
    assert diff.max() <= U8_STEP and (diff == 0).mean() >= 0.9999


class _Pkg:
    def __init__(self, vpp, enums):
        self.VPPConfig = vpp.VPPConfig
        self.ResizeType, self.FourCC = enums.ResizeType, enums.FourCC
        self.Planes = enums.Planes


def _whole(x):
    return x.full_tensor().numpy()


def _ranks(rank, world, ckpt_dir):
    from tensor_stream_torch import (AugmentConfig, ClipLoader,
                                     ShardedClipDataset, ShardedClipLoader,
                                     ShardedStreamLoader, TrainCheckpointer,
                                     enums)
    from tensor_stream_torch.models import VideoViT, gram_matrix
    from tensor_stream_torch.ops import vpp
    from tensor_stream_torch.parallel import (build_train_step, make_mesh,
                                              make_train_state,
                                              multi_stream_round_robin,
                                              vpp_batch_sharded)
    out = {}
    mesh = make_mesh(device="cpu")
    out["mesh"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
    out["round_robin"] = multi_stream_round_robin(10, mesh)
    pkg = _Pkg(vpp, enums)
    ys, uvs = nv12(4, 0)
    out["vpp"] = _whole(vpp_batch_sharded(vpp_cfg(pkg, 48), mesh,
                                          torch.from_numpy(ys),
                                          torch.from_numpy(uvs)))
    # The NV12 and resize operators on DTensors over "dp": their sharding
    # rules run the kernels' CPU twins on each rank's frames.
    from tensor_stream_torch.parallel.sharding import distribute
    y, uv = (distribute(torch.from_numpy(a), mesh, ("dp",))
             for a in (ys, uvs))
    ry, ruv = torch.ops.ts.resize_bilinear_nv12(
        y, uv, 64, 48, enums.ResizeType.BILINEAR.value)
    rgb = torch.ops.ts.nv12_to_rgb(ry, ruv, False, False, True,
                                   enums.ColorStandard.BT601.value)
    out["op_rules"] = ([str(p) for p in rgb.placements], _whole(rgb))
    # ts::clip_augment on DTensors over "dp": clips and parameter rows
    # sharded alike, each clip augmented on its rank (the contrast mean is
    # per clip).
    from tensor_stream_torch.ops import augment
    aug = AugmentConfig(width=24, height=20, scale=(0.3, 1.0), hflip=0.5,
                        brightness=0.4, contrast=0.4, mean=(0.45,) * 3,
                        std=(0.225,) * 3, erase=0.5)
    clips = np.random.default_rng(3).random((4, 2, 3, 30, 40), np.float32)
    rows = augment.sample_clip_params(aug, 30, 40, 1, np.stack(
        [np.zeros(4), np.arange(4)], axis=1))
    args = (True, 20, 24, augment.op_flags(aug), list(aug.mean),
            list(aug.std), 1.0, False, torch.float32)
    got = torch.ops.ts.clip_augment(
        *(distribute(torch.from_numpy(a), mesh, ("dp",))
          for a in (clips, rows)), *args)
    out["aug_rule"] = ([str(p) for p in got.placements], _whole(got),
                       torch.ops.ts.clip_augment(
                           torch.from_numpy(clips), torch.from_numpy(rows),
                           *args).numpy())
    model, opt = make_train_state(mesh, 64, 64, batch=8,
                                  generator=torch.Generator().manual_seed(0))
    step = build_train_step(mesh, model, opt, vpp_cfg(pkg, 64))
    ys, uvs = nv12(8, 1)
    style = gram_matrix(torch.zeros(1, 64, 64, 3))
    out["train_losses"] = [float(step(torch.from_numpy(ys),
                                      torch.from_numpy(uvs), style))
                           for _ in range(3)]
    out["conv_local"] = tuple(model.convs[1].weight.to_local().shape)

    dp = make_mesh(axes=("dp",), device="cpu")
    kw = loader_kwargs(enums)
    loader = ShardedClipLoader(FIX, clip_len=4, per_device=2, seed=11,
                               workers=2, mesh=dp, **kw)
    out["clip_len"], out["clip_batch"] = len(loader), loader.batch
    batches, starts = [], []
    for clips, st in loader:
        batches.append(_whole(clips))
        starts.append(st)
        out["clip_placements"] = [str(p) for p in clips.placements]
    out["clip_batches"], out["clip_starts"] = batches, starts
    _, out["epoch1_first"] = next(loader)
    out["epoch1_state"] = state = loader.state()
    out["epoch1_rest"] = [int(s) for _, st in loader for s in st]
    loader.close()
    with ShardedClipLoader(FIX, clip_len=4, per_device=2, seed=11,
                           workers=2, mesh=dp, epoch=state["epoch"],
                           start_clip=state["start_clip"], **kw) as resumed:
        out["resumed_rest"] = [int(s) for _, st in resumed for s in st]
    try:
        ShardedClipLoader(FIX, clip_len=4, per_device=16, workers=1,
                          mesh=dp, **kw)
    except ValueError as e:
        out["zero_batch_error"] = str(e)

    aug = AugmentConfig(width=48, height=48, scale=(0.4, 1.0), hflip=0.5,
                        brightness=0.3, contrast=0.3)
    akw = dict(clip_len=4, seed=11, workers=2, augment=aug, **kw)
    with ClipLoader(FIX, batch=4, device="cpu", **akw) as single:
        want, want_starts = next(single)
    with ShardedClipLoader(FIX, per_device=1, mesh=dp, **akw) as sharded:
        got, got_starts = next(sharded)
    out["aug_equal"] = (bool(torch.equal(got.full_tensor(), want))
                        and list(got_starts) == list(want_starts))

    dkw = dict(clip_len=4, seed=3, per_device=1, workers=1, mesh=dp, **kw)
    with ShardedClipDataset(FILES, max_open=1, **dkw) as ds:
        out["ds_len"] = len(ds)
        out["ds"] = [(_whole(c), lab) for c, lab in ds]
    with ShardedClipDataset(FILES, augment=AugmentConfig(), **dkw) as ds:
        c, lab = next(ds)
        out["ds_identity"] = (_whole(c), lab)
    daug = AugmentConfig(width=48, height=48, scale=(0.4, 1.0), hflip=0.5,
                         brightness=0.4)
    runs = []
    for _ in range(2):
        with ShardedClipDataset(FILES, augment=daug, **dkw) as ds:
            c, lab = next(ds)
            runs.append((_whole(c), lab))
    out["ds_aug"] = runs

    with ShardedStreamLoader([FIX] * world, per_stream=4, mesh=dp,
                             resize_type=enums.ResizeType.BILINEAR,
                             buffer_size=16, **kw) as streams:
        batch, indices = next(streams)
        out["stream"] = _whole(batch), indices

    # A meshed ViT state through the checkpointer: the parameters laid out
    # by vit_param_specs, Adam's moments made by one step on set gradients.
    from tensor_stream_torch.models import vit_param_specs
    from tensor_stream_torch.parallel.sharding import shard_params
    vit_kw = dict(num_classes=2, depth=2, dim=32, num_heads=4, patch=8,
                  frames=4, size=16, device="cpu",
                  compute_dtype=torch.float32)

    def meshed_vit(shape, seed):
        m = make_mesh(axes=("dp", "mp"), shape=shape, device="cpu")
        model = VideoViT(**vit_kw,
                         generator=torch.Generator().manual_seed(seed))
        shard_params(model, m, vit_param_specs(model, mesh=m))
        return model, torch.optim.Adam(model.parameters(), lr=1e-3)
    vit, opt = meshed_vit((2, 2), 0)
    for i, p in enumerate(vit.parameters()):
        p.grad = torch.full_like(p, 0.01 * (i + 1))
    opt.step()
    saved = {n: _whole(t) for n, t in vit.state_dict().items()}
    ckpt = TrainCheckpointer(ckpt_dir)
    out["saved_new"] = ckpt.save(7, {"model": vit, "opt": opt},
                                 loader_state=CURSOR)
    with torch.no_grad():
        for p in vit.parameters():
            p.zero_()
    step, state, cursor = ckpt.restore(template={"model": vit, "opt": opt})
    out["restored"] = (step, cursor, all(
        np.array_equal(_whole(t), saved[n])
        for n, t in vit.state_dict().items()))
    other, opt_b = meshed_vit((1, 4), 9)
    ckpt.restore(step=7, template={"model": other, "opt": opt_b})
    q = other.blocks[0].attn_s.query.weight
    out["resharded"] = (all(np.array_equal(_whole(t), saved[n])
                            for n, t in other.state_dict().items()),
                        tuple(q.to_local().shape), tuple(q.shape),
                        all(np.array_equal(_whole(opt_b.state[pb]["exp_avg"]),
                                           _whole(opt.state[pa]["exp_avg"]))
                            for pa, pb in zip(vit.parameters(),
                                              other.parameters())))
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from tensor_stream_tpu import (ShardedClipDataset, ShardedClipLoader,
                                   ShardedStreamLoader, enums)
    from tensor_stream_tpu.ops import vpp

    ranks = start(_ranks, WORLD, tmp_path_factory.mktemp("par"),
                  str(tmp_path_factory.mktemp("ckpt")))
    want = {}
    devices = jax.devices()[:WORLD]
    cfg = vpp_cfg(_Pkg(vpp, enums), 48)
    ys, uvs = nv12(4, 0)
    want["vpp"] = np.stack([vpp.vpp_numpy(cfg, y, uv)
                            for y, uv in zip(ys, uvs)])
    kw = loader_kwargs(enums)
    with ShardedClipLoader(FIX, clip_len=4, per_device=2, seed=11,
                           workers=2, devices=devices, **kw) as loader:
        want["clip_len"] = len(loader)
        epoch = [(np.asarray(c), [int(s) for s in st]) for c, st in loader]
        want["clip_batches"] = [c for c, _ in epoch]
        want["clip_starts"] = [st for _, st in epoch]
        _, first = next(loader)
        want["epoch1_first"] = [int(s) for s in first]
    dkw = dict(clip_len=4, seed=3, per_device=1, workers=1, devices=devices,
               **kw)
    with ShardedClipDataset(FILES, max_open=1, **dkw) as ds:
        want["ds_len"] = len(ds)
        want["ds"] = [(np.asarray(c), lab) for c, lab in ds]
    with ShardedStreamLoader([FIX] * WORLD, per_stream=4, devices=devices,
                             resize_type=enums.ResizeType.BILINEAR,
                             buffer_size=16, **kw) as streams:
        batch, indices = next(streams)
        want["stream"] = np.asarray(batch), indices
    return ranks.results(), want


def test_make_mesh_needs_a_process_group():
    from tensor_stream_torch.parallel import make_mesh
    from tensor_stream_torch.parallel.sharding import factor
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")
    assert factor(8) == (4, 2) and factor(6) == (3, 2)
    assert factor(4) == (2, 2) and factor(1) == (1, 1)


def test_mesh_factoring_and_round_robin(results):
    r = results[0][0]
    assert r["mesh"] == {"dp": 2, "mp": 2}
    mapping = r["round_robin"]
    assert len(mapping) == 10 and mapping[0] == mapping[4] == 0
    assert sorted(set(mapping.values())) == list(range(WORLD))


def test_sharded_vpp_matches_single_device(results):
    got, want = results
    for r in got:
        np.testing.assert_array_equal(r["vpp"], want["vpp"])


def test_vpp_operators_run_on_each_ranks_frames(results):
    """ts::resize_bilinear_nv12 then ts::nv12_to_rgb called on DTensors
    sharded over "dp": the rules keep the batch sharded, and the bytes
    are the sharded VPP's (the same two kernels)."""
    for r in results[0]:
        placements, rgb = r["op_rules"]
        assert placements == ["S(0)", "R"]
        np.testing.assert_array_equal(rgb, r["vpp"])


def test_clip_augment_operator_runs_on_each_ranks_clips(results):
    """ts::clip_augment called on DTensors sharded over "dp": its rule
    keeps clips and parameter rows sharded, and the clips are the
    single-device operator's."""
    for r in results[0]:
        placements, got, want = r["aug_rule"]
        assert placements == ["S(0)", "R"]
        np.testing.assert_array_equal(got, want)


def test_sharded_train_step_runs_and_descends(results):
    for r in results[0]:
        losses = r["train_losses"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0], losses
    assert results[0][0]["train_losses"] == results[0][3]["train_losses"]
    # conv 2 has 64 output channels, 32 a rank over mp = 2.
    assert results[0][0]["conv_local"][0] == 32


def test_sharded_clip_loader_matches_jax(results):
    got, want = results
    r = got[0]
    assert r["clip_batch"] == 8 and r["clip_len"] == want["clip_len"] == 7
    assert r["clip_placements"] == ["S(0)"]
    assert r["clip_starts"] == want["clip_starts"]
    for g, w in zip(r["clip_batches"], want["clip_batches"]):
        colour_rule(g, w)
    seen = [s for st in r["clip_starts"] for s in st]
    assert len(seen) == 56 and len(set(seen)) == 56
    assert [int(s) for s in r["epoch1_first"]] == want["epoch1_first"]
    for other in got[1:]:          # every rank hands out the same batches
        assert other["clip_starts"] == r["clip_starts"]


def test_sharded_clip_loader_resume(results):
    r = results[0][0]
    assert r["epoch1_state"]["epoch"] == 1
    assert r["epoch1_state"]["start_clip"] == 8
    assert r["resumed_rest"] == r["epoch1_rest"]
    assert len(r["epoch1_rest"]) == 48


def test_sharded_clip_loader_rejects_zero_batch_epochs(results):
    assert "clip starts per epoch" in results[0][0]["zero_batch_error"]


def test_sharded_clip_loader_augment_matches_single_device(results):
    assert all(r["aug_equal"] for r in results[0])


def test_sharded_clip_dataset_matches_jax(results):
    got, want = results
    r = got[0]
    assert r["ds_len"] == want["ds_len"] == 13
    assert len(r["ds"]) == len(want["ds"])
    for (c, lab), (wc, wlab) in zip(r["ds"], want["ds"]):
        assert lab == wlab
        colour_rule(c, wc)
    seen = [tuple(x) for _, lab in r["ds"] for x in lab]
    assert len(seen) == 52 and len(set(seen)) == 52
    assert {x[0] for x in seen} == {0, 1}


def test_sharded_clip_dataset_augment_keys_by_corpus_identity(results):
    r = results[0][0]
    plain, labels = r["ds"][0]
    fused, labels1 = r["ds_identity"]
    assert labels1 == labels
    np.testing.assert_array_equal(fused, plain)
    (a, la), (b, lb) = r["ds_aug"]
    assert la == lb and a.shape == (4, 4, 3, 48, 48)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a[0], a[1])


def test_sharded_stream_loader_matches_jax(results):
    got, want = results
    batch, indices = got[0]["stream"]
    want_batch, want_indices = want["stream"]
    assert batch.shape == (16, 3, 64, 64)
    assert indices == want_indices
    assert all(indices[k] == [1, 2, 3, 4] for k in range(WORLD))
    colour_rule(batch, want_batch)
    means = batch.mean(axis=(1, 2, 3)).reshape(WORLD, 4)
    assert np.allclose(means, means[0], atol=1e-6)


def test_checkpoint_roundtrip_same_mesh(results):
    for r in results[0]:
        assert r["saved_new"]
        assert r["restored"] == (7, CURSOR, True)


def test_checkpoint_restore_reshards_to_new_mesh(results):
    for r in results[0]:
        equal, local, whole, opt_equal = r["resharded"]
        assert equal and opt_equal
        assert local == (whole[0] // 4, whole[1])
