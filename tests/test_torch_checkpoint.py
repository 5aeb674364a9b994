"""The port's TrainCheckpointer (tensor_stream_torch/checkpoint.py) on the
CPU: retention and latest step against the JAX package's
TrainCheckpointer, the loader cursor, an idempotent second save, a
restore without a template, bit-equal resume of the ViT step with Adam
and of the conditional DiT step with its generator, and a restore that
writes into the template's own storage."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tensor_stream_tpu.checkpoint import TrainCheckpointer as JaxCheckpointer
from tensor_stream_torch import ClipLoader, TrainCheckpointer
from tensor_stream_torch.models import (DiffusionSchedule, VideoDiT,
                                        VideoViT, init_vit,
                                        make_conditional_diffusion_train_step,
                                        make_vit_train_step)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "bbb_720x480_RGB24_250.h264")
VIT = dict(num_classes=3, depth=2, dim=32, num_heads=2, patch=8,
           tubelet_t=2, attention="joint", use_flash=True, frames=4, size=16)
CLIP = (4, 4, 16, 16, 3)


def vit(seed):
    model = VideoViT(compute_dtype=torch.float32, device="cpu", **VIT)
    init_vit(torch.Generator().manual_seed(seed), model, CLIP)
    return model


def vit_batch():
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.uniform(0, 1, CLIP).astype(np.float32)),
            torch.tensor([True, False, True, False]))


def optimizer_tensors(opt):
    params = [p for g in opt.param_groups for p in g["params"]]
    return [t for p in params for t in opt.state[p].values()]


def assert_state_equal(a, b, opt_a, opt_b):
    for (name, x), y in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(x, y), name
    ta, tb = optimizer_tensors(opt_a), optimizer_tensors(opt_b)
    assert len(ta) == len(tb) > 0
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


def test_retention_and_latest_match_jax(tmp_path):
    """max_to_keep=2 over steps 1-4: both packages keep [3, 4], report 4
    as the latest and restore its values."""
    x = np.arange(8, dtype=np.float32)
    with JaxCheckpointer(str(tmp_path / "jax"), max_to_keep=2) as theirs, \
            TrainCheckpointer(str(tmp_path / "torch"),
                              max_to_keep=2) as ours:
        for s in (1, 2, 3, 4):
            assert theirs.save(s, {"w": jnp.asarray(x * s)})
            assert ours.save(s, {"w": torch.from_numpy(x * s)})
        assert ours.all_steps() == theirs.all_steps() == [3, 4]
        assert ours.latest_step() == theirs.latest_step() == 4
        j_step, j_state, j_loader = theirs.restore(
            template={"w": jnp.zeros(8, jnp.float32)})
        template = {"w": torch.zeros(8)}
        step, state, loader = ours.restore(template=template)
    assert step == j_step == 4 and loader is j_loader is None
    np.testing.assert_array_equal(state["w"].numpy(),
                                  np.asarray(j_state["w"]))
    assert state["w"] is template["w"]  # restored in place
    assert sorted(os.listdir(tmp_path / "torch")) == ["3", "4"]


def test_loader_cursor_round_trips(tmp_path):
    """A ClipLoader's state() saved beside the model resumes a new loader
    at the batch the first one would give next."""
    kw = dict(clip_len=4, batch=3, clip_step=25, seed=5, workers=1,
              device="cpu")
    model = vit(0)
    with ClipLoader(FIXTURE, **kw) as loader:
        next(loader)
        cursor = loader.state()
        want, _ = next(loader)
    with TrainCheckpointer(str(tmp_path)) as ckpt:
        ckpt.save(1, {"model": model}, loader_state=cursor)
        _, _, restored = ckpt.restore(template={"model": vit(1)})
    assert restored == cursor
    with ClipLoader(restored["stream_url"], epoch=restored["epoch"],
                    start_clip=restored["start_clip"],
                    **{**kw, "seed": restored["seed"]}) as resumed:
        got, _ = next(resumed)
    assert torch.equal(got, want)


def test_second_save_of_a_step_is_idempotent(tmp_path):
    with TrainCheckpointer(str(tmp_path)) as ckpt:
        assert ckpt.save(5, {"w": torch.ones(3)}, loader_state={"epoch": 0})
        assert not ckpt.save(5, {"w": torch.zeros(3)},
                             loader_state={"epoch": 9})
        assert ckpt.all_steps() == [5]
        _, state, loader = ckpt.restore(device="cpu")
    assert torch.equal(state["w"], torch.ones(3)) and loader == {"epoch": 0}


def test_restore_without_a_template(tmp_path):
    """template=None: new tensors on the device asked for; a module comes
    back as its state dict, an optimizer as its state and groups by
    parameter index, a generator as its state bytes, plain values as
    they were."""
    model = vit(0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    make_vit_train_step(model, opt)(*vit_batch())
    gen = torch.Generator().manual_seed(4)
    tree = {"model": model, "opt": opt, "gen": gen,
            "extra": [torch.arange(3), ("note", 2.5, None)]}
    with TrainCheckpointer(str(tmp_path)) as ckpt:
        ckpt.save(1, tree)
        step, state, loader = ckpt.restore(device="cpu")
    assert step == 1 and loader is None
    assert state["model"].keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(state["model"][k], v)
        assert state["model"][k].data_ptr() != v.data_ptr()
    params = list(model.parameters())
    assert sorted(state["opt"]["state"]) == list(range(len(params)))
    for i, p in enumerate(params):
        for k, v in opt.state[p].items():
            assert torch.equal(state["opt"]["state"][i][k], v)
    assert state["opt"]["param_groups"][0]["betas"] == (0.9, 0.999)
    assert torch.equal(state["gen"], gen.get_state())
    assert torch.equal(state["extra"][0], torch.arange(3))
    assert state["extra"][1] == ("note", 2.5, None)


def test_vit_adam_resume_is_bit_equal(tmp_path):
    """Two steps, save, two more (A); a fresh model and optimizer (other
    weights, no state yet) restored and taken through the same two steps
    (B): every parameter and Adam state tensor bit-equal, and the
    losses."""
    clips, mask = vit_batch()
    model = vit(0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_vit_train_step(model, opt)
    for _ in range(2):
        step(clips, mask)
    with TrainCheckpointer(str(tmp_path)) as ckpt:
        ckpt.save(2, {"model": model, "opt": opt})
        losses_a = [step(clips, mask)[0] for _ in range(2)]
        fresh = vit(7)
        fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
        fresh_step = make_vit_train_step(fresh, fresh_opt)
        assert not fresh_opt.state
        ckpt.restore(template={"model": fresh, "opt": fresh_opt})
    losses_b = [fresh_step(clips, mask)[0] for _ in range(2)]
    assert [float(x) for x in losses_a] == [float(x) for x in losses_b]
    assert_state_equal(model, fresh, opt, fresh_opt)


def test_dit_resume_with_its_generator_is_bit_equal(tmp_path):
    """The conditional DiT step draws t, the noise and the label dropout
    from its generator: saved with the model, the optimizer and the
    generator, a restore into fresh ones (generator seeded otherwise)
    takes the same two steps bit for bit."""
    latents = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 2, 4, 4, 4)).astype(np.float32))
    labels = torch.tensor([1, 3])
    sched = DiffusionSchedule(100, device="cpu")

    def build(seed):
        model = VideoDiT((2, 4, 4, 4), depth=1, dim=32, num_heads=2,
                         num_classes=5, compute_dtype=torch.float32,
                         device="cpu",
                         generator=torch.Generator().manual_seed(seed))
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        gen = torch.Generator().manual_seed(10 + seed)
        return model, opt, gen, make_conditional_diffusion_train_step(
            model, sched, opt, 0.5, generator=gen)
    model, opt, gen, step = build(0)
    for _ in range(2):
        step(latents, labels)
    with TrainCheckpointer(str(tmp_path)) as ckpt:
        ckpt.save(2, {"model": model, "opt": opt, "gen": gen})
        losses_a = [float(step(latents, labels)) for _ in range(2)]
        model_b, opt_b, gen_b, step_b = build(1)
        ckpt.restore(template={"model": model_b, "opt": opt_b, "gen": gen_b})
    losses_b = [float(step_b(latents, labels)) for _ in range(2)]
    assert losses_a == losses_b
    assert_state_equal(model, model_b, opt, opt_b)
    assert torch.equal(gen.get_state(), gen_b.get_state())


def test_restore_into_an_optimizer_keeps_its_storage(tmp_path):
    """A restore into an optimizer that has state writes into its state
    tensors (a CUDA graph captured over them replays the restored
    values): every data_ptr() is kept, the values are the saved ones."""
    clips, mask = vit_batch()
    model = vit(0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_vit_train_step(model, opt)
    step(clips, mask)
    saved = [t.clone() for t in optimizer_tensors(opt)]
    params = [p.detach().clone() for p in model.parameters()]
    with TrainCheckpointer(str(tmp_path)) as ckpt:
        ckpt.save(1, {"model": model, "opt": opt})
        step(clips, mask)
        ptrs = [t.data_ptr() for t in optimizer_tensors(opt)]
        param_ptrs = [p.data_ptr() for p in model.parameters()]
        ckpt.restore(template={"model": model, "opt": opt})
    assert [t.data_ptr() for t in optimizer_tensors(opt)] == ptrs
    assert [p.data_ptr() for p in model.parameters()] == param_ptrs
    for got, want in zip(optimizer_tensors(opt), saved):
        assert torch.equal(got, want)
    for got, want in zip(model.parameters(), params):
        assert torch.equal(got, want)


def test_a_template_that_differs_raises(tmp_path):
    with TrainCheckpointer(str(tmp_path)) as ckpt:
        ckpt.save(1, {"w": torch.ones(3), "b": [torch.ones(2)]})
        with pytest.raises(ValueError, match="tree differs"):
            ckpt.restore(template={"w": torch.ones(3)})
        with pytest.raises(ValueError, match=r"\(4,\)"):
            ckpt.restore(template={"w": torch.ones(4), "b": [torch.ones(2)]})
        with pytest.raises(ValueError, match="float64"):
            ckpt.restore(template={"w": torch.ones(3, dtype=torch.float64),
                                   "b": [torch.ones(2)]})
        with pytest.raises(FileNotFoundError):
            ckpt.restore(step=9, template={"w": torch.ones(3)})
    with pytest.raises(FileNotFoundError):
        TrainCheckpointer(str(tmp_path / "empty")).restore(device="cpu")
