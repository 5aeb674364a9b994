"""The port's GPipe (tensor_stream_torch/parallel/pipeline.py) against the
JAX package's sequential model, on 4 gloo ranks on the CPU: a ("dp", "pp")
mesh of 2 x 2, depth 4, so each stage runs 2 blocks (the JAX tests,
tests/test_pipeline_parallel.py:41-144, use pp=4 on 8 devices, and 2
blocks a stage at depth 8).

The stage parameters come from the flax ``init_pp_params`` through
``pp_params_from_flax``; the ranks run the circulating schedule with the
hand-offs through ``dist.batch_isend_irecv``. Held: the logits at 1, 2
and 4 microbatches (rtol 1e-5, atol 1e-6), every gradient of the outer
and stacked stage parameters (rtol 1e-4, atol 1e-6) against the flax
sequential model's, each rank holding only its stage, and a train step
whose loss falls.
"""
import numpy as np
import pytest
import torch

from torch_spawn import start

WORLD = 4
STAGES = 2
CLIP = (8, 4, 16, 16, 3)       # B/dp = 4 on each rank
VIT = dict(num_classes=2, depth=4, dim=32, num_heads=2, patch=8,
           tubelet_t=2)
LABELS = np.array([0, 1, 1, 0, 1, 0, 0, 1])
MICRO = (1, 2, 4)


def clips_of(seed):
    return np.random.default_rng(seed).uniform(0, 1, CLIP).astype(np.float32)


def _ranks(rank, world, outer, stage):
    from tensor_stream_torch.models import VideoViT
    from tensor_stream_torch.parallel import (make_pp_mesh,
                                              make_pp_train_step, pp_apply,
                                              shard_pp_params)
    out = {}
    mesh = make_pp_mesh(pp=STAGES, device="cpu")
    model = VideoViT(**VIT, frames=CLIP[1], size=CLIP[2], device="cpu",
                     compute_dtype=torch.float32)
    so, ss = shard_pp_params(mesh, outer, stage)
    out["local_stage"] = tuple(ss["attn_s.query.weight"].to_local().shape)
    clips = torch.from_numpy(clips_of(1))
    for m in MICRO:
        out[f"logits_{m}"] = pp_apply(mesh, model, so, ss, clips,
                                      n_micro=m).full_tensor().detach().numpy()
    logits = pp_apply(mesh, model, so, ss, clips, n_micro=2)
    labels = torch.from_numpy(LABELS)
    from tensor_stream_torch.parallel.sharding import distribute
    lab = distribute(labels, mesh, ("dp",))
    loss = -torch.take_along_dim(torch.log_softmax(logits, -1),
                                 lab[:, None], dim=1).mean()
    loss.backward()
    out["outer_grads"] = {k: v.grad.full_tensor().numpy()
                          for k, v in so.items()}
    out["stage_grads"] = {k: v.grad.full_tensor().numpy()
                          for k, v in ss.items()}

    bf = VideoViT(**VIT, frames=CLIP[1], size=CLIP[2], device="cpu",
                  compute_dtype=torch.bfloat16)
    so, ss = shard_pp_params(mesh, outer, stage)
    opt = torch.optim.Adam(list(so.values()) + list(ss.values()), lr=3e-3)
    step = make_pp_train_step(mesh, bf, so, ss, opt, n_micro=2)
    rng = np.random.default_rng(3)
    ramp = np.linspace(0, 1, CLIP[1], dtype=np.float32)
    train = torch.from_numpy((rng.uniform(0, .25, CLIP).astype(np.float32)
                              + ramp[None, :, None, None, None]))
    mask = torch.tensor([True, False, True, False, False, True, False, True])
    out["losses"] = [float(step(train, mask)[0]) for _ in range(8)]
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from tensor_stream_tpu.models.video_vit import VideoViT
    from tensor_stream_tpu.parallel.pipeline import init_pp_params
    from tensor_stream_torch.models import (pp_params_from_flax,
                                            vit_state_dict_from_flax)

    model = VideoViT(**VIT, compute_dtype=jnp.float32)
    rng = jax.random.PRNGKey(0)
    full = jax.jit(model.init)(rng, jnp.zeros(CLIP, jnp.float32))
    outer, stage = jax.jit(init_pp_params, static_argnums=(1, 2, 3))(
        rng, model, CLIP, STAGES)
    outer_t, stage_t = pp_params_from_flax(
        jax.tree_util.tree_map(np.asarray, outer),
        jax.tree_util.tree_map(np.asarray, stage))
    ranks = start(_ranks, WORLD, tmp_path_factory.mktemp("pp"), outer_t,
                  stage_t)
    clips = jnp.asarray(clips_of(1))
    labels = jnp.asarray(LABELS)

    def loss(p):
        logits = model.apply(p, clips)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                    labels[:, None], axis=1).mean()
    want = {"logits": np.asarray(jax.jit(model.apply)(full, clips)),
            "grads": {k: v.numpy() for k, v in vit_state_dict_from_flax(
                jax.jit(jax.grad(loss))(full)).items()},
            "full": {k: v.numpy() for k, v in
                     vit_state_dict_from_flax(full).items()},
            "outer": outer_t, "stage": stage_t}
    return ranks.results(), want


def test_pp_params_from_flax_stacks_the_blocks(results):
    want = results[1]
    per = VIT["depth"] // STAGES
    for name, stacked in want["stage"].items():
        assert stacked.shape[:2] == (STAGES, per)
        for i in range(VIT["depth"]):
            np.testing.assert_array_equal(
                stacked[i // per, i % per].numpy(),
                want["full"][f"blocks.{i}.{name}"], err_msg=name)
    for name, t in want["outer"].items():
        np.testing.assert_array_equal(t.numpy(), want["full"][name])


@pytest.mark.parametrize("n_micro", MICRO)
def test_pp_forward_matches_sequential(results, n_micro):
    got, want = results
    for r in got:
        np.testing.assert_allclose(r[f"logits_{n_micro}"], want["logits"],
                                   rtol=1e-5, atol=1e-6)


def test_pp_grads_match_sequential(results):
    got, want = results
    r, grads = got[0], want["grads"]
    for name, g in r["outer_grads"].items():
        np.testing.assert_allclose(g, grads[name], rtol=1e-4, atol=1e-6,
                                   err_msg=name)
    per = VIT["depth"] // STAGES
    for name, g in r["stage_grads"].items():
        for i in range(VIT["depth"]):
            np.testing.assert_allclose(g[i // per, i % per],
                                       grads[f"blocks.{i}.{name}"],
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"block {i} {name}")


def test_pp_stage_params_physically_sharded(results):
    local = results[0][0]["local_stage"]
    assert local[:2] == (1, VIT["depth"] // STAGES)


def test_pp_train_step_descends(results):
    for r in results[0]:
        losses = r["losses"]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0], losses
    assert results[0][0]["losses"] == results[0][1]["losses"]
