"""The port's meshed train steps against the single-device ones and the JAX
package, on 4 gloo ranks on the CPU: dp=2 x mp=2, dp=2 x ep=2 and tp x cp
= 2 x 2 (the JAX tests, tests/test_video_vit.py, tests/test_moe.py and
tests/test_ring_attention.py, use dp=4 x mp=2, dp=4 x ep=2 and dp x tp x
cp = 2 x 2 x 2 on 8 devices; 4 ranks keep this file's run short on the
CPU, and shard the same axes but dp in the last, where DTensor's sharding
propagation for one linear layer over a 3-D mesh took over 2 minutes on
this CPU).

* ``make_vit_train_step(..., mesh=)``: the Megatron layout of
  ``vit_param_specs`` on DTensors, one SGD step against the port's
  single-device step and the flax step (loss rtol 1e-5, parameters rtol
  1e-4 atol 1e-5, tests/test_video_vit.py:137-175), with materialized
  attention and with flash attention (tp shards the heads, and the ``ts``
  flash operators run on each rank's heads through their DTensor sharding
  rules);
* ``vit_param_specs``: its count of sharded leaves and its GQA error;
* ``make_moe_train_step(..., mesh=)`` over ("dp", "ep"): the forward of
  the flax model and one step of the single-device port step; a rank's
  MoE layer counts half the unsharded layer's expert FLOPs (the router's
  are replicated) and gives its output;
* the dp steps of VideoDiT and VideoVAE against their single-device steps
  drawing from the same generator;
* MHA ringed over "cp" with its heads over "tp" (``ring_head_axis``)
  against the unsharded flax MHA.

One spawn serves every test (a module fixture); the flax side runs in
this process meanwhile.
"""
import numpy as np
import pytest
import torch

from torch_spawn import start

WORLD = 4
CLIP = (4, 4, 16, 16, 3)
VIT = dict(num_classes=2, depth=2, dim=32, num_heads=2, patch=8, tubelet_t=2)
MOE = dict(num_classes=2, num_experts=4, depth=2, dim=32, num_heads=2,
           patch=8, tubelet_t=2)
MASK = np.array([True, False, False, True])
LR = 1e-2
TOL = dict(atol=2e-5, rtol=2e-5)
PARAM = dict(rtol=1e-4, atol=1e-5)


def clips_of(seed, shape=CLIP):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _params(model):
    return {n: (p.full_tensor() if hasattr(p, "full_tensor") else p)
            .detach().numpy() for n, p in model.named_parameters()}


def _expert_flops(dense, meshed, mesh):
    """FLOPs of one MoE layer's forward on the same tokens, unsharded
    (`dense`), on this rank's experts (`meshed`, after
    ``make_moe_train_step(mesh=)``) and of the router alone; and the two
    layers' outputs."""
    from torch.utils.flop_counter import FlopCounterMode

    from tensor_stream_torch.parallel.sharding import (gathered_params,
                                                       local_module)
    tokens = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, MOE["dim"])).astype(np.float32))
    ep = local_module(meshed, gathered_params(meshed, mesh, keep=("ep",)))
    flops, outs = {}, {}
    with torch.no_grad():
        for key, fn in (("dense", dense), ("ep", ep),
                        ("router", dense.router)):
            with FlopCounterMode(display=False) as counter:
                y = fn(tokens)
            flops[key] = counter.get_total_flops()
            outs[key] = y[0].numpy() if isinstance(y, tuple) else None
    return flops, (outs["dense"], outs["ep"])


def _ranks(rank, world, vit_sd, moe_sd, mha_sd):
    import copy

    from tensor_stream_torch.models import (DiffusionSchedule, VideoDiT,
                                            VideoMoE, VideoVAE, VideoViT,
                                            make_diffusion_train_step,
                                            make_moe_train_step,
                                            make_vae_train_step,
                                            make_vit_train_step,
                                            vit_param_specs)
    from tensor_stream_torch.models.video_vit import MHA, _Init
    from tensor_stream_torch.parallel.sharding import (distribute,
                                                       make_mesh,
                                                       shard_params)
    out = {}
    dp_mp = make_mesh(axes=("dp", "mp"), device="cpu")         # 2 x 2
    clips, mask = torch.from_numpy(clips_of(0)), torch.from_numpy(MASK)

    vit = VideoViT(**VIT, frames=4, size=16, device="cpu",
                   compute_dtype=torch.float32)
    specs = vit_param_specs(vit, mesh=dp_mp)
    out["n_sharded"] = sum(any(a is not None for a in s)
                           for s in specs.values())
    try:
        vit_param_specs(VideoViT(**VIT, frames=4, size=16, device="cpu",
                                 num_kv_heads=1), mesh=dp_mp)
    except ValueError as e:
        out["gqa_error"] = str(e)
    for flash in (False, True):
        single = VideoViT(**VIT, frames=4, size=16, device="cpu",
                          compute_dtype=torch.float32, use_flash=flash)
        single.load_state_dict(vit_sd)
        meshed = copy.deepcopy(single)
        s_step = make_vit_train_step(single, torch.optim.SGD(
            single.parameters(), lr=LR))
        m_step = make_vit_train_step(meshed, torch.optim.SGD(
            meshed.parameters(), lr=LR), mesh=dp_mp)
        key = "flash" if flash else "vit"
        out[f"{key}_single"] = [float(x) for x in s_step(clips, mask)]
        out[f"{key}_meshed"] = [float(x) for x in m_step(clips, mask)]
        out[f"{key}_single_params"] = _params(single)
        out[f"{key}_meshed_params"] = _params(meshed)
    q = meshed.blocks[0].attn_s.query.weight
    out["local_q"] = tuple(q.to_local().shape), tuple(q.shape)

    dp_ep = make_mesh(axes=("dp", "ep"), device="cpu")
    single = VideoMoE(**MOE, frames=4, size=16, device="cpu",
                      compute_dtype=torch.float32)
    single.load_state_dict(moe_sd)
    meshed = copy.deepcopy(single)
    s_step = make_moe_train_step(single, torch.optim.SGD(single.parameters(),
                                                         lr=LR))
    m_step = make_moe_train_step(meshed, torch.optim.SGD(meshed.parameters(),
                                                         lr=LR), mesh=dp_ep)
    out["moe_flops"], out["moe_layer"] = _expert_flops(
        single.blocks[0].moe, meshed.blocks[0].moe, dp_ep)
    moe_clips = torch.from_numpy(clips_of(1))
    out["moe_single"] = [float(x) for x in s_step(moe_clips, mask)]
    out["moe_meshed"] = [float(x) for x in m_step(moe_clips, mask)]
    out["moe_single_params"] = _params(single)
    out["moe_meshed_params"] = _params(meshed)
    w1 = meshed.blocks[0].moe.w1
    out["local_w1"] = tuple(w1.to_local().shape), tuple(w1.shape)

    dp = make_mesh(axes=("dp",), device="cpu")
    sched = DiffusionSchedule(100, device="cpu")
    dit = VideoDiT((2, 4, 4, 8), depth=2, dim=32, num_heads=2,
                   compute_dtype=torch.float32, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    vae = VideoVAE(base=8, latent=4, compute_dtype=torch.float32,
                   device="cpu", generator=torch.Generator().manual_seed(4))
    z = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 2, 4, 4, 8)).astype(np.float32))
    vclips = torch.from_numpy(clips_of(3, (4, 4, 16, 16, 3)))
    for name, model, make, data in (
            ("dit", dit, lambda m, o, **kw: make_diffusion_train_step(
                m, sched, o, **kw), z),
            ("vae", vae, lambda m, o, **kw: make_vae_train_step(
                m, o, **kw), vclips)):
        twin = copy.deepcopy(model)
        runs = []
        for m, kw in ((model, {}), (twin, {"mesh": dp})):
            step = make(m, torch.optim.SGD(m.parameters(), lr=LR),
                        generator=torch.Generator().manual_seed(5), **kw)
            runs.append([float(torch.stack(list(step(data))).sum()
                               if name == "vae" else step(data))
                         for _ in range(2)])
        out[name] = runs
        out[f"{name}_params"] = _params(model), _params(twin)

    # tp's head-sharded flash attention: the ts operators' sharding rules
    # run the kernel on each rank's heads, and nothing is gathered (the
    # row-sharded output projection leaves a partial sum).
    from torch.distributed.tensor.debug import CommDebugMode
    flash = MHA(32, 2, torch.float32, _Init("cpu", torch.Generator()),
                use_flash=True)
    flash.load_state_dict(mha_sd)
    shard_params(flash, dp_mp, vit_param_specs(flash, mesh=dp_mp))
    xf = torch.from_numpy((np.random.default_rng(9).standard_normal(
        (2, 3, 16, 32)) * 0.5).astype(np.float32))
    with torch.no_grad(), CommDebugMode() as comm:
        yf = flash(distribute(xf, dp_mp, ("dp",)))
    out["mha_flash_tp"] = yf.full_tensor().numpy()
    out["mha_flash_tp_comms"] = sorted(str(k) for k in
                                       comm.get_comm_counts())

    dtc = make_mesh(axes=("tp", "cp"), device="cpu")
    mha = MHA(32, 2, torch.float32, _Init("cpu", torch.Generator()),
              ring_axis="cp", mesh=dtc, ring_batch_axis=None,
              ring_head_axis="tp")
    mha.load_state_dict(mha_sd)
    shard_params(mha, dtc, vit_param_specs(mha, tp_axis="tp", mesh=dtc))
    x = torch.from_numpy((np.random.default_rng(9).standard_normal(
        (2, 3, 16, 32)) * 0.5).astype(np.float32))
    with torch.no_grad():
        y = mha(distribute(x, dtc, (None, None, "cp", None)))
    out["mha_tp"] = y.full_tensor().numpy()
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    import optax

    from tensor_stream_tpu.models import moe as jmoe
    from tensor_stream_tpu.models.video_vit import MHA, VideoViT
    from tensor_stream_torch.models import (moe_state_dict_from_flax,
                                            vit_state_dict_from_flax)

    vit = VideoViT(**VIT, compute_dtype=jnp.float32)
    vit_params = jax.jit(vit.init)(jax.random.PRNGKey(0), jnp.zeros(CLIP))
    moe = jmoe.VideoMoE(**MOE, compute_dtype=jnp.float32)
    moe_params = jax.jit(moe.init)(jax.random.PRNGKey(0), jnp.zeros(CLIP))
    x = jnp.asarray(np.random.default_rng(9).standard_normal((2, 3, 16, 32))
                    * 0.5, jnp.float32)
    mha = MHA(num_heads=2, compute_dtype=jnp.float32)
    mha_params = jax.jit(mha.init)(jax.random.PRNGKey(3), x)
    ranks = start(_ranks, WORLD, tmp_path_factory.mktemp("mesh"),
                  vit_state_dict_from_flax(vit_params),
                  moe_state_dict_from_flax(moe_params),
                  vit_state_dict_from_flax(mha_params))

    want = {}
    labels = jnp.asarray(MASK.astype(np.int32))

    def sgd_step(apply, params, clips):
        x = np.where(MASK[:, None, None, None, None], clips[:, ::-1], clips)

        def loss_fn(p):
            logits, aux = apply(p, jnp.asarray(x))
            ce = -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                      labels[:, None], axis=1).mean()
            return ce + aux, ((logits.argmax(-1) == labels).mean(), aux)
        (loss, (acc, aux)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
        tx = optax.sgd(LR)
        updates, _ = tx.update(grads, tx.init(params))
        return [float(loss), float(acc), float(aux)], \
            optax.apply_updates(params, updates)

    got, new = sgd_step(lambda p, x: (vit.apply(p, x), 0.0), vit_params,
                        clips_of(0))
    want["vit"] = got[:2]
    want["vit_params"] = {k: v.numpy() for k, v in
                          vit_state_dict_from_flax(new).items()}
    got, _ = sgd_step(moe.apply, moe_params, clips_of(1))
    want["moe"] = got
    want["mha_tp"] = np.asarray(jax.jit(mha.apply)(mha_params, x))
    return ranks.results(), want


def test_vit_param_specs_count_and_gqa_error(results):
    r = results[0][0]
    # 2 attention modules a block x (3 qkv weights + 3 qkv biases + out
    # weight) + fc1 weight, fc1 bias, fc2 weight.
    assert r["n_sharded"] == VIT["depth"] * (2 * 7 + 3)
    assert "key projection has 1 heads" in r["gqa_error"]
    assert "'mp' of size 2" in r["gqa_error"]


@pytest.mark.parametrize("attention", ["vit", "flash"])
def test_meshed_vit_step_matches_single_device(results, attention):
    got, want = results
    for r in got:   # every rank reports the global loss and accuracy
        np.testing.assert_allclose(r[f"{attention}_meshed"][0], want["vit"][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(r[f"{attention}_meshed"],
                                   r[f"{attention}_single"], rtol=1e-5)
        assert r[f"{attention}_meshed"][1] == want["vit"][1]
    r = got[0]
    for name, p in r[f"{attention}_meshed_params"].items():
        np.testing.assert_allclose(p, want["vit_params"][name], err_msg=name,
                                   **PARAM)
        np.testing.assert_allclose(p, r[f"{attention}_single_params"][name],
                                   err_msg=name, **PARAM)


def test_meshed_vit_params_physically_sharded(results):
    local, whole = results[0][0]["local_q"]
    assert local == (whole[0] // 2, whole[1])


def test_expert_parallel_matches_unsharded(results):
    got, want = results
    for r in got:
        np.testing.assert_allclose(r["moe_meshed"], want["moe"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["moe_meshed"], r["moe_single"],
                                   rtol=1e-5, atol=1e-6)
    r = got[0]
    for name, p in r["moe_meshed_params"].items():
        np.testing.assert_allclose(p, r["moe_single_params"][name],
                                   err_msg=name, **PARAM)
    local, whole = r["local_w1"]
    assert local[0] * 2 == whole[0] and local[1:] == whole[1:]


def test_expert_parallel_splits_the_expert_work(results):
    got, _ = results
    for r in got:
        flops = r["moe_flops"]
        router = flops["router"]
        assert router > 0 and flops["ep"] > router
        assert 2 * (flops["ep"] - router) == flops["dense"] - router, flops
        dense, ep = r["moe_layer"]
        np.testing.assert_allclose(ep, dense, **TOL)


@pytest.mark.parametrize("model", ["dit", "vae"])
def test_dp_step_matches_single_device(results, model):
    got, _ = results
    for r in got:
        single, meshed = r[model]
        np.testing.assert_allclose(meshed, single, rtol=1e-5)
    single, meshed = got[0][f"{model}_params"]
    for name, p in meshed.items():
        np.testing.assert_allclose(p, single[name], err_msg=name, **PARAM)


def test_tp_flash_attention_runs_on_each_ranks_heads(results):
    got, want = results
    r = got[0]
    np.testing.assert_allclose(r["mha_flash_tp"], want["mha_tp"], **TOL)
    comms = r["mha_flash_tp_comms"]
    assert not [c for c in comms if "gather" in c.lower()], comms


def test_mha_ring_composes_with_tp(results):
    got, want = results
    np.testing.assert_allclose(got[0]["mha_tp"], want["mha_tp"], **TOL)
