"""The port's ring attention (tensor_stream_torch/ops/ring_attention.py) and
the ringed models against the JAX package, on 4 gloo ranks on the CPU.

The ranks run the real hop code: on CPU tensors each kernel hop is the
``ts`` operators' CPU kernel (the plain flash forward and backward), the
blocks rotate through ``dist.batch_isend_irecv``. The JAX side runs in this
process: ``ring_attention_sharded`` on its 8-device CPU mesh for the full,
causal and dp x cp forwards, and the JAX ``_reference`` (full attention,
which tests/test_ring_attention.py holds the JAX ring to at these
tolerances) for the windowed and bf16 forwards and, through ``jax.grad``,
for the gradients; the models are the flax ones with their weights converted
(``vit_state_dict_from_flax``), ringed in JAX where tests/test_ring_
attention.py rings them and unringed where it compares with the unringed
model. One spawn of the ranks serves every test (a module fixture), and
they run while JAX computes.

Tolerances are the JAX tests' (tests/test_ring_attention.py:29, :81-83):
2e-5 in f32, 2e-2 in bf16, 1e-4 for the ViT's parameter gradients.
``virtual_ring`` (every ring position on one device, the arrangement the
card's smoke check uses) is held to one flash call and to JAX here too.
"""
import numpy as np
import pytest
import torch

from torch_spawn import start

TOL = dict(atol=2e-5, rtol=2e-5)
BF16 = dict(atol=2e-2, rtol=2e-2)
WORLD = 4
WINDOWS = [(True, 12), (False, 20), (True, 64)]
X_SHAPE = (2, 3, 16, 32)
CLIP = (2, 4, 32, 32, 3)                # N = 16 tokens, sp = 2
VIT = dict(num_classes=5, depth=2, dim=32, num_heads=2, patch=8, tubelet_t=2)
Z_SHAPE = (2, 3, 4, 4, 8)


def qkv(b, h, s, d, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((b, h, s, d)) * 0.5).astype(dtype)
            for _ in range(3)]


def cotangent(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape)
            * 0.1).astype(np.float32)


# ------------------------------------------------------------------ ranks

def _grads(fn, arrays, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    (fn(*ts) * torch.from_numpy(cot)).sum().backward()
    return [t.grad.numpy() for t in ts]


def _ranks(rank, world, mha_sd, vit_sd, dit_sd, labels):
    """Every ring and model check, on this rank; returns the gathered
    global results (numpy) and the error messages."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from tensor_stream_torch.models import VideoDiT, VideoViT
    from tensor_stream_torch.models.video_vit import MHA, _Init
    from tensor_stream_torch.ops import ring_attention as ra
    from tensor_stream_torch.parallel.sharding import (distribute,
                                                       make_mesh,
                                                       shard_params)
    out, counts = {}, {}
    cp = make_mesh(axes=("cp",), device="cpu")
    mesh = make_mesh(axes=("dp", "sp"), shape=(2, 2), device="cpu")

    def ring(*arrays, **kw):
        ts = [torch.as_tensor(a) for a in arrays]
        return ra.ring_attention_sharded(cp, *ts, seq_axis="cp",
                                         **kw).full_tensor()

    for causal in (False, True):
        ra.reset_counts()
        out[f"fwd_{causal}"] = ring(*qkv(2, 2, 64, 16), causal=causal).numpy()
        counts[f"fwd_{causal}"] = dict(ra.launches_by_mode)
        out[f"grad_{causal}"] = _grads(
            lambda q, k, v: ring(q, k, v, causal=causal),
            qkv(2, 2, 64, 16, seed=4), cotangent((2, 2, 64, 16), 5))
    for causal, window in WINDOWS:
        ra.reset_counts()
        out[f"win_{causal}_{window}"] = ring(*qkv(2, 2, 64, 16, seed=7),
                                             causal=causal,
                                             window=window).numpy()
        counts[f"win_{causal}_{window}"] = dict(ra.launches_by_mode)
    out["win_grad"] = _grads(
        lambda q, k, v: ring(q, k, v, causal=True, window=24),
        qkv(2, 2, 64, 16, seed=8), cotangent((2, 2, 64, 16), 9))
    dpcp = make_mesh(axes=("dp", "cp"), shape=(2, 2), device="cpu")
    out["dp_cp"] = ra.ring_attention_sharded(
        dpcp, *map(torch.as_tensor, qkv(4, 2, 32, 16, seed=1)),
        seq_axis="cp", batch_axis="dp", causal=True).full_tensor().numpy()
    bf = [torch.as_tensor(a).bfloat16() for a in qkv(1, 2, 64, 16, seed=2)]
    got = ra.ring_attention_sharded(cp, *bf, seq_axis="cp", sm_scale=0.125)
    out["bf16_dtype"] = str(got.dtype)
    out["bf16"] = got.full_tensor().float().numpy()
    local = [torch.as_tensor(a).chunk(world, 2)[rank]
             for a in qkv(2, 2, 64, 16)]
    shards = [torch.empty_like(local[0]) for _ in range(world)]
    dist.all_gather(shards, ra.ring_attention_plain(
        *local, group=cp.get_group("cp"), causal=True))
    out["plain"] = torch.cat(shards, 2).numpy()
    errors = {}
    for name, args, kw in (
            ("indivisible", qkv(1, 1, 62, 16), {}),
            ("ragged", [a[:, :, :n] for a, n in zip(qkv(1, 1, 64, 16),
                                                    (64, 32, 32))],
             dict(causal=True)),
            ("gqa", [a[:, :h] for a, h in zip(qkv(1, 2, 64, 16),
                                              (2, 1, 1))], {})):
        try:
            ring(*args, **kw)
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    try:
        MHA(32, 2, torch.float32, _Init("cpu", torch.Generator()),
            num_kv_heads=1, ring_axis="sp", mesh=mesh)
    except ValueError as e:
        errors["mha_gqa"] = str(e)

    # ---- models: MHA, ViT and DiT with ring spatial attention
    init = _Init("cpu", torch.Generator())
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(X_SHAPE)
                        * 0.5, dtype=torch.float32)
    ringed = MHA(32, 2, torch.float32, init, ring_axis="sp", mesh=mesh)
    ringed.load_state_dict(mha_sd)
    out["mha"] = ringed(x).detach().numpy()
    xw = torch.as_tensor(np.random.default_rng(10).standard_normal(X_SHAPE)
                         * 0.5, dtype=torch.float32)
    win = MHA(32, 2, torch.float32, init, causal=True, window=5,
              ring_axis="sp", mesh=mesh)
    win.load_state_dict(mha_sd)
    out["mha_window"] = win(xw).detach().numpy()

    # The whole clips on every rank, each spatial attention ringed over
    # "sp" (its output gathered whole), the gradients through the ring.
    vit = VideoViT(**VIT, frames=CLIP[1], size=CLIP[2], device="cpu",
                   compute_dtype=torch.float32, ring_axis="sp", mesh=mesh)
    vit.load_state_dict(vit_sd)
    clips = torch.as_tensor(np.random.default_rng(7).uniform(0, 1, CLIP),
                            dtype=torch.float32)
    loss = -torch.take_along_dim(torch.log_softmax(vit(clips), -1),
                                 torch.as_tensor(labels)[:, None],
                                 dim=1).mean()
    loss.backward()
    out["vit_loss"] = float(loss)
    out["vit_grads"] = {n: p.grad.numpy() for n, p in vit.named_parameters()}

    sw = VideoViT(**VIT, frames=CLIP[1], size=CLIP[2], device="cpu",
                  compute_dtype=torch.float32, spatial_window=5,
                  ring_axis="sp", mesh=mesh)
    sw.load_state_dict(vit_sd)
    clips_w = torch.as_tensor(np.random.default_rng(11).uniform(0, 1, CLIP),
                              dtype=torch.float32)
    with torch.no_grad():
        out["vit_window"] = sw(clips_w).numpy()

    dit = VideoDiT(Z_SHAPE[1:], depth=2, dim=32, num_heads=2,
                   compute_dtype=torch.float32, device="cpu",
                   ring_axis="sp", mesh=mesh)
    dit.load_state_dict(dit_sd)
    z = torch.as_tensor(np.random.default_rng(8).standard_normal(Z_SHAPE)
                        * 0.3, dtype=torch.float32)
    with torch.no_grad():
        out["dit"] = dit(z, torch.tensor([10, 500])).numpy()

    # A ringed MHA on DTensors: the tokens stay sharded over "sp" through
    # attention, with no all-gather.
    shard_params(ringed, mesh, {})
    xd = distribute(x, mesh, ("dp", None, "sp", None))
    with CommDebugMode() as comm:
        y = ringed(xd)
    out["mha_dtensor"] = y.full_tensor().detach().numpy()
    out["mha_dtensor_placements"] = [str(p) for p in y.placements]
    out["mha_dtensor_comms"] = sorted(str(k) for k in
                                      comm.get_comm_counts())
    out["is_dtensor"] = isinstance(y, DTensor)
    out["counts"] = counts
    return out


# ------------------------------------------------------------------ JAX

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from tensor_stream_tpu.models.latent_diffusion import VideoDiT
    from tensor_stream_tpu.models.video_vit import MHA, VideoViT
    from tensor_stream_tpu.ops.flash_attention import _reference
    from tensor_stream_tpu.ops.ring_attention import ring_attention_sharded
    from tensor_stream_torch.models import (dit_state_dict_from_flax,
                                            vit_state_dict_from_flax)

    x = jnp.asarray(np.random.default_rng(6).standard_normal(X_SHAPE) * 0.5,
                    jnp.float32)
    mha = MHA(num_heads=2, compute_dtype=jnp.float32)
    mha_params = jax.jit(mha.init)(jax.random.PRNGKey(0), x)
    vit = VideoViT(**VIT, compute_dtype=jnp.float32)
    clips = jnp.asarray(np.random.default_rng(7).uniform(0, 1, CLIP),
                        jnp.float32)
    vit_params = jax.jit(vit.init)(jax.random.PRNGKey(1), clips)
    z = jnp.asarray(np.random.default_rng(8).standard_normal(Z_SHAPE) * 0.3,
                    jnp.float32)
    t = jnp.asarray([10, 500])
    dit = VideoDiT(depth=2, dim=32, num_heads=2, compute_dtype=jnp.float32)
    dit_params = jax.jit(dit.init)(jax.random.PRNGKey(2), z, t)
    labels = np.array([1, 3])
    ranks = start(_ranks, WORLD, tmp_path_factory.mktemp("ring"),
                  vit_state_dict_from_flax(mha_params),
                  vit_state_dict_from_flax(vit_params),
                  dit_state_dict_from_flax(dit_params), labels)

    want = {}
    mesh8 = Mesh(np.asarray(jax.devices()[:8]), ("cp",))

    def ring(*arrays, mesh=mesh8, **kw):
        return np.asarray(ring_attention_sharded(
            mesh, *map(jnp.asarray, arrays), seq_axis="cp", **kw), np.float32)

    def ref_grads(arrays, cot, causal, window=None):
        def loss(q, k, v):
            return jnp.sum(_reference(q, k, v, causal, 16 ** -0.5, window)
                           * cot)
        return [np.asarray(g) for g in jax.jit(jax.grad(
            loss, argnums=(0, 1, 2)))(*map(jnp.asarray, arrays))]

    for causal in (False, True):
        want[f"fwd_{causal}"] = ring(*qkv(2, 2, 64, 16), causal=causal)
        want[f"grad_{causal}"] = ref_grads(qkv(2, 2, 64, 16, seed=4),
                                           cotangent((2, 2, 64, 16), 5),
                                           causal)
    for causal, window in WINDOWS:
        want[f"win_{causal}_{window}"] = np.asarray(_reference(
            *map(jnp.asarray, qkv(2, 2, 64, 16, seed=7)), causal, 16 ** -0.5,
            window))
    want["win_grad"] = ref_grads(qkv(2, 2, 64, 16, seed=8),
                                 cotangent((2, 2, 64, 16), 9), True, 24)
    dpcp = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("dp", "cp"))
    want["dp_cp"] = ring(*qkv(4, 2, 32, 16, seed=1), mesh=dpcp,
                         batch_axis="dp", causal=True)
    want["bf16"] = np.asarray(_reference(
        *map(jnp.asarray, qkv(1, 2, 64, 16, seed=2, dtype=jnp.bfloat16)),
        False, 0.125), np.float32)
    want["plain"] = want["fwd_True"]
    sp = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("dp", "sp"))
    want["mha"] = np.asarray(MHA(num_heads=2, compute_dtype=jnp.float32,
                                 ring_axis="sp", mesh=sp).apply(mha_params,
                                                                x))
    xw = jnp.asarray(np.random.default_rng(10).standard_normal(X_SHAPE)
                     * 0.5, jnp.float32)
    want["mha_window"] = np.asarray(jax.jit(MHA(
        num_heads=2, compute_dtype=jnp.float32, causal=True,
        window=5).apply)(mha_params, xw))

    def vit_loss(p):
        logits = vit.apply(p, clips)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                    jnp.asarray(labels)[:, None], 1).mean()
    loss, grads = jax.jit(jax.value_and_grad(vit_loss))(vit_params)
    want["vit_loss"] = float(loss)
    want["vit_grads"] = {k: v.numpy() for k, v in
                         vit_state_dict_from_flax(grads).items()}
    clips_w = jnp.asarray(np.random.default_rng(11).uniform(0, 1, CLIP),
                          jnp.float32)
    want["vit_window"] = np.asarray(jax.jit(VideoViT(
        **VIT, compute_dtype=jnp.float32, spatial_window=5).apply)(
            vit_params, clips_w))
    want["vit_full"] = np.asarray(jax.jit(vit.apply)(vit_params, clips_w))
    want["dit"] = np.asarray(jax.jit(dit.apply)(dit_params, z, t))
    return ranks.results(), want


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax(results, causal):
    got, want = results
    for r in got:       # every rank gathers the same global result
        np.testing.assert_allclose(r[f"fwd_{causal}"], want[f"fwd_{causal}"],
                                   **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_grads_match_jax(results, causal):
    got, want = results
    for g, w, name in zip(got[0][f"grad_{causal}"], want[f"grad_{causal}"],
                          "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal,window", WINDOWS)
def test_ring_window_matches_jax(results, causal, window):
    got, want = results
    key = f"win_{causal}_{window}"
    np.testing.assert_allclose(got[0][key], want[key], **TOL)


def test_ring_window_grads_match_jax(results):
    got, want = results
    for g, w, name in zip(got[0]["win_grad"], want["win_grad"], "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


def test_ring_dp_cp_mesh(results):
    got, want = results
    np.testing.assert_allclose(got[0]["dp_cp"], want["dp_cp"], **TOL)


def test_ring_custom_scale_and_bf16(results):
    got, want = results
    assert got[0]["bf16_dtype"] == "torch.bfloat16"
    np.testing.assert_allclose(got[0]["bf16"], want["bf16"], **BF16)


def test_ring_plain_body_matches_jax(results):
    """ring_attention_plain, the JAX step written out, on each rank."""
    got, want = results
    np.testing.assert_allclose(got[0]["plain"], want["plain"], **TOL)


def test_ring_routes_are_counted(results):
    """Kernel hops by mode; under causal a later block is skipped but
    still rotates; windowed hops take the plain route (rank 0: its own
    block first, then the 3 others, all earlier-or-later by position)."""
    counts = [r["counts"] for r in results[0]]
    assert counts[0]["fwd_False"] == {"full": 4, "causal": 0, "plain": 0,
                                      "skipped": 0}
    # Rank r holds blocks r, r-1, ...: r earlier ones run full, n-1-r
    # later ones are skipped.
    for r, c in enumerate(counts):
        assert c["fwd_True"] == {"full": r, "causal": 1, "plain": 0,
                                 "skipped": WORLD - 1 - r}
        live = c["win_True_64"]
        assert live["plain"] == r + 1 and live["full"] == 0
    # A window of 12 inside blocks of 16 reaches only the previous block.
    assert counts[2]["win_True_12"] == {"full": 0, "causal": 0, "plain": 2,
                                        "skipped": 2}


def test_ring_rejects_indivisible_and_raggedness(results):
    errors = results[0][0]["errors"]
    assert "divide the ring" in errors["indivisible"]
    assert "equal q/kv" in errors["ragged"]
    assert "bad attention shapes" in errors["gqa"]
    assert "num_kv_heads" in errors["mha_gqa"]


def test_mha_ring_parity(results):
    got, want = results
    np.testing.assert_allclose(got[0]["mha"], want["mha"], **TOL)


def test_mha_ring_window_parity(results):
    got, want = results
    np.testing.assert_allclose(got[0]["mha_window"], want["mha_window"],
                               **TOL)


def test_vit_ring_forward_and_grads(results):
    """VideoViT with ring spatial attention (dp x sp): the loss and every
    parameter gradient of the unringed flax model. The residual stream's
    DTensor layout over "sp" is held at the MHA
    (test_mha_ring_on_dtensors_gathers_nothing)."""
    got, want = results
    np.testing.assert_allclose(got[0]["vit_loss"], want["vit_loss"], **TOL)
    assert set(got[0]["vit_grads"]) == set(want["vit_grads"])
    for name, g in got[0]["vit_grads"].items():
        np.testing.assert_allclose(g, want["vit_grads"][name], atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_vit_spatial_window_through_ring(results):
    got, want = results
    np.testing.assert_allclose(got[0]["vit_window"], want["vit_window"],
                               **TOL)
    assert not np.allclose(want["vit_window"], want["vit_full"])


def test_dit_ring_parity(results):
    got, want = results
    np.testing.assert_allclose(got[0]["dit"], want["dit"], **TOL)


def test_mha_ring_on_dtensors_gathers_nothing(results):
    """On DTensors laid out (dp, -, sp, -) the ringed MHA keeps the token
    axis sharded over "sp" through attention: its output stays there and
    no all-gather runs (the blocks move point to point)."""
    got, want = results
    r = got[0]
    np.testing.assert_allclose(r["mha_dtensor"], want["mha"], **TOL)
    assert r["is_dtensor"]
    assert r["mha_dtensor_placements"] == ["S(0)", "S(2)"]
    assert not [c for c in r["mha_dtensor_comms"]
                if "gather" in c.lower()], r["mha_dtensor_comms"]


# -------------------------------------------------- the virtual ring

@pytest.mark.parametrize("causal", [False, True])
def test_virtual_ring_matches_one_call_and_jax(causal):
    """Four ring positions on one device through the hop and merge code:
    o, l, m of one flash call (the port's plain forward, the kernel's CPU
    twin) and JAX's reference output; the reverse ring's gradients
    against one flash backward and jax.vjp of the reference."""
    import jax
    import jax.numpy as jnp

    from tensor_stream_torch.ops import flash_attention as fa
    from tensor_stream_torch.ops import ring_attention as ra
    from tensor_stream_tpu.ops.flash_attention import _reference

    arrays = qkv(2, 2, 64, 16, seed=12)
    q, k, v = map(torch.as_tensor, arrays)
    o, l, m = ra.virtual_ring(q, k, v, 4, causal=causal)
    wo, wl, wm = fa.flash_attention_plain(q, k, v, causal, residuals=True)
    np.testing.assert_allclose(o, wo, **TOL)
    np.testing.assert_allclose(m, wm, **TOL)
    np.testing.assert_allclose(l, wl, rtol=2e-5, atol=2e-5 * float(wl.max()))
    jo, vjp = jax.vjp(lambda *t: _reference(*t, causal, 16 ** -0.5),
                      *map(jnp.asarray, arrays))
    np.testing.assert_allclose(o, np.asarray(jo), **TOL)
    do = cotangent(q.shape, 13)
    got = ra.virtual_ring_bwd(q, k, v, o, l, m, torch.as_tensor(do), 4,
                              causal=causal)
    one = fa.flash_attention_bwd_plain(q, k, v, wo, wl, wm,
                                       torch.as_tensor(do), causal)
    for g, w, j, name in zip(got, one, vjp(jnp.asarray(do)), "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)
        np.testing.assert_allclose(g, np.asarray(j), err_msg=f"d{name}",
                                   **TOL)
