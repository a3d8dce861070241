"""Parity of the PyTorch port's flagship forward with the JAX reference.

The same inputs, made from a numpy seed, go through the brpc_tpu function
and its brpc_tpu_torch counterpart on the CPU. The reference's parameters
cross with ``params_from_numpy``. Tolerances are the reference tests' own
where they have one (2e-5 attention, 3e-4 fp32 logits); the others are
stated beside their test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.tensor import model as rmodel
from brpc_tpu.tensor import moe as rmoe
from brpc_tpu.tensor.config import ModelConfig as RefConfig
from brpc_tpu.tensor.ring_attention import local_attention as ref_local_attention
from brpc_tpu_torch.entry import entry
from brpc_tpu_torch.tensor import model as pmodel
from brpc_tpu_torch.tensor import moe as pmoe
from brpc_tpu_torch.tensor.config import ModelConfig
from brpc_tpu_torch.tensor.ring_attention import local_attention

# tests/test_tensor_model.py's CFG: fp32, capacity factor == n_experts (no drops)
CFG = dict(vocab=64, d_model=32, n_heads=4, d_head=8, d_ff=32, n_layers=1,
           n_experts=4, expert_capacity_factor=4.0, dtype="float32")
# two experts at capacity factor 1.25: tokens past capacity are dropped
DROP_CFG = dict(CFG, n_layers=2, n_experts=2, expert_capacity_factor=1.25)


def _t(a):
    return torch.from_numpy(np.array(a))


def _ref_params(cfg, seed):
    """Reference Params drawn from a numpy seed with init_params' shapes and
    scales (cheaper than jax.random on the CPU; test_params_from_numpy...
    covers the reference's own init)."""
    rng = np.random.default_rng(seed)
    L, d, dq, f, e = (cfg.n_layers, cfg.d_model, cfg.d_qkv, cfg.d_ff,
                      cfg.n_experts)

    def dense(shape, fan_in):
        return jnp.asarray(rng.normal(size=shape) / np.sqrt(fan_in),
                           dtype=cfg.dtype)

    ones = lambda shape: jnp.ones(shape, cfg.dtype)  # noqa: E731
    return rmodel.Params(
        embed=dense((cfg.vocab, d), d),
        layers=rmodel.LayerParams(
            ln1=ones((L, d)), wq=dense((L, d, dq), d),
            wk=dense((L, d, dq), d), wv=dense((L, d, dq), d),
            wo=dense((L, dq, d), dq), ln2=ones((L, d)),
            moe=rmoe.MoEParams(router=dense((L, d, e), d),
                               w_in=dense((L, e, d, f), d),
                               w_out=dense((L, e, f, d), f))),
        final_norm=ones((d,)),
    )


def _pair(cfg_kwargs, seed=0):
    ref_cfg, cfg = RefConfig(**cfg_kwargs), ModelConfig(**cfg_kwargs)
    ref_params = _ref_params(ref_cfg, seed)
    params = pmodel.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                      device="cpu")
    return ref_cfg, cfg, ref_params, params


def test_rmsnorm_parity():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 32)).astype(np.float32) * 3
    scale = rng.normal(size=(32,)).astype(np.float32)
    want = np.asarray(rmodel._rmsnorm(jnp.asarray(x), jnp.asarray(scale)))
    got = pmodel._rmsnorm(_t(x), _t(scale)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_local_attention_parity(causal):
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(2, 32, 4, 8)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(ref_local_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    got = local_attention(_t(q), _t(k), _t(v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_route_parity_with_drops_and_ties():
    """Dispatch and combine equal bit for bit. Inputs sit on a dyadic grid
    (small integers, router in sixteenths), so the router logits are exact
    in both frameworks whatever their summation order; the routing is
    biased toward expert 0 so its capacity overflows, and integer inputs
    give tied logits, which must go to the first expert."""
    rng = np.random.default_rng(2)
    N, D, E = 256, 32, 2
    x = rng.integers(-1, 3, size=(N, D)).astype(np.float32)
    router = (rng.integers(-4, 5, size=(D, E)) / 16).astype(np.float32)
    router[:, 0] += 1 / 8
    capacity = int(1.25 * N / E)
    want_d, want_c = (np.asarray(a) for a in rmoe._route(
        jnp.asarray(x), jnp.asarray(router), E, capacity))
    got_d, got_c = (a.numpy() for a in pmoe._route(
        _t(x), _t(router), E, capacity))
    logits = x @ router
    assert (logits[:, 0] == logits[:, 1]).any(), "no tie exercised"
    assert want_d.sum() < N, "no token dropped"
    np.testing.assert_array_equal(got_d, want_d)
    np.testing.assert_array_equal(got_c, want_c)


def test_moe_layer_parity_with_drops():
    # fp32 through three einsums of depth <= 32: 1e-5 covers the reordered
    # sums (values are O(1), fp32 eps 1.2e-7 times the depth, with margin)
    rng = np.random.default_rng(3)
    N, D, F, E = 48, 32, 32, 2
    ref = rmoe.MoEParams(
        router=jnp.asarray(rng.normal(size=(D, E)) / np.sqrt(D), jnp.float32),
        w_in=jnp.asarray(rng.normal(size=(E, D, F)) / np.sqrt(D), jnp.float32),
        w_out=jnp.asarray(rng.normal(size=(E, F, D)) / np.sqrt(F), jnp.float32))
    params = pmoe.MoEParams(*(_t(np.asarray(a)) for a in ref))
    # lean the tokens toward expert 0 so its capacity overflows
    lean = np.sign(np.asarray(ref.router[:, 0] - ref.router[:, 1]))
    x = (rng.normal(size=(N, D)) + 0.5 * lean).astype(np.float32)
    want = np.asarray(rmoe.moe_layer(ref, jnp.asarray(x), n_experts=E,
                                     capacity_factor=1.25))
    got = pmoe.moe_layer(params, _t(x), n_experts=E,
                         capacity_factor=1.25).numpy()
    dispatch, _ = pmoe._route(_t(x), params.router, E, int(1.25 * N / E))
    assert dispatch.sum() < N, "no token dropped"
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("cfg_kwargs", [CFG, DROP_CFG], ids=["cfg", "drops"])
def test_forward_local_parity(cfg_kwargs):
    ref_cfg, cfg, ref_params, params = _pair(cfg_kwargs)
    tokens = np.random.default_rng(4).integers(
        0, cfg.vocab, size=(2, 16)).astype(np.int32)
    want = np.asarray(rmodel.forward_local(ref_params, jnp.asarray(tokens),
                                           ref_cfg))
    got = pmodel.forward_local(params, _t(tokens), cfg)
    assert got.dtype == torch.float32 and got.shape == (2, 16, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4)


def test_loss_from_logits_parity():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(2, 16, 64)).astype(np.float32) * 4
    labels = rng.integers(0, 64, size=(2, 16)).astype(np.int32)
    want = float(rmodel._loss_from_logits(jnp.asarray(logits),
                                          jnp.asarray(labels)))
    got = float(pmodel._loss_from_logits(_t(logits), _t(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_bf16_forward_parity(monkeypatch):
    """The entry config in bfloat16.

    Routing first: fed the same bf16 activations, the router picks the same
    slots in both frameworks. In a whole forward the activations differ by
    rounding, and a token whose top two experts are nearly tied can take
    another expert in one framework, which moves its logits by O(1): no
    tolerance fits that. So the forward runs with the reference's dispatch
    and combine fed to both frameworks, layer by layer.

    Then the logits: a bf16 value carries 8 significant bits, and the two
    frameworks round at different places (accumulation order, fused vs
    separate casts). Each of the ~8 bf16 roundings on the path from the last
    layer to a logit may differ by one unit in the last place (2^-8
    relative), so the logits may differ by 8 * 2^-8 = 2^-5 of their largest
    magnitude."""
    kwargs = dict(vocab=256, d_model=128, n_heads=4, d_head=32, d_ff=256,
                  n_layers=2, n_experts=4, dtype="bfloat16")
    ref_cfg, cfg, ref_params, params = _pair(kwargs, seed=6)
    tokens = np.random.default_rng(6).integers(
        0, cfg.vocab, size=(2, 64)).astype(np.int32)

    h = rmodel._rmsnorm(jnp.take(ref_params.embed, jnp.asarray(tokens),
                                 axis=0), ref_params.layers.ln2[0])
    h = h.reshape(-1, cfg.d_model)
    capacity = int(cfg.expert_capacity_factor * h.shape[0] / cfg.n_experts)
    want_d, _ = rmoe._route(h, ref_params.layers.moe.router[0],
                            cfg.n_experts, capacity)
    h_t = pmodel._tensor_from_numpy(np.asarray(h), torch.device("cpu"))
    got_d, _ = pmoe._route(h_t, params.layers.moe.router[0], cfg.n_experts,
                           capacity)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))

    routes = []
    ref_route = rmoe._route

    def recording_route(*args):
        out = ref_route(*args)
        jax.debug.callback(lambda d, c: routes.append((_t(d), _t(c))), *out,
                           ordered=True)
        return out

    monkeypatch.setattr(rmoe, "_route", recording_route)
    monkeypatch.setattr(pmoe, "_route", lambda *args: routes.pop(0))
    want = np.asarray(rmodel.forward_local(ref_params, jnp.asarray(tokens),
                                           ref_cfg))
    jax.effects_barrier()
    assert len(routes) == cfg.n_layers
    got = pmodel.forward_local(params, _t(tokens), cfg).numpy()
    assert not routes
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -5 * np.abs(want).max())


def test_params_from_numpy_is_exact_and_init_matches_layout():
    ref_cfg = RefConfig(**dict(CFG, dtype="bfloat16"))
    cfg = ModelConfig(**dict(CFG, dtype="bfloat16"))
    ref_params = rmodel.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = pmodel.params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                      device="cpu")
    ref_leaves = jax.tree.leaves(ref_params)
    leaves = jax.tree.leaves(params)
    assert len(leaves) == len(ref_leaves)
    for got, want in zip(leaves, ref_leaves):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy(),
            np.asarray(want).view(np.int16))

    gen = torch.Generator().manual_seed(0)
    fresh = pmodel.init_params(cfg, gen, device="cpu")
    for got, want in zip(jax.tree.leaves(fresh), ref_leaves):
        assert tuple(got.shape) == tuple(want.shape)
        # same scale: the spread of normal(0, 1/sqrt(fan_in)) draws (or the
        # all-ones norms) agrees within sampling noise
        g, w = got.float().numpy(), np.asarray(want).astype(np.float32)
        assert abs(g.std() - w.std()) <= 0.1 * w.std() + 1e-6


def test_entry_runs_on_cpu():
    fn, (params, tokens) = entry(device="cpu")
    out = fn(params, tokens)
    assert out.shape == (2, 64, 256) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
