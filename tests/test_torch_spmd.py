"""The port's SPMD path held against brpc_tpu on the CPU: ring attention,
the SPMD forward, the train step, the dry run and the gradient scale.

The same inputs (numpy seeds, and for the dry run the reference's own
init; the reference's parameters carried across by ``params_from_numpy``)
go through the JAX functions on the 8-device CPU mesh and through the
port in one 8-rank gloo world per module (the dry run spawns its own, as
its entry point does). Every world has a deadline, so a hung collective
fails its test. Tolerances are the reference tests' own:
2e-5 for ring attention, 3e-4 for fp32 logits; a train step's loss within
1e-4 and every updated leaf within 1e-5 (lr 0.1 times gradients that agree
to fp32 rounding).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from brpc_tpu.jaxcompat import shard_map
from brpc_tpu.tensor import model as rmodel
from brpc_tpu.tensor import moe as rmoe
from brpc_tpu.tensor.config import MeshSpec as RefMeshSpec
from brpc_tpu.tensor.config import ModelConfig as RefConfig
from brpc_tpu.tensor.ring_attention import ring_attention as ref_ring
from brpc_tpu_torch.entry import (
    _dryrun_config,
    _dryrun_shapes,
    _dryrun_specs,
    dryrun_multichip,
)
from brpc_tpu_torch.parallel import run_ranks
from brpc_tpu_torch.parallel.world import tensors_to_numpy
from brpc_tpu_torch.tensor import model as pmodel
from brpc_tpu_torch.tensor.config import MeshSpec, ModelConfig
from brpc_tpu_torch.tensor.ring_attention import local_attention
import torch_spmd_ranks  # tests/ is on sys.path (rootdir insertion)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device test mesh"
)

WORLD_DEADLINE_S = 120.0
LR = 0.1
# tests/test_tensor_model.py's CFG: fp32, capacity factor == n_experts, so
# the sharded MoE drops no token and equals the local one
CFG = dict(vocab=64, d_model=32, n_heads=4, d_head=8, d_ff=32, n_layers=1,
           n_experts=4, expert_capacity_factor=4.0, dtype="float32")
FWD_MESHES = {"dp-tp-sp": MeshSpec(dp=2, tp=2, sp=2),
              "dp-pp-ep": MeshSpec(dp=2, pp=2, ep=2),
              "pp-tp-sp": MeshSpec(pp=2, tp=2, sp=2)}
DRYRUN_SPECS = _dryrun_specs(8)


def _dryrun_case(spec):
    batch, seq, n_microbatches = _dryrun_shapes(spec)
    return (spec, dataclasses.asdict(_dryrun_config(spec)), n_microbatches,
            batch, seq)


# (spec, config, microbatches, batch, seq): the two dry-run meshes with the
# dry run's configs and shapes, and test_tensor_model's train-step mesh
TRAIN = {
    "dryrun-dp-tp-sp": _dryrun_case(DRYRUN_SPECS[0]),
    "dryrun-dp-pp-ep": _dryrun_case(DRYRUN_SPECS[1]),
    "dp-pp-tp": (MeshSpec(dp=2, pp=2, tp=2), CFG, 2, 8, 16),
}
# ROADMAP queue C #6: the reference's update divided by lr, projected on
# the single-device gradient of the mean loss; (other leaves, w_in/w_out)
GRAD_SCALE = {"dryrun-dp-tp-sp": (4.0, 4.0),
              "dryrun-dp-pp-ep": (4.0, 8.0),
              "dp-pp-tp": (4.0, 4.0)}


def _ref_spec(spec):
    return RefMeshSpec(**spec.shape)


def _ref_params(cfg_kwargs, pp_stages, seed=0):
    """Reference Params drawn from a numpy seed with init_params' shapes
    and scales (jax.random's eager init costs about a second each here)."""
    cfg = RefConfig(**cfg_kwargs)
    rng = np.random.default_rng(seed)
    L, d, dq, f, e = (cfg.n_layers * pp_stages, cfg.d_model, cfg.d_qkv,
                      cfg.d_ff, cfg.n_experts)

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


def _np_params(ref_params):
    """The reference's Params as the port's Params with numpy leaves: what
    a rank can be sent without importing brpc_tpu."""
    return tensors_to_numpy(pmodel.params_from_numpy(
        jax.tree.map(np.asarray, ref_params), device="cpu"))


def _tokens(seed, batch, seq, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(batch, seq)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ref_step(name):
    spec, cfg, n_microbatches, _, _ = TRAIN[name]
    return rmodel.make_spmd_train_step(RefConfig(**cfg), _ref_spec(spec),
                                       n_microbatches=n_microbatches,
                                       lr=LR)[1]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    ring = tuple(rng.normal(size=(2, 32, 4, 8)).astype(np.float32)
                 for _ in range(3))
    fwd = {name: (_ref_params(CFG, spec.pp),
                  _tokens(1, spec.dp * 2, spec.sp * 8, CFG["vocab"]))
           for name, spec in FWD_MESHES.items()}
    train = {name: (_ref_params(cfg, spec.pp),
                    _tokens(2, batch, seq, cfg["vocab"]))
             for name, (spec, cfg, _, batch, seq) in TRAIN.items()}
    return {"ring": ring, "forward": fwd, "train": train}


@pytest.fixture(scope="module")
def port(inputs):
    """Every case in one 8-rank gloo world; per case, every rank's output."""
    cases = [("ring", MeshSpec(sp=8), *inputs["ring"])]
    names = ["ring"]
    for name, spec in FWD_MESHES.items():
        params, tokens = inputs["forward"][name]
        cases.append(("forward", spec, CFG, _np_params(params), tokens))
        names.append(f"forward/{name}")
    for name, (spec, cfg, n_microbatches, _, _) in TRAIN.items():
        params, tokens = inputs["train"][name]
        cases.append(("train", spec, cfg, _np_params(params), tokens,
                      n_microbatches, LR))
        names.append(f"train/{name}")
    ranks = run_ranks(torch_spmd_ranks.spmd_cases, 8, args=(cases,),
                      device="cpu", deadline_s=WORLD_DEADLINE_S)
    return {name: [r[i] for r in ranks] for i, name in enumerate(names)}


@pytest.fixture(scope="module")
def ref_train(inputs):
    """The reference's first step on each train mesh: (loss, new params)."""
    out = {}
    for name in TRAIN:
        params, tokens = inputs["train"][name]
        tokens = jnp.asarray(tokens)
        loss, new = _ref_step(name)(params, tokens, jnp.roll(tokens, -1, 1))
        out[name] = (float(loss), jax.tree.map(np.asarray, new))
    return out


def test_ring_attention_matches_local_and_reference(port, inputs):
    q, k, v = inputs["ring"]
    got = pmodel.unshard(port["ring"], (None, "sp"), MeshSpec(sp=8))
    local = local_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                            causal=True).numpy()
    np.testing.assert_allclose(got, local, atol=2e-5)

    mesh = Mesh(np.array(jax.devices()[:8]), ("sp",))
    ring = shard_map(lambda q, k, v: ref_ring(q, k, v, "sp", causal=True),
                     mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                     out_specs=P(None, "sp"), check=False)
    want = np.asarray(jax.jit(ring)(q, k, v))
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("name", list(FWD_MESHES))
def test_spmd_forward_matches_reference(port, inputs, name):
    spec = FWD_MESHES[name]
    params, tokens = inputs["forward"][name]
    _, fwd = rmodel.make_spmd_forward(RefConfig(**CFG), _ref_spec(spec),
                                      n_microbatches=1)
    want = np.asarray(fwd(params, jnp.asarray(tokens)))
    got = pmodel.unshard(port[f"forward/{name}"], pmodel.LOGITS_SPEC, spec)
    assert got.shape == want.shape == tokens.shape + (CFG["vocab"],)
    np.testing.assert_allclose(got, want, atol=3e-4)


@pytest.mark.parametrize("name", list(TRAIN))
def test_spmd_train_step_matches_reference(port, ref_train, name):
    spec = TRAIN[name][0]
    want_loss, want = ref_train[name]
    losses = [loss for loss, _ in port[f"train/{name}"]]
    for loss in losses:
        assert abs(float(loss) - want_loss) <= 1e-4, (loss, want_loss)
    got = pmodel.unshard_params([new for _, new in port[f"train/{name}"]],
                                spec)
    assert len(pmodel._tree_leaves(got)) == len(jax.tree.leaves(want))
    for g, w in zip(pmodel._tree_leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def _true_grads(cfg_kwargs, params, tokens):
    """The single-device gradient of the mean loss (the port's
    forward_local, held against the reference's by test_torch_model)."""
    cfg = ModelConfig(**cfg_kwargs)
    p = pmodel.params_from_numpy(jax.tree.map(np.asarray, params),
                                 device="cpu")
    leaves = [t.requires_grad_() for t in pmodel._tree_leaves(p)]
    tokens = torch.from_numpy(tokens)
    labels = torch.roll(tokens, -1, dims=1)
    loss = pmodel._loss_from_logits(pmodel.forward_local(p, tokens, cfg),
                                    labels) / tokens.numel()
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


@pytest.mark.parametrize("name", list(TRAIN))
def test_gradient_scale_of_reference_and_port(port, inputs, ref_train, name):
    """ROADMAP queue C #6, pinned in both packages: the update the train
    step applies is the true gradient times dp*sp*pp (the loss psum's
    transpose is a psum), and expert weights also times ep (the
    all_to_all's transpose returns every ep peer's cotangent)."""
    spec = TRAIN[name][0]
    params, tokens = inputs["train"][name]
    true = _true_grads(TRAIN[name][1], params, tokens)
    before = [np.asarray(a) for a in jax.tree.leaves(params)]
    ref_new = jax.tree.leaves(ref_train[name][1])
    port_new = pmodel._tree_leaves(pmodel.unshard_params(
        [new for _, new in port[f"train/{name}"]], spec))
    expert = {8, 9}  # leaf order: embed, ln1, wq, wk, wv, wo, ln2,
    #                   router, w_in, w_out, final_norm
    other_scale, expert_scale = GRAD_SCALE[name]
    for i, (p0, g) in enumerate(zip(before, true)):
        want = expert_scale if i in expert else other_scale
        for new in (ref_new[i], port_new[i]):
            applied = (p0 - new) / LR
            scale = float((applied * g).sum() / (g * g).sum())
            assert abs(scale - want) <= 1e-3 * want, (name, i, scale, want)


def test_dryrun_matches_reference(capsys):
    """The dry run's loss0 and loss3 on the reference's own parameters and
    tokens (jax.random keys 0 and 1, as __graft_entry__ draws them)."""
    inputs, want = [], []
    for name, spec in zip(("dryrun-dp-tp-sp", "dryrun-dp-pp-ep"),
                          DRYRUN_SPECS):
        cfg = TRAIN[name][1]
        batch, seq, _ = _dryrun_shapes(spec)
        params = rmodel.init_params(RefConfig(**cfg), jax.random.PRNGKey(0),
                                    pp_stages=spec.pp)
        tokens = jax.random.randint(jax.random.PRNGKey(1), (batch, seq), 0,
                                    cfg["vocab"], dtype=jnp.int32)
        labels = jnp.roll(tokens, -1, axis=1)
        step = _ref_step(name)
        loss0, new = step(params, tokens, labels)
        for _ in range(3):
            loss3, new = step(new, tokens, labels)
        want.append((float(loss0), float(loss3)))
        inputs.append((_np_params(params), np.asarray(tokens)))
    got = dryrun_multichip(8, device="cpu", inputs=inputs,
                           deadline_s=WORLD_DEADLINE_S)
    printed = capsys.readouterr().out
    assert printed.count("dryrun_multichip ok: mesh=") == 2
    for r, (loss0, loss3), spec in zip(got, want, DRYRUN_SPECS):
        assert r["mesh"] == spec.shape
        assert abs(r["loss0"] - loss0) <= 1e-4, (r, loss0)
        assert abs(r["loss3"] - loss3) <= 1e-4, (r, loss3)
        assert r["loss3"] < r["loss0"]
