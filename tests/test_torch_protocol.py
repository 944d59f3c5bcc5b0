"""The slice as a whole: ``run_scheme`` of the PyTorch port against the JAX
package, plus the pieces around it (data, telemetry, models, SGD, eval).

Both packages start from the JAX package's MLP parameters (carried over
with ``repro_torch.convert``) and train with the same key-free trainer:
each (client, round) adds a fixed numpy-drawn perturbation and reports a
numpy-drawn loss, so both see identical losses and the numpy LP gives
identical dropout rates.  Over 4 rounds with h=3 (round 3 is a full
Eq. (6) round): dropout rates and the Eq. (12) ``sim_time`` are equal,
``uploaded_fraction`` agrees to rtol 1e-6 and the global parameters to
atol 1e-5.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import protocol as jax_protocol
from repro.data import partition as jax_part
from repro.data import synthetic as jax_synth
from repro.fl import heterogeneity as jax_het
from repro.fl import models as jax_models
from repro_torch import convert, tree
from repro_torch.core import protocol
from repro_torch.data import partition, synthetic
from repro_torch.fl import heterogeneity, models

from torch_parity import assert_trees_close

N_CLIENTS = 10


def _jax_params(spec=jax_models.MLP_SPEC, seed=0):
    return jax.device_get(jax_models.init_cnn_spec(jax.random.PRNGKey(seed),
                                                   spec))


def _keyfree_trainer(flatten, unflatten, wrap):
    """local_train_fn(params, i, key) adding a perturbation fixed per
    (client, round) and reporting a numpy loss; ``flatten``/``unflatten``
    are the package's tree functions, ``wrap`` its array type."""
    calls = collections.Counter()

    def ltf(params, i, _key):
        r = calls[i]
        calls[i] += 1
        rng = np.random.default_rng([i, r])
        leaves, treedef = flatten(params)
        new = [wrap(np.asarray(l) + rng.normal(0, 0.01, l.shape)
                    .astype(np.float32)) for l in leaves]
        return unflatten(treedef, new), float(0.5 + rng.uniform())

    return ltf


def _telemetry(het, params_bytes):
    rng = np.random.default_rng(1)
    samples = rng.integers(300, 900, N_CLIENTS)
    cover = rng.uniform(1.0, 3.0, N_CLIENTS)
    return het.sample_system_telemetry(
        N_CLIENTS, [params_bytes] * N_CLIENTS, samples, cover, seed=0)


@pytest.mark.parametrize("scheme", ["feddd", "fedavg"])
def test_run_scheme_matches_jax(scheme):
    params = _jax_params()
    nbytes = jax_models.model_bytes(params)
    kw = dict(rounds=4, a_server=0.6, h=3, seed=0)
    want = jax_protocol.run_scheme(
        scheme, jax.tree_util.tree_map(jnp.asarray, params),
        _telemetry(jax_het, nbytes),
        _keyfree_trainer(jax.tree_util.tree_flatten,
                         jax.tree_util.tree_unflatten, jnp.asarray), **kw)
    got = protocol.run_scheme(
        scheme, convert.to_torch(params, "cpu"),
        _telemetry(heterogeneity, nbytes),
        _keyfree_trainer(tree.flatten, tree.unflatten, torch.from_numpy),
        device="cpu", **kw)
    assert len(got.history) == len(want.history) == 4
    for g, w in zip(got.history, want.history):
        np.testing.assert_array_equal(g.dropout_rates, w.dropout_rates)
        assert g.sim_time == w.sim_time
        assert g.sim_round_time == w.sim_round_time
        assert g.mean_loss == w.mean_loss
        assert g.participants == w.participants
        np.testing.assert_allclose(g.uploaded_fraction, w.uploaded_fraction,
                                   rtol=1e-6)
    if scheme == "feddd":
        assert 0.55 < got.history[1].uploaded_fraction < 0.65
    assert_trees_close(got.global_params, want.global_params, rtol=0,
                       atol=1e-5)


def test_data_and_telemetry_copies_are_equal():
    for name in ("mnist", "cifar10"):
        tr_t, te_t = synthetic.make_dataset(name, num_train=400,
                                            num_test=100, seed=2)
        tr_j, te_j = jax_synth.make_dataset(name, num_train=400,
                                            num_test=100, seed=2)
        for a, b in ((tr_t, tr_j), (te_t, te_j)):
            np.testing.assert_array_equal(a.x, b.x)
            np.testing.assert_array_equal(a.y, b.y)
    parts_t = partition.partition_noniid_b(tr_t, 7, seed=3)
    parts_j = jax_part.partition_noniid_b(tr_j, 7, seed=3)
    assert len(parts_t) == len(parts_j)
    for a, b in zip(parts_t, parts_j):
        np.testing.assert_array_equal(a, b)
        assert (partition.label_coverage_score(tr_t, a)
                == jax_part.label_coverage_score(tr_j, b))
    tel_t = heterogeneity.sample_system_telemetry(
        7, [1e5] * 7, [len(p) for p in parts_t], [2.0] * 7, seed=4)
    tel_j = jax_het.sample_system_telemetry(
        7, [1e5] * 7, [len(p) for p in parts_j], [2.0] * 7, seed=4)
    for field in ("model_bytes", "uplink_rate", "downlink_rate",
                  "compute_latency", "num_samples", "label_coverage",
                  "train_loss"):
        np.testing.assert_array_equal(getattr(tel_t, field),
                                      getattr(tel_j, field))


@pytest.mark.parametrize("spec_name,image", [("MLP_SPEC", (784,)),
                                             ("CNN1_SPEC", (16, 16, 1)),
                                             ("CNN2_SPEC", (32, 32, 3))])
def test_apply_spec_logits_match_jax(spec_name, image):
    params = _jax_params(getattr(jax_models, spec_name), seed=3)
    x = np.random.default_rng(0).uniform(-1, 1, (8,) + image).astype(
        np.float32)
    want = jax_models.apply_spec(jax.tree_util.tree_map(jnp.asarray, params),
                                 getattr(jax_models, spec_name),
                                 jnp.asarray(x))
    got = models.apply_spec(convert.to_torch(params, "cpu"),
                            getattr(models, spec_name), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_one_sgd_step_and_eval_match_jax():
    """A 64-sample shard at batch size 64 is one SGD step over the whole
    shard, so the shuffle order only reorders the batch's sum."""
    train, test = synthetic.make_dataset("mnist", num_train=256,
                                         num_test=200, seed=5)
    parts = [np.arange(0, 64), np.arange(64, 128)]
    params = _jax_params(seed=7)
    jltf = jax_models.make_local_train_fn(jax_models.MLP_SPEC, train, parts,
                                          lr=0.1, batch_size=64,
                                          flatten=True)
    tltf = models.make_local_train_fn(models.MLP_SPEC, train, parts, lr=0.1,
                                      batch_size=64, flatten=True,
                                      device="cpu")
    jp, jloss = jltf(jax.tree_util.tree_map(jnp.asarray, params), 1,
                     jax.random.PRNGKey(0))
    tp, tloss = tltf(convert.to_torch(params, "cpu"), 1,
                     torch.Generator().manual_seed(0))
    assert_trees_close(tp, jp, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tloss), jloss, rtol=1e-5, atol=1e-5)
    acc_j = jax_models.make_eval_fn(jax_models.MLP_SPEC, test,
                                    flatten=True)(jp)["accuracy"]
    acc_t = models.make_eval_fn(models.MLP_SPEC, test, flatten=True,
                                device="cpu")(tp)["accuracy"]
    assert acc_t == acc_j
    assert models.model_bytes(tp) == jax_models.model_bytes(jp)


def test_convert_roundtrip_keeps_bits():
    params = _jax_params(seed=2)
    back = convert.to_numpy(convert.to_torch(params, "cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(params), tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    bf = jax.device_get(jax.tree_util.tree_map(
        lambda x: jnp.asarray(x).astype(jnp.bfloat16), params))
    t = convert.to_torch(bf, "cpu")
    for a, b in zip(jax.tree_util.tree_leaves(params), tree.leaves(t)):
        assert b.dtype == torch.bfloat16
        want = torch.from_numpy(np.array(a)).to(torch.bfloat16)
        assert torch.equal(b, want)
