"""The slice as a whole: ``run_scheme`` of the PyTorch port against the JAX
package, plus the pieces around it (data, telemetry, models, SGD, eval).

With the real trainer (threefry shuffles, ``repro_torch.prng``) and the
JAX package's initial parameters carried over, 3 quickstart-configuration
rounds over every wire format give equal dropout rates, uploaded and wire
bytes, Eq. (12) times, participants, survivors and the other
``RoundRecord`` fields; the mean losses agree to rtol 1e-6 and the
global parameters to atol 1e-6 (float32 SGD in another order), plus one
fp16 or int8 step of the leaf where the uploads are quantized.

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
                     np.asarray(jax.random.PRNGKey(0)))
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


def test_local_train_shuffles_as_jax_does():
    """Two epochs over a 200-sample shard at batch 32: the threefry
    shuffle of each epoch orders the minibatches as the JAX package's
    does, so the parameters after 12 SGD steps agree (atol 1e-6) and the
    mean loss to rtol 1e-6; a Python float, as there."""
    train, _ = synthetic.make_dataset("mnist", num_train=400, num_test=10,
                                      seed=6)
    parts = [np.arange(0, 200), np.arange(200, 400)]
    params = _jax_params(seed=4)
    kw = dict(lr=0.1, batch_size=32, local_epochs=2, flatten=True)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    jp, jloss = jax_models.make_local_train_fn(
        jax_models.MLP_SPEC, train, parts, **kw)(
        jax.tree_util.tree_map(jnp.asarray, params), 0, key)
    tp, tloss = models.make_local_train_fn(
        models.MLP_SPEC, train, parts, device="cpu", **kw)(
        convert.to_torch(params, "cpu"), 0, np.asarray(key))
    assert isinstance(tloss, float)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-6)
    assert_trees_close(tp, jp, rtol=0, atol=1e-6)


@pytest.mark.parametrize("spec_name", ["MLP_SPEC", "CNN1_SPEC", "CNN2_SPEC"])
def test_init_draws_the_jax_values(spec_name):
    """``init_cnn_spec(spec, key)`` splits the key per layer and scales
    threefry normals as the JAX package does: equal biases, weights within
    8 float32 ulps (the normal's stated bound, plus the scaling's one
    rounding)."""
    key = jax.random.PRNGKey(9)
    want = jax_models.init_cnn_spec(key, getattr(jax_models, spec_name))
    got = models.init_cnn_spec(getattr(models, spec_name), np.asarray(key),
                               device="cpu")
    for g, w in zip(tree.leaves(got), jax.tree_util.tree_leaves(want)):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        ulps = np.abs(g.numpy().view(np.int32).astype(np.int64)
                      - w.view(np.int32))
        assert ulps.max() <= 8
    same = models.init_cnn_spec(models.MLP_SPEC, seed=9, device="cpu")
    for a, b in zip(tree.leaves(same), tree.leaves(models.init_cnn_spec(
            models.MLP_SPEC, np.asarray(key), device="cpu"))):
        assert torch.equal(a, b)


def test_eval_per_class_matches_jax():
    """``per_class=True`` adds ``acc_class_<c>`` for every class of the
    test set, as the JAX package's eval does (a class with no test sample
    reads 0.0)."""
    train, test = synthetic.make_dataset("mnist", num_train=100,
                                         num_test=300, seed=8)
    keep = test.y != 7                     # class 7 absent
    test = test.subset(np.flatnonzero(keep))
    params = _jax_params(seed=5)
    want = jax_models.make_eval_fn(jax_models.MLP_SPEC, test, flatten=True,
                                   per_class=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    got = models.make_eval_fn(models.MLP_SPEC, test, flatten=True,
                              per_class=True, device="cpu")(
        convert.to_torch(params, "cpu"))
    assert got == want
    assert got["acc_class_7"] == 0.0 and len(got) == 1 + test.num_classes
    assert set(models.make_eval_fn(models.MLP_SPEC, test, flatten=True,
                                   device="cpu")(
        convert.to_torch(params, "cpu"))) == {"accuracy"}


def _quickstart_pieces(syn, part, het, fl, **kw):
    """The quickstart's data, partition, telemetry, trainer and eval, cut
    to 1200/300 samples (10 non-IID clients, lr 0.1)."""
    train, test = syn.make_dataset("mnist", num_train=1200, num_test=300)
    parts = part.partition_noniid_b(train, N_CLIENTS, seed=0)
    tel = het.sample_system_telemetry(
        N_CLIENTS, [341_656] * N_CLIENTS, [len(p) for p in parts],
        [part.label_coverage_score(train, p) for p in parts], seed=0)
    return (tel, fl.make_local_train_fn(fl.MLP_SPEC, train, parts,
                                        flatten=True, lr=0.1, **kw),
            fl.make_eval_fn(fl.MLP_SPEC, test, flatten=True, **kw))


RECORD_EQUAL = ("round", "sim_time", "sim_round_time", "uploaded_fraction",
                "uploaded_bytes", "wire_bytes", "participants", "survivors",
                "epsilon", "retries", "abandoned_bytes", "quarantined_bytes",
                "skipped", "metrics")


@pytest.mark.parametrize("selection_scheme,codec,qbits,aware", [
    ("feddd", "dense", 32, False), ("feddd", "auto", 8, False),
    ("random", "index", 16, False), ("feddd", "bitmask", 8, True)])
def test_run_scheme_with_the_real_trainer_matches_jax(selection_scheme,
                                                      codec, qbits, aware):
    from repro.comm.payload import CommConfig as JaxComm
    from repro.core.selection import SelectionConfig as JaxSel
    from repro_torch.comm import CommConfig
    from repro_torch.core.selection import SelectionConfig
    params = _jax_params()
    kw = dict(rounds=3, a_server=0.6, h=5, seed=0)
    jtel, jltf, jef = _quickstart_pieces(jax_synth, jax_part, jax_het,
                                         jax_models)
    want = jax_protocol.run_scheme(
        "feddd", jax.tree_util.tree_map(jnp.asarray, params), jtel, jltf,
        jef, selection=JaxSel(scheme=selection_scheme),
        comm=JaxComm(codec=codec, qbits=qbits,
                     overhead_aware_allocation=aware), **kw)
    ttel, tltf, tef = _quickstart_pieces(synthetic, partition,
                                         heterogeneity, models, device="cpu")
    got = protocol.run_scheme(
        "feddd", convert.to_torch(params, "cpu"), ttel, tltf, tef,
        selection=SelectionConfig(scheme=selection_scheme),
        comm=CommConfig(codec=codec, qbits=qbits,
                        overhead_aware_allocation=aware),
        device="cpu", **kw)
    assert len(got.history) == len(want.history) == 3
    for g, w in zip(got.history, want.history):
        np.testing.assert_array_equal(g.dropout_rates, w.dropout_rates)
        for field in RECORD_EQUAL:
            assert getattr(g, field) == getattr(w, field), field
        np.testing.assert_allclose(g.mean_loss, w.mean_loss, rtol=1e-6)
    assert got.history[0].survivors == N_CLIENTS
    if codec != "dense":
        assert got.history[1].wire_bytes < got.history[1].uploaded_bytes
    # a float32 difference of ~1e-7 in a client's trained value can move
    # its fp16 rounding or its int8 code by one step: the tolerance is then
    # that step (of the leaf's largest value), as the codecs state
    step = {32: 0.0, 16: 2.0 ** -11, 8: 1.0 / 127}[qbits]
    for g, w in zip(tree.leaves(got.global_params),
                    jax.tree_util.tree_leaves(want.global_params)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 + step * np.abs(w).max())
