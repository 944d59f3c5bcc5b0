"""Robust Eq. (4) (``robust_agg``: ``"trimmed[:beta]"``, ``"clip[:factor]"``)
of the PyTorch port against the JAX package.

Spec parsing and the hand-computed reductions of the JAX package's tests
(``tests/test_robust_agg.py``) hold exactly; on seeded client-stacked
leaves both variants agree with ``repro.core.aggregation`` to rtol 1e-5,
atol 1e-6 (float32 sums in another order); whole runs with a key-free
trainer give equal rates and records and global parameters within atol
1e-5; the adversarial-client scenario behaves as in the JAX package; the
loop rejects robust specs.  The clip variant's Eq. (4) partials go
through the ``sparse_agg`` kernel's partials mode (its plain version
here): ``ops.mode_counts`` shows it on the card
(``tests/test_torch_cuda.py``).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jax_agg
from repro.core import protocol as jax_protocol
from repro.core.allocation import ClientTelemetry as JaxTelemetry
from repro_torch import convert, tree
from repro_torch.core import aggregation, protocol
from repro_torch.core.allocation import ClientTelemetry

from torch_parity import assert_trees_close, jax_tree, torch_tree


def _params(seed=0, w=12):
    rng = np.random.default_rng(seed)
    return {"fc0": {"w": rng.normal(size=(20, w)).astype(np.float32),
                    "b": np.zeros(w, np.float32)},
            "fc1": {"w": rng.normal(size=(w, 5)).astype(np.float32),
                    "b": np.zeros(5, np.float32)}}


def _nbytes(p):
    return float(sum(l.size * l.dtype.itemsize
                     for l in jax.tree_util.tree_leaves(p)))


def _tel(cls, n, nbytes, seed=0):
    rng = np.random.default_rng(seed)
    return cls(model_bytes=np.full(n, nbytes),
               uplink_rate=rng.uniform(1e3, 5e3, n),
               downlink_rate=rng.uniform(5e3, 2e4, n),
               compute_latency=rng.uniform(1.0, 5.0, n),
               num_samples=rng.integers(10, 50, n).astype(float),
               label_coverage=rng.uniform(0.5, 1.0, n),
               train_loss=np.ones(n))


def _trainer(flatten, unflatten, wrap, adversary=False):
    """local_train_fn adding a perturbation fixed per (client, round) and
    reporting a numpy loss; with ``adversary`` client 0 adds 500 to every
    value (corrupt but finite)."""
    calls = collections.Counter()

    def ltf(params, i, _key):
        r = calls[i]
        calls[i] += 1
        rng = np.random.default_rng([i, r])
        leaves, treedef = flatten(params)
        new = [np.asarray(l) + (500.0 if adversary and i == 0 else
                                rng.normal(0, 0.05, l.shape))
               for l in leaves]
        return (unflatten(treedef, [wrap(x.astype(np.float32)) for x in new]),
                float(0.5 + rng.uniform()))

    return ltf


def _run_port(n=6, robust=None, adversary=False, rounds=3, **kw):
    params = _params()
    if robust is not None:
        kw["robust_agg"] = robust
    return protocol.run_scheme(
        "feddd", convert.to_torch(params, "cpu"),
        _tel(ClientTelemetry, n, _nbytes(params)),
        _trainer(tree.flatten, tree.unflatten, torch.from_numpy, adversary),
        device="cpu", rounds=rounds, a_server=0.6, h=3, seed=0, **kw)


def _run_jax(n=6, robust=None, rounds=3):
    params = _params()
    kw = {} if robust is None else dict(robust_agg=robust)
    return jax_protocol.run_scheme(
        "feddd", jax_tree(params), _tel(JaxTelemetry, n, _nbytes(params)),
        _trainer(jax.tree_util.tree_flatten, jax.tree_util.tree_unflatten,
                 jnp.asarray), rounds=rounds, a_server=0.6, h=3, seed=0,
        **kw)


def _fields(rec):
    d = dataclasses.asdict(rec)
    d.pop("host_wall_time")
    d["dropout_rates"] = d["dropout_rates"].tolist()
    return d


# --- spec parsing -----------------------------------------------------------

@pytest.mark.parametrize("spec", [None, "mean", "trimmed", "trimmed:0.25",
                                  "clip", "clip:3.5", "trimmed:0"])
def test_parse_robust_agg_specs_match_jax(spec):
    assert (aggregation.parse_robust_agg(spec)
            == jax_agg.parse_robust_agg(spec))


def test_parse_robust_agg_rejects_bad_specs():
    for spec, match in (("mean:0.1", "takes no parameter"),
                        ("trimmed:0.5", r"beta must be in \[0,0.5\)"),
                        ("clip:0", "clip factor"),
                        ("krum", "unknown robust_agg")):
        with pytest.raises(ValueError, match=match):
            aggregation.parse_robust_agg(spec)
        with pytest.raises(ValueError, match=match):
            jax_agg.parse_robust_agg(spec)
    with pytest.raises(ValueError, match="unknown robust_agg"):
        protocol.ProtocolConfig(robust_agg="median-of-means")


# --- hand-computed reductions (the JAX package's cases) ---------------------

def test_trimmed_mean_hand_computed():
    vals = torch.tensor([0.0, 1.0, 2.0, 3.0, 100.0])
    out = aggregation.aggregate_sparse_stacked(
        {"w": vals[:, None].expand(5, 3).contiguous()},
        {"w": torch.ones(5, 1)}, np.ones(5), robust="trimmed:0.2")
    assert torch.equal(out["w"], torch.full((3,), 2.0))


def test_trimmed_mean_counts_only_valid_contributors():
    vals = torch.tensor([0.0, 1.0, 2.0, 3.0, 100.0])
    masks = {"w": torch.tensor([[1.0, 1.0], [0.0, 1.0], [1.0, 1.0],
                                [1.0, 1.0], [1.0, 1.0]])}
    got = aggregation.aggregate_sparse_stacked(
        {"w": vals[:, None].expand(5, 2).contiguous()}, masks, np.ones(5),
        robust="trimmed:0.25")["w"]
    assert got.tolist() == [2.5, 2.0]
    out2 = aggregation.aggregate_sparse_stacked(
        {"w": vals[:, None]}, {"w": torch.ones(5, 1)},
        np.asarray([1.0, 1.0, 1.0, 1.0, 0.0]), robust="trimmed:0.25")
    assert out2["w"].tolist() == [1.5]


def test_trimmed_mean_empty_coordinate_falls_back_to_prev_global():
    out = aggregation.aggregate_sparse_stacked(
        {"w": torch.tensor([[1.0], [2.0]])}, {"w": torch.zeros(2, 1)},
        np.ones(2), prev_global={"w": torch.tensor([7.0])},
        robust="trimmed:0.2")
    assert out["w"].tolist() == [7.0]


def test_clip_hand_computed_and_requires_prev_global():
    """Norms [1000, 1, 2, 3] against factor x median = 2.5: the updates
    of 1000 and 3 scale onto the 2.5 ball, so the mean is 2 (an even
    count: the median is the mean of the two middle norms)."""
    stacked = {"w": torch.tensor([[1000.0], [1.0], [2.0], [3.0]])}
    masks = {"w": torch.ones(4, 1)}
    out = aggregation.aggregate_sparse_stacked(
        stacked, masks, np.ones(4), prev_global={"w": torch.zeros(1)},
        robust="clip:1.0")
    np.testing.assert_allclose(out["w"].numpy(), [2.0], rtol=1e-6)
    with pytest.raises(ValueError, match="needs prev_global"):
        aggregation.aggregate_sparse_stacked(stacked, masks, np.ones(4),
                                             robust="clip:1.0")


@pytest.mark.parametrize("norms_valid", [[4.0, 1.0, 3.0], [2.0, 5.0],
                                         [7.0], []])
def test_nanmedian_is_numpys(norms_valid):
    x = torch.tensor(norms_valid + [float("nan")] * 2, dtype=torch.float32)
    got = aggregation._nanmedian(x)
    want = np.asarray(jnp.nanmedian(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)


# --- seeded leaves against the JAX package ----------------------------------

def _stacked_inputs(rng, n, zero_weight):
    vals = {"fc0": {"w": rng.normal(size=(n, 20, 12)).astype(np.float32),
                    "b": rng.normal(size=(n, 12)).astype(np.float32)},
            "fc1": {"w": rng.normal(size=(n, 12, 5)).astype(np.float32),
                    "b": rng.normal(size=(n, 5)).astype(np.float32)}}
    masks = jax.tree_util.tree_map(
        lambda v: (rng.uniform(size=(n,) + (1,) * (v.ndim - 2)
                               + v.shape[-1:]) > 0.3).astype(np.float32),
        vals)
    vals["fc0"]["w"][1] *= 40.0                  # an outlier client
    prev = jax.tree_util.tree_map(
        lambda v: rng.normal(size=v.shape[1:]).astype(np.float32), vals)
    w = rng.integers(1, 9, n).astype(np.float64)
    if zero_weight:
        w[2] = 0.0
    return vals, masks, prev, w


@pytest.mark.parametrize("spec", ["trimmed", "trimmed:0.25", "clip",
                                  "clip:2.0"])
@pytest.mark.parametrize("zero_weight", [False, True])
def test_robust_leaves_match_jax(spec, zero_weight):
    vals, masks, prev, w = _stacked_inputs(np.random.default_rng(3), 7,
                                           zero_weight)
    got = aggregation.aggregate_sparse_stacked(
        torch_tree(vals), torch_tree(masks), w,
        prev_global=torch_tree(prev), robust=spec)
    want = jax_agg.aggregate_sparse_stacked(
        jax_tree(vals), jax_tree(masks), w, prev_global=jax_tree(prev),
        robust=spec)
    assert_trees_close(got, want, rtol=1e-5, atol=1e-6)


def test_clip_scales_match_jax():
    vals, masks, prev, w = _stacked_inputs(np.random.default_rng(4), 6,
                                           True)
    deltas_t = [(torch.from_numpy(v) - torch.from_numpy(p))
                * torch.from_numpy(m) for v, m, p in zip(
                    tree.leaves(vals), tree.leaves(masks), tree.leaves(prev))]
    got = aggregation._clip_scales(deltas_t, torch.from_numpy(w).float(),
                                   1.5)
    want = jax_agg._clip_scales([jnp.asarray(d.numpy()) for d in deltas_t],
                                jnp.asarray(w, jnp.float32), 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert (got < 1.0).any() and (got == 1.0).any()


# --- whole runs --------------------------------------------------------------

@pytest.mark.parametrize("spec", ["trimmed:0.2", "clip:2.0"])
def test_robust_runs_match_jax(spec):
    got, want = _run_port(robust=spec), _run_jax(robust=spec)
    for g, w in zip(got.history, want.history):
        np.testing.assert_array_equal(g.dropout_rates, w.dropout_rates)
        assert g.sim_time == w.sim_time and g.mean_loss == w.mean_loss
        np.testing.assert_allclose(g.uploaded_fraction, w.uploaded_fraction,
                                   rtol=1e-6)
    assert_trees_close(got.global_params, want.global_params, rtol=0,
                       atol=1e-5)


def test_mean_spec_bit_identical_batched():
    ref, got = _run_port(), _run_port(robust="mean")
    assert [_fields(r) for r in ref.history] == [_fields(r)
                                                 for r in got.history]
    for a, b in zip(tree.leaves(ref.global_params),
                    tree.leaves(got.global_params)):
        assert torch.equal(a, b)


def test_adversarial_client_mean_diverges_trimmed_and_clip_hold():
    runs = {spec: _run_port(n=8, robust=spec, adversary=True)
            for spec in (None, "trimmed:0.25", "clip:2.0")}
    peak = {k: float(r.global_params["fc0"]["w"].abs().max())
            for k, r in runs.items()}
    assert peak[None] > 50.0
    assert peak["trimmed:0.25"] < 10.0
    assert peak["clip:2.0"] < peak[None] / 2
    for leaf in tree.leaves(runs["trimmed:0.25"].global_params):
        assert torch.isfinite(leaf).all()


def test_robust_specs_close_to_mean_on_clean_fleet():
    mean = _run_port(n=8)
    trimmed = _run_port(n=8, robust="trimmed:0.125")
    for a, b in zip(tree.leaves(mean.global_params),
                    tree.leaves(trimmed.global_params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=0.2)


def test_loop_path_rejects_robust_specs():
    with pytest.raises(ValueError, match="fused into the engine"):
        _run_port(n=4, robust="trimmed", batched=False, rounds=1)
