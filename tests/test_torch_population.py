"""The port's population serving (``repro_torch.population`` and the
simulator's cohort path) against the JAX package's ``repro.population``.

* availability draws, every availability model and every cohort sampler
  (with evolving sticky state) equal the JAX package's exactly;
* identity: a population the size of the fleet with always-on
  availability equals the plain fleet bit for bit — the sim on the
  stacked engine and on the grouped engine, and the port's scanned
  protocol path (``rounds_per_dispatch`` with ``allocator="jax"``);
* churn: a 100-client population served 8 at a time under Bernoulli
  availability equals the JAX package's run (cohorts, store arrays
  exactly; event times and ``sim_time`` to rtol 1e-6; global params to
  atol 1e-5) and updates the sticky state only for served clients;
* the params the store keeps are copies that own their storage, never
  views of a cohort's stack.
"""

import numpy as np
import pytest
import torch

from repro import population as jpop
from repro import sim as jsim
from repro.population.availability import _TAG_AVAIL as J_TAG_AVAIL
from repro_torch import population as pop_mod
from repro_torch import sim, tree
from repro_torch.core import protocol, round_engine
from repro_torch.population import Population
from repro_torch.population.availability import _TAG_AVAIL

from torch_sim_parity import (assert_close_to_jax, j_params, ltf_jax,
                              ltf_torch, np_params, np_sub_params, nbytes,
                              t_params, telemetry, trees_equal)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _assert_runs_identical(ref, got):
    assert ref.event_trace == got.event_trace
    for rr, rg in zip(ref.history, got.history):
        assert (rr.sim_time, rr.mean_loss, rr.uploaded_bytes,
                rr.wire_bytes) == (rg.sim_time, rg.mean_loss,
                                   rg.uploaded_bytes, rg.wire_bytes)
        np.testing.assert_array_equal(rr.dropout_rates, rg.dropout_rates)
    assert trees_equal(ref.global_params, got.global_params)


# --- draws and samplers: exactly the JAX package's ---------------------------

def test_availability_draws_equal_jax_package():
    assert _TAG_AVAIL == J_TAG_AVAIL
    ids = np.arange(100_000)
    for seed, epoch in ((7, 0), (7, 5), (2**40 + 3, 1000)):
        np.testing.assert_array_equal(
            pop_mod.uniform_draws(seed, _TAG_AVAIL, epoch, ids),
            jpop.uniform_draws(seed, _TAG_AVAIL, epoch, ids))
    for name, kw in (("always", {}), ("bernoulli", {"p": 0.4}),
                     ("diurnal", {"duty": 0.3, "period": 6.0}),
                     ("trace", {"trace": np.eye(5, 257, dtype=bool)})):
        size = 257
        a = pop_mod.make_availability(name, size, seed=11, **kw)
        b = jpop.make_availability(name, size, seed=11, **kw)
        sub = np.array([0, 9, 256, 31])
        for e in range(7):
            np.testing.assert_array_equal(a.online(e), b.online(e))
            np.testing.assert_array_equal(a.online(e, clients=sub),
                                          a.online(e)[sub])
    with pytest.raises(ValueError, match="unknown availability"):
        pop_mod.make_availability("nope", 4)
    with pytest.raises(ValueError, match="covers"):
        pop_mod.make_availability(pop_mod.AlwaysOn(3), 4)


@pytest.mark.parametrize("sampler", ["uniform", "weighted", "oort"])
def test_samplers_and_store_equal_jax_package(sampler):
    size, k = 97, 16
    a = Population(telemetry(size, 5), availability="bernoulli",
                   sampler=sampler, seed=3)
    b = jpop.Population(telemetry(size, 5, jax_side=True),
                        availability="bernoulli", sampler=sampler, seed=3)
    rng = np.random.default_rng(0)
    for epoch in range(6):
        ca, cb = a.sample_cohort(epoch, k), b.sample_cohort(epoch, k)
        np.testing.assert_array_equal(ca, cb)
        assert len(ca) == k and (np.sort(ca) == ca).all()
        assert a.first_contact(ca) == b.first_contact(cb)
        kw = dict(arrived=rng.uniform(size=k) < 0.8,
                  failed=rng.uniform(size=k) < 0.1,
                  losses=rng.uniform(0.1, 1.0, k),
                  uplink_bytes=rng.uniform(0, 10.0, k),
                  utilities=rng.uniform(1.0, 2.0, k))
        a.record_round(epoch, ca, **kw)
        b.record_round(epoch, cb, **kw)
    for f in ("seen", "last_round", "rounds_participated", "uploaded_bytes",
              "failures", "loss", "dropout", "utility"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # scarce online sets top up deterministically, as in the JAX package
    online = np.array([2, 7], np.int64)
    a.last_round[15], b.last_round[15] = 99, 99
    for name in ("uniform", "weighted", "oort"):
        np.testing.assert_array_equal(
            pop_mod.make_sampler(name, seed=4).sample(9, 5, online, a),
            jpop.make_sampler(name, seed=4).sample(9, 5, online, b))
    with pytest.raises(ValueError, match="identity sampler"):
        Population(telemetry(5), sampler="identity").sample_cohort(0, 3)


def test_cold_start_mean_equals_jax_package():
    base, jbase = telemetry(12, 7), telemetry(12, 7, jax_side=True)
    a = Population(base, cold_start="mean")
    b = jpop.Population(jbase, cold_start="mean")
    ids = np.array([0, 3, 5, 9])
    a.seen[[0, 5]] = b.seen[[0, 5]] = True
    import dataclasses
    ta = dataclasses.replace(base.subset(ids),
                             train_loss=np.array([0.2, 0.8, 0.4, 0.6]))
    tb = dataclasses.replace(jbase.subset(ids),
                             train_loss=np.array([0.2, 0.8, 0.4, 0.6]))
    oa, ob = a.lp_telemetry(ta, ids), b.lp_telemetry(tb, ids)
    for f in dataclasses.fields(oa):
        np.testing.assert_array_equal(getattr(oa, f.name),
                                      getattr(ob, f.name))
    assert Population(base).lp_telemetry(ta, ids) is ta


# --- identity contracts: population == fleet, bit for bit --------------------

def test_identity_contract_stacked_engine_bit_exact():
    n = 6
    kw = dict(rounds=5, a_server=0.6, h=3, seed=0, device="cpu",
              sim=sim.SimConfig(policy="sync"))
    ref = sim.run_sim("feddd", t_params(np_params()), telemetry(n),
                      ltf_torch, None, **kw)
    got = sim.run_sim("feddd", t_params(np_params()), telemetry(n),
                      ltf_torch, None, population=Population(telemetry(n)),
                      **kw)
    _assert_runs_identical(ref, got)


def test_identity_contract_grouped_bit_exact():
    n, widths = 4, (12, 8, 12, 6)
    subs = [np_sub_params(100 + i, w) for i, w in enumerate(widths)]
    tel = telemetry(n, 0, [nbytes(s) for s in subs])
    kw = dict(rounds=3, a_server=0.6, h=2, seed=0, device="cpu",
              sim=sim.SimConfig(policy="sync"))
    ref = sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch, None,
                      client_params=[t_params(s) for s in subs], **kw)
    got = sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch, None,
                      client_params=[t_params(s) for s in subs],
                      population=Population(tel), **kw)
    _assert_runs_identical(ref, got)


def test_identity_contract_scanned_path_bit_exact():
    """A key-free trainer, the same arithmetic per client in the sim and
    stacked in the scanned chunk: the population-identity sim with the
    float32 allocator equals ``FedDDServer``'s ``rounds_per_dispatch=4``
    path exactly — Eq. (12) clock, rates, losses and global params."""
    n = 8

    def loss_of(w):
        return torch.mean(torch.abs(w), dim=tuple(range(1, w.ndim)))

    def ltf(p, idx, key):
        new = tree.tree_map(lambda x: x * 0.99, p)
        return new, loss_of(new["fc0"]["w"][None])[0]

    def batched(stacked, key):
        new = tree.tree_map(lambda x: x * 0.99, stacked)
        return new, loss_of(new["fc0"]["w"])

    kw = dict(scheme="feddd", rounds=7, a_server=0.6, h=3, seed=0,
              allocator="jax")
    scan = protocol.FedDDServer(
        t_params(np_params()),
        protocol.ProtocolConfig(rounds_per_dispatch=4, **kw),
        telemetry(n), device="cpu").run(batched_train_fn=batched)
    pop = sim.run_sim("feddd", t_params(np_params()), telemetry(n), ltf,
                      None, population=Population(telemetry(n)),
                      sim=sim.SimConfig(policy="sync"), rounds=7,
                      a_server=0.6, h=3, seed=0, allocator="jax",
                      device="cpu")
    for hs, hp in zip(scan.history, pop.history):
        assert hs.mean_loss == hp.mean_loss
        assert hs.sim_time == hp.sim_time
        np.testing.assert_array_equal(hs.dropout_rates, hp.dropout_rates)
    assert trees_equal(scan.global_params, pop.global_params)


# --- churn -------------------------------------------------------------------

def test_churn_run_matches_jax_package_and_updates_sticky_state():
    P, K, R = 100, 8, 5
    a = Population(telemetry(P), availability="bernoulli",
                   sampler="uniform", seed=3)
    b = jpop.Population(telemetry(P, jax_side=True),
                        availability="bernoulli", sampler="uniform", seed=3)
    kw = dict(cohort_size=K, rounds=R, a_server=0.6, h=3, seed=0)
    got = sim.run_sim("feddd", t_params(np_params()), telemetry(P),
                      ltf_torch, None, population=a, device="cpu",
                      sim=sim.SimConfig(policy="sync"), **kw)
    want = jsim.run_sim("feddd", j_params(np_params()),
                        telemetry(P, jax_side=True), ltf_jax, None,
                        population=b, sim=jsim.SimConfig(policy="sync"),
                        **kw)
    assert [(k, c) for _, k, c in got.event_trace] == \
        [(k, c) for _, k, c in want.event_trace]
    np.testing.assert_allclose([r.sim_time for r in got.history],
                               [r.sim_time for r in want.history],
                               rtol=1e-6)
    for f in ("seen", "last_round", "rounds_participated", "failures",
              "loss", "dropout"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    np.testing.assert_allclose(a.uploaded_bytes, b.uploaded_bytes,
                               rtol=1e-6)
    assert_close_to_jax(got.global_params, want.global_params, atol=1e-5)
    served = int(a.seen.sum())
    assert K < served <= K * R
    assert not a.rounds_participated[~a.seen].any()
    assert not a.uploaded_bytes[~a.seen].any()
    assert len(a._params) == served


def test_stored_rows_are_copies_not_views():
    """The store keeps each served client's params as tensors that own
    their storage: a view would pin the cohort's whole (K, ...) stack and
    alias the next in-place write to it."""
    P, K = 40, 8
    pop = Population(telemetry(P), availability="bernoulli", seed=1)
    sim.run_sim("feddd", t_params(np_params()), telemetry(P), ltf_torch,
                None, population=pop, cohort_size=K, rounds=4,
                a_server=0.6, h=3, seed=0, device="cpu")
    assert len(pop._params) > K
    for p in pop._params.values():
        for leaf in tree.leaves(p):
            assert leaf.untyped_storage().nbytes() == \
                leaf.numel() * leaf.element_size()
    # fold_back of views taken from a stack: the stack is not shared
    stack = round_engine.stack_pytrees([t_params(np_params(i))
                                        for i in range(3)])
    rows = round_engine.unstack_pytree(stack, 3)
    pop.fold_back(np.array([0, 1, 2]), rows, dropout=np.zeros(3),
                  losses=np.ones(3))
    stack["fc0"]["w"].zero_()
    assert trees_equal(pop._params[1], t_params(np_params(1)))


def test_population_guards_and_routing():
    n = 6
    p = t_params(np_params())
    base = dict(rounds=2, a_server=0.6, h=3, seed=0, device="cpu")
    with pytest.raises(ValueError, match="cohort_size requires"):
        sim.run_sim("feddd", p, telemetry(n), ltf_torch, None,
                    cohort_size=4, **base)
    with pytest.raises(ValueError, match="population size"):
        sim.run_sim("feddd", p, telemetry(n), ltf_torch, None,
                    population=Population(telemetry(n + 1)), **base)
    with pytest.raises(ValueError, match="sync/deadline/retry"):
        sim.run_sim("feddd", p, telemetry(n), ltf_torch, None,
                    population=Population(telemetry(n)), cohort_size=2,
                    sim=sim.SimConfig(policy="async"), **base)
    with pytest.raises(ValueError, match="RunState"):
        sim.run_sim("feddd", p, telemetry(n), ltf_torch, None,
                    population=Population(telemetry(n)),
                    checkpoint_every=1, checkpoint_path="unused.npz",
                    **base)
    with pytest.raises(ValueError, match="cold_start"):
        Population(telemetry(n), cold_start="bogus")
    with pytest.raises(ValueError):
        protocol.ProtocolConfig(cohort_size=4)
    with pytest.raises(ValueError):
        protocol.ProtocolConfig(population=10, cohort_size=11)
    pop = Population(telemetry(10), availability="bernoulli", seed=2)
    res = protocol.run_scheme("feddd", p, telemetry(10), ltf_torch, None,
                              population=pop, cohort_size=4, rounds=3,
                              a_server=0.6, h=3, seed=0, device="cpu")
    assert isinstance(res, sim.SimResult) and len(res.history) == 3
    assert int(pop.seen.sum()) >= 4
