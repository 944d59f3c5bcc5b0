"""The port's event-driven simulator (``repro_torch.sim``) against the JAX
package's ``repro.sim``, and against the port's own protocol driver.

* the event queue, the network models and the policies are numpy and
  equal the JAX package's exactly;
* sync over a static network equals the port's protocol driver bit for
  bit: Eq. (12) times, dropout rates and global params, on a homogeneous
  fleet (the engine) and a ragged one (the grouped engine);
* a 3-round Markov-fading run of each policy (sync, deadline with and
  without partial aggregation, retry, async) equals ``repro.sim.run_sim``
  on the same inputs: the event trace by kind, client and order exactly,
  event times and ``sim_time`` to rtol 1e-6, participants and dropout
  rates exactly, global params to atol 1e-5 (the tolerance of
  tests/test_torch_protocol.py);
* the straggler demo's settings (the paper's MLP, synthetic MNIST
  4000/1000, 8 clients, the Markov network) order the three policies'
  final ``sim_time`` as the JAX package's demo does;
* policy semantics the JAX package's tests pin (deadline drops the
  straggler, async buffers, observed telemetry, stale losses).
"""

import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro_torch import sim
from repro_torch.core import protocol
from repro_torch.sim.engine import EventQueue, Simulator

from torch_sim_parity import (assert_close_to_jax, j_params, ltf_jax,
                              ltf_torch, np_params, np_sub_params, nbytes,
                              t_params, telemetry, trees_equal)


@pytest.fixture(autouse=True)
def _one_thread():
    """Bit-for-bit comparisons of two runs pin one CPU thread (a float32
    reduction's blocking can change with the thread count)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- engine, networks, policies: numpy twins ---------------------------------

def test_event_queue_orders_by_time_then_schedule_seq():
    q, jq = EventQueue(), jsim.EventQueue()
    for t, kind, c in ((2.0, "b", 1), (1.0, "a", 2), (1.0, "a2", 3),
                       (0.5, "z", 4)):
        q.push(t, kind, c)
        jq.push(t, kind, c)
    got = [q.pop() for _ in range(4)]
    want = [jq.pop() for _ in range(4)]
    assert [e.kind for e in got] == ["z", "a", "a2", "b"]
    assert [(e.time, e.seq, e.kind, e.client) for e in got] == \
        [(e.time, e.seq, e.kind, e.client) for e in want]


def test_simulator_clock_monotone_and_traced():
    s = Simulator()
    s.schedule(3.0, "x", 1)
    s.schedule(1.0, "y", 2)
    ev = s.step()
    assert (ev.kind, s.now) == ("y", 1.0)
    with pytest.raises(ValueError):
        s.schedule_at(0.5, "past", 3)
    s.step()
    assert s.trace == [(1.0, "y", 2), (3.0, "x", 1)]
    with pytest.raises(ValueError):
        s.advance_to(1.0)
    s.advance_to(10.0)
    assert s.now == 10.0
    s.schedule(1.0, "a")
    s.schedule(2.0, "b")
    assert [e.kind for e in s.queue.clear()] == ["a", "b"]
    assert not s.queue


def _net_pairs(n):
    tel, jtel = telemetry(n, 6), telemetry(n, 6, jax_side=True)
    yield sim.StaticNetwork(tel), jsim.StaticNetwork(jtel)
    yield (sim.MarkovFadingNetwork(tel, p_fade=0.3, p_recover=0.4,
                                   fade_factor=0.05, compute_slowdown=2.0,
                                   seed=7),
           jsim.MarkovFadingNetwork(jtel, p_fade=0.3, p_recover=0.4,
                                    fade_factor=0.05, compute_slowdown=2.0,
                                    seed=7))
    yield (sim.TraceNetwork.straggler_collapse(tel, clients=(0, 3)),
           jsim.TraceNetwork.straggler_collapse(jtel, clients=(0, 3)))
    yield (sim.make_network("markov", tel, seed=3),
           jsim.make_network("markov", jtel, seed=3))


def test_networks_equal_jax_package_exactly():
    for net, jnet in _net_pairs(5):
        assert net.num_clients == jnet.num_clients == 5
        for e in (0, 3, 1, 7, 12, 2):       # out of order: memoised chains
            a, b = net.conditions(e), jnet.conditions(e)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    tel = telemetry(5, 6)
    c0 = sim.MarkovFadingNetwork(tel, seed=3).conditions(0)
    np.testing.assert_array_equal(c0.uplink_rate, tel.uplink_rate)


def test_policies_equal_jax_package_exactly():
    exp = np.random.default_rng(0).uniform(1.0, 9.0, 11)
    for name, kw in (("sync", {}), ("deadline", {}),
                     ("deadline", dict(quantile=0.5, slack=2.0,
                                       partial=True)),
                     ("retry", {}), ("retry", dict(slack=1.5))):
        a, b = sim.make_policy(name, **kw), jsim.make_policy(name, **kw)
        assert a.horizon(exp) == b.horizon(exp)
        assert a.name == b.name
    a, b = sim.AsyncPolicy(alpha=0.7), jsim.AsyncPolicy(alpha=0.7)
    s = np.array([0, 1, 3, 9])
    np.testing.assert_array_equal(a.staleness_scale(s), b.staleness_scale(s))
    for n in (1, 3, 8, 17):
        assert a.resolved_buffer(n) == b.resolved_buffer(n)
    assert sim.SyncPolicy().horizon(exp) == float("inf")
    with pytest.raises(ValueError, match="unknown policy"):
        sim.make_policy("nope")


# --- sync + static == the port's protocol, bit for bit -----------------------

def test_sync_static_reproduces_protocol_bit_exact():
    n = 6
    kw = dict(rounds=5, a_server=0.6, h=3, seed=0, device="cpu")
    ref = protocol.run_scheme("feddd", t_params(np_params()), telemetry(n),
                              ltf_torch, None, **kw)
    got = sim.run_sim("feddd", t_params(np_params()), telemetry(n),
                      ltf_torch, None, sim=sim.SimConfig(policy="sync"),
                      **kw)
    assert len(got.history) == 5
    for rr, rg in zip(ref.history, got.history):
        assert rr.sim_time == rg.sim_time
        assert rr.sim_round_time == pytest.approx(rg.sim_round_time,
                                                  rel=1e-12)
        assert rr.uploaded_fraction == rg.uploaded_fraction
        assert rr.participants == rg.participants
        np.testing.assert_array_equal(rr.dropout_rates, rg.dropout_rates)
    assert trees_equal(ref.global_params, got.global_params)


def test_sync_static_ragged_reproduces_protocol_bit_exact():
    n, widths = 6, (12, 8, 5)
    clients = [np_sub_params(100 + i, widths[i % 3]) for i in range(n)]
    tel = telemetry(n, 2, [nbytes(c) for c in clients])
    kw = dict(rounds=4, a_server=0.6, h=3, seed=0, device="cpu")
    srv = protocol.FedDDServer(
        t_params(np_params()), protocol.ProtocolConfig(scheme="feddd", **{
            k: v for k, v in kw.items() if k != "device"}),
        tel, [t_params(c) for c in clients], device="cpu")
    assert srv.executor_kind == "grouped"
    ref = srv.run(ltf_torch)
    got = sim.run_sim("feddd", t_params(np_params()), tel, ltf_torch, None,
                      client_params=[t_params(c) for c in clients],
                      sim=sim.SimConfig(policy="sync"), **kw)
    for rr, rg in zip(ref.history, got.history):
        assert rr.sim_time == rg.sim_time
        np.testing.assert_array_equal(rr.dropout_rates, rg.dropout_rates)
        assert rr.uploaded_bytes == rg.uploaded_bytes
    assert trees_equal(ref.global_params, got.global_params)


def test_run_scheme_sim_kwarg_routes_to_simulator():
    n = 4
    kw = dict(rounds=2, a_server=0.6, h=5, seed=0, device="cpu")
    res = protocol.run_scheme("feddd", t_params(np_params(1)),
                              telemetry(n, 1), ltf_torch, None, sim=True,
                              **kw)
    assert isinstance(res, sim.SimResult)
    assert len(res.event_trace) == 3 * n * 2        # 3 events/client/round
    res2 = protocol.run_scheme(
        "feddd", t_params(np_params(1)), telemetry(n, 1), ltf_torch, None,
        sim=True, client_params=[t_params(np_params(1))] * n, **kw)
    assert trees_equal(res.global_params, res2.global_params)
    with pytest.raises(ValueError, match="client_params"):
        protocol.run_scheme("feddd", t_params(np_params(1)), telemetry(n, 1),
                            ltf_torch, None, sim=True,
                            client_params=[t_params(np_params(1))] * (n + 1),
                            rounds=1, device="cpu")
    with pytest.raises(ValueError, match="requires population"):
        protocol.run_scheme("feddd", t_params(np_params(1)), telemetry(n, 1),
                            ltf_torch, None, cohort_size=2, device="cpu")


# --- the port against repro.sim.run_sim --------------------------------------

def _markov(tel, mod):
    return mod.MarkovFadingNetwork(tel, p_fade=0.3, p_recover=0.4,
                                   fade_factor=0.05, seed=7)


@pytest.mark.parametrize("scheme,policy", [
    ("feddd", "sync"), ("feddd", "deadline"), ("feddd", "partial"),
    ("feddd", "retry"), ("feddd", "async"), ("fedavg", "deadline"),
    ("fedcs", "sync")])
def test_markov_run_matches_jax_package(scheme, policy):
    n = 6
    kw = dict(rounds=6 if policy == "async" else 3, a_server=0.6, h=2,
              seed=0)
    pol = {"partial": lambda m: m.DeadlinePolicy(partial=True)}.get(
        policy, lambda m: policy)
    want = jsim.run_sim(scheme, j_params(np_params()),
                        telemetry(n, jax_side=True), ltf_jax, None,
                        sim=jsim.SimConfig(policy=pol(jsim)),
                        network=_markov(telemetry(n, jax_side=True), jsim),
                        **kw)
    got = sim.run_sim(scheme, t_params(np_params()), telemetry(n),
                      ltf_torch, None, sim=sim.SimConfig(policy=pol(sim)),
                      network=_markov(telemetry(n), sim), device="cpu",
                      **kw)
    assert [(k, c) for _, k, c in got.event_trace] == \
        [(k, c) for _, k, c in want.event_trace]
    np.testing.assert_allclose([e[0] for e in got.event_trace],
                               [e[0] for e in want.event_trace], rtol=1e-6)
    assert len(got.history) == len(want.history) == kw["rounds"]
    for g, w in zip(got.history, want.history):
        assert g.participants == w.participants
        np.testing.assert_allclose(g.sim_time, w.sim_time, rtol=1e-6)
        np.testing.assert_array_equal(g.dropout_rates, w.dropout_rates)
        np.testing.assert_allclose(g.uploaded_fraction, w.uploaded_fraction,
                                   rtol=1e-6)
        np.testing.assert_allclose(g.abandoned_bytes, w.abandoned_bytes,
                                   rtol=1e-6, atol=1e-9)
    if policy == "partial":     # a cut upload's prefix was aggregated
        assert any(r.wire_bytes > r.uploaded_bytes for r in got.history)
    assert_close_to_jax(got.global_params, want.global_params, atol=1e-5)


def test_straggler_demo_orders_policies_as_jax_package():
    """The demo's settings (full-width MLP, synthetic MNIST 4000/1000, 8
    clients, the Markov network, A_server 0.6, h 5, 10 rounds; async
    at rounds x (clients // buffer) merges): the three policies' final
    ``sim_time`` come in the JAX package's order, each within 1e-3."""
    import jax
    from repro.data import (label_coverage_score, make_dataset,
                            partition_noniid_b)
    from repro.fl import (MLP_SPEC, init_cnn_spec, make_local_train_fn,
                          model_bytes, sample_system_telemetry)
    from repro_torch import straggler_sim

    rounds, clients = 10, 8
    got = straggler_sim.run(rounds, clients, device="cpu", eval_every=0)
    train, _ = make_dataset("mnist", num_train=4000, num_test=1000)
    parts = partition_noniid_b(train, clients, seed=0)
    params = init_cnn_spec(jax.random.PRNGKey(0), MLP_SPEC)
    tel = sample_system_telemetry(
        clients, [model_bytes(params)] * clients, [len(p) for p in parts],
        [label_coverage_score(train, p) for p in parts], seed=0)
    ltf = make_local_train_fn(MLP_SPEC, train, parts, flatten=True, lr=0.1)
    want = {}
    for policy in straggler_sim.POLICIES:
        net = jsim.MarkovFadingNetwork(tel, p_fade=0.25, p_recover=0.5,
                                       fade_factor=0.1, seed=1)
        want[policy] = jsim.run_sim(
            "feddd", params, tel, ltf, None,
            sim=jsim.SimConfig(policy=policy), network=net,
            rounds=straggler_sim.policy_rounds(policy, rounds, clients),
            a_server=0.6, h=5, seed=0).history[-1].sim_time
    have = {p: r.history[-1].sim_time for p, r in got.items()}
    assert sorted(have, key=have.get) == sorted(want, key=want.get)
    assert have["deadline"] < have["sync"]
    for p in want:
        np.testing.assert_allclose(have[p], want[p], rtol=1e-3)
    assert 0.55 < got["sync"].history[1].uploaded_fraction < 0.65


# --- policy semantics ---------------------------------------------------------

def _straggler_trace_net(tel, factor=50.0, fade_from=1):
    """Client 0's uplink collapses by ``factor`` from epoch ``fade_from``."""
    return sim.TraceNetwork.straggler_collapse(
        tel, clients=(0,), factor=factor, from_epoch=fade_from)


def test_deadline_drops_straggler_and_finishes_earlier():
    n = 6
    tel = telemetry(n, 3)
    kw = dict(rounds=5, a_server=0.6, h=3, seed=0, device="cpu")
    runs = {p: sim.run_sim("feddd", t_params(np_params(2)), tel, ltf_torch,
                           None, sim=sim.SimConfig(policy=p),
                           network=_straggler_trace_net(tel), **kw)
            for p in ("sync", "deadline")}
    assert all(r.participants == n for r in runs["sync"].history)
    assert any(r.participants < n for r in runs["deadline"].history)
    assert all(r.participants >= 1 for r in runs["deadline"].history)
    assert runs["deadline"].history[-1].sim_time < \
        runs["sync"].history[-1].sim_time


def test_async_buffer_and_merge_times():
    n = 8
    res = sim.run_sim("feddd", t_params(np_params(3)), telemetry(n, 4),
                      ltf_torch, None, sim=sim.SimConfig(policy="async"),
                      rounds=6, a_server=0.6, h=3, seed=0, device="cpu")
    k = sim.AsyncPolicy().resolved_buffer(n)
    assert k == 2
    assert all(r.participants == k for r in res.history)
    times = [r.sim_time for r in res.history]
    assert all(b > a for a, b in zip(times, times[1:]))


def test_observed_telemetry_adapts_dropout_to_fading_link():
    """The LP runs on OBSERVED rates: when client 0's uplink collapses, the
    server's estimate tracks it down and pushes D_0 toward D_max."""
    n = 6
    tel = telemetry(n, 5)
    res = sim.run_sim("feddd", t_params(np_params(4)), tel, ltf_torch, None,
                      sim=sim.SimConfig(policy="sync"),
                      network=_straggler_trace_net(tel, fade_from=2),
                      rounds=8, a_server=0.6, d_max=0.9, h=20, seed=0,
                      device="cpu")
    obs = res.observed_telemetry
    assert obs.uplink_rate[0] < 0.2 * tel.uplink_rate[0]
    d0 = np.asarray([r.dropout_rates[0] for r in res.history])
    assert d0[0] < 0.1
    assert d0[-1] > 0.6
    assert np.all(np.diff(d0) >= -1e-9)


def test_async_rejects_selection_baselines():
    for scheme in ("fedcs", "oort"):
        with pytest.raises(ValueError, match="async"):
            sim.run_sim(scheme, t_params(np_params(6)), telemetry(4, 8),
                        ltf_torch, None, sim=sim.SimConfig(policy="async"),
                        rounds=1, device="cpu")


def test_deadline_dropped_straggler_loss_stays_stale():
    """The loss report ships WITH the upload: a client whose transfer was
    abandoned must not update the server's loss view."""
    n = 6
    tel = telemetry(n, 3)
    counters = {i: 1.0 for i in range(n)}

    def halving_ltf(p, idx, key):
        counters[idx] *= 0.5
        return p, counters[idx]

    res = sim.run_sim("feddd", t_params(np_params(7)), tel, halving_ltf,
                      None, sim=sim.SimConfig(policy="deadline"),
                      network=_straggler_trace_net(tel, factor=500.0),
                      rounds=4, a_server=0.6, h=5, seed=0, device="cpu")
    assert [r for r in res.history if r.participants < n]
    for rec in res.history:
        fresh = 2.0 ** -rec.round
        if rec.participants == n:
            assert rec.mean_loss == pytest.approx(fresh)
        else:
            assert rec.mean_loss > fresh * (1 + 1e-9)
