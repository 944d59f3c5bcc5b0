"""The fused and scanned multi-round FedDD paths of the PyTorch port:
``batched_train_fn``, ``rounds_per_dispatch``, the float32 device
allocator (``allocator="jax"``), the traced Oort selector and the tensor
rendering of the analytic wire bytes, against the JAX package and
against the port's own per-round path.

Against the JAX package: ``partition_iid`` equal; the allocator twin's
rates within 5e-5 of ``solve_dropout_rates_jax`` on
``tests/test_allocation.py``'s fixture (the largest difference there,
3.57e-5 at seed 0 and A_server 0.6, is the golden-section bracket a few
ulps apart, taken up by the knapsack's fractional client), on the budget
at rtol 1e-4 and within rtol 1e-3 of the numpy LP's objective; the
traced Oort selector equal to both of the JAX package's selectors; the
vmapped MLP step within atol 1e-6; fused per-round runs with the real
SGD trainer walked round by round while every keep count agrees.

Against the port itself, bit for bit: K scanned rounds equal K per-round
fused rounds (records, global and client params) for every scheme, chunk
length, wire format and robust variant.  Runs compared bit for bit pin
one intra-op thread (``one_thread``).
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import payload as jax_payload
from repro.core import baselines as jax_base
from repro.core import protocol as jax_protocol
from repro.core import round_engine as jax_engine
from repro.core.allocation import ClientTelemetry as JaxTelemetry
from repro.core.allocation import solve_dropout_rates_with as jax_alloc_with
from repro.data import partition as jax_part
from repro.data import synthetic as jax_synth
from repro.fl import models as jax_models
from repro_torch import convert, obs, prng, tree
from repro_torch.comm import CommConfig
from repro_torch.comm import payload
from repro_torch.core import allocation, baselines, round_engine
from repro_torch.core.allocation import ClientTelemetry
from repro_torch.core.protocol import FedDDServer, ProtocolConfig
from repro_torch.core.selection import SelectionConfig, keep_count_host
from repro_torch.data import partition, synthetic
from repro_torch.fl import models

from torch_parity import assert_trees_close, jax_tree

SPEC = [("fc", 20, 12), ("fc", 12, 5)]


@pytest.fixture
def one_thread():
    """One intra-op thread: CPU float32 GEMMs block the same way in every
    run, so two runs compare bit for bit."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tel(cls, n, nbytes, seed=0):
    rng = np.random.default_rng(seed)
    return cls(model_bytes=np.full(n, nbytes),
               uplink_rate=rng.uniform(1e3, 5e3, n),
               downlink_rate=rng.uniform(5e3, 2e4, n),
               compute_latency=rng.uniform(1.0, 5.0, n),
               num_samples=rng.integers(10, 50, n).astype(float),
               label_coverage=rng.uniform(0.5, 1.0, n),
               train_loss=np.ones(n))


def _data(n, seed, shard=32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, shard, 20)).astype(np.float32),
            rng.integers(0, 5, (n, shard)))


def _torch_step(p, x, y):
    """One full-shard SGD step at lr 0.1 (the reference benchmark's)."""
    def loss(q):
        return models._ce(models.apply_spec(q, SPEC, x), y)
    g, l = torch.func.grad_and_value(loss)(p)
    return tree.tree_map(lambda w, gw: w - 0.1 * gw, p, g), l


def _jax_step(p, x, y):
    def loss(q):
        logits = jax_models.apply_spec(q, SPEC, x)
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]
        return jnp.mean(logz - gold)
    l, g = jax.value_and_grad(loss)(p)
    return jax.tree_util.tree_map(lambda w, gw: w - 0.1 * gw, p, g), l


def _fixture(n=8, seed=0):
    """(numpy params, nbytes, port trainer, JAX trainer, data)."""
    params = jax.device_get(jax_models.init_cnn_spec(
        jax.random.PRNGKey(seed), SPEC))
    xs, ys = _data(n, seed)
    bt = round_engine.make_batched_train_fn(
        _torch_step, (torch.from_numpy(xs), torch.from_numpy(ys)))
    jbt = jax.jit(jax_engine.make_batched_train_fn(
        _jax_step, (jnp.asarray(xs), jnp.asarray(ys))))
    return params, float(models.model_bytes(convert.to_torch(params, "cpu"))), \
        bt, jbt


def _fields(rec):
    d = dataclasses.asdict(rec)
    d.pop("host_wall_time")
    d["dropout_rates"] = d["dropout_rates"].tolist()
    return d


def _port_run(params, tel, bt, **kw):
    srv = FedDDServer(convert.to_torch(params, "cpu"), ProtocolConfig(**kw),
                      tel, device="cpu")
    return srv, srv.run(batched_train_fn=bt)


def _assert_runs_equal(a, b):
    (sa, ra), (sb, rb) = a, b
    assert [_fields(r) for r in ra.history] == [_fields(r)
                                                for r in rb.history]
    for x, y in zip(tree.leaves(ra.global_params),
                    tree.leaves(rb.global_params)):
        assert torch.equal(x, y)
    for ca, cb in zip(sa.clients, sb.clients):
        for x, y in zip(tree.leaves(ca.params), tree.leaves(cb.params)):
            assert torch.equal(x, y)


# --- data, allocator, selector, wire bytes ----------------------------------

def test_partition_iid_equals_jax():
    tr_t, _ = synthetic.make_dataset("mnist", num_train=6000, num_test=10)
    tr_j, _ = jax_synth.make_dataset("mnist", num_train=6000, num_test=10)
    for k in (1, 7, 10):
        got = partition.partition_iid(tr_t, k, seed=3)
        want = jax_part.partition_iid(tr_j, k, seed=3)
        assert len(got) == len(want) == k
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert {len(p) for p in partition.partition_iid(tr_t, 10)} == {600}


def _alloc_tel(cls, seed, n):
    """tests/test_allocation.py's ``_tel`` fixture."""
    rng = np.random.default_rng(seed)
    return cls(model_bytes=rng.uniform(1e5, 5e6, n),
               uplink_rate=rng.uniform(1e3, 1e4, n),
               downlink_rate=rng.uniform(5e3, 3e4, n),
               compute_latency=rng.uniform(0.1, 10.0, n),
               num_samples=rng.integers(10, 1000, n).astype(float),
               label_coverage=rng.uniform(1.0, 10.0, n),
               train_loss=rng.uniform(0.1, 3.0, n))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("a_server", [0.3, 0.6])
@pytest.mark.parametrize("n", [24, 1])
def test_allocator_twin_matches_jax(seed, a_server, n):
    kw = dict(a_server=a_server, d_max=0.9, delta=1.0)
    tel = _alloc_tel(ClientTelemetry, seed, n)
    got = allocation.solve_dropout_rates_with("jax", tel, device="cpu", **kw)
    want = jax_alloc_with("jax", _alloc_tel(JaxTelemetry, seed, n), **kw)
    ref = allocation.solve_dropout_rates_with("numpy", tel, **kw)
    np.testing.assert_allclose(got.dropout_rates, want.dropout_rates,
                               rtol=0, atol=5e-5)
    assert got.feasible and want.feasible and ref.feasible
    total = np.sum(tel.model_bytes)
    np.testing.assert_allclose(
        np.sum(tel.model_bytes * (1 - got.dropout_rates)), a_server * total,
        rtol=1e-4)
    assert np.all(got.dropout_rates >= 0) and np.all(
        got.dropout_rates <= 0.9)
    np.testing.assert_allclose(got.objective, ref.objective, rtol=1e-3)
    np.testing.assert_allclose(got.t_server, want.t_server, rtol=1e-5)


def test_allocator_device_solver_is_the_dispatch():
    """The dispatch clips the device solver's rates in float64; the raw
    solve on staged inputs gives the same float32 bits."""
    tel = _alloc_tel(ClientTelemetry, 0, 12)
    kw = dict(a_server=0.6, d_max=0.8, delta=1.0, global_model_bytes=5e6)
    res = allocation.solve_dropout_rates_with("jax", tel, device="cpu", **kw)
    d, t = allocation.solve_dropout_rates_torch(
        *(allocation.stage(getattr(tel, f), "cpu") for f in (
            "model_bytes", "uplink_rate", "downlink_rate", "compute_latency",
            "num_samples", "label_coverage", "train_loss")),
        num_iters=96, **kw)
    np.testing.assert_array_equal(
        res.dropout_rates, np.clip(d.numpy().astype(np.float64), 0, 0.8))
    assert res.t_server == float(t)


def test_allocator_dispatch_errors():
    tel = _alloc_tel(ClientTelemetry, 0, 4)
    kw = dict(a_server=0.6, d_max=0.8, delta=1.0)
    with pytest.raises(ValueError, match="unknown allocator"):
        allocation.solve_dropout_rates_with("scipy", tel, **kw)
    with pytest.raises(ValueError, match="overhead_aware"):
        allocation.solve_dropout_rates_with(
            "jax", tel, comm=CommConfig("auto", 8, True), device="cpu", **kw)
    assert allocation.ALLOCATORS == ("numpy", "jax")


@pytest.mark.parametrize("seed", range(6))
def test_select_oort_traced_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = 9
    tel = JaxTelemetry(
        model_bytes=rng.choice([1e5, 2e5, 3e5], n),
        uplink_rate=rng.uniform(1e3, 5e3, n),
        downlink_rate=rng.uniform(5e3, 2e4, n),
        compute_latency=rng.uniform(1.0, 5.0, n),
        num_samples=rng.integers(10, 50, n).astype(float),
        label_coverage=np.ones(n),
        train_loss=rng.uniform(0.1, 2.0, n) if seed else np.ones(n))
    a_server = (0.05, 0.3, 0.5, 0.6, 0.8, 1.0)[seed]
    pen = jax_base.oort_system_penalty(tel)
    budget = a_server * float(np.sum(tel.model_bytes))
    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa
    got = baselines.select_oort_traced(
        f32(tel.train_loss), num_samples=f32(tel.num_samples),
        system_penalty=f32(pen), model_bytes=f32(tel.model_bytes),
        budget=torch.tensor(budget, dtype=torch.float32))
    want = jax_base.select_oort_traced(
        jnp.asarray(tel.train_loss, jnp.float32),
        num_samples=jnp.asarray(tel.num_samples, jnp.float32),
        system_penalty=jnp.asarray(pen, jnp.float32),
        model_bytes=jnp.asarray(tel.model_bytes, jnp.float32),
        budget=jnp.asarray(budget, jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), jax_base.select_oort(tel, a_server=a_server))
    assert got.dtype == torch.bool and got.any()


@pytest.mark.parametrize("codec,qbits", [("dense", 8), ("bitmask", 32),
                                         ("index", 16), ("auto", 8)])
def test_analytic_wire_bytes_tensor_rendering(codec, qbits):
    """The tensor rendering equals the reference's ``xp=jnp`` one and
    the port's numpy one, on a rate vector."""
    params = jax.device_get(jax_models.init_cnn_spec(
        jax.random.PRNGKey(0), jax_models.MLP_SPEC))
    d = np.random.default_rng(1).uniform(0.0, 0.9, 16).astype(np.float32)
    spec = payload.WireSpec.from_params(convert.to_torch(params, "cpu"), -1)
    comm = CommConfig(codec=codec, qbits=qbits)
    got = payload.analytic_wire_bytes(spec, torch.from_numpy(d), comm)
    want = jax_payload.analytic_wire_bytes(
        jax_payload.WireSpec.from_params(jax_tree(params), -1),
        jnp.asarray(d), jax_payload.CommConfig(codec=codec, qbits=qbits),
        xp=jnp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  payload.analytic_wire_bytes(spec, d, comm))


# --- the fused trainer --------------------------------------------------------

def test_make_batched_train_fn_matches_jax():
    """The paper's MLP, 4 clients x 64 flattened synthetic MNIST samples,
    one SGD step each: vmapped rows within atol 1e-6 of the JAX
    package's vmapped step, losses within rtol 1e-6."""
    train, _ = synthetic.make_dataset("mnist", num_train=256, num_test=10,
                                      seed=1)
    xs = train.x.reshape(4, 64, -1)
    ys = train.y.astype(np.int64).reshape(4, 64)
    spec = models.MLP_SPEC

    def tstep(p, x, y):
        g, l = torch.func.grad_and_value(
            lambda q: models._ce(models.apply_spec(q, spec, x), y))(p)
        return tree.tree_map(lambda w, gw: w - 0.1 * gw, p, g), l

    def jstep(p, x, y):
        def loss(q):
            logits = jax_models.apply_spec(q, jax_models.MLP_SPEC, x)
            logz = jax.nn.logsumexp(logits, axis=-1)
            gold = jnp.take_along_axis(logits, y[:, None], axis=-1)[:, 0]
            return jnp.mean(logz - gold)
        l, g = jax.value_and_grad(loss)(p)
        return jax.tree_util.tree_map(lambda w, gw: w - 0.1 * gw, p, g), l

    params = [jax.device_get(jax_models.init_cnn_spec(
        jax.random.PRNGKey(i), jax_models.MLP_SPEC)) for i in range(4)]
    stacked = jax.tree_util.tree_map(lambda *ls: np.stack(ls), *params)
    torch.backends.cuda.matmul.allow_tf32 = True
    gp, gl = round_engine.make_batched_train_fn(
        tstep, (torch.from_numpy(xs), torch.from_numpy(ys)))(
        convert.to_torch(stacked, "cpu"), prng.PRNGKey(0))
    wp, wl = jax.jit(jax_engine.make_batched_train_fn(
        jstep, (jnp.asarray(xs), jnp.asarray(ys))))(
        jax_tree(stacked), jax.random.PRNGKey(0))
    assert not torch.backends.cuda.matmul.allow_tf32    # float32 stays
    assert_trees_close(gp, wp, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-6)
    # a vmapped row against the same step run alone (a batched GEMM adds
    # in another order)
    one, _ = tstep(convert.to_torch(params[2], "cpu"),
                   torch.from_numpy(xs[2]), torch.from_numpy(ys[2]))
    assert_trees_close(tree.tree_map(lambda l: l[2], gp),
                       jax_tree(jax.device_get(tree.tree_map(
                           lambda l: l.numpy(), one))), rtol=0, atol=1e-6)


def _fixed_loss_trainers(n, loss):
    """The JAX package's test trainers: 0.9 x params and a fixed loss,
    per client and batched, in both packages."""
    def per_client(p, idx, key):
        return tree.tree_map(lambda x: 0.9 * x, p), loss

    def batched(stacked, key):
        return (tree.tree_map(lambda x: 0.9 * x, stacked),
                torch.full((n,), loss))

    def jbatched(stacked, key):
        return (jax.tree_util.tree_map(lambda x: 0.9 * x, stacked),
                jnp.full((n,), loss))
    return per_client, batched, jbatched


@pytest.mark.parametrize("scheme", ["feddd", "fedavg", "fedcs", "oort"])
@pytest.mark.parametrize("allocator", ["numpy", "jax"])
def test_fused_runs_match_per_client_and_jax(scheme, allocator):
    """The twin of the JAX package's ``test_batched_train_fn_*``: a fused
    run equals the per-client engine run bit for bit (non-participants
    stay stale), and the JAX package's fused run within the port's
    tolerances (rates equal with the numpy LP, within 5e-5 with the
    float32 solvers)."""
    n = 6
    params = {"fc0": {"w": np.random.default_rng(4).normal(
        size=(20, 12)).astype(np.float32), "b": np.zeros(12, np.float32)},
        "fc1": {"w": np.random.default_rng(5).normal(
            size=(12, 5)).astype(np.float32), "b": np.zeros(5, np.float32)}}
    nbytes = float(sum(l.nbytes for l in jax.tree_util.tree_leaves(params)))
    per_client, batched, jbatched = _fixed_loss_trainers(n, 0.25)
    kw = dict(scheme=scheme, rounds=3, a_server=0.5, h=2, seed=0,
              allocator=allocator)
    tel = _tel(ClientTelemetry, n, nbytes, seed=2)
    s1 = FedDDServer(convert.to_torch(params, "cpu"), ProtocolConfig(**kw),
                     tel, device="cpu")
    r1 = s1.run(per_client)
    s2, r2 = _port_run(params, tel, batched, **kw)
    _assert_runs_equal((s1, r1), (s2, r2))
    want = jax_protocol.FedDDServer(
        jax_tree(params), jax_protocol.ProtocolConfig(**kw),
        _tel(JaxTelemetry, n, nbytes, seed=2)).run(batched_train_fn=jbatched)
    for g, w in zip(r2.history, want.history):
        assert g.participants == w.participants
        assert g.mean_loss == w.mean_loss
        np.testing.assert_allclose(g.dropout_rates, w.dropout_rates, rtol=0,
                                   atol=0 if allocator == "numpy" else 5e-5)
        np.testing.assert_allclose(g.uploaded_fraction, w.uploaded_fraction,
                                   rtol=1e-6)
    assert_trees_close(r2.global_params, want.global_params, rtol=1e-6,
                       atol=1e-6)
    if scheme in ("fedcs", "oort"):
        assert any(r.participants < n for r in r2.history)


def _keeps(rates, widths):
    return [[keep_count_host(c, d) for c in widths] for d in rates]


@pytest.mark.parametrize("scheme", ["feddd", "oort"])
def test_fused_sgd_run_walks_with_jax(scheme):
    """The real (vmapped SGD) trainer, allocator="jax": each round's rates
    within 5e-5 of the JAX package's; while every client's keep counts
    agree the records agree (losses rtol 1e-5), and where the walk ends
    with every keep count equal the global params within atol 1e-5."""
    n = 8
    params, nbytes, bt, jbt = _fixture(n, seed=1)
    kw = dict(scheme=scheme, rounds=5, a_server=0.6, h=3, seed=0,
              allocator="jax")
    _, got = _port_run(params, _tel(ClientTelemetry, n, nbytes, 1), bt, **kw)
    want = jax_protocol.FedDDServer(
        jax_tree(params), jax_protocol.ProtocolConfig(**kw),
        _tel(JaxTelemetry, n, nbytes, 1)).run(batched_train_fn=jbt)
    widths = (12, 12, 5, 5)
    walked = 0
    for g, w in zip(got.history, want.history):
        np.testing.assert_allclose(g.dropout_rates, w.dropout_rates, rtol=0,
                                   atol=5e-5)
        assert g.participants == w.participants
        np.testing.assert_allclose(g.mean_loss, w.mean_loss, rtol=1e-5)
        np.testing.assert_allclose(g.sim_time, w.sim_time, rtol=1e-6)
        walked += 1
        if _keeps(g.dropout_rates, widths) != _keeps(w.dropout_rates,
                                                     widths):
            break
    assert walked == len(got.history), f"a keep count flipped in {walked}"
    assert_trees_close(got.global_params, want.global_params, rtol=0,
                       atol=1e-5)


# --- scanned == per-round, bit for bit ----------------------------------------

@pytest.mark.parametrize("scheme", ["feddd", "fedavg", "fedcs", "oort"])
def test_scanned_equals_per_round(scheme, one_thread):
    """7 rounds at K = 4 (chunks 4 and 3): records, global and client
    params equal the per-round fused path's bit for bit; the budgeted
    baselines leave clients out."""
    params, nbytes, bt, _ = _fixture()
    tel = _tel(ClientTelemetry, 8, nbytes)
    kw = dict(scheme=scheme, rounds=7, a_server=0.6, h=3, seed=0,
              allocator="jax")
    seq = _port_run(params, tel, bt, **kw)
    scan = _port_run(params, tel, bt, rounds_per_dispatch=4, **kw)
    _assert_runs_equal(seq, scan)
    if scheme in ("fedcs", "oort"):
        assert any(r.participants < 8 for r in seq[1].history)
    if scheme == "feddd":       # the allocation drops channels
        assert all(r.dropout_rates.max() > 0.5 for r in seq[1].history)


@pytest.mark.parametrize("k", [2, 3, 6])
def test_scanned_chunk_length_does_not_leak(k, one_thread):
    params, nbytes, bt, _ = _fixture(seed=3)
    tel = _tel(ClientTelemetry, 8, nbytes, seed=3)
    kw = dict(scheme="feddd", rounds=6, a_server=0.6, h=3, seed=0,
              allocator="jax")
    _assert_runs_equal(_port_run(params, tel, bt, **kw),
                       _port_run(params, tel, bt, rounds_per_dispatch=k,
                                 **kw))


@pytest.mark.parametrize("variant", [dict(robust_agg="trimmed:0.2"),
                                     dict(robust_agg="clip:2.0"),
                                     dict(comm=CommConfig("auto", 8)),
                                     dict(comm=CommConfig("index", 16),
                                          selection=SelectionConfig(
                                              scheme="random"))])
def test_scanned_equals_per_round_variants(variant, one_thread):
    params, nbytes, bt, _ = _fixture(seed=2)
    tel = _tel(ClientTelemetry, 8, nbytes, seed=2)
    kw = dict(scheme="feddd", rounds=5, a_server=0.6, h=3, seed=0,
              allocator="jax", **variant)
    seq = _port_run(params, tel, bt, **kw)
    _assert_runs_equal(seq, _port_run(params, tel, bt,
                                      rounds_per_dispatch=3, **kw))
    if "comm" in variant:
        assert all(r.wire_bytes != r.uploaded_bytes
                   for r in seq[1].history[1:])


def test_scan_trace_and_device_clock():
    """``BatchedRoundEngine.run`` directly: (K, N) trace rows, the carry's
    losses and rates equal to the last row, and the float32 device clock
    within rtol 1e-5 of the float64 Eq. (12) of the traced rates."""
    n, k = 6, 5
    params, nbytes, bt, _ = _fixture(n=n, seed=1)
    tel = _tel(ClientTelemetry, n, nbytes, seed=1)
    p = convert.to_torch(params, "cpu")
    state = round_engine.ScanState(
        client_params=round_engine.stack_pytrees([p] * n), global_params=p,
        losses=torch.ones(n), dropout=torch.zeros(n), rng=prng.PRNGKey(0),
        sim_time=torch.zeros(()))
    out, trace = round_engine.BatchedRoundEngine().run(
        state, round_engine.ScanTelemetry.from_host(tel, "cpu"),
        num_rounds=k, batched_train_fn=bt, weights=tel.num_samples, h=3,
        a_server=0.6, d_max=0.8, delta=1.0,
        global_model_bytes=float(np.max(tel.model_bytes)))
    for name in ("losses", "densities", "next_dropout", "participants"):
        assert tuple(getattr(trace, name).shape) == (k, n), name
    assert tuple(trace.round_time.shape) == tuple(trace.sim_time.shape) \
        == (k,)
    assert trace.wire_overhead is None and trace.participants.all()
    assert torch.equal(out.losses, trace.losses[-1])
    assert torch.equal(out.dropout, trace.next_dropout[-1])
    d, expect = np.zeros(n), []
    for j in range(k):
        expect.append(np.max(baselines.round_times(tel, d)))
        d = trace.next_dropout[j].numpy().astype(float)
    np.testing.assert_allclose(trace.round_time.numpy(), expect, rtol=1e-5)
    np.testing.assert_allclose(trace.sim_time.numpy(), np.cumsum(expect),
                               rtol=1e-5)
    host = trace.to_host()
    for a, b in zip(host, trace):
        if b is not None:
            np.testing.assert_array_equal(a, b.numpy())
    assert host.next_dropout.max() > 0.5


def test_scan_trace_to_host_carries_the_overhead_bits():
    k, n = 3, 4
    g = torch.Generator().manual_seed(0)
    trace = round_engine.ScanTrace(
        *(torch.rand((k, n), generator=g) for _ in range(3)),
        torch.rand((k, n), generator=g) > 0.5, torch.rand(k, generator=g),
        torch.rand(k, generator=g),
        torch.randint(0, 2 ** 31 - 1, (k, n), generator=g,
                      dtype=torch.int32))
    host = trace.to_host()
    for a, b in zip(host, trace):
        np.testing.assert_array_equal(a, b.numpy())
    assert host.wire_overhead.dtype == np.int32


def test_scanned_run_leaves_caller_tensors(one_thread):
    params, nbytes, bt, _ = _fixture(n=4)
    tel = _tel(ClientTelemetry, 4, nbytes)
    mine = convert.to_torch(params, "cpu")
    before = tree.tree_map(torch.clone, mine)
    srv = FedDDServer(mine, ProtocolConfig(
        rounds=4, a_server=0.6, h=3, allocator="jax",
        rounds_per_dispatch=2), tel, device="cpu")
    res = srv.run(batched_train_fn=bt)
    for a, b, c in zip(tree.leaves(mine), tree.leaves(before),
                       tree.leaves(res.global_params)):
        assert torch.equal(a, b)
        assert not torch.equal(a, c) and a.data_ptr() != c.data_ptr()


def test_rounds_per_dispatch_validation():
    """The twin of the JAX package's checks: each raises ValueError."""
    with pytest.raises(ValueError, match="allocator"):
        ProtocolConfig(rounds_per_dispatch=2)
    with pytest.raises(ValueError, match="rounds_per_dispatch"):
        ProtocolConfig(rounds_per_dispatch=0)
    with pytest.raises(ValueError, match="unknown allocator"):
        ProtocolConfig(allocator="scipy")
    with pytest.raises(ValueError, match="overhead_aware"):
        ProtocolConfig(allocator="jax",
                       comm=CommConfig("bitmask", 32, True))
    params, nbytes, bt, _ = _fixture(n=4)
    tel = _tel(ClientTelemetry, 4, nbytes)
    cfg = dict(scheme="feddd", rounds=2, allocator="jax",
               rounds_per_dispatch=2)

    def srv(**kw):
        return FedDDServer(convert.to_torch(params, "cpu"),
                           ProtocolConfig(**{**cfg, **kw}), tel,
                           device="cpu")

    with pytest.raises(ValueError, match="batched_train_fn"):
        srv().run(lambda p, i, k: (p, 1.0))
    with pytest.raises(ValueError, match="eval_fn"):
        srv().run(batched_train_fn=bt, eval_fn=lambda p: {})
    with pytest.raises(ValueError, match="homogeneous"):
        srv(batched=False).run(batched_train_fn=bt)
    with pytest.raises(ValueError, match="homogeneous"):
        srv(rounds_per_dispatch=1, track_epsilon=True).run(
            batched_train_fn=bt)
    with pytest.raises(ValueError, match="need local_train_fn"):
        srv().run()
    eng = round_engine.BatchedRoundEngine()
    state = round_engine.ScanState(None, None, None, None, None, None)
    stel = round_engine.ScanTelemetry.from_host(tel, "cpu")
    for scheme, match in (("fedcs", "static_participants"),
                          ("oort", "oort_penalty")):
        with pytest.raises(ValueError, match=match):
            eng.run(state, stel, num_rounds=1, batched_train_fn=bt,
                    weights=np.ones(4), h=3, a_server=0.6, d_max=0.8,
                    delta=1.0, global_model_bytes=1.0, scheme=scheme)


def test_scanned_obs_on_equals_off(tmp_path, one_thread):
    """A scanned run with a JSONL log equals one without; the log says
    executor "scanned", one chunk_dispatch and one host_transfer span a
    chunk, and a round event per round on path "scanned"."""
    params, nbytes, bt, _ = _fixture(n=6)
    tel = _tel(ClientTelemetry, 6, nbytes)
    kw = dict(rounds=5, a_server=0.6, h=3, seed=0, allocator="jax",
              rounds_per_dispatch=2)
    off = _port_run(params, tel, bt, **kw)
    log = tmp_path / "scan.jsonl"
    on = _port_run(params, tel, bt, obs=obs.ObsConfig(jsonl_path=str(log)),
                   **kw)
    _assert_runs_equal(off, on)
    events = obs.read_events(str(log))
    assert events[0]["event"] == "run_start"
    assert events[0]["executor"] == "scanned"
    spans = collections.Counter(e["name"] for e in events
                                if e["event"] == "span")
    assert spans == {"chunk_dispatch": 3, "host_transfer": 3}
    rounds = [e for e in events if e["event"] == "round"]
    assert [e["path"] for e in rounds] == ["scanned"] * 5
    back = obs.load_history(str(log))
    assert [_fields(r) for r in back] == [_fields(r) for r in on[1].history]
