"""The port's launch tooling, held against the JAX package on the CPU.

* ``launch.specs``: ``SHAPES``, ``should_run`` and
  ``effective_decode_config`` for every arch x shape; ``input_specs`` and
  ``decode_specs`` (meta tensors) leaf by leaf against the JAX package's
  ``ShapeDtypeStruct`` s, long_500k's windowed caches included.
* ``lm.abstract_params`` against ``repro.models.lm.abstract_params`` for
  every arch, leaf by leaf in tree order.
* ``launch.analytic_cost`` (``analytic_flops``, ``analytic_bytes``,
  ``total_params``, ``analytic_terms`` with the reference's peaks passed
  in) and ``hlo_analysis.model_flops``: exactly equal for every arch x
  shape x kind; the ``Roofline`` formula.
* ``param_pspecs``, ``train_state_pspecs`` and ``decode_state_pspecs``
  equal to the JAX ``PartitionSpec`` s for every arch on both production
  meshes, the JAX side in one subprocess with 512 placeholder devices.
* ``hlo_analysis.CostCounter``: a meta trace and a CPU run of one
  reduced step (2 layers, narrow, S < 8192: no flash) count equal flops,
  bytes and peak of live bytes, op by op (ops that cost nothing may
  differ: ``lift_fresh`` of a Python scalar reaches the dispatcher on
  the CPU only); the flash wrapper's meta branch reports the kernel's
  cost, and a wrapper's cost is evaluated only under a counter.
* ``tree.named_leaves`` / ``tree.map_named``: named tuples walked and
  named as ``jax.tree_util`` paths are.
* ``python -m repro_torch.launch.dryrun`` writes its records and then
  reuses them.
* The serve and train entry points take the reference's mesh flags: ``launch.serve
  --production-mesh`` and ``launch.train --production-mesh
  [--multi-pod]`` parse and raise with the device count, as
  ``jax.make_mesh`` does, and ``--virtual`` gives the reference's axis
  names and sizes (no step runs on 256 shards).
"""

import collections
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.launch import analytic_cost as jax_cost
from repro.launch import hlo_analysis as jax_hlo
from repro.launch import specs as jax_specs
from repro.models import lm as jax_lm
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import analytic_cost, dryrun, hlo_analysis, specs
from repro_torch.launch.hlo_analysis import (CostCounter,
                                             costly_device_differences,
                                             op_differences)
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import lm_mesh_from_flags, make_production_mesh
from repro_torch.models import lm, sharding
from repro_torch.optim import adafactor, adamw

SRC = str(Path(__file__).resolve().parents[1] / "src")
SHAPE_NAMES = list(jax_specs.SHAPES)


def test_arch_ids_and_shapes_match():
    assert ARCH_IDS == JAX_ARCH_IDS
    assert specs.SHAPES == jax_specs.SHAPES
    assert specs.LONG_OK == jax_specs.LONG_OK
    assert specs.LONG_GLOBAL_WINDOW == jax_specs.LONG_GLOBAL_WINDOW
    assert specs.AUDIO_DECODER_LEN == jax_specs.AUDIO_DECODER_LEN
    for name, pol in jax_specs.RUN_POLICY.items():
        assert dataclasses.asdict(specs.RUN_POLICY[name]) == \
            dataclasses.asdict(pol)
    assert set(specs.RUN_POLICY) == set(jax_specs.RUN_POLICY)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_should_run_and_decode_config(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape in SHAPE_NAMES:
        assert specs.should_run(cfg, shape) == jax_specs.should_run(jcfg,
                                                                    shape)
        assert dataclasses.asdict(specs.effective_decode_config(
            cfg, shape)) == dataclasses.asdict(
            jax_specs.effective_decode_config(jcfg, shape))
        assert specs.policy_for(cfg) == specs.RUN_POLICY.get(
            cfg.name, specs.ArchRunPolicy())


def _dt(x) -> str:
    return str(x.dtype).split(".")[-1]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_decode_specs_match(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for shape in SHAPE_NAMES:
        if specs.SHAPES[shape][2] == "decode":
            state, tok = specs.decode_specs(cfg, shape)
            jstate, jtok = jax_specs.decode_specs(jcfg, shape)
            assert (tuple(tok.shape), _dt(tok)) == (jtok.shape, _dt(jtok))
            got = list(tree.named_leaves(state))
            want = jax.tree_util.tree_flatten_with_path(jstate)[0]
            assert len(got) == len(want)
            for (names, leaf), (path, jl) in zip(got, want):
                assert names[-1] == jax_lm._path_names(path)[-1]
                if names == ("pos",):       # a host int in the port
                    assert leaf == 0 and jl.shape == ()
                    continue
                assert leaf.device.type == "meta"
                assert (tuple(leaf.shape), _dt(leaf)) == (jl.shape, _dt(jl))
        else:
            got = specs.input_specs(cfg, shape)
            want = jax_specs.input_specs(jcfg, shape)
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k].device.type == "meta"
                assert (tuple(got[k].shape), _dt(got[k])) == \
                    (want[k].shape, _dt(want[k]))


def test_long_500k_windows_the_global_caches():
    """gemma3's global layers keep a 32768-slot ring at 500k, as in the
    JAX package's own test."""
    state, _ = specs.decode_specs(get_config("gemma3_27b"), "long_500k")
    lens = {leaf.shape[-3] for names, leaf in tree.named_leaves(state)
            if names[-1] in ("k", "v")}
    assert max(lens) == specs.LONG_GLOBAL_WINDOW


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_params_match(arch):
    got = tree.flatten_with_path(lm.abstract_params(get_config(arch)))[0]
    want = jax.tree_util.tree_flatten_with_path(
        jax_lm.abstract_params(jax_get_config(arch)))[0]
    assert [tree.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, t), (_, s) in zip(got, want):
        assert t.device.type == "meta"
        assert (tuple(t.shape), _dt(t)) == (s.shape, _dt(s))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_cost_and_model_flops_match(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert analytic_cost.total_params(cfg) == jax_cost.total_params(jcfg)
    for seq, batch, _ in specs.SHAPES.values():
        for kind in ("train", "prefill", "decode"):
            assert analytic_cost.analytic_flops(cfg, seq, batch, kind) == \
                jax_cost.analytic_flops(jcfg, seq, batch, kind)
            for opt in ("adamw", "adafactor"):
                assert analytic_cost.analytic_bytes(
                    cfg, seq, batch, kind, opt) == jax_cost.analytic_bytes(
                    jcfg, seq, batch, kind, opt)
            assert analytic_cost.analytic_terms(
                cfg, seq, batch, kind, 256, peak_flops=197e12,
                hbm_bw=819e9) == jax_cost.analytic_terms(
                jcfg, seq, batch, kind, 256)
            assert hlo_analysis.model_flops(cfg, seq, batch, kind) == \
                jax_hlo.model_flops(jcfg, seq, batch, kind)


def test_hardware_and_roofline():
    hw = hlo_analysis.Hardware()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.hbm_bytes) == (
        989e12, 3.35e12, 450e9, 80e9)
    assert analytic_cost.analytic_terms(
        get_config("granite_3_8b"), 4096, 256, "train", 256) == \
        analytic_cost.analytic_terms(get_config("granite_3_8b"), 4096, 256,
                                     "train", 256, peak_flops=989e12,
                                     hbm_bw=3.35e12)
    jhw = jax_hlo.Hardware()
    for coll in ({"all-reduce": 3e9, "all-gather": 2e9},
                 {"all-reduce": 0, "all-gather": 0}):
        for fl, by in ((4e14, 1e11), (1e12, 1e12)):
            got = hlo_analysis.Roofline(fl, by, coll, 256, hw=(
                hlo_analysis.Hardware(jhw.peak_flops, jhw.hbm_bw,
                                      jhw.link_bw, jhw.hbm_bytes)))
            want = jax_hlo.Roofline(fl, by, coll, 256)
            assert got.as_dict() == want.as_dict()
    rl = hlo_analysis.Roofline(989e12, 6.7e12, None, 4)
    d = rl.as_dict()
    assert d["collective_term_s"] is None and d["collective_per_device"] \
        is None
    assert (d["compute_term_s"], d["memory_term_s"], d["dominant"]) == (
        1.0, 2.0, "memory")


def test_sharding_spec_rules():
    """The reference's rules: divisibility-aware, a mesh axis once (the
    first use wins), overrides and reset; ``local_shape``."""
    mesh = make_production_mesh(multi_pod=True)
    assert (mesh.axis_names, mesh.axis_sizes, mesh.size) == (
        ("pod", "data", "model"), (2, 16, 16), 512)
    assert make_production_mesh().size == 256
    assert sharding.spec("embed", "mlp", shape=(4096, 12800), mesh=mesh) \
        == (("pod", "data"), "model")
    # 49155 does not divide by 16: vocab drops to replication
    assert sharding.spec("vocab", "table_embed", shape=(49155, 4096),
                         mesh=mesh) == (None, ("pod", "data"))
    # greedy, in the rule's order: 48 takes pod (2) but not pod x data (32)
    assert sharding.spec("batch", shape=(48,), mesh=mesh) == ("pod",)
    assert sharding.spec("heads", "mlp", shape=(32, 64), mesh=mesh) == (
        "model", None)
    assert sharding.spec("embed", "mlp") == (None, None)
    sharding.set_rules(residual="model")
    try:
        assert sharding.spec("residual", shape=(64,), mesh=mesh) == (
            "model",)
    finally:
        sharding.reset_rules()
    assert sharding.spec("residual", shape=(64,), mesh=mesh) == (None,)
    assert sharding.local_shape((4096, 12800), (("pod", "data"), "model"),
                                mesh) == (128, 800)
    with pytest.raises(ValueError):
        sharding.local_shape((10,), ("model",), mesh)


_JAX_SPECS = r"""
import json, sys
import jax
from repro.configs import ARCH_IDS, get_config
from repro.launch import specs as S
from repro.launch.mesh import make_production_mesh
from repro.models import lm
from repro.optim import adafactor, adamw


def flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [[jax.tree_util.keystr(p), [list(e) if isinstance(e, tuple) else e
                                       for e in s]] for p, s in leaves]


out = {}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    opt = (adafactor(1e-2) if S.policy_for(cfg).optimizer == "adafactor"
           else adamw(3e-4))
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        with jax.sharding.set_mesh(mesh):
            p = lm.abstract_params(cfg)
            ts = jax.eval_shape(lambda: lm.init_train_state(
                jax.random.PRNGKey(0), cfg, opt))
            rec = {"params": flat(lm.param_pspecs(cfg, p)),
                   "train": flat(lm.train_state_pspecs(cfg, ts))}
            for shape in ("decode_32k", "long_500k"):
                if S.should_run(cfg, shape)[0]:
                    ce = S.effective_decode_config(cfg, shape)
                    st, _ = S.decode_specs(cfg, shape)
                    rec[shape] = flat(lm.decode_state_pspecs(ce, st))
        out[f"{arch}/{'multi' if mp else 'single'}"] = rec
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_pspecs(tmp_path_factory):
    path = tmp_path_factory.mktemp("pspecs") / "specs.json"
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    res = subprocess.run([sys.executable, "-c", _JAX_SPECS, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(path.read_text())


def _port_flat(tree_of_specs):
    return [[list(e) if isinstance(e, tuple) else e for e in s]
            for _, s in tree.named_leaves(tree_of_specs)]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pspecs_match_jax_on_production_meshes(arch, jax_pspecs):
    cfg = get_config(arch)
    opt = (adafactor(1e-2) if specs.policy_for(cfg).optimizer ==
           "adafactor" else adamw(3e-4))
    p = lm.abstract_params(cfg)
    ts = lm.abstract_train_state(cfg, opt)
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        want = jax_pspecs[f"{arch}/{'multi' if mp else 'single'}"]
        assert _port_flat(lm.param_pspecs(cfg, p, mesh)) == \
            [s for _, s in want["params"]]
        assert _port_flat(lm.train_state_pspecs(cfg, ts, mesh)) == \
            [s for _, s in want["train"]]
        for shape in ("decode_32k", "long_500k"):
            if shape not in want:
                assert not specs.should_run(cfg, shape)[0]
                continue
            ce = specs.effective_decode_config(cfg, shape)
            st, _ = specs.decode_specs(cfg, shape)
            assert _port_flat(lm.decode_state_pspecs(ce, st, mesh)) == \
                [s for _, s in want[shape]]


def _reduced(arch):
    cfg = get_config(arch, reduced=True)
    return dataclasses.replace(cfg, num_layers=2, param_dtype="float32",
                               compute_dtype="float32")


def _real_batch(batch, cfg, gen):
    out = {}
    for k, v in batch.items():
        if v.dtype == torch.int32:
            out[k] = torch.randint(0, cfg.vocab_size, tuple(v.shape),
                                   generator=gen, dtype=torch.int32)
        else:
            out[k] = torch.randn(tuple(v.shape), generator=gen).to(v.dtype)
    return out


def _counted(fn, device):
    with CostCounter(device) as c:
        fn()
    return c


def _assert_same_count(meta: CostCounter, cpu: CostCounter):
    diff = op_differences(meta.by_op(), cpu.by_op())
    assert costly_device_differences(diff) == {}
    free = {k.split(".")[1] for k in diff}
    assert free <= {"lift_fresh"}, diff
    m, c = meta.totals(), cpu.totals()
    assert (m["flops"], m["bytes"], m["peak_live_bytes"]) == (
        c["flops"], c["bytes"], c["peak_live_bytes"])
    assert m["flops"] > 0 and m["bytes"] > 0 and m["peak_live_bytes"] > 0


@pytest.mark.parametrize("arch", ["granite_3_8b", "granite_moe_1b_a400m"])
def test_cost_counter_train_step_meta_equals_cpu(arch):
    cfg = _reduced(arch)
    opt = adamw(1e-3)
    step = lm.make_train_step(cfg, opt, 2)
    gen = torch.Generator().manual_seed(0)
    toks = torch.empty((2, 24), dtype=torch.int32, device="meta")
    ts = lm.abstract_train_state(cfg, opt)
    meta = _counted(lambda: step(ts, {"tokens": toks}), "meta")
    st = lm.init_train_state(cfg, opt, gen, "cpu")
    batch = _real_batch({"tokens": toks}, cfg, gen)
    cpu = _counted(lambda: step(st, batch), "cpu")
    _assert_same_count(meta, cpu)


@pytest.mark.parametrize("arch", ["gemma3_27b", "whisper_medium"])
def test_cost_counter_prefill_and_decode_meta_equals_cpu(arch):
    cfg = _reduced(arch)
    gen = torch.Generator().manual_seed(1)
    params = lm.init_model(cfg, gen, "cpu")
    abstract = lm.abstract_params(cfg)
    batch = {"tokens": torch.empty((2, 16), dtype=torch.int32,
                                   device="meta")}
    if cfg.is_encdec:
        batch["enc_frames"] = torch.empty((2, 20, cfg.d_model),
                                          device="meta")
    real = _real_batch(batch, cfg, gen)
    _assert_same_count(
        _counted(lambda: lm.prefill(abstract, cfg, batch), "meta"),
        _counted(lambda: lm.prefill(params, cfg, real), "cpu"))
    serve = lm.make_serve_step(cfg)
    state = lm.abstract_decode_state(cfg, 2, 8, enc_len=20)
    tok = torch.empty((2, 1), dtype=torch.int32, device="meta")
    real_state = lm.init_decode_state(params, cfg, 2, 8,
                                      enc_frames=real.get("enc_frames"))
    real_tok = _real_batch({"t": tok}, cfg, gen)["t"]
    _assert_same_count(
        _counted(lambda: serve(abstract, state, tok), "meta"),
        _counted(lambda: serve(params, real_state, real_tok), "cpu"))


def test_flash_meta_branch_reports_the_kernel_cost():
    q = torch.empty((1, 64, 4, 32), dtype=torch.bfloat16, device="meta")
    kv = torch.empty((1, 64, 2, 32), dtype=torch.bfloat16, device="meta")
    with CostCounter("meta") as c:
        out = flash_ops.flash_attention(q, kv, kv, causal=True, window=24)
    assert (out.shape, out.dtype, out.device.type) == (
        q.shape, q.dtype, "meta")
    fl, by = flash_ops.cost(1, 64, 64, 4, 2, 32, True, 24, 2)
    assert c.by_op()["kernel:flash_attention"] == {"calls": 1, "flops": fl,
                                                   "bytes": by}
    from repro_torch.kernels.flash_attention.ref import band_mask
    assert fl == 4 * 4 * 32 * int(band_mask(64, 64, True, 24, "cpu").sum())
    assert by == (2 * 64 * 4 * 32 + 2 * 64 * 2 * 32) * 2
    # a counter sees the allocation as live bytes, no traffic for it
    assert c.totals()["peak_live_bytes"] == out.numel() * 2
    # outside a counter the meta branch reports to nobody
    assert flash_ops.flash_attention(q, kv, kv).device.type == "meta"


def test_report_cost_evaluates_its_cost_only_under_a_counter():
    calls = []

    def cost():
        calls.append(1)
        return 7.0, 11

    _lib.report_cost("flash_attention", cost)
    with _OtherMode():                 # a dispatch mode, not a counter
        _lib.report_cost("flash_attention", cost)
    assert calls == []
    with CostCounter("meta") as c:
        _lib.report_cost("flash_attention", cost)
    assert calls == [1]
    assert c.by_op() == {"kernel:flash_attention": {"calls": 1,
                                                    "flops": 7.0,
                                                    "bytes": 11}}


class _OtherMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


_Pair = collections.namedtuple("_Pair", "a b")


def test_named_walk_names_leaves_as_jax_paths_do():
    """``tree.named_leaves`` walks named tuples field by field in
    ``jax.tree_util`` order, naming each leaf as the JAX package's
    ``_path_names`` reads its path; ``map_named`` keeps the structure;
    without named tuples the leaves are ``tree.flatten``'s."""
    def build(zeros):
        return {"z": [zeros(1), _Pair(zeros(2), None)],
                "a": _Pair(zeros(3), {"y": zeros(4), "x": [zeros(5)]})}

    t = build(torch.zeros)
    jt = build(jax.numpy.zeros)
    got = [(names, tuple(leaf.shape))
           for names, leaf in tree.named_leaves(t)]
    want = [(tuple(jax_lm._path_names(path)), leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jt)[0]]
    assert got == want
    named = tree.map_named(lambda names, leaf: names, t)
    assert type(named["a"]) is _Pair and named["z"][1].b is None
    assert named["a"].b["x"] == [("a", "b", "x")]
    plain = {"b": [torch.zeros(1), torch.zeros(2)], "a": torch.zeros(3)}
    flat = tree.flatten(plain)[0]
    walked = [leaf for _, leaf in tree.named_leaves(plain)]
    assert len(walked) == len(flat) and all(
        x is y for x, y in zip(walked, flat))


def test_map_named_visits_in_named_leaves_order():
    """``map_named`` calls its function in ``named_leaves`` order (dict
    keys sorted) and keeps each dict's insertion order;
    ``unflatten_named`` inverts ``named_values`` and rejects a value
    count that does not fit the tree."""
    t = {"z": [torch.zeros(1), _Pair(torch.zeros(2), None)],
         "a": _Pair(torch.zeros(3), {"y": torch.zeros(4),
                                     "x": [torch.zeros(5)]})}
    seen = []
    out = tree.map_named(lambda names, leaf: seen.append(names) or
                         leaf.numel(), t)
    assert seen == [names for names, _ in tree.named_leaves(t)]
    assert list(out) == ["z", "a"] and list(out["a"].b) == ["y", "x"]
    vals = tree.named_values(t)
    assert [v.numel() for v in vals] == [3, 5, 4, 1, 2]
    back = tree.unflatten_named(t, vals)
    assert list(back) == ["z", "a"] and back["z"][1].b is None
    assert all(x is y for x, y in zip(tree.named_values(back), vals))
    assert tree.unflatten_named(t, range(5))["a"].b["x"] == [1]
    for n in (4, 6):
        with pytest.raises(ValueError):
            tree.unflatten_named(t, range(n))


def test_dryrun_cli_writes_then_reuses_its_cache(tmp_path, monkeypatch,
                                                 capsys):
    argv = ["--arch", "whisper_medium", "--shape", "decode_32k",
            "long_500k", "--results-dir", str(tmp_path)]
    recs = dryrun.main(argv)
    by = {(r["shape"], r["mesh"]): r for r in recs}
    assert set(by) == {(s, m) for s in ("decode_32k", "long_500k")
                       for m in ("single", "multi")}
    ok = by["decode_32k", "single"]
    assert ok["status"] == "ok" and by["long_500k", "multi"]["status"] == \
        "skip"
    assert ok["num_devices"] == 256 and by["decode_32k", "multi"][
        "num_devices"] == 512
    assert ok["roofline"]["collective_term_s"] is None
    assert ok["memory"]["temp_bytes"] is None
    assert ok["traced_flops_total"] == by["decode_32k", "multi"][
        "traced_flops_total"] > 0
    assert ok["memory"]["argument_bytes"] > by["decode_32k", "multi"][
        "memory"]["argument_bytes"]
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(f"whisper-medium_{s}_{m}.json"
                           for s in ("decode_32k", "long_500k")
                           for m in ("single", "multi"))

    def no_trace(*a, **k):
        raise AssertionError("a cached pair was traced again")

    monkeypatch.setattr(dryrun, "trace", no_trace)
    capsys.readouterr()
    again = dryrun.main(argv)
    assert again == [json.loads(json.dumps(r)) for r in recs]
    assert capsys.readouterr().out.count("[cached]") == 4


def test_cost_counter_conventions():
    """Views and aliases move no bytes and allocate nothing; an
    allocation that writes nothing (``empty``) counts live bytes only; an
    op's bytes are its inputs' and outputs'; live bytes follow storages,
    so a view keeps its base alive; host ops of a device run are filed
    apart."""
    meta = torch.device("meta")
    with CostCounter("meta") as c:
        a = torch.empty(1000, device=meta)
        v = a.view(10, 100)
        d = v + 1.0
        del a
        e = d.t().contiguous()
        del d, e
        host = torch.ones(4) * 2.0
    ops = c.by_op()
    assert ops["aten.empty.memory_format"] == {"calls": 1, "flops": 0.0,
                                               "bytes": 0}
    assert ops["aten.view.default"]["bytes"] == 0
    assert ops["aten.add.Tensor"]["bytes"] == 8000
    assert ops["aten.t.default"]["bytes"] == 0
    assert ops["aten.clone.default"]["bytes"] == 8000
    assert ops["aten.mul.Tensor@host"]["bytes"] == 32
    # a (alive through v), d and its transposed copy: 12000 bytes at most
    assert c.totals()["peak_live_bytes"] == 12000
    assert c.live == 4000               # v still holds a's storage
    del v
    assert c.live == 0
    mm = CostCounter("meta")
    with mm:
        torch.empty(8, 16, device=meta) @ torch.empty(16, 4, device=meta)
    assert mm.totals()["flops"] == 2 * 8 * 16 * 4


def test_max_depth_finds_the_deepest_cut_that_fits():
    cfg = dataclasses.replace(get_config("granite_3_8b", reduced=True),
                              num_layers=6)
    batch = {"tokens": torch.empty((1, 16), dtype=torch.int32,
                                   device="meta")}
    peaks = {n: dryrun.train_peak(dataclasses.replace(cfg, num_layers=n),
                                  batch)["peak_bytes_one_card"]
             for n in range(1, 7)}
    assert all(peaks[n] < peaks[n + 1] for n in range(1, 6))
    for limit, want in ((peaks[1] - 1, None), (peaks[3], 3),
                        ((peaks[4] + peaks[5]) / 2, 4), (peaks[6], 6)):
        best, tried = dryrun.max_depth(cfg, batch, limit)
        assert (best and best["num_layers"]) == want
        assert len(tried) <= 5


# ------------------------------------------- the entry points' meshes ----

@pytest.mark.parametrize("argv,shape", [
    (["serve", "--production-mesh"], (16, 16)),
    (["train", "--production-mesh"], (16, 16)),
    (["train", "--production-mesh", "--multi-pod"], (2, 16, 16))])
def test_production_mesh_flags_parse_and_raise_with_the_count(argv, shape):
    """The reference's command lines parse in the port's entry points; with one
    CPU device the production mesh raises, naming the count, as
    ``jax.make_mesh`` does."""
    main = {"serve": serve.main, "train": train.main}[argv[0]]
    with pytest.raises(ValueError, match=rf"Number of devices 1 must be >= "
                       rf"the product of mesh_shape \({', '.join(map(str, shape))}\)"):
        main(argv[1:] + ["--device", "cpu", "--steps", "1"])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_virtual_production_mesh_has_the_reference_axes(multi_pod):
    want = make_production_mesh(multi_pod=multi_pod)
    got = lm_mesh_from_flags("cpu", production=True, multi_pod=multi_pod,
                             virtual=True)
    assert (got.axis_names, got.axis_sizes, got.size) == (
        want.axis_names, want.axis_sizes, want.size)
    assert got.axis_names == (("pod", "data", "model") if multi_pod
                              else ("data", "model"))
    assert got.size == (512 if multi_pod else 256)
    assert set(got.devices) == {torch.device("cpu")}
    # the specs cut each leaf on it as on the named shape
    sp = sharding.spec("embed", "mlp", shape=(4096, 12800), mesh=got)
    assert sp == sharding.spec("embed", "mlp", shape=(4096, 12800),
                               mesh=want)
    assert sharding.local_shape((4096, 12800), sp, got) == \
        sharding.local_shape((4096, 12800), sp, want)


def test_lm_mesh_from_flags():
    assert lm_mesh_from_flags("cpu").axis_sizes == (1, 1)
    assert lm_mesh_from_flags("cpu", shape="2,2").axis_sizes == (1, 1)
    assert lm_mesh_from_flags("cpu", shape="2,2", virtual=True).size == 4
    with pytest.raises(ValueError, match="--multi-pod"):
        lm_mesh_from_flags("cpu", multi_pod=True)
    with pytest.raises(ValueError, match="--virtual"):
        lm_mesh_from_flags("cpu", virtual=True)
