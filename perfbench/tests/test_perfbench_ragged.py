"""A model-heterogeneous fleet through the harness on the CPU: each
client's start cut to its own widths in ``compare``, the Eq. (21)
reference ``reference/ragged.py``, and a whole run of a ragged cell
built here (three narrow VGG-like sub-models on 32x32 images, pooled to
1x1 as hetero-a's are) with its ``noniid_a`` labels, ``cycle_specs``
fleet and ``per_client`` trainer.  The images are full size because the
TF32 control shows through max-pool and ReLU decisions: on 8x8 images it
read under ``rh1_local``'s limit on 5 of 8 seeds, on 32x32 over it on
every seed tried."""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import compare, control, harness, inputs, lookup
from perfbench.reference import feddd, ragged
from perfbench.tests.test_perfbench_runs import (
    SEED, TINY, _half_batch, _shift_first_rate)

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
LIMITS = json.loads((ROOT / "perfbench" / "limits" / "cnn2.c100.fused.json")
                    .read_text())["limits"]


def _vgg(widths, fc):
    spec, cin = [], 3
    for w in widths:
        spec += [["conv", cin, w, 3], ["pool"]]
        cin = w
    return spec + [["fc", cin, fc], ["fc", fc, 10]]


# three sub-models of the first, cut in width: 32x32 images pooled to 1x1
SPECS = [_vgg([8, 16, 16, 16, 16], 12), _vgg([8, 8, 16, 16, 16], 12),
         _vgg([4, 8, 8, 16, 16], 8)]
CFG = {"name": "vgg-tiny", "dtype": "float32", "image": [32, 32, 3],
       "classes": 10, "specs": SPECS, "global_spec": 0,
       "data": {"latent_dim": 16, "modes_per_class": 3, "class_sep": 3.2,
                "noise": 0.9}}
TRAFFIC = {"samples_per_client": 500, "labels": "noniid_a",
           "fleet": "cycle_specs", "trainer": "per_client",
           "reference": "ragged", "batch": 64, "lr": 0.05,
           "local_epochs": 1, "a_server": 0.6, "d_max": 0.8, "h": 5,
           "allocator": "numpy", "check_rounds": 6, "trace_after_rounds": 3,
           "trace_rounds": 10}
TRAFFIC.update(TINY, clients=6)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ragged_cell(cfg=CFG) -> harness.Cell:
    return harness.Cell("vgg-tiny.ragged", 1, cfg, dict(TRAFFIC), LIMITS,
                        MANIFEST["end_to_end"], MANIFEST["per_layer"])


def _run(cell=None):
    logs = []
    res = harness.run(cell or ragged_cell(), SEED, 0.05, False, device=CPU,
                      t_start=time.perf_counter(), log=logs.append)
    return res, logs


def _full(shape, v):
    return torch.full(shape, float(v), dtype=torch.float64)


def test_numbers_cut_each_start_to_its_client():
    """Two clients of 8 and 4 channels; the global model of round h holds
    0 in the leading 4 columns and 5 in the rest, so only the leading
    block as client 1's start gives these gaps."""
    g0w = torch.cat([_full((2, 4), 0), _full((2, 4), 5)], 1)
    g0 = {"fc0": {"w": g0w, "b": _full((8,), 0)}}
    g1 = {"fc0": {"w": _full((2, 8), 1), "b": _full((8,), 1)}}
    ref_clients = [{"fc0": {"w": _full((2, 8), 1), "b": _full((8,), 0.5)}},
                   {"fc0": {"w": _full((2, 4), 1), "b": _full((4,), 0.5)}}]
    p0w = _full((2, 8), 1)
    p0w[:, 4:] = 3
    p1b = _full((4,), 0.5)
    p1b[0] = 1.5
    prog_clients = [{"fc0": {"w": p0w, "b": _full((8,), 0.5)}},
                    {"fc0": {"w": _full((2, 4), 2), "b": p1b}}]
    masks = [{("fc0", "w"): torch.tensor([1., 1, 1, 1, 0, 0, 0, 0]),
              ("fc0", "b"): torch.ones(8)},
             {("fc0", "w"): torch.tensor([1., 1, 0, 0]),
              ("fc0", "b"): torch.tensor([0., 1, 1, 1])}]
    prog = feddd.Rounds([2.0, 1.0], [np.array([0.1, 0.2])] * 2, [1.0, 0.5],
                        [g0, g1], prog_clients)
    first = feddd.Rounds([2.5], [np.array([0.1, 0.25])], [1.0], [g0], [])
    after = (ref_clients, g1, 0.8, 0.4, masks)
    got = compare.numbers(prog, first, after, g1)

    # the clients' changes from their starts, stacked over both clients:
    # w: reference 8 x 1, 8 x (1 - 5), 8 x 1; program 8 x 1, 8 x (3 - 5),
    # 8 x 2; b: reference 12 x 0.5; program 11 x 0.5 and 1.5
    ref_w, prog_w = math.sqrt(8 + 8 * 16 + 8), math.sqrt(8 + 8 * 4 + 8 * 4)
    ref_b, prog_b = math.sqrt(12 * 0.25), math.sqrt(11 * 0.25 + 2.25)
    med = (ref_w + ref_b) / 2
    clients = max(abs(prog_w - ref_w) / max(ref_w, med),
                  abs(prog_b - ref_b) / max(ref_b, med))
    # at the channels each reference mask keeps home: client 0's w columns
    # 4-7 (8 x -2 against 8 x -4), client 1's w columns 2-3 (4 x 2 against
    # 4 x 1) and its b channel 0 (1.5 against 0.5)
    pairs = [(math.sqrt(32), math.sqrt(128)), (4.0, 2.0), (1.5, 0.5)]
    med_local = 2.0
    local = float(np.median([abs(p - r) / max(r, med_local)
                             for p, r in pairs]))
    want = {"r1_loss": 0.2, "r1_update": 0.0, "r1_rates": 0.05,
            "rh1_loss": 0.25, "rh1_update": 0.0, "rh1_clients": clients,
            "rh1_local": local, "rh1_uploaded": 0.1}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-12, abs=1e-12), k
    assert got["rh1_local"] == pytest.approx(0.5)


def _old_numbers(prog, first, after, start_global):
    """``compare.numbers`` as it was before the cut: every client's start
    the full global model."""
    t = len(prog.mean_loss)
    clients, glob, loss, uploaded, masks = after
    start = [prog.globals[t - 2]] * len(clients)
    out = {
        "r1_loss": abs(prog.mean_loss[0] - first.mean_loss[0])
        / abs(first.mean_loss[0]),
        "r1_update": compare.leaf_gap(compare._flat(prog.globals[0]),
                                      compare._flat(first.globals[0]),
                                      compare._flat(start_global)),
        "r1_rates": float(np.max(np.abs(np.asarray(prog.rates[0])
                                        - first.rates[0]))),
        "rh1_loss": abs(prog.mean_loss[t - 1] - loss) / abs(loss),
        "rh1_update": compare.leaf_gap(compare._flat(prog.globals[t - 1]),
                                       compare._flat(glob),
                                       compare._flat(prog.globals[t - 2])),
        "rh1_clients": compare.leaf_gap(compare._stack(prog.clients_last),
                                        compare._stack(clients),
                                        compare._stack(start)),
        "rh1_local": compare.local_median(prog.clients_last, clients, start,
                                          masks),
        "rh1_uploaded": abs(prog.uploaded[t - 1] - uploaded),
    }
    return {k: (float(v) if np.isfinite(v) else float("inf"))
            for k, v in out.items()}


def test_numbers_on_a_homogeneous_fleet_equal_the_full_start():
    """Every client holds the global shapes: the cut is the whole tensor
    and every number equals the old full-width formula's bit for bit."""
    gen = torch.Generator().manual_seed(7)
    spec = [["conv", 3, 6, 3], ["pool"], ["fc", 24, 5], ["fc", 5, 3]]

    def model():
        return inputs.make_weights([spec], gen, CPU)[0]

    n = 4
    g = [model() for _ in range(3)]
    prog = feddd.Rounds([2.3, 1.9], [np.array([0.0, 0.1, 0.2, 0.3])] * 2,
                        [1.0, 0.6], g[:2], [model() for _ in range(n)])
    first = feddd.Rounds([2.31], [np.array([0.0, 0.1, 0.2, 0.31])], [1.0],
                         [g[2]], [])
    masks = [{(nm, k): (torch.rand(t.shape[-1], generator=gen) < 0.6)
              .double() for nm, lay in g[0].items()
              for k, t in lay.items()} for _ in range(n)]
    after = ([model() for _ in range(n)], model(), 1.85, 0.61, masks)
    start_global = model()
    got = compare.numbers(prog, first, after, start_global)
    assert got == _old_numbers(prog, first, after, start_global)
    assert got["rh1_clients"] > 0 and got["rh1_local"] > 0


def _inputs(cfg=CFG, seed=SEED):
    return inputs.make_inputs(cfg, TRAFFIC, seed, CPU)


def test_ragged_reference_on_full_specs_equals_feddd():
    """Every client on the full spec (its own weights): every CR is 1, and
    ragged's rounds are feddd's bit for bit."""
    cfg = dict(CFG, specs=SPECS[:1])
    inp = _inputs(cfg)
    assert len({id(p) for p in inp.client_params}) == TRAFFIC["clients"]
    a = ragged.run_rounds(cfg, TRAFFIC, inp, 3, precision="fp64")
    b = feddd.run_rounds(cfg, TRAFFIC, inp, 3, precision="fp64")
    assert a.mean_loss == b.mean_loss and a.uploaded == b.uploaded
    assert all(np.array_equal(x, y) for x, y in zip(a.rates, b.rates))
    for x, y in zip(a.globals + a.clients_last, b.globals + b.clients_last):
        for n in y:
            for k in y[n]:
                assert torch.equal(x[n][k], y[n][k]), (n, k)
    ra = ragged.round_from(cfg, TRAFFIC, inp, 3, a.globals[1], a.rates[1])
    rb = feddd.round_from(cfg, TRAFFIC, inp, 3, a.globals[1], a.rates[1])
    assert ra[2:4] == rb[2:4]
    for ma, mb in zip(ra[4], rb[4]):
        assert all(torch.equal(ma[k], mb[k]) for k in mb)
    for x, y in zip(ra[0] + [ra[1]], rb[0] + [rb[1]]):
        assert all(torch.equal(x[n][k], y[n][k]) for n in y for k in y[n])


def test_channel_with_partial_coverage_scores_over_its_rate():
    """CR(k) is the share of the fleet's clients holding channel k; a
    channel held by 4 of 6 clients scores 1/CR times its Eq. (20) score,
    exactly as Eq. (21) divides."""
    inp = _inputs()
    cr = ragged.coverage_rates(inp.client_params, inp.global_params)
    # conv0 widths 8, 8, 4 over clients 0..5 (specs cycled)
    assert torch.equal(cr[("conv0", "w")],
                       torch.tensor([1.0] * 4 + [4 / 6] * 4,
                                    dtype=torch.float64))
    # fc5: widths 12, 12, 8 -> channels 8..11 held by 4 of 6
    assert torch.equal(cr[("fc5", "b")][8:], torch.full((4,), 4 / 6,
                                                        dtype=torch.float64))
    gen = torch.Generator().manual_seed(3)
    old = torch.randn((3, 3, 3, 8), generator=gen, dtype=torch.float64)
    new = old + 0.1 * torch.randn(old.shape, generator=gen,
                                  dtype=torch.float64)
    plain = feddd.channel_scores(old, new)
    got = ragged.channel_scores(old, new, cr[("conv0", "w")])
    assert torch.equal(got[:4], plain[:4])
    assert torch.equal(got[4:], plain[4:] / (4 / 6))
    assert torch.allclose(got[4:], plain[4:] * 1.5, rtol=1e-15, atol=0)
    # a client of width 4 reads the leading rates only
    assert torch.equal(ragged.channel_scores(old[..., :4], new[..., :4],
                                             cr[("conv0", "w")]), plain[:4])


def test_noniid_a_labels_follow_the_law():
    """Client n holds k_n in 2..C classes, its labels within them; the same
    seed gives the same labels."""
    gen = torch.Generator().manual_seed(11)
    traffic = {"clients": 400, "samples_per_client": 300}
    y = lookup.module("labels", "noniid_a").draw(traffic, 10, gen, CPU)
    assert y.shape == (400, 300) and y.dtype == torch.int64
    held = [len(set(row.tolist())) for row in y]
    assert min(held) >= 2 and max(held) == 10
    # k_n uniform on 2..10: each value about 400 / 9 times (seen up to
    # rounding, every k is held by some client)
    assert set(held) == set(range(2, 11))
    gen.manual_seed(11)
    assert torch.equal(y, lookup.module("labels", "noniid_a").draw(
        traffic, 10, gen, CPU))


def test_cycle_specs_fleet_gives_each_client_its_own_draw():
    inp = _inputs()
    assert inp.client_spec == [0, 1, 2, 0, 1, 2]
    for i, p in enumerate(inp.client_params):
        shapes = inputs.leaf_shapes(SPECS[i % 3])
        assert {n: {k: tuple(t.shape) for k, t in lay.items()}
                for n, lay in p.items()} == shapes
    assert not torch.equal(inp.client_params[0]["conv0"]["w"],
                           inp.client_params[3]["conv0"]["w"])
    run = harness.RunData(CFG, TRAFFIC, inp.client_spec, 1.0, [1.0], 1.0, 1,
                          {})
    assert run.client_leaves()[2] == inputs.leaf_shapes(SPECS[2])
    assert run.leaves() == inputs.leaf_shapes(SPECS[0])


def test_ragged_cell_is_correct_on_the_grouped_engine():
    res, logs = _run()
    assert res["correct"], res["checks"]
    assert "executor grouped" in logs[0]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"rounds_per_s", "mfu", "setup_s"}
    assert list(res)[-1] == "checks"


def _unchanged_grouped_step(orig):
    def step(self, groups, global_params, *a, **kw):
        out = orig(self, groups, global_params, *a, **kw)
        return out._replace(
            group_client_params=tuple(g.stacked_old for g in groups),
            global_params=global_params)
    return step


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "rates"])
def test_broken_ragged_path_is_not_correct(fault, monkeypatch):
    from repro_torch.core import protocol, round_engine
    from repro_torch.fl import models
    if fault == "unchanged":
        monkeypatch.setattr(round_engine.GroupedRoundEngine, "step",
                            _unchanged_grouped_step(
                                round_engine.GroupedRoundEngine.step))
    elif fault == "half_batch":
        monkeypatch.setattr(models, "_ce", _half_batch(models._ce))
    else:
        monkeypatch.setattr(protocol, "solve_dropout_rates_with",
                            _shift_first_rate(
                                protocol.solve_dropout_rates_with))
    res, logs = _run()
    assert "executor grouped" in logs[0]
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("mode", ["tf32", "half_batch", "rates_altered"])
def test_ragged_control_and_planted_faults_are_not_correct(mode):
    values = control.readings(ragged_cell(), SEED, mode, CPU)
    assert not compare.verdict(values, LIMITS), values


def test_ragged_run_imports_no_jax():
    code = (
        "import sys, time, torch;"
        "torch.set_num_threads(2);"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}];"
        "from perfbench import harness;"
        "from perfbench.tests import test_perfbench_ragged as t;"
        "r = harness.run(t.ragged_cell(), 1, 0.01, False,"
        " device=torch.device('cpu'), t_start=time.perf_counter(),"
        " log=lambda s: None);"
        "print(r['correct'], harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "True []"
