#!/usr/bin/env python3
"""Which leaves does the JAX package's compiled Eq. (4) skip a masked-out
non-finite value on?

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/c5_select_rule.py [--out PATH]

Eq. (4) is ``sum_n W_n * M_n * w_n``.  Eagerly, NaN * 0 is NaN, so a
non-finite value on a dropped channel poisons the aggregate.  Inside a
jitted step XLA may rewrite ``W * convert(mask)`` into a select when the
mask comes straight from the top-k compare, and then the masked-out value
adds nothing.  This script finds where, on the JAX package itself (the
reference; CPU is enough, the rewrite is in the compiled graph):

for the paper's MLP, CNN1 and the full Table 3 VGG, three clients with
dropout rates (0, 1, 0) — client 1 keeps no channel, so every value it
holds sits on a dropped channel, while clients 0 and 2 keep every channel,
so no position falls back to the previous global (which would hide the
value whatever the rule) — it plants a NaN, then an Inf, in
client 1 at one element of each leaf in turn and runs one step of

* ``BatchedRoundEngine.step`` with the poisoned values as ``stacked_new``
  and, separately, as ``stacked_upload`` (no ``delivered``);
* the same with ``delivered`` (every count at the int32 maximum: nothing
  cut, but the mask is then a product);
* ``ShardedRoundEngine.step`` on a one-device mesh (dense collective);
* the sharded grouped step (``GroupedRoundEngine(mesh=)`` on a
  one-device mesh) and the unsharded grouped step, the three clients as
  one group at full width;

and records whether the poisoned leaf of the new global stays finite (a
select) or not (propagated).  Prints one JSON line per (path, model) and
a summary rule.  Imports the JAX package only.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

D = (0.0, 1.0, 0.0)
ROW = 1


def _models():
    from repro.fl import models
    return {"mlp": models.MLP_SPEC, "cnn1": models.CNN1_SPEC,
            "vgg": models.HETERO_A_SPECS[0]}


def _fleet(spec, seed=0):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.fl.models import init_cnn_spec
    g = init_cnn_spec(jax.random.PRNGKey(seed), spec)
    rng = np.random.default_rng(seed)
    n = len(D)

    def noisy(scale):
        return jax.tree_util.tree_map(
            lambda l: jnp.stack([l + jnp.asarray(
                rng.normal(0, scale, l.shape), jnp.float32)
                for _ in range(n)]), g)

    old = noisy(0.01)
    new = jax.tree_util.tree_map(
        lambda l: l + jnp.asarray(rng.normal(0, 0.01, l.shape), jnp.float32),
        old)
    return g, old, new


def _poison(stacked, li, value):
    import jax
    leaves, treedef = jax.tree_util.tree_flatten(stacked)
    leaves = list(leaves)
    flat = leaves[li].reshape(leaves[li].shape[0], -1)
    flat = flat.at[ROW, flat.shape[1] // 2].set(value)
    leaves[li] = flat.reshape(leaves[li].shape)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _finite(tree_, li) -> bool:
    import jax
    import numpy as np
    return bool(np.isfinite(np.asarray(
        jax.tree_util.tree_leaves(tree_)[li])).all())


def _paths(g, old, new):
    """name -> fn(poisoned_new) -> new global, for each step under test."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from repro.core import round_engine as jre
    from repro.core.selection import SelectionConfig
    from repro.launch.mesh import make_client_mesh
    sel = SelectionConfig()
    d = jnp.asarray(D, jnp.float32)
    w = jnp.asarray([3.0, 5.0, 2.0], jnp.float32)
    rk = jax.random.PRNGKey(7)
    eng = jre.BatchedRoundEngine(sel)
    mesh = make_client_mesh(1)
    shard = jre.ShardedRoundEngine(sel, mesh=mesh)
    n_leaves = len(jax.tree_util.tree_leaves(new))
    full = tuple(jnp.full((len(D),), np.iinfo(np.int32).max, jnp.int32)
                 for _ in range(n_leaves))

    def grouped(mesh_):
        geng = jre.GroupedRoundEngine(sel, mesh=mesh_)

        def run(pnew):
            # one group of all three clients at full width (the grouped
            # step's own code path; coverage 1 everywhere)
            cov = jax.tree_util.tree_map(
                lambda l: jnp.ones((l.shape[-1],), jnp.float32), g)
            gb = jre.GroupBatch(jnp.arange(len(D), dtype=jnp.int32), old,
                                pnew, cov, d)
            return geng.step([gb], g, w, rk, full_round=False).global_params
        return run

    return {
        "engine_new": lambda p: eng.step(old, p, g, d, w, rk,
                                         full_round=False).global_params,
        "engine_upload": lambda p: eng.step(
            old, new, g, d, w, rk, full_round=False,
            stacked_upload=p).global_params,
        "engine_upload_delivered": lambda p: eng.step(
            old, new, g, d, w, rk, full_round=False, stacked_upload=p,
            delivered=full).global_params,
        "sharded_1dev": lambda p: shard.step(old, p, g, d, w, rk,
                                             full_round=False).global_params,
        "grouped": grouped(None),
        "grouped_sharded_1dev": grouped(mesh),
    }


def characterise() -> dict:
    import jax
    import numpy as np
    out = {}
    for mname, spec in _models().items():
        g, old, new = _fleet(spec)
        shapes = [tuple(l.shape[1:]) for l in jax.tree_util.tree_leaves(new)]
        for pname, fn in _paths(g, old, new).items():
            rows = []
            for li, shape in enumerate(shapes):
                sel = []
                for value in (np.nan, np.inf):
                    sel.append(_finite(fn(_poison(new, li, value)), li))
                rows.append(dict(leaf=li, shape=list(shape),
                                 select_nan=sel[0], select_inf=sel[1]))
            out[(pname, mname)] = rows
    return out


def rule(rows) -> str:
    """The rule the rows follow, in words, or 'none'."""
    sel = {tuple(r["shape"]) for r in rows if r["select_nan"]
           and r["select_inf"]}
    prop = {tuple(r["shape"]) for r in rows if not r["select_nan"]
            and not r["select_inf"]}
    mixed = [r for r in rows if r["select_nan"] != r["select_inf"]]
    if mixed:
        return "mixed"
    if not sel:
        return "none"
    if all(len(s) == 1 for s in sel) and all(len(s) > 1 for s in prop):
        return "1-D leaves"
    return "other: " + json.dumps(sorted(sel))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    res = characterise()
    summary = {}
    for (pname, mname), rows in res.items():
        r = rule(rows)
        summary.setdefault(pname, {})[mname] = r
        print(json.dumps(dict(path=pname, model=mname, rule=r,
                              leaves=rows)))
    print(json.dumps({"rule": summary}))
    if args.out:
        Path(args.out).write_text(json.dumps(
            {f"{p}/{m}": rows for (p, m), rows in res.items()}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
