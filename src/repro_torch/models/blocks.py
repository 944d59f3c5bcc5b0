"""Block assembly and the layer stack.

The counterpart of ``repro.models.blocks``.  A layout (``cfg.layout()``)
splits into ``(period, n_super, remainder)``; the parameters of each
period position are stacked with a leading ``n_super`` axis, and the
stack runs as a Python loop over that axis (where the JAX package runs a
``lax.scan``), then the remainder layers.  The parameter tree is the JAX
package's: ``{"super": {"p<i>": stacked}, "rem": {"r<i>": ...}}``.

Mixers: ``attn``, ``attn_local``, ``mamba``, ``mlstm`` and ``slstm``;
feed-forwards ``dense``, ``moe`` and ``none``; decoder layers of enc-dec
models add cross-attention to the encoder output ``enc``.

Decode state is stacked the same way: a KV cache (``attention.KVCache``)
or a recurrent state (``ssm.MambaState``, ``xlstm.MLSTMState``,
``xlstm.SLSTMState``) per layer, named tuples in the JAX package's field
order.  A decode step updates the stacked state IN PLACE: slicing the
stack gives views, the attention layers write their caches through them,
and the recurrent layers' new states are copied into them.

``apply_stack`` returns ``(x, moe_aux)`` as the JAX package's does, the
MoE layers' load-balance losses summed in layer order.  ``remat=True``
runs each super-block under ``torch.utils.checkpoint`` (non-reentrant:
grad mode and so the attention route are the same in the recompute),
the counterpart of ``jax.checkpoint(superblock)``; the JAX package's
grouped checkpointing is off by default there (its env override is for
analysis only) and is not ported.

On an ``LMMesh`` (``apply_stack_mesh``, ``apply_stack_decode_mesh``)
every device runs its share of each layer from its placed blocks
(``models.sharding``): the layer's blocks gathered over the data axes
just before use, the norms and residuals whole on every device of a row
(replicated over ``model``), the attention heads, the MLP's hidden
units and the experts cut over ``model``, and the row-parallel partials
summed over ``model``.  A block replicated over ``data`` (a batch that
does not divide) is computed on every device that holds it, as a real
mesh does.  The meshed stack is differentiable: autograd's transposes
of the row sums and of the FSDP gathers land on the blocks each device
read, and ``models.sharding.reduce_replicas`` completes the gradient.
Every mixer runs there.  A Mamba shard runs its block of the inner
channels (conv, ``dt_proj``, scan and state per channel), an mLSTM or
sLSTM shard the heads its channels fall in; ``in_proj``'s and ``up``'s
fused ``(x, z)`` columns are read at the shard's channels of each half
(``sharding.read``), mLSTM's ``wq``/``wk``/``wv`` (cut within a head)
whole for its heads.  The contractions over the inner channels
(``x_proj``, the xLSTM gate inputs, ``out_norm``'s mean square, the
output projections) are summed over ``model`` before what follows them.
The xLSTM decode states are whole on every device of a row: each head's
new state is copied from the device that ran it into every copy.
Cross-attention splits its heads as self-attention does, against every
device's rows of the encoder output.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.models import (attention, layers, mlp, moe, sharding, ssm,
                                xlstm)
from repro_torch.models.config import BlockSpec, ModelConfig, split_layout

ATTN_MIXERS = ("attn", "attn_local")
RECURRENT_STATES = (ssm.MambaState, xlstm.MLSTMState, xlstm.SLSTMState)


# --------------------------------------------------------------- params ----

def init_block(gen: torch.Generator, cfg: ModelConfig, spec: BlockSpec,
               dtype, lead=()) -> Dict:
    dev = gen.device
    p: Dict[str, Any] = {
        "pre_norm": layers.init_norm(cfg.d_model, cfg.norm, dev, lead)}
    if spec.mixer in ATTN_MIXERS:
        p["mixer"] = attention.init_attention(gen, cfg, dtype, lead)
    elif spec.mixer == "mamba":
        p["mixer"] = ssm.init_mamba(gen, cfg, dtype, lead)
    elif spec.mixer == "mlstm":
        p["mixer"] = xlstm.init_mlstm(gen, cfg, dtype, lead)
    elif spec.mixer == "slstm":
        p["mixer"] = xlstm.init_slstm(gen, cfg, dtype, lead)
    else:
        raise ValueError(spec.mixer)
    if spec.cross_attention:
        p["cross_norm"] = layers.init_norm(cfg.d_model, cfg.norm, dev, lead)
        p["cross"] = attention.init_cross_attention(gen, cfg, dtype, lead)
    if spec.ff == "dense":
        p["post_norm"] = layers.init_norm(cfg.d_model, cfg.norm, dev, lead)
        p["ff"] = mlp.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                               dtype, lead)
    elif spec.ff == "moe":
        p["post_norm"] = layers.init_norm(cfg.d_model, cfg.norm, dev, lead)
        p["ff"] = moe.init_moe(gen, cfg.d_model, cfg.moe, cfg.activation,
                               dtype, lead)
    return p


# --------------------------------------------------------------- states ----

def init_block_state(cfg: ModelConfig, spec: BlockSpec, batch: int,
                     cache_len: int, dtype, device, lead=()):
    """Decode-time state of one layer: its KV cache or recurrent state."""
    if spec.mixer in ATTN_MIXERS:
        c = cache_len
        if spec.mixer == "attn_local":
            c = min(spec.window or cfg.window_size, cache_len)
        return attention.KVCache.zeros(batch, c, cfg.num_kv_heads,
                                       cfg.head_dim_, dtype, device, lead)
    if spec.mixer == "mamba":
        return ssm.MambaState.zeros(batch, cfg, dtype, device, lead)
    if spec.mixer == "mlstm":
        return xlstm.MLSTMState.zeros(batch, cfg, device, lead)
    if spec.mixer == "slstm":
        return xlstm.SLSTMState.zeros(batch, cfg, device, lead)
    raise ValueError(spec.mixer)


# --------------------------------------------------------------- apply -----

def _attn_mode(spec: BlockSpec, mode: str) -> str:
    if mode == "bidir":
        return "bidir"
    return "local" if spec.mixer == "attn_local" else "full"


def _feed_forward(p, cfg: ModelConfig, spec: BlockSpec, x: torch.Tensor
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's feed-forward residual: (x, the MoE aux loss or None)."""
    if spec.ff == "dense":
        h = layers.apply_norm(p["post_norm"], x, cfg.norm)
        return x + mlp.apply_mlp(p["ff"], h, cfg.activation), None
    if spec.ff == "moe":
        h = layers.apply_norm(p["post_norm"], x, cfg.norm)
        y, a = moe.apply_moe(p["ff"], h, cfg.moe, cfg.activation)
        return x + y, a
    return x, None


def _cross(p, cfg: ModelConfig, spec: BlockSpec, x: torch.Tensor,
           enc: Optional[torch.Tensor]) -> torch.Tensor:
    if spec.cross_attention and enc is not None:
        h = layers.apply_norm(p["cross_norm"], x, cfg.norm)
        x = x + attention.cross_attention(p["cross"], cfg, h, enc)
    return x


def apply_block(p, cfg: ModelConfig, spec: BlockSpec, x: torch.Tensor, *,
                enc: Optional[torch.Tensor] = None,
                mode: str = "causal") -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/prefill application of one layer: (x, moe_aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = layers.apply_norm(p["pre_norm"], x, cfg.norm)
    if spec.mixer in ATTN_MIXERS:
        y = attention.self_attention(p["mixer"], cfg, h,
                                     mode=_attn_mode(spec, mode),
                                     window=spec.window)
    elif spec.mixer == "mamba":
        y = ssm.mamba_forward(p["mixer"], cfg, h)
    elif spec.mixer == "mlstm":
        y = xlstm.mlstm_forward(p["mixer"], cfg, h)
    elif spec.mixer == "slstm":
        y = xlstm.slstm_forward(p["mixer"], cfg, h)
    else:
        raise ValueError(spec.mixer)
    x = _cross(p, cfg, spec, x + y, enc)
    x, a = _feed_forward(p, cfg, spec, x)
    if a is not None:
        aux = aux + a
    return x, aux


def apply_block_decode(p, cfg: ModelConfig, spec: BlockSpec,
                       x: torch.Tensor, state, pos: int, *,
                       enc: Optional[torch.Tensor] = None):
    """Single-token decode of one layer.  x: (B, 1, D).  Returns (x, the
    layer's state): its KV cache, written in place, or a fresh recurrent
    state (``apply_stack_decode`` copies it into the stack)."""
    h = layers.apply_norm(p["pre_norm"], x, cfg.norm)
    if spec.mixer in ATTN_MIXERS:
        y, state = attention.decode_self_attention(
            p["mixer"], cfg, h, state, pos, mode=_attn_mode(spec, "causal"))
    elif spec.mixer == "mamba":
        y, state = ssm.mamba_decode(p["mixer"], cfg, h, state)
    elif spec.mixer == "mlstm":
        y, state = xlstm.mlstm_decode(p["mixer"], cfg, h, state)
    elif spec.mixer == "slstm":
        y, state = xlstm.slstm_decode(p["mixer"], cfg, h, state)
    else:
        raise ValueError(spec.mixer)
    x = _cross(p, cfg, spec, x + y, enc)
    x, _ = _feed_forward(p, cfg, spec, x)
    return x, state


# ---------------------------------------------------------------- stack ----

@dataclasses.dataclass(frozen=True)
class StackPlan:
    period: Tuple[BlockSpec, ...]
    n_super: int
    remainder: Tuple[BlockSpec, ...]

    @staticmethod
    def from_layout(specs: List[BlockSpec]) -> "StackPlan":
        p, n, r = split_layout(specs)
        return StackPlan(tuple(p), n, tuple(r))


def init_stack(gen: torch.Generator, cfg: ModelConfig, plan: StackPlan,
               dtype) -> Dict:
    """Stacked parameters: {'super': {'p0': stacked, ...}, 'rem': {...}}."""
    out: Dict[str, Any] = {"super": {}, "rem": {}}
    for pi, spec in enumerate(plan.period):
        out["super"][f"p{pi}"] = init_block(gen, cfg, spec, dtype,
                                            lead=(plan.n_super,))
    for ri, spec in enumerate(plan.remainder):
        out["rem"][f"r{ri}"] = init_block(gen, cfg, spec, dtype)
    return out


def init_stack_state(cfg: ModelConfig, plan: StackPlan, batch: int,
                     cache_len: int, dtype, device) -> Dict:
    out: Dict[str, Any] = {"super": {}, "rem": {}}
    for pi, spec in enumerate(plan.period):
        out["super"][f"p{pi}"] = init_block_state(
            cfg, spec, batch, cache_len, dtype, device, lead=(plan.n_super,))
    for ri, spec in enumerate(plan.remainder):
        out["rem"][f"r{ri}"] = init_block_state(cfg, spec, batch, cache_len,
                                                dtype, device)
    return out


def _slice(stacked, i: int):
    """Super-block ``i`` of a stacked tree or state (views, no copies)."""
    if isinstance(stacked, (attention.KVCache,) + RECURRENT_STATES):
        return type(stacked)(*(t[i] for t in stacked))
    return tree.tree_map(lambda t: t[i], stacked)


def _store(view, new) -> None:
    """Write a layer's new recurrent state into its slot of the stack (a
    KV cache was written in place already)."""
    if isinstance(view, RECURRENT_STATES):
        for dst, src in zip(view, new):
            dst.copy_(src)


def apply_stack(params: Dict, cfg: ModelConfig, plan: StackPlan,
                x: torch.Tensor, *, enc: Optional[torch.Tensor] = None,
                mode: str = "causal", remat: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward through the whole stack: (x, total moe_aux).

    ``remat`` recomputes each super-block's activations in the backward
    pass instead of keeping them (only where autograd records: grad
    enabled and the input or a stacked parameter requiring grad).  The
    stacked parameters are unbound once into per-super-block views: the
    backward then stacks each leaf's gradient once, where indexing
    ``t[i]`` per super-block would scatter every slice's gradient into a
    zero tensor of the whole stack (n_super times the stack's bytes)."""
    slices = [tree.tree_map(lambda t: t.unbind(0),
                            params["super"][f"p{pi}"])
              for pi in range(len(plan.period))]

    def superblock(h, aux, i):
        for pi, spec in enumerate(plan.period):
            p = tree.tree_map(lambda u: u[i], slices[pi])  # tuples: leaves
            h, a = apply_block(p, cfg, spec, h, enc=enc, mode=mode)
            aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ckpt = remat and torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in tree.leaves(params["super"])))
    for i in range(plan.n_super):
        if ckpt:
            x, aux = checkpoint(superblock, x, aux, i, use_reentrant=False)
        else:
            x, aux = superblock(x, aux, i)
    for ri, spec in enumerate(plan.remainder):
        x, a = apply_block(params["rem"][f"r{ri}"], cfg, spec, x, enc=enc,
                           mode=mode)
        aux = aux + a
    return x, aux


def apply_stack_decode(params: Dict, cfg: ModelConfig, plan: StackPlan,
                       x: torch.Tensor, state: Dict, pos: int, *,
                       enc: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict]:
    """One decode step through the stack; the states in ``state`` are
    updated in place and ``state`` is returned."""
    for i in range(plan.n_super):
        for pi, spec in enumerate(plan.period):
            view = _slice(state["super"][f"p{pi}"], i)
            x, new = apply_block_decode(_slice(params["super"][f"p{pi}"], i),
                                        cfg, spec, x, view, pos, enc=enc)
            _store(view, new)
    for ri, spec in enumerate(plan.remainder):
        view = state["rem"][f"r{ri}"]
        x, new = apply_block_decode(params["rem"][f"r{ri}"], cfg, spec, x,
                                    view, pos, enc=enc)
        _store(view, new)
    return x, state


# ------------------------------------------------------------ on a mesh ----

@dataclasses.dataclass(frozen=True)
class MeshBatch:
    """Where a meshed pass's (B, S, D) activations lie: the mesh, the spec
    of the residual stream (batch over the data axes where it divides),
    and each device's rows of the B * S global tokens."""

    mesh: Any
    spec: Tuple
    ranges: Tuple[Tuple[int, int], ...]
    tokens: int

    @staticmethod
    def of(mesh, b: int, s: int, d: int) -> "MeshBatch":
        spec = sharding.spec("batch", "seq", None, shape=(b, s, d),
                             mesh=mesh)
        ranges = tuple((lo * s, hi * s) for lo, hi in (
            sharding.block_range(spec[0], mesh, k, b)
            for k in range(mesh.size)))
        return MeshBatch(mesh, spec, ranges, b * s)


def _stacked_spec(specs):
    """A stacked layer's specs without the leading ``layers`` entry."""
    return tree.tree_map(lambda sp: sp[1:], specs)


def _layer(placed: "sharding.Placed", key: str, idx: Optional[int]):
    """Every device's blocks of one layer of the stack, and their specs."""
    group = "super" if idx is not None else "rem"
    shards = [sh[group][key] for sh in placed.shards]
    specs = placed.specs[group][key]
    if idx is None:
        return shards, specs
    return [_slice(sh, idx) for sh in shards], _stacked_spec(specs)


def _local(shards, specs, name: str, mesh, k: int):
    """Device k's ``name`` subtree of a layer, gathered over the data
    axes."""
    return sharding.local_tree([sh[name] for sh in shards], specs[name],
                               mesh, k)


def _attention_mesh(shards, specs, cfg: ModelConfig, spec: BlockSpec, xs,
                    mesh, mode: str, states, pos: int):
    """Every device's self-attention on its heads: (outputs, whether they
    are partial sums over ``model``)."""
    ys, partial = [], False
    for k in range(mesh.size):
        norm = _local(shards, specs, "pre_norm", mesh, k)
        h = layers.apply_norm(norm, xs[k], cfg.norm)
        p = _local(shards, specs, "mixer", mesh, k)
        if states is None:
            y, partial = attention.self_attention_shard(
                p, cfg, h, mesh.col(k), mode=_attn_mode(spec, mode),
                window=spec.window)
        else:
            y, _, partial = attention.decode_self_attention_shard(
                p, cfg, h, states[k], pos, mesh.col(k),
                mode=_attn_mode(spec, "causal"))
        ys.append(y)
        del p
    return ys, partial


def _mixer_params(shards, specs, mesh, k: int, reads: Dict):
    """Device ``k``'s mixer parameters: every leaf gathered over the data
    axes (``sharding.local_tree``) but those of ``reads``, read at the
    regions it gives them (``sharding.read``)."""
    mine = [sh["mixer"] for sh in shards]
    sp = specs["mixer"]
    p = sharding.local_tree([{n: t for n, t in m.items() if n not in reads}
                             for m in mine],
                            {n: e for n, e in sp.items() if n not in reads},
                            mesh, k)
    for n, region in reads.items():
        p[n] = sharding.read([m[n] for m in mine], sp[n], mesh, k, region)
    return p


def _store_heads(views, news, shares, mesh) -> None:
    """Write an xLSTM layer's new states, each device's of its heads, into
    every device's whole copy (the states are replicated over
    ``model``): each head from the first device of the row that ran it,
    so every copy of a row is the same, bit for bit."""
    m = mesh.n_model
    for r in range(mesh.n_rows):
        row = range(r * m, (r + 1) * m)
        done = set()
        for i in row:
            heads = shares[i].heads
            if (heads.start, heads.stop) in done:
                continue
            done.add((heads.start, heads.stop))
            for k in row:
                for dst, src in zip(views[k], news[i]):
                    dst[:, heads].copy_(src)


def _recurrent_mesh(shards, specs, cfg: ModelConfig, spec: BlockSpec, xs,
                    mesh, states):
    """The Mamba, mLSTM and sLSTM mixers on the mesh: each device runs its
    block of the inner channels (an xLSTM shard the heads they fall in),
    the contractions over them summed over ``model``; a decode step
    writes every device's state block in place.  Returns (outputs,
    whether they are partial sums over ``model``)."""
    hs = [layers.apply_norm(_local(shards, specs, "pre_norm", mesh, k),
                            xs[k], cfg.norm) for k in range(mesh.size)]
    mamba = spec.mixer == "mamba"
    di = ssm.d_inner(cfg) if mamba else xlstm.d_inner(cfg)
    inner = specs["mixer"]["out_proj" if mamba else "down"][0]
    ranges = [sharding.block_range(inner, mesh, k, di)
              for k in range(mesh.size)]
    partial = ranges[0] != (0, di)

    def psum(parts):
        return sharding.psum_model(parts, mesh) if partial else parts

    if mamba:
        ps = [_mixer_params(shards, specs, mesh, k, {"in_proj": [
            None, [(lo, hi), (di + lo, di + hi)]]})
            for k, (lo, hi) in enumerate(ranges)]
        if states is None:
            return ssm.mamba_forward_shard(ps, cfg, hs, psum), partial
        ys, new = ssm.mamba_decode_shard(ps, cfg, hs, states, psum)
        for view, n in zip(states, new):
            _store(view, n)
        return ys, partial
    shares = [xlstm.share(cfg, lo, hi) for lo, hi in ranges]
    ps = []
    for k, sh in enumerate(shares):
        reads = {"up": [None, xlstm.up_columns(cfg, sh)]}
        if spec.mixer == "mlstm":
            reads.update({w: [[(sh.heads.start, sh.heads.stop)], None, None]
                          for w in ("wq", "wk", "wv")})
        ps.append(_mixer_params(shards, specs, mesh, k, reads))
    if states is None:
        fwd = (xlstm.mlstm_forward_shard if spec.mixer == "mlstm"
               else xlstm.slstm_forward_shard)
        return fwd(ps, cfg, hs, shares, psum), partial
    dec = (xlstm.mlstm_decode_shard if spec.mixer == "mlstm"
           else xlstm.slstm_decode_shard)
    ys, new = dec(ps, cfg, hs, states, shares, psum)
    _store_heads(states, new, shares, mesh)
    return ys, partial


def _mesh_block(shards, specs, cfg: ModelConfig, spec: BlockSpec, xs,
                mb: MeshBatch, *, mode: str = "causal", states=None,
                pos: int = 0, enc=None):
    """One layer on the mesh: prefill (``states`` None) or one decode
    step on every device's block of its state; ``enc`` every device's
    rows of the encoder output (enc-dec).  Returns (xs, aux)."""
    mesh = mb.mesh
    if spec.mixer in ATTN_MIXERS:
        ys, partial = _attention_mesh(shards, specs, cfg, spec, xs, mesh,
                                      mode, states, pos)
    elif spec.mixer in ("mamba", "mlstm", "slstm"):
        ys, partial = _recurrent_mesh(shards, specs, cfg, spec, xs, mesh,
                                      states)
    else:
        raise ValueError(spec.mixer)
    if partial:
        ys = sharding.psum_model(ys, mesh)
    xs = [x + y for x, y in zip(xs, ys)]
    if spec.cross_attention and enc is not None:
        ys = []
        for k in range(mesh.size):
            h = layers.apply_norm(_local(shards, specs, "cross_norm", mesh,
                                         k), xs[k], cfg.norm)
            p = _local(shards, specs, "cross", mesh, k)
            y, partial = attention.cross_attention_shard(p, cfg, h, enc[k],
                                                         mesh.col(k))
            ys.append(y)
            del p
        if partial:
            ys = sharding.psum_model(ys, mesh)
        xs = [x + y for x, y in zip(xs, ys)]
    aux = None
    if spec.ff == "dense":
        ys = []
        for k in range(mesh.size):
            h = layers.apply_norm(_local(shards, specs, "post_norm", mesh, k),
                                  xs[k], cfg.norm)
            p = _local(shards, specs, "ff", mesh, k)
            partial = p["w_up"].shape[-1] < cfg.d_ff
            ys.append(mlp.apply_mlp(p, h, cfg.activation))
            del p
        if partial:
            ys = sharding.psum_model(ys, mesh)
        xs = [x + y for x, y in zip(xs, ys)]
    elif spec.ff == "moe":
        hs, ps = [], []
        for k in range(mesh.size):
            h = layers.apply_norm(_local(shards, specs, "post_norm", mesh, k),
                                  xs[k], cfg.norm)
            hs.append(h.reshape(-1, h.shape[-1]))
            ps.append(_local(shards, specs, "ff", mesh, k))
        ys, aux = moe.apply_moe_mesh(ps, hs, mb.ranges, mb.tokens, cfg.moe,
                                     cfg.activation, mesh,
                                     specs["ff"]["w_up"][0])
        del ps
        xs = [x + y.view(x.shape) for x, y in zip(xs, ys)]
    elif spec.ff != "none":
        raise ValueError(spec.ff)
    return xs, aux


def apply_stack_mesh(placed: "sharding.Placed", cfg: ModelConfig,
                     plan: StackPlan, xs, mb: MeshBatch, *, enc=None,
                     mode: str = "causal", remat: bool = True):
    """``apply_stack`` on the mesh: ``placed`` the stack's placed
    parameters, ``xs`` every device's (B_k, S, D) residual, ``enc`` every
    device's rows of the encoder output (enc-dec; ``mode`` "bidir" runs
    the encoder itself).  Returns (xs, total moe_aux).

    Differentiable.  ``remat`` (where autograd records) runs each layer
    under ``torch.utils.checkpoint``: its FSDP-gathered blocks and
    activations are not kept for the backward but gathered and computed
    again there, as GSPMD re-gathers under ``jax.checkpoint``; without it
    every device would hold every layer's whole fan-in until the
    backward.  Each device's stacked blocks are unbound once, as in
    ``apply_stack``."""
    mesh = mb.mesh
    aux = torch.zeros((), dtype=torch.float32, device=mesh.devices[0])
    ckpt = remat and torch.is_grad_enabled() and (
        any(x.requires_grad for x in xs) or any(
            t.requires_grad for sh in placed.shards
            for t in tree.leaves(sh["super"])))
    slices = {f"p{pi}": [tree.tree_map(lambda t: t.unbind(0),
                                       sh["super"][f"p{pi}"])
                         for sh in placed.shards]
              for pi in range(len(plan.period))}

    def layer(shards, specs, spec, xs):
        if ckpt:
            return checkpoint(_mesh_block, shards, specs, cfg, spec, xs, mb,
                              mode=mode, enc=enc, use_reentrant=False)
        return _mesh_block(shards, specs, cfg, spec, xs, mb, mode=mode,
                           enc=enc)

    for i in range(plan.n_super):
        for pi, spec in enumerate(plan.period):
            shards = [tree.tree_map(lambda u: u[i], sl)
                      for sl in slices[f"p{pi}"]]
            specs = _stacked_spec(placed.specs["super"][f"p{pi}"])
            xs, a = layer(shards, specs, spec, xs)
            if a is not None:
                aux = aux + a
    for ri, spec in enumerate(plan.remainder):
        shards, specs = _layer(placed, f"r{ri}", None)
        xs, a = layer(shards, specs, spec, xs)
        if a is not None:
            aux = aux + a
    return xs, aux


def apply_stack_decode_mesh(placed: "sharding.Placed", cfg: ModelConfig,
                            plan: StackPlan, xs, state: "sharding.Placed",
                            pos: int, mb: MeshBatch, *, enc=None):
    """One decode step through the stack on the mesh; every device's
    block of every cache and recurrent state (``state.shards[k]``) is
    written in place, a recurrent state through the stack's views as
    ``apply_stack_decode`` writes it."""
    for i in range(plan.n_super):
        for pi, spec in enumerate(plan.period):
            shards, specs = _layer(placed, f"p{pi}", i)
            views = [_slice(st["super"][f"p{pi}"], i) for st in state.shards]
            xs, _ = _mesh_block(shards, specs, cfg, spec, xs, mb,
                                states=views, pos=pos, enc=enc)
    for ri, spec in enumerate(plan.remainder):
        shards, specs = _layer(placed, f"r{ri}", None)
        views = [st["rem"][f"r{ri}"] for st in state.shards]
        xs, _ = _mesh_block(shards, specs, cfg, spec, xs, mb, states=views,
                            pos=pos, enc=enc)
    return xs
