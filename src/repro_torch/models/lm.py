"""The language model: embeddings -> (encoder) -> decoder stack -> logits,
the train step, the prefill and the single-token serve step.

The counterpart of ``repro.models.lm``, for every family of the
registry.  Input contract (the JAX package's):

  dense/moe/hybrid/ssm : {"tokens": (B, S) int}
  vlm                  : {"tokens": (B, S_text) int,
                          "patch_embeds": (B, P, D)}     # stub frontend
  audio (enc-dec)      : {"tokens": (B, S_dec) int,
                          "enc_frames": (B, S_enc, D)}   # stub frontend

Training computes next-token CE over the text tokens (VLM: the patches
are prefix context only; audio: the decoder tokens).  Parameters are the
JAX package's tree:

  {"embed": {"table"}, "stack": {"super": ..., "rem": ...},
   "final_norm": {"scale"[, "bias"]}, ["lm_head": {"table"}],
   ["encoder": {"super": ..., "rem": ...}, "enc_norm": {...}]}

so :func:`repro_torch.convert.lm_params_from_jax` carries JAX weights
across unchanged, and :func:`repro_torch.convert.train_state_from_jax`
a whole train state.  ``forward`` and ``loss_fn`` are differentiable
(autograd records them when the parameters require grad);
``make_train_step`` is the JAX package's, microbatching included.
``prefill`` is the JAX package's ``prefill_32k`` dry-run function
(``launch/dryrun.py``): the forward pass, keeping the last position's
logits; it and the serve step run under ``torch.inference_mode``.

On a ``(data, model)`` mesh (``launch.mesh.LMMesh``), ``forward``,
``prefill``, ``init_decode_state`` and ``make_serve_step`` take
``mesh=`` and parameters placed on it (:func:`place_params`, or
``convert.lm_params_to_mesh`` from the JAX package's): every device runs
its share from one process (``blocks.apply_stack_mesh``), with the batch
over the data axes where it divides, the embedding and the logits
vocab-parallel, and the KV caches per device as
:func:`decode_state_pspecs` gives them (batch over data, kv heads over
model), written in place.  The returned logits are gathered on the
mesh's first device.  A one-device mesh runs the unmeshed code on its
device.  Training runs there too: ``loss_fn``, ``value_and_grad`` and
``make_train_step`` take ``mesh=`` and a state placed by
:func:`place_train_state` (or ``convert.train_state_to_mesh``); the
cross-entropy is vocab-parallel, each device's gradient is that of its
blocks (``sharding.reduce_replicas`` sums the replicas) and the
optimizer updates every device's blocks (``optim.update_placed``).
Every family serves and trains there: a VLM's patch prefix is split over
data with its tokens, and an enc-dec model runs its encoder on the mesh
(``"bidir"``), its decode state holding every device's rows of the
encoder output under ``("batch", "seq", None)``.

For the dry-run (``launch/dryrun.py``): ``abstract_params``,
``abstract_train_state`` and ``abstract_decode_state`` build the same
trees on the ``meta`` device (shapes and dtypes, no data), and
``param_pspecs`` / ``train_state_pspecs`` / ``decode_state_pspecs`` give
each leaf's spec on a mesh (``models.sharding``), walking named tuples
field by field as ``jax.tree_util`` does.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import blocks, layers, sharding
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer, apply_updates, update_placed


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[cfg.param_dtype]


def plan_for(cfg: ModelConfig) -> blocks.StackPlan:
    return blocks.StackPlan.from_layout(cfg.layout())


def encoder_plan_for(cfg: ModelConfig) -> Optional[blocks.StackPlan]:
    if not cfg.is_encdec:
        return None
    return blocks.StackPlan.from_layout(cfg.encoder_layout())


# ----------------------------------------------------------------- init ----

def init_model(cfg: ModelConfig, generator: torch.Generator,
               device: DeviceLike = None) -> Dict:
    """Random parameters with the JAX init's shapes, dtypes and scales,
    drawn from ``generator`` (which must live on ``device``;
    :func:`abstract_params` passes a CPU generator that reads ``meta``)."""
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{dev}: make the generator on the device")
    dt = _dtype(cfg)
    params: Dict[str, Any] = {
        "embed": layers.init_embedding(generator, cfg.vocab_size,
                                       cfg.d_model, dt),
        "stack": blocks.init_stack(generator, cfg, plan_for(cfg), dt),
        "final_norm": layers.init_norm(cfg.d_model, cfg.norm, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_embedding(generator, cfg.vocab_size,
                                                  cfg.d_model, dt)
    if cfg.is_encdec:
        params["encoder"] = blocks.init_stack(generator, cfg,
                                              encoder_plan_for(cfg), dt)
        params["enc_norm"] = layers.init_norm(cfg.d_model, cfg.norm, dev)
    return params


# -------------------------------------------------------------- forward ----

def _embed(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return layers.embed_tokens(params["embed"], tokens,
                               scale=cfg.embed_scale).to(_dtype(cfg))


def _patches(cfg: ModelConfig, batch: Dict) -> int:
    """The number of VLM patch positions prefixed to the text (0 if none)."""
    if cfg.family == "vlm" and "patch_embeds" in batch:
        return batch["patch_embeds"].shape[1]
    return 0


def _embed_inputs(params, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """Token embeddings, after the VLM patch prefix where there is one, and
    with the decoder's sinusoids for enc-dec."""
    x = _embed(params, cfg, batch["tokens"])
    if _patches(cfg, batch):
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    if cfg.is_encdec:
        x = x + layers.sinusoidal_positions(x.shape[1], cfg.d_model,
                                            x.device).to(x.dtype)
    return x


def _run_encoder(params, cfg: ModelConfig, batch: Dict
                 ) -> Optional[torch.Tensor]:
    """Enc-dec: the encoder's output over ``batch["enc_frames"]``."""
    if not cfg.is_encdec:
        return None
    frames = batch["enc_frames"].to(_dtype(cfg))
    pe = layers.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                     frames.device)
    h, _ = blocks.apply_stack(params["encoder"], cfg, encoder_plan_for(cfg),
                              frames + pe.to(frames.dtype), mode="bidir")
    return layers.apply_norm(params["enc_norm"], h, cfg.norm)


def _decoder(params, cfg: ModelConfig, batch: Dict, remat: bool = True
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decoder stack's output at the text positions, and moe_aux."""
    enc = _run_encoder(params, cfg, batch)
    x = _embed_inputs(params, cfg, batch)
    x, aux = blocks.apply_stack(params["stack"], cfg, plan_for(cfg), x,
                                enc=enc, remat=remat)
    return x[:, _patches(cfg, batch):], aux


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    head = params.get("lm_head", params["embed"])
    return layers.unembed(head, x, softcap=cfg.logits_softcap)


def forward(params, cfg: ModelConfig, batch: Dict, remat: bool = True,
            mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (logits (B, S_text, V) fp32, moe_aux 0-d fp32): VLM logits
    cover the text positions only.  Differentiable; ``remat`` recomputes
    each super-block (on a ``mesh``, each layer) in the backward pass.
    On a ``mesh`` (``params`` placed on it) the logits are gathered on
    its first device."""
    if _meshed(params, mesh):
        xs, mb, aux = _decoder_mesh(params, cfg, batch, remat=remat)
        return _logits_mesh(params, cfg, xs, mb), aux
    params = _unwrap(params)
    x, aux = _decoder(params, cfg, batch, remat)
    return _logits(params, cfg, x), aux


def loss_fn(params, cfg: ModelConfig, batch: Dict, remat: bool = True,
            mesh=None) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross-entropy plus the MoE load-balance loss:
    (total, {"ce", "moe_aux"}).  On a ``mesh`` the cross-entropy is
    vocab-parallel (:func:`_ce_mesh`): no device holds the whole
    logits."""
    if _meshed(params, mesh):
        xs, mb, aux = _decoder_mesh(params, cfg, batch, remat=remat)
        ce = _ce_mesh(params, cfg, xs, mb, batch["tokens"])
        return ce + aux, {"ce": ce, "moe_aux": aux}
    logits, aux = forward(params, cfg, batch, remat=remat, mesh=mesh)
    labels = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1]
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    return ce + aux, {"ce": ce, "moe_aux": aux}


# ----------------------------------------------------------- train step ----

class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor            # 0-d int32


def init_train_state(cfg: ModelConfig, opt: Optimizer,
                     generator: torch.Generator,
                     device: DeviceLike = None) -> TrainState:
    params = init_model(cfg, generator, device)
    return TrainState(params=params, opt_state=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=resolve_device(device)))


def value_and_grad(params, cfg: ModelConfig, batch: Dict,
                   remat: bool = True, mesh=None):
    """(loss, metrics, grads) of :func:`loss_fn`; grads in the parameters'
    dtypes, as ``jax.value_and_grad`` gives them.  On a ``mesh`` the
    grads are a ``sharding.Placed`` of every device's blocks, each the
    whole gradient of its block (``sharding.reduce_replicas``)."""
    if _meshed(params, mesh):
        return _value_and_grad_mesh(params, cfg, batch, remat)
    if mesh is not None:
        loss, metrics, grads = value_and_grad(_unwrap(params), cfg, batch,
                                              remat)
        return loss, metrics, _rewrap(params, grads)
    leaves, td = tree.flatten(params)
    req = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree.unflatten(td, req), cfg, batch, remat)
        grads = torch.autograd.grad(loss, req)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree.unflatten(td, list(grads)))


def _micro_grads(params, cfg: ModelConfig, batch: Dict, n: int,
                 remat: bool, mesh):
    """(loss, metrics, grads) of the whole batch: :func:`value_and_grad`,
    or with ``n > 1`` its n microbatches' grads accumulated in fp32 and
    divided by n (the loss is the mean, ``moe_aux`` reported 0, as in the
    JAX package).  On a mesh every device accumulates its own blocks."""
    if n <= 1:
        return value_and_grad(params, cfg, batch, remat, mesh=mesh)
    micro = {k: v.reshape((n, v.shape[0] // n) + tuple(v.shape[1:]))
             for k, v in batch.items()}
    grads = _map_blocks(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    lsum = None
    for i in range(n):
        l, _, g = value_and_grad(params, cfg,
                                 {k: v[i] for k, v in micro.items()}, remat,
                                 mesh=mesh)
        for a, b in zip(_blocks(grads), _blocks(g)):
            a.add_(b.float())
        del g
        lsum = l if lsum is None else lsum + l
    div = torch.tensor(float(n), dtype=torch.float32, device=lsum.device)
    for g in _blocks(grads):
        g.div_(div.to(g.device))
    loss = lsum / div
    return loss, {"ce": loss, "moe_aux": torch.zeros_like(loss)}, grads


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    num_microbatches: int = 1, remat: bool = True,
                    mesh=None):
    """Returns train_step(state, batch) -> (state, metrics).

    With ``num_microbatches > 1`` the batch is split along axis 0 and the
    gradients are accumulated in fp32 and divided by the count (the loss
    is the mean, ``moe_aux`` reported 0, as in the JAX package).  The
    optimizer writes its moments in place: the state passed in is
    consumed (its parameters are not).

    On a ``mesh`` the state is placed on it (:func:`place_train_state`):
    each microbatch's batch goes over the data axes, every device
    computes its blocks' gradients (``value_and_grad(mesh=)``), the grad
    norm counts each distinct block once (``sharding.global_sq_norm``)
    and the optimizer updates every device's blocks
    (``optim.update_placed``).  A one-device mesh runs the unmeshed
    step on its device."""

    def train_step(state: TrainState, batch: Dict):
        loss, metrics, grads = _micro_grads(state.params, cfg, batch,
                                            num_microbatches, remat, mesh)
        if isinstance(grads, sharding.Placed):
            gnorm = torch.sqrt(sharding.global_sq_norm(grads))
            updates, opt_state = update_placed(opt, grads, state.opt_state,
                                               state.params)
            del grads
            params = sharding.Placed(mesh, state.params.specs, tuple(
                apply_updates(p, u) for p, u in zip(state.params.shards,
                                                    updates.shards)))
        else:
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                       for g in tree.leaves(grads)))
            updates, opt_state = opt.update(grads, state.opt_state,
                                            state.params)
            del grads
            params = apply_updates(state.params, updates)
        del updates
        return TrainState(params, opt_state, state.step + 1), {
            "loss": loss, "grad_norm": gnorm, **metrics}

    return train_step


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, batch: Dict, mesh=None
            ) -> torch.Tensor:
    """The last position's logits (B, V) fp32 of ``forward``.

    The final norm and the unembedding run on that position only: the
    same numbers as ``forward(...)[0][:, -1]``, without (B, S, V) fp32
    logits (34 GB at S = 32768 for a 262k vocabulary).  ``batch`` is
    ``forward``'s (``patch_embeds``, ``enc_frames`` where the family
    takes them).  On a ``mesh``, ``params`` are placed on it."""
    if _meshed(params, mesh):
        xs, mb, _ = _decoder_mesh(params, cfg, batch)
        return _logits_mesh(params, cfg, [x[:, -1] for x in xs], mb)
    x, _ = _decoder(_unwrap(params), cfg, batch)
    return _logits(_unwrap(params), cfg, x[:, -1])


# ------------------------------------------------------------ on a mesh ----

def place_params(params, cfg: ModelConfig, mesh) -> sharding.Placed:
    """``params`` cut into every device's blocks under
    :func:`param_pspecs` and copied to them."""
    return sharding.place(params, param_pspecs(cfg, params, mesh), mesh)


def _unwrap(tree_or_placed):
    """The tree of a one-device placement, or the tree itself."""
    if isinstance(tree_or_placed, sharding.Placed):
        return tree_or_placed.shards[0]
    return tree_or_placed


def _rewrap(like, new_tree):
    """``new_tree`` placed as ``like`` is: on its one device where
    ``like`` is a one-device placement, else as it is."""
    if isinstance(like, sharding.Placed):
        return sharding.Placed(like.mesh, like.specs, (new_tree,))
    return new_tree


def _blocks(tree_or_placed):
    """Every tensor block of a tree or of every device of a placement."""
    if isinstance(tree_or_placed, sharding.Placed):
        return [t for s in tree_or_placed.shards
                for t in tree.named_values(s)]
    return tree.leaves(tree_or_placed)


def _map_blocks(fn, tree_or_placed):
    """``fn`` over every block, keeping the tree or the placement."""
    if isinstance(tree_or_placed, sharding.Placed):
        return sharding.Placed(tree_or_placed.mesh, tree_or_placed.specs,
                               tuple(tree.tree_map(fn, s)
                                     for s in tree_or_placed.shards))
    return tree.tree_map(fn, tree_or_placed)


def place_train_state(state: TrainState, cfg: ModelConfig, mesh
                      ) -> TrainState:
    """A whole ``TrainState`` on ``mesh``: the parameters and the
    optimizer state each a ``sharding.Placed`` under
    :func:`train_state_pspecs` (AdamW's moments cut as the parameters,
    adafactor's factored ``vr``/``vc`` whole on every device, as the JAX
    package's specs leave them), ``step`` on the mesh's first device."""
    specs = train_state_pspecs(cfg, state, mesh)
    return TrainState(
        params=sharding.place(state.params, specs.params, mesh),
        opt_state=sharding.place(state.opt_state, specs.opt_state, mesh),
        step=state.step.to(mesh.devices[0]))


def _value_and_grad_mesh(params: sharding.Placed, cfg: ModelConfig,
                         batch: Dict, remat: bool):
    """:func:`value_and_grad` on the mesh: every device's blocks made
    leaves that require grad, autograd through the meshed loss (each
    block receives the gradient of the uses that read it), then the sum
    over replicas."""
    mesh = params.mesh
    req = [[t.detach().requires_grad_(True) for t in tree.named_values(s)]
           for s in params.shards]
    live = sharding.Placed(mesh, params.specs, tuple(
        tree.unflatten_named(s, r) for s, r in zip(params.shards, req)))
    flat = [t for r in req for t in r]
    with torch.enable_grad():
        loss, metrics = loss_fn(live, cfg, batch, remat, mesh=mesh)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    del live
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(flat, grads)]
    n = len(req[0])
    placed = sharding.Placed(mesh, params.specs, tuple(
        tree.unflatten_named(s, grads[k * n:(k + 1) * n])
        for k, s in enumerate(params.shards)))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            sharding.reduce_replicas(placed))


def _meshed(params, mesh) -> bool:
    """Whether a call runs the meshed path (a mesh of several devices):
    checks that ``params`` are placed on ``mesh``."""
    if mesh is None:
        if isinstance(params, sharding.Placed):
            raise TypeError("placed parameters need their mesh= as well")
        return False
    if not isinstance(params, sharding.Placed) or params.mesh != mesh:
        raise TypeError("on a mesh, pass the parameters placed on it "
                        "(lm.place_params or convert.lm_params_to_mesh)")
    return mesh.size > 1


def _encoder_mesh(params: sharding.Placed, cfg: ModelConfig,
                  frames: torch.Tensor, remat: bool = True):
    """Enc-dec: every device's rows of the encoder output over ``frames``
    (B, S_enc, D), its batch over the data axes: the encoder stack in
    ``"bidir"`` mode on the mesh, then each device's ``enc_norm``."""
    mesh = params.mesh
    frames = frames.to(_dtype(cfg))
    pe = layers.sinusoidal_positions(frames.shape[1], cfg.d_model,
                                     frames.device)
    b, s, d = frames.shape
    mb = blocks.MeshBatch.of(mesh, b, s, d)
    hs = sharding.split(frames + pe.to(frames.dtype), mb.spec, mesh)
    stack = sharding.Placed(mesh, params.specs["encoder"],
                            tuple(sh["encoder"] for sh in params.shards))
    hs, _ = blocks.apply_stack_mesh(stack, cfg, encoder_plan_for(cfg), hs,
                                    mb, mode="bidir", remat=remat)
    return [layers.apply_norm(sharding.local_tree(
        [sh["enc_norm"] for sh in params.shards], params.specs["enc_norm"],
        mesh, k), h, cfg.norm) for k, h in enumerate(hs)]


def _decoder_mesh(params: sharding.Placed, cfg: ModelConfig, batch: Dict,
                  state=None, remat: bool = True):
    """Every device's residual stream after the stack, at the text
    positions: the forward (``state`` None) or one decode step on
    ``state`` (its caches and recurrent states written in place).  A VLM
    batch's patch prefix is split over data with the tokens and prefixed
    on every device; an enc-dec forward runs the encoder on the mesh
    first (a decode step reads ``state.enc``).  Returns (xs, the
    MeshBatch, moe_aux)."""
    mesh = params.mesh
    tokens = batch["tokens"]
    b, s = tokens.shape
    n_p = _patches(cfg, batch)
    mb = blocks.MeshBatch.of(mesh, b, n_p + s, cfg.d_model)
    toks = sharding.split(tokens, mb.spec[:2], mesh)
    parts, partial = [], False
    for k in range(mesh.size):
        p = sharding.local_tree([sh["embed"] for sh in params.shards],
                                params.specs["embed"], mesh, k)
        v_l = p["table"].shape[0]
        partial = v_l < cfg.vocab_size
        lo = mesh.col(k) * v_l if partial else 0
        parts.append(layers.embed_tokens_shard(p, toks[k], lo,
                                               scale=cfg.embed_scale))
    if partial:
        parts = sharding.psum_model(parts, mesh)
    xs = [x.to(_dtype(cfg)) for x in parts]
    if n_p:
        pre = sharding.split(batch["patch_embeds"], mb.spec, mesh)
        xs = [torch.cat([p.to(x.dtype), x], dim=1) for p, x in zip(pre, xs)]
    enc = None
    if cfg.is_encdec:
        if state is None:
            pe = layers.sinusoidal_positions(n_p + s, cfg.d_model,
                                             mesh.devices[0])
            enc = _encoder_mesh(params, cfg, batch["enc_frames"], remat)
        else:
            pe = layers.sinusoid_at(state.pos, cfg.d_model, mesh.devices[0])
            enc = list(state.enc.shards)
        xs = [x + pe.to(x.device, x.dtype) for x in xs]
    stack = sharding.Placed(mesh, params.specs["stack"],
                            tuple(sh["stack"] for sh in params.shards))
    if state is None:
        xs, aux = blocks.apply_stack_mesh(stack, cfg, plan_for(cfg), xs, mb,
                                          enc=enc, remat=remat)
    else:
        xs = blocks.apply_stack_decode_mesh(stack, cfg, plan_for(cfg), xs,
                                            state.stack, state.pos, mb,
                                            enc=enc)
        aux = None
    return [x[:, n_p:] for x in xs], mb, aux


def _logits_mesh(params: sharding.Placed, cfg: ModelConfig, xs,
                 mb: "blocks.MeshBatch") -> torch.Tensor:
    """The final norm and the vocab-parallel unembedding on every device,
    the fp32 logits gathered on the mesh's first device."""
    mesh = params.mesh
    head = "lm_head" if "lm_head" in params.specs else "embed"
    parts = []
    for k in range(mesh.size):
        norm = sharding.local_tree([sh["final_norm"] for sh in params.shards],
                                   params.specs["final_norm"], mesh, k)
        p = sharding.local_tree([sh[head] for sh in params.shards],
                                params.specs[head], mesh, k)
        x = layers.apply_norm(norm, xs[k], cfg.norm)
        parts.append(layers.unembed(p, x, softcap=cfg.logits_softcap))
    lspec = (mb.spec[0],) + (None,) * (parts[0].dim() - 2) + (
        params.specs[head]["table"][0],)
    return sharding.unsplit(parts, lspec, mesh)


def _ce_mesh(params: sharding.Placed, cfg: ModelConfig, xs,
             mb: "blocks.MeshBatch", tokens: torch.Tensor) -> torch.Tensor:
    """The mean next-token cross-entropy, vocab-parallel: what GSPMD
    compiles for the JAX package's ``shard(logits, "batch", "seq",
    "vocab")`` then ``logsumexp``.  Each device takes its vocab shard's
    logits of its batch rows; per row of the mesh, the shards' row max
    (no gradient, as ``logsumexp`` stops it) combines over ``model``,
    then their sums of ``exp`` and the gold logit from the shard that
    owns the label, in model order on the row's first device.  The rows'
    sums of ``logz - gold`` combine on the mesh's first device, divided
    by ``B * (S - 1)``.  Each distinct (batch, vocab) block counts once:
    a vocab replicated over ``model`` is read from the row's first
    device, a batch replicated over data from its first row."""
    mesh = params.mesh
    head = "lm_head" if "lm_head" in params.specs else "embed"
    cut = params.specs[head]["table"][0] is not None
    b, s = tokens.shape
    labels = sharding.split(tokens[:, 1:].long(), (mb.spec[0], None), mesh)
    dev0 = mesh.devices[0]
    total, seen = None, set()
    for r in range(mesh.n_rows):
        ks = range(r * mesh.n_model, (r + 1) * mesh.n_model)
        rows = sharding.block_range(mb.spec[0], mesh, ks[0], b)
        if rows in seen:
            continue
        seen.add(rows)
        ks = ks if cut else ks[:1]
        lead = mesh.devices[ks[0]]
        parts = []
        for k in ks:
            norm = sharding.local_tree(
                [sh["final_norm"] for sh in params.shards],
                params.specs["final_norm"], mesh, k)
            p = sharding.local_tree([sh[head] for sh in params.shards],
                                    params.specs[head], mesh, k)
            x = layers.apply_norm(norm, xs[k][:, :-1], cfg.norm)
            lg = layers.unembed(p, x, softcap=cfg.logits_softcap)
            parts.append((k, lg, mesh.col(k) * p["table"].shape[0]
                          if cut else 0))
        m = None
        for _, lg, _ in parts:
            mk = lg.detach().amax(-1).to(lead)
            m = mk if m is None else torch.maximum(m, mk)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        sumexp = gold = None
        for k, lg, lo in parts:
            dev = lg.device
            se = torch.exp(lg - m.to(dev)[..., None]).sum(-1).to(lead)
            lab = labels[k] - lo
            mine = (lab >= 0) & (lab < lg.shape[-1])
            g = torch.gather(lg, -1, torch.where(mine, lab, 0)[..., None]
                             )[..., 0]
            g = torch.where(mine, g, torch.zeros((), dtype=g.dtype,
                                                 device=dev)).to(lead)
            sumexp = se if sumexp is None else sumexp + se
            gold = g if gold is None else gold + g
        row = torch.sum(torch.log(sumexp) + m - gold).to(dev0)
        total = row if total is None else total + row
    return total / torch.tensor(float(b * (s - 1)), dtype=torch.float32,
                                device=dev0)


# ----------------------------------------------------------- serve step ----

class DecodeState(NamedTuple):
    stack: Any                    # per-layer states, stacked like params
    pos: int                      # current position (host int)
    enc: Optional[torch.Tensor] = None   # enc-dec: the encoder's output


def init_decode_state(params, cfg: ModelConfig, batch_size: int,
                      cache_len: int,
                      enc_frames: Optional[torch.Tensor] = None,
                      mesh=None) -> DecodeState:
    """Empty states on the parameters' device; for enc-dec, the encoder
    run once over ``enc_frames`` (B, S_enc, D), whose output every step
    attends to.  On a ``mesh``, the stack is a ``sharding.Placed`` of
    every device's blocks under :func:`decode_state_pspecs`, each
    allocated on its device."""
    if _meshed(params, mesh):
        shapes = blocks.init_stack_state(cfg, plan_for(cfg), batch_size,
                                         cache_len, _dtype(cfg), META)
        # a fresh state holds one value a field (the recurrent states'
        # stabilisers are not 0): read each from a one-token state
        one = blocks.init_stack_state(cfg, plan_for(cfg), 1, 1, _dtype(cfg),
                                      "cpu")
        stack = sharding.zeros(shapes, decode_state_pspecs(cfg, shapes, mesh),
                               mesh, fill=[float(t.flatten()[0]) for t in
                                           tree.named_values(one)])
        enc = None
        if cfg.is_encdec:
            if enc_frames is None:
                raise ValueError("enc-dec decode requires enc_frames")
            with torch.no_grad():
                rows = _encoder_mesh(params, cfg, enc_frames)
            spec = decode_state_pspecs(cfg, DecodeState(
                stack=None, pos=0, enc=enc_frames), mesh).enc
            enc = sharding.Placed(mesh, spec, tuple(rows))
        return DecodeState(stack=stack, pos=0, enc=enc)
    params = _unwrap(params)
    dev = params["embed"]["table"].device
    st = blocks.init_stack_state(cfg, plan_for(cfg), batch_size, cache_len,
                                 _dtype(cfg), dev)
    enc = None
    if cfg.is_encdec:
        if enc_frames is None:
            raise ValueError("enc-dec decode requires enc_frames")
        with torch.no_grad():
            enc = _run_encoder(params, cfg, {"enc_frames": enc_frames})
    return DecodeState(stack=st, pos=0, enc=enc)


def make_serve_step(cfg: ModelConfig, mesh=None):
    """serve_step(params, state, tokens (B, 1)) -> (logits (B, V), state).

    The states are written in place: the returned state holds the same
    tensors as the one passed in, with ``pos`` advanced by one.  VLM
    decode is text only; enc-dec adds the sinusoid of ``pos``.  On a
    ``mesh``, ``params`` and the state are placed on it and the logits
    come back gathered on its first device."""
    plan = plan_for(cfg)

    @torch.inference_mode()
    def serve_step(params, state: DecodeState, tokens: torch.Tensor):
        if _meshed(params, mesh):
            xs, mb, _ = _decoder_mesh(params, cfg, {"tokens": tokens}, state)
            logits = _logits_mesh(params, cfg, [x[:, 0] for x in xs], mb)
            return logits, DecodeState(stack=state.stack, pos=state.pos + 1,
                                       enc=state.enc)
        params = _unwrap(params)
        x = _embed(params, cfg, tokens)
        if cfg.is_encdec:
            x = x + layers.sinusoid_at(state.pos, cfg.d_model,
                                       x.device).to(x.dtype)
        x, stack = blocks.apply_stack_decode(params["stack"], cfg, plan, x,
                                             state.stack, state.pos,
                                             enc=state.enc)
        logits = _logits(params, cfg, x[:, 0])
        return logits, DecodeState(stack=stack, pos=state.pos + 1,
                                   enc=state.enc)

    return serve_step


# ------------------------------------------------------ abstract inputs ----

META = torch.device("meta")


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``: the inits draw on
    ``gen.device``, so through it they build meta tensors (``torch.randn``
    takes a CPU generator for a meta tensor and draws nothing)."""

    @property
    def device(self) -> torch.device:
        return META


def abstract_params(cfg: ModelConfig) -> Dict:
    """The parameter tree on ``meta``, without allocating (the dry-run's
    input; ``jax.eval_shape`` of the init in the JAX package)."""
    return init_model(cfg, _MetaGenerator(), META)


def abstract_train_state(cfg: ModelConfig, opt: Optimizer) -> TrainState:
    return init_train_state(cfg, opt, _MetaGenerator(), META)


def abstract_decode_state(cfg: ModelConfig, batch_size: int, cache_len: int,
                          enc_len: int = 0) -> DecodeState:
    """The decode state on ``meta`` (the dry-run's input): the stacked
    caches and recurrent states, ``pos`` 0 (a host int: the step's cost
    does not depend on it, every step reads the whole cache under a
    mask), and for enc-dec the cached encoder output (B, enc_len, D)."""
    dt = _dtype(cfg)
    st = blocks.init_stack_state(cfg, plan_for(cfg), batch_size, cache_len,
                                 dt, META)
    enc = (torch.empty((batch_size, enc_len, cfg.d_model), dtype=dt,
                       device=META) if cfg.is_encdec else None)
    return DecodeState(stack=st, pos=0, enc=enc)


# ------------------------------------------------------- sharding specs ----

_SPEC_BY_NAME_RANK = {
    # name -> {rank: logical axes}
    "table": {2: ("vocab", "table_embed")},
    "wq": {3: ("embed", "heads", None), 2: ("embed", "inner")},
    "wk": {3: ("embed", "kv_heads", None), 2: ("embed", "inner")},
    "wv": {3: ("embed", "kv_heads", None), 2: ("embed", "inner")},
    "wo": {3: ("heads", None, "embed")},
    "w_up": {2: ("embed", "mlp"), 3: ("experts", "embed", None)},
    "w_gate": {2: ("embed", "mlp"), 3: ("experts", "embed", None)},
    "w_down": {2: ("mlp", "embed"), 3: ("experts", None, "embed")},
    "router": {2: (None, None)},
    "in_proj": {2: ("embed", "inner")},
    "conv_w": {2: (None, "inner")},
    "conv_b": {1: ("inner",)},
    "x_proj": {2: ("inner", None)},
    "dt_proj": {2: (None, "inner")},
    "dt_bias": {1: ("inner",)},
    "a_log": {2: ("inner", None)},
    "d_skip": {1: ("inner",)},
    "out_proj": {2: ("inner", "embed")},
    "up": {2: ("embed", "inner")},
    "down": {2: ("inner", "embed")},
    "w_gates": {2: ("inner", None)},
    "w_i": {2: ("inner", None)},
    "w_f": {2: ("inner", None)},
    "b_i": {1: (None,)},
    "b_f": {1: (None,)},
    "b_gates": {1: (None,)},
}


def _leaf_shape(leaf) -> Tuple[int, ...]:
    """A tensor's shape; () for a host scalar."""
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def _leaf_logical_axes(names: Tuple[str, ...], shape: Tuple[int, ...]
                       ) -> Tuple:
    stacked = "super" in names
    base = names[-1] if names else None
    rank = len(shape) - (1 if stacked else 0)
    axes = _SPEC_BY_NAME_RANK.get(base, {}).get(rank)
    if axes is None:
        axes = (None,) * rank
    if stacked:
        axes = ("layers",) + axes
    return axes


def param_pspecs(cfg: ModelConfig, params_shape, mesh=None) -> Any:
    """The spec of every leaf on ``mesh`` (divisibility-aware), in the
    tree's structure.  Also right for a ``TrainState``: the optimizer's
    moments mirror the parameter tree, so the lookup by name lands on the
    same entries."""
    del cfg

    def _one(names, leaf):
        shape = _leaf_shape(leaf)
        return sharding.spec(*_leaf_logical_axes(names, shape), shape=shape,
                             mesh=mesh)

    return tree.map_named(_one, params_shape)


train_state_pspecs = param_pspecs


def decode_state_pspecs(cfg: ModelConfig, state_shape, mesh=None) -> Any:
    """Specs for a ``DecodeState``: KV caches shard batch over data and
    kv-heads over model; recurrent states shard batch (and mamba's inner
    dim)."""
    del cfg

    def _one(names, leaf):
        shape = _leaf_shape(leaf)
        stacked = "super" in names
        rank = len(shape) - (1 if stacked else 0)
        base = names[-1] if names else None
        if base in ("k", "v") and rank == 4:       # KV cache
            axes = ("batch", "kv_seq", "kv_heads", None)
        elif base == "conv" and rank == 3:         # mamba conv window
            axes = ("batch", None, "inner")
        elif base == "ssm" and rank == 3:          # mamba SSM state
            axes = ("batch", "inner", None)
        elif base == "enc" and rank == 3:          # cached encoder output
            axes = ("batch", "seq", None)
        elif rank >= 1 and base != "pos":          # lstm c/n/h/m etc.
            axes = ("batch",) + (None,) * (rank - 1)
        else:
            axes = (None,) * rank
        if stacked:
            axes = ("layers",) + axes
        return sharding.spec(*axes, shape=shape, mesh=mesh)

    return tree.map_named(_one, state_shape)
