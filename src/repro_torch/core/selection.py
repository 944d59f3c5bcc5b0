"""Uploaded-parameter selection — FedDD Algorithm 2.

Given each client's dropout rate ``D_n`` and its parameters before/after
the local update, keep per layer the top ``ceil(C_l * (1 - D_n))``
channels by importance (the same rate for every layer, channel-wise, as
in the paper's §4.2).  1-D leaves (biases) ride along as channels of
fan-in 1; 0-D leaves always upload.  :func:`build_masks_batched` builds
every client's masks over client-stacked leaves (the engine);
:func:`build_masks` one client's (the per-client reference loop, with
coverage and ``always_upload``).

Ties rank toward the lower channel index, the order of ``lax.top_k`` in
the JAX package: a stable descending sort gives the same order, which
``torch.topk`` does not promise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import prng, tree
from repro_torch.core import importance as imp_mod

SCHEMES = ("feddd", "max", "delta", "random", "ordered")
MASK_KEY_OFFSET = 10_000     # client i's mask key: fold_in(rng, 10_000 + i)


@dataclasses.dataclass(frozen=True)
class SelectionConfig:
    scheme: str = "feddd"          # one of SCHEMES
    channel_axis: int = -1         # which axis of each leaf is 'channels'

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(f"unknown selection scheme {self.scheme!r}")


def keep_count(num_channels: int, dropout_rate: torch.Tensor) -> torch.Tensor:
    """ceil(C * (1-D)) in float32, clipped to [0, C], as int32."""
    d = torch.as_tensor(dropout_rate, dtype=torch.float32)
    k = torch.ceil(num_channels * (1.0 - d))
    return torch.clamp(k, 0, num_channels).to(torch.int32)


def mask_from_scores(scores: torch.Tensor, keep: torch.Tensor,
                     num_channels: int) -> torch.Tensor:
    """float32 mask keeping the top ``keep`` of ``scores`` along the last
    axis (scores (..., C), keep an int or broadcast against (...,)); ties
    keep the lower index.  keep == 0 gives an all-zero mask."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    pos = torch.arange(num_channels, device=scores.device).expand_as(order)
    ranks = torch.empty_like(order).scatter_(-1, order, pos)
    if not isinstance(keep, int):      # a host int needs no device copy
        keep = torch.as_tensor(keep, device=scores.device)[..., None]
    return (ranks < keep).to(torch.float32)


def keep_count_host(num_channels: int, dropout_rate: float) -> int:
    """:func:`keep_count` of one host rate, in float32 on the host (the
    same IEEE operations, no device round trip)."""
    one = np.float32(1.0)
    k = np.ceil(np.float32(num_channels) * (one - np.float32(dropout_rate)))
    return int(np.clip(k, 0, num_channels))


def _tensor_scores_batched(cfg: SelectionConfig, w_old: torch.Tensor,
                           w_new: torch.Tensor,
                           coverage: Optional[torch.Tensor] = None,
                           per_client_split: bool = False
                           ) -> torch.Tensor:
    """Scores of a client-stacked leaf: (N, *leaf) x2 -> (N, C); a (C,)
    ``coverage`` shared by the clients divides the FedDD scores
    (Eq. (21))."""
    ax = cfg.channel_axis
    if cfg.scheme == "feddd":
        return imp_mod.channel_importance_batched(
            w_old, w_new, channel_axis=ax, coverage=coverage,
            per_client_split=per_client_split)
    if cfg.scheme == "max":
        return imp_mod.channel_score_max_batched(w_old, w_new,
                                                 channel_axis=ax)
    if cfg.scheme == "delta":
        return imp_mod.channel_score_delta_batched(w_old, w_new,
                                                   channel_axis=ax)
    if cfg.scheme == "ordered":
        nch = w_new.shape[ax % (w_new.ndim - 1) + 1]
        return imp_mod.channel_score_ordered(nch, w_new.device).expand(
            w_new.shape[0], nch)
    raise AssertionError(cfg.scheme)


def _random_scores(cfg: SelectionConfig, flat_new, rng, ids):
    """'random selection' scores of every leaf of rank >= 1, {leaf index:
    (N, C)}: client ``ids[k]``'s scores of leaf ``l`` are
    ``uniform(fold_in(fold_in(rng, 10_000 + ids[k]), l), (C,))``, all
    drawn in one pass on the leaves' device."""
    client_keys = prng.fold_in(rng, MASK_KEY_OFFSET + ids)
    idx = [li for li, w in enumerate(flat_new) if w.ndim > 1]
    if not idx:
        return {}
    keys = prng.fold_in(client_keys[:, None, :], np.asarray(idx))
    shapes = [(flat_new[li].shape[cfg.channel_axis % (flat_new[li].ndim - 1)
                                  + 1],) for li in idx]
    return dict(zip(idx, prng.uniform_many(keys, shapes,
                                           flat_new[0].device)))


def build_masks_batched(stacked_old, stacked_new,
                        dropout_rates: torch.Tensor, *,
                        config: SelectionConfig = SelectionConfig(),
                        rng=None, coverage=None, client_indices=None,
                        match_loop: bool = False):
    """All clients' masks in one pass over the stacked leaves.

    Args:
      stacked_old / stacked_new: pytrees whose leaves carry a leading
        client axis, (N, *leaf).
      dropout_rates: (N,) per-client dropout rates.
      rng: the round key (:mod:`repro_torch.prng`), needed by scheme
        'random': client ``i``'s scores of leaf ``l`` are
        ``uniform(fold_in(fold_in(rng, 10_000 + i), l), (C,))``, the JAX
        package's fold order (leaves counted in flatten order, 0-D ones
        included).
      coverage: optional un-stacked pytree of (C,) float32 coverage rates
        CR(k) on the leaves' device, shared by every client of the stack
        (a shape group: the same widths, so the same coverage slice); it
        divides the FedDD scores, Eq. (21).
      client_indices: the (N,) host ints ``i`` the random-score keys fold
        in; default ``arange(N)``.  A shape group passes its members'
        fleet positions, so its masks equal the per-client loop's.
      match_loop: give each row the bits of :func:`build_masks` and
        :func:`mask_density` for that client (the grouped engine, whose
        oracle is the per-client loop): the importance kernel's fan-in
        split planned as for one client, and the density a true division
        of the kept count by the total.  By default the split is planned
        for N and the density multiplies by the float32 reciprocal of the
        total, as the JAX package's jitted engine.

    Returns ``(masks, density)``: a mask pytree with leaves shaped
    (N, 1, ..., C, ..., 1) in the parameters' dtype, and the (N,) float32
    fraction of parameter elements kept, accumulated in float32 leaf by
    leaf as the JAX package does.
    """
    if config.scheme == "random" and rng is None:
        raise ValueError("scheme='random' requires rng")
    flat_old = tree.leaves(stacked_old)
    flat_new, treedef = tree.flatten(stacked_new)
    if len(flat_old) != len(flat_new):
        raise ValueError("stacked_old/stacked_new structure mismatch")
    n = flat_new[0].shape[0]
    dev = flat_new[0].device
    rates = torch.as_tensor(dropout_rates, dtype=torch.float32, device=dev)

    flat_cov = (tree.leaves(coverage) if coverage is not None
                else [None] * len(flat_new))
    ids = (np.arange(n) if client_indices is None
           else np.asarray(client_indices, np.int64))
    random_scores = (_random_scores(config, flat_new, rng, ids)
                     if config.scheme == "random" else {})
    masks = []
    kept = torch.zeros((n,), dtype=torch.float32, device=dev)
    total = 0.0
    for li, (w_old, w_new, cov) in enumerate(zip(flat_old, flat_new,
                                                 flat_cov)):
        leaf_ndim = w_new.ndim - 1
        leaf_size = float(np.prod(w_new.shape[1:], dtype=np.float64))
        if leaf_ndim == 0:
            masks.append(torch.ones((n,), dtype=w_new.dtype, device=dev))
            kept = kept + leaf_size
            total += leaf_size
            continue
        ax = config.channel_axis % leaf_ndim + 1
        nch = w_new.shape[ax]
        scores = (random_scores[li] if random_scores else
                  _tensor_scores_batched(config, w_old, w_new, cov,
                                         match_loop))
        m1d = mask_from_scores(scores, keep_count(nch, rates), nch)
        shape = [n] + [1] * leaf_ndim
        shape[ax] = nch
        masks.append(m1d.reshape(shape).to(w_new.dtype))
        kept = kept + m1d.sum(dim=1) * (leaf_size / nch)
        total += leaf_size
    if match_loop:
        return tree.unflatten(treedef, masks), kept / torch.full(
            (), float(np.float32(total)), dtype=torch.float32, device=dev)
    # the JAX package's jitted engine divides by this compile-time
    # constant as XLA does: a multiply by its float32 reciprocal
    density = kept * float(np.float32(1.0 / total))
    return tree.unflatten(treedef, masks), density


def _tensor_scores(cfg: SelectionConfig, w_old: torch.Tensor,
                   w_new: torch.Tensor, coverage, rng) -> torch.Tensor:
    """One client's scores of one leaf: (*leaf) x2 -> (C,); feddd runs the
    importance kernel at N = 1."""
    if cfg.scheme == "feddd":
        return imp_mod.channel_importance(w_old, w_new,
                                          channel_axis=cfg.channel_axis,
                                          coverage=coverage)
    nch = w_new.shape[cfg.channel_axis % w_new.ndim]
    if cfg.scheme == "random":
        return prng.uniform(rng, (nch,), w_new.device)
    if cfg.scheme == "ordered":
        return imp_mod.channel_score_ordered(nch, w_new.device)
    return _tensor_scores_batched(cfg, w_old[None], w_new[None])[0]


def build_masks(params_old, params_new, dropout_rate: float, *,
                config: SelectionConfig = SelectionConfig(),
                coverage=None, rng=None,
                always_upload: Optional[Callable[[str], bool]] = None):
    """One client's mask pytree ``M_n^t``.

    Args:
      params_old / params_new: pytrees of identical structure (W, W-hat).
      dropout_rate: the client's rate, a host scalar (the keep count is
        computed in float32 on the host).
      coverage: optional pytree of (C,) fp32 coverage rates CR(k) on the
        params' device (heterogeneous fleets, Eq. (21)).
      rng: the client's mask key, ``fold_in(round_key, 10_000 + i)``;
        required by scheme 'random', whose leaf ``l`` scores are
        ``uniform(fold_in(rng, l), (C,))``.
      always_upload: predicate on the leaf's ``tree.keystr`` path; its
        leaves get an all-ones mask.

    Returns masks shaped 1 everywhere but the channel axis, in the
    parameters' dtype (0-D leaves: a 0-D one).
    """
    if config.scheme == "random" and rng is None:
        raise ValueError("scheme='random' requires rng")
    flat_old = tree.leaves(params_old)
    flat_new, treedef = tree.flatten_with_path(params_new)
    flat_cov = (tree.leaves(coverage) if coverage is not None
                else [None] * len(flat_new))
    if len(flat_old) != len(flat_new):
        raise ValueError("params_old/params_new structure mismatch")
    masks = []
    for li, ((path, w_new), w_old, cov) in enumerate(
            zip(flat_new, flat_old, flat_cov)):
        if w_new.ndim == 0 or (always_upload is not None
                               and always_upload(tree.keystr(path))):
            masks.append(torch.ones((1,) * w_new.ndim, dtype=w_new.dtype,
                                    device=w_new.device))
            continue
        ax = config.channel_axis % w_new.ndim
        nch = w_new.shape[ax]
        scores = _tensor_scores(config, w_old, w_new, cov,
                                prng.fold_in(rng, li) if rng is not None
                                else None)
        m1d = mask_from_scores(scores, keep_count_host(nch, dropout_rate),
                               nch)
        shape = [1] * w_new.ndim
        shape[ax] = nch
        masks.append(m1d.reshape(shape).to(w_new.dtype))
    return tree.unflatten(treedef, masks)


def apply_mask(params, masks):
    """W ⊙ M (masks broadcast: they are channel-shaped)."""
    return tree.tree_map(lambda w, m: w * m, params, masks)


def mask_density(params, masks) -> torch.Tensor:
    """One client's fraction of parameter elements kept, a 0-D float32
    tensor: float32 kept and total counts summed leaf by leaf, then a true
    division, as the JAX package's eager ``mask_density``."""
    kept, size = None, np.float32(0.0)
    for w, m in zip(tree.leaves(params), tree.leaves(masks)):
        k = m.float().sum() * float(w.numel() // m.numel())
        kept = k if kept is None else kept + k
        size = size + np.float32(w.numel())
    return kept / torch.full((), float(size), dtype=torch.float32,
                             device=kept.device)
