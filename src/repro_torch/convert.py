"""Carry parameter pytrees and LM train states between numpy arrays and
the port's tensors.

``jax.random.normal`` cannot be reproduced in torch, so runs that must
start from the JAX package's parameters hand them over as numpy arrays
(``jax.device_get``) and convert here.  bfloat16 arrays (numpy's
``ml_dtypes`` extension type) cross bit for bit; going back, bfloat16
tensors come out as float32 arrays (exact) so no extension type is
needed on this side.  :func:`lm_params_to_mesh` carries the JAX
package's LM parameters onto an ``LMMesh``: every device gets its blocks
of every leaf; :func:`train_state_to_mesh` a whole train state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import DeviceLike, resolve_device


def _leaf_to_torch(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(arr, copy=True).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def to_torch(params, device: DeviceLike = None):
    """numpy (or tensor) pytree -> dict of tensors on ``device``."""
    dev = resolve_device(device)
    return tree.tree_map(lambda x: _leaf_to_torch(x, dev), params)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def to_numpy(params):
    """dict of tensors -> dict of numpy arrays (bfloat16 as float32)."""
    return tree.tree_map(_leaf_to_numpy, params)


def lm_params_from_jax(numpy_tree, device: DeviceLike = None):
    """The JAX package's LM parameters (``jax.device_get`` of
    ``repro.models.lm.init_model``) -> the port's tree on ``device``.

    The tree is the same ({"embed", "stack": {"super", "rem"},
    "final_norm", ["lm_head"], ["encoder", "enc_norm"]}); bfloat16
    leaves cross bit for bit and every leaf keeps its dtype: norm scales
    and the recurrent families' fp32 leaves (``a_log``, ``dt_bias``,
    ``d_skip``, ``w_i``, ``w_f``, ``b_*``, ``r_*``) stay float32 in a
    bf16 model."""
    for key in ("embed", "stack", "final_norm"):
        if key not in numpy_tree:
            raise ValueError(f"not an LM parameter tree: no {key!r} entry")
    return to_torch(numpy_tree, device)


def lm_params_to_mesh(numpy_tree, cfg, mesh):
    """The JAX package's LM parameters placed on ``mesh`` (a
    ``sharding.Placed``): :func:`lm_params_from_jax` on the host, then
    each device's blocks under ``lm.param_pspecs`` copied to it."""
    from repro_torch.models.lm import place_params
    return place_params(lm_params_from_jax(numpy_tree, "cpu"), cfg, mesh)


def train_state_from_jax(numpy_state, device: DeviceLike = None):
    """The JAX package's ``TrainState`` (``jax.device_get`` of it: params,
    optimizer state and step as numpy) -> the port's
    :class:`~repro_torch.models.lm.TrainState` on ``device``.  Every leaf
    keeps its dtype (moments float32, steps int32)."""
    from repro_torch.models.lm import TrainState
    params, opt_state, step = numpy_state
    return TrainState(lm_params_from_jax(params, device),
                      to_torch(opt_state, device), to_torch(step, device))


def train_state_to_mesh(numpy_state, cfg, mesh):
    """The JAX package's ``TrainState`` (as for
    :func:`train_state_from_jax`) placed on ``mesh``:
    ``lm.place_train_state`` of it, from the host."""
    from repro_torch.models.lm import place_train_state
    return place_train_state(train_state_from_jax(numpy_state, "cpu"), cfg,
                             mesh)


def train_state_to_numpy(state):
    """The port's TrainState -> (params, opt_state, step) as numpy trees
    (bfloat16 as float32), to hand back to the JAX package."""
    return (to_numpy(state.params), to_numpy(state.opt_state),
            to_numpy(state.step))
