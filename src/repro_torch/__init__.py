"""FedDD on PyTorch and CUDA — the Hopper port of the JAX package ``repro``.

The layout follows ``repro`` so every module has an obvious counterpart:

  core/       allocation LP, importance, selection, aggregation, baselines,
              the batched round engine and the protocol driver
  fl/         the paper's models, local SGD, system telemetry
  data/       synthetic datasets and client partitions (numpy copies)
  comm/       byte accounting (the default dense wire format)
  kernels/    hand-written CUDA kernels (``csrc/``) behind thin wrappers

Parameter pytrees are nested dicts of tensors, flattened in
``jax.tree_util`` order (:mod:`repro_torch.tree`).  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; without a card and
without that argument they raise (:mod:`repro_torch.device`).

The port imports ``torch`` and numpy only, never ``jax`` and nothing of
``repro``.
"""
