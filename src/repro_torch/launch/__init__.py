"""Entry points of the port's LM stack (``python -m repro_torch.launch.serve``,
``.train``, ``.federated``), the per-architecture run policy (``specs``)
and the client meshes of the sharded round engines (``launch.mesh``)."""
