"""Entry points of the port's LM stack (``python -m repro_torch.launch.serve``)
and the client meshes of the sharded round engines (``launch.mesh``)."""
