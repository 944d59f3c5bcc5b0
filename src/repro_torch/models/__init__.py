"""The LM stack of the port: the dense family (config, layers, MLP,
attention, blocks, lm).  Other families wait for ROADMAP A15."""
