"""The LM stack of the port: the dense and MoE families (config, layers,
MLP, MoE, attention, blocks, lm).  Other families wait for ROADMAP A15."""
