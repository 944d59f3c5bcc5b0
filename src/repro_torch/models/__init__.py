"""The LM stack of the port, every family of the registry (config, layers,
MLP, MoE, attention, Mamba, xLSTM, blocks, lm)."""
