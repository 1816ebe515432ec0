"""Configurations of the torch package: the paper's gol3d grid and the LM
architectures ported so far (smollm-360m)."""
