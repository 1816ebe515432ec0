"""Configurations of the torch package (the paper's gol3d grid)."""
