"""Configurations of the torch package: the paper's gol3d grid and the
ten LM architectures of ``registry.ARCHS``."""
