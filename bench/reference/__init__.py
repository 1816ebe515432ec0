"""Plain PyTorch references, independent of the program: they import
nothing but torch."""
