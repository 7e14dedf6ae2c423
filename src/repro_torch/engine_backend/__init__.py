"""Array containers and the plain PyTorch versions of the engine ops."""
