"""Plain fp32 references of the port's models, in PyTorch operations alone:
each imports nothing of the port, and the tests hold the port to them."""
