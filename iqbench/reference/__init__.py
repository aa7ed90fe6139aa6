"""The plain reference: straightforward PyTorch, float32, with the card's
TF32 switched off (``precision``), that imports nothing of the port or of
the JAX package.  It reads a configuration's widths and the benchmark's
seeded state dict, and recomputes everything the port derives (graphs,
FPS centres, balls, masks, plans) from the inputs the benchmark hands both
sides.
"""
