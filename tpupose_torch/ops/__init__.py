"""Fixed-shape pre/post-processing ops and the hand-written kernels' wrappers."""
