"""Device code of the port: plain torch ops and the hand-written kernels."""
