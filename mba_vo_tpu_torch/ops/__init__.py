"""Image ops, the frontoparallel warp, windowed sampling and the residual."""
