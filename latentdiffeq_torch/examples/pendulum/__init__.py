"""Pendulum-video CLIs: the dataset cache, GOKU and LatentODE training,
forecasting and training on the GOKU-net paper's data."""
