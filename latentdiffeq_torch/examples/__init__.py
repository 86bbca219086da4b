"""The port's training CLIs (counterparts of the JAX package's examples/):
pendulum/ (create_data, train_goku, train_latent_ode, forecast,
train_original_data) and custom_dynamics/ (train_vdp, train_kuramoto).
Each script has ``main(argv=None)`` and runs as ``python -m
latentdiffeq_torch.examples.<folder>.<script>`` or as a file (with the
package importable); it takes the JAX script's flags and ``--device``
(default ``cuda``; ``cpu`` runs the plain PyTorch path)."""
