"""GOKU on user-defined mechanistic dynamics: Van der Pol and Kuramoto."""
