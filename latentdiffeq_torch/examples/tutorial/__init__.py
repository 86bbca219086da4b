"""The GOKU-net pendulum tutorial (tutorial.py) and its notebook maker."""
