"""Hyena token classifiers, their registry and the JAX-parameter bridge."""
