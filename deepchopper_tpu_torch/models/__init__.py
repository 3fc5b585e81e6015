"""Hyena and Caduceus token classifiers, their registry and the JAX-parameter bridge."""
