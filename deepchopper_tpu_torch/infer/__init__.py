"""Bucketed predict engine."""
