"""Dtype policy, initializers and module helpers."""
