"""Weights interchange and the signal simulator."""
