"""Serving model: modules, encoder, decoder step."""
