"""Greedy decoding and batch basecalling."""
