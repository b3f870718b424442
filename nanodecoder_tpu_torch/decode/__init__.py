"""Greedy and beam-search decoding, penalties, and batch basecalling."""
