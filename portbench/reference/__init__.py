"""Frozen plain checks and generators of the benchmark; nothing here
imports the program."""
