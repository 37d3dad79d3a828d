"""Checkpoint loading (training is not ported yet)."""
