"""Datasets, batch loader and on-device preprocessing."""
