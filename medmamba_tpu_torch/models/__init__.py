"""VSSM model and size registry."""
