"""Process groups, the device mesh and data-parallel helpers."""
