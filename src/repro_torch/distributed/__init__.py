"""Tensor/expert-parallel execution of the serving paths on one device.
Port of ``repro/distributed`` (only what ``tp.py`` needs)."""
