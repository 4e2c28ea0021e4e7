"""Tensor/expert-parallel execution of the serving paths on one device,
and the step functions (train, prefill, decode). Port of
``repro/distributed``."""
