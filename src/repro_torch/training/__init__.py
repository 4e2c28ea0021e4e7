"""Training of the PyTorch port (reference: ``repro/training``)."""
