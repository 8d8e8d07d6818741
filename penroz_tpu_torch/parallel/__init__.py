"""Part of the PyTorch port (see penroz_tpu_torch/__init__.py)."""
