"""Data pipeline of the port."""
from .pipeline import SyntheticLM, make_device_batch
