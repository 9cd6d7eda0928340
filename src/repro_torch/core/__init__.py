"""Core of the port: so far only the Hopper roofline model."""
from .cost_model import H100, HopperModel, HopperSpec, RooflineTerms
