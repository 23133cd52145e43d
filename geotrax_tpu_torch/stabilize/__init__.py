"""Stabilization of the port: the configuration surface and the sequential
``Stabilizer`` (one frame at a time; georeferencing registers with it)."""

from geotrax_tpu_torch.stabilize.config import StabilizerConfig
from geotrax_tpu_torch.stabilize.stabilizer import Stabilizer

__all__ = ["Stabilizer", "StabilizerConfig"]
