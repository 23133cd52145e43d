"""Stabilization configuration of the port (the sequential ``Stabilizer``
waits for ROADMAP A11)."""

from geotrax_tpu_torch.stabilize.config import StabilizerConfig

__all__ = ["StabilizerConfig"]
