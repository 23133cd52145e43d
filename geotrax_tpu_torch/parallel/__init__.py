"""Spatial tiling of the detector (``tiling.py``); sharding over several
cards waits for ROADMAP A15."""
