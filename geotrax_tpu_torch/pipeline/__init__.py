"""The port's extract path: the fused chunk step and the row emission."""
