"""Tensor primitives of the port: the counterparts of ``geotrax_tpu/ops``.

Plain PyTorch throughout, except the FAST corner score, which launches the
hand-written CUDA kernel in ``csrc/fast_score.cu`` on a CUDA tensor.
"""
