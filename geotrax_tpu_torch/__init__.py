"""geotrax_tpu_torch: the PyTorch/CUDA port of geotrax_tpu for NVIDIA Hopper.

The package mirrors ``geotrax_tpu``'s layout module for module, so each
function's counterpart sits at the same path. It imports ``torch``, ``numpy``
and the standard library only: nothing of JAX and nothing of the JAX
package. Plain tensor code is PyTorch; each kernel that the JAX package
wrote in Pallas for the TPU is a CUDA kernel written by hand for ``sm_90a``
(sources under ``csrc/``, built with ``nvcc`` on first use and bound with
``ctypes``). Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``, which selects each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"
