"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and there is
    no card. There is no fallback to the CPU: a caller that wants the plain
    PyTorch path passes ``device="cpu"``.

    On CUDA this also turns TF32 off for matrix products and cuDNN
    convolutions, so the detector's convolutions and ``match_l2``'s product
    run in full float32 like the JAX reference on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "geotrax_tpu_torch: device 'cuda' requested but "
                "torch.cuda.is_available() is False; pass device='cpu' to run "
                "the plain PyTorch path"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def to_device(array, device) -> torch.Tensor:
    """A host array (or list) as a tensor on ``device``. On a CUDA device the
    copy goes through pinned memory without blocking the host: it is
    ordered on the current stream, and the pinned buffer is not reused
    before it is done. Elsewhere it is ``torch.as_tensor(array).to(device)``."""
    tensor = torch.as_tensor(array)
    if torch.device(device).type != "cuda":
        return tensor.to(device)
    return tensor.pin_memory().to(device, non_blocking=True)
