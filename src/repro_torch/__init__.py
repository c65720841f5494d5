"""PyTorch + CUDA port of the BEAM-LRC compressed-MoE serving system.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``repro/X/Y.py`` -> ``repro_torch/X/Y.py``) and imports neither
``jax`` nor ``repro``.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; on CPU tensors every kernel wrapper runs
its plain PyTorch version.
"""
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for and absent, so a missing
    card is never silently replaced by the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return dev
