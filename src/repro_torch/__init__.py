"""MemFine in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

A port of the JAX package ``repro`` that keeps its module names, so each
module's counterpart is easy to find.  This package imports ``torch`` and
nothing of JAX or of ``repro``; its entry points run on a CUDA device unless
the caller asks for the CPU explicitly.
"""

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.

    ``"cuda"`` (the entry points' default) requires a card and raises when
    there is none: the port never falls back to the CPU on its own.  The CPU
    is used only when asked for by name, as the tests do."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the port's plain PyTorch path on the CPU")
    return dev
