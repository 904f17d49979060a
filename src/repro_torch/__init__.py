"""PyTorch port of the dense paged-KV serving engine for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports none of
it. Entry points run on the card (``device="cuda"``) unless the caller
asks for the CPU, where every kernel takes its plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. A CUDA device without a card
    raises: the port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run the plain path on the CPU")
        # full f32 matmuls and convolutions, as the reference computes them
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
