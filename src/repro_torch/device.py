"""Where the port's entry points run: the card unless the caller asks."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; no card is an error."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def generator_on(device=None, generator: torch.Generator | None = None) -> torch.Generator:
    """``generator`` if it draws on the resolved ``device`` (an error if it
    draws elsewhere), else a new one there seeded with 0."""
    dev = resolve_device(device)
    if generator is None:
        return torch.Generator(dev).manual_seed(0)
    own = generator.device
    if own.type != dev.type or (None not in (own.index, dev.index) and own.index != dev.index):
        raise ValueError(
            f"the generator draws on {own} but the parameters are asked for on {dev}: "
            f"pass device={str(own)!r} or a torch.Generator({str(dev)!r})"
        )
    return generator
