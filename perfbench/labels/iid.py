"""IID labels: every sample's class drawn uniformly."""

import torch


def draw(traffic, classes: int, gen: torch.Generator,
         device: torch.device) -> torch.Tensor:
    """(clients, samples_per_client) int64 labels."""
    return torch.randint(classes, (traffic["clients"],
                                   traffic["samples_per_client"]),
                         generator=gen, device=device)
