"""Non-IID-a labels (the paper's §6.1, the law of the port's
``partition_noniid_a``): client ``n`` holds ``k_n`` classes, ``k_n``
uniform on 2..C, the classes drawn without replacement; its samples'
labels are drawn uniformly over those classes.  Every client keeps the
traffic's ``samples_per_client``, so the work of a round does not depend
on the seed."""

import torch


def draw(traffic, classes: int, gen: torch.Generator,
         device: torch.device) -> torch.Tensor:
    """(clients, samples_per_client) int64 labels."""
    n, s = traffic["clients"], traffic["samples_per_client"]
    held = torch.randint(2, classes + 1, (n, 1), generator=gen,
                         device=device)
    # each row a uniform permutation of the classes: its first k_n are
    # k_n classes drawn without replacement
    perm = torch.rand((n, classes), generator=gen,
                      device=device).argsort(dim=1)
    pick = (torch.rand((n, s), generator=gen, device=device)
            * held).long().clamp_(max=held - 1)
    return perm.gather(1, pick)
