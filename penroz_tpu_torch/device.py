"""Device resolution (counterpart of penroz_tpu/models/model.py
``_resolve_device``).

The port runs on the card: ``None`` means ``cuda``, and asking for the card
where there is none raises instead of falling back to the CPU.  Only an
explicit ``"cpu"`` (the tests, ``--device cpu``) runs the plain PyTorch
versions of the kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

_ACCELERATOR_NAMES = ("cuda", "gpu", "accelerator")


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """Map an API device string to a ``torch.device``.

    ``None``, ``"cuda"``, ``"gpu"`` and ``"accelerator"`` mean the first
    CUDA card (``"cuda:N"`` a given one); ``"cpu"`` the host.  Unknown
    strings raise ValueError (→ HTTP 400), and a CUDA request without a
    card raises RuntimeError."""
    if isinstance(device, torch.device):
        dev = device
    else:
        name = "cuda" if device is None else str(device).lower()
        if name in _ACCELERATOR_NAMES:
            name = "cuda"
        if name != "cpu" and not name.startswith("cuda"):
            raise ValueError(f"Unknown device {device!r}; expected 'cpu', "
                             f"'cuda', 'gpu' or 'accelerator'")
        dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"Unsupported device {device!r}")
    return dev
