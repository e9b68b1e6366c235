"""Device selection for the port's entry points.

Every entry point (`Scalar.from_ints/random/zeros/ones`, the preprocessing
sources, `MpcFabric`, `execute_mock_mpc`) runs on the CUDA card unless the
caller asks for another device.  Without a card and without an explicit
device they raise: nothing carries on quietly on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; anything else is taken as given.  A CUDA
    device without an index gets the current one, so that it compares equal
    to the devices of the tensors made on it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
