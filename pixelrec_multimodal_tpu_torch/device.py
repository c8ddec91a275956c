# pixelrec_multimodal_tpu_torch/device.py
"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = 'cuda') -> torch.device:
    """The torch device an entry point runs on.

    Entry points default to ``'cuda'``. Without a CUDA device they raise
    rather than carry on quietly on the CPU: the CPU runs only when the
    caller asks for it with ``device='cpu'``.
    """
    dev = torch.device(device)
    if dev.type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available (torch.cuda.is_available() is "
                "False); pass device='cpu' to run the plain CPU path")
        if dev.index is None:
            dev = torch.device('cuda', torch.cuda.current_device())
    elif dev.type != 'cpu':
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
