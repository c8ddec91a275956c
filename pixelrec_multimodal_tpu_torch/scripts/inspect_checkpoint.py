# pixelrec_multimodal_tpu_torch/scripts/inspect_checkpoint.py
"""Checkpoint weight sanity inspector.

    python -m pixelrec_multimodal_tpu_torch.scripts.inspect_checkpoint \\
        models/checkpoints/None_None/best_model

Counterpart of the repo's ``scripts/inspect_checkpoint.py``: prints every
parameter of the checkpoint's ``state.pt`` (by its state-dict name) with
its shape, mean absolute value and status, and exits 1 if any is all
zeros or holds a non-finite value.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..utils.checkpointing import load_checkpoint


def inspect_checkpoint_weights(checkpoint_path: str) -> bool:
    path = Path(checkpoint_path)
    restored = load_checkpoint(path.parent, path.name)
    if restored is None:
        print(f"Checkpoint not found at {path}")
        return False
    params = restored['state'].get('params', {})
    print(f"Inspecting {len(params)} parameter arrays in {path}:\n")
    ok = True
    for name, tensor in params.items():
        arr = tensor.detach().float().numpy()
        all_zero = not np.any(arr)
        nan = not np.isfinite(arr).all()
        status = 'ALL-ZERO!' if all_zero else ('NON-FINITE!' if nan else 'ok')
        if all_zero or nan:
            ok = False
        print(f"  {name:60s} shape={str(arr.shape):18s} "
              f"|mean|={np.abs(arr).mean():.3e}  {status}")
    print(f"\nResult: {'OK' if ok else 'CORRUPTION DETECTED'}")
    return ok


def main(cli_args: Optional[List[str]] = None) -> int:
    """The exit code: 0 when every parameter is sound, else 1."""
    parser = argparse.ArgumentParser(
        description='Inspect checkpoint weights for corruption')
    parser.add_argument('checkpoint', type=str,
                        help='Path to a checkpoint directory '
                             '(e.g. models/checkpoints/None_None/best_model)')
    args = parser.parse_args(cli_args)
    return 0 if inspect_checkpoint_weights(args.checkpoint) else 1


if __name__ == '__main__':
    sys.exit(main())
