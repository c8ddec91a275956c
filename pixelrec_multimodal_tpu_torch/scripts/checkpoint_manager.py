# pixelrec_multimodal_tpu_torch/scripts/checkpoint_manager.py
"""Checkpoint management from the command line.

    python -m pixelrec_multimodal_tpu_torch.scripts.checkpoint_manager \\
        list|organize|organize-manual|info [--checkpoint_dir D] [--dry-run]

Counterpart of the repo's ``scripts/checkpoint_manager.py``: scan a
checkpoint directory, read each checkpoint's model combination from its
``meta.json`` (``model_config``, which the port's Trainer writes), move
checkpoints into ``<vision>_<language>/`` and encoder pickles into
``encoders/`` (``--dry-run`` only prints the moves), assign the rest by
hand, and write a ``checkpoint_info.json`` summary. A checkpoint here is a
directory with the port's ``state.pt``; the JAX package's Orbax
``state/`` directories are not listed.
"""
from __future__ import annotations

import argparse
import json
import shutil
from datetime import datetime
from pathlib import Path
from typing import Dict, List, Optional

from ..utils.checkpointing import STATE_FILE


def is_checkpoint_dir(path: Path) -> bool:
    return path.is_dir() and (path / STATE_FILE).exists()


def dir_size(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob('*') if f.is_file())


def read_model_combo(ckpt: Path) -> Optional[str]:
    """'<vision>_<language>' from the checkpoint's ``meta.json``."""
    meta_path = ckpt / 'meta.json'
    if not meta_path.exists():
        return None
    try:
        meta = json.loads(meta_path.read_text())
    except (OSError, ValueError):
        return None
    mc = meta.get('model_config') or {}
    if 'vision_model' in mc or 'language_model' in mc:
        return f"{mc.get('vision_model')}_{mc.get('language_model')}"
    return None


def scan_checkpoints(base_dir: Path) -> List[Dict]:
    """All checkpoint dirs directly under base_dir or one level down."""
    found = []
    if not base_dir.exists():
        return found
    candidates = [p for p in base_dir.iterdir() if p.is_dir()]
    for p in list(candidates):
        candidates.extend(c for c in p.iterdir() if c.is_dir())
    for p in candidates:
        if is_checkpoint_dir(p):
            meta = {}
            if (p / 'meta.json').exists():
                try:
                    meta = json.loads((p / 'meta.json').read_text())
                except (OSError, ValueError):
                    pass
            found.append({
                'path': p,
                'name': p.name,
                'combo': read_model_combo(p),
                'epoch': meta.get('epoch'),
                'best_score': meta.get('best_early_stopping_score'),
                'size_mb': dir_size(p) / 1e6,
            })
    return found


def cmd_list(args):
    base = Path(args.checkpoint_dir)
    ckpts = scan_checkpoints(base)
    if not ckpts:
        print(f"No checkpoints found under {base}")
        return
    print(f"Found {len(ckpts)} checkpoints under {base}:\n")
    for c in ckpts:
        rel = c['path'].relative_to(base)
        print(f"  {rel}  combo={c['combo']}  epoch={c['epoch']}  "
              f"best={c['best_score']}  size={c['size_mb']:.1f}MB")
    pkls = list(base.rglob('*.pkl'))
    if pkls:
        print(f"\nEncoder pickles ({len(pkls)}):")
        for p in pkls:
            print(f"  {p.relative_to(base)}")


def _move(src: Path, dest: Path, dry_run: bool):
    if dry_run:
        print(f"[dry-run] would move {src} -> {dest}")
        return
    dest.parent.mkdir(parents=True, exist_ok=True)
    shutil.move(str(src), str(dest))
    print(f"Moved {src} -> {dest}")


def cmd_organize(args):
    """Move checkpoints into <combo>/ subdirs, pickles into encoders/."""
    base = Path(args.checkpoint_dir)
    for c in scan_checkpoints(base):
        combo = c['combo']
        if combo is None:
            print(f"Skipping {c['path'].name}: no model combo in metadata "
                  "(use organize-manual)")
            continue
        target = base / combo / c['path'].name
        if c['path'].parent.name == combo:
            continue  # already organized
        if target.exists():
            print(f"Skipping {c['path']}: target {target} exists")
            continue
        _move(c['path'], target, args.dry_run)
    for pkl in base.glob('*.pkl'):
        _move(pkl, base / 'encoders' / pkl.name, args.dry_run)


def cmd_organize_manual(args):
    """Assign checkpoints without a combo by hand (read from stdin)."""
    base = Path(args.checkpoint_dir)
    unassigned = [c for c in scan_checkpoints(base) if c['combo'] is None]
    if not unassigned:
        print("No unattributed checkpoints found.")
        return
    for c in unassigned:
        print(f"\nCheckpoint: {c['path']}")
        combo = input("Enter model combo (e.g. resnet_sentence-bert), "
                      "or blank to skip: ").strip()
        if not combo:
            continue
        _move(c['path'], base / combo / c['path'].name, args.dry_run)


def cmd_info(args):
    """Write checkpoint_info.json with sizes, epochs and scores."""
    base = Path(args.checkpoint_dir)
    ckpts = scan_checkpoints(base)
    info = {
        'generated_at': datetime.now().isoformat(),
        'checkpoint_dir': str(base),
        'num_checkpoints': len(ckpts),
        'total_size_mb': sum(c['size_mb'] for c in ckpts),
        'checkpoints': [{
            'path': str(c['path'].relative_to(base)),
            'model_combo': c['combo'],
            'epoch': c['epoch'],
            'best_score': c['best_score'],
            'size_mb': round(c['size_mb'], 2),
        } for c in ckpts],
    }
    out = base / 'checkpoint_info.json'
    with open(out, 'w') as f:
        json.dump(info, f, indent=2)
    print(json.dumps(info, indent=2))
    print(f"\nSummary written to {out}")


def main(cli_args=None):
    parser = argparse.ArgumentParser(description='Manage model checkpoints')
    parser.add_argument('command',
                        choices=['list', 'organize', 'organize-manual',
                                 'info'],
                        help='Action to perform')
    parser.add_argument('--checkpoint_dir', type=str,
                        default='models/checkpoints',
                        help='Base checkpoint directory')
    parser.add_argument('--dry-run', action='store_true',
                        help='Show planned moves without performing them')
    args = parser.parse_args(cli_args)
    {'list': cmd_list, 'organize': cmd_organize,
     'organize-manual': cmd_organize_manual, 'info': cmd_info}[args.command](args)


if __name__ == '__main__':
    main()
