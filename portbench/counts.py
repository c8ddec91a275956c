"""Operations and bytes of the work, from a configuration's widths, and the
peaks they are held against.

The counts are the benchmark's, computed from the configuration, never
from the port's head or kernels, so a later change to how the port computes
a pair does not move them. The peaks are the data sheet's for one NVIDIA
H100 SXM at its full 700 W (dense, no sparsity); a run records the card's
power limit beside every share.
"""
from __future__ import annotations

from typing import List, Optional

from .inputs import feature_widths, n_modalities

PEAK_BF16_FLOPS = 989e12      # bf16 tensor cores
PEAK_HBM_BYTES_PER_S = 3.35e12

# The pair kernel of each fusion, as the device trace names it.
PAIR_KERNEL = {'concatenate': 'pairwise_mlp_kernel',
               'gated': 'gated_pairwise_kernel'}


def _hidden(cfg: dict) -> List[int]:
    return list(cfg['model']['fusion_hidden_dims'])


def pair_ops(cfg: dict) -> int:
    """Operations to score one (user, item) pair once the first layer is
    split into a per-user and a per-item row (each computed once per user
    or item, not per pair): the products of the hidden chain, 2 h_i h_i+1;
    the assembly of the first layer's input, and the last dot, 2 h_last.
    Concat assembles by add, activation and rounding, 3 h1; gated by the
    softmax of its M gate logits, 6 M, and the gated sum of its M rows
    with the activation, 2 M h1 + h1. With [512, 256, 128]: concat 329,472;
    gated at M = 6 334,628."""
    h = _hidden(cfg)
    products = sum(2 * a * b for a, b in zip(h, h[1:]))
    if cfg['model']['fusion_type'] == 'concatenate':
        assembly = 3 * h[0]
    else:
        m = n_modalities(cfg)
        assembly = 2 * m * h[0] + h[0] + 6 * m
    return products + assembly + 2 * h[-1]


def request_bytes(cfg: dict, users: int, items: int) -> int:
    """Bytes a top-K request's pair scoring must move at the least, each
    read once and written once: the per-user rows and the per-item rows
    (float32; gated: the user's row and M gate logits, and each item's
    M - 1 rows of h1 and M gate logits), the hidden weights in bf16 with
    float32 biases, and the [users, items] float32 scores."""
    h = _hidden(cfg)
    weights = (2 * sum(a * b for a, b in zip(h, h[1:]))
               + 4 * (sum(h[1:]) + h[-1] + 1))
    if cfg['model']['fusion_type'] == 'concatenate':
        user_row, item_row = h[0], h[0]
    else:
        m = n_modalities(cfg)
        user_row, item_row = h[0] + m, (m - 1) * h[0] + m
    return 4 * (users * user_row + items * item_row + users * items) + weights


def sample_forward_ops(cfg: dict) -> int:
    """Products of one training sample's forward pass: each feature's
    projection, 2 in d; the gate (gated: 2 (M d) M, and the gated sum,
    2 M d); the MLP from the fused width, and the last dot. Three times
    this is the sample's forward and backward."""
    m = cfg['model']
    d, n_mod, h = m['embedding_dim'], n_modalities(cfg), _hidden(cfg)
    ops = sum(2 * w * d for w in feature_widths(cfg).values())
    if m['fusion_type'] == 'concatenate':
        fused = n_mod * d
    else:
        ops += 2 * (n_mod * d) * n_mod + 2 * n_mod * d
        fused = d
    widths = [fused] + h
    ops += sum(2 * a * b for a, b in zip(widths, widths[1:]))
    return ops + 2 * h[-1]


def roofline_seconds(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations at
    the bf16 peak and the bytes at the HBM peak."""
    return max(ops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def request_users(run) -> List[int]:
    """Users of each top-K request of the traced slice (its work units are
    the request's pairs)."""
    n = run.cell.config['n_items']
    return [round(u / n) for _, _, u in run.window.calls]


def pair_roofline_share(run, kernel: str) -> Optional[float]:
    """The pair kernel's share of its roofline over a traced slice, in %:
    the least time of every request's pair scoring (``roofline_seconds`` of
    its ``pair_ops`` and ``request_bytes``) over the summed device time of
    the kernel's launches; None where the trace holds no launch of it."""
    launches = run.trace.kernels(kernel)
    users = request_users(run)
    if not launches or not users:
        return None
    cfg = run.cell.config
    n = cfg['n_items']
    least = sum(roofline_seconds(u * n * pair_ops(cfg),
                                 request_bytes(cfg, u, n)) for u in users)
    return 100.0 * least / sum(t - s for _, s, t in launches)


def pair_mfu(run) -> Optional[float]:
    """The whole top-K call's share of the bf16 peak, in %: the untraced
    window's pairs a second times ``pair_ops`` over the peak."""
    if run.rate <= 0:
        return None
    return 100.0 * run.rate * pair_ops(run.cell.config) / PEAK_BF16_FLOPS


def train_mfu(run) -> Optional[float]:
    """The training step's share of the bf16 peak, in %: the untraced
    window's samples a second times three times ``sample_forward_ops``
    over the peak."""
    if run.rate <= 0:
        return None
    return (100.0 * run.rate * 3 * sample_forward_ops(run.cell.config)
            / PEAK_BF16_FLOPS)


def scan_other_share(run) -> Optional[float]:
    """Device time in operations other than the pair kernel (the scan's
    masking, the top-K merge, copies) over the device's busy time in the
    traced slice, in %; None without a launch of the pair kernel."""
    busy = run.trace.busy_s
    kernel = PAIR_KERNEL.get(run.cell.config['model']['fusion_type'])
    if busy <= 0 or kernel is None or not run.trace.kernels(kernel):
        return None
    other = sum(t - s for n, s, t in run.trace.device if kernel not in n)
    return 100.0 * other / busy


def launches_per_step(run) -> Optional[float]:
    """Device kernels (copies and sets left out) in the traced training
    slice over the steps taken in it (its work units are samples)."""
    steps = run.window.work / run.cell.config['training']['batch_size']
    if not steps or run.trace.n_kernels() == 0:
        return None
    return run.trace.n_kernels() / steps


def idle_share(run) -> Optional[float]:
    """The share of the untraced window in which no operation ran on the
    device, in %: one minus the device's busy seconds a unit of work in
    the device-only slice (the union of its intervals over the slice's
    work) times the untraced window's units a second. The profiler's own
    cost on the host stretches the traced slice, not the device's work, so
    the slice's own idle share would read the profiler too. None where
    nothing ran on the device."""
    units = run.window.work
    if run.trace.busy_s <= 0 or units <= 0 or run.rate <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / units * run.rate)
