# pixelrec_multimodal_tpu_torch/ops/pairwise_mlp.py
"""Fused pairwise-MLP scoring: the full-catalog hot path.

Counterpart of ``pixelrec_multimodal_tpu/ops/pairwise_mlp.py`` for
concatenate and gated fusion. Scoring every (user, item) pair through the
prediction MLP is made compute-bound in three steps:

  1. BatchNorm folding: eval-mode BN is affine and folds into the next
     Dense, so the MLP becomes a Dense -> act chain.
  2. First-layer factorization: the first Dense over
     ``concat(user_emb, item_block)`` splits into a per-user row
     ``user_emb @ W_user`` and a per-item row ``item_block @ W_item + b1``
     (computed once per catalog), so a pair only adds two rows. Gated
     fusion splits its gate logits the same way, and a pair forms the
     softmax-weighted sum of the user row and the Mi item rows.
  3. One kernel scores a [users x items] block with every activation kept
     on chip: K1 (``csrc/pairwise_mlp.cu``) for concatenate fusion, K2
     (``csrc/gated_pairwise_mlp.cu``) for exact gated fusion, K3
     (``csrc/gated_factored_mlp.cu``) for its factored form. In their
     bf16 mode all three run the wgmma chain of
     ``csrc/mlp_chain_wgmma.cuh`` (the weights packed by
     ``wgmma_weights``) in blocks of 128 and 64 pair rows where that block
     fits, and the ``mma.sync`` chain of ``csrc/mlp_chain.cuh`` below
     (``chain_kind``).

``pairwise_scores``, ``pairwise_scores_gated`` and
``pairwise_scores_gated_factored`` are the kernels' wrappers: CUDA tensors
go through the kernel, CPU tensors through the plain version in float32
(the JAX package's XLA fallback math). The plain versions with
``compute_dtype=torch.bfloat16`` repeat each kernel's bf16 rounding points
and are what the kernels are held against on the card.

A head that carries ``qlayers`` (``quantize_head``) scores in int8: each
hidden Dense quantizes its input affinely to int8 codes, multiplies them
with per-column int8 weights into int32 sums and rescales in float32
(``_chain_scores_int8``). The same three kernels then run their int8 mode
(K1q, K2q, K3q): the assembly of the bf16 mode, then an int8 chain: the
s8 wgmma chain of ``csrc/mlp_chain_wgmma_int8.cuh`` (the quantized weights
packed by ``wgmma_weights``) in blocks of 128 rows and of 64 where that
block fits, and the ``mma.sync`` chain of ``csrc/mlp_chain_int8.cuh``
below.

A kernel's block holds 8, 4, 2 or 1 users x 16 items (128 to 16 pair
rows): ``block_rows`` takes the largest whose shared memory, as the
kernel's own launch set-up counts it (``block_bytes``), fits the card's 227
KB, once per kernel and chain, and every launch passes it to the kernel,
which checks it again. Every output's sums run in the same order whatever
the row count, so the bf16 kernels give the same scores at any of them on
one chain.
``check_pair_kernel_fits`` refuses a head that fits no block before a
scorer builds its tables.

Head tensors keep the JAX package's 128-lane zero padding, so they compare
one to one with the JAX head; the padding is exact (zero rows and columns).
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.multimodal import activation_fn, final_activation_fn
from . import _build

LANE = 128

# Codes the CUDA kernel takes (act_fn / final_fn in csrc/pairwise_mlp.cu).
ACTIVATIONS = {'relu': 0, 'gelu': 1, 'tanh': 2, 'leaky_relu': 3, 'silu': 4}
FINAL_ACTIVATIONS = {'sigmoid': 0, 'tanh': 1}  # anything else: none (2)
MAX_HIDDEN = 8  # hidden Dense layers after the first one the kernel takes
GATE_PAD = 8  # gated fusion pads the modality axis of its gates to this

# A block's shape (csrc/mlp_chain.cuh) and the shared memory it may take.
SMEM_OPTIN = 232448  # shared memory a block may opt in to on sm_90, 227 KB
BLOCK_ROWS = (128, 64, 32, 16)  # pair rows: 8, 4, 2 or 1 users x 16 items


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _kernel_of(layer) -> np.ndarray:
    """A torch Linear's weight in Flax kernel layout [in, out], float32."""
    return np.ascontiguousarray(
        layer.weight.detach().cpu().numpy().T.astype(np.float32))


def fold_prediction_mlp(model) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Fold eval-mode BatchNorm into the prediction MLP's Dense kernels.

    BN after hidden layer i is ``h' = a*h + c`` with a = scale/sqrt(var+eps)
    and c = bias - mean*a; it folds into layer i+1 as W' = a[:,None]*W and
    b' = b + c @ W (the bias correction uses the original kernel). Returns
    the folded (kernels [in, out], biases) as float32 numpy arrays.
    """
    pn = model.prediction_network
    n_hidden = len(model.fusion_hidden_dims)
    kernels = [_kernel_of(getattr(pn, f'Dense_{i}'))
               for i in range(n_hidden + 1)]
    biases = [getattr(pn, f'Dense_{i}').bias.detach().cpu().numpy()
              .astype(np.float32) for i in range(n_hidden + 1)]
    if model.use_batch_norm:
        for i in range(n_hidden):
            bn = getattr(pn, f'BatchNorm_{i}')
            scale = bn.weight.detach().cpu().numpy().astype(np.float32)
            bias = bn.bias.detach().cpu().numpy().astype(np.float32)
            mean = bn.running_mean.detach().cpu().numpy().astype(np.float32)
            var = bn.running_var.detach().cpu().numpy().astype(np.float32)
            a = scale / np.sqrt(var + 1e-5)
            c = bias - mean * a
            biases[i + 1] = biases[i + 1] + c @ kernels[i + 1]
            kernels[i + 1] = a[:, None] * kernels[i + 1]
    return kernels, biases


def pad2(w: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Zero-pad a 2D matrix to [rows, cols]."""
    out = np.zeros((rows, cols), np.float32)
    out[:w.shape[0], :w.shape[1]] = w
    return out


def pack_mlp_chain(kernels: List[np.ndarray], biases: List[np.ndarray],
                   n_hidden: int,
                   device: Union[str, torch.device] = 'cpu'
                   ) -> Tuple[int, torch.Tensor,
                              List[Tuple[torch.Tensor, torch.Tensor]]]:
    """Lane-pad the folded chain: (h1, padded first bias, [(W, b)] for
    layers 1..n_hidden+1). The last layer is padded to one lane group and
    only its column 0 is live."""
    w1, b1 = kernels[0], biases[0]
    h1 = _round_up(w1.shape[1], LANE)
    padded_b1 = np.zeros(h1, np.float32)
    padded_b1[:b1.shape[0]] = b1

    def tensor(a):
        return torch.from_numpy(a).to(device)

    layers = []
    prev = h1
    for i in range(1, n_hidden + 1):
        w, b = kernels[i], biases[i]
        cols = _round_up(w.shape[1], LANE) if i < n_hidden else LANE
        bp = np.zeros(cols, np.float32)
        bp[:b.shape[0]] = b
        layers.append((tensor(pad2(w, prev, cols)), tensor(bp)))
        prev = cols
    return h1, tensor(padded_b1), layers


def build_factorized_head(model) -> Optional[dict]:
    """The factorized, BN-folded head of a concatenate- or gated-fusion
    model, its tensors on the model's device. ``head['kernel']`` holds the
    tensors the CUDA kernels read (``kernel_chain``), built once here.

    * ``concatenate``: the first Dense over ``concat(user, items...)``
      splits by rows into ``w_user`` and ``w_item``; ``b1`` folds into the
      per-item rows (``compute_item_first``).
    * ``gated``: the gate logits ``concat @ W_g`` split the same way into
      ``wg_user [d, M]`` and ``wg_item [Mi, d, M]`` (user first, then the
      Mi item-side modalities), and the first Dense distributes over the
      softmax-weighted sum, ``fused @ W1 = sum_m g_m * (feat_m @ W1)``, so
      every ``feat_m @ w_fused`` is a per-user or per-item row. ``b1``
      folds into every one of them (the gates sum to 1).
    """
    if model.fusion_type not in ('concatenate', 'gated'):
        return None  # attention: ops/attention_scorer.build_attention_head
    kernels, biases = fold_prediction_mlp(model)
    n_hidden = len(model.fusion_hidden_dims)
    d = model.embedding_dim
    device = model.device
    w1 = kernels[0]
    h1, padded_b1, layers = pack_mlp_chain(kernels, biases, n_hidden, device)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    head = {
        'fusion': model.fusion_type,
        'b1': padded_b1,
        'layers': layers,
        'activation': model.fusion_activation,
        'final_activation': model.final_activation,
        'b1_folded': True,
    }
    if model.fusion_type == 'concatenate':
        w_item = w1[d:]
        head['w_user'] = tensor(pad2(w1[:d], d, h1))
        head['w_item'] = tensor(pad2(w_item, w_item.shape[0], h1))
    else:
        wg = _kernel_of(model.fusion_layer.gating)             # [M*d, M]
        n_mod = wg.shape[1]
        head['w_fused'] = tensor(pad2(w1, d, h1))
        head['wg_user'] = tensor(wg[:d])
        head['wg_item'] = tensor(wg[d:].reshape(n_mod - 1, d, n_mod))
        head['bg'] = tensor(model.fusion_layer.gating.bias.detach().cpu()
                            .numpy().astype(np.float32))
        head['n_item_mods'] = n_mod - 1
        head['h1'] = h1
    head['kernel'] = kernel_chain(head)
    return head


def compute_item_first(head: dict, item_flat: torch.Tensor) -> torch.Tensor:
    """Per-item first-layer rows, once per catalog: item_flat [N, D_item]
    @ W_item + b1."""
    return item_flat.float() @ head['w_item'] + head['b1']


def compute_user_first(head: dict, user_emb: torch.Tensor) -> torch.Tensor:
    """Per-user first-layer rows: user_emb [B, d] @ W_user -> [B, h1]."""
    return user_emb.float() @ head['w_user']


def _pad_gates(g: torch.Tensor) -> torch.Tensor:
    """Pad the modality axis of [n, M] gate values to GATE_PAD columns of
    float32 zeros."""
    if g.shape[1] > GATE_PAD:
        raise ValueError(f'gated fusion takes at most {GATE_PAD} '
                         f'modalities, got {g.shape[1]}')
    out = torch.zeros((g.shape[0], GATE_PAD), dtype=torch.float32,
                      device=g.device)
    out[:, :g.shape[1]] = g.float()
    return out


def compute_item_side_gated(head: dict, item_feats: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-item rows of a gated head, once per catalog: item_feats
    [N, Mi, d] -> (item_first [N, Mi*h1], each modality's ``feat @
    w_fused + b1`` side by side; item_gates [N, GATE_PAD], the item-side
    gate logits plus the gate bias, zero-padded)."""
    f32 = item_feats.float()
    first = torch.einsum('nmd,dh->nmh', f32, head['w_fused']) + head['b1']
    gates = torch.einsum('nmd,mdg->ng', f32, head['wg_item']) + head['bg']
    return first.reshape(first.shape[0], -1), _pad_gates(gates)


def compute_user_side_gated(head: dict, user_emb: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-user rows of a gated head: (user_first [B, h1] with b1 folded
    in, user_gates [B, GATE_PAD] zero-padded)."""
    f32 = user_emb.float()
    return (f32 @ head['w_fused'] + head['b1'],
            _pad_gates(f32 @ head['wg_user']))


# The factored form of the gated softmax: per side,
#     g_m = exp(ug_m + ig_m) / Z = a_m[user] * b_m[item] / Z,
#     a = exp(ug - max ug),  b = exp(ig - max ig),  Z = sum_m a_m b_m
# (the per-side max subtractions cancel in the ratio), so the item part of
# the assembly is a contraction of the user's coefficient row against
# per-item tables b_m * item_first_m built once per catalog:
#     x1 = (a_0 b_0 * uf + sum_{m>=1} bf16(a_m) * T[item, m-1]) / Z.
# It is approximate (the tables and the coefficients are bf16), so it is
# held against the JAX package's factored math, never against the exact.
def factor_gated_user(head: dict, user_first: torch.Tensor,
                      user_gates: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(user_first, a [B, GATE_PAD]): the user's exp'd, max-subtracted
    gate coefficients, zero in the padding slots."""
    ug = user_gates[:, :head['n_item_mods'] + 1].float()
    return user_first, _pad_gates(
        torch.exp(ug - ug.max(dim=1, keepdim=True).values))


def factor_gated_tables(head: dict, item_first: torch.Tensor,
                        item_gates: torch.Tensor,
                        table_dtype: torch.dtype = torch.bfloat16
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-catalog factored tables from the exact gated tables, item-major
    so that an item chunk is a slice of the leading axis:

      T   [N, Mi, h1] ``table_dtype``: T[n, m-1] = b_m[n] * item_first_m[n]
          for the item-side modalities m = 1..Mi (the user slot, which the
          JAX package's T4 layout keeps as a zero row, is left out);
      igb [N, GATE_PAD] float32: b[n], zero in the padding slots.

    The JAX package lays T out as T4 [h1/128, GATE_PAD, N*128] for the
    TPU's lanes; ``T4[blk, m, n*128 + l] == T[n, m-1, blk*128 + l]``.
    """
    Mi, h1 = head['n_item_mods'], head['h1']
    ig = item_gates[:, :Mi + 1].float()
    b = torch.exp(ig - ig.max(dim=1, keepdim=True).values)    # [N, M]
    t = item_first.float().reshape(-1, Mi, h1) * b[:, 1:, None]
    return t.to(table_dtype).contiguous(), _pad_gates(b)


# ------------------------------------------------------------- int8 head
# Opt-in int8 scoring (CatalogScorer(precision='int8')). Each hidden Dense
# quantizes its input affinely, x ~ (xq + 128) * a + mn with xq in
# [-128, 127] and a = (mx - mn) / 255 from a calibrated range [mn, mx], and
# its weights symmetrically per column, W ~ wq * wscale. Then
#     x @ W + b = a * wscale * (xq @ wq) + [b + 128 a wscale colsum(wq)
#                                          + mn colsum(W)],
# an int32 product rescaled by the per-column out_scale = a * wscale and
# shifted by bias_eff. Scores are approximate; never a default.

# The auto-precision gate of CatalogScorer(precision='int8'): int8 serves
# only heads whose hidden chain does at least this many operations per
# first-layer lane (``int8_chain_flops_per_lane``), where the int8 kernel
# beats the bf16 one. Each pair's h1-wide quantize and every layer's
# rescale run outside the tensor cores, so the int8 mode wins only where
# its products are faster than the bf16 wgmma chain's by more than that.
# On an NVIDIA H100 80GB HBM3 (700.00 W; chip_smoke.py's int8_flip_point
# phase, PERF.md), on the chains whose h1 is a multiple of 128, as the
# scorer's heads are: since all three int8 modes run the s8 wgmma chain,
# each is the faster on every chain measured, from 64 (the least ratio of
# any head the int8 mode takes):
#   gated heads (K2q against K2, K3q against K3): 0.93x and 0.91x the bf16
#     time at the flagship's 640;
#   concatenate heads (K1q against K1): 0.86x at 640, 0.79x at 64 (h1
#     512), so 'int8' serves the flagship concat head through K1q.
# The JAX package's 1000 is the TPU's.
INT8_MIN_CHAIN_FLOPS_PER_LANE = 64
INT8_MIN_CHAIN_FLOPS_PER_LANE_CONCAT = 64


def int8_chain_flops_per_lane(head: dict) -> float:
    """Hidden-chain operations per pair over the first-layer width: the
    auto-precision gate's measure."""
    chain = sum(2 * w.shape[0] * w.shape[1] for w, _ in head['layers'][:-1])
    h1 = head.get('h1') or head['b1'].shape[0]
    return chain / max(h1, 1)


def quantize_mlp_chain(head: dict, ranges: Sequence[Tuple[float, float]]
                       ) -> List[dict]:
    """Quantize the hidden layers of a head to int8, in the JAX package's
    numpy arithmetic (``np.round`` half to even, so ``wq`` equals JAX's
    for equal weights).

    ranges: the calibrated (min, max) of each hidden layer's input
    (``calibrate_head_ranges``). Returns one dict per hidden layer on the
    head's device: ``wq`` int8 [in, out] and ``params`` float32 [3, out],
    row 0 out_scale (a * wscale), row 1 bias_eff, row 2 (inv_a, off, 0...)
    for the quantize ``xq = floor(x * inv_a + off)``, where off folds the
    zero point and the rounding: -mn / a + 0.5 - 128.
    """
    qlayers = []
    for j, (w, b) in enumerate(head['layers'][:-1]):
        device = w.device
        w = w.detach().cpu().numpy().astype(np.float32)
        b = b.detach().cpu().numpy().astype(np.float32)
        mn, mx = float(ranges[j][0]), float(ranges[j][1])
        a = max(mx - mn, 1e-12) / 255.0
        wscale = np.maximum(np.abs(w).max(axis=0), 1e-12) / 127.0
        wq = np.clip(np.round(w / wscale[None, :]), -127, 127)
        out_scale = (a * wscale).astype(np.float32)
        bias_eff = (b + out_scale * 128.0 * wq.sum(axis=0)
                    + mn * w.sum(axis=0)).astype(np.float32)
        params = np.zeros((3, w.shape[1]), np.float32)
        params[0] = out_scale
        params[1] = bias_eff
        params[2, 0] = 1.0 / a
        params[2, 1] = -mn / a + 0.5 - 128.0
        qlayers.append({'wq': torch.from_numpy(wq.astype(np.int8)).to(device),
                        'params': torch.from_numpy(params).to(device)})
    return qlayers


def quantize_head(head: dict, ranges: Sequence[Tuple[float, float]]) -> dict:
    """Put the head in int8 mode in place: ``qlayers`` from ``ranges``, and
    ``head['kernel']`` rebuilt for the kernels' int8 mode (the bf16 chain
    cached by ``build_factorized_head`` would otherwise stay there).
    Returns the head."""
    head['qlayers'] = quantize_mlp_chain(head, ranges)
    head['kernel'] = kernel_chain(head)
    return head


def _chain_input_ranges(head: dict, x: torch.Tensor
                        ) -> List[Tuple[float, float]]:
    """(min, max) of each hidden layer's input through the float32 chain;
    x: the assembled first-layer activations [rows, h1]."""
    act = activation_fn(head['activation'])
    out = []
    for w, b in head['layers'][:-1]:
        out.append((x.min().item(), x.max().item()))
        x = act(x @ w + b)
    return out


def calibrate_head_ranges(head: dict, user_first: torch.Tensor,
                          item_first: torch.Tensor
                          ) -> List[Tuple[float, float]]:
    """Each hidden layer's input (min, max) over every pair of a
    calibration sample ([B, h1] x [C, h1]), through the float32 chain, on
    the rows' device."""
    act = activation_fn(head['activation'])
    B, C = user_first.shape[0], item_first.shape[0]
    x = user_first.float()[:, None, :] + item_first.float()[None, :, :]
    if not head.get('b1_folded'):
        x = x + head['b1']
    return _chain_input_ranges(head, act(x).reshape(B * C, -1))


def calibrate_head_ranges_gated(head: dict,
                                user_side: Tuple[torch.Tensor, torch.Tensor],
                                item_side: Tuple[torch.Tensor, torch.Tensor]
                                ) -> List[Tuple[float, float]]:
    """Gated calibration: the ranges through the exact gated assembly
    (softmax-weighted first-layer parts) and the float32 chain, from the
    exact gated rows (user_first, user_gates) and (item_first,
    item_gates)."""
    act = activation_fn(head['activation'])
    (uf, ug), (itf, ig) = user_side, item_side
    n_mod, h1 = head['n_item_mods'] + 1, head['h1']
    B, C = uf.shape[0], itf.shape[0]
    g = torch.softmax(ug[:, None, :n_mod] + ig[None, :, :n_mod], dim=-1)
    x = g[:, :, 0, None] * uf[:, None, :]
    for m in range(n_mod - 1):
        x = x + g[:, :, m + 1, None] * itf[None, :, m * h1:(m + 1) * h1]
    if not head.get('b1_folded'):
        x = x + head['b1']
    return _chain_input_ranges(head, act(x).reshape(B * C, h1))


def _int8_product(codes: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The int32 product of int8 codes [rows, K] (held as float32) with
    int8 weights [K, N], exact, rounded once to float32. In float32 every
    partial sum is an integer of at most K * 128 * 127 in magnitude, exact
    below 2**24 in any order (K <= 1032, TF32 included: the codes fit its
    mantissa); wider layers multiply in float64."""
    if wq.shape[0] * 128 * 127 < 2 ** 24:
        return codes @ wq.float()
    return (codes.double() @ wq.double()).float()


def _chain_scores_int8(head: dict, x: torch.Tensor) -> torch.Tensor:
    """The int8 chain on first-layer activations [rows, h1] (float32, or
    bf16 where a kernel rounds them), JAX's ``_quantize_rows`` and
    ``_mlp_chain_int8``: per hidden layer the codes clip(floor(x * inv_a +
    off), -128, 127), their exact integer product, then act(f32(acc) *
    out_scale + bias_eff) in float32, every product and sum rounded on its
    own; the last layer an f32 dot against the unrounded float32 column 0
    of W_last plus b_last[0]. Nothing after the first layer is rounded to
    bf16."""
    act = activation_fn(head['activation'])
    x = x.float()
    for q in head['qlayers']:
        p = q['params']
        codes = torch.clamp(torch.floor(x * p[2, 0] + p[2, 1]), -128, 127)
        x = act(_int8_product(codes, q['wq']) * p[0] + p[1])
    w_last, b_last = head['layers'][-1]
    s = (x * w_last[:, 0].float()).sum(dim=1) + b_last[0].float()
    return final_activation_fn(s, head['final_activation'])


def _check_head(head: dict):
    if not head.get('b1_folded'):
        raise ValueError('pair scoring takes heads with b1 folded into the '
                         'item rows (build_factorized_head)')
    qlayers = head.get('qlayers')
    if qlayers is not None:
        n_hidden = len(head['layers']) - 1
        if len(qlayers) != n_hidden or not qlayers:
            raise ValueError(f'an int8 head carries one quantized layer '
                             f'(qlayers) per hidden layer, at least one: '
                             f'got {len(qlayers)} for {n_hidden}')
        widths = [head['layers'][0][0].shape[0]] + [
            q['wq'].shape[1] for q in qlayers]
        if any(wd % 32 for wd in widths):
            raise ValueError(f'int8 layers take widths that are multiples '
                             f'of 32, got {widths}')


def _chain_scores_f32(head: dict, x: torch.Tensor) -> torch.Tensor:
    """Float32 Dense chain on assembled first-layer activations [rows, h1]
    -> [rows] scores; the int8 chain for a head with ``qlayers`` (JAX's
    ``_xla_chain_scores``)."""
    if head.get('qlayers') is not None:
        return _chain_scores_int8(head, x)
    act = activation_fn(head['activation'])
    n = len(head['layers'])
    for i, (w, b) in enumerate(head['layers']):
        x = x @ w + b
        if i < n - 1:
            x = act(x)
    return final_activation_fn(x[:, 0], head['final_activation'])


def _chain_scores_bf16(head: dict, x: torch.Tensor) -> torch.Tensor:
    """The kernel's bf16 chain on bf16 activations [rows, h1]: bf16
    operands with float32 products and sums (an f32 product of two bf16
    values is exact), bias rounded to bf16 and added in f32, the sum
    rounded to bf16 before the activation, whose result is rounded to bf16
    again; the last layer is an f32 dot against the bf16-rounded column 0
    of W_last plus the unrounded f32 b_last[0]. A head with ``qlayers``
    takes the int8 chain on the bf16 activations instead, as the kernels'
    int8 mode does."""
    if head.get('qlayers') is not None:
        return _chain_scores_int8(head, x)
    bf16 = torch.bfloat16
    act = activation_fn(head['activation'])
    for w, b in head['layers'][:-1]:
        acc = x.float() @ w.to(bf16).float()
        x = act((acc + b.to(bf16).float()).to(bf16).float()).to(bf16)
    w_last, b_last = head['layers'][-1]
    s = (x.float() * w_last[:, 0].to(bf16).float()).sum(dim=1) \
        + b_last[0].float()
    return final_activation_fn(s, head['final_activation'])


def _check_compute_dtype(compute_dtype: torch.dtype):
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'compute_dtype must be float32 or bfloat16, got '
                         f'{compute_dtype}')


def _finish(head: dict, x: torch.Tensor,
            compute_dtype: torch.dtype) -> torch.Tensor:
    """Scores [..., C] from float32 first-layer pre-activations
    [..., C, h1]: the activation in float32, then the float32 chain, or,
    for bfloat16, one bf16 rounding and ``_chain_scores_bf16`` (the gated
    kernels' rounding points)."""
    _check_compute_dtype(compute_dtype)
    x = activation_fn(head['activation'])(x)
    lead = x.shape[:-1]
    x = x.reshape(-1, x.shape[-1])
    if compute_dtype == torch.float32:
        return _chain_scores_f32(head, x).reshape(lead)
    return _chain_scores_bf16(head, x.to(torch.bfloat16)).reshape(lead)


def pairwise_scores_plain(head: dict, user_first: torch.Tensor,
                          item_first: torch.Tensor,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """Plain PyTorch pair scoring: [B, h1] x [C, h1] -> [B, C] float32.

    ``compute_dtype=torch.float32`` is the JAX package's XLA fallback math
    (``xla_pairwise_scores``). ``torch.bfloat16`` reproduces the kernel's
    rounding points: a bf16 add of the bf16-rounded user and item rows,
    the activation rounded to bf16, then ``_chain_scores_bf16``. On CUDA
    tensors the float32 products need TF32 off, which is torch's default
    (``torch.backends.cuda.matmul.allow_tf32 = False``).
    """
    _check_head(head)
    _check_compute_dtype(compute_dtype)
    act = activation_fn(head['activation'])
    B, C = user_first.shape[0], item_first.shape[0]
    if compute_dtype == torch.float32:
        x = act(user_first[:, None, :] + item_first[None, :, :])
        return _chain_scores_f32(head, x.reshape(B * C, -1)).reshape(B, C)
    bf16 = torch.bfloat16
    x = (user_first.to(bf16).float()[:, None, :]
         + item_first.to(bf16).float()[None, :, :]).to(bf16)
    x = act(x.float()).to(bf16)
    return _chain_scores_bf16(head, x.reshape(B * C, -1)).reshape(B, C)


def candidate_scores(head: dict, user_first: torch.Tensor,
                     item_first_rows: torch.Tensor) -> torch.Tensor:
    """Per-user candidate scoring, float32: [B, h1] x [B, C, h1] -> [B, C];
    each user pairs only with its own gathered candidate rows."""
    _check_head(head)
    act = activation_fn(head['activation'])
    B, C = item_first_rows.shape[:2]
    x = act(user_first[:, None, :] + item_first_rows)
    return _chain_scores_f32(head, x.reshape(B * C, -1)).reshape(B, C)


def _gated_first_layer(head: dict, user_first: torch.Tensor,
                       user_gates: torch.Tensor, item_first: torch.Tensor,
                       item_gates: torch.Tensor) -> torch.Tensor:
    """Gated first-layer pre-activations in float32, in kernel K2's order
    of operations (every sum left to right, each product and sum rounded
    on its own): softmax gates ``e_m * (1 / sum e)`` of the pairwise-added
    logits over the M live columns, then ``g_0 * uf + sum_m g_m * part_m``.
    The user tensors are [B, 1, ...] and the item tensors [1 or B, C, ...];
    returns [B, C, h1]."""
    n_mod, h1 = head['n_item_mods'] + 1, head['h1']
    logits = user_gates[..., :n_mod] + item_gates[..., :n_mod]
    e = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    tot = e[..., 0]
    for m in range(1, n_mod):
        tot = tot + e[..., m]
    g = e * (1.0 / tot)[..., None]
    x = g[..., 0, None] * user_first
    for m in range(n_mod - 1):
        x = x + g[..., m + 1, None] * item_first[..., m * h1:(m + 1) * h1]
    return x


def pairwise_scores_gated_plain(head: dict, user_first: torch.Tensor,
                                user_gates: torch.Tensor,
                                item_first: torch.Tensor,
                                item_gates: torch.Tensor,
                                compute_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """Plain exact gated pair scoring: user_first [B, h1], user_gates
    [B, GATE_PAD], item_first [C, Mi*h1], item_gates [C, GATE_PAD] ->
    [B, C] float32.

    ``torch.float32`` is the JAX package's XLA fallback math
    (``xla_pairwise_scores_gated``). ``torch.bfloat16`` repeats kernel K2's
    rounding points: the gates, the weighted sum and the activation in
    float32, one bf16 rounding, then ``_chain_scores_bf16`` (unlike K1, the
    user and item parts are not rounded before they are combined).
    """
    _check_head(head)
    x = _gated_first_layer(head, user_first[:, None], user_gates[:, None],
                           item_first[None], item_gates[None])
    return _finish(head, x, compute_dtype)


def candidate_scores_gated(head: dict,
                           user_side: Tuple[torch.Tensor, torch.Tensor],
                           item_first_rows: torch.Tensor,
                           item_gates_rows: torch.Tensor) -> torch.Tensor:
    """Gated per-user candidate scoring, float32
    (``xla_candidate_scores_gated``): each user pairs with its own gathered
    rows, item_first_rows [B, C, Mi*h1] and item_gates_rows [B, C,
    GATE_PAD] -> [B, C]."""
    _check_head(head)
    user_first, user_gates = user_side
    x = _gated_first_layer(head, user_first[:, None], user_gates[:, None],
                           item_first_rows, item_gates_rows)
    return _finish(head, x, torch.float32)


def pairwise_scores_gated_factored_plain(
        head: dict, user_first: torch.Tensor, user_coefs: torch.Tensor,
        tables: torch.Tensor, item_coefs: torch.Tensor,
        compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain factored gated pair scoring: user_first [B, h1], user_coefs
    a [B, GATE_PAD] (``factor_gated_user``), tables T [C, Mi, h1] and
    item_coefs igb [C, GATE_PAD] (``factor_gated_tables``) -> [B, C]
    float32.

    The JAX package's factored math: Z from the unrounded float32 a and b,
    floored at 1e-30; the contraction of a rounded to T's type against T
    with float32 sums; ``x = (a_0 b_0 * uf + r) * (1 / Z)``, every sum left
    to right as kernel K3 takes it. Then the activation and the chain as
    ``pairwise_scores_gated_plain``: float32, or K3's bf16 rounding points.
    """
    _check_head(head)
    n_mod = head['n_item_mods'] + 1
    a, b = user_coefs.float(), item_coefs.float()
    p0 = a[:, None, 0] * b[None, :, 0]
    z = p0
    for m in range(1, n_mod):
        z = z + a[:, None, m] * b[None, :, m]
    inv = 1.0 / torch.clamp(z, min=1e-30)
    coefs = a[:, 1:n_mod].to(tables.dtype).float()
    r = coefs[:, None, 0, None] * tables[None, :, 0].float()
    for m in range(1, n_mod - 1):
        r = r + coefs[:, None, m, None] * tables[None, :, m].float()
    x = (p0[..., None] * user_first[:, None, :] + r) * inv[..., None]
    return _finish(head, x, compute_dtype)


# ------------------------------------------------------------ CUDA kernels
def kernel_chain(head: dict,
                 device: Optional[Union[str, torch.device]] = None) -> dict:
    """The head's tensors in the kernel's layout on ``device`` (default:
    the head's): hidden weights as one bf16 buffer, biases and the live last
    column rounded to bf16 (held as float32), the width list from h1 on,
    and the activation codes. A head with an unfolded first Dense (``w1``
    [d, h1] and ``b1``, the attention head) takes it as the chain's layer
    0, so the widths start at d. A head with ``qlayers`` gets the int8
    mode's tensors (``_kernel_chain_int8``). Raises for a head the kernel
    does not take."""
    bf16 = torch.bfloat16
    h1 = head['b1'].shape[0]
    device = head['b1'].device if device is None else torch.device(device)
    if head.get('qlayers') is not None:
        return _kernel_chain_int8(head, device)
    hidden = list(head['layers'][:-1])
    w_last, b_last = head['layers'][-1]
    widths = [h1]
    if 'w1' in head:
        hidden.insert(0, (head['w1'], head['b1']))
        widths = [head['w1'].shape[0]]
    for w, _ in hidden:
        if w.shape[0] != widths[-1]:
            raise ValueError(f'layer input width {w.shape[0]} != previous '
                             f'width {widths[-1]}')
        widths.append(w.shape[1])
    if w_last.shape[0] != widths[-1]:
        raise ValueError(f'last layer input width {w_last.shape[0]} != '
                         f'{widths[-1]}')
    if len(hidden) > MAX_HIDDEN or any(wd <= 0 or wd % 16 for wd in widths):
        raise ValueError(f'the pairwise kernel takes at most {MAX_HIDDEN} '
                         f'hidden layers of widths that are positive '
                         f'multiples of 16, got {widths}')
    if hidden:
        w_all = torch.cat([w.to(device=device, dtype=bf16).reshape(-1)
                           for w, _ in hidden])
        b_all = torch.cat([b.to(device=device, dtype=bf16).float()
                           for _, b in hidden])
    else:  # no hidden layer: the buffers are never read
        w_all = torch.zeros(8, dtype=bf16, device=device)
        b_all = torch.zeros(1, dtype=torch.float32, device=device)
    return {
        'int8': False,
        'n_hidden': len(hidden),
        'widths': np.asarray(widths, np.int32),
        'w': w_all.contiguous(), 'b': b_all.contiguous(),
        'w_last': w_last[:, 0].to(device=device, dtype=bf16).float()
                                .contiguous(),
        'b_last': b_last[:1].to(device=device, dtype=torch.float32)
                            .contiguous(),
        'act': ACTIVATIONS.get(head['activation'].lower(), 0),
        'final': FINAL_ACTIVATIONS.get(head['final_activation'], 2),
    }


WGMMA_TILE = 64  # csrc/mlp_chain_wgmma.cuh: packed weight tiles of 64 columns


def wgmma_weights(chain: dict) -> torch.Tensor:
    """The chain's hidden weights packed for a wgmma chain: the bf16
    chain's for ``csrc/mlp_chain_wgmma.cuh`` (the bf16 modes of K1, K2 and
    K3, and K4, K5 and K6, at blocks of 128 and 64 pair rows), an int8
    chain's for the s8 chain of ``csrc/mlp_chain_wgmma_int8.cuh`` (K1q,
    K2q and K3q; probe P3 packs its two layers so too). Per layer, W^T
    [N, K] (the int8 chain's ``wq`` is stored so already) zero-padded to a
    multiple of 64 columns and of one k slice
    (64 bf16 or 128 int8 codes: a 128-byte row) and cut into tiles of 64
    columns x one k slice, 8 KB each, in the order (k slice, column group),
    each tile's rows 128 bytes whose 16-byte chunks are swizzled by the row
    (stored chunk = chunk ^ n % 8), the layout the kernel's descriptors
    read. Built once per chain dict and cached in it (``chain['w_wgmma']``)
    beside the weights it was packed from (``chain['w_wgmma_of']``):
    packed weights that came with another chain's (a copied dict whose
    ``w`` was replaced) are packed anew, never launched. ValueError for
    weights of the other mode's type (an int8 chain's are int8 codes)."""
    int8 = bool(chain.get('int8'))
    w = chain['w']
    want = torch.int8 if int8 else torch.bfloat16
    if w.dtype != want:
        raise ValueError(f"{'an int8' if int8 else 'a bf16'} chain's "
                         f'weights must be {want}, got {w.dtype}')
    packed = chain.get('w_wgmma')
    if packed is not None and chain.get('w_wgmma_of') is w:
        return packed
    t = WGMMA_TILE
    ks, chunk = (128, 16) if int8 else (64, 8)  # a k slice; a chunk's k
    widths = [int(x) for x in chain['widths']]
    rows = torch.arange(t, device=w.device) % 8
    source = torch.arange(8, device=w.device)[None, :] ^ rows[:, None]
    parts, off = [], 0
    for k, n in zip(widths[:-1], widths[1:]):
        wt = torch.zeros(_round_up(n, t), _round_up(k, ks), dtype=w.dtype,
                         device=w.device)
        layer = w[off:off + k * n]
        wt[:n, :k] = layer.view(n, k) if int8 else layer.view(k, n).t()
        off += k * n
        # [column group, n, k slice, chunk, element]
        tiles = wt.view(wt.shape[0] // t, t, wt.shape[1] // ks, 8, chunk)
        tiles = torch.gather(tiles, 3, source[None, :, None, :, None]
                             .expand_as(tiles))
        parts.append(tiles.permute(2, 0, 1, 3, 4).reshape(-1))
    packed = (torch.cat(parts) if parts
              else torch.zeros(8, dtype=w.dtype, device=w.device))
    chain['w_wgmma'], chain['w_wgmma_of'] = packed.contiguous(), w
    return chain['w_wgmma']


def _kernel_chain_int8(head: dict, device: torch.device) -> dict:
    """The int8 mode's tensors (``csrc/mlp_chain_int8.cuh``):

      w       every hidden layer's wq transposed to [N, K] (K contiguous,
              as the tensor cores' B operand wants it), back to back, int8;
      b       float32: (inv_a, off) of each layer in 2 * MAX_HIDDEN slots,
              then each layer's out_scale [N] and bias_eff [N];
      w_last  column 0 of W_last in float32, unrounded (the bf16 mode
              rounds it), and b_last [1].
    """
    if 'w1' in head:
        raise ValueError('the int8 mode takes concatenate and gated heads')
    _check_head(head)
    qlayers = head['qlayers']
    widths = [head['b1'].shape[0]] + [q['wq'].shape[1] for q in qlayers]
    w_last, b_last = head['layers'][-1]
    for q, k in zip(qlayers, widths):
        if q['wq'].shape[0] != k:
            raise ValueError(f"layer input width {q['wq'].shape[0]} != "
                             f'previous width {k}')
    if w_last.shape[0] != widths[-1]:
        raise ValueError(f'last layer input width {w_last.shape[0]} != '
                         f'{widths[-1]}')
    if len(qlayers) > MAX_HIDDEN:  # _check_head held the widths
        raise ValueError(f'the int8 kernels take at most {MAX_HIDDEN} '
                         f'hidden layers, got {len(qlayers)}')
    scalars = torch.zeros(2 * MAX_HIDDEN, dtype=torch.float32)
    for j, q in enumerate(qlayers):
        scalars[2 * j:2 * j + 2] = q['params'][2, :2].cpu()
    rows = [scalars.to(device)] + [q['params'][r].to(device).float()
                                   for q in qlayers for r in (0, 1)]
    return {
        'int8': True,
        'n_hidden': len(qlayers),
        'widths': np.asarray(widths, np.int32),
        'w': torch.cat([q['wq'].to(device).t().contiguous().reshape(-1)
                        for q in qlayers]),
        'b': torch.cat(rows).contiguous(),
        'w_last': w_last[:, 0].to(device=device, dtype=torch.float32)
                                .contiguous(),
        'b_last': b_last[:1].to(device=device, dtype=torch.float32)
                            .contiguous(),
        'act': ACTIVATIONS.get(head['activation'].lower(), 0),
        'final': FINAL_ACTIVATIONS.get(head['final_activation'], 2),
    }


def _chain_on(head: dict, device: torch.device) -> dict:
    """``head['kernel']`` where it lies on ``device`` and is in the head's
    mode (int8 when it carries ``qlayers``), else built for this call: a
    head quantized after its bf16 chain was cached never launches the bf16
    chain."""
    chain = head.get('kernel')
    if chain is None or chain['w'].device != device \
            or chain.get('int8', False) != (head.get('qlayers') is not None):
        chain = kernel_chain(head, device)
    return chain


def _check_tensor(name: str, t: torch.Tensor, device: torch.device,
                  dtype: torch.dtype, rows: int, tail: Tuple[int, ...],
                  align: int = 16):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of shape
    ``(rows, *tail)`` on ``device`` (rows < 0: any) whose data is aligned
    to ``align`` bytes, as the kernels' vector loads need."""
    if t.device != device or t.dtype != dtype or t.dim() != 1 + len(tail) \
            or tuple(t.shape[1:]) != tail \
            or (rows >= 0 and t.shape[0] != rows) \
            or not t.is_contiguous() or t.data_ptr() % align:
        want = ('n' if rows < 0 else str(rows),) + tuple(map(str, tail))
        raise ValueError(f'{name} must be a contiguous, {align}-byte aligned '
                         f'{dtype} [{", ".join(want)}] tensor on {device}; '
                         f'got {t.dtype} {tuple(t.shape)} on {t.device}')


def _device_of(name: str, *tensors: torch.Tensor) -> Optional[torch.device]:
    """None when every tensor lies on the CPU (the plain version runs),
    the CUDA device of the first one otherwise; raises for another
    device."""
    devices = {t.device for t in tensors}
    if all(d.type == 'cpu' for d in devices):
        return None
    device = tensors[0].device
    if device.type != 'cuda':
        raise ValueError(f'{name} runs on cuda or cpu tensors, got '
                         f'{sorted(map(str, devices))}')
    return device


def _n_mod(head: dict) -> int:
    n_mod = head['n_item_mods'] + 1
    if not 2 <= n_mod <= GATE_PAD:
        raise ValueError(f'the gated kernels take 2 to {GATE_PAD} '
                         f'modalities, got {n_mod}')
    return n_mod


def chain_widths(head: dict) -> Tuple[int, ...]:
    """The widths of the head's chain as its kernel takes them
    (``kernel_chain``'s, in either mode): h1, or d then h1 for a head with
    an unfolded first Dense (the attention head), then each hidden layer's
    output."""
    first = (list(head['w1'].shape) if 'w1' in head
             else [head['b1'].shape[0]])
    return tuple(int(w) for w in first
                 + [w.shape[1] for w, _ in head['layers'][:-1]])


def _error_string(lib, err: int) -> str:
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return f'{lib.kernel_error_string(err).decode()} ({err})'


def block_bytes(name: str, widths: Sequence[int], rows: int,
                mode: Tuple[int, ...]) -> int:
    """The shared memory ``csrc/<name>.cu``'s launch set-up counts for a
    block of ``rows`` pair rows on the chain of ``widths`` (its
    ``<name>_block_bytes``): ``mode`` is (int8,) for the pair kernels, (H,
    Mi) for the attention kernels. Negative (a CUDA error) for a shape the
    kernel does not take. It loads the kernel's library, so it runs where
    the kernels run: the launch's own count is the only one."""
    lib = _build.load(name)
    fn = getattr(lib, f'{name}_block_bytes')
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * (len(mode) + 1))
        fn.restype = ctypes.c_int
    wd = np.asarray(widths, np.int32)
    return fn(len(wd) - 1, wd.ctypes.data, *mode, rows)


CHAIN_KINDS = {1: 'mma.sync', 2: 'wgmma'}


def chain_kind(name: str, rows: int,
               widths: Optional[Sequence[int]] = None,
               mode: Tuple[int, ...] = (0,)) -> str:
    """The tensor-core chain ``csrc/<name>.cu`` runs in a block of ``rows``
    pair rows, as its library reports it (``<name>_chain_kind``):
    'wgmma' (``csrc/mlp_chain_wgmma.cuh``; the bf16 modes of K1, K2 and
    K3, and K4, K5 and K6, at 128 and 64 rows) or 'mma.sync'
    (``csrc/mlp_chain.cuh``; every kernel without the export). With
    ``widths`` (and ``mode``, as for ``block_bytes``) a kernel that
    chooses the chain by fit (K1, K2, K3: ``<name>_block_chain_kind``, a
    64-row block whose wgmma layout does not fit runs mma.sync) reports
    the chain of that block on those widths; in the int8 mode 'wgmma' is
    the s8 chain of ``csrc/mlp_chain_wgmma_int8.cuh`` (K1q, K2q and K3q,
    by fit). Loads the kernel's library."""
    lib = _build.load(name)
    fn = (getattr(lib, f'{name}_block_chain_kind', None)
          if widths is not None else None)
    if fn is not None:
        wd = np.asarray(widths, np.int32)
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * (len(mode) + 1))
        fn.restype = ctypes.c_int
        kind = fn(len(wd) - 1, wd.ctypes.data, *mode, rows)
        if kind not in CHAIN_KINDS:
            raise ValueError(f'{_what(name, widths, mode)}: no chain for '
                             f'{rows} pair rows '
                             f'({_error_string(lib, -kind)})')
        return CHAIN_KINDS[kind]
    fn = getattr(lib, f'{name}_chain_kind', None)
    if fn is None:
        return CHAIN_KINDS[1]
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    kind = fn(rows)
    if kind not in CHAIN_KINDS:
        raise ValueError(f'{name}: no chain for {rows} pair rows '
                         f'({_error_string(lib, -kind)})')
    return CHAIN_KINDS[kind]


def _what(name: str, widths: Sequence[int], mode: Tuple[int, ...]) -> str:
    kind = (f'{mode[0]} heads' if len(mode) == 2
            else 'int8' if mode[0] else 'bf16')
    return f'the {name} kernel ({kind}) on the chain {list(widths)}'


@functools.lru_cache(maxsize=None)
def block_rows(name: str, widths: Tuple[int, ...],
               mode: Tuple[int, ...]) -> int:
    """The pair rows of ``csrc/<name>.cu``'s block on the chain of
    ``widths`` in ``mode`` (``block_bytes``'s arguments): the largest of
    BLOCK_ROWS whose block fits SMEM_OPTIN. Chosen once per shape: a
    scorer's check at construction and every launch after read the same
    choice. ValueError if even 16 rows do not fit, or for a shape the
    kernel does not take."""
    for rows in BLOCK_ROWS:
        need = block_bytes(name, widths, rows, mode)
        if need < 0:
            raise ValueError(f'{_what(name, widths, mode)}: '
                             f'{_error_string(_build.load(name), -need)}')
        if need <= SMEM_OPTIN:
            return rows
    raise ValueError(
        f'{_what(name, widths, mode)} needs {need} B of shared memory per '
        f'block even at {BLOCK_ROWS[-1]} pair rows, past the {SMEM_OPTIN} B '
        f'a block may take')


def launch_rows(name: str, chain: dict, mode: Tuple[int, ...],
                forced: Optional[int] = None) -> int:
    """The pair rows a launch of ``csrc/<name>.cu`` on ``chain`` passes to
    its kernel: ``block_rows``, or ``forced`` (the wrappers' private
    ``_block_rows``, which tests use to compare row counts), which must be
    one of BLOCK_ROWS whose block fits."""
    widths = tuple(int(w) for w in chain['widths'])
    if forced is None:
        return block_rows(name, widths, mode)
    if forced not in BLOCK_ROWS \
            or not 0 <= block_bytes(name, widths, forced, mode) <= SMEM_OPTIN:
        raise ValueError(f'_block_rows must be one of {BLOCK_ROWS} whose '
                         f'block fits; got {forced} for '
                         f'{_what(name, widths, mode)}')
    return forced


PAIR_KERNELS = {None: 'pairwise_mlp', 'exact': 'gated_pairwise_mlp',
                'factored': 'gated_factored_mlp'}


def check_pair_kernel_fits(head: dict, gated_variant: Optional[str] = None,
                           int8: bool = False) -> int:
    """The block rows of the kernel a concatenate head (K1) or a gated head
    (K2 for ``'exact'``, K3 for ``'factored'``) launches, in the bf16 mode
    or, with ``int8``, the int8 mode; ValueError for a head that fits no
    block. A scorer calls it on the card before it builds any table."""
    return block_rows(PAIR_KERNELS[gated_variant], chain_widths(head),
                      (int(int8),))


def _launch(name: str, out: torch.Tensor, tensors, chain: dict, B: int,
            C: int, extra=(), mode: Optional[Tuple[int, ...]] = None,
            forced: Optional[int] = None) -> None:
    """Launch ``csrc/<name>.cu`` on the current stream, its int8 mode
    (``<name>_int8_forward``) for an int8 chain: the pointers of
    ``tensors``, then the chain's, then ``out``; then B, C, the chain's
    shape and codes, the ``extra`` ints, the block's pair rows
    (``launch_rows`` in ``mode``, by default the chain's (int8,)) and the
    stream. Raises if the launch fails."""
    rows = launch_rows(name, chain, (int(chain['int8']),) if mode is None
                       else mode, forced)
    lib = _build.load(name)
    fn = getattr(lib, f'{name}_int8_forward' if chain.get('int8')
                 else f'{name}_forward')
    n_ptrs = len(tensors) + 5
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] + [ctypes.c_int] * (3 + len(extra))
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    device = out.device
    with torch.cuda.device(device):
        err = fn(*(t.data_ptr() for t in tensors),
                 chain['w'].data_ptr(), chain['b'].data_ptr(),
                 chain['w_last'].data_ptr(), chain['b_last'].data_ptr(),
                 out.data_ptr(), B, C, chain['n_hidden'],
                 chain['widths'].ctypes.data, chain['act'], chain['final'],
                 *extra, rows, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f'{name} kernel failed: '
                           f'{_error_string(lib, err)}')


def pairwise_scores(head: dict, user_first: torch.Tensor,
                    item_first: torch.Tensor,
                    _block_rows: Optional[int] = None) -> torch.Tensor:
    """Fused [B, h1] x [C, h1] -> [B, C] float32 pair scoring (kernel K1,
    ``csrc/pairwise_mlp.cu``).

    CUDA tensors launch the kernel on the current stream (bf16 operands,
    float32 accumulation); B and C need not be tile multiples. The kernel's
    tensors come from ``head['kernel']`` when they lie on the rows' device,
    else ``kernel_chain`` builds them for this call; either mode reads the
    hidden weights packed for its wgmma chain too (``wgmma_weights``,
    cached in that dict). The block's pair rows are ``block_rows``'s (a
    head that fits no block raises ValueError; ``_block_rows`` forces a
    smaller block, for tests): the mode's wgmma chain (bf16, or s8 in the
    int8 mode) at 128 and 64 rows where its block fits, its mma.sync chain
    below (``chain_kind``). CPU tensors take
    ``pairwise_scores_plain`` in float32. Anything else raises.
    ``pairwise_scores.launches`` counts kernel launches of the bf16 mode,
    ``pairwise_scores.launches_int8`` those of the int8 mode (K1q), which a
    head with ``qlayers`` launches.
    """
    _check_head(head)
    device = _device_of('pairwise_scores', user_first, item_first)
    if device is None:
        return pairwise_scores_plain(head, user_first, item_first)
    chain = _chain_on(head, device)
    h1 = int(chain['widths'][0])
    B, C = user_first.shape[0], item_first.shape[0]
    _check_tensor('user_first', user_first, device, torch.float32, -1, (h1,))
    _check_tensor('item_first', item_first, device, torch.float32, -1, (h1,))
    out = torch.empty((B, C), dtype=torch.float32, device=device)
    if B == 0 or C == 0:
        return out
    tensors = (user_first, item_first, wgmma_weights(chain))  # either mode's
    _launch('pairwise_mlp', out, tensors, chain, B, C, forced=_block_rows)
    if chain['int8']:
        pairwise_scores.launches_int8 += 1
    else:
        pairwise_scores.launches += 1
    return out


pairwise_scores.launches = 0
pairwise_scores.launches_int8 = 0


def pairwise_scores_gated(head: dict, user_first: torch.Tensor,
                          user_gates: torch.Tensor, item_first: torch.Tensor,
                          item_gates: torch.Tensor,
                          _block_rows: Optional[int] = None) -> torch.Tensor:
    """Fused exact gated pair scoring (kernel K2,
    ``csrc/gated_pairwise_mlp.cu``): user_first [B, h1], user_gates
    [B, GATE_PAD], item_first [C, Mi*h1], item_gates [C, GATE_PAD], all
    float32 -> [B, C] float32.

    CUDA tensors launch the kernel on the current stream; B and C need not
    be tile multiples; the chain's tensors and the block's pair rows as
    ``pairwise_scores``; the packed weights of either mode
    (``wgmma_weights``): the bf16 mode runs the wgmma chain and the int8
    mode the s8 wgmma chain at 128 rows and at 64 where that block fits,
    the mma.sync chain of the mode below (``chain_kind``). CPU tensors take
    ``pairwise_scores_gated_plain`` in float32. Anything else raises. ``pairwise_scores_gated.launches`` counts kernel launches of
    the bf16 mode, ``.launches_int8`` those of the int8 mode (K2q), which a
    head with ``qlayers`` launches.
    """
    _check_head(head)
    device = _device_of('pairwise_scores_gated', user_first, user_gates,
                        item_first, item_gates)
    if device is None:
        return pairwise_scores_gated_plain(head, user_first, user_gates,
                                           item_first, item_gates)
    n_mod = _n_mod(head)
    chain = _chain_on(head, device)
    h1 = int(chain['widths'][0])
    B, C = user_first.shape[0], item_first.shape[0]
    f32 = torch.float32
    _check_tensor('user_first', user_first, device, f32, -1, (h1,))
    _check_tensor('user_gates', user_gates, device, f32, B, (GATE_PAD,))
    _check_tensor('item_first', item_first, device, f32, -1,
                  ((n_mod - 1) * h1,))
    _check_tensor('item_gates', item_gates, device, f32, C, (GATE_PAD,))
    out = torch.empty((B, C), dtype=f32, device=device)
    if B == 0 or C == 0:
        return out
    tensors = (user_first, user_gates, item_first, item_gates)
    tensors += (wgmma_weights(chain),)  # either mode's
    _launch('gated_pairwise_mlp', out, tensors, chain, B, C, (n_mod,),
            forced=_block_rows)
    if chain['int8']:
        pairwise_scores_gated.launches_int8 += 1
    else:
        pairwise_scores_gated.launches += 1
    return out


pairwise_scores_gated.launches = 0
pairwise_scores_gated.launches_int8 = 0


def pairwise_scores_gated_factored(head: dict, user_first: torch.Tensor,
                                   user_coefs: torch.Tensor,
                                   tables: torch.Tensor,
                                   item_coefs: torch.Tensor,
                                   _block_rows: Optional[int] = None
                                   ) -> torch.Tensor:
    """Fused factored gated pair scoring (kernel K3,
    ``csrc/gated_factored_mlp.cu``): user_first [B, h1] and user_coefs
    [B, GATE_PAD] float32 (``factor_gated_user``), tables [C, Mi, h1]
    bfloat16 and item_coefs [C, GATE_PAD] float32
    (``factor_gated_tables``) -> [B, C] float32.

    CUDA tensors launch the kernel on the current stream; B and C need not
    be tile multiples; the chain's tensors and the block's pair rows as
    ``pairwise_scores``; the packed weights of either mode
    (``wgmma_weights``): the bf16 mode runs the wgmma chain and the int8
    mode the s8 wgmma chain at 128 rows and at 64 where that block fits,
    the mma.sync chain of the mode below (``chain_kind``). CPU tensors take
    ``pairwise_scores_gated_factored_plain`` in float32.
    Anything else raises. ``pairwise_scores_gated_factored.launches``
    counts kernel launches of the bf16 mode, ``.launches_int8`` those of
    the int8 mode (K3q), which a head with ``qlayers`` launches.
    """
    _check_head(head)
    device = _device_of('pairwise_scores_gated_factored', user_first,
                        user_coefs, tables, item_coefs)
    if device is None:
        return pairwise_scores_gated_factored_plain(
            head, user_first, user_coefs, tables, item_coefs)
    n_mod = _n_mod(head)
    chain = _chain_on(head, device)
    h1 = int(chain['widths'][0])
    B, C = user_first.shape[0], tables.shape[0]
    f32 = torch.float32
    _check_tensor('user_first', user_first, device, f32, -1, (h1,))
    _check_tensor('user_coefs', user_coefs, device, f32, B, (GATE_PAD,))
    _check_tensor('tables', tables, device, torch.bfloat16, -1,
                  (n_mod - 1, h1), align=8)
    _check_tensor('item_coefs', item_coefs, device, f32, C, (GATE_PAD,))
    out = torch.empty((B, C), dtype=f32, device=device)
    if B == 0 or C == 0:
        return out
    tensors = (user_first, user_coefs, tables, item_coefs)
    tensors += (wgmma_weights(chain),)  # either mode's
    _launch('gated_factored_mlp', out, tensors, chain, B, C, (n_mod,),
            forced=_block_rows)
    if chain['int8']:
        pairwise_scores_gated_factored.launches_int8 += 1
    else:
        pairwise_scores_gated_factored.launches += 1
    return out


pairwise_scores_gated_factored.launches = 0
pairwise_scores_gated_factored.launches_int8 = 0
