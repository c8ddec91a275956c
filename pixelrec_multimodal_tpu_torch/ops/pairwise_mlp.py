# pixelrec_multimodal_tpu_torch/ops/pairwise_mlp.py
"""Fused pairwise-MLP scoring: the full-catalog hot path.

Counterpart of ``pixelrec_multimodal_tpu/ops/pairwise_mlp.py`` for
concatenate fusion. Scoring every (user, item) pair through the prediction
MLP is made compute-bound in three steps:

  1. BatchNorm folding: eval-mode BN is affine and folds into the next
     Dense, so the MLP becomes a Dense -> act chain.
  2. First-layer factorization: the first Dense over
     ``concat(user_emb, item_block)`` splits into a per-user row
     ``user_emb @ W_user`` and a per-item row ``item_block @ W_item + b1``
     (computed once per catalog), so a pair only adds two rows.
  3. One kernel (``csrc/pairwise_mlp.cu``) scores a [users x items] block
     with every activation kept on chip.

``pairwise_scores`` is the kernel's wrapper: CUDA tensors go through the
kernel, CPU tensors through ``pairwise_scores_plain`` in float32 (the JAX
package's XLA fallback math). ``pairwise_scores_plain(compute_dtype=
torch.bfloat16)`` repeats the kernel's bf16 rounding points and is the
plain version the kernel is held against on the card.

Head tensors keep the JAX package's 128-lane zero padding, so they compare
one to one with the JAX head; the padding is exact (zero rows and columns).
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..models.multimodal import activation_fn, final_activation_fn
from . import _build

LANE = 128

# Codes the CUDA kernel takes (act_fn / final_fn in csrc/pairwise_mlp.cu).
ACTIVATIONS = {'relu': 0, 'gelu': 1, 'tanh': 2, 'leaky_relu': 3, 'silu': 4}
FINAL_ACTIVATIONS = {'sigmoid': 0, 'tanh': 1}  # anything else: none (2)
MAX_HIDDEN = 8  # hidden Dense layers after the first one the kernel takes


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
    """The factorized, BN-folded head of a concatenate-fusion model, its
    tensors on the model's device. ``b1`` folds into the per-item rows
    (``compute_item_first``), so pair scoring adds no first-layer bias.
    ``head['kernel']`` holds the tensors the CUDA kernel reads
    (``kernel_chain``), built once here."""
    if model.fusion_type != 'concatenate':
        return None  # the model refuses gated and attention fusion itself
    kernels, biases = fold_prediction_mlp(model)
    n_hidden = len(model.fusion_hidden_dims)
    d = model.embedding_dim
    device = model.device
    w1 = kernels[0]
    h1, padded_b1, layers = pack_mlp_chain(kernels, biases, n_hidden, device)
    w_item = w1[d:]
    head = {
        'fusion': model.fusion_type,
        'b1': padded_b1,
        'layers': layers,
        'activation': model.fusion_activation,
        'final_activation': model.final_activation,
        'w_user': torch.from_numpy(pad2(w1[:d], d, h1)).to(device),
        'w_item': torch.from_numpy(pad2(w_item, w_item.shape[0], h1)).to(device),
        'b1_folded': True,
    }
    head['kernel'] = kernel_chain(head)
    return head


def compute_item_first(head: dict, item_flat: torch.Tensor) -> torch.Tensor:
    """Per-item first-layer rows, once per catalog: item_flat [N, D_item]
    @ W_item + b1."""
    return item_flat.float() @ head['w_item'] + head['b1']


def compute_user_first(head: dict, user_emb: torch.Tensor) -> torch.Tensor:
    """Per-user first-layer rows: user_emb [B, d] @ W_user -> [B, h1]."""
    return user_emb.float() @ head['w_user']


def _check_folded(head: dict):
    if not head.get('b1_folded'):
        raise ValueError('pair scoring takes heads with b1 folded into the '
                         'item rows (build_factorized_head)')


def _chain_scores_f32(head: dict, x: torch.Tensor) -> torch.Tensor:
    """Float32 Dense chain on assembled first-layer activations [rows, h1]
    -> [rows] scores."""
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
    of W_last plus the unrounded f32 b_last[0]."""
    bf16 = torch.bfloat16
    act = activation_fn(head['activation'])
    for w, b in head['layers'][:-1]:
        acc = x.float() @ w.to(bf16).float()
        x = act((acc + b.to(bf16).float()).to(bf16).float()).to(bf16)
    w_last, b_last = head['layers'][-1]
    s = (x.float() * w_last[:, 0].to(bf16).float()).sum(dim=1) \
        + b_last[0].float()
    return final_activation_fn(s, head['final_activation'])


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
    _check_folded(head)
    act = activation_fn(head['activation'])
    B, C = user_first.shape[0], item_first.shape[0]
    if compute_dtype == torch.float32:
        x = act(user_first[:, None, :] + item_first[None, :, :])
        return _chain_scores_f32(head, x.reshape(B * C, -1)).reshape(B, C)
    if compute_dtype != torch.bfloat16:
        raise ValueError(f'compute_dtype must be float32 or bfloat16, got '
                         f'{compute_dtype}')
    bf16 = torch.bfloat16
    x = (user_first.to(bf16).float()[:, None, :]
         + item_first.to(bf16).float()[None, :, :]).to(bf16)
    x = act(x.float()).to(bf16)
    return _chain_scores_bf16(head, x.reshape(B * C, -1)).reshape(B, C)


def candidate_scores(head: dict, user_first: torch.Tensor,
                     item_first_rows: torch.Tensor) -> torch.Tensor:
    """Per-user candidate scoring, float32: [B, h1] x [B, C, h1] -> [B, C];
    each user pairs only with its own gathered candidate rows."""
    _check_folded(head)
    act = activation_fn(head['activation'])
    B, C = item_first_rows.shape[:2]
    x = act(user_first[:, None, :] + item_first_rows)
    return _chain_scores_f32(head, x.reshape(B * C, -1)).reshape(B, C)


# ------------------------------------------------------------ CUDA kernel
def _forward_fn():
    lib = _build.load('pairwise_mlp')
    fn = lib.pairwise_mlp_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.pairwise_mlp_error_string.argtypes = [ctypes.c_int]
        lib.pairwise_mlp_error_string.restype = ctypes.c_char_p
    return lib, fn


def kernel_chain(head: dict,
                 device: Optional[Union[str, torch.device]] = None) -> dict:
    """The head's tensors in the kernel's layout on ``device`` (default:
    the head's): hidden weights as one bf16 buffer, biases and the live last
    column rounded to bf16 (held as float32), the width list from h1 on,
    and the activation codes. Raises for a head the kernel does not take."""
    bf16 = torch.bfloat16
    h1 = head['b1'].shape[0]
    device = head['b1'].device if device is None else torch.device(device)
    hidden = head['layers'][:-1]
    w_last, b_last = head['layers'][-1]
    widths = [h1]
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


def _check_rows(name: str, t: torch.Tensor, device: torch.device, h1: int):
    if t.device != device or t.dtype != torch.float32 or t.dim() != 2 \
            or t.shape[1] != h1 or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise ValueError(f'{name} must be a contiguous, 16-byte aligned '
                         f'float32 [n, {h1}] tensor on {device}; got '
                         f'{t.dtype} {tuple(t.shape)} on {t.device}')


def pairwise_scores(head: dict, user_first: torch.Tensor,
                    item_first: torch.Tensor) -> torch.Tensor:
    """Fused [B, h1] x [C, h1] -> [B, C] float32 pair scoring.

    CUDA tensors launch the kernel on the current stream (bf16 operands,
    float32 accumulation); B and C need not be tile multiples. The kernel's
    tensors come from ``head['kernel']`` when they lie on the rows' device,
    else ``kernel_chain`` builds them for this call. CPU tensors take
    ``pairwise_scores_plain`` in float32. Anything else raises.
    ``pairwise_scores.launches`` counts kernel launches.
    """
    _check_folded(head)
    device = user_first.device
    if device.type == 'cpu' and item_first.device.type == 'cpu':
        return pairwise_scores_plain(head, user_first, item_first)
    if device.type != 'cuda':
        raise ValueError(f'pairwise_scores runs on cuda or cpu tensors, got '
                         f'{device} and {item_first.device}')
    chain = head.get('kernel')
    if chain is None or chain['w'].device != device:
        chain = kernel_chain(head, device)
    h1 = int(chain['widths'][0])
    _check_rows('user_first', user_first, device, h1)
    _check_rows('item_first', item_first, device, h1)
    B, C = user_first.shape[0], item_first.shape[0]
    out = torch.empty((B, C), dtype=torch.float32, device=device)
    if B == 0 or C == 0:
        return out
    lib, fn = _forward_fn()
    with torch.cuda.device(device):
        err = fn(user_first.data_ptr(), item_first.data_ptr(),
                 chain['w'].data_ptr(), chain['b'].data_ptr(),
                 chain['w_last'].data_ptr(), chain['b_last'].data_ptr(),
                 out.data_ptr(), B, C, chain['n_hidden'],
                 chain['widths'].ctypes.data, chain['act'], chain['final'],
                 torch.cuda.current_stream(device).cuda_stream)
    if err:
        hint = (' (widths beyond the shared-memory budget?)' if err == 1
                else '')
        raise RuntimeError(
            f'pairwise_mlp kernel failed: '
            f'{lib.pairwise_mlp_error_string(err).decode()} ({err}){hint}')
    pairwise_scores.launches += 1
    return out


pairwise_scores.launches = 0
