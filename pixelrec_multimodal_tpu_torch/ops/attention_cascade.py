# pixelrec_multimodal_tpu_torch/ops/attention_cascade.py
"""The attention cascade: cheap screens of the whole catalog, then the
exact scores of each user's top candidates.

Counterpart of ``pixelrec_multimodal_tpu/ops/attention_cascade.py``. Exact
attention scoring (``ops/attention_scorer.py``, K4 and K5) forms every
token's attention output per pair. The screens freeze part of it:

  * token 0 (``'token0'``, kernel K6, ``csrc/attention_screen_mlp.cu``,
    ``attention_screen_scores``): the user token's attention row is exact;
    the item tokens' outputs take their item-only limit (the user key's
    weight ``e_u -> 0``: ``attn_t = sum_h sexp_th / dsum_th``), so their
    LayerNormed sum is a per-item table, the tail (``compute_screen_tail``);
  * additive (``'additive'``): token 0 also takes its user-only limit
    (``attn_0 = sum_h u_vo_h``), so the fused vector is a per-user row plus
    the tail, and the first Dense splits over the sum: the screen is the
    concat kernel K1's ``MLP(uf + itf)`` on per-user rows
    (``compute_screen_additive_user``) and per-item rows
    (``compute_screen_additive_items``), with the head of
    ``screen_additive_head``.

The exact rescore (``attention_candidate_scores``) and the funnel's middle
stage, the token-0 screen on gathered candidates
(``attention_screen_candidate_scores``), are whole-tensor PyTorch in
float32, as the JAX package leaves them to XLA. Tables are d wide (the JAX
package pads them to 128 lanes): the port's per-item tables are (raw, q, k,
vo, sexp, dm), so the tail reads indices 0, 4 and 5 and K6 reads 2 and 3.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from .attention_scorer import (
    LN_EPS,
    SUU_PAD,
    _check_attention_head,
    _f32_reciprocal,
    _kernel_dims,
    _layernorm_token,
    _score_fused,
    _token0_coefs,
    _token0_input,
)
from .pairwise_mlp import (
    _chain_on,
    _check_tensor,
    _device_of,
    _launch,
    kernel_chain,
    wgmma_weights,
)


# ------------------------------------------------------------ screen tables
def compute_screen_tail(head: dict, item_side: Sequence[torch.Tensor]
                        ) -> torch.Tensor:
    """[N, d] per-item tail of the screens: ``sum_{t>0} LN(raw_t + sum_h
    sexp_th / dsum_th) * gamma / T``, the item tokens' LayerNormed outputs
    with the user's key and value dropped (``e_u -> 0``: the item-key
    softmax mass alone, whose per-pair max cancels), from the per-item
    tables (raw, q, k, vo, sexp, dm). ``beta`` is added once per pair."""
    d, H, Mi = head['d'], head['H'], head['n_item_mods']
    raw, sexp, dm = item_side[0], item_side[4], item_side[5]
    N = raw.shape[0]
    dsum = dm.reshape(N, H, Mi, 2)[..., 0].transpose(1, 2)     # [N, Mi, H]
    y = raw.reshape(N, Mi, d) + (sexp.reshape(N, Mi, H, d)
                                 / dsum[..., None]).sum(dim=2)
    yn = F.layer_norm(y, (d,), eps=LN_EPS)
    return yn.sum(dim=1) * (head['ln_scale'] / (Mi + 1))


def compute_screen_additive_user(head: dict,
                                 user_side: Sequence[torch.Tensor]
                                 ) -> torch.Tensor:
    """[B, h1] user rows of the additive screen: token 0 at its user-only
    limit (the softmax mass on the user key, ``attn_0 = sum_h u_vo_h``),
    ``LN(raw + sum_h u_vo_h) * gamma / T + beta`` through ``w1``, plus
    ``b1`` (folded into the user rows, as K1's heads fold it into one
    side)."""
    d, H, Mi = head['d'], head['H'], head['n_item_mods']
    u_raw, u_vo = user_side[0].float(), user_side[3].float()
    y0 = u_raw + u_vo.reshape(-1, H, d).sum(dim=1)
    fused = (F.layer_norm(y0, (d,), eps=LN_EPS)
             * (head['ln_scale'] / (Mi + 1)) + head['ln_bias'])
    return fused @ head['w1'] + head['b1']


def compute_screen_additive_items(head: dict,
                                  tail: torch.Tensor) -> torch.Tensor:
    """[N, h1] item rows of the additive screen: the tail through ``w1``."""
    return tail @ head['w1']


def screen_additive_head(head: dict) -> dict:
    """The K1 head of the additive screen: the attention head's chain after
    ``w1`` (``layers``, activations), ``b1`` in the user rows
    (``b1_folded``) and its own ``kernel`` (``kernel_chain`` from h1 on:
    the attention head's ``kernel`` has ``w1`` as its layer 0, which K1
    must not read)."""
    shead = {'layers': head['layers'], 'activation': head['activation'],
             'final_activation': head['final_activation'], 'h1': head['h1'],
             'b1': head['b1'], 'b1_folded': True}
    shead['kernel'] = kernel_chain(shead)
    return shead


# ------------------------------------------------------- token-0 screen, K6
def _screen_sides(head: dict, user_side, item_k, item_vo):
    """Broadcast views: user tensors [B, 1, ...], item tensors [1, C, ...]
    (catalog rows [C, ...]) or [B, C, ...] (per-user candidate rows)."""
    d, H, Mi = head['d'], head['H'], head['n_item_mods']
    u_raw, u_q, _, u_vo, u_suu = (t.float() for t in user_side[:5])
    B = u_raw.shape[0]
    u = dict(raw=u_raw[:, None], q=u_q[:, None], vo=u_vo.reshape(B, 1, H, d),
             suu=u_suu[:, None, :H])
    k, vo = item_k.float(), item_vo.float()
    if k.dim() == 2:
        k, vo = k[None], vo[None]
    lead = k.shape[:2]
    return u, dict(k=k.reshape(lead + (Mi, d)),
                   vo=vo.reshape(lead + (Mi, H, d)))


def attention_screen_scores_plain(head: dict,
                                  user_side: Sequence[torch.Tensor],
                                  item_side: Sequence[torch.Tensor],
                                  tail: torch.Tensor,
                                  compute_dtype: torch.dtype = torch.float32
                                  ) -> torch.Tensor:
    """Plain token-0 screen scoring: user_side (raw, q, k, vo, suu), the
    per-item tables item_side (raw, q, k, vo, ...; k and vo are read) and
    tail [C, d] -> [B, C] float32. Kernel K6's algebra and order of
    operations: token 0's logits, softmax and attention input as K4's
    (``_token0_coefs``, ``_token0_input``), its LayerNorm scaled by 1/T,
    ``* gamma + (beta + tail)``; then the float32 chain or, for
    ``torch.bfloat16``, K6's rounding points."""
    _check_attention_head(head)
    u, i = _screen_sides(head, user_side, item_side[2], item_side[3])
    w0, w = _token0_coefs(head, u, i)
    f = _layernorm_token(_token0_input(head, u, i, w0, w),
                         _f32_reciprocal(head['d']),
                         _f32_reciprocal(head['n_item_mods'] + 1))
    fused = f * head['ln_scale'] + (head['ln_bias'] + tail.float())
    return _score_fused(head, fused, compute_dtype)


def attention_screen_scores(head: dict, user_side: Sequence[torch.Tensor],
                            item_side: Sequence[torch.Tensor],
                            tail: torch.Tensor,
                            _block_rows: Optional[int] = None
                            ) -> torch.Tensor:
    """Fused token-0 screen scoring (kernel K6,
    ``csrc/attention_screen_mlp.cu``): user_side (raw, q, k, vo, suu), the
    per-item tables item_side (raw, q, k, vo, ...), of which the kernel
    reads k [C, Mi*d] and vo [C, Mi*H*d], and tail [C, d], all float32 ->
    [B, C] float32.

    CUDA tensors launch the kernel on the current stream (the chain of
    ``attention_scores``: wgmma at 128 and 64 pair rows, the weights packed
    by ``wgmma_weights``; mma.sync below); B and C need not be tile
    multiples. CPU tensors take ``attention_screen_scores_plain`` in
    float32. Anything else raises: other devices, widths or head counts the
    kernel does not take, a head that fits no block, launch errors. The
    block's pair rows are ``check_kernel_fits``'s (``_block_rows`` forces a
    smaller block, for tests).
    ``attention_screen_scores.launches`` counts kernel launches.
    """
    _check_attention_head(head)
    user_side = tuple(user_side[:5])
    it_k, it_vo = item_side[2], item_side[3]
    device = _device_of('attention_screen_scores', *user_side, it_k, it_vo,
                        tail)
    if device is None:
        return attention_screen_scores_plain(head, user_side, item_side, tail)
    d, H, Mi = _kernel_dims(head)
    chain = _chain_on(head, device)
    B, C = user_side[0].shape[0], it_k.shape[0]
    f32 = torch.float32
    for nm, t, width in zip(('raw', 'q', 'k', 'vo', 'suu'), user_side,
                            (d, d, d, H * d, SUU_PAD)):
        _check_tensor(f'user {nm}', t, device, f32, B, (width,))
    for nm, t, width in (('k', it_k, Mi * d), ('vo', it_vo, Mi * H * d),
                         ('tail', tail, d)):
        _check_tensor(f'item {nm}', t, device, f32, C, (width,))
    ln = tuple(head[k].to(device=device, dtype=f32).contiguous()
               for k in ('ln_scale', 'ln_bias'))
    out = torch.empty((B, C), dtype=f32, device=device)
    if B == 0 or C == 0:
        return out
    _launch('attention_screen_mlp', out,
            user_side + (it_k, it_vo, tail) + ln + (wgmma_weights(chain),),
            chain, B, C, (H, Mi), mode=(H, Mi), forced=_block_rows)
    attention_screen_scores.launches += 1
    return out


attention_screen_scores.launches = 0


# ----------------------------------------------- per-user candidate lists
def attention_screen_candidate_scores(head: dict,
                                      user_side: Sequence[torch.Tensor],
                                      cand_side: Sequence[torch.Tensor],
                                      cand_tail: torch.Tensor
                                      ) -> torch.Tensor:
    """The token-0 screen on per-user candidate lists, the funnel's middle
    stage, float32: user_side (raw, q, k, vo, suu) [B, ...], cand_side
    (it_k [B, C, Mi*d], it_vo [B, C, Mi*H*d]) and cand_tail [B, C, d], each
    user's own gathered rows -> [B, C]. Whole-tensor PyTorch (one softmax
    over the self logit and the Mi item-key logits, batched products for the
    logits and the value sum, one LayerNorm), the JAX package's
    ``xla_attention_screen_candidate_scores``; no kernel's plain version."""
    _check_attention_head(head)
    d, H, dh, Mi = head['d'], head['H'], head['dh'], head['n_item_mods']
    u_raw, u_q, _, u_vo, u_suu = (t.float() for t in user_side[:5])
    it_k, it_vo = (t.float() for t in cand_side[:2])
    B, C = it_k.shape[:2]
    ik = it_k.reshape(B, C, Mi, H, dh)
    s_items = torch.einsum('bhe,bcmhe->bchm', u_q.reshape(B, H, dh), ik)
    s = torch.cat([u_suu[:, None, :H, None].expand(B, C, H, 1), s_items],
                  dim=-1)
    w = torch.softmax(s, dim=-1)                           # [B, C, H, 1+Mi]
    attn = (torch.einsum('bch,bhe->bce', w[..., 0], u_vo.reshape(B, H, d))
            + torch.einsum('bchm,bcmhe->bce', w[..., 1:],
                           it_vo.reshape(B, C, Mi, H, d)))
    y0 = u_raw[:, None] + attn
    fused = (F.layer_norm(y0, (d,), eps=LN_EPS)
             * (head['ln_scale'] / (Mi + 1)) + head['ln_bias']
             + cand_tail.float())
    return _score_fused(head, fused, torch.float32)


def attention_candidate_scores(head: dict, user_side: Sequence[torch.Tensor],
                               cand_side: Sequence[torch.Tensor]
                               ) -> torch.Tensor:
    """Exact attention scores of per-user candidate lists, float32 (the
    cascade's rescore): user_side (raw, q, k, vo, suu) [B, ...] and the
    per-item tables gathered per user, cand_side (raw, q, k, vo, ...)
    [B, C, ...], of which raw, q, k and vo are read -> [B, C]. Each user
    pairs only with its own rows.

    Whole-tensor PyTorch, JAX's full T x T softmax
    (``xla_attention_candidate_scores``): the item-item logits come from the
    gathered q and k (the port keeps no ``sii`` table), the user's self
    logit from ``suu``; one softmax over the keys, batched products for the
    logits and the value sums, LayerNorm per token, the token mean and the
    affine, then the float32 chain. It reads no sexp or dm: fewer gathered
    bytes per pair (8,960 B at the flagship) than the stream identities
    would (14,240 B). No kernel's plain version."""
    _check_attention_head(head)
    d, H, dh, Mi = head['d'], head['H'], head['dh'], head['n_item_mods']
    u_raw, u_q, u_k, u_vo, u_suu = (t.float() for t in user_side[:5])
    it_raw, it_q, it_k, it_vo = (t.float() for t in cand_side[:4])
    B, C = it_raw.shape[:2]
    T = Mi + 1
    q = torch.cat([u_q.reshape(B, 1, 1, H, dh).expand(B, C, 1, H, dh),
                   it_q.reshape(B, C, Mi, H, dh)], dim=2)   # [B, C, T, H, dh]
    k = torch.cat([u_k.reshape(B, 1, 1, H, dh).expand(B, C, 1, H, dh),
                   it_k.reshape(B, C, Mi, H, dh)], dim=2)
    s = torch.einsum('bcqhe,bckhe->bchqk', q, k)            # [B, C, H, T, T]
    s[:, :, :, 0, 0] = u_suu[:, None, :H]
    w = torch.softmax(s, dim=-1)
    attn = (torch.einsum('bchq,bhe->bcqe', w[..., 0], u_vo.reshape(B, H, d))
            + torch.einsum('bchqm,bcmhe->bcqe', w[..., 1:],
                           it_vo.reshape(B, C, Mi, H, d)))   # [B, C, T, d]
    attn[:, :, 0] += u_raw[:, None]
    attn[:, :, 1:] += it_raw.reshape(B, C, Mi, d)
    fused = (F.layer_norm(attn, (d,), eps=LN_EPS).sum(dim=2)
             * (head['ln_scale'] / T) + head['ln_bias'])
    return _score_fused(head, fused, torch.float32)
