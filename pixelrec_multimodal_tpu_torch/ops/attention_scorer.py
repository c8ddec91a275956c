# pixelrec_multimodal_tpu_torch/ops/attention_scorer.py
"""Fused full-catalog scoring for attention fusion.

Counterpart of ``pixelrec_multimodal_tpu/ops/attention_scorer.py``.
Attention fusion runs multi-head self-attention over the (user, item
modality) token stack, the residual and LayerNorm per token, the mean over
tokens, then the prediction MLP. The first Dense does not factorize, but
almost everything that feeds the attention is per user or per item:

  * the item tokens' queries, keys and values are per item, computed once
    per catalog; the out-projection folds into the values per head
    (``vo = v_h @ W_out_h``), and its bias into the residual (``raw``);
  * for an item-query token only the user key's logit depends on the pair,
    so the item keys' softmax mass is a per-item table (``sexp``, the
    exp-weighted ``vo`` sum, and ``dm``, its sum and max);
  * the user token's self logit and its rows are per user.

A pair then needs the user token's softmax over 1 + Mi logits, one clamped
exp per item token and head, the weighted sums of the per-side vectors,
LayerNorm per token and the MLP. Two kernels compute it:

  * K4, ``csrc/attention_mlp.cu`` (``attention_scores``, variant
    ``'stream'``): every token's pre-LayerNorm vector is formed and
    normalized in turn;
  * K5, ``csrc/attention_gram_mlp.cu`` (``attention_scores_gram``, variant
    ``'gram'``): each token's LayerNorm mean and variance come from
    precomputed component means and Grams plus per-pair user x item
    cross-Grams, and one pass combines the component vectors.

Both, and the cascade's token-0 screen K6 (``ops/attention_cascade.py``),
then run the Dense chain with the first Dense ``w1`` as its layer 0:
the wgmma chain of ``csrc/mlp_chain_wgmma.cuh`` (weights packed by
``wgmma_weights``) in blocks of 128 and 64 pair rows, the mma.sync chain of
``csrc/mlp_chain.cuh`` in blocks of 32 and 16. CUDA tensors go through a
kernel, CPU tensors through its plain version in float32. The plain
versions repeat their kernel's order of float32 operations (``_seq_dot``
and ``_warp_sum`` are the kernels' sums), so with
``compute_dtype=torch.bfloat16`` they round where the kernels do and are
what the kernels are held against on the card.

Tables are d wide (the JAX package pads them to 128 lanes): per item
``raw``, ``q`` and ``k`` [Mi*d], ``vo`` and ``sexp`` [Mi*H*d] (index
``(t*H + h)*d``) and ``dm`` [H*Mi*2] (index ``(h*Mi + t)*2``: sum, max);
per user ``raw``, ``q``, ``k`` [d], ``vo`` [H*d] and ``suu`` [8] (the self
logit per head). The gram variant adds per-item and per-user scalar tables
(``gram_layout``, ``user_sc_layout``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .pairwise_mlp import (
    _chain_on,
    _chain_scores_bf16,
    _chain_scores_f32,
    _check_compute_dtype,
    _check_tensor,
    _device_of,
    _kernel_of,
    _launch,
    block_rows,
    chain_widths,
    fold_prediction_mlp,
    kernel_chain,
    pack_mlp_chain,
    pad2,
    wgmma_weights,
)

LN_EPS = 1e-6      # Flax nn.LayerNorm's default
EXP_CLAMP = 80.0   # item-token exponent clamp of the stream form
SUU_PAD = 8        # columns of the per-user self-logit table
MAX_HEADS = SUU_PAD
MAX_ITEM_MODS = 7
MAX_D = 512        # the kernels hold at most 16 values per lane of a warp


# ------------------------------------------------------------ table layouts
def gram_layout(H: int, Mi: int):
    """Column offsets of the per-item scalar table of the gram variant and
    its width. Means are over the d entries, Grams full inner products."""
    n_vo = Mi * H
    cols, off = {}, 0
    for name, n in (('m_vo', n_vo),          # mean(vo[m, h]), m*H + h
                    ('m_sexp', n_vo),        # mean(sexp[t, h]), t*H + h
                    ('m_raw', Mi),           # mean(raw_t)
                    ('g_vovo', n_vo * n_vo),  # <vo_a, vo_b>, a*n_vo + b
                    ('g_rr', Mi),            # <raw_t, raw_t>
                    ('g_rsexp', n_vo),       # <raw_t, sexp[t, h]>, t*H + h
                    ('g_ss', Mi * H * H),    # <sexp[t,h], sexp[t,h']>
                    ('e_ii', Mi * Mi * H)):  # item-key exps, (t*Mi+m)*H+h
        cols[name] = off
        off += n
    return cols, off


def user_sc_layout(H: int):
    """Column offsets of the per-user scalar table of the gram variant and
    its width."""
    cols, off = {}, 0
    for name, n in (('m_uraw', 1), ('m_uvo', H), ('g_rr', 1), ('g_rvo', H),
                    ('g_vv', H * H)):         # <u_vo_h, u_vo_h'>, h*H + h'
        cols[name] = off
        off += n
    return cols, off


# -------------------------------------------------------------------- head
def build_attention_head(model) -> Optional[dict]:
    """The BN-folded head of an attention-fusion model, its tensors on the
    model's device; None for another fusion. The first Dense stays
    unfolded (``w1 [d, h1]``, ``b1``): LayerNorm sits between it and the
    attention. ``head['kernel']`` holds the tensors the kernels read, with
    ``w1`` as the chain's layer 0 (``kernel_chain``)."""
    if model.fusion_type != 'attention':
        return None
    kernels, biases = fold_prediction_mlp(model)
    device = model.device
    h1, padded_b1, layers = pack_mlp_chain(
        kernels, biases, len(model.fusion_hidden_dims), device)
    d = model.embedding_dim
    fl = model.fusion_layer
    attn = fl.attention

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def vector(p):
        return p.detach().to(device=device, dtype=torch.float32).clone()

    head = {
        'fusion': 'attention', 'd': d, 'H': attn.num_heads,
        'dh': attn.head_dim, 'n_item_mods': model.num_modalities - 1,
        'h1': h1, 'b1': padded_b1, 'layers': layers,
        'activation': model.fusion_activation,
        'final_activation': model.final_activation,
        'w1': tensor(pad2(kernels[0], d, h1)),
        'ln_scale': vector(fl.norm.weight), 'ln_bias': vector(fl.norm.bias),
        'w_out': tensor(_kernel_of(attn.out)), 'b_out': vector(attn.out.bias),
    }
    for name in ('query', 'key', 'value'):
        layer = getattr(attn, name)
        head[f'w_{name}'] = tensor(_kernel_of(layer))          # [d, H*dh]
        head[f'b_{name}'] = vector(layer.bias)
    head['kernel'] = kernel_chain(head)
    return head


def _qkvo(head: dict, tokens: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens [..., d] -> (q scaled by 1/sqrt(dh), k, vo [..., H, d]): the
    out-projection folded into the values per head."""
    H, dh, d = head['H'], head['dh'], head['d']
    f = tokens.float()
    q = (f @ head['w_query'] + head['b_query']) / math.sqrt(dh)
    k = f @ head['w_key'] + head['b_key']
    v = (f @ head['w_value'] + head['b_value']).reshape(
        f.shape[:-1] + (H, dh))
    vo = torch.einsum('...hd,hde->...he', v, head['w_out'].reshape(H, dh, d))
    return q, k, vo


def compute_item_side_attention(head: dict, item_feats: torch.Tensor,
                                with_gram: bool = False
                                ) -> Tuple[torch.Tensor, ...]:
    """Per-item tables, once per catalog: item_feats [N, Mi, d] ->
    (raw, q, k [N, Mi*d]; vo, sexp [N, Mi*H*d]; dm [N, H*Mi*2]), plus the
    gram variant's scalar table [N, gram_layout(H, Mi)[1]] when
    ``with_gram``. ``raw`` carries the out-projection bias; ``sexp[t, h]``
    is ``sum_m e_m * vo[m, h]`` and ``dm[h, t]`` is ``(sum_m e_m, mx)``
    with ``e_m = exp(s_tm - mx)`` over the item keys m of item query t."""
    N, Mi, d = item_feats.shape
    H, dh = head['H'], head['dh']
    q, k, vo = _qkvo(head, item_feats)            # [N, Mi, d], vo [N, Mi, H, d]
    sii = torch.einsum('nthd,nkhd->nhtk', q.reshape(N, Mi, H, dh),
                       k.reshape(N, Mi, H, dh))   # [N, H, Mi(q), Mi(k)]
    mx = sii.amax(dim=-1)
    e = torch.exp(sii - mx[..., None])
    dsum = e.sum(dim=-1)
    sexp = torch.einsum('nhqk,nkhd->nqhd', e, vo)  # [N, Mi(q), H, d]
    raw = item_feats.float() + head['b_out']
    tables = (raw.reshape(N, Mi * d), q.reshape(N, Mi * d),
              k.reshape(N, Mi * d), vo.reshape(N, Mi * H * d),
              sexp.reshape(N, Mi * H * d),
              torch.stack([dsum, mx], dim=-1).reshape(N, H * Mi * 2))
    if not with_gram:
        return tables
    vo_f = vo.reshape(N, Mi * H, d)
    sexp_f = sexp.reshape(N, Mi * H, d)
    it_sc = torch.cat([
        vo_f.sum(-1) / d,
        sexp_f.sum(-1) / d,
        raw.sum(-1) / d,
        torch.einsum('nad,nbd->nab', vo_f, vo_f).reshape(N, -1),
        (raw * raw).sum(-1),
        torch.einsum('ntd,nthd->nth', raw, sexp).reshape(N, -1),
        torch.einsum('nthd,ntgd->nthg', sexp, sexp).reshape(N, -1),
        e.permute(0, 2, 3, 1).reshape(N, -1),
    ], dim=-1)
    return tables + (it_sc,)


def compute_user_side_attention(head: dict, user_emb: torch.Tensor,
                                with_gram: bool = False
                                ) -> Tuple[torch.Tensor, ...]:
    """Per-user rows: user_emb [B, d] -> (raw, q, k [B, d]; vo [B, H*d];
    suu [B, SUU_PAD], the self logit per head, zero-padded), plus the gram
    variant's scalar table [B, user_sc_layout(H)[1]] when ``with_gram``."""
    H, dh, d = head['H'], head['dh'], head['d']
    B = user_emb.shape[0]
    q, k, vo = _qkvo(head, user_emb)
    suu = torch.zeros((B, SUU_PAD), dtype=torch.float32,
                      device=user_emb.device)
    suu[:, :H] = (q.reshape(B, H, dh) * k.reshape(B, H, dh)).sum(-1)
    raw = user_emb.float() + head['b_out']
    side = (raw, q, k, vo.reshape(B, H * d), suu)
    if not with_gram:
        return side
    u_sc = torch.cat([
        raw.sum(-1, keepdim=True) / d,
        vo.sum(-1) / d,
        (raw * raw).sum(-1, keepdim=True),
        torch.einsum('bd,bhd->bh', raw, vo),
        torch.einsum('bhd,bgd->bhg', vo, vo).reshape(B, H * H),
    ], dim=-1)
    return side + (u_sc,)


# ----------------------------------------------------------- plain versions
def _seq_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis as one kernel thread takes it: left
    to right, each product rounded before it is added."""
    s = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        s = s + a[..., i] * b[..., i]
    return s


def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (d) as a kernel warp takes it: entries 2s and
    2s+1 live on lane s % 32, each lane adds its entries in order, then a
    butterfly over the 32 lanes (xor 16, 8, 4, 2, 1)."""
    d = x.shape[-1]
    J = -(-d // 64)
    if J * 64 != d:
        x = torch.nn.functional.pad(x, (0, J * 64 - d))
    x = x.reshape(x.shape[:-1] + (J, 32, 2))
    p = x[..., 0, :, 0] + x[..., 0, :, 1]
    for j in range(1, J):
        p = p + x[..., j, :, 0]
        p = p + x[..., j, :, 1]
    for w in (16, 8, 4, 2, 1):
        p = p[..., :w] + p[..., w:2 * w]
    return p[..., 0]


def _f32_reciprocal(n: int) -> float:
    """1/n rounded once to float32, as the kernels compute it."""
    return float(np.float32(1) / np.float32(n))


def _check_attention_head(head: dict):
    if head.get('fusion') != 'attention' or 'w1' not in head:
        raise ValueError('attention scoring takes heads from '
                         'build_attention_head')


def _sides(head: dict, user_side: Sequence[torch.Tensor],
           item_side: Sequence[torch.Tensor]):
    """Views of the tables for broadcasting: user tensors [B, 1, ...],
    item tensors [1, C, ...] (catalog rows [C, ...]) or [B, C, ...]
    (per-user candidate rows)."""
    d, H, Mi = head['d'], head['H'], head['n_item_mods']
    u_raw, u_q, u_k, u_vo, u_suu = (t.float() for t in user_side[:5])
    B = u_raw.shape[0]
    u = dict(raw=u_raw[:, None], q=u_q[:, None], k=u_k[:, None],
             vo=u_vo.reshape(B, 1, H, d), suu=u_suu[:, None, :H])
    it = [t.float() for t in item_side]
    it = [t[None] if t.dim() == 2 else t for t in it]
    lead = it[0].shape[:2]
    i = dict(raw=it[0].reshape(lead + (Mi, d)),
             q=it[1].reshape(lead + (Mi, d)),
             k=it[2].reshape(lead + (Mi, d)),
             vo=it[3].reshape(lead + (Mi, H, d)),
             sexp=it[4].reshape(lead + (Mi, H, d)),
             dm=it[5].reshape(lead + (H, Mi, 2)))
    return u, i, it[6:]


def _token0_coefs(head: dict, u: dict, i: dict):
    """Token 0's softmax weights per pair and head, [B, C, ...] float32
    planes: the softmax over the self logit and the Mi user query x item
    key logits (``_seq_dot`` over each head's dh entries), (w0 [B, C, H],
    w [B, C, Mi, H])."""
    H, dh = head['H'], head['dh']
    lead_u = u['q'].shape[:2]
    uq = u['q'].reshape(lead_u + (1, H, dh))
    lead_i = i['k'].shape[:3]
    l_key = _seq_dot(uq, i['k'].reshape(lead_i + (H, dh)))   # [B, C, Mi, H]
    lu = u['suu']                                            # [B, 1, H]
    mx = lu
    for m in range(l_key.shape[2]):
        mx = torch.maximum(mx, l_key[:, :, m])
    e0 = torch.exp(lu - mx)
    tot = e0
    es = []
    for m in range(l_key.shape[2]):
        es.append(torch.exp(l_key[:, :, m] - mx))
        tot = tot + es[-1]
    inv = 1.0 / tot
    return e0 * inv, torch.stack([e * inv for e in es], dim=2)


def _softmax_coefs(head: dict, u: dict, i: dict):
    """The kernels' per-pair coefficients, [B, C, ...] float32 planes:

      token 0, per head: ``_token0_coefs``, (w0 [B, C, H], w [B, C, Mi, H]);
      item token t, per head: ``e_u = exp(min(s_tu - mx, 80))`` of the item
      query x user key logit, ``a = e_u / (e_u + dsum)`` on the user's vo
      and ``b = 1 / (e_u + dsum)`` on sexp, (a, b [B, C, Mi, H]).

    Logits are ``_seq_dot`` over each head's dh entries."""
    H, dh = head['H'], head['dh']
    w0, w = _token0_coefs(head, u, i)
    uk = u['k'].reshape(u['k'].shape[:2] + (1, H, dh))
    lead_i = i['q'].shape[:3]
    s_iu = _seq_dot(uk, i['q'].reshape(lead_i + (H, dh)))    # [B, C, Mi, H]
    dsum = i['dm'][..., 0].transpose(-1, -2)                 # [1|B, C, Mi, H]
    imx = i['dm'][..., 1].transpose(-1, -2)
    e_u = torch.exp(torch.clamp(s_iu - imx, max=EXP_CLAMP))
    r = 1.0 / (e_u + dsum)
    return w0, w, e_u * r, r


def _layernorm_token(y: torch.Tensor, inv_d: float,
                     inv_t: float) -> torch.Tensor:
    """One token's share of the fused vector, stream form: LayerNorm
    without its affine, scaled by 1/T (the affine is applied once after the
    token sum). Mean and centred variance are ``_warp_sum``s."""
    mu = _warp_sum(y) * inv_d
    yc = y - mu[..., None]
    var = _warp_sum(yc * yc) * inv_d
    return (yc * (1.0 / torch.sqrt(var + LN_EPS))[..., None]) * inv_t


def _token0_input(head: dict, u: dict, i: dict, w0: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Token 0's pre-LayerNorm vector [B, C, d] as kernels K4 and K6 form
    it: the attention output as a running sum over heads (the user term,
    then the Mi item terms), then the residual."""
    H, Mi, d = head['H'], head['n_item_mods'], head['d']
    attn = torch.zeros(w0.shape[:2] + (d,), dtype=torch.float32,
                       device=w0.device)
    for h in range(H):
        attn = attn + w0[..., h, None] * u['vo'][:, :, h]
        for m in range(Mi):
            attn = attn + w[:, :, m, h, None] * i['vo'][:, :, m, h]
    return u['raw'] + attn


def _stream_fused(head: dict, user_side, item_side) -> torch.Tensor:
    """Kernel K4's fused vector [B, C, d] in float32, operation for
    operation: per token the attention output as a running sum over heads
    (token 0: ``_token0_input``; item tokens: ``a*u_vo``, then
    ``b*sexp``), the residual, LayerNorm (``_layernorm_token``) and the
    token sum; then the LayerNorm affine."""
    H, Mi, d = head['H'], head['n_item_mods'], head['d']
    u, i, _ = _sides(head, user_side, item_side)
    w0, w, a, b = _softmax_coefs(head, u, i)
    inv_d, inv_t = _f32_reciprocal(d), _f32_reciprocal(Mi + 1)
    y0 = _token0_input(head, u, i, w0, w)
    fused = torch.zeros_like(y0) + _layernorm_token(y0, inv_d, inv_t)
    for t in range(Mi):
        attn = torch.zeros_like(fused)
        for h in range(H):
            attn = attn + a[:, :, t, h, None] * u['vo'][:, :, h]
            attn = attn + b[:, :, t, h, None] * i['sexp'][:, :, t, h]
        fused = fused + _layernorm_token(i['raw'][:, :, t] + attn, inv_d,
                                         inv_t)
    return fused * head['ln_scale'] + head['ln_bias']


def _gram_fused(head: dict, user_side, item_side) -> torch.Tensor:
    """Kernel K5's fused vector [B, C, d] in float32, operation for
    operation. Each token's pre-LayerNorm vector is a combination of
    per-side components with per-pair coefficients,

        y_0 = u_raw + sum_h w0_h u_vo_h + sum_mh w_mh vo_mh
        y_t = raw_t + sum_h (a_th u_vo_h + b_th sexp_th),

    so its mean is a combination of component means and its mean square a
    quadratic form over component Grams: the user x user and item x item
    ones come from the scalar tables, the user x item cross-Grams are
    ``_seq_dot``s over d per pair. The variance is E[y^2] - mu^2, clamped
    at 0. One pass then combines the component vectors with the
    1/sigma-scaled coefficients, ``sexp`` expanded over the ``vo`` basis
    through the item-key exps ``e_ii``; the LayerNorm scale carries the
    1/T of the token mean (a product with 1/T rounded to float32: torch
    divides a CUDA tensor by a scalar that way, so the kernel does too)."""
    H, Mi, d = head['H'], head['n_item_mods'], head['d']
    n_vo = Mi * H
    u, i, (it_sc,) = _sides(head, user_side, item_side)
    u_sc = user_side[5].float()[:, None]                     # [B, 1, n_usc]
    w0, w, a, b = _softmax_coefs(head, u, i)
    GR, UC = gram_layout(H, Mi)[0], user_sc_layout(H)[0]
    inv_d = _f32_reciprocal(d)
    lead = i['vo'].shape[:2]
    vo = i['vo'].reshape(lead + (n_vo, d))
    sexp = i['sexp'].reshape(lead + (n_vo, d))
    x_raw = _seq_dot(u['raw'][:, :, None], vo)                # [B, C, n_vo]
    x_vo = _seq_dot(u['vo'][:, :, :, None], vo[:, :, None])  # [B, C, H, n_vo]
    x_sx = _seq_dot(u['vo'][:, :, :, None], sexp[:, :, None])
    x_rw = _seq_dot(u['vo'][:, :, :, None], i['raw'][:, :, None])  # [.., H, Mi]

    def us(col):
        return u_sc[..., col]

    def isc(col):
        return it_sc[..., col]

    beta = [w[:, :, m, h] for m in range(Mi) for h in range(H)]
    mu0 = us(UC['m_uraw'])
    for h in range(H):
        mu0 = mu0 + w0[..., h] * us(UC['m_uvo'] + h)
    for j in range(n_vo):
        mu0 = mu0 + beta[j] * isc(GR['m_vo'] + j)
    s0 = us(UC['g_rr'])
    for h in range(H):
        s0 = s0 + (2.0 * w0[..., h]) * us(UC['g_rvo'] + h)
    for h in range(H):
        for h2 in range(H):
            s0 = s0 + (w0[..., h] * w0[..., h2]) * us(UC['g_vv'] + h * H + h2)
    q = beta[0] * x_raw[..., 0]
    for j in range(1, n_vo):
        q = q + beta[j] * x_raw[..., j]
    s0 = s0 + 2.0 * q
    for h in range(H):
        q = beta[0] * x_vo[..., h, 0]
        for j in range(1, n_vo):
            q = q + beta[j] * x_vo[..., h, j]
        s0 = s0 + (2.0 * w0[..., h]) * q
    q = None
    for j in range(n_vo):
        inner = beta[0] * isc(GR['g_vovo'] + j * n_vo)
        for j2 in range(1, n_vo):
            inner = inner + beta[j2] * isc(GR['g_vovo'] + j * n_vo + j2)
        q = beta[j] * inner if q is None else q + beta[j] * inner
    s0 = s0 + q
    isig0 = 1.0 / torch.sqrt(torch.clamp(s0 * inv_d - mu0 * mu0, min=0.0)
                             + LN_EPS)
    isig, mus = [], []
    for t in range(Mi):
        at = [a[:, :, t, h] for h in range(H)]
        bt = [b[:, :, t, h] for h in range(H)]
        mu = isc(GR['m_raw'] + t)
        for h in range(H):
            mu = mu + at[h] * us(UC['m_uvo'] + h)
        for h in range(H):
            mu = mu + bt[h] * isc(GR['m_sexp'] + t * H + h)
        s = isc(GR['g_rr'] + t)
        for h in range(H):
            for h2 in range(H):
                s = s + (at[h] * at[h2]) * us(UC['g_vv'] + h * H + h2)
        q = at[0] * x_rw[..., 0, t]
        for h in range(1, H):
            q = q + at[h] * x_rw[..., h, t]
        s = s + 2.0 * q
        q = bt[0] * isc(GR['g_rsexp'] + t * H)
        for h in range(1, H):
            q = q + bt[h] * isc(GR['g_rsexp'] + t * H + h)
        s = s + 2.0 * q
        q = None
        for h in range(H):
            for h2 in range(H):
                p = (at[h] * bt[h2]) * x_sx[..., h, t * H + h2]
                q = p if q is None else q + p
        s = s + 2.0 * q
        q = None
        for h in range(H):
            for h2 in range(H):
                p = (bt[h] * bt[h2]) * isc(GR['g_ss'] + (t * H + h) * H + h2)
                q = p if q is None else q + p
        s = s + q
        isig.append(1.0 / torch.sqrt(
            torch.clamp(s * inv_d - mu * mu, min=0.0) + LN_EPS))
        mus.append(mu)
    acc = isig0[..., None] * u['raw']
    for h in range(H):
        wt = w0[..., h] * isig0
        for t in range(Mi):
            wt = wt + a[:, :, t, h] * isig[t]
        acc = acc + wt[..., None] * u['vo'][:, :, h]
    for m in range(Mi):
        for h in range(H):
            wt = w[:, :, m, h] * isig0
            for t in range(Mi):
                wt = wt + (b[:, :, t, h] * isig[t]) * isc(
                    GR['e_ii'] + (t * Mi + m) * H + h)
            acc = acc + wt[..., None] * i['vo'][:, :, m, h]
    for t in range(Mi):
        acc = acc + isig[t][..., None] * i['raw'][:, :, t]
    ones = mu0 * isig0
    for t in range(Mi):
        ones = ones + mus[t] * isig[t]
    acc = acc - ones[..., None]
    return acc * (head['ln_scale'] * _f32_reciprocal(Mi + 1)) \
        + head['ln_bias']


def _score_fused(head: dict, fused: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Scores [B, C] from fused vectors [B, C, d]: the float32 chain with
    ``w1`` as its first layer, or, for bfloat16, one bf16 rounding and the
    kernels' bf16 chain (``_chain_scores_bf16``)."""
    _check_compute_dtype(compute_dtype)
    chain = {'activation': head['activation'],
             'final_activation': head['final_activation'],
             'layers': [(head['w1'], head['b1'])] + list(head['layers'])}
    lead = fused.shape[:-1]
    x = fused.reshape(-1, fused.shape[-1])
    if compute_dtype == torch.float32:
        return _chain_scores_f32(chain, x).reshape(lead)
    return _chain_scores_bf16(chain, x.to(torch.bfloat16)).reshape(lead)


def attention_scores_plain(head: dict, user_side: Sequence[torch.Tensor],
                           item_side: Sequence[torch.Tensor],
                           compute_dtype: torch.dtype = torch.float32
                           ) -> torch.Tensor:
    """Plain stream-form scoring: user_side (raw, q, k, vo, suu) [B, ...]
    and item_side (raw, q, k, vo, sexp, dm) [C, ...] -> [B, C] float32.
    Kernel K4's algebra and order of operations, then the float32 chain or,
    for ``torch.bfloat16``, K4's rounding points."""
    _check_attention_head(head)
    return _score_fused(head, _stream_fused(head, user_side, item_side[:6]),
                        compute_dtype)


def attention_scores_gram_plain(head: dict, user_side: Sequence[torch.Tensor],
                                item_side: Sequence[torch.Tensor],
                                compute_dtype: torch.dtype = torch.float32
                                ) -> torch.Tensor:
    """Plain gram-form scoring: user_side (raw, q, k, vo, suu, u_sc) and
    item_side (raw, q, k, vo, sexp, dm, it_sc) -> [B, C] float32. Kernel
    K5's algebra and order of operations, then the float32 chain or K5's
    bf16 rounding points."""
    _check_attention_head(head)
    return _score_fused(head, _gram_fused(head, user_side, item_side),
                        compute_dtype)


# ------------------------------------------------------------ CUDA kernels
def _kernel_dims(head: dict) -> Tuple[int, int, int]:
    """(d, H, Mi), raising for a head the kernels do not take."""
    d, H, Mi = head['d'], head['H'], head['n_item_mods']
    if d % 16 or not 16 <= d <= MAX_D:
        raise ValueError(f'the attention kernels take an embedding width '
                         f'that is a multiple of 16 in [16, {MAX_D}], got '
                         f'{d}')
    if not 1 <= H <= MAX_HEADS or d % H:
        raise ValueError(f'the attention kernels take 1 to {MAX_HEADS} heads '
                         f'that divide d={d}, got {H}')
    if not 1 <= Mi <= MAX_ITEM_MODS:
        raise ValueError(f'the attention kernels take 1 to {MAX_ITEM_MODS} '
                         f'item-side modalities, got {Mi}')
    return d, H, Mi


def check_kernel_fits(head: dict, gram: bool, screen: bool = False) -> int:
    """The block rows K5 (``gram``), K6 (``screen``, the cascade's token-0
    screen, ``ops/attention_cascade.py``) or K4 takes ``head`` at:
    ``block_rows`` on the kernel's own count of its shared memory (the
    chain's two activation buffers and its weight ring, which the
    assembly's scratch grows where it passes buffer B). ValueError for a
    head the kernel does not take (its widths, heads and item tokens) or
    that fits no block, naming the stream variant where K4 serves the
    head."""
    d, H, Mi = _kernel_dims(head)
    widths = chain_widths(head)
    try:
        return block_rows(_kernel_name(gram, screen), widths, (H, Mi))
    except ValueError as err:
        if not gram:
            raise
        try:
            block_rows(_kernel_name(False, False), widths, (H, Mi))
        except ValueError:
            raise err from None
        raise ValueError(f"{err}; use attention_variant='stream'") from None


def _kernel_name(gram: bool, screen: bool) -> str:
    return ('attention_gram_mlp' if gram else
            'attention_screen_mlp' if screen else 'attention_mlp')


def _launch_attention(name: str, head: dict, user_side, item_side,
                      forced: Optional[int]) -> torch.Tensor:
    d, H, Mi = _kernel_dims(head)
    device = user_side[0].device
    chain = _chain_on(head, device)
    B, C = user_side[0].shape[0], item_side[0].shape[0]
    f32 = torch.float32
    user_tails = [(d,), (d,), (d,), (H * d,), (SUU_PAD,)]
    item_tails = [(Mi * d,), (Mi * d,), (Mi * d,), (Mi * H * d,),
                  (Mi * H * d,), (H * Mi * 2,)]
    if len(user_side) > 5:
        user_tails.append((user_sc_layout(H)[1],))
        item_tails.append((gram_layout(H, Mi)[1],))
    names = ('raw', 'q', 'k', 'vo', 'suu', 'sc')
    for nm, t, tail in zip(names, user_side, user_tails):
        _check_tensor(f'user {nm}', t, device, f32, B, tail)
    for nm, t, tail in zip(('raw', 'q', 'k', 'vo', 'sexp', 'dm', 'sc'),
                           item_side, item_tails):
        _check_tensor(f'item {nm}', t, device, f32, C, tail)
    ln = tuple(head[k].to(device=device, dtype=f32).contiguous()
               for k in ('ln_scale', 'ln_bias'))
    out = torch.empty((B, C), dtype=f32, device=device)
    if B == 0 or C == 0:
        return out
    tensors = tuple(user_side) + tuple(item_side) + ln + (
        wgmma_weights(chain),)
    _launch(name, out, tensors, chain, B, C, (H, Mi), mode=(H, Mi),
            forced=forced)
    return out


def attention_scores(head: dict, user_side: Sequence[torch.Tensor],
                     item_side: Sequence[torch.Tensor],
                     _block_rows: Optional[int] = None) -> torch.Tensor:
    """Fused stream-form attention scoring (kernel K4,
    ``csrc/attention_mlp.cu``): user_side (raw, q, k, vo, suu) and
    item_side (raw, q, k, vo, sexp, dm), all float32 -> [B, C] float32.

    CUDA tensors launch the kernel on the current stream; B and C need not
    be tile multiples. The block's pair rows are ``check_kernel_fits``'s
    (``_block_rows`` forces a smaller block, for tests). CPU tensors take
    ``attention_scores_plain`` in float32. Anything else raises: other
    devices, widths or head counts the kernel does not take, a head that
    fits no block, launch errors.
    ``attention_scores.launches`` counts kernel launches.
    """
    _check_attention_head(head)
    user_side, item_side = tuple(user_side[:5]), tuple(item_side[:6])
    if _device_of('attention_scores', *user_side, *item_side) is None:
        return attention_scores_plain(head, user_side, item_side)
    out = _launch_attention('attention_mlp', head, user_side, item_side,
                            _block_rows)
    if out.numel():
        attention_scores.launches += 1
    return out


attention_scores.launches = 0


def attention_scores_gram(head: dict, user_side: Sequence[torch.Tensor],
                          item_side: Sequence[torch.Tensor],
                          _block_rows: Optional[int] = None) -> torch.Tensor:
    """Fused gram-form attention scoring (kernel K5,
    ``csrc/attention_gram_mlp.cu``): user_side (raw, q, k, vo, suu, u_sc)
    and item_side (raw, q, k, vo, sexp, dm, it_sc), all float32 -> [B, C]
    float32. As ``attention_scores`` otherwise; CPU tensors take
    ``attention_scores_gram_plain`` in float32. The kernel keeps each
    pair's cross-Grams, (1 + H)*Mi*H + H*(Mi*H + Mi) floats, in shared
    memory, so many heads or a wide embedding take a block of fewer pair
    rows than K4's (``check_kernel_fits``; at Mi = 5 and the chain [512,
    256, 128], d 256 and 4 heads: 64 rows).
    ``attention_scores_gram.launches`` counts kernel launches.
    """
    _check_attention_head(head)
    user_side, item_side = tuple(user_side[:6]), tuple(item_side[:7])
    if len(user_side) < 6 or len(item_side) < 7:
        raise ValueError('the gram variant takes the scalar tables '
                         '(with_gram=True)')
    if _device_of('attention_scores_gram', *user_side, *item_side) is None:
        return attention_scores_gram_plain(head, user_side, item_side)
    out = _launch_attention('attention_gram_mlp', head, user_side,
                            item_side, _block_rows)
    if out.numel():
        attention_scores_gram.launches += 1
    return out


attention_scores_gram.launches = 0
