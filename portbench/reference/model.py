"""The plain reference of the multimodal recommender, in float32.

Written from the model's description, not from the port: ID embeddings for
the user, the item and the item's tag; one projection per item feature
(Dense, activation, dropout) into the embedding width; fusion of the M
modality vectors, by concatenation or by a softmax gate over the
concatenation (dropout on the concatenation in training) weighting the sum
of the vectors; the prediction MLP (Dense, activation, BatchNorm, dropout
for each hidden layer, then a Dense to one logit) and the sigmoid. The
activation ``gelu`` is the tanh form. BatchNorm is eps 1e-5; in training it
normalises by the batch's mean and biased variance and moves its running
statistics to ``0.9 r + 0.1 b`` (the momentum of the JAX model that the
port follows). Dropout keeps an entry with probability ``1 - rate`` and
divides it by that; its masks come from the generator given, drawn layer
by layer in the order above, one ``torch.rand`` of the layer's output shape
each. Scores are ``nan_to_num``'d (nan 0, +inf 10, -inf -10).

Weights are the benchmark's own (``portbench/inputs.py``), by state-dict
name. Every product is float32 with TF32 off (``exact``); ``product``
replaces it, for the control that computes in a lower precision than the
configuration states (``float8_product``).

Nothing here imports the port, JAX or the JAX package.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ACTIVATIONS = {
    'relu': F.relu,
    'gelu': lambda x: F.gelu(x, approximate='tanh'),
    'tanh': torch.tanh,
    'leaky_relu': lambda x: F.leaky_relu(x, 0.01),
    'silu': F.silu,
}
BN_EPS, BN_MOMENTUM = 1e-5, 0.9

Weights = Dict[str, torch.Tensor]


@contextlib.contextmanager
def exact():
    """float32 products in full float32 (TF32 off), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _scaled(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """``x`` through ``dtype`` with one scale for the tensor (its largest
    magnitude to ``top``), back in float32."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).float() / scale


class _Operand(torch.autograd.Function):
    """An operand in float8 e4m3 forward; its gradient passed back as it
    is (the product's own rounding is ``_Output``'s)."""

    @staticmethod
    def forward(ctx, x):
        return _scaled(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Output(torch.autograd.Function):
    """A product's output as it is forward; the gradient it receives
    rounded to float8 e5m2 backward, before the two products of the
    backward pass take it."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return _scaled(grad, torch.float8_e5m2, 57344.0)


def float8_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w.T`` computed in float8, as float8 training computes it: both
    operands in e4m3 forward and the incoming gradient in e5m2 backward,
    one scale a tensor each, every sum in float32."""
    return _Output.apply(_Operand.apply(x) @ _Operand.apply(w).T)


class Dropout:
    """Dropout at ``rate`` with masks from ``gen`` (none without one)."""

    def __init__(self, rate: float, gen: Optional[torch.Generator]):
        self.rate, self.gen = rate, gen

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.gen is None or self.rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.gen,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class Model:
    """The reference over ``weights`` for configuration ``cfg``;
    ``product(x, w)`` (None: exact float32 ``x @ w.T``) computes every
    Dense's product."""

    def __init__(self, cfg: dict, weights: Weights,
                 product: Optional[Callable] = None):
        self.cfg, self.w, self.product = cfg, weights, product
        m = cfg['model']
        self.act = ACTIVATIONS.get(m['fusion_activation'], F.relu)
        self.rate = m['dropout_rate']
        self.hidden = list(m['fusion_hidden_dims'])
        self.features = [k for k in ('vision', 'language', 'numerical')
                         if f'{k}_projection.Dense_0.weight' in weights]

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.w[f'{name}.weight']
        y = x @ w.T if self.product is None else self.product(x, w)
        return y + self.w[f'{name}.bias']

    def embed(self, table: str, idx: torch.Tensor) -> torch.Tensor:
        return self.w[f'{table}.weight'][idx.long()]

    def project(self, name: str, x: torch.Tensor, drop: Dropout
                ) -> torch.Tensor:
        i = 0
        while f'{name}_projection.Dense_{i}.weight' in self.w:
            x = drop(self.act(self.dense(f'{name}_projection.Dense_{i}', x)))
            i += 1
        return x

    def item_modalities(self, items: torch.Tensor, tags: torch.Tensor,
                        feats: Dict[str, torch.Tensor],
                        drop: Dropout) -> List[torch.Tensor]:
        """[N, d] vectors of the item side: item, tag, each feature."""
        return [self.embed('item_embedding', items),
                self.embed('tag_embedding', tags),
                *(self.project(k, feats[k].float(), drop)
                  for k in self.features)]

    def fuse(self, mods: List[torch.Tensor], drop: Dropout) -> torch.Tensor:
        concat = torch.cat(mods, dim=-1)
        if self.cfg['model']['fusion_type'] == 'concatenate':
            return concat
        gates = torch.softmax(self.dense('fusion_layer.gating', drop(concat)),
                              dim=-1)
        return (torch.stack(mods, dim=-2) * gates[..., None]).sum(dim=-2)

    def head(self, x: torch.Tensor, drop: Dropout, train: bool = False,
             stats: Optional[Dict[str, torch.Tensor]] = None,
             final: bool = True) -> torch.Tensor:
        """Scores [N] of fused vectors [N, F] (``final=False``: the logits
        before the last activation). In training BatchNorm uses the batch's
        statistics and writes the moved running statistics into ``stats``
        by state-dict name."""
        for i in range(len(self.hidden)):
            x = self.act(self.dense(f'prediction_network.Dense_{i}', x))
            bn = f'prediction_network.BatchNorm_{i}'
            if f'{bn}.weight' in self.w:
                rm = self.w[f'{bn}.running_mean']
                rv = self.w[f'{bn}.running_var']
                if train:
                    mean = x.mean(dim=0)
                    var = torch.clamp((x * x).mean(dim=0) - mean * mean,
                                      min=0.0)
                    if stats is not None:
                        with torch.no_grad():
                            stats[f'{bn}.running_mean'] = (
                                BN_MOMENTUM * rm + (1 - BN_MOMENTUM) * mean)
                            stats[f'{bn}.running_var'] = (
                                BN_MOMENTUM * rv + (1 - BN_MOMENTUM) * var)
                else:
                    mean, var = rm, rv
                x = ((x - mean) * torch.rsqrt(var + BN_EPS)
                     * self.w[f'{bn}.weight'] + self.w[f'{bn}.bias'])
            x = drop(x)
        x = self.dense(f'prediction_network.Dense_{len(self.hidden)}', x)
        if not final:
            return x[..., 0]
        act = self.cfg['model']['final_activation']
        if act == 'sigmoid':
            x = torch.sigmoid(x)
        elif act == 'tanh':
            x = torch.tanh(x)
        return torch.nan_to_num(x[..., 0], nan=0.0, posinf=10.0,
                                neginf=-10.0)

    # ------------------------------------------------------------ serving
    def catalog(self, feats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The item side of every catalog item, [n_items, Mi, d]."""
        n = feats['tag'].shape[0]
        items = torch.arange(n, device=feats['tag'].device)
        with torch.no_grad():
            return torch.stack(self.item_modalities(
                items, feats['tag'], feats, Dropout(0.0, None)), dim=1)

    def score_users(self, users: torch.Tensor, catalog: torch.Tensor,
                    pairs_per_block: int = 1 << 20,
                    final: bool = True) -> torch.Tensor:
        """Scores [len(users), n_items] of every pair, in eval mode, in
        blocks of about ``pairs_per_block`` pairs (``final=False``: the
        logits before the last activation)."""
        n = catalog.shape[0]
        item_block = min(n, pairs_per_block)
        user_block = max(1, pairs_per_block // item_block)
        out = torch.empty(len(users), n, device=catalog.device)
        no_drop = Dropout(0.0, None)
        with torch.no_grad():
            for u0 in range(0, len(users), user_block):
                ue = self.embed('user_embedding', users[u0:u0 + user_block])
                b = ue.shape[0]
                for i0 in range(0, n, item_block):
                    it = catalog[i0:i0 + item_block]
                    c = it.shape[0]
                    mods = [ue[:, None, :].expand(b, c, ue.shape[1])] + [
                        it[None, :, m, :].expand(b, c, it.shape[2])
                        for m in range(it.shape[1])]
                    flat = [x.reshape(b * c, -1) for x in mods]
                    out[u0:u0 + b, i0:i0 + c] = self.head(
                        self.fuse(flat, no_drop), no_drop,
                        final=final).view(b, c)
        return out

    # ----------------------------------------------------------- training
    def forward_train(self, batch: Dict[str, torch.Tensor],
                      packed: torch.Tensor, drop: Dropout,
                      stats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Scores [B] of a training batch (``user_idx``, ``item_idx``,
        ``tag_idx``) in training mode: the item features gathered from the
        packed table, dropout from ``drop``, BatchNorm on the batch."""
        rows = packed[batch['item_idx'].long()]
        feats, off = {}, 0
        for k in self.features:
            width = self.w[f'{k}_projection.Dense_0.weight'].shape[1]
            feats[k] = rows[:, off:off + width]
            off += width
        mods = [self.embed('user_embedding', batch['user_idx'])]
        mods += self.item_modalities(batch['item_idx'], batch['tag_idx'],
                                     feats, drop)
        return self.head(self.fuse(mods, drop), drop, train=True,
                         stats=stats)


class TopK:
    """The reference in the scorer's place, for a control:
    ``top_k(users, k, seen_mask)`` gives host arrays as the scorer does,
    the k best scores (after the last activation) of every catalog item
    not marked in the bool mask's rows, and their items."""

    def __init__(self, model: Model, feats: Dict[str, torch.Tensor]):
        self.model = model
        with exact():
            self.catalog = model.catalog(feats)

    def top_k(self, users: np.ndarray, k: int,
              seen_mask: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
        dev = self.catalog.device
        with exact():
            scores = self.model.score_users(
                torch.from_numpy(np.asarray(users, np.int64)).to(dev),
                self.catalog)
        if seen_mask is not None:
            seen = torch.from_numpy(seen_mask[:len(users)]).to(dev)
            scores[seen] = float('-inf')
        v, i = torch.topk(scores, k, dim=1)
        return v.cpu().numpy(), i.cpu().numpy()


def bce(scores: torch.Tensor, labels: torch.Tensor,
        weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Binary cross-entropy of sigmoid scores, clamped to [1e-7, 1 - 1e-7],
    averaged over the rows (weighted by ``weight`` where given)."""
    p = torch.clamp(scores, 1e-7, 1.0 - 1e-7)
    per = -(labels * torch.log(p) + (1.0 - labels) * torch.log1p(-p))
    if weight is None:
        return per.mean()
    return (weight * per).sum() / torch.clamp(weight.sum(), min=1.0)
