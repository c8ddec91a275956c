"""The inputs of a run, made from ``--seed`` on the run's device.

Everything here is the benchmark's own: the weights under the state-dict
names that a configuration's widths give (the port's model loads them by
name, the plain reference reads them as they are), the item features, the
users' histories and the stream of requests. The same seed gives the same
inputs. Weights and features are drawn on the device in a few large calls.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

# One stream of random numbers for each purpose, so that adding a draw to
# one leaves the others as they were.
PURPOSES = {'weights': 1, 'features': 2, 'history': 3, 'requests': 4,
            'pool': 5, 'dropout': 6, 'sample': 7}

# Scales of the random weights. Embeddings and projections feed the head
# vectors of about unit size; the last Dense is scaled so that the logits
# spread over a few units and the catalog's best scores stay off the
# sigmoid's flat top, where float32 could not order them.
EMBEDDING_STD = 1.0
BIAS_STD = 0.1
LAST_DENSE_GAIN = 4.5


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one purpose of a run's ``seed`` (any integer)."""
    ss = np.random.SeedSequence([seed % (1 << 64), PURPOSES[purpose]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, purpose: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose))


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, purpose))


# ------------------------------------------------------------------ model
def feature_widths(cfg: dict) -> Dict[str, int]:
    """Widths of the item-side features the model reads, in its order."""
    m, dims = cfg['model'], cfg['feature_dims']
    out = {}
    if m['vision_model']:
        out['vision'] = dims['vision']
    if m['language_model']:
        out['language'] = dims['language']
    if cfg['num_numerical_features'] > 0:
        out['numerical'] = cfg['num_numerical_features']
    return out


def n_modalities(cfg: dict) -> int:
    return 3 + len(feature_widths(cfg))


def contrastive_active(cfg: dict) -> bool:
    m = cfg['model']
    return bool(m['use_contrastive'] and m['vision_model'] == 'clip')


def weight_specs(cfg: dict) -> List[Tuple[str, tuple, str]]:
    """(state-dict name, shape, kind) of every weight of the configuration's
    model, from its widths. Kinds: ``emb``, ``kernel`` (``[out, in]``),
    ``last`` (the last Dense's kernel), ``bias``, ``bn_mean``, ``bn_var``,
    ``bn_weight``, ``bn_bias``, ``temperature``, ``count``."""
    m = cfg['model']
    d = m['embedding_dim']
    specs = []
    for table, n in (('user_embedding', cfg['n_users']),
                     ('item_embedding', cfg['n_items']),
                     ('tag_embedding', cfg['n_tags'])):
        specs.append((f'{table}.weight', (n, d), 'emb'))

    def dense(name, n_in, n_out, kind='kernel'):
        specs.append((f'{name}.weight', (n_out, n_in), kind))
        specs.append((f'{name}.bias', (n_out,), 'bias'))

    hid = m['projection_hidden_dim']
    for name, width in feature_widths(cfg).items():
        dims = [width] + ([hid] if hid else []) + [d]
        for i in range(len(dims) - 1):
            dense(f'{name}_projection.Dense_{i}', dims[i], dims[i + 1])
    if contrastive_active(cfg):
        dense('vision_contrastive_projection', cfg['feature_dims']['vision'],
              d)
        dense('text_contrastive_projection', cfg['feature_dims']['clip_text'],
              d)
        specs.append(('temperature', (), 'temperature'))
    n_mod = n_modalities(cfg)
    fusion = m['fusion_type']
    if fusion == 'gated':
        dense('fusion_layer.gating', n_mod * d, n_mod)
    elif fusion != 'concatenate':
        raise ValueError(f'the benchmark does not model fusion {fusion!r}')
    prev = n_mod * d if fusion == 'concatenate' else d
    hidden = m['fusion_hidden_dims']
    for i, h in enumerate(hidden):
        dense(f'prediction_network.Dense_{i}', prev, h)
        if m['use_batch_norm']:
            bn = f'prediction_network.BatchNorm_{i}'
            for part, kind in (('weight', 'bn_weight'), ('bias', 'bn_bias'),
                               ('running_mean', 'bn_mean'),
                               ('running_var', 'bn_var')):
                specs.append((f'{bn}.{part}', (h,), kind))
            specs.append((f'{bn}.num_batches_tracked', (), 'count'))
        prev = h
    dense(f'prediction_network.Dense_{len(hidden)}', prev, 1, 'last')
    return specs


_NORMAL = ('emb', 'kernel', 'last', 'bias', 'bn_mean', 'bn_bias')
_UNIFORM = {'bn_var': (0.5, 2.0), 'bn_weight': (0.5, 1.5)}


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every weight of the configuration's model, float32 on ``device``,
    from two draws: one normal and one uniform buffer, cut and scaled."""
    specs = weight_specs(cfg)
    g = generator(seed, 'weights', device)
    sizes = {name: math.prod(shape) for name, shape, _ in specs}
    n_normal = sum(sizes[n] for n, _, k in specs if k in _NORMAL)
    n_uniform = sum(sizes[n] for n, _, k in specs if k in _UNIFORM)
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    out, i_n, i_u = {}, 0, 0
    for name, shape, kind in specs:
        n = sizes[name]
        if kind in _NORMAL:
            x = normal[i_n:i_n + n].view(shape)
            i_n += n
            if kind == 'emb':
                x = x * EMBEDDING_STD
            elif kind == 'kernel':
                x = x / math.sqrt(shape[1])
            elif kind == 'last':
                x = x * (LAST_DENSE_GAIN / math.sqrt(shape[1]))
            elif kind in ('bias', 'bn_mean', 'bn_bias'):
                x = x * BIAS_STD
        elif kind in _UNIFORM:
            lo, hi = _UNIFORM[kind]
            x = uniform[i_u:i_u + n].view(shape) * (hi - lo) + lo
            i_u += n
        elif kind == 'temperature':
            x = torch.full(shape, cfg['model']['contrastive_temperature'],
                           device=device)
        else:  # BatchNorm's count of batches
            x = torch.zeros(shape, dtype=torch.int64, device=device)
        out[name] = x.contiguous()
    return out


# ---------------------------------------------------------------- catalog
def make_features(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The catalog's raw item features on ``device``: ``packed`` [n_items,
    sum of the feature widths] float32 (the modalities side by side, in the
    model's order, from one draw), a view of each modality by name, and
    ``tag`` [n_items] int64."""
    g = generator(seed, 'features', device)
    widths = feature_widths(cfg)
    n = cfg['n_items']
    packed = torch.randn(n, sum(widths.values()), generator=g, device=device)
    out = {'packed': packed}
    off = 0
    for name, w in widths.items():
        out[name] = packed[:, off:off + w]
        off += w
    out['tag'] = torch.randint(0, cfg['n_tags'], (n,), generator=g,
                               device=device)
    return out


def history_lengths(n_users: int, p: dict, seed: int) -> np.ndarray:
    """Each user's history length. The lengths are the same multiset for
    every seed, the quantiles of a log-normal of mean ``mean_length`` and
    log-sigma ``log_sigma`` clipped to [min_length, max_length]; the seed
    only deals them out to the users."""
    sigma = p['log_sigma']
    mu = math.log(p['mean_length']) - sigma * sigma / 2
    q = (torch.arange(n_users, dtype=torch.float64) + 0.5) / n_users
    lengths = torch.exp(mu + sigma * torch.special.ndtri(q)).round()
    lengths = lengths.clamp(p['min_length'], p['max_length']).numpy()
    return rng(seed, 'history').permutation(lengths.astype(np.int64))


def make_histories(cfg: dict, p: dict, seed: int, device
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Each user's history, (indptr [n_users + 1] int64, items int32) on the
    host: ``history_lengths`` items drawn without replacement by Zipf
    popularity (exponent ``zipf_exponent``) over a seeded ranking of the
    catalog, by the Gumbel top-k draw on the device in blocks of users."""
    n_users, n_items = cfg['n_users'], cfg['n_items']
    lengths = np.minimum(history_lengths(n_users, p, seed), n_items)
    g = generator(seed, 'history', device)
    rank = torch.randperm(n_items, generator=g, device=device)
    log_w = -p['zipf_exponent'] * torch.log1p(rank.double()).float()
    block = max(1, (1 << 28) // (4 * n_items))  # 256 MiB of keys a block
    parts = []
    lengths_t = torch.from_numpy(lengths).to(device)
    for lo in range(0, n_users, block):
        hi = min(lo + block, n_users)
        keys = torch.empty(hi - lo, n_items, device=device).exponential_(
            generator=g).log_().neg_().add_(log_w)
        top = int(lengths[lo:hi].max())
        idx = torch.topk(keys, top, dim=1).indices
        keep = torch.arange(top, device=device) < lengths_t[lo:hi, None]
        parts.append(idx[keep].to(torch.int32))
        del keys, idx
    items = torch.cat(parts).cpu().numpy()
    indptr = np.zeros(n_users + 1, np.int64)
    np.cumsum(lengths, out=indptr[1:])
    return indptr, items


def rows_of(indptr: np.ndarray, items: np.ndarray, users: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """(row, item) of every history entry of ``users`` (rows numbered as
    ``users``), for setting a dense mask."""
    starts = indptr[users]
    lens = indptr[users + 1] - starts
    total = int(lens.sum())
    offsets = np.repeat(starts - np.concatenate([[0], np.cumsum(lens)[:-1]]),
                        lens)
    return (np.repeat(np.arange(len(users)), lens),
            items[offsets + np.arange(total)])


def request_users(n_users: int, per_request: int, seed: int
                  ) -> Iterator[np.ndarray]:
    """The users of each request: ``per_request`` distinct users drawn
    uniformly, request after request, from the run's seed."""
    r = rng(seed, 'requests')
    while True:
        yield r.choice(n_users, size=per_request, replace=False).astype(
            np.int32)
