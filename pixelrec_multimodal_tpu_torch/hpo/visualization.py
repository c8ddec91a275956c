# pixelrec_multimodal_tpu_torch/hpo/visualization.py
"""Study visualizations as static PNGs (matplotlib; no plotly or optuna).

Counterpart of ``pixelrec_multimodal_tpu/hpo/visualization.py``: the same
three diagnostics (optimization history, parameter importances, parallel
coordinates) from any study object exposing ``.trials`` with
``number/state/value/params``. matplotlib is imported only inside the
plotting functions, so the module imports where matplotlib is absent;
plotting there raises ImportError, which the search entry point reports
as a warning and then writes no PNG.

Parameter importance uses a model-free estimate, bit for bit JAX's:
|Spearman rank correlation| (mergesort ranks, ties averaged) with the
objective for numeric parameters, and the correlation ratio (eta) for
categorical ones, normalized to sum to 1.
"""
from __future__ import annotations

import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Validated categorical/sequential palette (slot-1 blue; sequential =
# one hue light->dark; text in ink tokens, never series color).
_BLUE = '#2a78d6'
_BLUE_DARK = '#174e92'
_BLUE_LIGHT = '#d6e6f8'
_INK = '#0b0b0b'
_INK_2 = '#52514e'
_GRID = '#e6e5e1'
_SURFACE = '#fcfcfb'


def _completed_trials(study) -> List[Any]:
    out = []
    for t in study.trials:
        state = getattr(t, 'state', None)
        name = getattr(state, 'name', None) or str(state)
        if 'COMPLETE' not in name:
            continue
        if t.value is None or not math.isfinite(t.value):
            continue
        out.append(t)
    return out


def _style_axes(ax):
    ax.set_facecolor(_SURFACE)
    for spine in ('top', 'right'):
        ax.spines[spine].set_visible(False)
    for spine in ('left', 'bottom'):
        ax.spines[spine].set_color(_GRID)
    ax.tick_params(colors=_INK_2, labelsize=9)
    ax.grid(True, color=_GRID, linewidth=0.7, alpha=0.8)
    ax.set_axisbelow(True)


def _new_fig(width=7.2, height=4.2):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(width, height), dpi=144)
    fig.patch.set_facecolor(_SURFACE)
    return plt, fig, ax


def plot_optimization_history(study, path: str,
                              metric_name: str = 'objective') -> bool:
    """Trial values vs trial number with the running best overlaid."""
    trials = _completed_trials(study)
    if not trials:
        return False
    plt, fig, ax = _new_fig()
    _style_axes(ax)
    nums = np.asarray([t.number for t in trials])
    vals = np.asarray([float(t.value) for t in trials])
    direction = getattr(study, 'direction', 'minimize')
    direction = getattr(direction, 'name', None) or str(direction)
    best = (np.minimum if 'MIN' in direction.upper() else np.maximum
            ).accumulate(vals[np.argsort(nums)])
    order = np.argsort(nums)
    ax.scatter(nums, vals, s=22, color=_BLUE, alpha=0.75, linewidths=0,
               label='trial value', zorder=3)
    ax.plot(nums[order], best, color=_BLUE_DARK, linewidth=2,
            label='best so far', zorder=4)
    ax.set_xlabel('trial', color=_INK_2, fontsize=10)
    ax.set_ylabel(metric_name, color=_INK_2, fontsize=10)
    ax.set_title('Optimization history', color=_INK, fontsize=12, loc='left')
    leg = ax.legend(frameon=False, fontsize=9, loc='best')
    for text in leg.get_texts():
        text.set_color(_INK_2)
    fig.tight_layout()
    fig.savefig(path, facecolor=fig.get_facecolor())
    plt.close(fig)
    return True


def compute_param_importances(study) -> Dict[str, float]:
    """Model-free importances: |Spearman| for numerics, eta for categoricals,
    normalized to sum to 1 over parameters with >=2 distinct observed values."""
    trials = _completed_trials(study)
    if len(trials) < 2:
        return {}
    values = np.asarray([float(t.value) for t in trials])
    names = sorted({k for t in trials for k in t.params})
    raw: Dict[str, float] = {}
    for name in names:
        pairs = [(t.params[name], v) for t, v in zip(trials, values)
                 if name in t.params]
        if len(pairs) < 2:
            continue
        xs = [p for p, _ in pairs]
        ys = np.asarray([y for _, y in pairs])
        if len(set(map(repr, xs))) < 2 or np.ptp(ys) == 0:
            continue
        if all(isinstance(x, (int, float, np.integer, np.floating))
               and not isinstance(x, bool) for x in xs):
            raw[name] = _abs_spearman(np.asarray(xs, dtype=float), ys)
        else:
            raw[name] = _eta(xs, ys)
    total = sum(raw.values())
    if total <= 0:
        return {k: 0.0 for k in raw}
    return {k: v / total for k, v in
            sorted(raw.items(), key=lambda kv: -kv[1])}


def _abs_spearman(x: np.ndarray, y: np.ndarray) -> float:
    def rank(a):
        order = np.argsort(a, kind='mergesort')
        r = np.empty(len(a))
        r[order] = np.arange(len(a), dtype=float)
        # average ties
        for v in np.unique(a):
            m = a == v
            if m.sum() > 1:
                r[m] = r[m].mean()
        return r

    rx, ry = rank(x), rank(y)
    sx, sy = rx.std(), ry.std()
    if sx == 0 or sy == 0:
        return 0.0
    return float(abs(np.mean((rx - rx.mean()) * (ry - ry.mean())) / (sx * sy)))


def _eta(groups: Sequence[Any], y: np.ndarray) -> float:
    total_var = y.var()
    if total_var == 0:
        return 0.0
    keys = {}
    for g, v in zip(groups, y):
        keys.setdefault(repr(g), []).append(v)
    between = sum(len(vs) * (np.mean(vs) - y.mean()) ** 2 for vs in
                  keys.values()) / len(y)
    return float(math.sqrt(max(between / total_var, 0.0)))


def plot_param_importances(study, path: str) -> bool:
    """Horizontal bars, one hue (magnitude job), value-labeled."""
    imp = compute_param_importances(study)
    if not imp:
        return False
    names = list(imp)[:20][::-1]
    vals = [imp[n] for n in names]
    plt, fig, ax = _new_fig(height=max(2.2, 0.34 * len(names) + 1.2))
    _style_axes(ax)
    ax.grid(False, axis='y')
    bars = ax.barh(names, vals, color=_BLUE, height=0.62, zorder=3)
    for bar, v in zip(bars, vals):
        ax.text(bar.get_width() + max(vals) * 0.015,
                bar.get_y() + bar.get_height() / 2, f'{v:.2f}',
                va='center', ha='left', fontsize=8.5, color=_INK_2)
    ax.set_xlim(0, max(vals) * 1.12)
    ax.set_xlabel('relative importance', color=_INK_2, fontsize=10)
    ax.set_title('Parameter importances', color=_INK, fontsize=12, loc='left')
    fig.tight_layout()
    fig.savefig(path, facecolor=fig.get_facecolor())
    plt.close(fig)
    return True


def plot_parallel_coordinate(study, path: str,
                             params: Optional[List[str]] = None) -> bool:
    """One normalized vertical axis per parameter; lines colored by the
    objective on a single-hue sequential ramp (light=worst, dark=best)."""
    trials = _completed_trials(study)
    if len(trials) < 2:
        return False
    values = np.asarray([float(t.value) for t in trials])
    names = params or sorted({k for t in trials for k in t.params})
    names = [n for n in names
             if sum(n in t.params for t in trials) == len(trials)][:12]
    if not names:
        return False

    # Column -> [0,1] positions; categorical columns get evenly spaced levels.
    columns: List[np.ndarray] = []
    ticklabels: List[Tuple[List[float], List[str]]] = []
    for name in names:
        xs = [t.params[name] for t in trials]
        numeric = all(isinstance(x, (int, float, np.integer, np.floating))
                      and not isinstance(x, bool) for x in xs)
        if numeric:
            arr = np.asarray(xs, dtype=float)
            lo, hi = arr.min(), arr.max()
            span = (hi - lo) or 1.0
            columns.append((arr - lo) / span)
            ticks = [0.0, 0.5, 1.0]
            labels = [f'{lo + t * span:.3g}' for t in ticks]
            ticklabels.append((ticks, labels))
        else:
            levels = sorted(set(map(str, xs)))
            pos = {v: (i / max(len(levels) - 1, 1)) for i, v in
                   enumerate(levels)}
            columns.append(np.asarray([pos[str(x)] for x in xs]))
            ticklabels.append(([pos[v] for v in levels], levels))
    mat = np.stack(columns, axis=1)  # [trials, params]

    direction = getattr(study, 'direction', 'minimize')
    direction = getattr(direction, 'name', None) or str(direction)
    goodness = -values if 'MIN' in direction.upper() else values
    lo, hi = goodness.min(), goodness.max()
    norm = (goodness - lo) / ((hi - lo) or 1.0)

    from matplotlib.colors import LinearSegmentedColormap
    cmap = LinearSegmentedColormap.from_list(
        'seq_blue', [_BLUE_LIGHT, _BLUE, _BLUE_DARK])
    plt, fig, ax = _new_fig(width=max(7.2, 1.05 * len(names) + 1.5))
    _style_axes(ax)
    ax.grid(False)
    xs = np.arange(len(names))
    order = np.argsort(norm)  # draw best (darkest) last
    for i in order:
        ax.plot(xs, mat[i], color=cmap(norm[i]), linewidth=1.4,
                alpha=0.85, zorder=3)
    for j, name in enumerate(names):
        ax.axvline(j, color=_GRID, linewidth=1.0, zorder=1)
        ticks, labels = ticklabels[j]
        last = j == len(names) - 1
        for tpos, lab in zip(ticks, labels):
            ax.text(j + (-0.045 if last else 0.045), tpos, str(lab)[:14],
                    fontsize=7.5, color=_INK_2, va='center',
                    ha='right' if last else 'left', zorder=5)
    ax.set_xticks(xs)
    ax.set_xticklabels(names, rotation=20, ha='right', fontsize=9,
                       color=_INK_2)
    ax.set_yticks([])
    ax.set_ylim(-0.05, 1.05)
    ax.set_title('Parallel coordinates (darker = better objective)',
                 color=_INK, fontsize=12, loc='left')
    # Colorbar in actual objective units: dark end = better, which for
    # 'minimize' means the reversed ramp over [min(value), max(value)].
    from matplotlib.colors import Normalize
    display_cmap = cmap.reversed() if 'MIN' in direction.upper() else cmap
    sm = plt.cm.ScalarMappable(
        norm=Normalize(vmin=float(values.min()), vmax=float(values.max())),
        cmap=display_cmap)
    cbar = fig.colorbar(sm, ax=ax, pad=0.015, fraction=0.04)
    cbar.ax.tick_params(labelsize=8, colors=_INK_2)
    cbar.outline.set_edgecolor(_GRID)
    fig.tight_layout()
    fig.savefig(path, facecolor=fig.get_facecolor())
    plt.close(fig)
    return True


def save_study_visualizations(study, output_dir: str,
                              metric_name: str = 'objective') -> List[str]:
    """Write the three diagnostic PNGs; returns the paths written."""
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    if plot_optimization_history(
            study, str(out / 'optimization_history.png'), metric_name):
        written.append(str(out / 'optimization_history.png'))
    if len(_completed_trials(study)) > 5 and plot_param_importances(
            study, str(out / 'param_importances.png')):
        written.append(str(out / 'param_importances.png'))
    if plot_parallel_coordinate(study, str(out / 'parallel_coordinate.png')):
        written.append(str(out / 'parallel_coordinate.png'))
    return written
