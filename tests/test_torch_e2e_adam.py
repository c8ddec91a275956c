"""AdamW steps of the port's end-to-end path against JAX's, on the CPU:
the default mask (both towers frozen, bit for bit in both packages) and
both towers unfrozen, where ResNet's frozen BatchNorm statistics move,
decay and clip as JAX's parameters do. Adam's sign-sensitive entries are
held by a share (``tests/_torch_e2e.py:held``). Fixtures:
``tests/_torch_e2e.py``.
"""
import jax
import numpy as np
import torch

from tests._torch_e2e import (
    ADAM_LR,
    Pair,
    assert_metrics,
    held,
    port_sd,
    raw_batch,
)


def test_frozen_adamw_step():
    """The default mask freezes both towers: they stay bit for bit in both
    packages, need no gradient in the port, and the scorer moves as
    JAX's."""
    pair = Pair('adamw', ADAM_LR, freeze=(True, True))
    before = {k: v.clone() for k, v in port_sd(pair.tmodel).items()}
    jbefore = jax.tree.map(np.array, pair.jstate.params)
    jm, tm = pair.step(raw_batch())
    assert_metrics(jm, tm)
    jafter, tafter = pair.jax_sd(), port_sd(pair.tmodel)
    towers = [k for k in tafter if not k.startswith('scorer.')]
    assert towers
    for k in towers:
        assert torch.equal(tafter[k], before[k]), k
        assert not dict(pair.tmodel.named_parameters())[k].requires_grad
    for name in ('vision_encoder', 'language_encoder'):
        for a, b in zip(jax.tree.leaves(jbefore[name]),
                        jax.tree.leaves(pair.jstate.params[name])):
            np.testing.assert_array_equal(np.asarray(b), a)
    scorer = [k for k in tafter if k.startswith('scorer.')]
    assert any(not torch.equal(tafter[k], before[k]) for k in scorer)
    held({k: jafter[k] for k in scorer}, tafter, adam=True)


def test_unfrozen_adamw_moves_resnet_statistics():
    """ResNet's frozen BatchNorm statistics are parameters, as in JAX:
    one unfrozen AdamW step moves, decays and clips them with the rest,
    to JAX's values."""
    pair = Pair('adamw', ADAM_LR, freeze=(False, False))
    stats = [k for k in port_sd(pair.tmodel)
             if k.startswith('vision_encoder.')
             and k.endswith(('running_mean', 'running_var'))]
    before = {k: port_sd(pair.tmodel)[k].clone() for k in stats}
    jm, tm = pair.step(raw_batch())
    assert_metrics(jm, tm)
    jafter, tafter = pair.jax_sd(), port_sd(pair.tmodel)
    for k in stats:
        assert not torch.equal(jafter[k], before[k]), k
    held({k: jafter[k] for k in stats}, tafter, adam=True)
    held(jafter, tafter, adam=True)
