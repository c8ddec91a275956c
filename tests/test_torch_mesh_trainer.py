"""The port's ``Trainer`` over the 'data' axis of two gloo ranks on the
CPU, against the JAX package's ``Trainer`` with a (2, 1) mesh and the port
in one process.

``tests/test_torch_trainer.py``'s data and model (SGD, dropout 0, the
plateau scheduler at patience 0, batch 32) run 2 epochs on a 2x1 mesh, on
the whole-epoch path and on the per-batch one, from the same weights (a
Flax tree drawn from a numpy seed, set as JAX's ``Trainer.state``): the
loss history within 1e-5, the classification metrics and the LR sequence
equal, the parameters within 1e-5, on both ranks; rank 0 alone writes the
checkpoints.
"""
import json

import jax
import numpy as np
import pytest

from pixelrec_multimodal_tpu.models.multimodal import (
    MultimodalRecommender as JaxRecommender,
)
from pixelrec_multimodal_tpu.parallel import mesh as jmesh
from pixelrec_multimodal_tpu.training import Trainer as JaxTrainer
from pixelrec_multimodal_tpu.training import optimizers as jopt
from pixelrec_multimodal_tpu.training import steps as jsteps
from pixelrec_multimodal_tpu_torch.training import Trainer
from tests._torch_mesh import Ranks
from tests._torch_port import port_model, port_state_of, quiet
from tests.test_torch_trainer import (
    BATCH,
    configs,
    jax_datasets,
    model_kwargs,
    port_datasets,
    record_lr,
)

TOL, EPOCHS = 1e-5, 2
TRAIN = dict(epochs=EPOCHS, batch_size=BATCH, patience=2,
             lr_scheduler_patience=0, optimizer_type='sgd', lr=0.05)


def jax_state(jmodel):
    """JAX's train state from a Flax tree of the model's shapes (traced,
    not run) drawn from a numpy seed, with the optimizer ``Trainer.train``
    builds for TRAIN; and the tree as numpy."""
    z = jax.numpy.zeros(2, jax.numpy.int32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0)}, z, z, z,
        vision_features=jax.numpy.zeros((2, jmodel.vision_feature_dim)),
        language_features=jax.numpy.zeros((2, jmodel.language_feature_dim)),
        numerical_features=jax.numpy.zeros((2, 2)), train=False))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: (0.2 * rng.standard_normal(
        s.shape)).astype(np.float32), shapes)
    for stats in variables['batch_stats']['prediction_network'].values():
        stats['var'] = np.abs(stats['var']) + 0.5
    tx = jopt.build_optimizer('sgd', TRAIN['lr'], 0.01, gradient_clip=1.0)
    return jsteps.TrainState.create(
        apply_fn=jmodel.apply, params=variables['params'],
        batch_stats=variables['batch_stats'], tx=tx), variables


@pytest.fixture(scope='module')
def world(tmp_path_factory):
    """The ranks started first; then JAX's meshed trainer and the port's
    one process."""
    base = tmp_path_factory.mktemp('mesh_trainer')
    ranks = Ranks(base / 'job', 2)
    jfull, jtr, jva = jax_datasets()
    _, ttr, tva = port_datasets()
    kw = model_kwargs(jfull)
    jmodel = JaxRecommender(**kw)
    state, variables = jax_state(jmodel)
    jcfg, tcfg = configs(base)
    common = {'kind': 'trainer', 'model': 'tr', 'datasets': 'small',
              'config': 'port', 'mesh': (2, 1), 'train': TRAIN}
    ranks.submit({
        'models': {'tr': {'kw': kw, 'variables': variables}},
        'datasets': {'small': (ttr, tva)}, 'configs': {'port': tcfg},
        'calls': [dict(common, id='epochs',
                       checkpoint_dir=str(base / 'ranks_epochs')),
                  dict(common, id='batches', compiled=False,
                       checkpoint_dir=str(base / 'ranks_batches'))]})
    jt = JaxTrainer(jmodel, config=jcfg, checkpoint_dir=str(base / 'jax'),
                    mesh=jmesh.make_mesh(jax.devices()[:2],
                                         data_parallel=2))
    jt.state = state
    jlr = record_lr(jt)
    jlosses = quiet(jt.train, jtr, jva, **TRAIN)
    one = Trainer(port_model(kw, variables), config=tcfg,
                  checkpoint_dir=str(base / 'one'))
    tlr = record_lr(one)
    tlosses = quiet(one.train, ttr, tva, **TRAIN)
    yield {'ranks': ranks.results(), 'jax': (jt, jlosses, jlr),
           'one': (one, tlosses, tlr), 'kw': kw, 'base': base}
    ranks.kill()


@pytest.mark.parametrize('path', ['epochs', 'batches'])
def test_trainer_matches_jax_and_one_process(world, path):
    jt, jlosses, jlr = world['jax']
    one, tlosses, tlr = world['one']
    for r in range(2):
        got = world['ranks'][r][path]
        for ref in (jlosses, tlosses):
            for g, want in zip(got['losses'], ref, strict=True):
                assert len(g) == EPOCHS
                np.testing.assert_allclose(g, want, atol=TOL)
        assert got['lrs'] == jlr == tlr
        for k in ('train_metrics', 'val_metrics'):
            for g, want in zip(got['history'][k],
                               jt.training_history[k], strict=True):
                for m in ('accuracy', 'precision', 'recall', 'f1_score'):
                    assert g[m] == want[m], (k, m)
        ref = port_state_of(world['kw'], jt.state)
        for k, v in ref.items():
            np.testing.assert_allclose(got['state'][k], v.numpy(), atol=TOL,
                                       err_msg=k)
            np.testing.assert_allclose(got['state'][k],
                                       one.model.state_dict()[k].numpy(),
                                       atol=TOL, err_msg=k)
    assert world['ranks'][0][path]['state'].keys() == \
        world['ranks'][1][path]['state'].keys()


def test_trainer_ranks_write_one_checkpoint(world):
    root = world['base'] / 'ranks_epochs' / 'None_None'
    for name in ('best_model', 'last_model'):
        assert sorted(p.name for p in (root / name).iterdir()) == \
            ['meta.json', 'state.pt']
    meta = json.loads((root / 'last_model' / 'meta.json').read_text())
    assert meta['epoch'] == EPOCHS - 1
