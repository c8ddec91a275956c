"""SGD steps of the port's end-to-end path (``training/e2e_steps.py``)
against JAX's ``make_e2e_step_fns``, on the CPU, on one Pair: both towers
unfrozen and the CLIP text tower in the model. A step on a raw batch,
where the contrastive loss and the learned temperature move too, and an
augmented step on a batch of ``MultimodalDataset.batches(include_raw=
('image', 'text'))``, the port fed the draws JAX makes from its key.
Metrics at 1e-6, every parameter and statistic at 1e-5 (SGD's update is
linear in the gradient). Fixtures: ``tests/_torch_e2e.py``.
"""
import jax
import numpy as np
import pytest

from pixelrec_multimodal_tpu.config import (
    ImageAugmentationConfig as JaxAugmentation,
)
from pixelrec_multimodal_tpu_torch.data.dataset import MultimodalDataset
from tests._torch_e2e import (
    LR,
    N_ITEMS,
    N_TAGS,
    N_USERS,
    STEP_KEY,
    Pair,
    assert_metrics,
    held,
    port_sd,
    raw_batch,
)
from tests.test_torch_augment import jax_augment_draws

CONTRASTIVE_WEIGHT = 0.5
DATA_B = 4  # rows of the dataset batch: ResNet's forward at 224 px is dear


@pytest.fixture(scope='module')
def sgd_pair():
    """Both towers unfrozen, the CLIP text tower in the step, contrastive
    weight 0.5."""
    return Pair('sgd', LR, contrastive=True,
                contrastive_weight=CONTRASTIVE_WEIGHT)


def test_sgd_step_matches_jax(sgd_pair):
    """One SGD step: the metrics (the contrastive loss among them) at
    1e-6, every parameter and statistic at 1e-5, the learned temperature
    moved."""
    t0 = sgd_pair.tmodel.scorer.temperature.item()
    jm, tm = sgd_pair.step(raw_batch(contrastive=True))
    assert np.isfinite(jm['total_loss']) and jm['contrastive_loss'] > 0
    assert_metrics(jm, tm)
    jsd = sgd_pair.jax_sd()
    held(jsd, port_sd(sgd_pair.tmodel))
    assert float(jsd['scorer.temperature']) != t0
    assert int(sgd_pair.tstate.step) == int(sgd_pair.jstate.step)


def dataset_batch(folder):
    """DATA_B rows of ``MultimodalDataset.batches(include_raw=('image',
    'text'))``: 224 px decoded JPEGs (every other item has one),
    hash-tokenized text at length 16."""
    from PIL import Image
    rng = np.random.default_rng(3)
    items = {'item_id': np.array([f'i{j}' for j in range(N_ITEMS)], object),
             'tag': np.array([f't{j % N_TAGS}' for j in range(N_ITEMS)],
                             object),
             'description': np.array([f'item {j} soft red' for j in
                                      range(N_ITEMS)], object)}
    for j in range(0, N_ITEMS, 2):
        Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
                        ).save(folder / f'i{j}.jpg')
    inter = {'user_id': np.array([f'u{u}' for u in range(N_USERS)
                                  for _ in range(4)], object),
             'item_id': np.array([f'i{(3 * u + 5 * k) % N_ITEMS}'
                                  for u in range(N_USERS) for k in range(4)],
                                 object),
             'timestamp': np.arange(4 * N_USERS)}
    ds = MultimodalDataset(inter, items, image_folder=str(folder),
                           vision_model_name='resnet',
                           language_model_name='sentence-bert',
                           max_text_length=16, categorical_feat_cols=['tag'])
    return next(ds.batches(DATA_B, seed=1, include_raw=('image', 'text')))


def test_step_on_dataset_batches(sgd_pair, tmp_path):
    """A dataset batch through both packages' SGD step with every
    augmentation op on (noise too): JAX augments with the key it folds
    from its step key, the port with the same draws recomputed here. No
    CLIP text in the batch, so no contrastive loss."""
    batch = dataset_batch(tmp_path)
    assert batch['image'].shape == (DATA_B, 3, 224, 224)
    assert batch['text_input_ids'].shape == (DATA_B, 16)
    assert batch['image'].any()
    fields = dict(enabled=True, gaussian_noise=True)
    steps = sgd_pair.step_fns(CONTRASTIVE_WEIGHT, augmentation=fields)
    draws = jax_augment_draws(jax.random.fold_in(STEP_KEY, 1),
                              JaxAugmentation(**fields),
                              batch['image'].shape)
    jm, tm = sgd_pair.step(batch, steps, draws)
    assert np.isfinite(jm['total_loss']) and jm['contrastive_loss'] == 0
    assert_metrics(jm, tm)
    held(sgd_pair.jax_sd(), port_sd(sgd_pair.tmodel))
    assert int(sgd_pair.tstate.step) == int(sgd_pair.jstate.step)
