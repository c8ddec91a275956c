"""``parallel/dryrun.dryrun_multichip`` on four gloo ranks on the CPU: the
counterpart of JAX's ``dryrun_multichip`` (``__graft_entry__.py``) runs
every stage (the frozen step with InfoNCE, tensor-parallel parameters and
a catalog-sharded table; the sharded top-K; the three sharded cascades
against one process and ``auto_cascade``; the unfrozen step with remat;
the checkpoint round trip on the mesh; the frozen step and the scorer on
the 4x1 mesh) and prints its ok line with JAX's stage names. The weights
are the port's own random ones, so the losses are not JAX's; they are
finite, InfoNCE is active, and the frozen step's loss is the same on the
2x2 and the 4x1 mesh (the same global batch from the same weights).
"""
import re

import numpy as np

from pixelrec_multimodal_tpu_torch.parallel.dryrun import dryrun_multichip
from tests._torch_port import quiet

# JAX's stages on 4 devices (__graft_entry__.py:_dryrun_impl): the primary
# mesh is 2x2, so the extra topologies add only 4x1.
STAGES = ['frozen+contrastive', 'sharded_topk', 'sharded_cascade',
          'e2e_unfrozen+remat', 'sharded_ckpt_roundtrip', 'mesh4x1']


def test_dryrun_multichip_prints_jax_stage_names():
    line = quiet(dryrun_multichip, 4, 'cpu')
    m = re.fullmatch(r"dryrun_multichip ok: ranks=4 backend=gloo "
                     r"primary_mesh=\{'data': 2, 'model': 2\} "
                     r"stages=\[(.*)\]", line)
    assert m, line
    stages = m.group(1).split('; ')
    assert [s.split('(')[0] for s in stages] == STAGES
    loss = {s.split('(')[0]: float(re.search(r'loss=([-0-9.]+)', s).group(1))
            for s in stages if 'loss=' in s}
    assert all(np.isfinite(list(loss.values())))
    assert float(re.search(r'infonce=([0-9.]+)', stages[0]).group(1)) > 0
    assert abs(loss['frozen+contrastive'] - loss['mesh4x1']) < 1e-4
    assert stages[1] == 'sharded_topk(shape=(12, 5))'
