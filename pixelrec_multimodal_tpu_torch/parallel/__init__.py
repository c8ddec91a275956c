# pixelrec_multimodal_tpu_torch/parallel/__init__.py
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    agree_max,
    all_gather,
    all_reduce,
    barrier,
    batch_sharding,
    init_distributed,
    is_main_rank,
    item_table_sharding,
    main_rank_stdout,
    make_mesh,
    mesh_from_flags,
    pad_to_multiple,
    world_size,
)

__all__ = ['DATA_AXIS', 'MODEL_AXIS', 'Mesh', 'agree_max', 'all_gather',
           'all_reduce', 'barrier', 'batch_sharding', 'init_distributed',
           'is_main_rank', 'item_table_sharding', 'main_rank_stdout',
           'make_mesh', 'mesh_from_flags', 'pad_to_multiple', 'world_size']
