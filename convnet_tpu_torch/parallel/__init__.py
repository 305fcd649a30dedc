"""Data parallelism across cards and hosts (counterpart of
convnet_tpu/parallel): the ``'data'`` mesh and its collectives
(``mesh.py``), ZeRO-1 (``zero.py``). Spatial partitioning
(``parallel/spatial.py`` of the JAX package) is not ported yet
(ROADMAP.md §1 item 10)."""

from convnet_tpu_torch.parallel.mesh import (DATA_AXIS, group_mean,
                                             init_distributed,
                                             local_batch_size, make_mesh,
                                             process_batch_slice, replicate,
                                             set_bn_group)

__all__ = ["DATA_AXIS", "group_mean", "init_distributed", "local_batch_size",
           "make_mesh", "process_batch_slice", "replicate", "set_bn_group"]
