"""Meshes of processes over torch.distributed (harp_tpu/parallel/): the
frame-parallel fit of one sequence and the batch fit's sequences over
ranks, a launcher of local ranks, and the halo exchange."""

from harp_tpu_torch.parallel.halo import neighbor_shift
from harp_tpu_torch.parallel.sharding import (
    FRAME_AXIS, PER_FRAME_KEYS, SEQUENCE_AXIS, Mesh, global_batch_mesh,
    initialize_distributed, make_mesh,
)
