"""Data parallelism and within-scene view parallelism over torch.distributed.

Port of geopurify_tpu/parallel/: the reference's only distribution strategy
is DDP + SyncBN + an eval all-reduce. Here a rank is one process driving
one device (NCCL between cards, gloo on the CPU or for ranks sharing one
card): Stage-1 gradients, running statistics and loss are averaged over
the ranks and the BatchNorm moments summed (``run/train.py``), Stage-2
histograms summed (``utils/metrics.py``), and one scene's views split
over the ranks (``view_parallel.sharded_lift_scene``).
"""

from geopurify_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    init_distributed,
    make_mesh,
    scene_index,
    spawn,
    world,
)
