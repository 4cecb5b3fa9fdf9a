"""Session settings for the test suite run in parallel workers.

Under pytest-xdist every worker is a process of its own, and torch sizes its
intra-op pool to every core: n workers on c cores run n x c OpenMP threads,
which spin between ops and starve each other and the workers running JAX.
Each worker's torch gets its share of the cores instead, the rule
``geopurify_tpu_torch.parallel.mesh`` applies to gloo ranks. A run in one
process keeps torch's default.
"""

import os


def pytest_configure(config):
    workerinput = getattr(config, "workerinput", None)
    if workerinput is None:
        return
    import torch

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workerinput["workercount"]))
