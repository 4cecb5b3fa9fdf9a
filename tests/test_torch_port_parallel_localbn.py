"""The data-parallel Stage-1 step with ``parallel.sync_batchnorm=false``
(each rank's BatchNorm moments its own, the running statistics averaged
after the step) held against JAX's at dp=2; see
``tests/test_torch_port_parallel.py``."""

from tests.test_torch_port_parallel import check_dp_step


def test_dp_step_with_local_bn_matches_jax_at_dp2():
    check_dp_step(sync=False)
