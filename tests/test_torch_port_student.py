"""Student AffinityPredictor port held against the JAX package on the CPU,
weights and BatchNorm running statistics carried across with from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.models.student import AffinityPredictor as JStudent
from geopurify_tpu.ops.sparse_conv import build_neighbor_table as j_table
from geopurify_tpu_torch.models.student import AffinityPredictor as TStudent
from geopurify_tpu_torch.ops.sparse_conv import build_neighbor_table as t_table
from geopurify_tpu_torch.utils.from_jax import student_from_jax


def _t(x):
    return torch.from_numpy(np.array(x))


def _vars(student, in_dim, seed):
    shapes = jax.eval_shape(lambda k: student.init(
        k, jnp.zeros((8, in_dim)), jnp.full((8, 27), 8, jnp.int32),
        jnp.ones(8, bool), train=False), jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if name.endswith("['var']"):
            return np.abs(x) + 0.5
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * x
        if name.endswith("['kernel']"):
            return x * (1.0 / np.sqrt(leaf.shape[-2] * (27 if x.ndim == 3 else 1)))
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.mark.parametrize("num_res_blocks", [1, 2])
def test_affinity_predictor_matches_jax(rng, num_res_blocks):
    allc = np.stack(np.meshgrid(*[np.arange(9)] * 3, indexing="ij"), -1).reshape(-1, 3)
    M = 400
    vox = allc[np.sort(rng.choice(allc.shape[0], M, replace=False))].astype(np.int32)
    valid = np.ones(M, bool)
    valid[-15:] = False
    feats = rng.normal(size=(M, 22)).astype(np.float32)
    js = JStudent(input_dim=22, hidden_dim=16, embed_dim=8, num_res_blocks=num_res_blocks)
    variables = _vars(js, 22, seed=num_res_blocks)
    nbr = j_table(jnp.asarray(vox), jnp.asarray(valid))
    ref = js.apply(jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(feats),
                   nbr, jnp.asarray(valid), train=False)
    ts = TStudent(22, 16, 8, num_res_blocks).eval()
    ts.load_state_dict(student_from_jax(variables))
    with torch.no_grad():
        got = ts(_t(feats), t_table(_t(vox), _t(valid)), _t(valid))
    ref = np.asarray(ref)
    rel = np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref))
    assert rel < 1e-5, rel
    assert np.all(got.numpy()[~valid] == 0)
