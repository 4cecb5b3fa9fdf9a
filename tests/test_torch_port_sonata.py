"""The Sonata teacher's port held against the JAX package on the CPU: the
serialization codes, the device voxelizer, and a tiny SonataTeacher in f32
and in bf16 with the weights carried across by ``sonata_from_jax``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geopurify_tpu.data.synthetic import make_scene_batch
from geopurify_tpu.models.sonata import SonataTeacher as JSonata
from geopurify_tpu.ops.morton import morton_code as j_morton
from geopurify_tpu.ops.voxelize import voxelize_points as j_voxelize
from geopurify_tpu_torch.models.sonata import SonataTeacher as TSonata
from geopurify_tpu_torch.ops.morton import morton_code as t_morton
from geopurify_tpu_torch.ops.voxelize import voxelize_points as t_voxelize
from geopurify_tpu_torch.utils.from_jax import sonata_from_jax


@pytest.mark.parametrize("order", [0, 1])
def test_morton_code_bit_exact(rng, order):
    c = rng.integers(-5, 1100, (3000, 3)).astype(np.int32)
    np.testing.assert_array_equal(t_morton(torch.from_numpy(c), order).numpy(),
                                  np.asarray(j_morton(jnp.asarray(c), order)))


@pytest.mark.parametrize("max_voxels", [400, 150])
def test_voxelize_points_exact(rng, max_voxels):
    c = rng.integers(0, 8, (500, 3)).astype(np.int32)
    valid = rng.random(500) < 0.9
    j = j_voxelize(jnp.asarray(c), jnp.asarray(valid), max_voxels)
    t = t_voxelize(torch.from_numpy(c), torch.from_numpy(valid), max_voxels)
    for name in ("voxel_coords", "point2voxel", "voxel_valid", "num_voxels"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), err_msg=name)


def _scene():
    b = make_scene_batch(seed=5, n_points=700, n_views=1, max_points=768,
                         max_voxels=640, max_view_points=64)
    M = b.voxel_coords.shape[0]
    p2v = jnp.where(b.point_valid, b.point2voxel, M)
    return (b.geom_feats, b.voxel_coords, b.voxel_valid, p2v, b.point_valid)


TINY = dict(enc_depths=(1, 1, 1), enc_channels=(8, 16, 24), enc_num_head=(2, 4, 4),
            enc_patch_size=(32, 32, 32))


def _variables(stem, seed):
    """Random weights in the JAX SonataTeacher's tree (its eager init draws
    its truncated normals slowly on the CPU): kernels at a He-like scale,
    norm scales near 1, small non-zero biases."""
    js = JSonata(**TINY, stem_kernel=stem)
    shapes = jax.eval_shape(js.init, jax.random.key(0), *_scene())
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=leaf.shape).astype(np.float32)
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * x
        if name.endswith("['bias']"):
            return 0.1 * x
        fan_in = int(np.prod(leaf.shape[:-1]))
        return x * np.sqrt(2.0 / fan_in)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def weights():
    return {stem: _variables(stem, seed=stem) for stem in (3, 5)}


def _pair(variables, stem, jdtype, tdtype):
    js = JSonata(**TINY, stem_kernel=stem, dtype=jdtype)
    args = _scene()
    ts = TSonata(**TINY, stem_kernel=stem, dtype=tdtype)
    sd = sonata_from_jax(variables)
    assert set(sd) == set(ts.state_dict())       # no missing, no unexpected keys
    ts.load_state_dict(sd)
    # jitted, as the JAX pipeline runs its teacher (pipeline._sonata_fwd)
    apply = jax.jit(js.apply)
    ref = np.asarray(apply(jax.tree_util.tree_map(jnp.asarray, variables), *args), np.float32)
    with torch.inference_mode():
        got = ts(*(torch.from_numpy(np.array(a)) for a in args)).numpy()
    assert got.shape == ref.shape == (768, ts.out_channels)
    return got, ref


@pytest.mark.parametrize("stem", [3, 5])
def test_sonata_teacher_f32_matches_jax(weights, stem):
    got, ref = _pair(weights[stem], stem, jnp.float32, torch.float32)
    assert np.abs(ref).max() > 0.1
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-5, rel


def test_sonata_teacher_bf16_matches_jax(weights):
    got, ref = _pair(weights[5], 5, jnp.bfloat16, torch.bfloat16)
    # both run bf16 activations with f32 logits, norms and conv sums; they
    # round at other places (GELU, matmul outputs), a few bf16 ulps (2^-8)
    # through 3 blocks and 2 poolings
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 3e-2 * scale
    assert np.abs(got - ref).mean() < 3e-3 * scale
