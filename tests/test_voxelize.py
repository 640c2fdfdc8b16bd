"""Scatter-min voxelizer vs a NumPy reference of the bit-packed min.

The renderer's voxelizer must reproduce the reference's bit-packed
distance|colour min volume (plb build_sdf_from_particles, renderer.py:
100-131, an atomic_min over each particle's neighbourhood) exactly for
every cell with an unsaturated contributor, and agree on the sdf byte
everywhere (saturated cells may differ in colour tint — docs/PARITY.md
deviation 8)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plasticinelab_tpu.config.spec import RendererSpec, SceneSpec
from plasticinelab_tpu.engine.renderer import Renderer


def _renderer(res, scale):
    # dist_scale = 0.2 * dx * 150 (Renderer.__init__)
    return Renderer(SceneSpec(renderer=RendererSpec(
        voxel_res=res, dx=scale / (0.2 * 150.0), bake_size=6)))


def _scatter_ref(p, colors, res, scale):
    """All offsets within +-7 (superset of every unsaturated contribution:
    per-axis |v - p| < 1/scale <= 5 voxels)."""
    vol = np.full(int(np.prod(res)), 0xFFFFFFFF, np.uint64)
    coord = p.astype(np.int64)
    r = np.arange(-7, 8)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3)
    idx = coord[:, None, :] + offs[None, :, :]
    ok = np.all((idx >= 0) & (idx < np.asarray(res)[None, None, :]), -1)
    dist = np.linalg.norm(
        idx.astype(np.float32) - p[:, None, :].astype(np.float32), axis=-1)
    q = np.clip(255.0 * scale * dist, 0.0, 255.0).astype(np.float32)
    packed = (q.astype(np.uint64) << 24) | colors[:, None].astype(np.uint64)
    flat = (idx[..., 0] * res[1] + idx[..., 1]) * res[2] + idx[..., 2]
    np.minimum.at(vol, flat[ok], packed[ok])
    return vol.astype(np.uint32)


def _check(got, p, colors, res, scale):
    got = np.asarray(got, np.uint32)
    want = _scatter_ref(np.asarray(p), np.asarray(colors), res, scale)
    sdf_g, sdf_w = (got >> 24).astype(np.int32), (want >> 24).astype(np.int32)
    # float rounding can flip the 8-bit truncation at a quantization
    # boundary on isolated cells; the field itself must match
    diff = np.abs(sdf_g - sdf_w)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() < 1e-3, (diff > 0).mean()
    live = (sdf_w < 255) & (diff == 0)
    np.testing.assert_array_equal(got[live], want[live])
    assert live.any()


def _compare(p, colors, res, scale):
    r = _renderer(res, scale)
    got = jax.jit(r._packed_volume)(jnp.asarray(p), jnp.asarray(colors))
    _check(got, p, colors, res, scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_cloud(seed):
    rng = np.random.default_rng(seed)
    res = (40, 40, 40)
    n = 300
    p = rng.uniform(6.0, 30.0, (n, 3)).astype(np.float32)
    colors = rng.integers(0, 1 << 24, n).astype(np.int32)
    _compare(p, colors, res, 0.2)


def test_edge_particles_and_dense_cluster():
    """Particles hugging the domain edges (out-of-range neighbours dropped)
    plus a dense cluster that piles many writes onto the same cells."""
    rng = np.random.default_rng(2)
    res = (40, 48, 40)
    edge = np.array([[0.2, 0.3, 0.1], [39.7, 47.8, 39.9], [0.1, 47.9, 20.0],
                     [39.9, 0.05, 0.02]], np.float32)
    cluster = rng.uniform(16.0, 18.0, (200, 3)).astype(np.float32)
    p = np.concatenate([edge, cluster]).astype(np.float32)
    colors = rng.integers(0, 1 << 24, len(p)).astype(np.int32)
    _compare(p, colors, res, 0.2)


def test_coarse_scale():
    """Doubled dist_scale (the half-resolution observation bake)."""
    rng = np.random.default_rng(3)
    res = (48, 40, 40)
    p = rng.uniform(5.0, 35.0, (150, 3)).astype(np.float32)
    colors = rng.integers(0, 1 << 24, 150).astype(np.int32)
    _compare(p, colors, res, 0.4)


def test_vmapped_batch():
    """Batched envs voxelize under vmap (VecPlasticineEnv rgb observations):
    each batch entry equals its own reference volume."""
    rng = np.random.default_rng(4)
    res = (32, 32, 32)
    B, n = 3, 120
    p = rng.uniform(5.0, 27.0, (B, n, 3)).astype(np.float32)
    colors = rng.integers(0, 1 << 24, (B, n)).astype(np.int32)
    r = _renderer(res, 0.4)
    got = jax.jit(jax.vmap(r._packed_volume))(jnp.asarray(p),
                                              jnp.asarray(colors))
    for b in range(B):
        _check(got[b], p[b], colors[b], res, 0.4)
