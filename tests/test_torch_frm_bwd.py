"""K2's backward in its ordered plain form (``frm_sample_levels_bwd_ordered``,
the yardstick the card's kernel equals bit for bit), on the CPU:

- against an explicit Python loop that sums each corner row's
  contributions in ascending id e = ((cell * P) + q) * 4 + k, with the
  chunk rule for long rows (a tiny chunk, so the collide scene exercises
  it), the contributions from ``bwd_contributions``: tiny levels, points 1
  and 5, the transposed-coordinate quirk on and off, -0.0 gradients, 8
  channels and 40 (two of the 32-channel chunks it works in);
- against JAX's ``jax.vjp`` of ``feature_refine_sample`` in f32, a level at
  a time (atol 1e-5, 2e-5 for the five-point sum, as the plain backward's
  own JAX test);
- against the autograd backward (``frm_sample_levels_bwd_reference``)
  within ``frm_bwd_error``'s bound: one bf16 ulp of the f32 backward plus
  2^-14 of the summed magnitudes.

Inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from r3det_tpu.models.frm import feature_refine_sample as j_frs
from r3det_tpu_torch.ops import frm_sample as K2

from test_torch_kernels_gpu import colliding_rois, frm_bwd_error, frm_levels

torch.set_num_threads(2)

# five tiny levels: 6 x 5 .. 1 x 1 (strides 8 .. 128), 8 channels
TINY = ((6, 5), (3, 3), (2, 2), (1, 1), (1, 1))
# the levels of the plain backward's JAX test (test_torch_ops.FRM_SIZES)
SMALL = ((16, 16), (8, 8), (4, 4), (2, 2), (1, 1))


def scene(seed, scene_kind, sizes=TINY, c=8, dtype=torch.bfloat16):
    """(grads, rois, scales) on the CPU: rois near their cells, on edges,
    far off and outside (frm_levels; 'wide': with 40 channels), or every
    cell on one corner (colliding_rois); a tenth of the gradients -0.0."""
    rng = np.random.RandomState(seed)
    c = 40 if scene_kind == 'wide' else c
    _, feats, rois, scales = frm_levels(rng, 2, sizes, c, 'cpu', dtype)
    if scene_kind == 'collide':
        rois = [torch.from_numpy(r) for r in colliding_rois(rng, 2, sizes)]
    grads = []
    for f in feats:
        g = rng.randn(*f.shape).astype(np.float32)
        g[rng.uniform(size=g.shape) < 0.1] = -0.0
        grads.append(torch.from_numpy(g).to(dtype))
    return grads, rois, scales


def ordered_loop(grads, rois, scales, points, quirk, chunk):
    """The backward's definition, one contribution at a time: each corner
    row's products w * g_cell in ascending e, chunks of ``chunk`` from +0.0
    each, their sums in order from +0.0; dfeat = g + acc."""
    trig = K2.angle_trig(rois) if points == 5 else None
    out, begin = [], 0
    for g, r, s in zip(grads, rois, scales):
        b, h, w, c = g.shape
        n = b * h * w
        t = None if trig is None else \
            trig[:, begin:begin + n].reshape(2, b, h * w)
        begin += n
        key, wt = K2.bwd_contributions(r, s, h, w, points, quirk, t)
        rows = {}
        for e in np.flatnonzero(key.numpy() >= 0):
            rows.setdefault(int(key[e]), []).append(int(e))
        flat = g.reshape(n, c).float()
        acc = torch.zeros(n, c)
        for row, ids in rows.items():
            total = torch.zeros(c)
            for j in range(0, len(ids), chunk):
                part = torch.zeros(c)
                for e in ids[j:j + chunk]:
                    part = part + wt[e] * flat[e // (4 * points)]
                total = total + part
            acc[row] = total
        out.append((flat + acc).to(g.dtype).reshape(g.shape))
    return out


def bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else \
        t.view(torch.int32)


@pytest.mark.parametrize('scene_kind', ['near', 'collide', 'wide'])
@pytest.mark.parametrize('quirk', [True, False])
@pytest.mark.parametrize('points', [1, 5])
def test_ordered_backward_is_the_ordered_loop(points, quirk, scene_kind):
    grads, rois, scales = scene(3 + points + 2 * quirk, scene_kind)
    chunk = 3
    got = K2.frm_sample_levels_bwd_ordered(grads, rois, scales, points,
                                           quirk, chunk=chunk)
    want = ordered_loop(grads, rois, scales, points, quirk, chunk)
    for k, w in zip(got, want):
        assert torch.equal(bits(k), bits(w))
    if scene_kind == 'collide':
        # rows longer than the chunk, so the chunk rule ran
        b, h, w, _ = grads[0].shape
        key, _ = K2.bwd_contributions(rois[0], scales[0], h, w, points,
                                      quirk)
        assert int(torch.bincount(key[key >= 0]).max()) > chunk


@pytest.mark.parametrize('quirk', [True, False])
@pytest.mark.parametrize('points', [1, 5])
def test_ordered_backward_matches_jax_vjp(points, quirk):
    """f32: against JAX's autodiff of feature_refine_sample, a level at a
    time."""
    grads, rois, scales = scene(10 + points + quirk, 'near', SMALL, 32,
                                torch.float32)
    got = K2.frm_sample_levels_bwd_ordered(grads, rois, scales, points,
                                           quirk)
    for d, g, r, s in zip(got, grads, rois, scales):
        _, vjp = jax.vjp(lambda v: j_frs(v, jnp.asarray(r.numpy()), s,
                                         points, quirk),
                         jnp.zeros(g.shape, jnp.float32))
        want = np.asarray(vjp(jnp.asarray(g.numpy()))[0])
        np.testing.assert_allclose(d.numpy(), want, rtol=0,
                                   atol=1e-5 if points == 1 else 2e-5)


@pytest.mark.parametrize('scene_kind', ['near', 'collide'])
@pytest.mark.parametrize('quirk', [True, False])
@pytest.mark.parametrize('points', [1, 5])
def test_ordered_backward_within_autograd_bound(points, quirk, scene_kind):
    """bf16: within one bf16 ulp + 2^-14 of the summed magnitudes of the
    f32 autograd backward (the bound the card's kernel was held to)."""
    grads, rois, scales = scene(20 + points + 2 * quirk, scene_kind, SMALL,
                                32)
    got = K2.frm_sample_levels_bwd_ordered(grads, rois, scales, points,
                                           quirk)
    excess, _, _ = frm_bwd_error(got, grads, rois, scales, points, quirk)
    assert excess <= 0.0
