"""FRM bilinear sample: the plain PyTorch form and the CUDA kernel (K2).

Port of ``r3det_tpu/models/frm.py::bilinear_sample`` and of the points=1
path of ``feature_refine_sample``, and of the TPU kernel
``r3det_tpu/ops/frm_sample.py::bilinear_sample_band``, whose CUDA
counterpart is ``csrc/frm_sample.cu``. One kernel replaces both TPU
routes: it reads each cell's 4 corner rows directly, so it needs neither
the band kernel's stencil window nor its outlier correction.

The fused op of one pyramid level is ``x + (feat + sample)``: ``feat`` is
the FRM branch-conv output, ``sample`` its bilinear sample at each cell's
best-box centre with the reference's transposed-coordinate quirk (row <-
cx * scale, col <- cy * scale). Corner weights stay f32 (JAX's gather
rounded them to ``feat``'s dtype; the band kernel kept f32); the sample is
rounded to ``feat``'s dtype before each residual add.
"""
import torch

from .. import _ext


def bilinear_sample(feat, py, px):
    """Bilinear sample of ``feat`` (B, H, W, C) at fractional (row, col)
    points ``py``, ``px`` (B, N) -> (B, N, C) in ``feat``'s dtype.

    Points outside (-1, H) x (-1, W) give 0; inside, coordinates clamp to
    the map (the reference's bilinear_interpolate boundary rule). Weights
    and sums are f32.
    """
    b, h, w, c = feat.shape
    py = py.float()
    px = px.float()
    inside = (py > -1.0) & (py < h) & (px > -1.0) & (px < w)
    py = py.clamp(0.0, h - 1.0)
    px = px.clamp(0.0, w - 1.0)
    y0 = py.floor().long()
    x0 = px.floor().long()
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    ly = py - y0
    lx = px - x0
    hy, hx = 1.0 - ly, 1.0 - lx
    flat = feat.reshape(b, h * w, c)

    def corner(yy, xx):
        idx = (yy * w + xx)[..., None].expand(-1, -1, c)
        return flat.gather(1, idx).float()

    val = ((hy * hx)[..., None] * corner(y0, x0)
           + (hy * lx)[..., None] * corner(y0, x1)
           + (ly * hx)[..., None] * corner(y1, x0)
           + (ly * lx)[..., None] * corner(y1, x1))
    val = torch.where(inside[..., None], val, torch.zeros_like(val))
    return val.to(feat.dtype)


def sample_coords(rois, spatial_scale, transpose_quirk=True):
    """(row, col) sample points (B, H*W) of the rois' centres on a level."""
    cx = rois[..., 0] * spatial_scale
    cy = rois[..., 1] * spatial_scale
    return (cx, cy) if transpose_quirk else (cy, cx)


def frm_sample_reference(x, feat, rois, spatial_scale, transpose_quirk=True):
    """Plain version of :func:`frm_sample`: ``x + (feat + sample)``."""
    b, h, w, c = feat.shape
    row, col = sample_coords(rois, spatial_scale, transpose_quirk)
    val = bilinear_sample(feat, row, col).reshape(b, h, w, c)
    return x + (feat + val)


def frm_sample_cuda(x, feat, rois, spatial_scale, transpose_quirk=True):
    """Launch the K2 kernel (``csrc/frm_sample.cu``) on CUDA tensors."""
    for name, t in (('x', x), ('feat', feat)):
        if not t.is_cuda or t.dim() != 4 or t.dtype != torch.bfloat16 \
                or t.shape != feat.shape or not t.is_contiguous() \
                or t.device != feat.device:
            raise ValueError(f'{name} must be a contiguous NHWC bfloat16 '
                             f'CUDA tensor of feat\'s shape, got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')
    b, h, w, c = feat.shape
    if rois.dtype != torch.float32 or tuple(rois.shape) != (b, h * w, 5) \
            or not rois.is_contiguous() or rois.device != feat.device:
        raise ValueError(f'rois must be a contiguous (B, H*W, 5) float32 '
                         f'tensor on feat\'s device, got {rois.dtype} '
                         f'{tuple(rois.shape)}')
    out = torch.empty_like(feat)
    _ext.launch('frm_sample', x.data_ptr(), feat.data_ptr(), rois.data_ptr(),
                out.data_ptr(), b, h, w, c, float(spatial_scale),
                int(bool(transpose_quirk)), _ext.current_stream(feat.device))
    return out


def frm_sample(x, feat, rois, spatial_scale, transpose_quirk=True):
    """FRM points=1 refinement of one level: ``x + (feat + sample)``.

    x, feat: (B, H, W, C) NHWC; rois: (B, H*W, 5) f32 best boxes in image
    coordinates; ``spatial_scale`` = 1 / stride. CPU tensors take the plain
    form; CUDA tensors launch the kernel, which takes bfloat16 only.
    """
    if feat.is_cuda:
        return frm_sample_cuda(x, feat, rois, spatial_scale, transpose_quirk)
    return frm_sample_reference(x, feat, rois, spatial_scale, transpose_quirk)
