"""The extras against the JAX package on the CPU: the image gradients, the
spherical derivatives, splatting and DIBR, pano_stretch (its tables, its
forward and VJP through the port's quad blend), the normals, gather_blend,
the SSIM, photometric and smoothness losses, chamfer, and the writer of
upstream ``.pth`` state dicts.

Inputs come from a numpy seed at 32x64 and 64x128, batch 2, f32. The
tolerances, each stated where it is used:

- f32 elementwise functions: rtol 1e-5, atol 1e-6 (the two packages'
  transcendental functions and sums differ in the last bits);
- functions that scatter, sum windows or fit (splat, render, the normals,
  SSIM): atol 1e-5 (sums in another order); DIBR 4e-5, and the plane fit
  and SSIM also in float64, for the reasons stated at their tests;
- pano_stretch: forward atol 1e-6 (the same tables bit for bit; four
  products of inputs in [0, 1) with weights summing to at most 1), VJP atol
  1e-5 (up to tens of products per source pixel);
- the writer: bit for bit.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnifusion_tpu.evaluation as jax_evaluation
import omnifusion_tpu.losses as jax_losses
import omnifusion_tpu.ops as jax_ops
from omnifusion_tpu.geometry.sphere import create_image_grid, create_spherical_grid
from omnifusion_tpu.models import SphericalFusion as JaxSphericalFusion
from omnifusion_tpu.models import SphericalFusionIterative as JaxIterative
from omnifusion_tpu.models import torch_export as jax_export
from omnifusion_tpu.ops import depth2normal as jax_d2n
from omnifusion_tpu.ops import derivatives as jax_D
from omnifusion_tpu.ops import gradients as jax_gradients
from omnifusion_tpu.ops import sparse_blend as jax_sparse_blend
from omnifusion_tpu.ops import splatting as jax_splatting
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec

import omnifusion_torch.evaluation as evaluation
import omnifusion_torch.losses as losses
import omnifusion_torch.ops as ops
from omnifusion_torch.models import SphericalFusion, SphericalFusionIterative, state_dict_from_jax
from omnifusion_torch.models import torch_export
from omnifusion_torch.models.torch_import import import_checkpoint
from omnifusion_torch.ops import depth2normal, derivatives as D, gradients
from omnifusion_torch.ops.quad_blend import gather_blend
from omnifusion_torch.projection import ProjectionSpec

# the packages' ops/__init__.py bind the name pano_stretch to the function
jax_stretch = importlib.import_module("omnifusion_tpu.ops.pano_stretch")
stretch = importlib.import_module("omnifusion_torch.ops.pano_stretch")

B = 2
SIZES = ((32, 64), (64, 128))
F32_TOL = dict(rtol=1e-5, atol=1e-6)  # elementwise
SCATTER_TOL = dict(rtol=0, atol=1e-5)  # scatters, fits


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # the suite runs in several worker processes at once
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _rand(seed, *shape, lo=0.0, hi=1.0):
    return (np.random.default_rng(seed).random(shape) * (hi - lo) + lo).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(ours, theirs, equal_nan=False, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(theirs), equal_nan=equal_nan,
                               **tol)


def _smooth_depth(seed, h, w, lo=1.0, hi=8.0):
    """(B, H, W, 1) smooth depth in [lo, hi]: low-frequency cosines."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    d = sum(rng.random() * np.cos(2 * np.pi * (rng.integers(1, 4) * x + rng.integers(0, 3) * y)
                                  + rng.random() * 6) for _ in range(4))
    d = np.stack([d + 0.3 * rng.random() * np.sin(2 * np.pi * (x + y)) for _ in range(B)])
    d = (d - d.min()) / (d.max() - d.min())
    return (lo + (hi - lo) * d)[..., None].astype(np.float32)


def _grids(h, w):
    """The DIBR grids: the image grid (u, v) and the spherical grid (phi,
    theta), (B, H, W, 2) f32."""
    uv = np.broadcast_to(create_image_grid(w, h), (B, h, w, 2)).astype(np.float32)
    sg = np.broadcast_to(create_spherical_grid(w), (B, h, w, 2)).astype(np.float32)
    return uv, sg


# ---- ops/gradients.py ----

@pytest.mark.parametrize("name", ["dI_du", "dI_dv", "dI_duv", "imgrad", "imgrad_yx"])
def test_gradients_match_jax(name):
    h, w = SIZES[0]
    img = _rand(0, B, h, w, 3)
    ours = getattr(gradients, name)(_t(img))
    theirs = getattr(jax_gradients, name)(jnp.asarray(img))
    for o, t in zip(*((ours, theirs) if name == "imgrad" else ((ours,), (theirs,)))):
        assert o.shape == t.shape
        _close(o, t, **F32_TOL)


def test_gradient_kernels_equal_jax():
    for ours, theirs in ((gradients.get_sobel_kernel(3), jax_gradients.get_sobel_kernel(3)),
                         (gradients.get_sobel_kernel(5), jax_gradients.get_sobel_kernel(5)),
                         (gradients.gaussian_kernel_1d(7, 1.5),
                          jax_gradients.gaussian_kernel_1d(7, 1.5)),
                         (gradients.gaussian_kernel_3d(5, 1.2),
                          jax_gradients.gaussian_kernel_3d(5, 1.2)),
                         (gradients.SOBEL_X, jax_gradients.SOBEL_X),
                         (gradients.SOBEL_Y, jax_gradients.SOBEL_Y)):
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


# ---- ops/derivatives.py: all 16 functions, by their arguments ----

DERIVATIVES = {
    "sgrid": ("dr_dx", "dphi_dx", "dtheta_dx", "dtheta_dy", "dr_horizontal"),
    "depth": ("dphi_horizontal_clip", "dphi_horizontal", "dtheta_horizontal",
              "dtheta_horizontal_clip", "dtheta_vertical"),
    "disparity": ("disparity_to_depth_theta", "disparity_to_depth_vertical"),
    "pcloud": ("dV_dx", "dV_dy", "dV_dz", "dV_dxyz"),
}


@pytest.mark.parametrize("group", sorted(DERIVATIVES))
def test_derivatives_match_jax(group):
    h, w = SIZES[1]
    _, sg = _grids(h, w)
    depth = _smooth_depth(1, h, w)
    depth[0, 5, 7:12] = 0.0  # divisions by zero: inf and NaN, cleaned where JAX cleans
    baseline = 0.26
    for name in DERIVATIVES[group]:
        if group == "sgrid":
            args = (sg, baseline) if name == "dr_horizontal" else (sg,)
        elif group == "pcloud":
            args = (_rand(2, B, h, w, 3, lo=-4.0, hi=4.0),)
        else:
            args = (sg, depth, baseline)
        ours = getattr(D, name)(*(_t(a) if isinstance(a, np.ndarray) else a for a in args))
        theirs = getattr(jax_D, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                        for a in args))
        assert ours.shape == theirs.shape, name
        # only dtheta_horizontal_clip and disparity_to_depth_vertical keep NaN or inf
        _close(ours, theirs, equal_nan=True, err_msg=name, **F32_TOL)


def test_dtheta_horizontal_clip_keeps_nan():
    h, w = SIZES[0]
    _, sg = _grids(h, w)
    depth = _smooth_depth(3, h, w)
    depth[1, 3, 4] = np.nan
    ours = D.dtheta_horizontal_clip(_t(sg), _t(depth), 0.26)
    theirs = jax_D.dtheta_horizontal_clip(jnp.asarray(sg), jnp.asarray(depth), 0.26)
    assert torch.isnan(ours[1, 3, 4]).all() and np.isnan(np.asarray(theirs)[1, 3, 4]).all()
    _close(ours, theirs, equal_nan=True, **F32_TOL)
    assert not torch.isnan(D.dphi_horizontal_clip(_t(sg), _t(depth), 0.26)).any()  # cleaned


# ---- ops/splatting.py: forward and VJP (values and coordinates) ----

def _splat_coords(case, h, w):
    rng = np.random.default_rng({"inside": 4, "outside": 5, "integer": 6}[case])
    uv, _ = _grids(h, w)
    if case == "inside":
        return (uv + rng.uniform(-0.9, 0.9, uv.shape)).clip(0, [w - 1, h - 1]).astype(np.float32)
    if case == "outside":  # corners past every border, and whole samples off the image
        return (uv * [1.2, 1.3] + rng.uniform(-4, 4, uv.shape) - [3, 2]).astype(np.float32)
    # integer coordinates, and fractions around the 1e-3 weight threshold
    frac = rng.choice([0.0, 5e-4, 9e-4, 1.1e-3, 2e-3, 0.999, 0.9995], size=uv.shape)
    return (uv + frac).astype(np.float32)


@pytest.mark.parametrize("case", ["inside", "outside", "integer"])
def test_splat_and_its_vjp_match_jax(case):
    h, w = SIZES[0]
    values = _rand(7, B, h, w, 3)
    coords = _splat_coords(case, h, w)
    cot = _rand(8, B, h, w, 3)
    theirs, vjp = jax.vjp(lambda v, c: jax_splatting.splat(v, c, (h, w)), jnp.asarray(values),
                          jnp.asarray(coords))
    g_values, g_coords = vjp(jnp.asarray(cot))
    v, c = _t(values).requires_grad_(), _t(coords).requires_grad_()
    ours = ops.splat(v, c, (h, w))
    ours.backward(_t(cot))
    _close(ours, theirs, **SCATTER_TOL)
    _close(v.grad, g_values, **SCATTER_TOL)
    _close(c.grad, g_coords, **SCATTER_TOL)
    if case == "integer":  # the threshold drops corners: some target gets less than 1
        assert (ours.detach().sum() < values.sum() - 1.0).item()


def test_render_matches_jax():
    h, w = SIZES[1]
    img, depth = _rand(9, B, h, w, 3), _smooth_depth(10, h, w)
    coords = _splat_coords("outside", h, w)
    ours, ours_mask = ops.render(_t(img), _t(depth), _t(coords), max_depth=8.0)
    theirs, their_mask = jax_splatting.render(jnp.asarray(img), jnp.asarray(depth),
                                              jnp.asarray(coords), max_depth=8.0)
    _close(ours, theirs, **SCATTER_TOL)
    assert np.array_equal(ours_mask.numpy(), np.asarray(their_mask))
    assert 0 < ours_mask.float().mean() < 1
    _close(ops.depth_distance_weights(_t(depth)), jax_splatting.depth_distance_weights(
        jnp.asarray(depth)), **F32_TOL)


# ---- ops/dibr.py ----

@pytest.mark.parametrize("direction", ["vertical", "horizontal"])
def test_dibr_matches_jax(direction):
    h, w = SIZES[1]
    uv, sg = _grids(h, w)
    depth, img = _smooth_depth(11, h, w), _rand(12, B, h, w, 3)
    # a negative baseline moves the left columns left, across the seam into
    # negative u, which the floor modulo brings back at the right edge
    baseline = 0.26 if direction == "vertical" else -0.26
    if direction == "horizontal":
        u = uv[..., 0] + np.asarray(jax_D.dphi_horizontal_clip(sg, depth, baseline))[..., 0]
        assert (u < 0).any()
    fn = "dibr_" + direction
    ours = getattr(ops, fn)(_t(depth), _t(img), _t(uv), _t(sg), baseline)
    theirs = getattr(jax_ops, fn)(*(jnp.asarray(a) for a in (depth, img, uv, sg)), baseline)
    assert ours.shape == (B, h, w, 3)
    # the disparities differ by the packages' sin and cos: one f32 ulp of a
    # u near 128 (7.6e-6) at a tenth of the pixels. That moves a bilinear
    # weight by as much, and the render by up to that over the weight sum
    # (above 0.2 here) times the neighbours' difference (below 1): 4e-5
    _close(ours, theirs, rtol=0, atol=4e-5)
    # the scatter itself, at the same coordinates: the scatter tolerance
    disp = [jax_D.dtheta_vertical(sg, depth, baseline)] if direction == "vertical" else [
        jax_D.dphi_horizontal_clip(sg, depth, baseline),
        jax_D.dtheta_horizontal_clip(sg, depth, baseline)]
    coords = uv + np.concatenate([np.zeros_like(depth)] * (2 - len(disp)) + disp, -1)
    coords[..., 0] = np.mod(coords[..., 0] + w, w) if direction == "horizontal" else coords[..., 0]
    _close(ops.render(_t(img), _t(depth), _t(coords), max_depth=8.0)[0], theirs, **SCATTER_TOL)


# ---- ops/pano_stretch.py: the tables bit for bit, forward and VJP ----

STRETCH_CASES = [((64, 128), 1.3, 0.8), ((32, 64), 1.0, 1.0), ((64, 128), 0.7, 1.5)]


@pytest.mark.parametrize("size,kx,ky", STRETCH_CASES)
def test_stretch_tables_equal_jax(size, kx, ky):
    ours = stretch._stretch_tables(*size, kx, ky)
    theirs = jax_stretch._stretch_tables(*size, kx, ky)
    for o, t in zip(ours, theirs):
        assert o.dtype == t.dtype and o.shape == t.shape and np.array_equal(o, t)


@pytest.mark.parametrize("size,kx,ky", STRETCH_CASES)
def test_pano_stretch_and_its_vjp_match_jax(size, kx, ky):
    h, w = size
    img, cot = _rand(13, B, h, w, 3), _rand(14, B, h, w, 3)
    theirs, vjp = jax.vjp(lambda x: jax_stretch.pano_stretch(x, kx, ky), jnp.asarray(img))
    x = _t(img).requires_grad_()
    ours = ops.pano_stretch(x, kx, ky)
    ours.backward(_t(cot))
    assert ours.shape == img.shape and ours.dtype == torch.float32
    _close(ours, theirs, rtol=0, atol=1e-6)
    _close(x.grad, vjp(jnp.asarray(cot))[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_pano_stretch_16_bit_is_nearer_f32_than_jax(dtype):
    # the JAX XLA path sums in the source dtype; the port keeps the f32 sums
    # and rounds once. Each value is nearer to the f32 result (of the same
    # 16-bit input) than the JAX one, or within one ulp of it
    h, w = SIZES[1]
    img16 = torch.from_numpy(_rand(15, B, h, w, 3)).to(getattr(torch, dtype))
    ours = ops.pano_stretch(img16, 1.3, 0.8)
    assert ours.dtype == img16.dtype
    theirs = np.asarray(jax_stretch.pano_stretch(
        jnp.asarray(img16.float().numpy()).astype(dtype), 1.3, 0.8).astype(jnp.float32))
    ref = ops.pano_stretch(img16.float(), 1.3, 0.8).numpy()
    ours = ours.float().numpy()
    ulp = np.spacing(np.abs(theirs).astype(np.float32)) * 2.0 ** (16 if dtype == "bfloat16" else 13)
    ok = (np.abs(ours - ref) <= np.abs(theirs - ref)) | (np.abs(ours - theirs) <= ulp)
    assert ok.all(), np.argwhere(~ok)[:5]


# ---- ops/depth2normal.py ----

def test_depth_to_points_and_sphere_rays_equal_jax():
    for h, w in SIZES:
        # the port's rays are utils/ply.py's, bit for bit the JAX _sphere_xyz
        ours = depth2normal._sphere_xyz(h, w, torch.device("cpu")).numpy()
        assert ours.dtype == np.float32 and np.array_equal(ours, jax_d2n._sphere_xyz(h, w))
    depth = _smooth_depth(16, *SIZES[0])
    _close(ops.depth_to_points(_t(depth)), jax_d2n.depth_to_points(jnp.asarray(depth)),
           **F32_TOL)


@pytest.mark.parametrize("curvature", [False, True])
def test_normals_cross_matches_jax(curvature):
    depth = _smooth_depth(17, *SIZES[1])
    ours = ops.normals_cross(_t(depth), return_curvature=curvature)
    theirs = jax_d2n.normals_cross(jnp.asarray(depth), return_curvature=curvature)
    for o, t in zip(*((ours, theirs) if curvature else ((ours,), (theirs,)))):
        assert o.shape == t.shape
        _close(o, t, **SCATTER_TOL)


def _plane_fit_f64(depth):
    """normals_plane_fit of both packages in float64."""
    with jax.enable_x64(True):
        theirs = np.asarray(jax_d2n.normals_plane_fit(jnp.asarray(depth.astype(np.float64))))
    return ops.normals_plane_fit(_t(depth).double()), theirs


def test_normals_plane_fit_matches_jax():
    # float64: the same fit to float64 rounding, at the scatter tolerance. In
    # f32 a neighbourhood's Gram matrix is ill-conditioned (its rays span a
    # few degrees), so both packages' normals lie up to ~6e-5 from the
    # float64 ones, each with its own rounding: the port's distance from
    # float64 is held to 1.5x the JAX package's (largest and median)
    depth = _smooth_depth(18, *SIZES[0])
    ours64, theirs64 = _plane_fit_f64(depth)
    assert ours64.shape == (B, *SIZES[0], 3)
    _close(ours64, theirs64, **SCATTER_TOL)
    ours = ops.normals_plane_fit(_t(depth)).double()
    theirs = torch.from_numpy(np.array(jax_d2n.normals_plane_fit(jnp.asarray(depth)))).double()
    ours_err = (ours - ours64).abs().amax(-1)
    their_err = (theirs - ours64).abs().amax(-1)
    assert ours_err.max() <= 1.5 * their_err.max(), (ours_err.max(), their_err.max())
    assert ours_err.median() <= 1.5 * their_err.median(), (ours_err.median(), their_err.median())


def test_normals_plane_fit_takes_the_identity_on_a_flat_patch():
    # depth 0 on a patch: its neighbourhoods' points are all 0 and their
    # Gram matrices singular (det 0 < 1e-5), so the fit falls back to the
    # identity: the normal of the summed points, 0 / eps -> 0 at the centre.
    # Float64: at the patch's border a neighbourhood holds a few points, and
    # in f32 the determinant of their rank-deficient Gram matrix is rounding
    # noise (~1e-7 of entries up to 1e3, cubed), which either package may put
    # on either side of 1e-5
    h, w = SIZES[0]
    depth = _smooth_depth(19, h, w)
    depth[:, 8:24, 16:40] = 0.0
    pts = depth2normal.depth_to_points(_t(depth).double())
    a = torch.nn.functional.unfold(pts.permute(0, 3, 1, 2), 5, dilation=2, padding=4)
    a = a.reshape(B, 3, 25, h, w).permute(0, 3, 4, 2, 1)
    _, det = depth2normal._inv3x3(a.transpose(-1, -2) @ a)
    assert (det[:, 12:20, 20:36] == 0).all()
    ours, theirs = _plane_fit_f64(depth)
    _close(ours, theirs, **SCATTER_TOL)
    for n in (ours, ops.normals_plane_fit(_t(depth))):
        assert (n[:, 12:20, 20:36] == 0).all()
        assert ((n.norm(dim=-1) - 1).abs() < 1e-5).float().mean() > 0.75


def test_unfold_feature_order_is_conv_general_dilated_patches():
    # channel-major (C, kh, kw) features, dilation 2, padding k - 1, on
    # distinct channels
    h, w = SIZES[0]
    x = _rand(20, B, h, w, 3) + np.arange(3, dtype=np.float32) * 10
    theirs = jax.lax.conv_general_dilated_patches(
        jnp.asarray(x), filter_shape=(5, 5), window_strides=(1, 1), padding=((4, 4), (4, 4)),
        rhs_dilation=(2, 2), dimension_numbers=("NHWC", "HWIO", "NHWC"))
    ours = torch.nn.functional.unfold(_t(x).permute(0, 3, 1, 2), 5, dilation=2, padding=4)
    _close(ours.reshape(B, 75, h, w).permute(0, 2, 3, 1), theirs, rtol=0, atol=0)


# ---- gather_blend (sparse_blend.py:165) ----

def test_gather_blend_matches_jax():
    rng = np.random.default_rng(21)
    src = _rand(22, B, 500, 3)
    idx = rng.integers(0, 500, size=(300, 5)).astype(np.int32)
    wts = _rand(23, 300, 5)
    wts[rng.random((300, 5)) < 0.3] = 0.0
    ours = gather_blend(_t(src), _t(idx), _t(wts))
    theirs = jax_sparse_blend.gather_blend(jnp.asarray(src), jnp.asarray(idx), jnp.asarray(wts))
    assert ours.shape == (B, 300, 3)
    _close(ours, theirs, **F32_TOL)


# ---- losses ----

@pytest.mark.parametrize("mode", ["gaussian", "box"])
def test_ssim_matches_jax(mode):
    h, w = SIZES[1]
    pred, gt = _rand(24, B, h, w, 3), _rand(25, B, h, w, 3)
    for k in (3, 7):
        ours = losses.ssim_loss(_t(pred), _t(gt), kernel_size=k, mode=mode)
        theirs = jax_losses.ssim_loss(jnp.asarray(pred), jnp.asarray(gt), kernel_size=k, mode=mode)
        assert ours.shape == (B, h, w, 3)
        # window sums of up to 49 terms in another order, and E[x^2] - E[x]^2
        # cancels: each package lies ~4e-6 from float64, so the sums' atol
        _close(ours, theirs, **SCATTER_TOL)
        with jax.enable_x64(True):  # float64: the same map to float64 rounding
            theirs = jax_losses.ssim_loss(*(jnp.asarray(a.astype(np.float64)) for a in (pred, gt)),
                                          kernel_size=k, mode=mode)
        _close(losses.ssim_loss(_t(pred).double(), _t(gt).double(), kernel_size=k, mode=mode),
               theirs, rtol=0, atol=1e-12)
    fn = "ssim_gaussian" if mode == "gaussian" else "ssim_box"
    _close(getattr(losses, fn)(_t(pred), _t(gt)), getattr(jax_losses, fn)(
        jnp.asarray(pred), jnp.asarray(gt)), **SCATTER_TOL)


def test_ssim_loss_refuses_an_unknown_mode():
    x = torch.zeros(1, 8, 8, 1)
    with pytest.raises(ValueError, match="unknown ssim mode 'median'"):
        losses.ssim_loss(x, x, mode="median")


@pytest.mark.parametrize("mode,weighted", [("gaussian", False), ("box", True)])
def test_photometric_loss_matches_jax(mode, weighted):
    h, w = SIZES[1]
    pred, gt = _rand(26, B, h, w, 3), _rand(27, B, h, w, 3)
    mask = _rand(28, B, h, w, 1) > 0.2
    weights = _rand(29, B, h, w, 1) if weighted else None
    params = losses.PhotometricLossParameters(ssim_mode=mode)
    jax_params = jax_losses.PhotometricLossParameters(ssim_mode=mode)
    assert params == losses.PhotometricLossParameters(**vars(jax_params))
    ours = losses.photometric_loss(_t(pred), _t(gt), params, _t(mask),
                                   None if weights is None else _t(weights))
    theirs = jax_losses.photometric_loss(jnp.asarray(pred), jnp.asarray(gt), jax_params,
                                         jnp.asarray(mask),
                                         None if weights is None else jnp.asarray(weights))
    _close(ours, theirs, **F32_TOL)


def test_guided_smoothness_loss_matches_jax():
    h, w = SIZES[1]
    depth, img = _smooth_depth(30, h, w), _rand(31, B, h, w, 3)
    mask = depth > 2.0
    for weights in (None, _rand(32, B, h, w, 1)):
        args = (gradients.imgrad_yx(_t(depth)).abs(), gradients.imgrad_yx(_t(img)).abs(),
                _t(mask))
        ours = losses.guided_smoothness_loss(*args, None if weights is None else _t(weights))
        theirs = jax_losses.guided_smoothness_loss(
            *(jnp.asarray(a.numpy()) for a in args),
            None if weights is None else jnp.asarray(weights))
        _close(ours, theirs, **F32_TOL)


# ---- evaluation/chamfer.py ----

@pytest.mark.parametrize("n,block", [(96, 32), (100, 32)])
def test_chamfer_matches_jax(n, block):
    # 100 rows: a last block of 4 (the JAX package pads it with zeros and
    # masks them out); a point pair 1e-4 apart, which the matmul form of a
    # distance would lose
    p1, p2 = _rand(33, B, n, 3, lo=-2, hi=2), _rand(34, B, 70, 3, lo=-2, hi=2)
    p1[0, 3] = p2[0, 5] + 1e-4
    for fn in ("chamfer_distance", "chamfer_distance_symmetric"):
        ours = getattr(evaluation, fn)(_t(p1), _t(p2), block=block)
        theirs = getattr(jax_evaluation, fn)(jnp.asarray(p1), jnp.asarray(p2), block=block)
        _close(ours, theirs, **F32_TOL)
    d = evaluation.chamfer_distance(_t(p1[:1, 3:4]), _t(p2[:1]), block=block)
    assert abs(d.item() - 1e-4 * np.sqrt(3)) < 1e-6


# ---- models/torch_export.py: key for key against the JAX exporter ----

def _jax_variables(name, seed):
    """Random (seeded) variables of the JAX model at the small configuration
    of test_torch_port_upstream_import.py (64x128, patch 32: the port has
    up_proj there), without running its init."""
    erp, patch = (64, 128), 32
    cls = JaxSphericalFusion if name == "oneshot" else JaxIterative
    shapes = jax.eval_shape(cls(spec=JaxSpec.create(erp, patch, (80, 80), 4)).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, *erp, 3)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def carried():
    """Per model: the JAX exporter's state dict, and the port's model
    holding the same weights (carried across by models/convert.py)."""
    out = {}
    for name, seed in (("oneshot", 40), ("iterative", 41)):
        v = _jax_variables(name, seed)
        cls = SphericalFusion if name == "oneshot" else SphericalFusionIterative
        model = cls(ProjectionSpec.create((64, 128), 32, (80, 80), 4), device="cpu")
        model.load_state_dict(state_dict_from_jax(v), strict=True)
        export = (jax_export.export_oneshot_checkpoint if name == "oneshot"
                  else jax_export.export_iterative_checkpoint)
        out[name] = export(v), model
    return out


@pytest.mark.parametrize("name", ["oneshot", "iterative"])
def test_export_matches_the_jax_exporter(carried, name):
    theirs, model = carried[name]
    export = (torch_export.export_oneshot_checkpoint if name == "oneshot"
              else torch_export.export_iterative_checkpoint)
    for arg in (model, model.state_dict()):
        ours = export(arg)
        assert set(ours) == set(theirs)
        for k, t in theirs.items():
            t = torch.from_numpy(np.asarray(t))
            assert ours[k].shape == t.shape and ours[k].dtype == t.dtype, k
            assert torch.equal(ours[k], t), k
    assert ours["bn1.num_batches_tracked"].shape == () and "up_proj.weight" not in ours
    assert ours["mlp_points.0.weight" if name == "oneshot" else "mlp_points1.0.weight"].ndim == 4
    other = (torch_export.export_iterative_checkpoint if name == "oneshot"
             else torch_export.export_oneshot_checkpoint)
    with pytest.raises(ValueError, match="not the state dict of"):
        other(model)


@pytest.mark.parametrize("name", ["oneshot", "iterative"])
def test_export_round_trips_through_the_importer(carried, name, tmp_path):
    _, model = carried[name]
    export = (torch_export.export_oneshot_checkpoint if name == "oneshot"
              else torch_export.export_iterative_checkpoint)
    sd = model.state_dict()
    path = tmp_path / "exported.pth"
    torch_export.save_torch_checkpoint(str(path), export(model))
    back = import_checkpoint(torch.load(path, weights_only=True))
    path.unlink()
    assert set(sd) - set(back) == {"up_proj.weight", "up_proj.bias"} and set(back) <= set(sd)
    for k, t in back.items():
        assert t.shape == sd[k].shape and t.dtype == sd[k].dtype, k
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, sd[k]), k


# ---- the packages' exports ----

def test_exports_follow_jax():
    # the JAX XLA quad blend, quad_gather_blend, is ops/quad_blend.py's
    # quad_blend over BlendTables; ops.quad_blend stays the module
    assert set(ops.__all__) == set(jax_ops.__all__) - {"quad_gather_blend"}
    assert ops.quad_blend.quad_blend.launches >= 0
    assert list(losses.__all__) == list(jax_losses.__all__)
    assert list(evaluation.__all__) == list(jax_evaluation.__all__)
    for mod, names in ((ops, ops.__all__), (losses, losses.__all__),
                       (evaluation, evaluation.__all__)):
        assert all(hasattr(mod, n) for n in names)
