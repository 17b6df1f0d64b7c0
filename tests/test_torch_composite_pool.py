"""The rasterizer's output pass (``rasterize/composite_pool.py``) and its
routing, on the CPU.

* ``api.grad_flows``, the test that routes a render to the output pass's
  kernel on the card: false with grad mode off or no input requiring a
  gradient, true for each of faces, textures and background requiring
  one;
* the plain output pass (``composite_pool_plain``: ``composite``, then
  ``flip_pool``), which the gradient route, the CPU route and the kernel's
  checks on the card share, equals the composite and the flip and pool
  the port ran before the kernel (copied here as ``_seed_pass``) bit for
  bit: pool on and off, each output alone and all three, a ``[3]`` and a
  ``[bs, 3]`` background, adversarial values, a view with no covered
  pixel, and a face-group coverage whose winners belong to another rank;
* a render routed as on the card (``api.on_card`` faked, the output pass
  run by its plain version) takes the output pass without
  ``rasterize_core`` where no gradient flows, the autograd function
  where one does, and gives the other route's images bit for bit.

The kernel itself runs only on the card: ``chip_smoke.py`` holds it to
``composite_pool_plain`` bit for bit.
"""

import os

import pytest
import torch

import neural_renderer_torch as nt
import utils
from neural_renderer_torch.rasterize import api, composite_pool, core
from neural_renderer_torch.rasterize.config import RasterizeSettings

TEAPOT = os.path.join(utils.DATA_DIR, 'teapot.obj')
BS, IS = 3, 12
FAR = 100.0


def _seed_pass(settings, cover, rgb, depth, background, pool):
    """The output pass as the port ran it before ``composite_pool``: the
    composite of ``core._forward_all``, then the flips and pools of
    ``api._render_pass``, verbatim."""
    covered = cover >= 0
    rgb_map = rgb.permute(0, 2, 3, 1)
    bg = (background[None, None, None, :] if background.ndim == 1
          else background[:, None, None, :])
    mask = covered.to(torch.float32)[..., None]
    rgb = rgb_map * mask + (1.0 - mask) * bg
    alpha = covered.to(torch.float32)

    def pool2(x):
        h, w = x.shape[-2], x.shape[-1]
        x = x.reshape(*x.shape[:-2], h // 2, 2, w // 2, 2)
        return x.mean(dim=(-3, -1))

    if settings.return_rgb:
        rgb = torch.flip(rgb.permute(0, 3, 1, 2), dims=[2])
        if pool:
            rgb = pool2(rgb)
    if settings.return_alpha:
        alpha = torch.flip(alpha, dims=[1])
        if pool:
            alpha = pool2(alpha)
    if settings.return_depth:
        depth = torch.flip(depth, dims=[1])
        if pool:
            depth = pool2(depth)
    return {'rgb': rgb if settings.return_rgb else None,
            'alpha': alpha if settings.return_alpha else None,
            'depth': depth if settings.return_depth else None}


def _adversarial(gen, *shape):
    """Values of both signs over 48 binades: sums of four round
    differently in every order."""
    sign = torch.where(torch.rand(shape, generator=gen) < 0.5, -1.0, 1.0)
    scale = torch.exp2(torch.randint(-24, 25, shape, generator=gen).float())
    return sign * scale * (1.0 + torch.rand(shape, generator=gen))


def _maps(seed, bs=BS, is_=IS):
    """(cover, rgb [bs, 3, is, is], depth): about half the pixels covered,
    batch element 1 not at all (its depth ``FAR``)."""
    gen = torch.Generator().manual_seed(seed)
    cover = torch.randint(-40, 40, (bs, is_, is_), generator=gen).clamp(
        min=-1).to(torch.int32)
    cover[1] = -1
    rgb = _adversarial(gen, bs, 3, is_, is_)
    depth = torch.where(cover >= 0, _adversarial(gen, bs, is_, is_).abs(),
                        FAR)
    return cover, rgb, depth


def _bits_equal(got, want):
    assert got.keys() == want.keys()
    for k in got:
        if want[k] is None:
            assert got[k] is None, k
            continue
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k].contiguous().view(torch.int32),
                           want[k].contiguous().view(torch.int32)), k


def _settings(outputs, is_=IS):
    return RasterizeSettings(image_size=is_,
                             return_rgb='rgb' in outputs,
                             return_alpha='alpha' in outputs,
                             return_depth='depth' in outputs)


LEAVES = ('faces', 'textures', 'background')
# grad mode, the inputs that require a gradient, whether one flows
GRAD_CASES = {
    'grad_off': (False, LEAVES, False),
    'no_input_requires_grad': (True, (), False),
    'faces': (True, ('faces',), True),
    'textures': (True, ('textures',), True),
    'background': (True, ('background',), True),
}


@pytest.mark.parametrize('case', sorted(GRAD_CASES))
def test_grad_flows(case):
    enabled, requiring, flows = GRAD_CASES[case]
    leaves = {'faces': torch.zeros(1, 2, 3, 3),
              'textures': torch.zeros(1, 2, 2, 2, 2, 3),
              'background': torch.zeros(3)}
    for name in requiring:
        leaves[name].requires_grad_(True)
    with torch.set_grad_enabled(enabled):
        assert api.grad_flows(**leaves) is flows


# (pool, outputs, background shape, rgb layout): channel planes as the
# forward kernel writes them, or channel-last as texture sampling does
PASS_CASES = ([(pool, outputs, (3,), 'planes') for pool in (True, False)
               for outputs in ('rgb', 'alpha', 'depth', 'rgb alpha depth')]
              + [(pool, 'rgb alpha depth', (BS, 3), layout)
                 for pool in (True, False)
                 for layout in ('planes', 'channel-last')])


@pytest.mark.parametrize('pool,outputs,bg_shape,layout', PASS_CASES)
def test_plain_output_pass_equals_the_seed_pass(pool, outputs, bg_shape,
                                                layout):
    cover, rgb, depth = _maps(7)
    if layout == 'channel-last':
        rgb = rgb.permute(0, 2, 3, 1).contiguous().permute(0, 3, 1, 2)
    bg = _adversarial(torch.Generator().manual_seed(8), *bg_shape)
    s = _settings(outputs)
    got = composite_pool.composite_pool_plain(s, cover, rgb, depth, bg, pool)
    _bits_equal(got, _seed_pass(s, cover, rgb, depth, bg, pool))
    size = IS // 2 if pool else IS
    for k in ('rgb', 'alpha', 'depth'):
        if k in outputs:
            assert got[k].shape[-2:] == (size, size)


def test_a_view_with_no_covered_pixel_is_background():
    cover, rgb, depth = _maps(9)
    bg = torch.tensor([[0.25, 0.5, 0.75], [0.1, 0.2, 0.3], [1.0, 0.0, 2.0]])
    s = _settings('rgb alpha depth')
    got = composite_pool.composite_pool_plain(s, cover, rgb, depth, bg, True)
    _bits_equal(got, _seed_pass(s, cover, rgb, depth, bg, True))
    assert torch.equal(got['rgb'][1],
                       bg[1][:, None, None].expand(3, IS // 2, IS // 2))
    assert torch.equal(got['alpha'][1], torch.zeros(IS // 2, IS // 2))
    assert torch.equal(got['depth'][1], torch.full((IS // 2, IS // 2), FAR))


def test_face_group_winners_of_another_rank_are_covered():
    """Under a face group the pass takes the global winners' coverage
    (``core.coverage``): a pixel whose local face-index map is -1 but that
    another rank's face won is composited as covered."""
    cover, rgb, depth = _maps(10)
    local = torch.where(torch.rand(cover.shape,
                                   generator=torch.Generator().manual_seed(11))
                        < 0.5, cover, -1).to(torch.int32)
    maps = {'face_index_map': local, 'global_index_map': cover}
    assert core.coverage(maps) is cover
    assert core.coverage({'face_index_map': local}) is local
    elsewhere = (local < 0) & (cover >= 0)
    assert elsewhere.any()
    bg = torch.tensor([0.5, 0.25, 0.125])
    s = _settings('rgb alpha depth')
    got = composite_pool.composite_pool_plain(s, core.coverage(maps), rgb,
                                              depth, bg, False)
    _bits_equal(got, _seed_pass(s, cover, rgb, depth, bg, False))
    flipped = torch.flip(elsewhere, dims=[1])
    assert bool((got['alpha'][flipped] == 1.0).all())
    assert torch.equal(got['rgb'].permute(0, 2, 3, 1)[flipped],
                       torch.flip(rgb.permute(0, 2, 3, 1), dims=[1])[flipped])


@pytest.fixture(scope='module')
def scene():
    v, f = nt.load_obj(TEAPOT)
    v = torch.as_tensor(v)[None].expand(2, -1, -1).contiguous()
    f = torch.as_tensor(f, dtype=torch.int64)[None].expand(2, -1, -1)
    tx = torch.rand((2, f.shape[1], 2, 2, 2, 3),
                    generator=torch.Generator().manual_seed(5))
    r = nt.Renderer()
    r.image_size = 16
    r.background_color = [0.25, 0.5, 0.75]
    r.eye = torch.tensor([[0.0, 0.5, -2.7], [1.0, 1.0, -2.7]])
    return r, v, f, tx


ROUTE_CASES = [(aa, grad) for aa in (True, False, 'approx')
               for grad in (False, True)]


@pytest.mark.parametrize('anti_aliasing,grad', ROUTE_CASES)
def test_render_takes_the_output_pass_where_no_gradient_flows(
        scene, monkeypatch, anti_aliasing, grad):
    r, v, f, tx = scene
    r.anti_aliasing = anti_aliasing
    want = r.render_rgbad(v, f, tx)

    calls = {'core': 0, 'pass': 0}

    def counted(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(api, 'on_card', lambda t: True)
    monkeypatch.setattr(api, 'rasterize_core',
                        counted('core', api.rasterize_core))
    monkeypatch.setattr(composite_pool, 'composite_pool',
                        counted('pass', composite_pool.composite_pool))
    tx_in = tx.clone().requires_grad_(grad)
    got = r.render_rgbad(v, f, tx_in)
    # 'approx' renders its values without gradient, and its gradient pass
    # where one flows
    assert calls == {'core': int(grad),
                     'pass': int(anti_aliasing == 'approx' or not grad)}
    _bits_equal({k: x.detach() for k, x in got.items()}, want)
    if grad:
        g, = torch.autograd.grad(got['rgb'].sum(), tx_in)
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
