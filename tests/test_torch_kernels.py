"""The port's CUDA kernels vs their plain PyTorch twins, and the wrappers'
dispatch and checks. Imports torch and the port only, so it runs on a
machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py

The card tests are marked ``gpu`` and skip without a card.
"""
import numpy as np
import pytest
import torch

from ws_mgmap_tpu_torch.ops.kernels import conv as kconv
from ws_mgmap_tpu_torch.ops.kernels import splat as ksplat

EGO = 12


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA kernel has no CPU mode")
    allow = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # fp32 twins in full fp32
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = allow


def _conv_launches():
    return (kconv.conv3x3_bn_relu_wgmma.launches,
            kconv.conv3x3_bn_relu_direct.launches)


# (H, C1, C2, Co) of the 12 fused call sites of the UNet at width 1
WIDTH1_SITES = [(224, 64, 0, 64), (224, 128, 64, 64), (112, 256, 64, 128),
                (56, 256, 64, 256), (28, 512, 128, 256), (14, 512, 256, 512),
                (56, 64, 0, 64), (56, 64, 0, 64), (28, 128, 0, 128),
                (28, 128, 0, 128), (14, 256, 0, 256), (14, 256, 0, 256)]
# (C1, C2, Co) that only the direct kernel takes
RAGGED = [(8, 0, 16), (5, 0, 7), (96, 32, 70), (64, 0, 130), (64, 32, 64),
          (32, 0, 64)]


@pytest.mark.parametrize("site", WIDTH1_SITES)
def test_dispatch_sends_width1_bf16_sites_to_wgmma(site):
    h, c1, c2, co = site
    assert kconv.conv_variant(torch.bfloat16, c1, c2, co) == "wgmma"
    assert kconv.conv_variant(torch.float32, c1, c2, co) == "direct"
    th, bn = kconv.wgmma_tile(6, h, h, c1 + c2, co)
    assert (th, bn) in kconv.WGMMA_TILES and bn <= co
    grid = kconv.wgmma_grid(6, h, h, c1 + c2, co)
    assert grid[0] * th * kconv.TILE_W >= h * h
    assert grid[1] * bn >= co and grid[2] == 6
    # enough blocks for most of the 132 SMs even at 14x14
    assert grid[0] * grid[1] * grid[2] >= kconv.MIN_BLOCKS


@pytest.mark.parametrize("shape", RAGGED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatch_sends_ragged_channels_to_direct(shape, dtype):
    assert kconv.conv_variant(dtype, *shape) == "direct"


def test_pack_weight_roundtrip():
    w = torch.randn(3, 3, 20, 12)
    p = kconv.pack_weight(w)
    assert p.shape == (9 * 12, 20) and p.is_contiguous()
    # row (dx*3 + dy)*Co + co holds w[dy, dx, :, co]
    assert torch.equal(p[(2 * 3 + 1) * 12 + 5], w[1, 2, :, 5])
    assert torch.equal(kconv.unpack_weight(p), w)


def _splat_inputs(rng, b, p, c):
    feats = (rng.randn(b, p, c) * 2.0).astype(np.float32)
    ids = rng.randint(0, EGO * EGO, (b, p)).astype(np.int32)
    crowd = rng.rand(b, p) < 0.3
    ids[crowd] = rng.randint(0, 6, crowd.sum())
    ids[rng.rand(b, p) < 0.75] = -1
    return torch.from_numpy(feats), torch.from_numpy(ids)


def test_splat_twin_zeroes_eps_maxima():
    # a max <= -1e16 is the reference's invalid sentinel: written as 0
    feats = torch.full((1, 4, 2), -2e16)
    feats[0, 1] = torch.tensor([-1e15, 3.0])
    ids = torch.tensor([[0, 0, 5, -1]], dtype=torch.int32)
    out = ksplat.splat_max(feats, ids, EGO).reshape(EGO * EGO, 2)
    assert torch.equal(out[0], feats[0, 1])
    assert torch.equal(out[5], torch.zeros(2))
    assert torch.count_nonzero(out[1:5]) == 0


def test_cpu_tensors_take_the_twins_without_counting():
    rng = np.random.RandomState(0)
    feats, ids = _splat_inputs(rng, 2, 64, 4)
    before = ksplat.splat_max.launches
    assert torch.equal(ksplat.splat_max(feats, ids, EGO),
                       ksplat.splat_max_plain(feats, ids, EGO))
    x = torch.randn(1, 8, 8, 4)
    w, s, b = torch.randn(3, 3, 4, 5), torch.ones(5), torch.zeros(5)
    cbefore = _conv_launches()
    assert torch.equal(kconv.conv3x3_bn_relu(x, w, s, b),
                       kconv.conv3x3_bn_relu_plain(x, w, s, b))
    for variant, wrapper in kconv.KERNELS.items():
        assert torch.equal(wrapper(x, kconv.kernel_weight(w, variant), s, b),
                           kconv.conv3x3_bn_relu_plain(x, w, s, b))
    assert ksplat.splat_max.launches == before
    assert _conv_launches() == cbefore


def test_conv_rejects_residual_with_x2():
    x = torch.randn(1, 8, 8, 4)
    with pytest.raises(ValueError):
        kconv.conv3x3_bn_relu(x, torch.randn(3, 3, 8, 4), torch.ones(4),
                              torch.zeros(4), residual=x, x2=x)


def _check_splat(f, i, ego):
    """One call launches the kernel once and matches the twin exactly
    (a max picks one of its inputs), NaN in the same places."""
    before = ksplat.splat_max.launches
    got = ksplat.splat_max(f, i, ego)
    torch.cuda.synchronize()
    assert ksplat.splat_max.launches == before + 1
    torch.testing.assert_close(got, ksplat.splat_max_plain(f, i, ego),
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("ego,c", [(12, 4), (100, 64), (240, 64), (12, 20),
                                   (12, 70), (100, 3)])
def test_splat_plan_owns_every_cell_and_channel_once(ego, c):
    plan = ksplat.splat_plan(ego, c)
    assert plan.smem_bytes <= ksplat.SMEM_BUDGET - 16
    assert 1 <= plan.group <= ksplat.MAX_GROUP and ksplat.RANKS <= 8
    owned = np.zeros((ego * ego, c), np.int64)
    for rank in range(ksplat.RANKS):
        cell = np.arange(plan.cells_per_rank) * ksplat.RANKS + rank
        cell = cell[cell < ego * ego]
        for g in range(plan.n_groups):
            g0 = g * plan.group
            owned[cell, g0:min(g0 + plan.group, c)] += 1
    assert (owned == 1).all()
    if (ego, c) == (100, 64):  # the main path: 2 groups of 32 channels
        assert (plan.n_groups, plan.group) == (2, 32)


def test_splat_plan_raises_past_the_shared_memory():
    assert ksplat.splat_plan(240, 64).n_groups > 2
    with pytest.raises(ValueError):
        ksplat.splat_plan(700, 64)


def test_splat_ablations_still_edit_the_kernel_source():
    # chip_smoke.py --splat-ablation edits csrc/splat.cu by text; each edit
    # must still match the kernel exactly once
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    src = (root / "ws_mgmap_tpu_torch/ops/kernels/csrc/splat.cu").read_text()
    variants = smoke.splat_ablation_sources(src)
    assert sorted(variants) == sorted(n for n, _ in smoke.SPLAT_ABLATIONS)
    assert all(text != src for text in variants.values())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 6, 13, 24])
def test_splat_kernel_matches_twin(cuda, b, dtype):
    feats, ids = _splat_inputs(np.random.RandomState(b), b, 4096, 64)
    _check_splat(feats.to(cuda, dtype), ids.to(cuda), EGO)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ego,c", [(12, 4), (12, 64), (12, 20), (100, 4),
                                   (100, 64), (100, 20)])
def test_splat_kernel_channels_and_grids(cuda, ego, c, dtype):
    rng = np.random.RandomState(ego + c)
    feats = torch.from_numpy((rng.randn(3, 5000, c) * 2).astype(np.float32))
    ids = rng.randint(0, ego * ego, (3, 5000)).astype(np.int32)
    ids[rng.rand(3, 5000) < 0.6] = -1
    f, i = feats.to(cuda, dtype), torch.from_numpy(ids).to(cuda)
    _check_splat(f, i, ego)
    # a view 2 or 4 bytes off the allocation's alignment
    shifted = torch.empty(f.numel() + 1, dtype=dtype, device=cuda)
    shifted[1:] = f.flatten()
    _check_splat(shifted[1:].view(f.shape), i, ego)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splat_kernel_every_pixel_on_one_cell(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    f = (torch.randn(2, 50176, 64, generator=g, device=cuda) * 2).to(dtype)
    i = torch.full((2, 50176), 4321, dtype=torch.int32, device=cuda)
    _check_splat(f, i, 100)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splat_kernel_on_projected_wall_ids(cuda, dtype):
    """Ids as the step makes them: the "wall 3 m ahead" depth projected by
    spatial_locs at the feature resolution, with the heading rotation."""
    from ws_mgmap_tpu_torch.ops.projection import cell_ids, spatial_locs
    from ws_mgmap_tpu_torch.tools.synthetic import wall_obs

    obs = wall_obs(3, 0.0, np.random.RandomState(0))
    depth = torch.from_numpy(np.stack([o["depth"] for o in obs])).to(cuda)
    heading = torch.tensor([0.0, 0.4, -1.3], device=cuda)
    x, y, valid = spatial_locs(depth * 10.0, 100, 0.12, out_hw=(224, 224),
                               heading=heading)
    i = cell_ids(x, y, valid, 100, (224, 224))
    assert 0.1 < float((i >= 0).float().mean()) < 0.9
    g = torch.Generator(device=cuda).manual_seed(2)
    f = (torch.randn(3, 224 * 224, 64, generator=g, device=cuda)).to(dtype)
    _check_splat(f, i, 100)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_splat_kernel_propagates_nan_and_edge_values(cuda, dtype):
    """The kernel against the twin on NaN (of either sign), +inf, +0.0
    beside -0.0, maxima at or below -1e16, -inf and an all-invalid frame.
    The sign of a zero max over a cell holding both +0.0 and -0.0 depends
    on the order of the merges, in the kernel and in the twin alike;
    assert_close treats the two zeros as equal."""
    from ws_mgmap_tpu_torch.tools.synthetic import special_splat_inputs

    feats, ids = special_splat_inputs(np.random.RandomState(3), 256, 4, EGO)
    f = torch.from_numpy(feats).to(cuda, dtype)
    i = torch.from_numpy(ids).to(cuda)
    _check_splat(f, i, EGO)
    got = ksplat.splat_max(f, i, EGO).reshape(2, EGO * EGO, 4)
    assert torch.isnan(got[0, 0, 0]) and torch.isnan(got[0, 1, 1])
    assert got[0, 2, 2] == float("inf") and not got[1].any()


@pytest.mark.gpu
@pytest.mark.parametrize("ego,c", [(12, 4), (100, 64), (240, 64), (12, 20),
                                   (12, 70), (100, 3)])
def test_splat_plan_shared_memory_matches_the_kernel(cuda, ego, c):
    # the plan's layout copy against the one the built kernel launches with
    plan = ksplat.splat_plan(ego, c)
    assert ksplat.splat_smem_bytes(plan) == plan.smem_bytes


@pytest.mark.gpu
def test_splat_kernel_fits_clusters_on_the_card(cuda):
    f = torch.zeros(6, 50176, 64, dtype=torch.bfloat16, device=cuda)
    i = torch.zeros(6, 50176, dtype=torch.int32, device=cuda)
    assert ksplat.splat_active_clusters(f, i, 100) >= 1


@pytest.mark.gpu
def test_splat_kernel_rejects_bad_operands(cuda):
    f = torch.zeros(2, 16, 4, device=cuda)
    i = torch.zeros(2, 16, dtype=torch.int32, device=cuda)
    before = ksplat.splat_max.launches
    with pytest.raises(TypeError):
        ksplat.splat_max(f, i.long(), EGO)
    with pytest.raises(TypeError):
        ksplat.splat_max(f.half(), i, EGO)
    with pytest.raises(ValueError):
        ksplat.splat_max(f[:, ::2], i[:, ::2].contiguous(), EGO)
    with pytest.raises(ValueError):  # ids [B, P, 1]
        ksplat.splat_max(f, i[..., None], EGO)
    with pytest.raises(ValueError):  # ids on the CPU
        ksplat.splat_max(f, i.cpu(), EGO)
    with pytest.raises(ValueError):
        ksplat.splat_max(f[:0], i[:0], EGO)
    assert ksplat.splat_max.launches == before


def _direct_operands(cuda, shape, dtype, res):
    b, h, w, c1, c2, co = shape
    g = torch.Generator(device=cuda).manual_seed(c1 * 100 + co)

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=cuda) * scale

    x = rnd(b, h, w, c1).to(dtype)
    x2 = rnd(b, h, w, c2).to(dtype) if c2 else None
    k = rnd(3, 3, c1 + c2, co, scale=0.1).to(dtype)
    s, bb = rnd(co).abs() + 0.5, rnd(co, scale=0.1)
    r = rnd(b, h, w, co).to(dtype) if res else None
    return x, x2, k, s, bb, r


def _check_direct(x, x2, k, s, bb, res, relu=True):
    wg, direct = _conv_launches()
    got = kconv.conv3x3_bn_relu(x, k, s, bb, relu=relu, residual=res, x2=x2)
    torch.cuda.synchronize()
    # ragged channels and fp32 take the direct kernel
    assert _conv_launches() == (wg, direct + 1)
    want = kconv.conv3x3_bn_relu_plain(x, k, s, bb, relu=relu, residual=res,
                                       x2=x2)
    # both sum in fp32 in different orders; bf16 outputs may then round
    # one bf16 ulp (2^-7 relative) apart
    bf16 = x.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=2**-7 if bf16 else 1e-4,
                               atol=1e-3 if bf16 else 1e-4)


# (B, H, W, C1, C2, Co): ragged channels; then H and W that no tile
# divides, Ci below one chunk (8 channels), an x/x2 split inside a chunk
# (C1 = 12), Co = 1 mod 4 (the fp32 4-byte copies)
@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 16, 24, 8, 0, 16),
                                   (1, 32, 20, 5, 0, 7),
                                   (2, 28, 28, 96, 32, 70),
                                   (1, 14, 14, 64, 0, 130),
                                   (2, 13, 22, 32, 0, 64),
                                   (1, 9, 11, 5, 0, 16),
                                   (2, 20, 20, 12, 20, 64),
                                   (1, 18, 18, 64, 0, 65)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_matches_twin(cuda, shape, dtype):
    _check_direct(*_direct_operands(cuda, shape, dtype, res=not shape[4]))


@pytest.mark.gpu
@pytest.mark.parametrize("tile", list(kconv.DIRECT_TILES))
@pytest.mark.parametrize("case", [((2, 20, 36, 24, 40, 136), False, True),
                                  ((1, 17, 30, 64, 0, 72), True, False),
                                  ((2, 11, 13, 6, 3, 70), False, True)])
def test_conv_direct_every_tile_matches_twin(cuda, monkeypatch, tile, case):
    shape, res, relu = case
    monkeypatch.setattr(kconv, "direct_tile", lambda *a: tile)
    _check_direct(*_direct_operands(cuda, shape, torch.float32, res), relu)


@pytest.mark.gpu
def test_conv_direct_at_a_224_site_fp32(cuda):
    # conv_original_size2 at the fp32 parity batch
    _check_direct(*_direct_operands(cuda, (2, 224, 224, 128, 64, 64),
                                    torch.float32, res=False))


@pytest.mark.gpu
def test_conv_direct_unaligned_operands(cuda):
    # a view 4 bytes off 16-byte alignment takes the 4-byte copies
    x, _, k, s, bb, r = _direct_operands(cuda, (2, 12, 20, 16, 0, 32),
                                         torch.float32, res=True)
    shifted = torch.empty(x.numel() + 1, device=cuda)
    shifted[1:] = x.flatten()
    _check_direct(shifted[1:].view(x.shape), None, k, s, bb, r)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", list(kconv.DIRECT_TILES))
def test_conv_direct_plan_matches_the_kernel(cuda, tile):
    # shared memory and blocks an SM holds, as the plan assumes
    from ws_mgmap_tpu_torch.ops.kernels import build
    lib = build.load_library()
    assert lib.ws_conv3x3_direct_smem_bytes(*tile) == \
        kconv.direct_smem_bytes(tile)
    assert lib.ws_conv3x3_direct_blocks_per_sm(*tile) == \
        kconv.DIRECT_TILES[tile][0]


@pytest.mark.gpu
def test_conv_kernel_rejects_bad_operands(cuda):
    x = torch.randn(1, 8, 8, 4, device=cuda)
    w, s, b = (torch.randn(3, 3, 4, 5, device=cuda),
               torch.ones(5, device=cuda), torch.zeros(5, device=cuda))
    with pytest.raises(TypeError):
        kconv.conv3x3_bn_relu(x, w.bfloat16(), s, b)
    with pytest.raises(ValueError):
        kconv.conv3x3_bn_relu(x.permute(0, 2, 1, 3), w, s, b)
    with pytest.raises(TypeError):
        kconv.conv3x3_bn_relu(x.half(), w.half(), s, b)
    before = _conv_launches()
    with pytest.raises(ValueError):  # a tile the kernel has no instance of
        kconv.conv3x3_bn_relu_direct(x, w, s, b, tile=(8, 8, 128, 8, 1, 3))
    assert _conv_launches() == before


# (B, H, W, C1, C2, Co, residual, relu): edge-heavy H/W (14, 28, 56, and
# sizes that are no multiple of the tile), Co > 256 (several N tiles),
# Co not a multiple of the N tile, an x/x2 split, residuals, relu=False,
# B > 1, a box wider than the image
WGMMA_CASES = [
    (2, 14, 14, 64, 0, 64, False, True),
    (3, 28, 28, 128, 0, 128, True, True),
    (2, 56, 56, 64, 0, 64, True, False),
    (1, 20, 36, 64, 64, 128, False, True),
    (2, 14, 14, 256, 256, 512, False, True),
    (2, 13, 22, 128, 0, 320, True, True),
    (2, 16, 16, 64, 0, 72, False, False),
    (1, 6, 5, 64, 64, 64, False, True),
    (6, 112, 112, 64, 0, 256, False, True),
]


def _wgmma_operands(cuda, b, h, w, c1, c2, co, res):
    g = torch.Generator(device=cuda).manual_seed(b * 1000 + h * 10 + co)

    def rnd(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=cuda) * scale

    x = rnd(b, h, w, c1).bfloat16()
    x2 = rnd(b, h, w, c2).bfloat16() if c2 else None
    k = rnd(3, 3, c1 + c2, co, scale=(9 * (c1 + c2)) ** -0.5).bfloat16()
    s, bb = rnd(co).abs() + 0.5, rnd(co, scale=0.1)
    r = rnd(b, h, w, co).bfloat16() if res else None
    return x, x2, k, s, bb, r


def _check_wgmma(cuda, case):
    b, h, w, c1, c2, co, res, relu = case
    x, x2, k, s, bb, r = _wgmma_operands(cuda, b, h, w, c1, c2, co, res)
    wg, direct = _conv_launches()
    got = kconv.conv3x3_bn_relu(x, k, s, bb, relu=relu, residual=r, x2=x2)
    torch.cuda.synchronize()
    assert _conv_launches() == (wg + 1, direct)
    want = kconv.conv3x3_bn_relu_plain(x, k, s, bb, relu=relu, residual=r,
                                       x2=x2)
    # both sum in fp32 in different orders; the bf16 outputs may then
    # round one bf16 ulp (2^-7 relative) apart
    torch.testing.assert_close(got.float(), want.float(), rtol=2**-7,
                               atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WGMMA_CASES)
def test_conv_wgmma_matches_twin(cuda, case):
    _check_wgmma(cuda, case)


@pytest.mark.gpu
@pytest.mark.parametrize("tile", kconv.WGMMA_TILES)
@pytest.mark.parametrize("case", [(2, 20, 36, 64, 64, 264, False, True),
                                  (1, 17, 30, 128, 0, 264, True, False)])
def test_conv_wgmma_every_tile_matches_twin(cuda, monkeypatch, tile, case):
    monkeypatch.setattr(kconv, "wgmma_tile", lambda *a: tile)
    _check_wgmma(cuda, case)


@pytest.mark.gpu
def test_conv_wgmma_takes_packed_weights(cuda):
    x, _, k, s, bb, r = _wgmma_operands(cuda, 2, 28, 28, 64, 0, 128, True)
    got = kconv.conv3x3_bn_relu_wgmma(x, kconv.pack_weight(k), s, bb,
                                      residual=r)
    assert torch.equal(got, kconv.conv3x3_bn_relu(x, k, s, bb, residual=r))


@pytest.mark.gpu
def test_conv_wgmma_rejects_what_it_does_not_take(cuda):
    x, _, k, s, bb, _ = _wgmma_operands(cuda, 1, 16, 16, 64, 0, 64, False)
    wp = kconv.pack_weight(k)
    before = _conv_launches()
    with pytest.raises(TypeError):  # fp32: no silent TF32
        kconv.conv3x3_bn_relu_wgmma(x.float(), wp.float(), s, bb)
    with pytest.raises(ValueError):  # ragged channels
        kconv.conv3x3_bn_relu_wgmma(x[..., :32].contiguous(),
                                    wp[:, :32].contiguous(), s, bb)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
    shifted[1:] = x.flatten()
    with pytest.raises(ValueError):  # 2 bytes off TMA's 16-byte alignment
        kconv.conv3x3_bn_relu_wgmma(shifted[1:].view(x.shape), wp, s, bb)
    with pytest.raises(ValueError):  # HWIO where packed is expected
        kconv.conv3x3_bn_relu_wgmma(x, k, s, bb)
    with pytest.raises(ValueError):  # a tile the kernel has no instance of
        kconv.conv3x3_bn_relu_wgmma(x, wp, s, bb, tile=(32, 64))
    assert _conv_launches() == before
