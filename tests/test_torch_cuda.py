"""The port on a CUDA GPU: the hand-written kernels against their plain
versions, the GPU slice against the port's CPU path, and the public API.

Every test needs a CUDA device and ``nvcc`` and skips without them. This file
imports no JAX, so on a machine without JAX run it without the suite's
conftest: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from fetalsyngen_torch.generator import pipeline as tpipe
from fetalsyngen_torch.generator.config import GeneratorCfg, IntensityCfg
from fetalsyngen_torch.generator.params import sample_params
from fetalsyngen_torch.kernels import deform_mask, hat, row_affine
from fetalsyngen_torch.testing import phantom_seeds_and_seg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("D, H, S, OW", [(6, 10, 16, 16), (3, 8, 16, 24), (2, 5, 300, 300), (4, 4, 513, 64)])
def test_kernel_matches_plain(dev, D, H, S, OW):
    g = torch.Generator(device=dev).manual_seed(D * 1000 + S + OW)
    B = 3
    xa = torch.rand((B, D, H, S), generator=g, device=dev)
    xb = torch.randint(0, 8, (B, D, H, S), generator=g, device=dev).float()
    coefs = torch.rand((B, 4), generator=g, device=dev) - 0.5
    coefs[:, 2] += S / OW
    disp = (torch.rand((B, D, H, OW), generator=g, device=dev) - 0.5) * 2 * (S / 4)
    disp[..., ::5] = torch.round(disp[..., ::5]) + 0.5  # near-half positions
    ka, kb = hat.hat_pass_pair(xa, xb, coefs, disp)
    ra, rb = hat.hat_pass_pair_ref(xa, xb, coefs, disp)
    torch.cuda.synchronize()
    torch.testing.assert_close(ka, ra, rtol=0, atol=1e-6)
    assert torch.equal(kb, rb)


@pytest.mark.parametrize("nearest", [False, True])
@pytest.mark.parametrize("with_disp", [False, True])
@pytest.mark.parametrize("D, H, S", [(6, 10, 16), (2, 5, 300), (4, 4, 513)])
def test_single_kernel_matches_plain(dev, D, H, S, with_disp, nearest):
    g = torch.Generator(device=dev).manual_seed(D * 1000 + S + 10 * with_disp + nearest)
    B = 3
    x = torch.rand((B, D, H, S), generator=g, device=dev)
    if nearest:
        x = torch.randint(0, 8, (B, D, H, S), generator=g, device=dev).float()
    # general slopes with three nonzero products, as the U passes have
    coefs = torch.rand((B, 4), generator=g, device=dev) - 0.5
    coefs[:, 2] += 1.0
    coefs[:, 3] *= S / 4
    disp = None
    if with_disp:
        disp = (torch.rand((B, D, H, S), generator=g, device=dev) - 0.5) * 2 * (S / 4)
        disp[..., ::5] = torch.round(disp[..., ::5]) + 0.5  # near-half positions
    k = hat.hat_pass(x, coefs, disp, nearest)
    r = hat.hat_pass_ref(x, coefs, disp, nearest)
    torch.cuda.synchronize()
    if nearest:
        assert torch.equal(k, r)
    else:
        torch.testing.assert_close(k, r, rtol=0, atol=1e-6)


@pytest.mark.parametrize("form", ["lane", "slice"])
@pytest.mark.parametrize("D, H, S", [(6, 10, 16), (2, 5, 300), (4, 4, 513)])
def test_scanner_forms_match_plain(dev, D, H, S, form):
    """K1's (linear, linear) lane-affine and per-slice forms and K2's
    per-slice form against their plain versions, bit-identical."""
    g = torch.Generator(device=dev).manual_seed(D * 1000 + S + len(form))
    B = 2
    xa = torch.rand((B, D, H, S), generator=g, device=dev)
    xb = torch.rand((B, D, H, S), generator=g, device=dev)
    if form == "lane":
        coefs = torch.tensor([[0.0, 0.0, 1.0, 0.0]] * B, device=dev)
        disp = (torch.rand((B, 3, S), generator=g, device=dev) - 0.5) * torch.tensor([[[0.2], [0.2], [S / 4]]], device=dev)
    else:
        coefs = torch.rand((B, D, 4), generator=g, device=dev) - 0.5
        coefs[..., 0] = 0.0
        coefs[..., 2] += 1.0
        coefs[..., 3] *= S / 4
        disp = None
    ka, kb = hat.hat_pass_pair(xa, xb, coefs, disp, nearest_b=False)
    ra, rb = hat.hat_pass_pair_ref(xa, xb, coefs, disp, nearest_b=False)
    torch.cuda.synchronize()
    assert torch.equal(ka, ra) and torch.equal(kb, rb)
    if form == "slice":
        assert torch.equal(hat.hat_pass(xa, coefs), hat.hat_pass_ref(xa, coefs))
    else:
        with pytest.raises(ValueError, match="no kernel"):
            hat.hat_pass_pair(xa, xb, coefs, disp, nearest_b=True)


def test_wrapper_rejects_bad_inputs(dev):
    x = torch.zeros((1, 2, 3, 8), device=dev)
    coefs = torch.zeros((1, 4), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        hat.hat_pass_pair(x.transpose(1, 2).contiguous().transpose(1, 2), x, coefs, x)
    with pytest.raises(TypeError, match="float32"):
        hat.hat_pass_pair(x.double(), x.double(), coefs, x)
    with pytest.raises(ValueError, match="coefs"):
        hat.hat_pass_pair(x, x, torch.zeros((2, 4), device=dev), x)
    with pytest.raises(ValueError, match="disp"):
        hat.hat_pass(x, coefs, torch.zeros((1, 2, 4, 9), device=dev))
    with pytest.raises(ValueError, match="out_len=8 but the displacement has 9 lanes"):
        hat.hat_pass(x, coefs, torch.zeros((1, 2, 3, 9), device=dev), out_len=8)
    with pytest.raises(TypeError, match="float32"):
        hat.hat_pass(x.double(), coefs)


def test_slice_gpu_matches_cpu(dev):
    shape = (48, 48, 48)
    labels = tuple([0] + list(range(10, 50)))
    classes = tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))
    cfg = GeneratorCfg(shape=shape, intensity=IntensityCfg(1, 6, labels, classes))
    seeds, seg = (torch.from_numpy(a.astype(np.int32)) for a in phantom_seeds_and_seg(shape))
    ov = {g: True for g in ("deform_apply", "gamma_apply", "bf_apply", "resample_apply", "noise_apply")}
    hat.LAUNCHES.update(dict.fromkeys(hat.LAUNCHES, 0))
    out, seg_out, p = tpipe.synth_batch(
        seeds[None].expand(2, *shape), seg[None].expand(2, *shape), cfg, [3, 4], dev, ov
    )
    torch.cuda.synchronize()
    assert hat.LAUNCHES == {**dict.fromkeys(hat.LAUNCHES, 0), "hat_pass_pair": 3}
    gens = tpipe.make_generators([3, 4], dev)
    p2 = sample_params(gens, cfg, ov)
    fields = tpipe.draw_fields(gens, cfg, dev)
    out_cpu, seg_cpu, _ = tpipe.synth_core(
        p2.to("cpu"), fields.to("cpu"), seeds[None].expand(2, *shape), seg[None].expand(2, *shape), cfg
    )
    torch.testing.assert_close(out.cpu(), out_cpu, rtol=0, atol=1e-4)
    assert (seg_out.cpu() != seg_cpu).float().mean() <= 1e-5


@pytest.mark.parametrize("nonlinear", [True, False])
def test_api_image_path_gpu_matches_cpu(dev, nonlinear):
    """``FetalSynthGen.sample`` with the image as intensity and co-deformed
    (K1 and K2, or K2 alone without the field) on the card, replayed
    bit-identically, and against the port's CPU path on the same draws."""
    from fetalsyngen_torch.generator.model import (
        FetalSynthGen, ImageFromSeeds, RandBiasField, RandGamma, RandNoise, RandResample,
        SpatialDeformation,
    )
    from fetalsyngen_torch.testing import make_phantom

    shape = (48, 48, 48)
    labels = tuple([0] + list(range(10, 50)))
    classes = tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))
    gen = FetalSynthGen(
        shape, (0.5, 0.5, 0.5), ImageFromSeeds(1, 6, labels, classes),
        SpatialDeformation(20, 0.02, 0.1, shape, 0.9, nonlinear, 0.03, 0.06, 4.0, 0.5),
        RandResample(0.9, 0.5, 1.5), RandBiasField(0.9, 0.004, 0.02, 0.01, 0.3),
        RandNoise(0.9, 5, 15), RandGamma(0.9, 0.1), device="cuda", seed=1,
    )
    img, seg = make_phantom(np.random.default_rng(2), shape)
    pinned = {"deform_params": {"deform_apply": True}}
    hat.LAUNCHES.update(dict.fromkeys(hat.LAUNCHES, 0))
    out, seg_out, img_out, gp = gen.sample(img, seg, None, genparams=pinned)
    torch.cuda.synchronize()
    want = {"hat_pass_pair": 3, "hat_pass": 6} if nonlinear else {"hat_pass_pair": 0, "hat_pass": 15}
    assert hat.LAUNCHES == {**dict.fromkeys(hat.LAUNCHES, 0), **want}
    out2, seg2, img2, _ = gen.sample(img, seg, None, genparams=gp)
    assert torch.equal(out2, out) and torch.equal(seg2, seg_out) and torch.equal(img2, img_out)
    inputs, _, _ = gen.prepare(img, seg, None, genparams=gp)
    cpu = {k: (v.to("cpu") if v is not None else None) for k, v in inputs.items()}
    out_c, seg_c, img_c = tpipe.synth_core(**cpu, cfg=gen.cfg)
    for g, c in ((out, out_c[0]), (img_out, img_c[0])):
        scale = max(1.0, float(c.abs().max()))  # the dataset scales both to [0, 1]
        torch.testing.assert_close(g.cpu() / scale, c / scale, rtol=0, atol=1e-4)
    assert (seg_out.cpu() != seg_c[0]).float().mean() <= 1e-5


def test_scanner_ab_gpu_matches_cpu(dev):
    """One stack's acquisition and reconstruction (``scanner_ab_case``) on the
    card through K1's and K2's scanner forms, against the port's CPU path."""
    from fetalsyngen_torch.testing import run_scanner_ab, scanner_ab_case

    case = scanner_ab_case(128, 32)
    hat.LAUNCHES.update(dict.fromkeys(hat.LAUNCHES, 0))
    gpu = run_scanner_ab(case, 128, 32, device=dev)
    assert hat.LAUNCHES == {**dict.fromkeys(hat.LAUNCHES, 0), "hat_pass_pair_lane": 2,
                            "hat_pass_pair_slice": 2, "hat_pass_slice": 2}
    cpu = run_scanner_ab(case, 128, 32, device="cpu")
    np.testing.assert_array_equal(gpu[1], cpu[1])
    for g, c in zip(gpu, cpu):
        np.testing.assert_allclose(g, c, rtol=0, atol=1e-4 * float(np.abs(c).max()))


@pytest.mark.parametrize("D, H, S", [(6, 10, 16), (2, 5, 300), (4, 4, 513)])
def test_new_hat_forms_match_plain(dev, D, H, S):
    """K1 without a displacement (nearest labels) and K2's lane-affine form
    against their plain versions, bit-identical."""
    g = torch.Generator(device=dev).manual_seed(D * 100 + S)
    B = 2
    xa = torch.rand((B, D, H, S), generator=g, device=dev)
    xb = torch.randint(0, 8, (B, D, H, S), generator=g, device=dev).float()
    coefs = torch.rand((B, 4), generator=g, device=dev) - 0.5
    coefs[:, 2] += 1.0
    coefs[:, 3] *= S / 4
    ka, kb = hat.hat_pass_pair(xa, xb, coefs, None)
    ra, rb = hat.hat_pass_pair_ref(xa, xb, coefs, None)
    table = (torch.rand((B, 3, S), generator=g, device=dev) - 0.5) * torch.tensor([[[0.2], [0.2], [S / 4]]], device=dev)
    k = hat.hat_pass(xa, coefs, table)
    r = hat.hat_pass_ref(xa, coefs, table)
    torch.cuda.synchronize()
    assert torch.equal(ka, ra) and torch.equal(kb, rb) and torch.equal(k, r)
    with pytest.raises(ValueError, match="no kernel"):
        hat.hat_pass(xb, coefs, table, nearest=True)


# (D, H) per row length S at B=3: with K2's tiles of about 16 KB (S=5: 816
# rows; 300: 13; 513: 4; 6144: 1) every shape has several tiles, the last
# partial, and (but at 6144, one row a tile) tiles that span two samples and
# two slices
K2_ROWS = {5: (40, 30), 300: (5, 7), 513: (3, 5), 6144: (2, 3)}
K2_FORMS = [("sample", False, None), ("sample", True, None), ("sample", False, "volume"), ("sample", True, "volume"),
            ("sample", False, "lane"), ("slice", False, None)]


@pytest.mark.parametrize("form", K2_FORMS, ids=lambda f: "-".join(str(v) for v in f))
@pytest.mark.parametrize("S", sorted(K2_ROWS))
def test_single_kernel_bits(dev, S, form):
    """K2 in each instantiated form bit for bit (as int32), -0.0 among the
    volume's, the displacement's and the labels' values, positions at exact
    half-integers and past both edges."""
    coef, nearest, disp_kind = form
    B, (D, H) = 3, K2_ROWS[S]
    g = torch.Generator(device=dev).manual_seed(S * 10 + len(str(form)))
    if nearest:
        x = torch.randint(-1, 8, (B, D, H, S), generator=g, device=dev).float()
        x[x < 0] = -0.0
    else:
        x = _with_negative_zeros(torch.randn((B, D, H, S), generator=g, device=dev))
    if coef == "slice":
        coefs = (torch.rand((B, D, 4), generator=g, device=dev) - 0.5) * torch.tensor([0.0, 0.5, 0.2, S / 2],
                                                                                       device=dev)
        coefs[..., 2] += 1.0
    else:  # quarter-voxel rows (exact halves), general slopes, reversed lanes
        coefs = torch.tensor([[0.25, -0.5, 1.0, 0.5], [0.05, -0.04, 1.02, -0.3 * S], [0.0, 0.0, -1.0, S - 1.0]],
                             device=dev)
    disp = None
    if disp_kind == "volume":
        disp = (torch.rand((B, D, H, S), generator=g, device=dev) - 0.5) * (S / 2)
        disp[..., ::5] = torch.round(disp[..., ::5]) + 0.5
        disp[..., 1::7] = -0.0
    elif disp_kind == "lane":
        disp = torch.randn((B, 3, S), generator=g, device=dev) * torch.tensor([[[0.3], [0.3], [S / 8]]], device=dev)
    got, want = hat.hat_pass(x, coefs, disp, nearest), hat.hat_pass_ref(x, coefs, disp, nearest)
    torch.cuda.synchronize()
    assert _bits_equal((got,), (want,))


def test_hat_geometry(dev):
    """K2's launches: 16 KB tiles in three stages on a grid of whole SMs'
    worth of blocks at B=1 256^3 in every form; tile rows in whole 16-byte
    units and two stages where three do not fit."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for nearest, per_slice, disp in ((False, False, "none"), (True, False, "none"), (False, False, "volume"),
                                     (True, False, "volume"), (False, False, "lane"), (False, True, "none")):
        geo = hat.hat_geometry((1, 256, 256, 256), nearest, per_slice, disp)
        assert geo == {"tile_rows": 16, "stages": 3, "grid": geo["grid"], "smem_bytes": 128 + 3 * 16384}
        assert geo["grid"] % sms == 0 and geo["grid"] < 4096
    assert hat.hat_geometry((3, 40, 30, 5)) == {"tile_rows": 816, "stages": 3, "grid": 5, "smem_bytes": 128 + 3 * 16320}
    geo = hat.hat_geometry((1, 1, 8, 6143))
    assert geo == {"tile_rows": 4, "stages": 2, "grid": 2, "smem_bytes": 128 + 2 * 4 * 6143 * 4}


@pytest.mark.parametrize("form", K2_FORMS, ids=lambda f: "-".join(str(v) for v in f))
def test_hat_pass_offset_views(dev, form):
    """K2 on contiguous views 4, 8 and 12 bytes into larger tensors (a
    batch's later samples, as ``vol[1:]`` gives them): ``x`` off 16 bytes,
    and a displacement or table off 16 bytes, bit for bit (as int32) with
    the plain version, in every form."""
    coef, nearest, disp_kind = form
    B, D, H, S = 2, 3, 5, 7
    n = B * D * H * S
    g = torch.Generator(device=dev).manual_seed(7)
    coefs = torch.tensor([[0.25, -0.5, 1.0, 0.5], [0.05, -0.04, 1.02, -2.1]], device=dev)
    if coef == "slice":
        coefs = (torch.rand((B, D, 4), generator=g, device=dev) - 0.5) * torch.tensor([0.0, 0.5, 0.2, 3.0], device=dev)
        coefs[..., 2] += 1.0
    for off in (1, 2, 3):
        base = torch.randint(0, 8, (off + n,), generator=g, device=dev).float() if nearest else \
            _with_negative_zeros(torch.randn(off + n, generator=g, device=dev))
        x = base[off:].view(B, D, H, S)
        assert x.is_contiguous() and x.data_ptr() % 16
        disp = None
        if disp_kind == "volume":
            disp = ((torch.rand(off + n, generator=g, device=dev) - 0.5) * S)[off:].view(B, D, H, S)
        elif disp_kind == "lane":
            disp = torch.randn(off + B * 3 * S, generator=g, device=dev)[off:].view(B, 3, S)
        got, want = hat.hat_pass(x, coefs, disp, nearest), hat.hat_pass_ref(x, coefs, disp, nearest)
        torch.cuda.synchronize()
        assert _bits_equal((got,), (want,)), off


# K1's forms: (displacement kind, nearest second operand), and its bit tests'
# shapes, (B, D, H, S), OW, operand offsets in floats: tiles of 13 rows that
# span samples and slices and end partial; an odd S above 3630 (one-row
# tiles: 4-row ones would not fit two stages); OW != S; xa and xb as views
# 4 and 12 bytes into larger tensors
K1_FORMS = [("volume", True), (None, True), ("lane", False), ("slice", False)]
K1_SHAPES = {"partial": ((3, 100, 101, 301), 301, (0, 0)), "odd_s": ((2, 2, 3, 4095), 4095, (0, 0)),
             "ow": ((2, 4, 4, 513), 64, (0, 0)), "offsets": ((2, 7, 9, 301), 301, (1, 3))}


def _pair_inputs(dev, disp_kind, nearest_b, shape, OW, offsets, seed):
    """K1's operands, -0.0 among them (labels in 0..49 if nearest), at the
    given float offsets into larger tensors; coefficients with quarter-voxel
    rows, general slopes and a reversed row; the displacement with exact
    half-integer positions and -0.0. OW is S without a displacement."""
    B, D, H, S = shape
    n = B * D * H * S
    g = torch.Generator(device=dev).manual_seed(seed)

    def operand(off, nearest):
        if nearest:
            base = torch.randint(-1, 50, (off + n,), generator=g, device=dev).float()
            base[base < 0] = -0.0
        else:
            base = _with_negative_zeros(100.0 * torch.randn(off + n, generator=g, device=dev))
        return base[off:].view(B, D, H, S)

    xa, xb = operand(offsets[0], False), operand(offsets[1], nearest_b)
    if disp_kind == "slice":
        coefs = (torch.rand((B, D, 4), generator=g, device=dev) - 0.5) * torch.tensor([0.0, 0.2, 0.04, 8.0], device=dev)
        coefs[..., 2] += 1.0
    else:
        r = S / OW
        coefs = torch.tensor([[0.25, -0.5, r, 0.5], [0.05, -0.04, 1.02 * r, -0.3 * S], [0.0, 0.0, -r, S - 1.0]],
                             device=dev)[:B].contiguous()
    disp = None
    if disp_kind == "volume":
        disp = (torch.rand((B, D, H, OW), generator=g, device=dev) - 0.5) * (S / 2)
        disp[..., ::5] = torch.round(disp[..., ::5]) + 0.5
        disp[..., 1::7] = -0.0
    elif disp_kind == "lane":
        disp = torch.randn((B, 3, OW), generator=g, device=dev) * torch.tensor([[[0.3], [0.3], [S / 8]]], device=dev)
    return xa, xb, coefs, disp


@pytest.mark.parametrize("case", sorted(K1_SHAPES))
@pytest.mark.parametrize("form", K1_FORMS, ids=lambda f: f"{f[0]}-{f[1]}")
def test_pair_kernel_bits(dev, form, case):
    """K1 on the ring in every instantiated form bit for bit (as int32) with
    its plain version at partial tiles across samples and slices, an odd S
    above 3630, OW != S and operands off 16 bytes."""
    disp_kind, nearest_b = form
    shape, OW, offsets = K1_SHAPES[case]
    if disp_kind in (None, "slice"):
        OW = shape[-1]
    xa, xb, coefs, disp = _pair_inputs(dev, disp_kind, nearest_b, shape, OW, offsets, shape[-1] + len(case))
    assert (xa.data_ptr() % 16 != 0) == (case == "offsets") and (xb.data_ptr() % 16 != 0) == (case == "offsets")
    got = hat.hat_pass_pair(xa, xb, coefs, disp, nearest_b)
    want = hat.hat_pass_pair_ref(xa, xb, coefs, disp, nearest_b)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)


def test_hat_pair_geometry(dev):
    """K1's launches: 16 KB tiles per operand in three stages on a grid of
    whole SMs' worth of blocks at B=4 256^3 in every form, each operand's
    buffer four floats longer than its tile (room for a tile's lead); tiles
    of any row count (one row at S = 6143, three stages)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for nearest_b, per_slice, disp in ((True, False, "volume"), (True, False, "none"), (False, False, "lane"),
                                       (False, True, "none")):
        geo = hat.hat_pair_geometry((4, 256, 256, 256), nearest_b, per_slice, disp)
        assert geo == {"tile_rows": 16, "stages": 3, "grid": geo["grid"], "smem_bytes": 128 + 3 * 2 * 4100 * 4}
        assert geo["grid"] % sms == 0 and geo["grid"] < 4 * 256 * 256 // 16
    assert hat.hat_pair_geometry((3, 40, 30, 5)) == {"tile_rows": 819, "stages": 3, "grid": 5,
                                                     "smem_bytes": 128 + 3 * 2 * 4100 * 4}
    geo = hat.hat_pair_geometry((1, 1, 8, 6143))
    assert geo == {"tile_rows": 1, "stages": 3, "grid": 8, "smem_bytes": 128 + 3 * 2 * 6148 * 4}


@pytest.mark.parametrize("n", [1, 3, 5, 4099, 4096 * 3 + 2, 1 << 20])
def test_pair_copy_bits(dev, n):
    """K5 copies every bit pattern (NaN payloads, -0.0, denormals) at sizes
    that end inside a 16-byte unit and a tile; operands off 16 bytes are
    refused."""
    from fetalsyngen_torch.kernels import probes

    g = torch.Generator(device=dev).manual_seed(n)
    xa, xb = (torch.randint(-2**31, 2**31 - 1, (n,), generator=g, device=dev, dtype=torch.int32).view(torch.float32)
              for _ in range(2))
    assert _bits_equal(probes.pair_copy(xa, xb), (xa, xb))
    off = torch.zeros(n + 1, device=dev)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        probes.pair_copy(off, off)


@pytest.mark.parametrize("shape", [(3, 5, 7), (2, 64, 96), (1, 33, 65, 40)])
def test_pair_copy_and_transpose_match_plain(dev, shape):
    from fetalsyngen_torch.kernels import probes

    g = torch.Generator(device=dev).manual_seed(len(shape) * 100 + shape[-1])
    xa, xb = (torch.randn(shape, generator=g, device=dev) for _ in range(2))
    for kernel, plain in ((probes.pair_copy, probes.pair_copy_ref), (probes.pair_transpose, probes.pair_transpose_ref)):
        got, want = kernel(xa, xb), plain(xa, xb)
        torch.cuda.synchronize()
        assert all(torch.equal(k, r) for k, r in zip(got, want))


# (B, D, H) rows of the probe tests: rows that fill no whole tile, one row per
# volume, rows that end in a partial tile, and rows enough that each block
# walks its ring of tiles more than once
PROBE_ROWS = [(2, 3, 8), (1, 3, 7), (2, 1, 1), (1, 5, 67), (3, 100, 101)]


def _with_negative_zeros(x):
    x.view(-1)[::7] = -0.0
    return x


def _bits_equal(got, want):
    return all(torch.equal(k.view(torch.int32), r.view(torch.int32)) for k, r in zip(got, want))


@pytest.mark.parametrize("S", [5, 16, 256, 300])
@pytest.mark.parametrize("rows", PROBE_ROWS)
def test_probe2_matches_plain(dev, rows, S):
    """K3, every mode bit for bit; S = 5 puts rows and the operand's end off
    16 bytes."""
    from fetalsyngen_torch.kernels import probes

    g = torch.Generator(device=dev).manual_seed(S)
    xa, xb = (_with_negative_zeros(torch.randn((*rows, S), generator=g, device=dev)) for _ in range(2))
    for mode, ntaps in (("copy", 0), ("stage", 0), ("taps", 1), ("taps", 8), ("taps", 13), ("taps", S + 128)):
        got, want = probes.probe2(xa, xb, mode, ntaps), probes.probe2_ref(xa, xb, mode, ntaps)
        torch.cuda.synchronize()
        assert _bits_equal(got, want), (mode, ntaps)


@pytest.mark.parametrize("S", [128, 384, 1024])
@pytest.mark.parametrize("rows", [(2, 3, 24)] + PROBE_ROWS[1:])
def test_probe_matches_plain(dev, rows, S):
    """K4, every mode bit for bit (tiles turns -0.0 into +0)."""
    from fetalsyngen_torch.kernels import probes

    x = torch.randn((*rows, S), generator=torch.Generator(device=dev).manual_seed(S), device=dev)
    _with_negative_zeros(x)
    for mode in probes.SINGLE_MODES:
        got, want = probes.probe(x, mode), probes.probe_ref(x, mode)
        torch.cuda.synchronize()
        assert _bits_equal((got,), (want,)), mode


def test_probe_wrappers_reject_bad_inputs(dev):
    """K3's and K4's launch limits: 16-byte alignment, and two ring stages of
    the fewest rows a tile may hold in shared memory."""
    from fetalsyngen_torch.kernels import probes

    off = torch.zeros(1 + 2 * 128, device=dev)[1:].view(1, 1, 2, 128)  # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        probes.probe(off, "stage")
    with pytest.raises(ValueError, match="16-byte aligned"):
        probes.probe2(off, off, "copy")
    with pytest.raises(ValueError, match="shared memory for two ring stages of 1-row"):
        probes.probe(torch.zeros((1, 1, 1, 227 * 128), device=dev), "stage")
    with pytest.raises(ValueError, match="shared memory for two ring stages of 4-row"):
        probes.probe2(*(torch.zeros((1, 1, 1, 3631), device=dev) for _ in range(2)), "stage")
    x = torch.randn((1, 1, 2, 226 * 128), device=dev)  # the largest S whose two 1-row stages fit
    assert torch.equal(probes.probe(x, "stage"), x)


def test_probe_geometry(dev):
    """K3 and K4 at B=4 256^3: 16- and 32-row tiles in three stages and a
    grid of whole SMs' worth of blocks drawing tiles; copy one tile per block
    with no shared memory."""
    from fetalsyngen_torch.kernels import probes

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kernel, mode, rows, stages in ((3, "stage", 16, 3), (3, "taps", 16, 3), (4, "sweep12", 32, 3),
                                       (3, "copy", 16, 0), (4, "copy", 32, 0)):
        geo = probes.probe_geometry(kernel, (4, 256, 256, 256), mode)
        ops = 2 if kernel == 3 else 1
        smem = 128 + stages * ops * rows * 1024
        assert geo == {"tile_rows": rows, "stages": stages, "grid": geo["grid"], "smem_bytes": smem if stages else 0}
        ntiles = 4 * 256 * 256 // rows
        assert geo["grid"] == ntiles if mode == "copy" else geo["grid"] % sms == 0 and geo["grid"] < ntiles


@pytest.mark.parametrize("D, H, S, scale", [(2, 32, 384, 0.02), (1, 64, 384, 0.5), (4, 16, 100, 0.3),
                                           (1, 64, 1000, 0.3)])
def test_hat_variant_matches_plain(dev, D, H, S, scale):
    """K7's five variants, with saturated rows and spans past the budget in
    the wider tables; at S = 1000 the rows and positions of a block do not
    fit shared memory, so taps come from device memory."""
    from fetalsyngen_torch.kernels import probes

    g = torch.Generator(device=dev).manual_seed(S + D)
    x = torch.rand((D, H, S), generator=g, device=dev)
    coefs = torch.tensor([0.25, -0.125, 1.0, 0.3], device=dev)
    table = torch.randn((3, S), generator=g, device=dev) * scale
    for v in probes.VARIANTS:
        got, want = probes.hat_variant(x, coefs, table, v), probes.hat_variant_ref(x, coefs, table, v)
        torch.cuda.synchronize()
        assert torch.equal(got, want), v


def test_hat_variant_offset_view(dev):
    """K7 on a contiguous view 4 bytes into a larger tensor (copied on the
    card before the bulk copies), bit for bit in every variant."""
    from fetalsyngen_torch.kernels import probes

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand(1 + 64 * 96, generator=g, device=dev)[1:].view(2, 32, 96)
    coefs = torch.tensor([0.25, -0.125, 1.0, 0.3], device=dev)
    table = torch.randn((3, 96), generator=g, device=dev) * 0.3
    for v in probes.VARIANTS:
        got, want = probes.hat_variant(x, coefs, table, v), probes.hat_variant_ref(x, coefs, table, v)
        torch.cuda.synchronize()
        assert _bits_equal((got,), (want,)), v


def test_hat_variant_longest_row(dev):
    """K7 at the longest row its library reports, in every variant, bit for
    bit; one float more is refused before a launch."""
    from fetalsyngen_torch.kernels import probes

    S = probes.variant_max_s()
    assert S > 864  # past the rows and positions a block keeps
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.rand((1, 32, S), generator=g, device=dev)
    coefs = torch.tensor([0.25, -0.125, 1.0, 0.3], device=dev)
    table = torch.randn((3, S), generator=g, device=dev) * 0.3
    for v in probes.VARIANTS:
        got, want = probes.hat_variant(x, coefs, table, v), probes.hat_variant_ref(x, coefs, table, v)
        torch.cuda.synchronize()
        assert _bits_equal((got,), (want,)), v
    wide = torch.zeros((1, 32, S + 1), device=dev)
    with pytest.raises(ValueError, match="at most"):
        probes.hat_variant(wide, coefs, torch.zeros((3, S + 1), device=dev), 0)


# ---------------------------------------------------------------------------
# the artifact-free input stream on the card, at 64^3
# ---------------------------------------------------------------------------

STREAM_SHAPE = (64, 64, 64)


def _stream_dataset(dev, root):
    from fetalsyngen_torch.data.datasets import FetalSynthDataset
    from fetalsyngen_torch.generator import model as m

    labels = [0] + list(range(10, 50))
    classes = [0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50))
    gen = m.FetalSynthGen(
        shape=STREAM_SHAPE, resolution=(0.5, 0.5, 0.5),
        intensity_generator=m.ImageFromSeeds(1, 2, labels, classes),
        spatial_deform=m.SpatialDeformation(20, 0.02, 0.1, STREAM_SHAPE, 0.9, True, 0.03, 0.06, 4.0, 0.5),
        resampler=m.RandResample(0.9, 0.5, 1.5), bias_field=m.RandBiasField(0.9, 0.004, 0.02, 0.01, 0.3),
        noise=m.RandNoise(0.9, 5, 15), gamma=m.RandGamma(0.9, 0.1), device=dev, seed=0,
    )
    return FetalSynthDataset(str(root), gen, str(root / "derivatives" / "seeds"))


@pytest.fixture
def stream_ds(dev, tmp_path):
    from fetalsyngen_torch.testing import build_bids_tree

    return _stream_dataset(dev, build_bids_tree(tmp_path / "bids", shape=STREAM_SHAPE))


def _take(stream, n):
    it = iter(stream)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()


def test_stream_matches_cpu(stream_ds, monkeypatch):
    """A batch on the card against the port's batch program on the CPU, with
    the card's parameters and fields, in the f32 mode (``FSG_STREAM_BF16=0``;
    ``test_production_core_card_vs_cpu`` holds the production mode): image
    within 1e-4, labels differing on at most 1e-5 of voxels (chip_smoke's
    bars)."""
    from fetalsyngen_torch.parallel.input_pipeline import SyntheticStream, batch_program

    monkeypatch.setenv("FSG_STREAM_BF16", "0")

    stream = SyntheticStream(stream_ds, batch_size=2, seed=1, prefetch=False)
    batch = _take(stream, 1)[0]
    meta = batch["meta"]
    assert batch["image"].device.type == "cuda" and stream.banks.records[meta["resident"][0]]["reader"] == "native"
    gens = tpipe.make_generators(meta["seeds"], stream.device)
    p = sample_params(gens, stream.cfg)
    f = tpipe.draw_fields(gens, stream.cfg, stream.device)
    banks = stream._banks_for(meta["resident"])
    img, seg = batch_program(
        *(t.cpu() for t in banks), torch.from_numpy(meta["subj"]), torch.from_numpy(meta["u"]),
        p.to("cpu"), f.to("cpu"), stream.cfg, stream._lo,
    )
    torch.testing.assert_close(batch["image"].cpu(), img, rtol=0, atol=1e-4)
    assert (batch["label"].cpu() != seg).sum().item() <= 1e-5 * seg.numel()


def test_stream_replay_and_prefetch_bit_identical(stream_ds):
    from fetalsyngen_torch.parallel.input_pipeline import SyntheticStream

    on = _take(SyntheticStream(stream_ds, batch_size=2, seed=4, prefetch=True), 3)
    off = _take(SyntheticStream(stream_ds, batch_size=2, seed=4, prefetch=False), 3)
    for a, b in zip(on, off):
        assert torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])
    fresh = SyntheticStream(stream_ds, batch_size=2, seed=0, prefetch=False)
    for b in (on[2], off[1]):
        r = fresh.replay_batch(b["meta"])
        assert torch.equal(r["image"], b["image"]) and torch.equal(r["label"], b["label"])


def test_stream_launches_k1_three_times_per_batch(stream_ds, monkeypatch):
    """Three K1 launches a batch: its bf16 form at the stream's default, its
    f32 form under ``FSG_STREAM_BF16=0``."""
    from fetalsyngen_torch.parallel.input_pipeline import SyntheticStream

    for env, form in ((None, "hat_pass_pair_bf16"), ("0", "hat_pass_pair")):
        if env is not None:
            monkeypatch.setenv("FSG_STREAM_BF16", env)
        stream = SyntheticStream(stream_ds, batch_size=2, seed=2, prefetch=False)
        _take(stream, 1)
        for k in hat.LAUNCHES:
            hat.LAUNCHES[k] = 0
        _take(stream, 4)
        torch.cuda.synchronize()
        assert hat.LAUNCHES == {**dict.fromkeys(hat.LAUNCHES, 0), form: 12}


COHORT = tuple(f"sub-c{i}" for i in range(6))


@pytest.mark.parametrize("mix, budget", [(6, None), (2, 3)], ids=["all_resident", "rotation_evicts"])
def test_cohort_slots_on_the_card(dev, tmp_path, monkeypatch, mix, budget):
    """Six distinct phantoms at 64^3 on the card, every one resident, or two
    at a time under a budget of three banks so that the rotation evicts:
    the slot each element gathers holds its own subject's bank and
    segmentation, byte for byte, and the element equals its computation
    alone from its own seed files (B=1, f32; chip_smoke's bars)."""
    from fetalsyngen_torch.io import nifti
    from fetalsyngen_torch.parallel import input_pipeline as ip
    from fetalsyngen_torch.testing import build_bids_tree

    monkeypatch.setenv("FSG_STREAM_BF16", "0")
    ds = _stream_dataset(dev, build_bids_tree(tmp_path / "cohort", np.random.default_rng(3), shape=STREAM_SHAPE,
                                              subjects=COHORT))
    stream = ip.SyntheticStream(ds, batch_size=3, seed=2**31 + 7, prefetch=False, mix_subjects=mix)
    if budget is not None:
        stream.banks.max_bytes = budget * 2 * 4 * int(np.prod(STREAM_SHAPE))
    evictions = ip.BANK_COUNTS["evictions"]
    batches = _take(stream, 5)
    assert stream.banks.capacity == (budget or 6)
    assert (ip.BANK_COUNTS["evictions"] > evictions) == (budget is not None)
    seg_of = {ds._sub_ses_idx(i): path for i, path in enumerate(ds.segm_paths)}
    names = set()
    for batch in batches:
        meta = batch["meta"]
        banks, segs, hi, slots = stream._banks_for(meta["resident"])
        for j in range(3):
            name = meta["resident"][int(meta["subj"][j])]
            names.add(name)
            assert batch["name"][j] == name
            slot = int(slots[int(meta["subj"][j])])
            bank = ip.SeedBankCache({name: ds.seed_paths[name]}, device=dev).bank(name)
            seg = torch.from_numpy(nifti.load_ras(str(seg_of[name])).data.astype(np.int32)).to(dev)
            assert torch.equal(banks[slot], bank) and torch.equal(segs[slot].int(), seg)
            choice = ip.choose_options(torch.from_numpy(meta["u"][j : j + 1]).to(dev),
                                       hi[slot : slot + 1], stream._lo)[0]
            gens = tpipe.make_generators(meta["seeds"][j : j + 1], dev)
            with ip._production_scopes():
                out, lab, _ = tpipe.synth_core(sample_params(gens, stream.cfg), tpipe.draw_fields(gens, stream.cfg, dev),
                                               ip.compose_seeds(bank, choice)[None], seg[None], stream.cfg)
            out = out.float()
            peak = out.amax(dim=(1, 2, 3), keepdim=True)
            torch.testing.assert_close(batch["image"][j], (out / torch.where(peak > 0, peak, 1.0))[0], rtol=0, atol=1e-4)
            assert (batch["label"][j] != lab[0]).sum().item() <= 1e-5 * lab[0].numel()
    assert len(names) >= 4


def test_many_prefetching_iterators_share_one_side_stream(stream_ds):
    """More prefetching iterators than the ring kernels' 64 tile-counter
    slots: every producer runs on the device's one side stream."""
    from fetalsyngen_torch.parallel import input_pipeline as ip

    stream = ip.SyntheticStream(stream_ds, batch_size=1, seed=3, prefetch=True)
    for _ in range(70):
        batch = _take(stream, 1)[0]
    torch.cuda.synchronize()
    assert bool(torch.isfinite(batch["image"]).all())
    assert list(ip._SIDE_STREAMS) == [stream.device.index]


# ---------------------------------------------------------------------------
# the stream's artifact chain on the card
# ---------------------------------------------------------------------------

# (D, H, S) of the stream's K2 forms, at partial tiles: the lane-affine
# extraction and recon value passes, the pooled weight pass, the per-slice
# passes on (ns_grid, cube, cube)
STREAM_K2 = {"lane": [(37, 41, 256), (33, 128, 128), (5, 7, 384)], "slice": [(96, 45, 256), (96, 7, 384)]}


@pytest.mark.parametrize("kind, shape", [(k, s) for k, ss in STREAM_K2.items() for s in ss])
def test_stream_k2_forms_bits(dev, kind, shape):
    from fetalsyngen_torch.generator.artifacts import scanner as sc

    D, H, S = shape
    g = torch.Generator(device=dev).manual_seed(D * H + S)
    x = 100.0 * torch.rand((1, D, H, S), generator=g, device=dev)
    if kind == "lane":
        coefs = sc._unit_coefs(dev)[None]
        disp = (torch.rand((1, 3, S), generator=g, device=dev) - 0.5) * torch.tensor([[[0.4], [0.4], [9.0]]], device=dev)
        disp[..., ::7] = torch.round(disp[..., ::7]) + 0.5
    else:
        coefs = torch.rand((1, D, 4), generator=g, device=dev) - 0.5
        coefs[..., 0] = 0.0
        coefs[..., 2] += 1.0
        coefs[..., 3] *= S / 8
        disp = None
    got = hat.hat_pass(x, coefs, disp)
    want = hat.hat_pass_ref(x, coefs, disp)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_acceptance_one_read_equals_sequential(dev):
    """The stream's acceptance from one read of the (Kb, ns) validity
    equals the sequential rule that reads each stack's count as it goes."""
    from fetalsyngen_torch.generator.artifacts import batched as tba

    g = torch.Generator(device=dev).manual_seed(1)
    for trial in range(60):
        valid = (torch.rand((6, 96), generator=g, device=dev) < 0.3 * (trial % 4)).float()
        valid[trial % 6] = 0.0
        num_stacks, max_slices = 2 + trial % 5, 40.0 + 10 * (trial % 7)
        got = tba.accept_stacks(valid.cpu().numpy().sum(1), num_stacks, max_slices)
        count, total, want = 0, 0.0, []
        for k in range(valid.shape[0]):
            if count >= num_stacks:
                break
            nv = valid[k].sum().item()
            if nv > 0 and total + nv >= max_slices:
                break
            if nv > 0:
                want.append(k)
                count += 1
                total += nv
        assert got == want, (trial, got, want)


@pytest.fixture
def artifact_ds(dev, tmp_path):
    from fetalsyngen_torch.data.datasets import FetalSynthDataset
    from fetalsyngen_torch.generator import model as m
    from fetalsyngen_torch.generator.artifacts import quality as q
    from fetalsyngen_torch.generator.artifacts import scanner as sc
    from fetalsyngen_torch.testing import build_bids_tree

    root = build_bids_tree(tmp_path / "bids", shape=STREAM_SHAPE)
    labels = [0] + list(range(10, 50))
    classes = [0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50))
    perlin = dict(perlin_res_list=[1, 2], perlin_octaves_list=[1, 2], perlin_persistence=0.5, perlin_lacunarity=2)
    motion = sc.SimulateMotion(
        1.0, sc.ScannerParams(0.5, 2, 1.5, 1.5, 3.5, 1.5, 5.5, 2, 4, 250, 0, 0.1, 1, 2, 0.2, 0.1, 0.05),
        sc.ReconParams(0.1, 0.1, 0.1, 3.0, 0.2, 0.3, 0.1, 0.4, 1.0,
                       q.ReconMergeParams("perlin", perlin_increase_size=0.25, **perlin)),
        tiers=(128, 256), ns_grid=64,
    )
    gen = m.FetalSynthGen(
        shape=STREAM_SHAPE, resolution=(0.5, 0.5, 0.5),
        intensity_generator=m.ImageFromSeeds(1, 2, labels, classes),
        spatial_deform=m.SpatialDeformation(20, 0.02, 0.1, STREAM_SHAPE, 0.9, True, 0.03, 0.06, 4.0, 0.5),
        resampler=m.RandResample(0.9, 0.5, 1.5), bias_field=m.RandBiasField(0.9, 0.004, 0.02, 0.01, 0.3),
        noise=m.RandNoise(0.9, 5, 15), gamma=m.RandGamma(0.9, 0.1), device=dev, seed=0,
        blur_cortex=q.BlurCortex(1.0, 2, 10, 40),
        struct_noise=q.StructNoise(1.0, 3, 0.2, 0.4, q.StructNoiseMergeParams("perlin", perlin_increase_size=0.1,
                                                                            **perlin)),
        simulate_motion=motion, boundaries=q.SimulatedBoundaries(0.0, 1.0, 1.0),
    )
    return FetalSynthDataset(str(root), gen, str(root / "derivatives" / "seeds"))


def test_stream_artifacts_card_vs_cpu(artifact_ds, monkeypatch):
    """A B=2 batch with the four artifacts on the card against the port's
    CPU path, in the f32 mode (``FSG_STREAM_BF16=0``): the core's labels
    within 1e-5 of voxels (nearest-label ties may flip); the chain on the
    CPU from the card's core output with the card's recorded draws: the same
    validity flags, within 1e-4 of its scale outside the voxels whose recon
    weight crosses 1e-2 between the two (grown by one voxel where the box
    smooth ran) or whose boundaries mask differs; the recorded rerun
    bit-identical to the batch."""
    from fetalsyngen_torch.generator.artifacts import batched as tba
    from fetalsyngen_torch.ops.morphology import box_sum
    from fetalsyngen_torch.parallel.input_pipeline import SyntheticStream, batch_program

    monkeypatch.setenv("FSG_STREAM_BF16", "0")

    stream = SyntheticStream(artifact_ds, batch_size=2, seed=1, prefetch=False)
    batch = _take(stream, 1)[0]
    meta = batch["meta"]
    assert stream.cubes == (128, 256) and meta["pack"]["motion_on"].all()
    rec = tba.chain_draws(meta["seeds"], stream.device, record=True)
    tr_gpu, tr_cpu, core = [], [], {}
    chain_gpu = stream.make_chain(meta, draws=rec, traces=tr_gpu)

    def chain(out, seg):
        core.update(out=out.cpu(), seg=seg.cpu())
        core["chain"] = chain_gpu(out, seg).cpu()
        return core["chain"].to(out.device)

    gens = tpipe.make_generators(meta["seeds"], stream.device)
    p = sample_params(gens, stream.cfg)
    f = tpipe.draw_fields(gens, stream.cfg, stream.device)
    banks = stream._banks_for(meta["resident"])
    args = (torch.from_numpy(meta["subj"]), torch.from_numpy(meta["u"]))
    img, _ = batch_program(*banks, *(a.to(stream.device) for a in args), p, f, stream.cfg, stream._lo, chain)
    assert torch.equal(img, batch["image"])
    _, seg = batch_program(*(t.cpu() for t in banks), *args, p.to("cpu"), f.to("cpu"), stream.cfg, stream._lo)
    assert (core["seg"] != seg).sum().item() <= 1e-5 * seg.numel()
    chain_cpu = stream.make_chain(meta, draws=[tba.Draws(d.seed, "cpu", given=d.recorded) for d in rec],
                                  traces=tr_cpu)
    out = chain_cpu(core["out"], core["seg"])
    for b in range(2):
        assert tr_gpu[b]["accepted"] == tr_cpu[b]["accepted"]
        assert np.array_equal(tr_gpu[b]["valid"], tr_cpu[b]["valid"])
        flips = (tr_gpu[b]["weight"].cpu() > 1e-2) != (tr_cpu[b]["weight"] > 1e-2)
        if meta["pack"]["smooth_on"][b]:
            flips = box_sum(flips.float(), 3) > 0
        flips |= tr_gpu[b]["mask"].cpu() != tr_cpu[b]["mask"]
        assert flips.float().mean() < 1e-3
        d = (core["chain"][b] - out[b]).abs()
        assert float(torch.where(flips, 0.0, d).max()) <= 1e-4 * float(core["chain"][b].abs().max())


def test_stream_artifacts_replay_prefetch_and_one_read(artifact_ds):
    """Prefetch on and off give the same batches; a batch replays on a fresh
    stream; a batch under sync debug mode "error" makes one planned read."""
    from fetalsyngen_torch.generator.artifacts import batched as tba
    from fetalsyngen_torch.parallel.input_pipeline import SyntheticStream

    on = _take(SyntheticStream(artifact_ds, batch_size=2, seed=4, prefetch=True), 2)
    off = _take(SyntheticStream(artifact_ds, batch_size=2, seed=4, prefetch=False), 2)
    for a, b in zip(on, off):
        assert torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])
    r = SyntheticStream(artifact_ds, batch_size=2, seed=0, prefetch=False).replay_batch(off[1]["meta"])
    assert torch.equal(r["image"], off[1]["image"])
    stream = SyntheticStream(artifact_ds, batch_size=2, seed=5, prefetch=False)
    _take(stream, 1)
    torch.cuda.synchronize()
    before = tba.COUNTS["transfers"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch = stream._generate()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tba.COUNTS["transfers"] - before == 1
    assert bool(torch.isfinite(batch["image"]).all())


# ---------------------------------------------------------------------------
# the segmentation trainer
# ---------------------------------------------------------------------------


def _train_inputs(dev, shape=(32, 32, 32)):
    from fetalsyngen_torch.train.segmentation import example_cfg

    seeds, seg = phantom_seeds_and_seg(shape, seed=0)
    seeds = torch.from_numpy(seeds.astype(np.int32))[None].to(dev)
    segs = torch.from_numpy(seg.astype(np.int32))[None].to(dev)
    return seeds, segs, example_cfg(shape)


def test_train_step_card_vs_cpu(dev):
    """One fused step of the f32 UNet (TF32 off) on the card's generated
    batch, on the card and on the CPU from the same weights: the loss within
    1e-4 relative, each gradient within 1e-3 of its leaf's max |g|; the
    step launches K1 three times. (16, 32) channels: at most 8 channels a
    GroupNorm has one channel per group, and the conv bias before it a zero
    gradient in exact arithmetic, rounding noise on both sides.)"""
    from fetalsyngen_torch.train import step as tstep
    from fetalsyngen_torch.train.unet import UNet3D

    seeds, segs, cfg = _train_inputs(dev)
    states = [tstep.create_train_state(3, UNet3D((16, 32), dtype=torch.float32), cfg.shape, device=d)
              for d in (dev, "cpu")]
    for k in hat.LAUNCHES:
        hat.LAUNCHES[k] = 0
    images, labels = tstep.generate([5], seeds, segs, cfg, dev)
    assert hat.LAUNCHES["hat_pass_pair"] == 3
    (_, l_card), (_, l_cpu) = (tstep.train_on(st, images.to(d), labels.to(d)) for st, d in zip(states, (dev, "cpu")))
    assert abs(float(l_card) - float(l_cpu)) <= 1e-4 * abs(float(l_cpu))
    for (name, a), b in zip(states[0].model.named_parameters(), states[1].model.parameters()):
        assert float((a.grad.cpu() - b.grad).abs().max()) <= 1e-3 * float(b.grad.abs().max()), name


def test_train_bf16_steps_are_finite_and_replay(dev):
    """The default bf16 UNet3D at 32^3: three steps with finite losses; the
    same seeds from the same weights give the same first loss."""
    from fetalsyngen_torch.train import step as tstep
    from fetalsyngen_torch.train.unet import UNet3D

    seeds, segs, cfg = _train_inputs(dev)
    firsts = []
    for _ in range(2):
        state = tstep.create_train_state(0, UNet3D(), cfg.shape, device=dev)
        losses = [float(tstep.generate_and_train_step(state, [i], seeds, segs, cfg)[1]) for i in range(3)]
        assert all(np.isfinite(losses)) and state.step == 3
        firsts.append(losses[0])
    assert firsts[0] == firsts[1]


def test_train_step_through_ddp_world_one(dev, tmp_path, monkeypatch):
    """``make_sharded_train_step`` under an NCCL group of world size 1 wraps
    the model in DDP and, cuDNN deterministic, gives the plain step's loss
    (1e-5 relative) and gradients (1e-5 of each leaf's max |g|), and each
    weight is AdamW's first step of its gradient (1e-6)."""
    import torch.distributed as dist

    from fetalsyngen_torch.parallel.sharding import data_group
    from fetalsyngen_torch.train import step as tstep
    from fetalsyngen_torch.train.unet import UNet3D

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    seeds, segs, cfg = _train_inputs(dev)
    plain = tstep.create_train_state(1, UNet3D(), cfg.shape, device=dev)
    want = float(tstep.generate_and_train_step(plain, [7], seeds, segs, cfg)[1])
    state = tstep.create_train_state(1, UNet3D(), cfg.shape, device=dev)
    init = [p.detach().clone() for p in state.model.parameters()]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        step = tstep.make_sharded_train_step(state, cfg, data_group(dev))
        assert isinstance(step.module, torch.nn.parallel.DistributedDataParallel)
        got = float(step([7], seeds, segs))
    finally:
        dist.destroy_process_group()
    assert state.step == 1 and abs(got - want) <= 1e-5 * abs(want)
    for p0, p, q in zip(init, state.model.parameters(), plain.model.parameters()):
        assert float((p.grad - q.grad).abs().max()) <= 1e-5 * float(q.grad.abs().max())
        adamw = p0 * (1 - 1e-3 * tstep.ADAMW["weight_decay"]) - 1e-3 * p.grad / (p.grad.abs() + 1e-8)
        assert float((p.detach() - adamw).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# the bf16 forms of K1 and K2 (the stream's production mode)
# ---------------------------------------------------------------------------

# K1's bf16 forms (displacement kind, nearest second operand) and K2's
# (coef mode, nearest, displacement kind)
K1_BF16_FORMS = [("volume", True), ("lane", False)]
K2_BF16_FORMS = [("sample", False, None), ("sample", True, None), ("sample", False, "lane"), ("slice", False, None),
                 ("sample", False, "volume"), ("sample", True, "volume")]


def _bf16_view(t: torch.Tensor, off_bytes: int) -> torch.Tensor:
    """``t`` rounded to bf16, as a contiguous view ``off_bytes`` (a multiple
    of 2) into a larger tensor; -0.0 kept."""
    flat = torch.empty(t.numel() + 8, dtype=torch.bfloat16, device=t.device)
    view = flat[off_bytes // 2 : off_bytes // 2 + t.numel()].view(t.shape)
    view.copy_(t.to(torch.bfloat16))
    assert view.data_ptr() % 16 == off_bytes % 16
    return view


def _bits16(got, want):
    return all(k.dtype == torch.bfloat16 and torch.equal(k.view(torch.int16), r.view(torch.int16))
               for k, r in zip(got, want))


@pytest.mark.parametrize("off", [0, 2, 4, 8])
@pytest.mark.parametrize("case", ["partial", "odd_s", "ow"])
@pytest.mark.parametrize("form", K1_BF16_FORMS, ids=lambda f: f"{f[0]}-{f[1]}")
def test_pair_kernel_bf16_bits(dev, form, case, off):
    """K1's bf16 forms bit for bit (as int16) with their plain version on
    bf16 rows: partial tiles across samples and slices, an odd S, OW != S,
    and both operands 0, 2, 4 and 8 bytes off 16 (the loose ring takes any
    bf16 offset)."""
    disp_kind, nearest_b = form
    shape, OW, _ = K1_SHAPES[case]
    xa, xb, coefs, disp = _pair_inputs(dev, disp_kind, nearest_b, shape, OW, (0, 0), shape[-1] + off)
    xa, xb = _bf16_view(xa, off), _bf16_view(xb, (off + 4) % 16 if off else 0)
    got = hat.hat_pass_pair(xa, xb, coefs, disp, nearest_b)
    want = hat.hat_pass_pair_ref(xa, xb, coefs, disp, nearest_b)
    torch.cuda.synchronize()
    assert _bits16(got, want)
    assert got[0].dtype == torch.bfloat16


# K2_ROWS and a 256-lane row, from which the per-sample forms without a
# displacement also write 240 and 272 lanes (the separable warp's U passes)
K2_BF16_ROWS = {**K2_ROWS, 256: (5, 7)}


@pytest.mark.parametrize("off", [0, 2, 4, 8])
@pytest.mark.parametrize("form", K2_BF16_FORMS, ids=lambda f: "-".join(str(v) for v in f))
@pytest.mark.parametrize("S", sorted(K2_BF16_ROWS))
def test_single_kernel_bf16_bits(dev, S, form, off):
    """K2's bf16 forms bit for bit (as int16) with their plain version, -0.0
    among the values, positions at half-integers and past both edges; an
    ``x`` off 16 bytes is copied to 16 bytes first (``hat.COPIES``). From
    256-lane rows the per-sample forms without a displacement write 256, 240
    and 272 lanes."""
    coef, nearest, disp_kind = form
    B, (D, H) = 3, K2_BF16_ROWS[S]
    g = torch.Generator(device=dev).manual_seed(S * 10 + len(str(form)) + off)
    if nearest:
        x = torch.randint(-1, 50, (B, D, H, S), generator=g, device=dev).float()
        x[x < 0] = -0.0
    else:
        x = _with_negative_zeros(100.0 * torch.randn((B, D, H, S), generator=g, device=dev))
    x = _bf16_view(x, off)
    if coef == "slice":
        coefs = (torch.rand((B, D, 4), generator=g, device=dev) - 0.5) * torch.tensor([0.0, 0.5, 0.2, S / 2],
                                                                                       device=dev)
        coefs[..., 2] += 1.0
    else:
        coefs = torch.tensor([[0.25, -0.5, 1.0, 0.5], [0.05, -0.04, 1.02, -0.3 * S], [0.0, 0.0, -1.0, S - 1.0]],
                             device=dev)
    disp = None
    if disp_kind == "lane":
        disp = torch.randn((B, 3, S), generator=g, device=dev) * torch.tensor([[[0.3], [0.3], [S / 8]]], device=dev)
    elif disp_kind == "volume":
        disp = (torch.rand((B, D, H, S), generator=g, device=dev) - 0.5) * (S / 2)
        disp[..., ::5] = torch.round(disp[..., ::5]) + 0.5
        disp[..., 1::7] = -0.0
    out_lens = (None, 240, 272) if S == 256 and coef == "sample" and disp_kind is None else (None,)
    for out_len in out_lens:
        copies = hat.COPIES["hat_pass"]
        got = hat.hat_pass(x, coefs, disp, nearest, out_len)
        want = hat.hat_pass_ref(x, coefs, disp, nearest, out_len)
        torch.cuda.synchronize()
        assert got.shape[-1] == (out_len or S)
        assert _bits16((got,), (want,))
        assert hat.COPIES["hat_pass"] - copies == (1 if off % 16 else 0)


def test_bf16_forms_not_instantiated_raise(dev):
    """A bf16 operand launches a bf16 kernel or raises: never the f32 one.
    Every f32 form has a bf16 twin, so the forms that raise are those
    without a kernel in either type: K2's nearest per-slice and lane-affine
    forms, K1's nearest lane-affine pair and K1's (nearest, nearest) pair
    with a displacement volume."""
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.zeros((1, 2, 3, 16), dtype=dtype, device=dev)
        coefs = torch.zeros((1, 4), device=dev)
        with pytest.raises(ValueError, match="no kernel"):
            hat.hat_pass(x, torch.zeros((1, 2, 4), device=dev), nearest=True)
        with pytest.raises(ValueError, match="no kernel"):
            hat.hat_pass(x, coefs, torch.zeros((1, 3, 16), device=dev), nearest=True)
        with pytest.raises(ValueError, match="no kernel"):
            hat.hat_pass_pair(x, x, coefs, torch.zeros((1, 3, 16), device=dev), nearest_b=True)
        with pytest.raises(ValueError, match="no kernel"):
            hat.hat_pass_pair(x, x, coefs, torch.zeros((1, 2, 3, 16), device=dev), nearest_b=True, nearest_a=True)
    x = torch.zeros((1, 2, 3, 16), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError, match="operand 2 must be bfloat16"):
        hat.hat_pass_pair(x, x.float(), coefs, torch.zeros((1, 2, 3, 16), device=dev))


def test_hat_geometry_bf16(dev):
    """K2's bf16 launches. The nearest per-sample form (the ring kernel): 16
    KB tiles hold twice the rows of f32 ones, in whole 16-byte units (eight
    bf16), two stages where three do not fit. The linear forms without a
    displacement volume, per-sample, lane-affine and per-slice (the lanes
    kernel): one 512-thread block an SM, 32 KB tiles of a multiple of the
    rows its 480 consumer threads compute at once (480 / ceil(OW / 8)) where
    that fits, and a pass of fewer than three tiles a block takes tiles of
    half the bytes, down to those rows."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf = torch.bfloat16
    geo = hat.hat_geometry((1, 256, 256, 256), True, dtype=bf)
    assert geo == {"tile_rows": 32, "stages": 3, "grid": geo["grid"], "smem_bytes": 128 + 3 * 16384}
    assert geo["grid"] % sms == 0 and geo["grid"] < 2048
    assert hat.hat_geometry((3, 40, 30, 5), True, dtype=bf) == {"tile_rows": 1632, "stages": 3, "grid": 3,
                                                                "smem_bytes": 128 + 3 * 16320}
    geo = hat.hat_geometry((1, 1, 8, 6143), True, dtype=bf)
    assert geo == {"tile_rows": 8, "stages": 2, "grid": 1, "smem_bytes": 128 + 2 * 8 * 6143 * 2}
    # the per-sample form at the stream's B=4 256^3
    geo = hat.hat_geometry((4, 256, 256, 256), dtype=bf)
    assert geo == {"tile_rows": 60, "stages": 3, "grid": sms, "smem_bytes": 128 + 3 * 60 * 256 * 2}
    for per_slice, disp in ((False, "none"), (False, "lane"), (True, "none")):
        # (shape, tile rows): 15, 10, 6, 30 and 30 rows at once; 128^3 and
        # the 6144-lane rows a small pass
        for shape, rows in (((1, 256, 256, 256), 60), ((1, 96, 384, 384), 40), ((1, 640, 640, 640), 24),
                            ((1, 640, 640, 128), 120), ((1, 128, 128, 128), 30), ((2, 3, 7, 6144), 1)):
            geo = hat.hat_geometry(shape, False, per_slice, disp, dtype=bf)
            ntiles = -(-shape[0] * shape[1] * shape[2] // rows)
            assert geo == {"tile_rows": rows, "stages": 3, "grid": min(ntiles, sms),
                           "smem_bytes": 128 + 3 * rows * shape[-1] * 2}, (shape, geo)
        # an odd S: tiles in units of eight rows, two stages at 6143
        geo = hat.hat_geometry((1, 1, 8, 6143), False, per_slice, disp, dtype=bf)
        assert geo == {"tile_rows": 8, "stages": 2, "grid": 1, "smem_bytes": 128 + 2 * 8 * 6143 * 2}


def test_hat_pair_geometry_bf16(dev):
    """K1's bf16 launches: the main form's 16 KB tiles per operand (32 rows
    at S = 256), each buffer whole 16-byte units with room for seven bf16 of
    lead; the lane-affine pair (the lanes kernel) on one 512-thread block an
    SM with 16 KB per operand (a 32 KB stage), its 128^3 pass on tiles of
    half the bytes."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf = torch.bfloat16
    geo = hat.hat_pair_geometry((4, 256, 256, 256), True, False, "volume", dtype=bf)
    assert geo == {"tile_rows": 32, "stages": 3, "grid": geo["grid"], "smem_bytes": 128 + 3 * 2 * 8200 * 2}
    assert geo["grid"] % sms == 0 and geo["grid"] < 4 * 256 * 256 // 32
    assert hat.hat_pair_geometry((3, 40, 30, 5), dtype=bf) == {"tile_rows": 1638, "stages": 3, "grid": 3,
                                                               "smem_bytes": 128 + 3 * 2 * 8200 * 2}
    geo = hat.hat_pair_geometry((1, 1, 8, 6143), dtype=bf)
    assert geo == {"tile_rows": 1, "stages": 3, "grid": 8, "smem_bytes": 128 + 3 * 2 * 6152 * 2}
    lane = dict(nearest_b=False, disp="lane", dtype=bf)
    # 60 rows of 128 lanes: 7680 bf16, each buffer 7688 (room for a lead)
    assert hat.hat_pair_geometry((1, 640, 640, 128), **lane) == {"tile_rows": 60, "stages": 3, "grid": sms,
                                                                 "smem_bytes": 128 + 3 * 2 * 7688 * 2}
    assert hat.hat_pair_geometry((1, 128, 128, 128), **lane) == {"tile_rows": 30, "stages": 3, "grid": sms,
                                                                 "smem_bytes": 128 + 3 * 2 * 3848 * 2}
    assert hat.hat_pair_geometry((1, 1, 8, 6143), **lane) == {"tile_rows": 1, "stages": 3, "grid": 8,
                                                              "smem_bytes": 128 + 3 * 2 * 6152 * 2}


# the lanes kernel's forms: (K1 pair, coefficient kind: "lane" per-sample
# with a lane-affine table, "slice", "sample" per-sample without a
# displacement); and the output widths of its tests: the stream's 128-640,
# widths that are not a multiple of 8 (rows off 16 bytes) and an odd one
# (rows off 4 bytes)
LANES_FORMS = [(False, "lane"), (False, "slice"), (True, "lane"), (False, "sample")]
LANES_OW = [128, 256, 384, 512, 640, 100, 77]


def _lanes_case(dev, pair, kind, OW, seed):
    """The inputs of a lanes-kernel test: B=3 samples of (5, 7) rows (tiles
    span samples and slices), bf16 rows with -0.0 among them, OW lanes out
    (K2: S = OW; K1: S = OW + 37). Lane-affine: general coefficients and a
    table whose lanes 3 mod 11 give exact half-integer positions, 5 mod 13
    and 6 mod 17 positions past either edge. Per-sample without a
    displacement: the same coefficients (sample 0's first row at exact
    half-integers, sample 1 past the low edge, sample 2 from edge to edge).
    Per-slice: the scanner's in-plane coefficients, slice 1 of sample 1 past
    the low edge, slice 3 of sample 2 past the high one. Returns (xa, xb or
    None, coefs, disp)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, D, H = 3, 5, 7
    S = OW + 37 if pair else OW
    rows = lambda: _with_negative_zeros(100.0 * torch.randn((B, D, H, S), generator=g, device=dev)).to(  # noqa: E731
        torch.bfloat16)
    xa, xb = rows(), rows() if pair else None
    if kind == "slice":
        coefs = torch.rand((B, D, 4), generator=g, device=dev) - 0.5
        coefs[..., 0] = 0.0
        coefs[..., 2] = 1.0 + 0.04 * coefs[..., 2]
        coefs[..., 3] *= 8.0
        coefs[1, 1, 3] = -2.0 * S
        coefs[2, 3, 3] = 2.0 * S
        return xa, xb, coefs, None
    coefs = torch.tensor([[0.25, -0.5, S / OW, 0.5], [0.05, -0.04, 1.02 * S / OW, -0.3 * S], [0.0, 0.0, 1.0, 0.0]],
                         device=dev)
    if kind == "sample":
        return xa, xb, coefs, None
    disp = (torch.rand((B, 3, OW), generator=g, device=dev) - 0.5) * torch.tensor([[[0.04], [0.04], [6.0]]],
                                                                                 device=dev)
    lanes = torch.arange(OW, device=dev)
    half = lanes % 11 == 3
    disp[2, :2, half] = 0.0
    disp[2, 2, half] = 0.5
    disp[:, 2, lanes % 13 == 5] = -3.0 * S
    disp[:, 2, lanes % 17 == 6] = 3.0 * S
    return xa, xb, coefs, disp


def _lanes_run(pair, xa, xb, coefs, disp, plain=False):
    if pair:
        fn = hat.hat_pass_pair_ref if plain else hat.hat_pass_pair
        return fn(xa, xb, coefs, disp, nearest_b=False)
    return ((hat.hat_pass_ref if plain else hat.hat_pass)(xa, coefs, disp),)


@pytest.mark.parametrize("OW", LANES_OW)
@pytest.mark.parametrize("pair, kind", LANES_FORMS, ids=lambda v: str(v))
def test_lanes_forms_bits(dev, pair, kind, OW):
    """The lanes kernel's forms (K2 lane-affine, per-slice and per-sample
    without a displacement, K1's lane-affine pair, bf16) bit for bit (as int16) with their plain versions
    at the stream's widths and at widths whose rows lie off 16 and 4 bytes,
    on tiles that span samples and slices, with exact half-integer positions
    and positions past both edges (the sign of zero kept)."""
    xa, xb, coefs, disp = _lanes_case(dev, pair, kind, OW, OW + 7 * pair + len(kind))
    R, H, S = xa.shape[1] * xa.shape[2], xa.shape[2], xa.shape[-1]
    pos = hat.positions(coefs, R, H, OW, lane=disp)
    assert bool((pos - torch.floor(pos) == 0.5).any()) or kind == "slice"
    assert bool((pos <= 0).any()) and bool((pos >= S - 1).any())
    key = hat.launch_key(pair, False, coefs, disp, torch.bfloat16)
    before = hat.LAUNCHES[key]
    got = _lanes_run(pair, xa, xb, coefs, disp)
    want = _lanes_run(pair, xa, xb, coefs, disp, plain=True)
    torch.cuda.synchronize()
    assert hat.LAUNCHES[key] == before + 1
    assert _bits16(got, want)


@pytest.mark.parametrize("pair, kind", LANES_FORMS, ids=lambda v: str(v))
def test_lanes_forms_nan_positions(dev, pair, kind):
    """A NaN position (a NaN table lane, a slice's or a sample's NaN bias)
    stays in the row: the lane is row[0] * 1 + row[1] * 0 in f32, rounded
    once, as the ring kernel computed it; every other lane bit for bit with
    the plain version on the same inputs made finite."""
    OW = 300
    xa, xb, coefs, disp = _lanes_case(dev, pair, kind, OW, 99 + pair)
    B, D, H, S = xa.shape
    nan_coefs, nan_disp = coefs.clone(), None if disp is None else disp.clone()
    if kind == "slice":
        nan_coefs[0, 2, 3] = float("nan")
        bad = torch.zeros((B, D, H, OW), dtype=torch.bool, device=dev)
        bad[0, 2] = True
    elif kind == "sample":
        nan_coefs[1, 3] = float("nan")
        bad = torch.zeros((B, D, H, OW), dtype=torch.bool, device=dev)
        bad[1] = True
    else:
        nan_disp[1, 2, 7::29] = float("nan")
        bad = torch.zeros((B, D, H, OW), dtype=torch.bool, device=dev)
        bad[1, ..., 7::29] = True
    got = _lanes_run(pair, xa, xb, nan_coefs, nan_disp)
    want = _lanes_run(pair, xa, xb, coefs, disp, plain=True)
    torch.cuda.synchronize()
    for k, r, x in zip(got, want, (xa, xb)):
        edge = (x[..., :1].float() * 1.0 + x[..., 1:2].float() * 0.0).to(torch.bfloat16).expand(B, D, H, OW)
        assert torch.equal(k[bad].view(torch.int16), edge[bad].view(torch.int16))
        assert torch.equal(k[~bad].view(torch.int16), r[~bad].view(torch.int16))


@pytest.mark.parametrize("reduced", [False, True])
def test_production_core_card_vs_cpu(dev, reduced):
    """``synth_core`` at 64^3 in the production mode on the card against the
    port's production mode on the CPU with the card's parameters and fields:
    labels within 1e-5 of voxels (phase 11's bar); the image, whose bf16
    roundings may fall the other way where the card sums in another order,
    within 2 bf16 ulps of its scale (chip_smoke measured one at 64^3) and a
    relative L2 of 1e-3. With cuBLAS's reduced-precision bf16 reductions
    off the GEMMs give bf16 results; with them allowed (``reduced``) the
    GEMMs write f32 results, so their sums stay f32 all the same. The mode
    leaves the setting as it was."""
    from fetalsyngen_torch.parallel.input_pipeline import _production_scopes

    shape = (64, 64, 64)
    cfg = GeneratorCfg(shape=shape, resolution=(0.5, 0.5, 0.5), intensity=IntensityCfg(
        1, 6, tuple([0] + list(range(10, 50))), tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))))
    seeds, seg = phantom_seeds_and_seg(shape, seed=1)
    seeds = torch.from_numpy(np.stack([seeds, seeds]).astype(np.int32))
    segs = torch.from_numpy(np.stack([seg, seg]).astype(np.int32))
    gens = tpipe.make_generators([3, 4], dev)
    p = sample_params(gens, cfg)
    f = tpipe.draw_fields(gens, cfg, dev)
    prior = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    before = dict(hat.LAUNCHES)
    try:
        with _production_scopes():
            out, lab, _ = tpipe.synth_core(p, f, seeds.to(dev), segs.to(dev), cfg)
            torch.cuda.synchronize()
            out_c, lab_c, _ = tpipe.synth_core(p.to("cpu"), f.to("cpu"), seeds, segs, cfg)
        assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction == reduced
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = prior
    assert hat.LAUNCHES["hat_pass_pair_bf16"] - before["hat_pass_pair_bf16"] == 3
    assert hat.LAUNCHES["hat_pass_pair"] == before["hat_pass_pair"]
    assert (lab.cpu() != lab_c).sum().item() <= 1e-5 * lab_c.numel()
    scale = float(out_c.abs().max())
    d = (out.cpu() - out_c).abs()
    assert float(d.max()) <= 2 * 2.0**-8 * scale
    assert float(d.norm() / out_c.norm()) < 1e-3


# ---------------------------------------------------------------------------
# the separable-warp surface: K1's per-operand modes, the forms writing
# OW != S, and the warps that launch them
# ---------------------------------------------------------------------------

MODE_PAIRS = [(False, False), (False, True), (True, False), (True, True)]
# (B, D, H, S) of the new forms' bit tests: tiles (13 f32 rows of 301) span
# samples and slices and the last is partial; OW = S, below and above it
SEP_SHAPE = (3, 20, 21, 301)
SEP_OW = [None, 77, 413]


def _sep_operand(dev, g, shape, nearest, off_bytes, dtype):
    """A (B, D, H, S) operand ``off_bytes`` into a larger tensor: labels
    0..49 if ``nearest``, else 100 * N(0, 1); -0.0 among the values."""
    if nearest:
        x = torch.randint(-1, 50, shape, generator=g, device=dev).float()
        x[x < 0] = -0.0
    else:
        x = _with_negative_zeros(100.0 * torch.randn(shape, generator=g, device=dev))
    if dtype == torch.bfloat16:
        return _bf16_view(x, off_bytes)
    flat = torch.empty(x.numel() + 4, device=dev)
    view = flat[off_bytes // 4 : off_bytes // 4 + x.numel()].view(shape)
    view.copy_(x)
    return view


def _bits(got, want):
    return _bits16(got, want) if got[0].dtype == torch.bfloat16 else _bits_equal(got, want)


def _sep_coefs(dev, S, OW):
    """Quarter-voxel rows (exact halves at OW = S), general slopes, a reversed
    row; lane slopes S / OW so the rows span the input."""
    r = S / OW
    return torch.tensor([[0.25, -0.5, r, 0.5], [0.05, -0.04, 1.02 * r, -0.3 * S], [0.0, 0.0, -r, S - 1.0]], device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("OW", SEP_OW)
@pytest.mark.parametrize("modes", MODE_PAIRS, ids=lambda m: "".join("n" if v else "l" for v in m))
def test_pair_modes_bits(dev, modes, OW, dtype):
    """K1 with per-sample coefficients and no displacement in each (first,
    second) mode, OW = S, below and above it, bit for bit with its plain
    version (the sign of zero kept), the operands off 16 bytes; one launch
    of the form's own count."""
    B, D, H, S = SEP_SHAPE
    g = torch.Generator(device=dev).manual_seed(S + (OW or 0) + 2 * modes[0] + modes[1])
    xa = _sep_operand(dev, g, SEP_SHAPE, modes[0], 4, dtype)
    xb = _sep_operand(dev, g, SEP_SHAPE, modes[1], 12, dtype)
    coefs = _sep_coefs(dev, S, OW or S)
    key = hat.launch_key(True, modes[1], coefs, None, dtype, nearest_a=modes[0])
    before = hat.LAUNCHES[key]
    got = hat.hat_pass_pair(xa, xb, coefs, None, modes[1], OW, modes[0])
    want = hat.hat_pass_pair_ref(xa, xb, coefs, None, modes[1], OW, modes[0])
    torch.cuda.synchronize()
    assert got[0].shape == (B, D, H, OW or S) and got[0].dtype == dtype
    assert hat.LAUNCHES[key] == before + 1
    assert _bits(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("OW", [77, 413])
@pytest.mark.parametrize("form", K2_FORMS, ids=lambda f: "-".join(str(v) for v in f))
def test_single_kernel_out_len_bits(dev, form, OW, dtype):
    """K2 in every form writing OW != S lanes (below and above S), bit for
    bit with its plain version: the ring stages S-lane rows and stores
    OW-lane ones (rows of 77 lanes start off 16 bytes)."""
    coef, nearest, disp_kind = form
    B, D, H, S = SEP_SHAPE
    g = torch.Generator(device=dev).manual_seed(OW + len(str(form)))
    x = _sep_operand(dev, g, SEP_SHAPE, nearest, 0, dtype)
    coefs = _sep_coefs(dev, S, OW)
    if coef == "slice":
        coefs = (torch.rand((B, D, 4), generator=g, device=dev) - 0.5) * torch.tensor([0.0, 0.5, 0.2, S / 2],
                                                                                       device=dev)
        coefs[..., 2] += S / OW
    disp = None
    if disp_kind == "volume":
        disp = (torch.rand((B, D, H, OW), generator=g, device=dev) - 0.5) * (S / 2)
        disp[..., ::5] = torch.round(disp[..., ::5]) + 0.5
        disp[..., 1::7] = -0.0
    elif disp_kind == "lane":
        disp = torch.randn((B, 3, OW), generator=g, device=dev) * torch.tensor([[[0.3], [0.3], [S / 8]]], device=dev)
    got = hat.hat_pass(x, coefs, disp, nearest, out_len=OW)
    want = hat.hat_pass_ref(x, coefs, disp, nearest, out_len=OW)
    torch.cuda.synchronize()
    assert got.shape == (B, D, H, OW) and got.dtype == dtype
    assert _bits((got,), (want,))


def test_separable_geometry(dev):
    """The new forms' launches. K2 on the ring kernel writing OW != S, and
    its bf16 forms with a displacement volume, plan as the per-sample form at
    OW = S: only the staged rows are tiled. Its bf16 linear per-sample form
    runs the lanes kernel: 32 KB tiles of a multiple of the 480 /
    ceil(OW / 8) rows computed at once, one block an SM. K1's (nearest,
    nearest) and (nearest, linear) pairs plan as its (linear, nearest) one,
    at any OW, and so does its f32 linear pair. Its bf16 linear pairs
    without a displacement run the lanes kernel: 16 KB per operand."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape = (4, 256, 256, 256)
    bf = torch.bfloat16
    for dtype in (torch.float32, bf):
        same = hat.hat_geometry(shape, True, dtype=dtype)
        for nearest in (False, True):
            for OW in (240, 272):
                if nearest or dtype == torch.float32:
                    assert hat.hat_geometry(shape, nearest, dtype=dtype, out_len=OW) == same
                assert hat.hat_geometry(shape, nearest, disp="volume", dtype=dtype, out_len=OW) == same
    # (OW, tile rows): 16, 15 and 14 rows computed at once
    for OW, rows in ((240, 64), (256, 60), (272, 56)):
        geo = hat.hat_geometry(shape, dtype=bf, out_len=OW)
        assert geo == {"tile_rows": rows, "stages": 3, "grid": sms, "smem_bytes": 128 + 3 * rows * 256 * 2}, (OW, geo)
    main = hat.hat_pair_geometry(shape, True, False, "none")
    assert main == {"tile_rows": 16, "stages": 3, "grid": main["grid"], "smem_bytes": 128 + 3 * 2 * 4100 * 4}
    for nearest_a, nearest_b in MODE_PAIRS:
        for OW in (None, 240, 272):
            assert hat.hat_pair_geometry(shape, nearest_b, False, "none", out_len=OW, nearest_a=nearest_a) == main
    main16 = hat.hat_pair_geometry(shape, True, False, "none", dtype=bf)
    assert main16 == {"tile_rows": 32, "stages": 3, "grid": main16["grid"], "smem_bytes": 128 + 3 * 2 * 8200 * 2}
    for nearest_a in (False, True):
        assert hat.hat_pair_geometry(shape, True, False, "none", dtype=bf, out_len=272, nearest_a=nearest_a) == main16
    assert hat.hat_pair_geometry(shape, False, False, "none", dtype=bf, nearest_a=True) == main16
    # (OW, tile rows, buffer pitch): 16, 15 and 14 rows computed at once
    for OW, rows, pitch in ((240, 32, 8200), (256, 30, 7688), (272, 28, 7176)):
        geo = hat.hat_pair_geometry(shape, False, False, "none", dtype=bf, out_len=OW)
        assert geo == {"tile_rows": rows, "stages": 3, "grid": sms, "smem_bytes": 128 + 3 * 2 * pitch * 2}, (OW, geo)
    geo = hat.hat_pair_geometry((1, 128, 384, 384), False, True, "none", dtype=bf)
    assert geo == {"tile_rows": 20, "stages": 3, "grid": sms, "smem_bytes": 128 + 3 * 2 * 7688 * 2}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_separable_warps_card_vs_cpu(dev, bf16):
    """The three warps at B=2 48^3 on the card against the port's CPU path:
    ``warp_affine_separable`` onto another grid (5 K2 launches), the pair in
    each mode (5 K1 launches of its form) and the displacement warp past
    FIELD_LIM (3 K2 launches with a volume); images within 1e-5 of their
    scale, labels equal; f32 and under ``storage_scope(bf16)``."""
    from fetalsyngen_torch.ops import linops, warp
    from fetalsyngen_torch.ops.affine import make_affine_matrix

    g = torch.Generator().manual_seed(5 + bf16)
    shape, out_shape = (48, 48, 48), (44, 52, 56)

    def smooth():  # zero mean, unit variance
        v = torch.nn.functional.avg_pool3d(torch.rand((2, 1, 56, 56, 56), generator=g), 9, 1)[:, 0]
        return (v - v.mean()) / v.std()

    img = smooth()
    img = 100.0 * (img - img.min()) / (img.max() - img.min())
    lab = torch.floor(img * 0.0799)
    A = make_affine_matrix(torch.rand((2, 3), generator=g) * 0.6 - 0.3, torch.rand((2, 3), generator=g) * 0.04 - 0.02,
                           torch.rand((2, 3), generator=g) * 0.2 + 0.9)
    t = (torch.tensor(shape) - 1) / 2 - torch.einsum("bij,j->bi", A, (torch.tensor(out_shape) - 1) / 2)
    fields = [10.0 * smooth() for _ in range(3)]
    assert all(bool((f.abs() > warp.FIELD_LIM).any()) for f in fields)

    def run(device):
        im, lb, a, tt, dx, dy, dz = (v.to(device) for v in (img, lab, A, t, *fields))
        return {
            ("affine", False): (warp.warp_affine_separable(im, a, tt, False, out_shape),),
            ("affine", True): (warp.warp_affine_separable(lb, a, tt, True, out_shape),),
            ("displacement", False): (warp.warp_displacement_separable(im, dx, dy, dz),),
            ("displacement", True): (warp.warp_displacement_separable(lb, dx, dy, dz, True),),
            **{("pair", m): warp.warp_affine_separable_pair(lb if m[0] else im, lb if m[1] else im, a, tt, m, out_shape)
               for m in MODE_PAIRS},
        }

    dtype = torch.bfloat16 if bf16 else torch.float32
    # K2: 5 launches an affine warp, 3 a displacement warp, two of each
    want = {"hat_pass_bf16": 10, "hat_pass_field_bf16": 6} if bf16 else {"hat_pass": 16}
    for m in MODE_PAIRS:
        want[hat.launch_key(True, m[1], torch.zeros((2, 4)), None, dtype, nearest_a=m[0])] = 5
    with linops.storage_scope(torch.bfloat16 if bf16 else None):
        before = dict(hat.LAUNCHES)
        card = run(dev)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in hat.LAUNCHES.items() if v != before[k]} == want
        cpu = run("cpu")
    for (name, mode), outs in card.items():
        modes = mode if name == "pair" else (mode,)
        for got, ref, nearest in zip(outs, cpu[(name, mode)], modes):
            assert got.device.type == "cuda" and got.shape[1:] == (shape if name == "displacement" else out_shape)
            if nearest:
                assert torch.equal(got.cpu(), ref), (name, mode)
            else:
                torch.testing.assert_close(got.cpu().float(), ref.float(), rtol=0, atol=1e-5 * 100.0)


# ---------------------------------------------------------------------------
# the row-affine pair pass: the pair warp's U passes and L21 peel
# ---------------------------------------------------------------------------

RA_ORDERS = ["ikj", "kji", "jik", "kij", "ijk"]  # the pair warp's five passes


def _ra_scope(form):
    from fetalsyngen_torch.ops import linops

    return {"f32": linops.f32_scope, "bf16": lambda: linops.storage_scope(torch.bfloat16),
            "default": lambda: linops.precision_scope(linops.DEFAULT)}[form]()


def _bf16_ulps(got, want):
    """Elementwise distance of two bf16 tensors in units in the last place
    (their bit patterns ordered as integers; -0 and +0 at the same place)."""
    def ordered(x):
        v = x.view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -(v + 32768), v)

    return (ordered(got) - ordered(want)).abs()


@pytest.mark.parametrize("rows", ["s", "j"])
@pytest.mark.parametrize("form", ["f32", "bf16", "default"])
@pytest.mark.parametrize("out_order", RA_ORDERS)
@pytest.mark.parametrize("shape", [(256, 256, 256), (5, 37, 71)], ids=["256", "odd"])
def test_row_affine_kernel_matches_plain(dev, shape, out_order, form, rows):
    """The row-affine kernel (``ops.warp.row_affine_pass_pair`` on the card)
    against its plain version, the banded-operator einsum on the card, at
    B=2 in each scope's form, on operands contiguous along S (an f32 image
    and int32 labels, as the first pass reads them) or along J (the form's
    own type, as the L-z peel reads the hat pass's output): one launch of
    the form, a contiguous output, labels bit-identical; the image within
    one bf16 ulp (bf16) or f32 rounding. Sample 0 clamps at both ends,
    sample 1 puts every other lane at a half-integer."""
    from fetalsyngen_torch.ops import warp

    g = torch.Generator(device=dev).manual_seed(len(out_order) * 7 + shape[0] + len(form))
    I, J, S = shape
    out_dtype = torch.bfloat16 if form == "bf16" else torch.float32
    dtypes = (torch.float32, torch.int32) if rows == "s" else (out_dtype, out_dtype)
    base = (2, I, J, S) if rows == "s" else (2, I, S, J)
    xa = (100.0 * torch.rand(base, generator=g, device=dev)).to(dtypes[0])
    xb = torch.randint(0, 50, base, generator=g, device=dev).to(dtypes[1])
    if rows == "j":
        xa, xb = xa.permute(0, 1, 3, 2), xb.permute(0, 1, 3, 2)
    coefs = [torch.tensor(v, device=dev) for v in ((1.07, 0.5), (0.21, 1.0), (-2.3, 0.0))]
    key = f"row_affine_pair_{form}"
    with _ra_scope(form):
        before = row_affine.LAUNCHES[key]
        ka, kb = warp.row_affine_pass_pair(xa, xb, *coefs, out_order=out_order)
        assert row_affine.LAUNCHES[key] == before + 1
        pa, pb = warp._row_affine_matmul_pair(xa.float(), xb.float(), *coefs, out_order=out_order)
    torch.cuda.synchronize()
    assert ka.is_contiguous() and kb.is_contiguous()
    assert ka.shape == pa.shape and ka.dtype == pa.dtype == kb.dtype == pb.dtype == out_dtype
    assert torch.equal(kb, pb)
    if form == "bf16":
        assert int(_bf16_ulps(ka, pa).max()) <= 1
    else:
        torch.testing.assert_close(ka, pa, rtol=2**-22, atol=2**-22 * 100.0)


def test_row_affine_production_core_labels_match_einsum(dev, monkeypatch):
    """``synth_core`` in the production mode at 256^3, B=4: the pair warp
    launches the row-affine kernel's bf16 form five times and builds no
    banded operator; its labels are bit-identical to those of the same
    batch through the banded-operator einsum on the card, and the image,
    whose bf16 roundings may fall the other way where the GEMM sums in
    another order, within a relative L2 of 1e-3."""
    from fetalsyngen_torch.ops import warp
    from fetalsyngen_torch.parallel.input_pipeline import _production_scopes

    shape = (256, 256, 256)
    cfg = GeneratorCfg(shape=shape, resolution=(0.5, 0.5, 0.5), intensity=IntensityCfg(
        1, 6, tuple([0] + list(range(10, 50))), tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))))
    seeds, seg = phantom_seeds_and_seg(shape, seed=2)
    seeds = torch.from_numpy(np.stack([seeds] * 4).astype(np.int32)).to(dev)
    segs = torch.from_numpy(np.stack([seg] * 4).astype(np.int32)).to(dev)
    gens = tpipe.make_generators([5, 6, 7, 8], dev)
    p = sample_params(gens, cfg)
    f = tpipe.draw_fields(gens, cfg, dev)
    built = []
    shear = warp._shear_matrices
    monkeypatch.setattr(warp, "_shear_matrices", lambda *a: built.append(a[:2]) or shear(*a))
    before = dict(row_affine.LAUNCHES)
    with _production_scopes():
        out, lab, _ = tpipe.synth_core(p, f, seeds, segs, cfg)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in row_affine.LAUNCHES.items()} == {
            "row_affine_pair_f32": 0, "row_affine_pair_bf16": 5, "row_affine_pair_default": 0}
        assert built == []
        monkeypatch.setattr(warp, "row_affine_pass_pair", lambda xa, xb, *a, **kw: warp._row_affine_matmul_pair(
            xa.float(), xb.float(), *a, **kw))
        out_e, lab_e, _ = tpipe.synth_core(p, f, seeds, segs, cfg)
        torch.cuda.synchronize()
    assert len(built) == 5
    assert lab.dtype == lab_e.dtype and torch.equal(lab, lab_e)
    assert float((out.float() - out_e.float()).norm() / out_e.float().norm()) < 1e-3


# ---------------------------------------------------------------------------
# the small-field pair warp's OOB mask and margin shift (kernels.deform_mask)
# ---------------------------------------------------------------------------

MASK_SHAPES = {"64": (64, 64, 64), "256": (256, 256, 256)}


def _mask_inputs(dev, shape, seed, dtype, layout, B=3, buf=16):
    """The mask's operands at B=3: per-sample size_F_small drawn from 8-16
    on each axis into a buffer of 16 (the 256^3 generator's), affines of the
    generator's ranges with scalings to +-15%, sample 0 a compression to 85%
    under a field of std 0.5 (its margin shift leaves 0), the others fields
    of std 4; c2 the centre as an expanded row; an image without zeros in
    the pair warp's output layout ((B, H, W, D) memory) or contiguous (a
    layout no caller gives, which the kernel reads uncoalesced)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    size = torch.randint(8, 17, (B, 3), generator=g, device=dev, dtype=torch.int32)
    rot = (2 * torch.rand(B, 3, generator=g, device=dev) - 1) * (20.0 / 180.0 * np.pi)
    sh = (2 * torch.rand(B, 3, generator=g, device=dev) - 1) * 0.02
    sc = 1 + (2 * torch.rand(B, 3, generator=g, device=dev) - 1) * 0.15
    rot[0], sc[0] = 0.0, 0.85
    from fetalsyngen_torch.ops.affine import make_affine_matrix

    A = make_affine_matrix(rot, sh, sc)
    std = torch.tensor([0.5] + [4.0] * (B - 1), device=dev).view(B, 1, 1, 1, 1)
    h_s = torch.einsum("bij,bjxyz->bixyz", A, std * torch.randn(B, 3, buf, buf, buf, generator=g, device=dev))
    c2 = torch.tensor([(s - 1) / 2.0 for s in shape], device=dev).expand(B, 3)
    a = (1.0 + torch.rand((B, shape[1], shape[2], shape[0]), generator=g, device=dev)).to(dtype)
    a = a.permute(0, 3, 1, 2) if layout == "warp" else a.permute(0, 3, 1, 2).contiguous()
    return h_s, size, A, c2, a


@pytest.mark.parametrize("layout", ["warp", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("margin", [True, False], ids=["shift", "noshift"])
@pytest.mark.parametrize("shape", sorted(MASK_SHAPES))
def test_deform_mask_kernels_match_plain(dev, shape, margin, dtype, layout):
    """``mask_shift`` and ``mask_apply`` against the zoom-based composition
    (``pipeline.pair_mask_plain`` and ``where``) on the card at B=3: the
    shift identical, the mask on all but 1e-6 of the voxels, the image
    equal wherever the masks agree, the output contiguous; one launch of
    each kernel (``mask_shift`` none without the margin shift)."""
    shape = MASK_SHAPES[shape]
    h_s, size, A, c2, a = _mask_inputs(dev, shape, 70 + shape[0] + margin, dtype, layout)
    shift_p, ok = tpipe.pair_mask_plain(h_s, size, A, c2, shape, margin)
    before = dict(deform_mask.LAUNCHES)
    shift = deform_mask.mask_shift(h_s, size, A, c2, shape) if margin else torch.zeros_like(c2)
    out = deform_mask.mask_apply(a, h_s, size, A, c2, shift)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in deform_mask.LAUNCHES.items()} == {"mask_shift": int(margin), "mask_apply": 1}
    assert torch.equal(shift, shift_p)
    if margin:
        assert bool((shift[0] > 0).all()) and bool((shift[1:] == 0).any())
    ok_k = out != 0
    assert int((ok_k != ok).sum()) <= 1e-6 * ok.numel()
    assert 0 < int(ok.sum()) < ok.numel()
    assert out.is_contiguous() and out.dtype == dtype and out.shape == a.shape
    plain = torch.where(ok, a, 0.0)
    agree = ok_k == ok
    assert torch.equal(out[agree], plain[agree])


@pytest.mark.parametrize("mode", ["production", "f32"])
@pytest.mark.parametrize("flip", [False, True], ids=["noflip", "flip"])
@pytest.mark.parametrize("margin", [True, False], ids=["shift", "noshift"])
def test_deform_mask_pair_warp_card(dev, monkeypatch, margin, flip, mode):
    """``deform_stage`` at B=3 256^3 on the card, size_F_small drawn from
    8-16 on each axis, in the production mode (a bf16 image) and in f32:
    one ``mask_shift`` (none without the margin shift) and one
    ``mask_apply`` a pair warp; against the same batch with the zoom-based
    composition in their place, the shift identical, the labels
    bit-identical, the image different on at most 1e-6 of the voxels (where
    a mask decision differs); the masked image contiguous."""
    from fetalsyngen_torch.generator.config import DeformCfg
    from fetalsyngen_torch.parallel.input_pipeline import _production_scopes

    shape = (256, 256, 256)
    cfg = GeneratorCfg(shape=shape, resolution=(0.5, 0.5, 0.5), intensity=IntensityCfg(
        1, 6, tuple([0] + list(range(10, 50))), tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))),
        deform=DeformCfg(size=shape, margin_shift=margin))
    seeds, seg = phantom_seeds_and_seg(shape, seed=3)
    seeds = torch.from_numpy(np.stack([seeds] * 3).astype(np.int32)).to(dev)
    segs = torch.from_numpy(np.stack([seg] * 3).astype(np.int32)).to(dev)
    gens = tpipe.make_generators([21, 22, 23], dev)
    size = np.random.default_rng(24).integers(8, 17, (3, 3))
    p = sample_params(gens, cfg, {"deform_apply": True, "flip": flip, "size_F_small": size})
    f = tpipe.draw_fields(gens, cfg, dev)
    shifts, applied = [], []
    kernel_shift, kernel_apply = deform_mask.mask_shift, deform_mask.mask_apply
    monkeypatch.setattr(deform_mask, "mask_shift", lambda *a: shifts.append(kernel_shift(*a)) or shifts[-1])
    monkeypatch.setattr(deform_mask, "mask_apply", lambda *a: applied.append(kernel_apply(*a)) or applied[-1])
    scope = _production_scopes if mode == "production" else __import__("contextlib").nullcontext
    with scope():
        out0 = tpipe.intensity_stage(seeds, p, f.intensity)
        before = dict(deform_mask.LAUNCHES)
        out, lab, _ = tpipe.deform_stage(p, f.nonlin, cfg, out0, segs)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in deform_mask.LAUNCHES.items()} == {
            "mask_shift": int(margin), "mask_apply": 1}
        monkeypatch.setattr(deform_mask, "mask_shift", lambda h_s, size, A, c2, shape: shifts.append(
            tpipe.pair_mask_plain(h_s, size, A, c2, shape, True)[0]) or shifts[-1])
        monkeypatch.setattr(deform_mask, "mask_apply", lambda a, h_s, size, A, c2, shift: torch.where(
            tpipe.pair_mask_plain(h_s, size, A, c2, tuple(a.shape[1:]), margin)[1], a, 0.0))
        out_p, lab_p, _ = tpipe.deform_stage(p, f.nonlin, cfg, out0, segs)
        torch.cuda.synchronize()
    if margin:
        assert len(shifts) == 2 and torch.equal(shifts[0], shifts[1])
    assert len(applied) == 1 and applied[0].is_contiguous()
    assert applied[0].dtype == (torch.bfloat16 if mode == "production" else torch.float32)
    assert out.dtype == out_p.dtype
    assert lab.dtype == lab_p.dtype and torch.equal(lab, lab_p)
    assert int((out != out_p).sum()) <= 1e-6 * out.numel()


# ---------------------------------------------------------------------------
# the seed-preparation path: the mixture's EM on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [2, 6, 10])
def test_gmm_card_matches_cpu(dev, k):
    """Meta-label 2 of ``data/sub-sta21`` (labels 2 and 6, 179,621 values)
    fitted on the card and through the port on the CPU from one
    ``random_state``: the same k-means++ indices and winning init, each
    component mean within 1e-4 relative, labels differing on at
    most 1e-4 of the values (chip_smoke phase 14's bars)."""
    from pathlib import Path

    from fetalsyngen_torch.scripts import generate_seeds, gmm

    anat = Path(__file__).resolve().parent.parent / "data" / "sub-sta21" / "anat"
    image, segm, _ = generate_seeds.load_subject(
        anat / "sub-sta21_rec-irtk_T2w.nii.gz", anat / "sub-sta21_rec-irtk_T2w_dseg.nii.gz", "feta")
    x = image[(segm == 2) | (segm == 6)]
    card = gmm.fit_predict(x, k, random_state=11, device=dev)
    cpu = gmm.fit_predict(x, k, random_state=11, device="cpu")
    assert card.labels.device.type == "cuda" and card.em.means.device.type == "cuda"
    np.testing.assert_array_equal(card.indices, cpu.indices)
    assert card.best == cpu.best
    torch.testing.assert_close(card.em.means[card.best].cpu(), cpu.em.means[cpu.best], rtol=1e-4, atol=0)
    assert float((card.labels.cpu() != cpu.labels).double().mean()) <= 1e-4


def test_generate_seeds_on_the_card(dev, tmp_path):
    """``generate_seeds`` on the card over a ``build_bids_tree`` tree (two
    subjects, 64^3) against ``--device cpu``, both from numpy's global
    ``RandomState`` seeded alike: the same files, int8, ``subclasses_1``
    identical, the fitted seeds differing on at most 1e-4 of each file's
    labelled voxels."""
    import shutil

    from fetalsyngen_torch.io import nifti
    from fetalsyngen_torch.scripts import generate_seeds
    from fetalsyngen_torch.testing import build_bids_tree

    bids = build_bids_tree(tmp_path / "bids", shape=(64, 64, 64))
    shutil.rmtree(bids / "derivatives")
    trees = {}
    for device in ("cuda", "cpu"):
        np.random.seed(3)
        trees[device] = tmp_path / device
        generate_seeds.main(["--bids_path", str(bids), "--out_path", str(trees[device]), "--max_subclasses", "3",
                             "--annotation", "feta", "--device", device])
    files = sorted(p.relative_to(trees["cuda"]) for p in trees["cuda"].rglob("*.nii.gz"))
    assert files == sorted(p.relative_to(trees["cpu"]) for p in trees["cpu"].rglob("*.nii.gz"))
    assert len(files) == 2 * 3 * 4
    for rel in files:
        a, b = nifti.load(trees["cuda"] / rel), nifti.load(trees["cpu"] / rel)
        assert a.data.dtype == b.data.dtype == np.int8
        np.testing.assert_array_equal(a.affine, b.affine)
        region = b.data != 0
        np.testing.assert_array_equal(a.data != 0, region)
        if rel.parts[0] == "subclasses_1":
            np.testing.assert_array_equal(a.data, b.data)
        else:
            assert np.mean(a.data[region] != b.data[region]) <= 1e-4
