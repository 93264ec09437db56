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
from fetalsyngen_torch.kernels import hat
from fetalsyngen_torch.testing import phantom_seeds_and_seg

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        hat.hat_pass(x, coefs, torch.zeros((1, 2, 3, 9), device=dev))
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


@pytest.mark.parametrize("D, H, S, scale", [(2, 32, 384, 0.02), (1, 64, 384, 0.5), (4, 16, 100, 0.3)])
def test_hat_variant_matches_plain(dev, D, H, S, scale):
    """K7's five variants, with saturated rows and spans past the budget in
    the wider tables."""
    from fetalsyngen_torch.kernels import probes

    g = torch.Generator(device=dev).manual_seed(S + D)
    x = torch.rand((D, H, S), generator=g, device=dev)
    coefs = torch.tensor([0.25, -0.125, 1.0, 0.3], device=dev)
    table = torch.randn((3, S), generator=g, device=dev) * scale
    for v in probes.VARIANTS:
        got, want = probes.hat_variant(x, coefs, table, v), probes.hat_variant_ref(x, coefs, table, v)
        torch.cuda.synchronize()
        assert torch.equal(got, want), v
