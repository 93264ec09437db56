"""The port's whole slice against JAX ``_synth_core``, plus the port's own replay.

JAX runs ``_synth_core`` with a key; the port gets the same ``GenParams``
(``params_from_numpy``) and the same four standard-normal voxel fields
(``fields_from_numpy`` of the ``field_key`` draws), so both compute the same
volume. Bars: the [0, 1] image within ``atol=1e-4`` (f32 summation order and
FMA contraction differ between XLA:CPU and PyTorch), labels exactly.

All cases pin the five stage gates through overrides, so each ``warp_impl``
compiles one JAX program: the natural-key cases pin them to the values JAX
itself draws for that key (which changes nothing), the forced case pins them
all on. The shape is not a cube, so a swapped axis in a pass layout shows.
Beyond the seed path, the pipeline's other branches are held the same way:
a co-deformed image, the image as intensity prior, the generate and augment
stage sets, and ``nonlinear_transform=False``.
"""

import dataclasses
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import fetalsyngen_torch
import fetalsyngen_tpu.testing
import fetalsyngen_torch.testing
from fetalsyngen_tpu.generator import config as jconfig
from fetalsyngen_tpu.generator import params as jparams
from fetalsyngen_tpu.generator.pipeline import STAGES_ALL, _synth_core
from fetalsyngen_torch.convert import fields_from_numpy, params_from_numpy
from fetalsyngen_torch.generator import config as tconfig
from fetalsyngen_torch.generator import params as tparams
from fetalsyngen_torch.generator import pipeline as tpipe

REPO = Path(__file__).resolve().parent.parent
SHAPE = (32, 40, 36)
LABELS = tuple([0] + list(range(10, 50)))
GEN_CLASSES = tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))
GATES = ("bf_apply", "deform_apply", "gamma_apply", "noise_apply", "resample_apply")
NAMES = [f.name for f in dataclasses.fields(tparams.GenParams)]


def _cfg(warp_impl="separable", mod=tconfig, nonlinear=True, shape=SHAPE):
    """The test config, built from the port's config module or JAX's."""
    return mod.GeneratorCfg(
        shape=shape,
        resolution=(0.5, 0.5, 0.5),
        intensity=mod.IntensityCfg(1, 6, LABELS, GEN_CLASSES),
        deform=mod.DeformCfg(size=shape, warp_impl=warp_impl, nonlinear_transform=nonlinear),
    )


@pytest.fixture(scope="module")
def volumes():
    seeds, seg = fetalsyngen_torch.testing.phantom_seeds_and_seg(SHAPE, seed=1)
    return seeds.astype(np.int32), seg.astype(np.int32)


@pytest.mark.parametrize("shape, seed", [((32, 40, 36), 1), ((17, 9, 24), 5)])
def test_phantom_matches_jax(shape, seed):
    port = fetalsyngen_torch.testing.phantom_seeds_and_seg(shape, seed)
    ref = fetalsyngen_tpu.testing.phantom_seeds_and_seg(shape, seed)
    for a, b in zip(port, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _jax_run(cfg, k, force, seeds, seg, image=None, use_seeds=True, stages=STAGES_ALL):
    """JAX ``_synth_core`` under ``cfg`` (the JAX package's config), with
    the parameters and fields it drew, as numpy. ``seeds`` holds the
    intensity prior when ``use_seeds`` is false."""
    key = jax.random.PRNGKey(k)
    natural = jparams.sample_params(key, cfg)
    gates = tuple(jnp.asarray(True) if force else getattr(natural, g) for g in GATES)
    with_image = image is not None
    out, seg_out, img_out, p = _synth_core(
        key, jnp.asarray(seeds), jnp.asarray(seg),
        jnp.asarray(image) if with_image else jnp.zeros((), jnp.float32), gates, cfg,
        GATES, with_image, use_seeds, stages,
    )
    shapes = tpipe.field_shapes(cfg)
    fields = {
        n: np.asarray(jax.random.normal(jparams.field_key(key, f"field_{n}"), shapes[n], jnp.float32))
        for n in shapes
    }
    params = {n: np.asarray(getattr(p, n)) for n in NAMES}
    img_out = np.asarray(img_out) if with_image else None
    return np.asarray(out), np.asarray(seg_out), img_out, params, fields


@pytest.mark.parametrize("warp_impl", ["separable", "exact"])
@pytest.mark.parametrize("k, force", [(0, False), (1, False), (2, False), (3, True)])
def test_slice_matches_jax(warp_impl, k, force, volumes):
    seeds, seg = volumes
    cfg = _cfg(warp_impl)
    j_out, j_seg, _, params, fields = _jax_run(_cfg(warp_impl, jconfig), k, force, seeds, seg)
    if force:
        assert all(bool(params[g]) for g in GATES)
    out, seg_out, _ = tpipe.synth_core(
        params_from_numpy(params), fields_from_numpy(**fields),
        torch.from_numpy(seeds[None]), torch.from_numpy(seg[None]), cfg,
    )
    out, seg_out = out[0].numpy(), seg_out[0].numpy()
    assert out.shape == SHAPE and seg_out.dtype == np.int32
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, j_out, atol=1e-4, rtol=0)
    flips = np.argwhere(seg_out != j_seg)
    assert len(flips) == 0, f"{len(flips)} labels differ, first at {flips[:8].tolist()}"


def test_replay_and_batching(volumes):
    seeds, seg = volumes
    cfg = _cfg()
    s2 = torch.from_numpy(np.stack([seeds, seeds]))
    g2 = torch.from_numpy(np.stack([seg, seg]))
    out, seg_out, p = tpipe.synth_batch(s2, g2, cfg, [7, 8], "cpu")
    assert out.shape == (2, *SHAPE) and seg_out.dtype == torch.int32
    assert not torch.equal(out[0], out[1])
    # same generator seeds -> identical tensors
    out_r, seg_r, _ = tpipe.synth_batch(s2, g2, cfg, [7, 8], "cpu")
    assert torch.equal(out_r, out) and torch.equal(seg_r, seg_out)
    # a batch of 2 equals two single-sample calls
    for b, sd in enumerate((7, 8)):
        o1, s1, _ = tpipe.synth_sample(s2[0], g2[0], cfg, sd, "cpu")
        torch.testing.assert_close(o1, out[b], rtol=0, atol=1e-6)
        assert torch.equal(s1, seg_out[b])
    # the genparams dict replays the volume under the same seed
    ov = tparams.overrides_from_genparams(tparams.genparams_to_dict(p, 1))
    o_ov, s_ov, _ = tpipe.synth_sample(s2[1], g2[1], cfg, 8, "cpu", overrides=ov)
    torch.testing.assert_close(o_ov, out[1], rtol=0, atol=1e-6)
    assert torch.equal(s_ov, seg_out[1])


# (nonlinear_transform, co-deformed image, image as intensity prior, stages,
# key, force every gate on): the image and prior cases are the dataset's
# real_train path (K1 + K2), the affine cases the nonlinear_transform=False
# path (K2 alone, both modes), the stage sets generate / augment.
API_CASES = {
    "image": (True, True, False, "all", 0, False),
    "image_forced": (True, True, False, "all", 3, True),
    "prior_generate": (True, True, True, "generate", 7, False),
    "prior_augment": (True, False, True, "augment", 2, False),
    "affine_prior_image": (False, True, True, "all", 4, True),
    "affine_seeds": (False, False, False, "all", 5, False),
    "affine_generate": (False, False, False, "generate", 6, False),
}
STAGES = {"all": tpipe.STAGES_ALL, "generate": tpipe.STAGES_GENERATE, "augment": tpipe.STAGES_AUGMENT}


def check_core_matches_jax(cfg, jcfg, k, force, seeds, seg, image, prior, stages):
    """Port ``synth_core`` against JAX ``_synth_core`` on the same inputs,
    parameters and fields: the output and image within 1e-4 of their scale
    (max(1, max|x|): the dataset scales both to [0, 1]), labels exactly."""
    base = prior if prior is not None else seeds
    j_out, j_seg, j_img, params, fields = _jax_run(
        jcfg, k, force, base, seg, image=image, use_seeds=prior is None, stages=stages
    )
    if "deform" in stages:
        assert bool(params["deform_apply"]), "pick a key whose deform gate is on"

    def t(a):
        return None if a is None else torch.from_numpy(a[None])

    out, seg_out, img = tpipe.synth_core(
        params_from_numpy(params), fields_from_numpy(**fields), t(seeds), t(seg), cfg,
        image=t(image), intensity_prior=t(prior), stages=stages,
    )
    for port, ref in ((out, j_out), (img, j_img)):
        if ref is None:
            assert port is None
            continue
        port = port[0].numpy()
        assert port.shape == ref.shape and np.isfinite(port).all()
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(port / scale, ref / scale, atol=1e-4, rtol=0)
    assert seg_out.dtype == torch.int32
    flips = np.argwhere(seg_out[0].numpy() != j_seg)
    assert len(flips) == 0, f"{len(flips)} labels differ, first at {flips[:8].tolist()}"


@pytest.mark.parametrize("case", list(API_CASES))
def test_api_paths_match_jax(case, volumes):
    """The image / intensity-prior / stage-set / affine-only branches of the
    pipeline against JAX."""
    nonlinear, with_image, with_prior, stages, k, force = API_CASES[case]
    seeds, seg = volumes
    img = fetalsyngen_torch.testing.make_phantom(np.random.default_rng(3), SHAPE)[0]
    check_core_matches_jax(
        _cfg(nonlinear=nonlinear), _cfg(mod=jconfig, nonlinear=nonlinear), k, force, seeds, seg,
        img if with_image else None, img if with_prior else None, STAGES[stages],
    )


def test_off_slice_configs_raise(volumes):
    """A stage set without intensity synthesis and without a prior raises;
    the two configurations that needed K2 (the separable warp with
    ``nonlinear_transform=False``, an extra co-deformed image) now run."""
    seeds, seg = volumes
    s, g = torch.from_numpy(seeds), torch.from_numpy(seg)
    out, seg_out, _ = tpipe.synth_sample(
        s, g, _cfg(nonlinear=False), 0, "cpu", overrides={"deform_apply": True}
    )
    assert out.shape == SHAPE and bool(torch.isfinite(out).all())
    assert set(torch.unique(seg_out).tolist()) <= set(np.unique(seg).tolist())
    gens = tpipe.make_generators([0], "cpu")
    p = tparams.sample_params(gens, _cfg(), {"deform_apply": True})
    fields = tpipe.draw_fields(gens, _cfg(), "cpu")
    image = s[None].float()
    _, _, img = tpipe.synth_core(p, fields, s[None], g[None], _cfg(), image=image)
    assert img.shape == (1, *SHAPE) and not torch.equal(img, image)
    with pytest.raises(ValueError, match="intensity_prior"):
        tpipe.synth_core(p, fields, None, g[None], _cfg(), stages=tpipe.STAGES_AUGMENT)


def test_port_imports_no_jax():
    """Every port module and ``chip_smoke.py`` import neither JAX nor the JAX
    package nor scikit-learn, and import without PyYAML; with all of them
    blocked, a tiny stream with the four SR artifacts runs on the CPU."""
    mods = [
        m.name
        for m in pkgutil.walk_packages(fetalsyngen_torch.__path__, "fetalsyngen_torch.")
    ]
    for m in ("kernels.hat", "convert", "config", "io.nifti", "data.transforms", "data.datasets",
              "generator.model", "testing", "test", "test_dl", "ops.morphology", "ops.noise", "ops.blur",
              "generator.artifacts.draws", "generator.artifacts.transforms", "generator.artifacts.motion",
              "generator.artifacts.psf", "generator.artifacts.quality", "generator.artifacts.scanner",
              "kernels.probes", "probes.timing", "probes.microbench_warp", "probes.probe_blocktp",
              "probes.profile_kernel_variants", "probes.ring_profile", "probes.stream_rate", "io.native",
              "parallel.input_pipeline", "ops.rand", "generator.artifacts.batched", "train.unet", "train.step",
              "train.segmentation", "parallel.sharding", "scripts.gmm", "scripts.generate_seeds",
              "scripts.resample", "scripts.resize_seeds", "examples.generator"):
        assert f"fetalsyngen_torch.{m}" in mods
    # PyYAML is blocked too: only ``config.load_yaml`` may need it. The
    # recorded trajectories are the port's own file.
    code = (
        "import importlib, sys, tempfile\n"
        "for m in ('yaml', 'jax', 'jaxlib', 'fetalsyngen_tpu', 'sklearn'): sys.modules[m] = None\n"
        f"for m in {mods + ['chip_smoke']!r}: importlib.import_module(m)\n"
        "from fetalsyngen_torch.generator.artifacts import motion\n"
        "assert 'fetalsyngen_torch' in motion._TRAJ_PATH and motion.get_trajectory()['dT'] > 0\n"
        "import torch\n"
        "from pathlib import Path\n"
        "from fetalsyngen_torch.data.datasets import FetalSynthDataset\n"
        "from fetalsyngen_torch.generator.artifacts import quality as q, scanner as sc\n"
        "from fetalsyngen_torch.generator.model import *\n"
        "from fetalsyngen_torch.parallel.input_pipeline import SyntheticStream\n"
        "from fetalsyngen_torch.testing import build_bids_tree\n"
        "S = (32, 32, 32)\n"
        "mp = q.StructNoiseMergeParams('perlin', perlin_res_list=[1], perlin_octaves_list=[1], "
        "perlin_persistence=0.5, perlin_lacunarity=2, perlin_increase_size=0.1)\n"
        "rp = q.ReconMergeParams('perlin', perlin_res_list=[1], perlin_octaves_list=[1], "
        "perlin_persistence=0.5, perlin_lacunarity=2, perlin_increase_size=0.25)\n"
        "sm = sc.SimulateMotion(1.0, sc.ScannerParams(1.0, 1.5, 2.0, 1.0, 1.5, 1.0, 1.5, 1, 2, 200, 0, 0.05, 1, 1, "
        "0.2, 0.5, 0.05), sc.ReconParams(0.5, 0.1, 0.5, 1.0, 0.5, 0.5, 0.1, 0.4, 1.0, rp), tiers=(64,), ns_grid=32)\n"
        "gen = FetalSynthGen(S, (0.5,) * 3, ImageFromSeeds(1, 2, [0] + list(range(10, 50)), "
        "[0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50))), "
        "SpatialDeformation(20, 0.02, 0.1, S, 0.9, True, 0.03, 0.06, 4.0, 0.5), RandResample(0.9, 0.5, 1.5), "
        "RandBiasField(0.9, 0.004, 0.02, 0.01, 0.3), RandNoise(0.9, 5, 15), RandGamma(0.9, 0.1), "
        "blur_cortex=q.BlurCortex(1.0, 2, 5, 20), struct_noise=q.StructNoise(1.0, 3, 0.2, 0.4, mp), "
        "simulate_motion=sm, boundaries=q.SimulatedBoundaries(0.0, 1.0, 1.0), device='cpu', seed=0)\n"
        "root = build_bids_tree(Path(tempfile.mkdtemp()), shape=S)\n"
        "ds = FetalSynthDataset(str(root), gen, str(root / 'derivatives' / 'seeds'))\n"
        "b = next(iter(SyntheticStream(ds, batch_size=1, seed=2, prefetch=False)))\n"
        "assert b['image'].shape == (1, *S) and bool(torch.isfinite(b['image']).all())\n"
        "assert b['meta']['pack']['motion_on'].all()\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'fetalsyngen_tpu', 'sklearn') "
        "and sys.modules[k] is not None)\n"
        "assert not bad, bad[:5]\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_a_card(where, tmp_path):
    """Without CUDA, or without the rest of the repo, ``chip_smoke.py`` exits
    non-zero and prints no result line."""
    if where == "repo":
        script, cwd = REPO / "chip_smoke.py", REPO
    else:
        script = tmp_path / "chip_smoke.py"
        script.write_bytes((REPO / "chip_smoke.py").read_bytes())
        cwd = tmp_path
    r = subprocess.run(
        [sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=300
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
