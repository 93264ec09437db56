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
from fetalsyngen_tpu.generator.pipeline import _synth_core
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


def _cfg(warp_impl="separable", mod=tconfig):
    """The test config, built from the port's config module or JAX's."""
    return mod.GeneratorCfg(
        shape=SHAPE,
        resolution=(0.5, 0.5, 0.5),
        intensity=mod.IntensityCfg(1, 6, LABELS, GEN_CLASSES),
        deform=mod.DeformCfg(warp_impl=warp_impl),
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


def _jax_run(cfg, k, force, seeds, seg):
    """JAX ``_synth_core`` under ``cfg`` (the JAX package's config), with
    the parameters and fields it drew, as numpy."""
    key = jax.random.PRNGKey(k)
    natural = jparams.sample_params(key, cfg)
    gates = tuple(jnp.asarray(True) if force else getattr(natural, g) for g in GATES)
    out, seg_out, _, p = _synth_core(
        key, jnp.asarray(seeds), jnp.asarray(seg), jnp.zeros((), jnp.float32), gates, cfg,
        GATES, False,
    )
    shapes = tpipe.field_shapes(cfg)
    fields = {
        n: np.asarray(jax.random.normal(jparams.field_key(key, f"field_{n}"), shapes[n], jnp.float32))
        for n in shapes
    }
    params = {n: np.asarray(getattr(p, n)) for n in NAMES}
    return np.asarray(out), np.asarray(seg_out), params, fields


@pytest.mark.parametrize("warp_impl", ["separable", "exact"])
@pytest.mark.parametrize("k, force", [(0, False), (1, False), (2, False), (3, True)])
def test_slice_matches_jax(warp_impl, k, force, volumes):
    seeds, seg = volumes
    cfg = _cfg(warp_impl)
    j_out, j_seg, params, fields = _jax_run(_cfg(warp_impl, jconfig), k, force, seeds, seg)
    if force:
        assert all(bool(params[g]) for g in GATES)
    out, seg_out = tpipe.synth_core(
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


def test_off_slice_configs_raise(volumes):
    seeds, seg = volumes
    cfg = dataclasses.replace(_cfg(), deform=tconfig.DeformCfg(nonlinear_transform=False))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.synth_sample(
            torch.from_numpy(seeds), torch.from_numpy(seg), cfg, 0, "cpu",
            overrides={"deform_apply": True},
        )
    gens = tpipe.make_generators([0], "cpu")
    p = tparams.sample_params(gens, _cfg())
    fields = tpipe.draw_fields(gens, _cfg(), "cpu")
    vol = torch.from_numpy(seeds[None])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tpipe.synth_core(p, fields, vol, torch.from_numpy(seg[None]), _cfg(), image=vol.float())


def test_port_imports_no_jax():
    """Every port module and ``chip_smoke.py`` import neither JAX nor the JAX package."""
    mods = [
        m.name
        for m in pkgutil.walk_packages(fetalsyngen_torch.__path__, "fetalsyngen_torch.")
    ]
    assert "fetalsyngen_torch.kernels.hat" in mods and "fetalsyngen_torch.convert" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods + ['chip_smoke']!r}: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'fetalsyngen_tpu'))\n"
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
