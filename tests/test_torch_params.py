"""The port's GenParams: overrides, derived laws and replay, against JAX.

The port's draws come from torch generators and cannot equal jax.random's
threefry streams; what must be equal is everything the laws fix: pinned
values, the values derived from them (grid sizes, the f64 ``new_size`` law)
and the gates that overrides force on. Within the port, draws are positional,
so pinning one parameter moves no other draw.
"""

import dataclasses

import numpy as np
import pytest

import jax
import torch

from fetalsyngen_tpu.generator import config as jconfig
from fetalsyngen_tpu.generator import params as jparams
from fetalsyngen_torch.generator import config as tconfig
from fetalsyngen_torch.generator import params as tparams
from fetalsyngen_torch.generator.pipeline import draw_fields, make_generators
from fetalsyngen_torch.ops.numerics import floor_div_exact

SHAPE = (48, 48, 48)
LABELS = tuple([0] + list(range(10, 50)))
GEN_CLASSES = tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))
NAMES = [f.name for f in dataclasses.fields(tparams.GenParams)]


def _cfg(mod=tconfig, shape=SHAPE, **kw):
    """The test config, built from the port's config module or JAX's."""
    return mod.GeneratorCfg(shape=shape, intensity=mod.IntensityCfg(1, 6, LABELS, GEN_CLASSES), **kw)


def _jax_numpy(p):
    return {n: np.asarray(getattr(p, n)) for n in NAMES}


def _assert_equal_to_jax(tp, jp, names=NAMES):
    for n in names:
        port = getattr(tp, n)
        ref = jp[n]
        assert port.dtype == tparams.field_dtype(n), n
        for b in range(port.shape[0]):
            np.testing.assert_array_equal(port[b].numpy(), ref, err_msg=n)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"shape": (256, 256, 256)},
        {"shape": (40, 56, 48), "resolution": (0.8, 0.5, 1.0)},
        {"deform": {"warp_impl": "exact", "nonlin_scale_max": 0.08}, "resample": {"max_resolution": 2.0}},
        {"bias_field": {"scale_max": 0.05}, "noise": {"std_max": 20.0}, "gamma": {"prob": 0.0}},
    ],
)
def test_config_matches_jax(kw):
    """The port's config: same fields, defaults and derived sizes as JAX's."""

    def build(mod):
        sub = {"deform": "DeformCfg", "resample": "ResampleCfg", "bias_field": "BiasFieldCfg",
               "noise": "NoiseCfg", "gamma": "GammaCfg"}
        args = {k: getattr(mod, sub[k])(**v) if k in sub else v for k, v in kw.items()}
        return _cfg(mod, **{"shape": SHAPE, **args})

    t, j = build(tconfig), build(jconfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.intensity.nlabels == j.intensity.nlabels == 50
    assert t.deform.small_field_max() == j.deform.small_field_max()
    assert t.bias_field.small_field_max(t.shape) == j.bias_field.small_field_max(j.shape)
    assert t.resample.blur_half_len(t.resolution) == j.resample.blur_half_len(j.resolution)
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="unique"):
            mod.IntensityCfg(seed_labels=(1, 1), generation_classes=(0, 0))
        with pytest.raises(ValueError, match="same lengths"):
            mod.IntensityCfg(seed_labels=(1, 2), generation_classes=(0,))


def test_all_overridden_equals_jax():
    cfg = _cfg()
    ov = _jax_numpy(jparams.sample_params(jax.random.PRNGKey(4), _cfg(jconfig)))
    jp = _jax_numpy(jparams.sample_params(jax.random.PRNGKey(5), _cfg(jconfig), ov))
    tp = tparams.sample_params(make_generators([0, 1], "cpu"), cfg, ov)
    _assert_equal_to_jax(tp, jp)


def test_derived_laws_equal_jax():
    """Grid sizes derived from pinned scales and spacing, and forced gates."""
    cfg = _cfg()
    ov = {"nonlin_scale": 0.0437, "bf_scale": 0.0171, "spacing": [1.2, 1.1, 0.7], "gamma": 1.07}
    jp = _jax_numpy(jparams.sample_params(jax.random.PRNGKey(6), _cfg(jconfig), ov))
    tp = tparams.sample_params(make_generators([3], "cpu"), cfg, ov)
    _assert_equal_to_jax(
        tp, jp,
        ["nonlin_scale", "size_F_small", "bf_scale", "bf_size", "spacing", "new_size", "gamma",
         "gamma_apply", "bf_apply", "resample_apply", "deform_apply"],
    )
    assert tp.gamma_apply.all() and tp.bf_apply.all() and tp.resample_apply.all()
    assert tp.deform_apply.all()


@pytest.mark.parametrize(
    "shape, spacing, f64_size",
    [((44, 44, 44), 1.1, 20), ((48, 48, 48), 1.2, 20), ((48, 48, 48), 0.7, 34)],
)
def test_new_size_f64_boundary(shape, spacing, f64_size):
    """``new_size`` follows the reference's f64 truncation for host spacings
    (ops/numerics.py:6-11): f64(1.2) and f32(1.2) truncate 24/1.2 differently."""
    cfg = _cfg(shape=shape)
    ov = {"spacing": [spacing] * 3}
    port = tparams.resolve_new_size_override(ov, cfg)["new_size"]
    ref = jparams.resolve_new_size_override(ov, _cfg(jconfig, shape=shape))["new_size"]
    np.testing.assert_array_equal(port, ref)
    assert list(port) == [f64_size] * 3
    tp = tparams.sample_params(make_generators([0], "cpu"), cfg, ov)
    assert tp.new_size[0].tolist() == [f64_size] * 3
    # a spacing that is already f32 takes the exact f32-input law instead
    a = np.float32(shape[0] * 0.5)
    f32_size = int(np.float64(a) / np.float64(np.float32(spacing)))
    assert int(floor_div_exact(torch.tensor(a), torch.tensor(np.float32(spacing)))) == f32_size
    if spacing == 1.2:
        assert f32_size == 19 != f64_size


def test_genparams_dict_roundtrip():
    cfg = _cfg()
    p = tparams.sample_params(make_generators([2], "cpu"), cfg)
    d = tparams.genparams_to_dict(p)
    p2 = tparams.sample_params(make_generators([99], "cpu"), cfg, tparams.overrides_from_genparams(d))
    for n in ("mus", "sigmas", "rotations", "shears", "scalings", "nonlin_scale", "nonlin_std",
              "size_F_small", "flip", "deform_apply", "blur_mult"):
        np.testing.assert_array_equal(getattr(p2, n).numpy(), getattr(p, n).numpy(), err_msg=n)
    for gate, names in (("gamma_apply", ["gamma"]), ("bf_apply", ["bf_scale", "bf_std", "bf_size"]),
                        ("resample_apply", ["spacing", "new_size"]), ("noise_apply", ["noise_std"])):
        if bool(getattr(p, gate)):
            for n in names:
                np.testing.assert_array_equal(getattr(p2, n).numpy(), getattr(p, n).numpy(), err_msg=n)
    # a JAX-written dict replays in the port, and a port-written one in JAX
    jd = jparams.genparams_to_dict(jparams.sample_params(jax.random.PRNGKey(8), _cfg(jconfig)))
    tp = tparams.sample_params(make_generators([1], "cpu"), cfg, tparams.overrides_from_genparams(jd))
    np.testing.assert_array_equal(tp.mus[0].numpy(), jd["seed_intensities"]["mus"])
    jp = jparams.sample_params(jax.random.PRNGKey(9), _cfg(jconfig), jparams.overrides_from_genparams(d))
    np.testing.assert_array_equal(np.asarray(jp.rotations), p.rotations[0].numpy())


def test_pinning_one_parameter_moves_no_other_draw():
    cfg = _cfg()
    p = tparams.sample_params(make_generators([5, 6], "cpu"), cfg)
    gens = make_generators([5, 6], "cpu")
    p2 = tparams.sample_params(gens, cfg, {"gamma": 1.3})
    for n in NAMES:
        if n not in ("gamma", "gamma_apply"):
            np.testing.assert_array_equal(getattr(p2, n).numpy(), getattr(p, n).numpy(), err_msg=n)
    assert p2.gamma.tolist() == pytest.approx([1.3, 1.3]) and p2.gamma_apply.all()
    # the voxel fields drawn after the parameters are unmoved too
    f1 = draw_fields(_after_params([5, 6], cfg), cfg, "cpu")
    f2 = draw_fields(gens, cfg, "cpu")
    for a, b in zip(dataclasses.astuple(f1), dataclasses.astuple(f2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _after_params(seeds, cfg):
    gens = make_generators(seeds, "cpu")
    tparams.sample_params(gens, cfg)
    return gens


def test_gates_and_laws():
    cfg = _cfg(gamma=tconfig.GammaCfg(prob=0.0, gamma_std=0.1))
    p = tparams.sample_params(make_generators(range(64), "cpu"), cfg)
    assert not p.gamma_apply.any()  # prob 0 -> off
    assert 0.1 < p.deform_apply.float().mean() <= 1.0
    mr = cfg.deform.max_rotation / 180 * np.pi
    assert (p.rotations.abs() <= mr + 1e-6).all()
    assert ((p.scalings - 1).abs() <= cfg.deform.max_scaling + 1e-6).all()
    assert ((p.mus >= 0) & (p.mus <= 225)).all() and ((p.sigmas >= 5) & (p.sigmas <= 25)).all()
    assert (p.bf_size >= 1).all() and (p.new_size <= 3 * torch.tensor(SHAPE)).all()
    assert (p.spacing[:, 0] == p.spacing[:, 2]).all()
