"""The stream's bf16 production mode: the port's scopes against the JAX
package's ``precision_scope`` / ``storage_scope`` / ``_production_scopes``.

Bars (each measured on these inputs, then stated here):

- scopes: nest and restore, ``f32_scope`` suspends both, a thread started
  inside a scope runs outside it;
- ``einsum_store`` / ``axis_mm`` under ``storage_scope(bf16)`` against JAX's
  under ``storage_scope(jnp.bfloat16)``: the same dtype, values within one
  bf16 ulp (f32 sums of the same exact products in another order, rounded
  once);
- the plain bf16 hat passes against ``_hat_pass_jnp`` on the same bf16 rows:
  labels (nearest) equal, linear samples within one bf16 ulp;
- ``synth_core`` in the storage-only mode against JAX's ``_synth_core``
  under ``_production_scopes()`` on the CPU (XLA:CPU ignores
  ``Precision.DEFAULT``, so JAX's mode there is storage-only): labels equal,
  the image within two bf16 ulps of its scale;
- the full production mode (bf16 precision too) against JAX's and against
  the port's own f32 core at JAX's bf16-against-f32 bars
  (``tests/test_pipeline.py``): labels equal, correlation > 0.995, relative
  L2 < 3e-2;
- a stream batch with the four artifacts in the production mode against
  JAX's ``_make_batch_fn`` with its draws handed in by name, at
  ``tests/test_batched_artifacts.py``'s bars (relative L2 < 2e-2,
  correlation > 0.999);
- ``make_sharded_artifact_generator`` on two ``gloo`` ranks against one
  process, in the production mode.
"""

import contextlib
import dataclasses
import threading

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fetalsyngen_tpu.generator import config as jconfig
from fetalsyngen_tpu.generator import params as jparams
from fetalsyngen_tpu.generator.pipeline import _synth_core
from fetalsyngen_tpu.ops import linops as jlinops
from fetalsyngen_tpu.ops import warp as jwarp
from fetalsyngen_tpu.parallel.input_pipeline import _production_scopes as j_production_scopes
from fetalsyngen_torch.convert import fields_from_numpy, params_from_numpy
from fetalsyngen_torch.generator import config as tconfig
from fetalsyngen_torch.generator import params as tparams
from fetalsyngen_torch.generator import pipeline as tpipe
from fetalsyngen_torch.kernels import hat
from fetalsyngen_torch.ops import linops
from fetalsyngen_torch.parallel.input_pipeline import _production_scopes
import fetalsyngen_torch.testing
# the stream fixtures and JAX's chain draws (tests/ is on the path, as
# test_torch_stream_artifacts imports test_torch_stream)
from test_torch_stream_artifacts import FORCED, _jax_chain_given, ds, jds, root  # noqa: F401
SHAPE = (32, 40, 36)
LABELS = tuple([0] + list(range(10, 50)))
GEN_CLASSES = tuple([0] + [10] * 10 + [20] * 10 + [30] * 10 + list(range(40, 50)))
GATES = ("bf_apply", "deform_apply", "gamma_apply", "noise_apply", "resample_apply")
NAMES = [f.name for f in dataclasses.fields(tparams.GenParams)]


def _ulps(a: np.ndarray, b: np.ndarray, scale=None) -> float:
    """max |a - b| in bf16 ulps: of each value's own magnitude, or of ``scale``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ref = np.maximum(np.abs(a), np.abs(b)) if scale is None else scale
    ulp = np.maximum(2.0 ** (np.floor(np.log2(np.maximum(ref, 1e-30))) - 7), 2.0**-133)
    return float(np.max(np.abs(a - b) / ulp))


# ---------------------------------------------------------------------------
# the scopes
# ---------------------------------------------------------------------------


def test_scopes_nest_and_restore():
    assert linops.current_precision() is None and linops.current_storage() is None
    with linops.precision_scope(linops.DEFAULT), linops.storage_scope(torch.bfloat16):
        assert linops.current_precision() == linops.DEFAULT
        assert linops.current_storage() == torch.bfloat16 and linops.io_dtype() == torch.bfloat16
        with linops.f32_scope():
            assert linops.current_precision() is None and linops.current_storage() is None
            assert linops.io_dtype() == torch.float32
            with linops.storage_scope(torch.bfloat16):
                assert linops.current_storage() == torch.bfloat16
            assert linops.current_storage() is None
        assert linops.current_precision() == linops.DEFAULT
        assert linops.current_storage() == torch.bfloat16
    assert linops.current_precision() is None and linops.current_storage() is None
    with pytest.raises(ValueError):
        with linops.storage_scope(torch.float16):
            pass
    with pytest.raises(ValueError):
        with linops.precision_scope("fast"):
            pass


def test_scope_does_not_leak_into_another_thread():
    """A thread running while another holds the scopes computes in f32."""
    rng = np.random.default_rng(0)
    M = torch.from_numpy(rng.normal(size=(12, 10)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(10, 6, 5)).astype(np.float32))
    want = torch.einsum("oi,ijk->ojk", M, x)
    inside, outside = threading.Event(), threading.Event()
    got = {}

    def scoped():
        with linops.precision_scope(linops.DEFAULT), linops.storage_scope(torch.bfloat16):
            got["scoped"] = linops.axis_mm(x, M, 0)
            inside.set()
            outside.wait(10)

    def plain():
        inside.wait(10)
        got["dtype"] = linops.current_storage()
        got["plain"] = linops.axis_mm(x, M, 0)
        got["prec"] = linops.prec_matmul(M, x.reshape(10, -1))
        outside.set()

    threads = [threading.Thread(target=scoped), threading.Thread(target=plain)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got["scoped"].dtype == torch.bfloat16
    assert got["dtype"] is None
    assert got["plain"].dtype == torch.float32
    torch.testing.assert_close(got["plain"], want, rtol=0, atol=1e-5)
    torch.testing.assert_close(got["prec"], want.reshape(12, -1), rtol=0, atol=1e-5)


def test_production_scopes_read_the_rollback(monkeypatch):
    with _production_scopes():
        assert linops.current_storage() == torch.bfloat16
        assert linops.current_precision() == linops.DEFAULT
    monkeypatch.setenv("FSG_STREAM_BF16", "0")
    with _production_scopes():
        assert linops.current_storage() is None and linops.current_precision() is None


# ---------------------------------------------------------------------------
# the contractions against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec, ms, xs", [
    ("oi,ijk->ojk", (20, 24), (24, 9, 7)),
    ("oi,jik->jok", (20, 9), (5, 9, 7)),
    ("oi,jki->jko", (11, 7), (5, 9, 7)),
    ("oi,jki->okj", (48, 40), (33, 35, 40)),
    ("jks,ijs->ijk", (9, 12, 12), (6, 9, 12)),
])
@pytest.mark.parametrize("out_f32", [False, True])
def test_einsum_store_matches_jax(spec, ms, xs, out_f32):
    rng = np.random.default_rng(len(spec) + sum(ms))
    M = rng.normal(size=ms).astype(np.float32)
    x = (rng.normal(size=xs) * 40.0).astype(np.float32)
    with jlinops.storage_scope(jnp.bfloat16):
        want = jlinops.einsum_store(spec, jnp.asarray(M), jnp.asarray(x), out_f32=out_f32)
    with linops.storage_scope(torch.bfloat16):
        got = linops.einsum_store(spec, torch.from_numpy(M), torch.from_numpy(x), out_f32=out_f32)
    assert got.dtype == (torch.float32 if out_f32 else torch.bfloat16)
    assert str(want.dtype) == ("float32" if out_f32 else "bfloat16")
    got, want = got.to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32))
    if out_f32:  # the same exact products summed in f32 in another order
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    else:
        assert _ulps(got, want) <= 1.0


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_axis_mm_matches_jax_apply_axis_matrix(axis):
    rng = np.random.default_rng(axis)
    x = (rng.normal(size=(24, 28, 20)) * 10).astype(np.float32)
    M = rng.normal(size=(30, x.shape[axis])).astype(np.float32)
    with jlinops.storage_scope(jnp.bfloat16):
        want = jlinops.apply_axis_matrix(jnp.asarray(x), jnp.asarray(M), axis)
    with linops.storage_scope(torch.bfloat16):
        got = linops.axis_mm(torch.from_numpy(x), torch.from_numpy(M), axis)
        got32 = linops.axis_mm(torch.from_numpy(x), torch.from_numpy(M), axis, out_f32=True)
    assert got.dtype == torch.bfloat16 and got32.dtype == torch.float32
    assert str(want.dtype) == "bfloat16"
    assert _ulps(got.float().numpy(), np.asarray(want.astype(jnp.float32))) <= 1.0
    # out_f32 is the same sum, unrounded
    assert torch.equal(got32.to(torch.bfloat16), got) or _ulps(got32.to(torch.bfloat16).float().numpy(),
                                                             got.float().numpy()) <= 1.0


def test_default_precision_rounds_the_operands():
    """``precision_scope(DEFAULT)``: one bf16 pass, f32 out; the CPU rounds
    the operands as the card's bf16 GEMM takes them."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(16, 24)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(24, 8)).astype(np.float32))
    with linops.precision_scope(linops.DEFAULT):
        got = linops.prec_matmul(a, b)
    want = a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    assert not torch.allclose(got, a @ b, rtol=0, atol=1e-5)
    with linops.precision_scope(None):
        torch.testing.assert_close(linops.prec_matmul(a, b), a @ b, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the plain bf16 hat passes against _hat_pass_jnp
# ---------------------------------------------------------------------------

# (K1 or K2, nearest second operand / nearest, coef mode, disp mode)
BF16_FORMS = [
    ("pair", True, "sample", "volume"),
    ("pair", False, "sample", "lane"),
    ("single", False, "sample", "none"),
    ("single", True, "sample", "none"),
    ("single", False, "sample", "lane"),
    ("single", False, "slice", "none"),
]


def _hat_inputs(rng, B, D, H, S, per_slice, disp_kind):
    va = (rng.normal(size=(B, D, H, S)) * 30).astype(np.float32)
    vb = rng.integers(0, 50, size=(B, D, H, S)).astype(np.float32)
    if per_slice:
        coefs = np.stack([np.zeros((B, D)), rng.uniform(-0.1, 0.1, (B, D)), rng.uniform(0.9, 1.1, (B, D)),
                          rng.uniform(-3, 3, (B, D))], -1).astype(np.float32)
    else:
        coefs = np.stack([rng.uniform(-0.2, 0.2, B), rng.uniform(-0.2, 0.2, B), rng.uniform(0.9, 1.1, B),
                          rng.uniform(-3, 3, B)], -1).astype(np.float32)
    disp = None
    if disp_kind == "volume":
        disp = rng.uniform(-6, 6, size=(B, D, H, S)).astype(np.float32)
    elif disp_kind == "lane":
        disp = rng.uniform(-0.05, 0.05, size=(B, 3, S)).astype(np.float32)
    return va, vb, coefs, disp


@pytest.mark.parametrize("kernel, nearest, coef_mode, disp_kind", BF16_FORMS)
def test_plain_bf16_hat_matches_hat_pass_jnp(kernel, nearest, coef_mode, disp_kind):
    rng = np.random.default_rng(7)
    B, D, H, S = 2, 6, 5, 48
    va, vb, coefs, disp = _hat_inputs(rng, B, D, H, S, coef_mode == "slice", disp_kind)
    ta = torch.from_numpy(va).to(torch.bfloat16)
    tb = torch.from_numpy(vb).to(torch.bfloat16)
    tdisp = None if disp is None else torch.from_numpy(disp)
    tc = torch.from_numpy(coefs)
    if kernel == "pair":
        oa, ob = hat.hat_pass_pair(ta, tb, tc, tdisp, nearest_b=nearest)
        outs = [(ta, oa, False), (tb, ob, nearest)]
    else:
        x = tb if nearest else ta
        outs = [(x, hat.hat_pass(x, tc, tdisp, nearest=nearest), nearest)]
    R = D * H
    pos = hat._positions_of(tc, B, D, H, S, tdisp)  # f32 positions, held equal to JAX's in test_torch_hat
    for x, out, near in outs:
        assert out.dtype == torch.bfloat16
        x2d = jnp.asarray(x.float().numpy().reshape(B, R, S)).astype(jnp.bfloat16)
        want = np.stack([
            np.asarray(jwarp._hat_pass_jnp(x2d[b], jnp.asarray(pos[b].numpy()), near).astype(jnp.float32))
            for b in range(B)
        ]).reshape(B, D, H, S)
        got = out.float().numpy()
        if near:
            np.testing.assert_array_equal(got, want)
        else:
            assert _ulps(got, want) <= 1.0


# ---------------------------------------------------------------------------
# synth_core in the production mode
# ---------------------------------------------------------------------------


def _cfg(mod, shape=SHAPE):
    return mod.GeneratorCfg(
        shape=shape,
        resolution=(0.5, 0.5, 0.5),
        intensity=mod.IntensityCfg(1, 6, LABELS, GEN_CLASSES),
        deform=mod.DeformCfg(size=shape, warp_impl="separable", nonlinear_transform=True),
    )


@pytest.fixture(scope="module")
def volumes():
    seeds, seg = fetalsyngen_torch.testing.phantom_seeds_and_seg(SHAPE, seed=1)
    return seeds.astype(np.int32), seg.astype(np.int32)


@pytest.fixture(scope="module")
def jax_runs(volumes):
    """JAX ``_synth_core`` under ``_production_scopes()`` and in f32, every
    gate on, for three keys: (bf16 output, f32 output, labels, params,
    fields) as numpy."""
    seeds, seg = volumes
    cfg = _cfg(jconfig)
    runs = {}
    for k in (0, 1, 2):
        key = jax.random.PRNGKey(k)
        gates = tuple(jnp.asarray(True) for _ in GATES)
        args = (key, jnp.asarray(seeds), jnp.asarray(seg), jnp.zeros((), jnp.float32), gates, cfg, GATES, False)
        with j_production_scopes():
            out, seg_o, _, p = _synth_core(*args)
        out32, seg32, _, _ = _synth_core(*args)
        shapes = tpipe.field_shapes(cfg)
        fields = {
            n: np.asarray(jax.random.normal(jparams.field_key(key, f"field_{n}"), shapes[n], jnp.float32))
            for n in shapes
        }
        params = {n: np.asarray(getattr(p, n)) for n in NAMES}
        runs[k] = (np.asarray(out.astype(jnp.float32)), np.asarray(out32), np.asarray(seg_o),
                   np.asarray(seg32), params, fields)
    return runs


def _port_core(volumes, params, fields, scopes):
    seeds, seg = volumes
    with scopes:
        out, seg_o, _ = tpipe.synth_core(
            params_from_numpy(params), fields_from_numpy(**fields),
            torch.from_numpy(seeds[None]), torch.from_numpy(seg[None]), _cfg(tconfig),
        )
    return out[0].float().numpy(), seg_o[0].numpy()


def _corr(a, b) -> float:
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_storage_only_core_matches_jax_production(k, volumes, jax_runs):
    j_out, _, j_seg, _, params, fields = jax_runs[k]
    out, seg = _port_core(volumes, params, fields, linops.storage_scope(torch.bfloat16))
    assert out.shape == SHAPE and np.isfinite(out).all()
    np.testing.assert_array_equal(seg, j_seg)
    assert _ulps(out, j_out, scale=np.abs(j_out).max()) <= 2.0


@pytest.mark.parametrize("k", [0, 1, 2])
def test_production_core_meets_jax_bars(k, volumes, jax_runs):
    """The full mode (bf16 precision on the CPU too) against JAX's
    production output and against the port's own f32 core."""
    j_out, j_out32, j_seg, j_seg32, params, fields = jax_runs[k]
    out, seg = _port_core(volumes, params, fields, _production_scopes())
    out32, seg32 = _port_core(volumes, params, fields, contextlib.nullcontext())
    np.testing.assert_array_equal(seg32, j_seg32)
    for ref, ref_seg in ((j_out, j_seg), (out32, seg32)):
        np.testing.assert_array_equal(seg, ref_seg)
        assert _corr(out, ref) > 0.995
        assert _rel(out, ref) < 3e-2


# ---------------------------------------------------------------------------
# the stream with the four artifacts, and the sharded artifact generator
# ---------------------------------------------------------------------------


def test_stream_batch_with_artifacts_meets_jax_bars(ds, jds):
    """Every artifact forced on, both streams at their defaults (the
    production mode): the port's batch program on JAX's core and artifact
    draws against JAX's batch. Labels equal; each image within JAX's own
    bf16-against-f32 bars of the motion engine."""
    from test_torch_stream import _jax_draws

    from fetalsyngen_torch.generator.artifacts import batched as tba
    from fetalsyngen_torch.parallel import input_pipeline as tstream
    from fetalsyngen_tpu.parallel import input_pipeline as jpipe

    B = 2
    jstream = jpipe.SyntheticStream(jds, batch_size=B, seed=0, prefetch=False, genparams={"artifact_params": FORCED})
    jbatch = next(iter(jstream))
    meta = jbatch["meta"]
    stream = tstream.SyntheticStream(ds, batch_size=B, seed=0, prefetch=False, genparams={"artifacts": FORCED})
    params, fields, u = _jax_draws(meta["sub"], jstream.cfg, B)
    draws = [tba.Draws(0, "cpu", given=g) for g in _jax_chain_given(meta["sub"], B, meta["pack"], jstream)]
    banks = stream._banks_for(meta["resident"])
    chain = stream.make_chain({"pack": meta["pack"]}, draws=draws)
    image, label = tstream.batch_program(*banks, torch.tensor(meta["subj"]), torch.tensor(u),
                                         params_from_numpy(params), fields_from_numpy(**fields), stream.cfg,
                                         stream._lo, chain)
    assert image.dtype == torch.float32 and float(image.amax(dim=(1, 2, 3)).min()) == 1.0
    np.testing.assert_array_equal(label.numpy(), np.asarray(jbatch["label"]))
    want = np.asarray(jbatch["image"])
    for b in range(B):
        got = image[b].numpy()
        assert _rel(got, want[b]) < 2e-2
        assert _corr(got, want[b]) > 0.999


def _sharded_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of the production-mode two-rank run."""
    import torch.distributed as dist

    from test_torch_train import CUBE, NSG, SHAPE as TSHAPE, _dp_inputs

    from fetalsyngen_torch.parallel import sharding

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=rank, world_size=world)
    try:
        g = sharding.data_group("cpu")
        sps, seeds, segs, gen, pack = _dp_inputs()
        art = sharding.make_sharded_artifact_generator(g, gen, TSHAPE, CUBE, NSG)(sps, seeds, segs, pack)
        torch.save(art, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_sharded_artifact_generator_two_ranks_in_production_mode(tmp_path, monkeypatch):
    """Two ``gloo`` ranks of ``make_sharded_artifact_generator`` at the
    stream's default (the production mode) give, bit for bit, their rows of
    one process's run; and that run differs from the f32 mode's."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from test_torch_train import CUBE, NSG, SHAPE as TSHAPE, _dp_inputs

    from fetalsyngen_torch.parallel import sharding

    tests = Path(__file__).resolve().parent
    code = f"import sys; sys.path.insert(0, {str(tests)!r}); import test_torch_precision as t; " \
           "t._sharded_rank(int(sys.argv[1]), 2, sys.argv[2])"
    env = {k: v for k, v in os.environ.items() if k != "FSG_STREAM_BF16"}
    env["PYTHONPATH"] = os.pathsep.join([str(tests.parent), os.environ.get("PYTHONPATH", "")])
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(tmp_path)], env=env, cwd=tests.parent,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    sps, seeds, segs, gen, pack = _dp_inputs()
    one = sharding.data_group("cpu")
    images, labels = sharding.make_sharded_artifact_generator(one, gen, TSHAPE, CUBE, NSG)(sps, seeds, segs, pack)
    for r in range(2):
        got_images, got_labels = torch.load(tmp_path / f"rank{r}.pt")
        assert torch.equal(got_images, images[r : r + 1]) and torch.equal(got_labels, labels[r : r + 1])
    monkeypatch.setenv("FSG_STREAM_BF16", "0")
    f32, _ = sharding.make_sharded_artifact_generator(one, gen, TSHAPE, CUBE, NSG)(sps, seeds, segs, pack)
    assert not torch.equal(f32, images)
    assert _corr(images.numpy(), f32.numpy()) > 0.99


@pytest.mark.parametrize("v", ["pair_l_unit", "u_stage", "deform_pair"])
def test_microbench_bf16_variants(v):
    """The three bf16 variants of ``probes/microbench_warp.py`` run one step
    on the CPU at 16^3 on the same inputs as their f32 twins: f32 outputs
    within a relative L2 of 1e-2 of the twins' (bf16 rows and operators)."""
    from fetalsyngen_torch.probes import microbench_warp as mb

    assert v + "_bf16" in mb.VARIANTS
    dev = torch.device("cpu")
    step32, carry32 = mb.build(v, 2, 16, dev)
    step16, carry16 = mb.build(v + "_bf16", 2, 16, dev)
    for a, b in zip(step32(carry32)[:2], step16(carry16)[:2]):
        assert b.dtype == torch.float32 and bool(torch.isfinite(b).all())
        assert not torch.equal(a, b)
        assert _rel(b.numpy(), a.numpy()) < 1e-2
