"""The port's segmentation trainer against the JAX package's, on the CPU.

At 32^3 with ``channels=(8, 16)``: ``UNet3D`` from the flax parameters
(``convert.unet_state_from_flax``) in f32 and bf16, the gradients of
``loss_fn`` (with labels past ``n_classes``, which ``jax.nn.one_hot`` makes
all-zero targets that still count in the mean), AdamW against
``optax.adamw`` on the same gradients, and the fused step with JAX's draws
handed in (``GenParams`` and the voxel fields, as
``tests/test_torch_pipeline.py`` does). Then the data-parallel step and the
sharded generators in two ``gloo`` processes against one process on the
same batch, in place of ``__graft_entry__.dryrun_multichip``.

Bars: f32 logits within 1e-4 of their largest magnitude (XLA:CPU and torch
sum the convolutions in other orders: 2.7e-5 measured); bf16 logits within
5e-2 of it (1.3e-2 measured: the two frameworks round to bf16 at other
points, cuDNN/oneDNN add the bias before rounding); each gradient leaf within
1e-4 of its largest magnitude; AdamW parameters within 1e-6; the fused step's
labels exact, images within 1e-4, loss within 1e-5 relative.
"""

import dataclasses
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from fetalsyngen_tpu.generator import config as jconfig
from fetalsyngen_tpu.generator import params as jparams
from fetalsyngen_tpu.generator.pipeline import _synth_core
from fetalsyngen_tpu.train import step as jstep
from fetalsyngen_tpu.train.unet import UNet3D as JaxUNet
from fetalsyngen_torch.convert import fields_from_numpy, params_from_numpy, unet_state_from_flax
from fetalsyngen_torch.generator import model as tmodel
from fetalsyngen_torch.generator import pipeline as tpipe
from fetalsyngen_torch.generator.artifacts import batched as tba
from fetalsyngen_torch.generator.artifacts import quality as tq
from fetalsyngen_torch.generator.artifacts import scanner as tsc
from fetalsyngen_torch.generator.params import GenParams
from fetalsyngen_torch.parallel import sharding
from fetalsyngen_torch.testing import phantom_seeds_and_seg
from fetalsyngen_torch.train import segmentation
from fetalsyngen_torch.train import step as tstep
from fetalsyngen_torch.train.unet import UNet3D

SHAPE = (32, 32, 32)
CHANNELS = (8, 16)
N_CLASSES = 8
NAMES = [f.name for f in dataclasses.fields(GenParams)]
# the two-rank runs: at most 8 channels a GroupNorm has one channel per
# group, which makes the gradient of the conv bias before it zero in exact
# arithmetic; AdamW's first step (g / (|g| + 1e-8)) then turns rounding
# noise into steps of up to lr, so that weights compared to 1e-6 need
# every gradient to be a signal
DP_CHANNELS = (16, 32)
CUBE, NSG = 64, 32  # the motion engine's tiers at 32^3 (tests/test_torch_stream_artifacts.py)
TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent


def _cfg(mod):
    return segmentation.example_cfg(SHAPE) if mod is None else mod.GeneratorCfg(
        shape=SHAPE, resolution=(0.5, 0.5, 0.5),
        intensity=mod.IntensityCfg(1, 6, segmentation.LABELS, segmentation.GEN_CLASSES),
    )


@pytest.fixture(scope="module")
def flax_params():
    """The flax UNet's parameters (f32 leaves) from ``PRNGKey(0)``."""
    return JaxUNet(channels=CHANNELS, n_classes=N_CLASSES).init(jax.random.PRNGKey(0), jnp.zeros((1, *SHAPE, 1)))


def _port(params, dtype=torch.float32):
    m = UNet3D(CHANNELS, N_CLASSES, dtype)
    m.load_state_dict(unet_state_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return m


def _images(seed, B=2):
    return np.random.default_rng(seed).random((B, *SHAPE), dtype=np.float32)


def test_state_from_flax_names_every_parameter(flax_params):
    """The tree's own names map onto every parameter of the port's module,
    with the same shapes after the permutes."""
    state = unet_state_from_flax(jax.tree_util.tree_map(np.asarray, flax_params))
    want = UNet3D(CHANNELS, N_CLASSES).state_dict()
    assert set(state) == set(want)
    assert all(state[k].shape == want[k].shape for k in want)


@pytest.mark.parametrize("jdt, tdt, bar", [(jnp.float32, torch.float32, 1e-4), (jnp.bfloat16, torch.bfloat16, 5e-2)])
def test_unet_forward_matches_flax(flax_params, jdt, tdt, bar):
    x = _images(0)
    want = np.asarray(JaxUNet(CHANNELS, N_CLASSES, jdt).apply(flax_params, jnp.asarray(x)[..., None]))
    with torch.no_grad():
        got = _port(flax_params, tdt)(torch.from_numpy(x)[:, None])
    assert got.dtype == torch.float32 and got.shape == (2, N_CLASSES, *SHAPE)
    got = np.moveaxis(got.numpy(), 1, -1)
    assert np.abs(got - want).max() <= bar * np.abs(want).max()


def test_conv_transpose_needs_the_flip(flax_params):
    """Without the spatial flip of the transposed kernel the logits differ
    far beyond the f32 bar: the flip is what makes the two agree."""
    x = torch.from_numpy(_images(1))[:, None]
    m = _port(flax_params)
    with torch.no_grad():
        ref = m(x)
        m.ups[0].weight.copy_(m.ups[0].weight.flip(2, 3, 4))
        assert (m(x) - ref).abs().max() > 100 * 1e-4 * ref.abs().max()


def test_init_follows_flax_law():
    """lecun_normal kernels (truncated at 2 sigma, variance 1/fan_in), zero
    biases, GroupNorm scale 1 and bias 0; the same seed gives the same
    weights, another seed others."""
    m = UNet3D((16, 32), N_CLASSES)
    m.init_parameters(torch.Generator().manual_seed(3))
    again = UNet3D((16, 32), N_CLASSES)
    again.init_parameters(torch.Generator().manual_seed(3))
    other = UNet3D((16, 32), N_CLASSES)
    other.init_parameters(torch.Generator().manual_seed(4))
    for (k, v), w, o in zip(m.state_dict().items(), again.state_dict().values(), other.state_dict().values()):
        assert torch.equal(v, w)
        if k.endswith("bias"):
            assert not v.any()
        elif ".norms." in k:
            assert bool((v == 1).all())
        else:
            fan_in = v.shape[0] * v[0, 0].numel() if k.startswith("ups.") else v[0].numel()
            std = (1.0 / fan_in) ** 0.5
            assert float(v.abs().max()) <= 2 * std / 0.87962566103423978
            if v.numel() > 4000:
                assert abs(float(v.std()) / std - 1) < 0.1, k
            assert not torch.equal(v, o)


@pytest.mark.parametrize("top", [N_CLASSES, N_CLASSES + 4])
def test_loss_and_grads_match_jax(flax_params, top):
    """``loss_fn`` and its gradients (f32). ``top`` past ``n_classes`` puts
    a third of the voxels on all-zero one-hot targets."""
    x = _images(2)
    labels = np.random.default_rng(3).integers(0, top, (2, *SHAPE)).astype(np.int32)
    model = JaxUNet(CHANNELS, N_CLASSES, jnp.float32)
    j_loss, j_grads = jax.value_and_grad(jstep._loss_fn)(flax_params, model, jnp.asarray(x), jnp.asarray(labels))
    m = _port(flax_params)
    loss = tstep.loss_fn(m, torch.from_numpy(x), torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    want = unet_state_from_flax(jax.tree_util.tree_map(np.asarray, j_grads))
    top_g = max(float(g.abs().max()) for g in want.values())
    for name, p in m.named_parameters():
        # a conv bias that feeds a GroupNorm of one channel per group has a
        # zero gradient in exact arithmetic (the norm subtracts the channel's
        # mean): both sides are rounding noise, held to the model's scale
        block = name.split(".")
        zero = block[0] == "blocks" and block[2] == "convs" and block[4] == "bias" and p.shape[0] <= 8
        scale = top_g if zero else float(want[name].abs().max())
        err = float((p.grad - want[name]).abs().max())
        assert err <= 1e-4 * scale, name


def test_one_hot_mean_counts_every_voxel():
    """Labels past ``n_classes`` add 0 to the sum and count in the mean; a
    model whose logits are zero gives log(C) times the in-range share."""

    class Zero(torch.nn.Module):
        def forward(self, x):
            return torch.zeros(x.shape[0], N_CLASSES, *x.shape[2:])

    labels = torch.tensor([[[[0, 3], [N_CLASSES, N_CLASSES + 5]]]])
    loss = tstep.loss_fn(Zero(), torch.zeros(1, 1, 2, 2), labels)
    assert torch.allclose(loss, torch.tensor(0.5 * np.log(N_CLASSES), dtype=torch.float32))


def test_adamw_matches_optax(flax_params):
    """The train state's optimizer against ``optax.adamw(1e-3)`` for three
    steps on the same gradients."""
    state = tstep.create_train_state(0, UNet3D(CHANNELS, N_CLASSES, torch.float32), SHAPE, device="cpu")
    state.model.load_state_dict(unet_state_from_flax(jax.tree_util.tree_map(np.asarray, flax_params)))
    tx = optax.adamw(1e-3)
    params = flax_params
    opt_state = tx.init(params)
    rng = np.random.default_rng(5)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.normal(0, 1e-2, a.shape), jnp.float32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        g = unet_state_from_flax(jax.tree_util.tree_map(np.asarray, grads))
        for name, p in state.model.named_parameters():
            p.grad = g[name]
        state.opt.step()
    want = unet_state_from_flax(jax.tree_util.tree_map(np.asarray, params))
    for name, p in state.model.named_parameters():
        assert float((p.detach() - want[name]).abs().max()) <= 1e-6, name


def test_fused_step_matches_jax(flax_params):
    """JAX's ``generate_and_train_step`` from keys; the port's
    ``synth_core`` on the draws JAX made for those keys, then ``train_on``
    from the same weights."""
    B = 2
    seeds_np, seg_np = phantom_seeds_and_seg(SHAPE, seed=0)
    seeds = np.broadcast_to(seeds_np.astype(np.int32), (B, *SHAPE))
    segs = np.broadcast_to(seg_np.astype(np.int32), (B, *SHAPE))
    keys = jax.random.split(jax.random.PRNGKey(1), B)
    jcfg = _cfg(jconfig)
    model = JaxUNet(CHANNELS, N_CLASSES, jnp.float32)
    tx = optax.adamw(1e-3)
    jstate = jstep.TrainState(params=flax_params, opt_state=tx.init(flax_params), step=jnp.zeros((), jnp.int32))
    step = jax.jit(partial(jstep.generate_and_train_step, model=model, tx=tx, cfg=jcfg))
    _, j_loss = step(jstate, keys, jnp.asarray(seeds), jnp.asarray(segs))

    def core(k, sd, sg):
        out, seg, _, p = _synth_core(k, sd, sg, jnp.zeros((), jnp.float32), (), jcfg, (), False)
        return out, seg, p

    j_out, j_seg, p = jax.vmap(core)(keys, jnp.asarray(seeds), jnp.asarray(segs))
    shapes = tpipe.field_shapes(jcfg)
    fields = {
        n: np.stack([np.asarray(jax.random.normal(jparams.field_key(k, f"field_{n}"), shapes[n], jnp.float32))
                     for k in keys])
        for n in shapes
    }
    images, labels, _ = tpipe.synth_core(
        params_from_numpy({n: np.asarray(getattr(p, n)) for n in NAMES}), fields_from_numpy(**fields),
        torch.from_numpy(seeds.copy()), torch.from_numpy(segs.copy()), _cfg(None),
    )
    np.testing.assert_array_equal(labels.numpy(), np.asarray(j_seg))
    np.testing.assert_allclose(images.numpy(), np.asarray(j_out), atol=1e-4, rtol=0)
    state = tstep.create_train_state(0, UNet3D(CHANNELS, N_CLASSES, torch.float32), SHAPE, device="cpu")
    state.model.load_state_dict(unet_state_from_flax(jax.tree_util.tree_map(np.asarray, flax_params)))
    state, loss = tstep.train_on(state, images, labels)
    assert state.step == 1 and loss.shape == () and not loss.requires_grad
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))


def test_step_entry_points_on_the_cpu():
    """``generate_and_train_step`` replays: the same seeds give the same
    loss and weights, and so does ``make_sharded_train_step`` without a
    process group; a seed list of the wrong length and a shape the UNet
    cannot pool raise; without a card the default device raises."""
    cfg = _cfg(None)
    seeds_np, seg_np = phantom_seeds_and_seg(SHAPE, seed=0)
    seeds = torch.from_numpy(seeds_np.astype(np.int32))[None]
    segs = torch.from_numpy(seg_np.astype(np.int32))[None]
    runs = []
    for _ in range(2):
        state = tstep.create_train_state(1, UNet3D(CHANNELS, N_CLASSES), SHAPE, device="cpu")
        state, loss = tstep.generate_and_train_step(state, [9], seeds, segs, cfg)
        runs.append((loss, [p.detach().clone() for p in state.model.parameters()]))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.isfinite(runs[0][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    state = tstep.create_train_state(1, UNet3D(CHANNELS, N_CLASSES), SHAPE, device="cpu")
    step = tstep.make_sharded_train_step(state, cfg, sharding.data_group("cpu"))
    assert step.module is state.model
    loss = step([9], seeds, segs)
    assert state.step == 1 and torch.equal(loss, runs[0][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], state.model.parameters()))
    with pytest.raises(ValueError, match="seeds"):
        tstep.generate_and_train_step(state, [9, 10], seeds, segs, cfg)
    with pytest.raises(ValueError, match="divide"):
        tstep.create_train_state(0, UNet3D((8, 16, 32)), (32, 32, 34), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            tstep.create_train_state(0, UNet3D(CHANNELS), SHAPE)


def test_segmentation_entry_point_runs_on_the_cpu(capsys):
    losses = segmentation.train(2, SHAPE, device="cpu", channels=CHANNELS)
    assert len(losses) == 2 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert "ranks: 1 (cpu), batch 1" in out and "step 1: loss" in out
    assert segmentation.smoothed_ends([3.0, 2.0, 1.0]) == (3.0, 1.0)


# ---------------------------------------------------------------------------
# two gloo ranks against one process
# ---------------------------------------------------------------------------


def _motion_generator():
    """A 32^3 generator with the four SR artifacts on, the motion engine on
    ``tests/test_torch_stream_artifacts.py``'s tiny tiers."""
    mp = tq.StructNoiseMergeParams(
        "perlin", perlin_res_list=[1, 2], perlin_octaves_list=[1, 2], perlin_persistence=0.5,
        perlin_lacunarity=2, perlin_increase_size=0.1,
    )
    rp = tq.ReconMergeParams(
        "perlin", perlin_res_list=[1, 2], perlin_octaves_list=[1, 2], perlin_persistence=0.5,
        perlin_lacunarity=2, perlin_increase_size=0.25,
    )
    sm = tsc.SimulateMotion(
        1.0, tsc.ScannerParams(1.0, 1.5, 2.0, 1.0, 1.5, 1.0, 1.5, 1, 2, 200, 0, 0.05, 1, 1, 0.3, 0.5, 0.05),
        tsc.ReconParams(0.5, 0.1, 0.5, 1.0, 0.5, 0.5, 0.1, 0.4, 1.0, rp), tiers=(CUBE,), ns_grid=NSG,
    )
    return tmodel.FetalSynthGen(
        shape=SHAPE, resolution=(0.5, 0.5, 0.5),
        intensity_generator=tmodel.ImageFromSeeds(1, 2, list(segmentation.LABELS), list(segmentation.GEN_CLASSES)),
        spatial_deform=tmodel.SpatialDeformation(20, 0.02, 0.1, SHAPE, 0.9, True, 0.03, 0.06, 4.0, 0.5),
        resampler=tmodel.RandResample(0.9, 0.5, 1.5), bias_field=tmodel.RandBiasField(0.9, 0.004, 0.02, 0.01, 0.3),
        noise=tmodel.RandNoise(0.9, 5, 15), gamma=tmodel.RandGamma(0.9, 0.1), seed=0, device="cpu",
        blur_cortex=tq.BlurCortex(prob=1.0, cortex_label=2, nblur_min=50, nblur_max=200),
        struct_noise=tq.StructNoise(prob=1.0, wm_label=3, std_min=0.2, std_max=0.4, merge_params=mp),
        boundaries=tq.SimulatedBoundaries(prob_no_mask=0.0, prob_if_mask_halo=1.0, prob_if_mask_fuzzy=1.0),
        simulate_motion=sm,
    )


def _dp_inputs():
    """The global batch of the two-rank runs: two volumes, their seeds, and
    the motion pack (every artifact forced on)."""
    rng = np.random.default_rng(0)
    seeds = torch.from_numpy(rng.integers(0, 50, (2, *SHAPE)).astype(np.int32))
    _, seg = phantom_seeds_and_seg(SHAPE, seed=2)
    seeds_ph, _ = phantom_seeds_and_seg(SHAPE, seed=3)
    seeds[1] = torch.from_numpy(seeds_ph.astype(np.int32))
    segs = torch.from_numpy(np.stack([seg, seg]).astype(np.int32))
    gen = _motion_generator()
    sm = gen.artifacts["simulate_motion"]
    pack = tba.pack_motion(np.random.default_rng(7), 2, SHAPE, 0.5, sm, CUBE, NSG)
    pack["gates"] = np.ones((2, 3), np.int32)
    return [11, 12], seeds, segs, gen, pack


def _rank_main(rank: int, world: int, tmp: str) -> None:
    """One rank of the two-process run: the data-parallel step, the
    sharded generator and the sharded artifact generator, each result
    saved for the parent."""
    import torch.distributed as dist

    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/pg", rank=rank, world_size=world)
    try:
        g = sharding.data_group("cpu")
        assert (g.rank, g.world) == (rank, world)
        sps, seeds, segs, gen, pack = _dp_inputs()
        state = tstep.create_train_state(0, UNet3D(DP_CHANNELS, N_CLASSES, torch.float32), SHAPE, device="cpu")
        step = tstep.make_sharded_train_step(state, _cfg(None), g)
        assert isinstance(step.module, torch.nn.parallel.DistributedDataParallel)
        loss = step(sps, seeds, segs)
        images, labels = sharding.make_sharded_generator(g, _cfg(None))(sps, seeds, segs)
        art = sharding.make_sharded_artifact_generator(g, gen, SHAPE, CUBE, NSG)(sps, seeds, segs, pack)
        torch.save({"loss": loss, "params": {k: v.detach() for k, v in state.model.named_parameters()},
                    "grads": {k: v.grad for k, v in state.model.named_parameters()},
                    "step": state.step, "images": images, "labels": labels, "art": art}, f"{tmp}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """The data-parallel step on 2 ranks x 1 volume equals one process's
    step on the same 2 volumes: the loss within 1e-6, the averaged gradients
    within 1e-5 of each leaf's scale, each rank's weights AdamW's step of its
    gradients and within 1e-6 of the one process's wherever the step is not
    ill-conditioned (|g| >= 1e-6, all but 0.11% of the weights); each rank's
    sharded generator gives its rows of ``synth_batch`` and its sharded
    artifact generator its rows of ``apply_chain`` on the same seeds and
    pack, bit for bit. The ranks run the artifact generator in the f32
    mode (``FSG_STREAM_BF16=0``): the one-process reference is f32."""
    code = f"import sys; sys.path.insert(0, {str(TESTS)!r}); import test_torch_train as t; " \
           "t._rank_main(int(sys.argv[1]), 2, sys.argv[2])"
    env = {**os.environ, "FSG_STREAM_BF16": "0",
           "PYTHONPATH": os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(tmp_path)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]

    sps, seeds, segs, gen, pack = _dp_inputs()
    cfg, lr = _cfg(None), 1e-3
    init = UNet3D(DP_CHANNELS, N_CLASSES, torch.float32)
    init.init_parameters(torch.Generator().manual_seed(0))
    state = tstep.create_train_state(0, UNet3D(DP_CHANNELS, N_CLASSES, torch.float32), SHAPE, lr, "cpu")
    state, loss = tstep.generate_and_train_step(state, sps, seeds, segs, cfg)
    images, labels, _ = tpipe.synth_batch(seeds, segs, cfg, sps, "cpu")
    spec = tba.ChainSpec(tba.QualityArtifacts.from_generator(gen), gen.artifacts["simulate_motion"], SHAPE,
                         (CUBE,), NSG)
    core, core_labels, _ = tpipe.synth_batch(seeds, segs, gen.cfg, sps, "cpu")
    chained = tstep.normalize_peak(tba.apply_chain(core, core_labels, spec, pack, tba.chain_draws(sps, "cpu")))
    for r, got in enumerate(ranks):
        assert got["step"] == 1
        assert abs(float(got["loss"]) - float(loss)) <= 1e-6
        ill = 0
        for (k, v), v0 in zip(state.model.named_parameters(), init.parameters()):
            g, got_g, got_p = v.grad, got["grads"][k], got["params"][k]
            # DDP's averaged gradient: the same sums in another order
            assert float((got_g - g).abs().max()) <= 1e-5 * float(g.abs().max()), k
            # AdamW's first step moves a weight by lr * g / (|g| + eps): each
            # rank's step is that of its own gradient ...
            want = v0.detach() * (1 - lr * tstep.ADAMW["weight_decay"]) - lr * got_g / (got_g.abs() + 1e-8)
            assert float((got_p - want).abs().max()) <= 1e-6, k
            # ... and the weights agree to 1e-6 where |g| >= 1e-6; below,
            # the step's slope lr * eps / (|g| + eps)^2 (up to 1e5) magnifies
            # the gradients' rounding differences
            well = g.abs() >= 1e-6
            assert float(torch.where(well, got_p - v.detach(), 0.0).abs().max()) <= 1e-6, k
            ill += int((~well).sum())
        assert ill <= 1e-2 * sum(p.numel() for p in init.parameters())  # 0.11% measured
        assert torch.equal(got["images"], images[r : r + 1]) and torch.equal(got["labels"], labels[r : r + 1])
        assert torch.equal(got["art"][0], chained[r : r + 1])
        assert torch.equal(got["art"][1], core_labels[r : r + 1])
    assert not torch.equal(ranks[0]["art"][0], tstep.normalize_peak(core[:1]))


@pytest.mark.parametrize("device, want", [
    (None, [("set_device", 1), ("init", "nccl")]),
    ("cpu", [("init", "gloo")]),
])
def test_entry_point_binds_the_card_before_the_group(monkeypatch, device, want):
    """Under ``torchrun`` the entry point binds the process to
    ``cuda:LOCAL_RANK`` before it creates the NCCL group (a group made first
    sets its communicator up on cuda:0 in every rank); gloo binds nothing.
    Both calls are stubs: the group's creation stops the run."""
    calls = []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: calls.append(("set_device", i)))

    def init(backend, *a, **kw):
        calls.append(("init", backend))
        raise RuntimeError("group stub")

    monkeypatch.setattr(segmentation.dist, "init_process_group", init)
    with pytest.raises(RuntimeError, match="group stub"):
        segmentation.main(["--steps", "1"] + ([] if device is None else ["--device", device]))
    assert calls == want


def test_sharding_without_a_group():
    """World 1 without a process group: the rows are the whole batch, and
    an indivisible batch raises where there are ranks."""
    g = sharding.data_group("cpu")
    assert (g.rank, g.world, g.device) == (0, 1, torch.device("cpu"))
    x = torch.arange(6).reshape(3, 2)
    assert torch.equal(sharding.shard_batch(g, x), x) and sharding.shard_seeds(g, [4, 5, 6]) == [4, 5, 6]
    two = sharding.DataGroup(1, 2, torch.device("cpu"))
    assert torch.equal(sharding.shard_batch(two, torch.arange(4)), torch.tensor([2, 3]))
    with pytest.raises(ValueError, match="divide"):
        sharding.shard_seeds(two, [1, 2, 3])
