"""The benchmark's arithmetic on the CPU: rates, percentiles, the
idle share over overlapping device intervals, kernel names, the hat
passes' bytes from shapes, and the reduction of a profiler trace."""

from __future__ import annotations

import pytest
import torch

from h100_bench import roofline, stats, trace


def test_rate_is_all_work_over_all_time():
    assert stats.rate(1056, 10.0) == pytest.approx(105.6)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("n, want, beyond", [(200, 190, 10), (20, 19, 1), (1, 1, 0), (66, 63, 3)])
def test_p95_with_its_sample_count(n, want, beyond):
    v, k = stats.percentile(list(range(n, 0, -1)), 95)
    assert (v, k) == (want, beyond)


def test_idle_share_over_overlapping_kernels():
    # two streams overlap on [2, 4]; a gap [5, 7); one interval reaches past the window
    busy, gaps = trace.busy_and_gaps([(1, 4), (2, 5), (7, 9), (9, 12)], 0, 10)
    assert busy == pytest.approx(4 + 3)
    assert gaps == [(0, 1), (5, 7)]
    assert trace.union([(3, 4), (1, 2), (1.5, 3)]) == [(1, 4)]


@pytest.mark.parametrize("name, want", [
    ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>(int)", "elementwise_kernel:direct_copy_kernel_cuda"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
     "std::array<char*, 3ul> >(int)", "vectorized_elementwise_kernel:CUDAFunctor_add"),
    ("void (anonymous namespace)::hat_ring_kernel<__nv_bfloat16, 2, true>(Params)", "hat_ring_kernel"),
    ("nvjet_tst_128x128_64x6_2x1_v_bz_NNT", "nvjet_tst_128x128_64x6_2x1_v_bz_NNT"),
])
def test_kernel_short_names(name, want):
    assert trace.short_name(name) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hat_bytes_from_shapes(dtype):
    B, D, H, S, OW = 2, 3, 5, 7, 11
    x = torch.empty((B, D, H, S), dtype=dtype)
    e = x.element_size()
    coefs = torch.empty((B, 4))
    vol = torch.empty((B, D, H, OW))
    lane = torch.empty((B, 3, OW))
    n_in = B * D * H * S * e
    assert roofline.hat_pass_bytes(x, coefs) == n_in + 32 + B * D * H * S * e
    assert roofline.hat_pass_bytes(x, coefs, vol, True) == n_in + 32 + vol.numel() * 4 + B * D * H * OW * e
    assert roofline.hat_pass_bytes(x, coefs, lane) == n_in + 32 + lane.numel() * 4 + B * D * H * OW * e
    assert roofline.hat_pass_bytes(x, coefs, None, False, 13) == n_in + 32 + B * D * H * 13 * e
    per_slice = torch.empty((B, D, 4))
    assert roofline.hat_pass_pair_bytes(x, x, per_slice, vol) == 2 * n_in + per_slice.numel() * 4 \
        + vol.numel() * 4 + 2 * B * D * H * OW * e


def test_peaks_of_the_card():
    p = roofline.peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert roofline.peaks("cpu") is None


def _x(cat, name, ts, dur, tid=1, pid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": pid}


def test_trace_reduction():
    ev = [
        _x("user_annotation", "window", 0, 100, tid=9),
        _x("user_annotation", "batch_program", 0, 100),
        _x("cpu_op", "aten::bmm", 10, 20),
        _x("kernel", "void at::native::elementwise_kernel<4, at::native::direct_copy_kernel_cuda()>()", 0, 10, tid=7),
        _x("kernel", "nvjet_tst_gemm", 5, 10, tid=8),
        _x("gpu_memcpy", "Memcpy DtoD", 40, 10, tid=7),
        _x("kernel", "late", 150, 10, tid=7),
    ]
    r = trace.reduce({"traceEvents": ev}, annotations=["batch_program"])
    assert r["window_us"] == 100 and r["busy_us"] == 25
    assert r["kernels"] == 2 and r["copy_us"] == 10 and r["gemm_us"] == 10
    assert r["idle_gaps"][0] == ["batch_program", pytest.approx(50e-6)]  # [50, 100)
    assert ["batch_program/aten::bmm", pytest.approx(25e-6)] in r["idle_gaps"]  # [15, 40)
    assert trace.reduce({"traceEvents": ev[1:]}) is None
    profiler_span = _x("Trace", "PyTorch Profiler", 0, 100, tid=9)
    assert trace.reduce({"traceEvents": [profiler_span] + ev[1:]})["busy_us"] == 25


def test_label_mismatch_per_element():
    from h100_bench.check import distances

    image, label = torch.ones(8, 8, 8), torch.zeros(8, 8, 8, dtype=torch.int32)
    wrong = label.clone()
    wrong[:2, :2, :2] = 1
    nums = distances([(image, label, image, label), (image, wrong, image, label)])
    assert nums["label_mismatch"] == 8 / 1024
    assert nums["label_mismatch_worst"] == 8 / 512
    assert nums["image_rel_l2"] == nums["image_rel_l2_worst"] == 0
