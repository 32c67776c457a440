"""The percentile, spread and union arithmetic, and the reading of a
Chrome trace: spans, library kernels, idle gaps."""
import statistics

import pytest

from portbench import stats, trace


def test_nearest_rank_percentile():
    values = list(range(1, 101))
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values, 100) == 100
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([5, 1, 4, 2, 3], 50) == 3
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_spread_is_the_quartile_distance_over_the_median():
    values = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert stats.spread(values) == pytest.approx((q3 - q1) / med)


def test_union_and_gaps():
    spans = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert trace.union_us(spans) == 4
    assert trace.gaps_us(spans, -1, 8) == [(-1, 0), (3, 5), (6, 8)]
    assert trace.gaps_us([], 0, 1) == [(0, 1)]
    assert trace.gaps_us([(0, 10)], 2, 4) == []


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_parse_places_device_ops_by_their_launch():
    """Host clock in seconds, trace clock in us 1000 ahead of it."""
    us = 1e-6
    spans = [("bl_draw", 1 * us, 10 * us), ("call", 10 * us, 40 * us),
             ("read_back", 45 * us, 55 * us)]
    anchors = [(-5 * us, -4 * us), (101 * us, 102 * us)]
    events = [
        _x("cuda_runtime", "cudaLaunchKernel", 995.0, 1.0, corr=10),
        _x("kernel", "marker_kernel", 996.0, 1.0, corr=10),
        _x("cuda_runtime", "cudaLaunchKernel", 1003, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 1013, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 1020, 1, corr=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 1047, 1, corr=4),
        _x("kernel", "void at::native::normal_kernel<2>(float*)", 1005, 5,
           corr=1),
        _x("kernel", "sm90_xmma_gemm_f64f64_cublas", 1014, 6, corr=2),
        _x("kernel", "void (anonymous namespace)::paired_grad_onchip_kernel"
           "<4, 4, false, 1>(int const*)", 1022, 20, corr=3),
        _x("gpu_memcpy", "Memcpy DtoH", 1048, 2, corr=4),
        _x("kernel", "paired_ll_onchip_kernel(int const*)", 998, 4, corr=99),
        _x("cuda_runtime", "cudaLaunchKernel", 1101.0, 1.0, corr=11),
        _x("kernel", "marker_kernel", 1102.0, 1.0, corr=11),
    ]
    t = trace.parse(events, spans, (0.0, 100 * us), anchors,
                    frozenset({"paired_grad_onchip_kernel",
                               "paired_ll_onchip_kernel"}))
    assert t.calls == 1 and t.window_s == pytest.approx(100e-6)
    ops = {trace.base_name(op.name): op for op in t.ops}
    assert "marker_kernel" not in ops
    assert (ops["normal_kernel"].span, ops["normal_kernel"].library) == (
        "bl_draw", False)
    gemm = ops["sm90_xmma_gemm_f64f64_cublas"]
    assert (gemm.span, gemm.library) == ("call", False)
    grad = ops["paired_grad_onchip_kernel"]
    assert (grad.span, grad.library) == ("call", True)
    assert ops["DtoH"].span == "read_back"
    early = ops["paired_ll_onchip_kernel"]
    assert (early.start, early.end) == (pytest.approx(1000), 1002)
    assert early.span == trace.UNPLACED and early.library
    assert t.device_s(library=True) == pytest.approx((20 + 2) * 1e-6)
    assert t.device_s(span="call", library=False) == pytest.approx(6e-6)
    assert t.busy_s == pytest.approx((2 + 5 + 26 + 2) * 1e-6)
    idle = t.idle_by_span()
    assert idle["bl_draw"] == pytest.approx(3e-6)        # 1002-1005
    assert idle["read_back"] == pytest.approx(6e-6)      # 1042-1048
    assert idle["harness"] == pytest.approx(50e-6)       # 1050-1100
    assert sum(idle.values()) == pytest.approx(t.window_s - t.busy_s)
    assert t.top_ops(1)[0][1] == pytest.approx(20e-6)


def test_library_kernels_are_the_tree_kernels_of_the_program():
    names = trace.library_kernels()
    assert {"paired_grad_onchip_kernel", "paired_grad_a64_kernel",
            "paired_ll_onchip_kernel"} <= names
    assert trace.base_name("(anonymous namespace)::paired_grad_a64_kernel"
                           "(int const*, float const*)") == \
        "paired_grad_a64_kernel"
