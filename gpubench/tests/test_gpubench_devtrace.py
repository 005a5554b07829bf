"""Kernel families by name, and the readers of the engine's turn spans
and KV pool gauge, on hand-made windows."""

from types import SimpleNamespace

import pytest

from gpubench import devtrace, harness

# Names as the profiler gave them on an H100 (traced runs of the cells).
GEMMS = [
    "nvjet_tst_112x128_64x7_2x1_v_bz_TNN",
    "nvjet_tst_64x64_64x13_4x2_h_bz_splitK_TNT",
    "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_"
    "warpsize2x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas",
    "void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_128x128_"
    "tn_align1>(cutlass_75_tensorop_bf16_s1688gemm_bf16_128x128_tn_align1::"
    "Params)",
    "void (anonymous namespace)::wg::wgmma_kernel<2>(CUtensorMap_st)",
]
DECODE = [
    "void (anonymous namespace)::paged_decode_kernel<__nv_bfloat16, "
    "__nv_bfloat16, 128, 128>(__nv_bfloat16 const*)",
    "void (anonymous namespace)::paged_row_kernel<__nv_bfloat16, "
    "__nv_bfloat16, 64>(__nv_bfloat16 const*)",
    "void (anonymous namespace)::decode_row_kernel<float, float, 64>(x)",
]
OTHER = [
    "void (anonymous namespace)::flash_bf16_kernel<128, false>(x)",
    "(anonymous namespace)::bodyc::flash_long_kernel(CUtensorMap_st)",
    "void at::native::elementwise_kernel<128, 2, at::native::"
    "gpu_kernel_impl_nocast<at::native::BinaryFunctor<float> > >(x)",
    "void my_fma_kernel_for_something_else<float>(x)",
    "void at::native::reduce_kernel<512, 1, gemm_like_name>(x)",
]


@pytest.mark.parametrize("name", GEMMS + DECODE + OTHER)
def test_kernel_families_by_whole_names(name):
    assert devtrace.is_gemm(name) == (name in GEMMS)
    assert devtrace.is_decode_attention(name) == (name in DECODE)


def _span(name, start, end, **attributes):
    return SimpleNamespace(name=name, start_ms=start * 1e3, end_ms=end * 1e3,
                           attributes=attributes, trace_id="t")


def _window(spans=(), pool=()):
    return harness.Window(cell={}, config={}, records=[], start=10.0,
                          end=20.0, setup_s=1.0, spans=list(spans),
                          pool=list(pool))


def test_slots_decoding_weights_each_turn_by_its_steps():
    read = harness.find_reader("slots_decoding")
    spans = [_span("decode.turn", 11.0, 11.1, horizon=8, active=30),
             _span("decode.turn", 12.0, 12.1, horizon=2, active=10),
             _span("decode.turn", 9.0, 9.1, horizon=8, active=99),  # before
             _span("decode.prefill", 13.0, 13.1)]
    assert read(_window(spans)) == pytest.approx((8 * 30 + 2 * 10) / 10)
    assert read(_window()) is None


def test_kv_pool_pct_is_the_mean_share_inside_the_window():
    read = harness.find_reader("kv_pool_pct")
    pool = [(9.0, 1.0), (10.5, 0.2), (15.0, 0.4), (21.0, 1.0)]
    assert read(_window(pool=pool)) == pytest.approx(30.0)
    assert read(_window(pool=[(5.0, 0.5)])) is None
