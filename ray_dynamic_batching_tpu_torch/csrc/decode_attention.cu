// Slab decode attention for Hopper (sm_90a), plain FMA version.
//
// Replaces ray_dynamic_batching_tpu/ops/decode_attention.py::_decode_attention
// (Pallas bodies _decode_kernel + _scan_tile): a fused KV scan for a small
// query window (1 <= Tq <= 8) with an online softmax in f32 and the int8
// window mask [B, Tq, S]. K/V are q's type, or int8 codes of the int8 KV
// cache with f32 scales k_scale/v_scale [B, S, K] (the reference's scale
// BlockSpecs, decode_attention.py:268-279, and _scan_tile's ks/vs branch):
// the codes are read as 1-byte elements and the scales applied inside the
// products (rdb::DecodeScan), never as a dequantized tile in memory.
//
// Layouts: q/out [B, Tq, N, H]; k/v [B, S, K, H]; scales [B, S, K] (the
// cache's own layout: key pos of KV head kvh at (b * S + pos) * K + kvh);
// all contiguous.
// Grid (K, B): one block per (slot, KV head). All G = N / K query heads of
// that KV head, times the Tq window rows (rows ordered (t, g), R = Tq * G),
// ride one read of each K/V tile — GQA by layout, no repeat of the cache.
// A sequential loop over S tiles inside the block carries (m, l, acc) in
// shared memory; it replaces the TPU's sequential ("arbitrary") grid axis.
// The per-tile scan and its softmax rule are rdb::DecodeScan (common.cuh),
// shared with the paged kernel; here a tile is 64 consecutive slab rows and
// validity comes from the int8 mask.
//
// What bounds it on the H100: the bytes of K/V (every step reads the whole
// slot capacity; an int8 cache halves them, plus 4 bytes of scale per
// (key, head) row). This version stages each tile with 16-byte loads into
// shared memory (widened to f32 there); splitting S across blocks (more
// loads in flight per slot) and keeping K/V narrow in shared memory are
// the later speed-ups.

#include "common.cuh"

namespace {

template <typename T, typename TK, int H>
__global__ void __launch_bounds__(rdb::DecodeScan<T, TK, H>::THREADS)
decode_kernel(const T* __restrict__ q, const TK* __restrict__ k,
              const TK* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int8_t* __restrict__ mask, T* __restrict__ out, int Tq,
              int S, int N, int K, float scale) {
  using Scan = rdb::DecodeScan<T, TK, H>;
  extern __shared__ float smem[];
  const int G = N / K;
  Scan scan(smem, Tq * G, G);
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  scan.begin(q, b, Tq, N, kvh);

  const size_t kv_rs = static_cast<size_t>(K) * H;
  const TK* kb = k + static_cast<size_t>(b) * S * kv_rs + static_cast<size_t>(kvh) * H;
  const TK* vb = v + static_cast<size_t>(b) * S * kv_rs + static_cast<size_t>(kvh) * H;
  // Scales of key pos: (b * S + pos) * K + kvh (null without int8 codes).
  const size_t sc0 = static_cast<size_t>(b) * S * K + kvh;
  for (int s0 = 0; s0 < S; s0 += Scan::BS) {
    // Window row r = t * G + g reads mask row t at this tile's keys.
    const int8_t* mt =
        mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Tq * S + s0;
    const size_t sc = sc0 + static_cast<size_t>(s0) * K;
    scan.tile(kb + s0 * kv_rs, vb + s0 * kv_rs, kv_rs,
              k_scale == nullptr ? nullptr : k_scale + sc,
              v_scale == nullptr ? nullptr : v_scale + sc, K,
              min(Scan::BS, S - s0),
              [=](int r, int j) {
                return mt == nullptr || mt[static_cast<size_t>(r / G) * S + j] != 0;
              },
              scale);
  }
  scan.end(out, b, Tq, N, kvh);
}

template <typename T, typename TK, int H>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int8_t* mask, void* out, int B, int Tq, int S, int N,
                   int K, float scale, cudaStream_t stream) {
  using Scan = rdb::DecodeScan<T, TK, H>;
  if (Scan::QUANT && (k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = Scan::smem_bytes(Tq * (N / K));
  auto kern = decode_kernel<T, TK, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(K, B);
  kern<<<grid, Scan::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), k_scale, v_scale, mask, static_cast<T*>(out),
      Tq, S, N, K, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_h(const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int8_t* m,
                     void* out, int B, int Tq, int S, int N, int K, int H,
                     float scale, int kv_int8, cudaStream_t st) {
  if (kv_int8 && H == 64)
    return launch<T, int8_t, 64>(q, k, v, ks, vs, m, out, B, Tq, S, N, K, scale, st);
  if (kv_int8 && H == 128)
    return launch<T, int8_t, 128>(q, k, v, ks, vs, m, out, B, Tq, S, N, K, scale, st);
  if (!kv_int8 && H == 64)
    return launch<T, T, 64>(q, k, v, nullptr, nullptr, m, out, B, Tq, S, N, K, scale, st);
  if (!kv_int8 && H == 128)
    return launch<T, T, 128>(q, k, v, nullptr, nullptr, m, out, B, Tq, S, N, K, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. kv_int8: 0 = k/v are
// q's type, 1 = int8 codes with f32 scales (both scale pointers non-null).
// Returns a cudaError_t (0 = launched).
extern "C" int rdb_decode_attention(const void* q, const void* k, const void* v,
                                    const void* k_scale, const void* v_scale,
                                    const void* mask, void* out, int B, int Tq,
                                    int S, int N, int K, int H, float scale,
                                    int dtype, int kv_int8, void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int8_t* m = static_cast<const int8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_h<float>(q, k, v, ks, vs, m, out, B, Tq, S, N, K, H, scale,
                           kv_int8, st);
  if (dtype == 1)
    return launch_h<__nv_bfloat16>(q, k, v, ks, vs, m, out, B, Tq, S, N, K, H,
                                   scale, kv_int8, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
