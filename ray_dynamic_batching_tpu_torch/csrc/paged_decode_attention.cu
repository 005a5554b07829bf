// Paged decode attention for Hopper (sm_90a), plain FMA version.
//
// Replaces ray_dynamic_batching_tpu/ops/decode_attention.py::
// _paged_decode_attention (Pallas body: _scan_tile over page-table tiles):
// a fused KV scan for a small query window (1 <= Tq <= 8) over a page pool
// shared by all slots, each slot's logical KV run named by its row of the
// page table. Pools hold q's type, or int8 codes with f32 scale pools
// k_scale/v_scale [P, ps, K] paged by the same table (the reference's
// int8-pool branch, decode_attention.py:354-360 + _scan_tile).
//
// Layouts: q/out [B, Tq, N, H]; k/v pools [P, ps, K, H] (the caller passes
// the P real pages; the engine's sink page past them is never named);
// scales [P, ps, K] (offset (page * ps + off) * K + kvh); table [B, NP]
// int32, sentinel P = unallocated; lengths [B] int32. All contiguous.
//
// Grid (K, B): one block per (slot, KV head), the R = Tq * G window rows
// of that KV head riding one read of each K/V tile, exactly as the slab
// kernel (csrc/decode_attention.cu) — the per-tile scan IS the slab
// kernel's (rdb::DecodeScan, common.cuh), as both TPU kernels share
// _scan_tile. What differs is addressing and validity:
//
// - logical tile t covers positions [64 t, 64 t + 64) of page p = 64 t / ps,
//   read from physical page min(table[b, p], P - 1) (sentinel and stray
//   entries clamp to a real page; the length bound masks them), its
//   scales from the same page;
// - window row r = t' * G + g attends position pos iff pos <= lengths[b] + t',
//   computed here from the lengths (the staircase rule) — no mask stream.
//
// Tiles wholly past lengths[b] + Tq - 1 are not read: tile 0 always holds
// an attended key (position 0), so the running max is finite from the
// first tile on, and a fully masked tile would add exp(NEG_INF - m) = 0 to
// l and acc and rescale them by exp(0) = 1 — the result is the full scan's.
//
// What bounds it on the H100: the bytes of the K/V positions each slot
// attends (the skip makes that the run's lengths, not the table width;
// int8 pools halve them, plus 4 bytes of scale per (key, head) row).
// Tiles are staged with 16-byte loads from wherever the page lies; split-S
// across blocks, TMA staging and tensor-core products are later work.

#include "common.cuh"

namespace {

template <typename T, typename TK, int H>
__global__ void __launch_bounds__(rdb::DecodeScan<T, TK, H>::THREADS)
paged_decode_kernel(const T* __restrict__ q, const TK* __restrict__ k,
                    const TK* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int Tq, int N, int K, int P, int ps, int NP, float scale) {
  using Scan = rdb::DecodeScan<T, TK, H>;
  extern __shared__ float smem[];
  const int G = N / K;
  Scan scan(smem, Tq * G, G);
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  scan.begin(q, b, Tq, N, kvh);

  const int len = lengths[b];
  const int* row = table + static_cast<size_t>(b) * NP;
  const size_t kv_rs = static_cast<size_t>(K) * H;
  const int n_tiles = min(NP * (ps / Scan::BS), (len + Tq - 1) / Scan::BS + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int pos0 = t * Scan::BS;
    const int p = pos0 / ps;
    const int page = min(row[p], P - 1);
    const size_t cell = static_cast<size_t>(page) * ps + (pos0 - p * ps);
    const size_t off = cell * kv_rs + static_cast<size_t>(kvh) * H;
    const size_t sc = cell * K + kvh;
    scan.tile(k + off, v + off, kv_rs,
              k_scale == nullptr ? nullptr : k_scale + sc,
              v_scale == nullptr ? nullptr : v_scale + sc, K, Scan::BS,
              [=](int r, int j) { return pos0 + j <= len + r / G; }, scale);
  }
  scan.end(out, b, Tq, N, kvh);
}

template <typename T, typename TK, int H>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int* table, const int* lengths, void* out, int B,
                   int Tq, int N, int K, int P, int ps, int NP, float scale,
                   cudaStream_t stream) {
  using Scan = rdb::DecodeScan<T, TK, H>;
  if (ps % Scan::BS != 0) return cudaErrorInvalidValue;
  if (Scan::QUANT && (k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = Scan::smem_bytes(Tq * (N / K));
  auto kern = paged_decode_kernel<T, TK, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(K, B);
  kern<<<grid, Scan::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), k_scale, v_scale, table, lengths,
      static_cast<T*>(out), Tq, N, K, P, ps, NP, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_h(const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int* tb,
                     const int* ln, void* out, int B, int Tq, int N, int K,
                     int H, int P, int ps, int NP, float scale, int kv_int8,
                     cudaStream_t st) {
  if (kv_int8 && H == 64)
    return launch<T, int8_t, 64>(q, k, v, ks, vs, tb, ln, out, B, Tq, N, K, P, ps, NP, scale, st);
  if (kv_int8 && H == 128)
    return launch<T, int8_t, 128>(q, k, v, ks, vs, tb, ln, out, B, Tq, N, K, P, ps, NP, scale, st);
  if (!kv_int8 && H == 64)
    return launch<T, T, 64>(q, k, v, nullptr, nullptr, tb, ln, out, B, Tq, N, K, P, ps, NP, scale, st);
  if (!kv_int8 && H == 128)
    return launch<T, T, 128>(q, k, v, nullptr, nullptr, tb, ln, out, B, Tq, N, K, P, ps, NP, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. kv_int8: 0 = pools are
// q's type, 1 = int8 codes with f32 scale pools (both non-null). Returns a
// cudaError_t (0 = launched).
extern "C" int rdb_paged_decode_attention(const void* q, const void* k,
                                          const void* v, const void* k_scale,
                                          const void* v_scale,
                                          const void* table,
                                          const void* lengths, void* out, int B,
                                          int Tq, int N, int K, int H, int P,
                                          int ps, int NP, float scale,
                                          int dtype, int kv_int8,
                                          void* stream) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_h<float>(q, k, v, ks, vs, tb, ln, out, B, Tq, N, K, H, P, ps,
                           NP, scale, kv_int8, st);
  if (dtype == 1)
    return launch_h<__nv_bfloat16>(q, k, v, ks, vs, tb, ln, out, B, Tq, N, K, H,
                                   P, ps, NP, scale, kv_int8, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
