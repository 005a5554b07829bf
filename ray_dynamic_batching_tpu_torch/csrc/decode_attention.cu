// Slab decode attention for Hopper (sm_90a), plain FMA version.
//
// Replaces ray_dynamic_batching_tpu/ops/decode_attention.py::_decode_attention
// (Pallas bodies _decode_kernel + _scan_tile): a fused KV scan for a small
// query window (1 <= Tq <= 8) with an online softmax in f32 and the int8
// window mask [B, Tq, S]. The int8-code branch (k_scale/v_scale) is not
// here: the port has no int8 KV cache yet and the wrapper refuses scales.
//
// Layouts: q/out [B, Tq, N, H]; k/v [B, S, K, H]; all contiguous.
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
// slot capacity). This version stages each tile with 16-byte loads into
// shared memory; splitting S across blocks (more loads in flight per slot)
// and keeping K/V in bf16 in shared memory are the later speed-ups.

#include "common.cuh"

namespace {

template <typename T, int H>
__global__ void __launch_bounds__(rdb::DecodeScan<T, H>::THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int8_t* __restrict__ mask,
              T* __restrict__ out, int Tq, int S, int N, int K, float scale) {
  using Scan = rdb::DecodeScan<T, H>;
  extern __shared__ float smem[];
  const int G = N / K;
  Scan scan(smem, Tq * G, G);
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  scan.begin(q, b, Tq, N, kvh);

  const size_t kv_rs = static_cast<size_t>(K) * H;
  const T* kb = k + static_cast<size_t>(b) * S * kv_rs + static_cast<size_t>(kvh) * H;
  const T* vb = v + static_cast<size_t>(b) * S * kv_rs + static_cast<size_t>(kvh) * H;
  for (int s0 = 0; s0 < S; s0 += Scan::BS) {
    // Window row r = t * G + g reads mask row t at this tile's keys.
    const int8_t* mt =
        mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * Tq * S + s0;
    scan.tile(kb + s0 * kv_rs, vb + s0 * kv_rs, kv_rs, min(Scan::BS, S - s0),
              [=](int r, int j) {
                return mt == nullptr || mt[static_cast<size_t>(r / G) * S + j] != 0;
              },
              scale);
  }
  scan.end(out, b, Tq, N, kvh);
}

template <typename T, int H>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int8_t* mask, void* out, int B, int Tq, int S, int N,
                   int K, float scale, cudaStream_t stream) {
  using Scan = rdb::DecodeScan<T, H>;
  const size_t smem = Scan::smem_bytes(Tq * (N / K));
  auto kern = decode_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(K, B);
  kern<<<grid, Scan::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), Tq, S, N, K, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int rdb_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int Tq,
                                    int S, int N, int K, int H, float scale,
                                    int dtype, void* stream) {
  const int8_t* m = static_cast<const int8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && H == 64)
    return launch<float, 64>(q, k, v, m, out, B, Tq, S, N, K, scale, st);
  if (dtype == 0 && H == 128)
    return launch<float, 128>(q, k, v, m, out, B, Tq, S, N, K, scale, st);
  if (dtype == 1 && H == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, m, out, B, Tq, S, N, K, scale, st);
  if (dtype == 1 && H == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, m, out, B, Tq, S, N, K, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
