// Flash prefill attention for Hopper (sm_90a), plain FMA version.
//
// Replaces ray_dynamic_batching_tpu/ops/flash_attention.py::_flash_attention
// (Pallas body _attn_kernel): FlashAttention-2 forward with a tiled online
// softmax in f32, the int8 keep-mask [B, Tq, Tk] and the causal iota rule
// (key <= query + Tk - Tq, with the early exit past the tile's last
// diagonal), GQA by reading KV head n / (N / K), and 0 (not NaN) for a row
// with no attended key.
//
// Layouts: q/out [B, Tq, N, H]; k/v [B, Tk, K, H]; all contiguous.
// Grid (ceil(Tq / BQ), N, B); one block owns one query tile of one head and
// loops over KV tiles staged in shared memory — the loop carries (m, l, acc)
// in registers in place of the TPU's in-VMEM fori_loop.
//
// Thread layout: 256 threads, 4 per query row. A row's 4 threads hold the
// row's head dims interleaved (dim = part + 4 i) in registers, and score
// the tile's keys interleaved the same way, so both shared-memory reads hit
// distinct banks; row max and row sum reduce over the 4 adjacent lanes with
// two shuffles. Shared rows are padded to H + 1 floats against bank
// conflicts.
//
// What bounds it on the H100: at the serving shapes (64-token prompts over
// a 512-position row cache) the K/V bytes; at long prompts the FLOPs of the
// two products, which this version issues as FMAs on the CUDA cores, not
// the tensor cores (wgmma + TMA staging is the later speed-up).

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;

template <typename T, int H>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int8_t* __restrict__ mask,
                 T* __restrict__ out, int Tq, int Tk, int N, int K,
                 float scale, int causal) {
  constexpr int HP = H + 1;       // padded smem row (odd: no bank conflicts)
  constexpr int DPT = H / TPR;    // head dims per thread
  constexpr int KPT = BK / TPR;   // keys per thread per tile
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PSTRIDE = BK + 1;

  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][HP]
  float* ks = qs + BQ * HP;       // [BK][HP]
  float* vs = ks + BK * HP;       // [BK][H]
  float* ps = vs + BK * H;        // [BQ][BK + 1] probabilities of this tile

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (N / K);
  const int qi = q0 + row;
  const bool row_live = qi < Tq;

  const size_t q_rs = static_cast<size_t>(N) * H;    // q/out row stride
  const size_t kv_rs = static_cast<size_t>(K) * H;   // k/v row stride
  const T* qb = q + static_cast<size_t>(b) * Tq * q_rs + static_cast<size_t>(n) * H;
  const T* kb = k + static_cast<size_t>(b) * Tk * kv_rs + static_cast<size_t>(kvh) * H;
  const T* vb = v + static_cast<size_t>(b) * Tk * kv_rs + static_cast<size_t>(kvh) * H;
  const int8_t* mrow =
      (mask != nullptr && row_live)
          ? mask + (static_cast<size_t>(b) * Tq + qi) * Tk
          : nullptr;

  // Stage the query tile; rows past Tq are zero (never written out).
  for (int e = tid * VEC; e < BQ * H; e += THREADS * VEC) {
    const int r = e / H, d = e % H;
    float tmp[VEC];
    if (q0 + r < Tq) {
      rdb::load_vec<T>(qb + static_cast<size_t>(q0 + r) * q_rs + d, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) qs[r * HP + d + i] = tmp[i];
  }

  float m_i = rdb::NEG_INF;
  float l_i = 0.f;
  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  int kv_end = Tk;
  if (causal) {
    // KV tiles wholly past this query tile's last diagonal contribute
    // nothing: stop early (the reference's kb_hi).
    const int last_key = q0 + BQ - 1 + (Tk - Tq);
    kv_end = min(Tk, last_key + 1);
  }
  const int offset = Tk - Tq;

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // previous tile fully consumed; q tile staged
    for (int e = tid * VEC; e < BK * H; e += THREADS * VEC) {
      const int r = e / H, d = e % H;
      float kt[VEC], vt[VEC];
      if (k0 + r < Tk) {
        rdb::load_vec<T>(kb + static_cast<size_t>(k0 + r) * kv_rs + d, kt);
        rdb::load_vec<T>(vb + static_cast<size_t>(k0 + r) * kv_rs + d, vt);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kt[i] = vt[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        ks[r * HP + d + i] = kt[i];
        vs[r * H + d + i] = vt[i];
      }
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) s[jj] = 0.f;
    for (int d = 0; d < H; ++d) {
      const float qd = qs[row * HP + d];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) s[jj] += qd * ks[(part + TPR * jj) * HP + d];
    }

    float tile_max = rdb::NEG_INF;
    unsigned valid_bits = 0;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int key = k0 + part + TPR * jj;
      bool valid = key < Tk;
      if (causal) valid = valid && key <= qi + offset;
      if (mask != nullptr) valid = valid && mrow != nullptr && mrow[key] != 0;
      s[jj] = valid ? s[jj] * scale : rdb::NEG_INF;
      valid_bits |= (valid ? 1u : 0u) << jj;
      tile_max = fmaxf(tile_max, s[jj]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m_i, tile_max);
    const float corr = expf(m_i - m_new);

    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = ((valid_bits >> jj) & 1u) ? expf(s[jj] - m_new) : 0.f;
      psum += p;
      ps[row * PSTRIDE + part + TPR * jj] = rdb::round_to<T>(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * corr + psum;
    m_i = m_new;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
    __syncwarp();  // the row's 4 lanes (one warp) wrote its probabilities

    for (int j = 0; j < BK; ++j) {
      const float p = ps[row * PSTRIDE + j];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += p * vs[j * H + part + TPR * i];
    }
  }

  if (row_live) {
    const float denom = l_i == 0.f ? 1.f : l_i;  // no attended key -> 0
    T* ob = out + (static_cast<size_t>(b) * Tq + qi) * q_rs + static_cast<size_t>(n) * H;
#pragma unroll
    for (int i = 0; i < DPT; ++i) ob[part + TPR * i] = rdb::from_f<T>(acc[i] / denom);
  }
}

template <typename T, int H>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int8_t* mask, void* out, int B, int Tq, int Tk,
                   int N, int K, float scale, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (H + 1) + BK * (H + 1) + BK * H + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, N, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), Tq, Tk, N, K,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int rdb_flash_attention(const void* q, const void* k, const void* v,
                                   const void* mask, void* out, int B, int Tq,
                                   int Tk, int N, int K, int H, float scale,
                                   int causal, int dtype, void* stream) {
  const int8_t* m = static_cast<const int8_t*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && H == 64)
    return launch<float, 64>(q, k, v, m, out, B, Tq, Tk, N, K, scale, causal, st);
  if (dtype == 0 && H == 128)
    return launch<float, 128>(q, k, v, m, out, B, Tq, Tk, N, K, scale, causal, st);
  if (dtype == 1 && H == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, m, out, B, Tq, Tk, N, K, scale, causal, st);
  if (dtype == 1 && H == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, m, out, B, Tq, Tk, N, K, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
