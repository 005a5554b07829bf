// Flash attention backward for Hopper (sm_90a): the gradient of kernel 1's
// masked / causal body (flash_attention.cu, body A), port-own.
//
// The JAX package has no backward kernel: its gradient comes from XLA's
// autodiff of the attention jax.value_and_grad traces. Training on the card
// keeps kernel 1 on its forward (which then also writes the per-row
// log-sum-exp, LSE) and runs this file on the way back, behind
// ops/flash_attention.py::FlashAttentionFn. The math is FlashAttention-2's
// backward, with P recomputed from Q, K and the saved LSE:
//
//   P  = exp(S * scale - LSE) on attended keys, 0 elsewhere (S = Q K^T)
//   D  = rowsum(dO o O)                          (preprocess kernel)
//   dV = P^T dO          dP = dO V^T
//   dS = P o (dP - D)    dQ = scale dS K     dK = scale dS^T Q
//
// Attended is the forward's rule exactly: key <= query + Tk - Tq when
// causal, and the int8 keep-mask [B, Tq, Tk] (1 = attend). A row with no
// attended key has P = 0 everywhere, so its dQ, and its share of dK and dV,
// are 0: what autograd of flash_attention_plain gives.
//
// Layouts (contiguous; the wrapper copies anything else): q, o, dO, dQ
// [B, Tq, N, H]; k, v, dK, dV [B, Tk, K, H]; LSE and D [B, N, Tq] f32. H is
// a multiple of 8 up to 128, padded to HP = 64 or 128 with zero columns in
// shared memory. Everything is accumulated in f32 by FMA (bf16 and f32
// inputs alike); gradients are written in the input type.
//
// Three kernels, one stream:
//   1. preprocess: D, one warp a (batch, row, head).
//   2. dK / dV: one block per (64-key tile, kv head, batch row). It walks
//      the query tiles of EVERY query head of its kv head's group (GQA's
//      N / K heads), so the group's sum happens in the block's registers,
//      with no atomics and no second pass. Under causal it starts at the
//      first query tile that can see the key tile.
//   3. dQ: one block per (32-row query tile, query head, batch row),
//      walking the key tiles up to the causal limit.
// Both recompute S and dP; that doubles QK^T and dO V^T over a fused
// kernel and keeps each simple. Tensor cores (mma / wgmma) are later work.

#include "common.cuh"

namespace {

constexpr int BQ = 32;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NTH = 256;  // threads a block
constexpr int PS = BK + 1;  // padded row of the P / dS tiles

struct Shape {
  int B, Tq, Tk, N, K, h;
  float scale;
  int causal;
};

// Rows [t0, t0 + rows) of head hd of a [B, T, heads, h] tensor into a
// [rows][HP + 1] f32 tile; rows past T and columns past h are zero.
template <typename T, int HP>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int b, int T_,
                                          int heads, int hd, int h, int t0, int rows) {
  constexpr int LD = HP + 1;
  for (int e = threadIdx.x; e < rows * HP; e += NTH) {
    const int r = e / HP, c = e % HP;
    float x = 0.f;
    if (t0 + r < T_ && c < h)
      x = rdb::to_f<T>(src[((static_cast<size_t>(b) * T_ + t0 + r) * heads + hd) * h + c]);
    dst[r * LD + c] = x;
  }
}

__device__ __forceinline__ bool attended(const int8_t* __restrict__ mask, const Shape& s, int b,
                                         int i, int j) {
  if (i >= s.Tq || j >= s.Tk) return false;
  if (s.causal && j > i + (s.Tk - s.Tq)) return false;
  return mask == nullptr || mask[(static_cast<size_t>(b) * s.Tq + i) * s.Tk + j] != 0;
}

// D[b, n, i] = sum_c dO[b, i, n, c] * O[b, i, n, c].
template <typename T>
__global__ void __launch_bounds__(NTH)
bwd_pre_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ D,
               Shape s) {
  const long long row = (static_cast<long long>(blockIdx.x) * NTH + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= static_cast<long long>(s.B) * s.Tq * s.N) return;
  const T* op = o + row * s.h;
  const T* dp = dout + row * s.h;
  float acc = 0.f;
  for (int c = lane; c < s.h; c += 32) acc += rdb::to_f<T>(op[c]) * rdb::to_f<T>(dp[c]);
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int n = static_cast<int>(row % s.N);
    const long long bi = row / s.N;
    const int i = static_cast<int>(bi % s.Tq);
    const int b = static_cast<int>(bi / s.Tq);
    D[(static_cast<size_t>(b) * s.N + n) * s.Tq + i] = acc;
  }
}

// P and dS of one (query tile, key tile) pair into ps / dss. Thread t
// takes row t / 8 and keys t % 8 + 8 u.
template <int HP>
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos, const float* ks,
                                         const float* vs, const float* ls, const float* ds_,
                                         float* ps, float* dss, const int8_t* mask,
                                         const Shape& s, int b, int q0, int k0) {
  constexpr int LD = HP + 1;
  const int i = threadIdx.x / 8;
  const int j0 = threadIdx.x % 8;
  float sc[8], dp[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) sc[u] = dp[u] = 0.f;
#pragma unroll 4
  for (int c = 0; c < HP; ++c) {
    const float qc = qs[i * LD + c];
    const float dc = dos[i * LD + c];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      sc[u] += qc * ks[(j0 + 8 * u) * LD + c];
      dp[u] += dc * vs[(j0 + 8 * u) * LD + c];
    }
  }
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int j = j0 + 8 * u;
    const float p = attended(mask, s, b, q0 + i, k0 + j) ? expf(sc[u] * s.scale - ls[i]) : 0.f;
    ps[i * PS + j] = p;
    dss[i * PS + j] = p * (dp[u] - ds_[i]);
  }
}

template <typename T, int HP>
struct BwdSmem {
  static constexpr int LD = HP + 1;
  static constexpr size_t bytes =
      sizeof(float) * (2 * BK * LD + 2 * BQ * LD + 2 * BQ * PS + 2 * BQ);
};

// dK, dV of keys [k0, k0 + 64) of kv head blockIdx.y, batch row blockIdx.z.
// Thread t accumulates key row t / 4, columns t % 4 + 4 u.
template <typename T, int HP>
__global__ void __launch_bounds__(NTH)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ D, const int8_t* __restrict__ mask,
                T* __restrict__ dk, T* __restrict__ dv, Shape s) {
  constexpr int LD = HP + 1;
  constexpr int CU = HP / 4;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;
  float* dos = qs + BQ * LD;
  float* ps = dos + BQ * LD;
  float* dss = ps + BQ * PS;
  float* ls = dss + BQ * PS;
  float* ds_ = ls + BQ;

  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = s.N / s.K;
  const int tid = threadIdx.x;
  const int jr = tid / 4;
  const int c0 = tid % 4;

  load_tile<T, HP>(ks, k, b, s.Tk, s.K, kvh, s.h, k0, BK);
  load_tile<T, HP>(vs, v, b, s.Tk, s.K, kvh, s.h, k0, BK);

  float dk_acc[CU], dv_acc[CU];
#pragma unroll
  for (int u = 0; u < CU; ++u) dk_acc[u] = dv_acc[u] = 0.f;

  // The first query row that can attend key k0 under the causal rule.
  int q_start = 0;
  if (s.causal) q_start = max(0, k0 - (s.Tk - s.Tq)) / BQ * BQ;

  for (int g = 0; g < G; ++g) {
    const int n = kvh * G + g;
    for (int q0 = q_start; q0 < s.Tq; q0 += BQ) {
      __syncthreads();  // the previous tile's ps / dss / qs / dos are consumed
      load_tile<T, HP>(qs, q, b, s.Tq, s.N, n, s.h, q0, BQ);
      load_tile<T, HP>(dos, dout, b, s.Tq, s.N, n, s.h, q0, BQ);
      for (int r = tid; r < BQ; r += NTH) {
        const bool in = q0 + r < s.Tq;
        const size_t at = (static_cast<size_t>(b) * s.N + n) * s.Tq + q0 + r;
        ls[r] = in ? lse[at] : 0.f;
        ds_[r] = in ? D[at] : 0.f;
      }
      __syncthreads();
      p_and_ds<HP>(qs, dos, ks, vs, ls, ds_, ps, dss, mask, s, b, q0, k0);
      __syncthreads();
      for (int i = 0; i < BQ; ++i) {
        const float p = ps[i * PS + jr];
        const float d = dss[i * PS + jr];
#pragma unroll
        for (int u = 0; u < CU; ++u) {
          const int c = c0 + 4 * u;
          dv_acc[u] += p * dos[i * LD + c];
          dk_acc[u] += d * qs[i * LD + c];
        }
      }
    }
  }
  const int key = k0 + jr;
  if (key < s.Tk) {
    const size_t base = ((static_cast<size_t>(b) * s.Tk + key) * s.K + kvh) * s.h;
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int c = c0 + 4 * u;
      if (c < s.h) {
        dk[base + c] = rdb::from_f<T>(dk_acc[u] * s.scale);
        dv[base + c] = rdb::from_f<T>(dv_acc[u]);
      }
    }
  }
}

// dQ of rows [q0, q0 + 32) of query head blockIdx.y, batch row blockIdx.z.
// Thread t accumulates row t / 8, columns t % 8 + 8 u.
template <typename T, int HP>
__global__ void __launch_bounds__(NTH)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ D, const int8_t* __restrict__ mask,
              T* __restrict__ dq, Shape s) {
  constexpr int LD = HP + 1;
  constexpr int CU = HP / 8;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * LD;
  float* qs = vs + BK * LD;
  float* dos = qs + BQ * LD;
  float* ps = dos + BQ * LD;
  float* dss = ps + BQ * PS;
  float* ls = dss + BQ * PS;
  float* ds_ = ls + BQ;

  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (s.N / s.K);
  const int tid = threadIdx.x;
  const int ir = tid / 8;
  const int c0 = tid % 8;

  load_tile<T, HP>(qs, q, b, s.Tq, s.N, n, s.h, q0, BQ);
  load_tile<T, HP>(dos, dout, b, s.Tq, s.N, n, s.h, q0, BQ);
  for (int r = tid; r < BQ; r += NTH) {
    const bool in = q0 + r < s.Tq;
    const size_t at = (static_cast<size_t>(b) * s.N + n) * s.Tq + q0 + r;
    ls[r] = in ? lse[at] : 0.f;
    ds_[r] = in ? D[at] : 0.f;
  }
  float dq_acc[CU];
#pragma unroll
  for (int u = 0; u < CU; ++u) dq_acc[u] = 0.f;

  // Keys past the tile's last row's causal limit are never attended.
  int k_end = s.Tk;
  if (s.causal) k_end = max(0, min(s.Tk, q0 + BQ + (s.Tk - s.Tq)));
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's ks / vs / dss are consumed
    load_tile<T, HP>(ks, k, b, s.Tk, s.K, kvh, s.h, k0, BK);
    load_tile<T, HP>(vs, v, b, s.Tk, s.K, kvh, s.h, k0, BK);
    __syncthreads();
    p_and_ds<HP>(qs, dos, ks, vs, ls, ds_, ps, dss, mask, s, b, q0, k0);
    __syncthreads();
    for (int j = 0; j < BK; ++j) {
      const float d = dss[ir * PS + j];
#pragma unroll
      for (int u = 0; u < CU; ++u) dq_acc[u] += d * ks[j * LD + c0 + 8 * u];
    }
  }
  if (q0 + ir < s.Tq) {
    const size_t base = ((static_cast<size_t>(b) * s.Tq + q0 + ir) * s.N + n) * s.h;
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int c = c0 + 8 * u;
      if (c < s.h) dq[base + c] = rdb::from_f<T>(dq_acc[u] * s.scale);
    }
  }
}

template <typename T, int HP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, const int8_t* mask, void* dq,
                   void* dk, void* dv, float* D, const Shape& s, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const long long rows = static_cast<long long>(s.B) * s.Tq * s.N;
  const unsigned pre_blocks = static_cast<unsigned>((rows * 32 + NTH - 1) / NTH);
  bwd_pre_kernel<T><<<pre_blocks, NTH, 0, stream>>>(static_cast<const T*>(o), dop, D, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t smem = BwdSmem<T, HP>::bytes;
  auto kv_kern = bwd_dkdv_kernel<T, HP>;
  err = rdb::raise_smem_limit(kv_kern, smem);
  if (err != cudaSuccess) return err;
  kv_kern<<<dim3((s.Tk + BK - 1) / BK, s.K, s.B), NTH, smem, stream>>>(
      qp, kp, vp, dop, lse, D, mask, static_cast<T*>(dk), static_cast<T*>(dv), s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto q_kern = bwd_dq_kernel<T, HP>;
  err = rdb::raise_smem_limit(q_kern, smem);
  if (err != cudaSuccess) return err;
  q_kern<<<dim3((s.Tq + BQ - 1) / BQ, s.N, s.B), NTH, smem, stream>>>(
      qp, kp, vp, dop, lse, D, mask, static_cast<T*>(dq), s);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Every tensor contiguous in the layouts
// above; lse from kernel 1's forward (rdb_flash_attention's lse pointer);
// D a [B, N, Tq] f32 scratch. Returns a cudaError_t (0 = launched).
extern "C" int rdb_flash_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       const void* mask, void* dq, void* dk, void* dv,
                                       void* D, int B, int Tq, int Tk, int N, int K, int H,
                                       float scale, int causal, int dtype, void* stream) {
  if (H <= 0 || H > 128 || H % 8 != 0 || K <= 0 || N % K != 0 || B <= 0 || Tq <= 0 || Tk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape s{B, Tq, Tk, N, K, H, scale, causal};
  const int8_t* m = static_cast<const int8_t*>(mask);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = H <= 64;
  if (dtype == 0)
    return narrow ? launch<float, 64>(q, k, v, o, dout, l, m, dq, dk, dv, d, s, st)
                  : launch<float, 128>(q, k, v, o, dout, l, m, dq, dk, dv, d, s, st);
  if (dtype == 1)
    return narrow ? launch<__nv_bfloat16, 64>(q, k, v, o, dout, l, m, dq, dk, dv, d, s, st)
                  : launch<__nv_bfloat16, 128>(q, k, v, o, dout, l, m, dq, dk, dv, d, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
