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
// are 0: what autograd of flash_attention_plain gives. GQA's query heads
// are summed into their kv head inside one block (no atomics), and every
// gradient element is written by exactly one block, so the backward is
// deterministic: two calls on the same inputs give the same bits.
//
// Layouts (contiguous; the wrapper copies anything else): q, o, dO, dQ
// [B, Tq, N, H]; k, v, dK, dV [B, Tk, K, H]; LSE and D [B, N, Tq] f32. H is
// a multiple of 8 up to 128, padded to HP = 64 or 128 with zero columns in
// shared memory (ViT-G/14's 104 and head_dim 16 ride the padded tiles).
//
// What bounds it. The function's work is 10 H FLOPs an attended (query,
// key) pair a query head (QK^T, dO V^T, dV, dQ, dK) over ~85 MB moved once
// (q, k, v, out, dO, the mask and the LSE read, dq, dk, dv written): at
// llama3_8b's training shape (q [4,512,32,128], k/v [4,512,8,128], causal
// + key mask) 21.2 GFLOP and 85.2 MB, 0.0214 ms at the bf16 tensor peak
// and 0.0254 ms at HBM's rate. The first version ran every
// product on the FMA pipes from padded f32 shared-memory rows, staged one
// scalar load at a time: 4.21-4.25 ms there (flash_bwd_variants.py's
// ``fma``), bound by shared-memory bandwidth.
//
// bf16, the training route: two launches on one stream.
//   1. preprocess: D, two rows a warp, 16-byte loads.
//   2. One kernel with two roles, blocks of 4 warps, each role's heaviest
//      blocks first (blockIdx order): first the dK / dV blocks, then the
//      dQ blocks. The dK / dV role's blocks are few and, under causal,
//      unequal (key tile 0 walks every query tile, the last tile one): in
//      one launch the dQ blocks take the SMs its light blocks leave, where
//      two launches would wait for its heaviest block (0.3467-0.3762 ms
//      against 0.2614-0.2712 at the training shape, flash_bwd_variants.py's
//      ``two_launches``).
//   dK / dV role: one block per (64-key tile, kv head, batch row). K and V
//      of the tile stay in shared memory; warp w owns keys 16 w .. 16 w + 15
//      across every column of dK and dV. The block walks (query head of
//      the group, live query tile) in order, BQ rows a step (32 at HP 128,
//      64 at HP 64), each step's Q, dO, LSE, D and mask bytes landing by
//      cp.async in a double buffer while the last one is computed. Per
//      step, all on mma.sync.m16n8k16 (bf16 in, f32 accumulate):
//      S^T = K Q^T and dP^T = V dO^T (K and V as A fragments by ldmatrix,
//      re-read each step: the registers hold dK and dV; Q and dO as B),
//      then P^T and dS^T in registers, rounded to bf16 straight from the
//      accumulators into the A fragments of dV += P^T dO and dK += dS^T Q
//      (dO and Q by ldmatrix.trans). GQA's query heads are summed in the
//      block's registers.
//   dQ role: one block per (64-row query tile, query head, batch row), the
//      last query tiles first. Warp w holds the Q and dO fragments of its
//      16 rows; the block walks the live key tiles through a cp.async
//      double buffer, recomputing S and dP (each tile as two 32-key halves
//      in turn) and accumulating dQ += dS K, K read by ldmatrix.trans.
//   Tiles stay bf16 in shared memory, 16-byte chunks XOR-swizzled against
//   ldmatrix bank conflicts (rdb::swz, shared with kernel 1). Before its
//   walk each block reads the mask bytes it could need and lists the tiles
//   some pair of which is attended under the mask and the causal rule;
//   only those are walked. Exact: P = dS = 0 on the others. At the
//   training shape that skips the causal half and the padded last quarter
//   of the masked batch row. Outputs are staged as bf16 rows in shared
//   memory and written in 16-byte stores.
//   Rounding: P and dS become bf16 only as tensor-core operands; D, the
//   LSE, the exponent (ex2 of one FFMA in log2 units) and every
//   accumulator stay f32; gradients are written in bf16.
//   Why a dQ role and not one pass with f32 atomics into a dQ scratch: the
//   atomics' order changes from run to run (the gradients would too), and
//   at the training shape the scratch adds a 33.5 MB f32 round trip; the
//   price is S and dP computed twice (14 H FLOPs a pair, not 10).
//   Why mma.sync and not wgmma: P^T, dS^T and dS are A operands from
//   registers, and register-sourced wgmma was serialised by ptxas in the
//   int8 GEMM (warning C7513, PERF.md); mma.sync at these masks is body
//   A's, proven on this card. wgmma is a later step.
//   Budgets. Shared memory: the larger role's, the dQ role's at HP 128,
//   107 KB (Q and dO 16 KB each, double-buffered K and V 64 KB, the mask
//   tiles 10 KB); the dK / dV role's is 71 KB (K, V 16 KB each, Q and dO
//   double buffers 32 KB, mask, LSE, D, the tile list). Registers: a dK /
//   dV thread holds 128 f32 accumulators (dK, dV of 16 keys x 128
//   columns) and 32 for S^T and dP^T; a dQ thread 64 accumulators, 64
//   registers of Q and dO fragments and 32 for S and dP. ptxas on the
//   card: 255 registers a thread at HP 128 (252 at HP 64), 0 bytes
//   spilled, with each role a __noinline__ function (inlined into one
//   body, 32 bytes spilled at HP 128; the dQ role's halves unrolled, 196).
//   So two blocks, 8 warps, an SM. A layout for three (168 registers:
//   32-key dK / dV blocks whose warps split P^T and dV from dP^T and dK,
//   handing P^T over through shared memory; 32-key dQ tiles with the Q and
//   dO fragments re-read each tile) ran slower on this card: what it saved
//   in latency it lost in fragment re-reads, staging and barriers.
//   Measured (chip_smoke.py phase 22a; H100 80GB HBM3, 700 W): forward +
//   backward 0.4255-0.4260 ms at the training shape against the FMA
//   version's 4.3632-4.3876 in the same call (10.3x), the backward 0.283
//   ms of it (preprocess 0.0117, the two roles 0.2710); SDPA's forward +
//   backward 0.3306-0.3326. What holds it back: the two roles run ~110
//   TFLOP/s (29.7 GFLOP with S and dP counted twice, in 0.271 ms), 11% of
//   the bf16 tensor peak, with two warps a scheduler (255 registers a
//   thread), and the heaviest dK / dV blocks (key tile 0: 64 steps of 32
//   rows) set the launch's time.

// f32, the model-parity route (tolerance 1e-4), keeps the first version's
// FMA kernels below as they were: TF32 tensor cores keep ~3 decimal digits
// and would not meet it, as the forward's f32 body keeps FMA for the same
// reason.
//   1. preprocess: D, one warp a (batch, row, head).
//   2. dK / dV: one block per (64-key tile, kv head, batch row), walking
//      the query tiles of every query head of the group from the first
//      that can see the key tile.
//   3. dQ: one block per (32-row query tile, query head, batch row),
//      walking the key tiles up to the causal limit.
//   Everything in f32 by FMA from padded f32 shared-memory tiles.

#include "common.cuh"

namespace {

// --- f32: FMA (unchanged) ---------------------------------------------------
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

// --- bf16: tensor cores ------------------------------------------------------
using rdb::ex2;
using rdb::ldsm_x4;
using rdb::ldsm_x4_t;
using rdb::mma_bf16;
using rdb::pack_bf16;
using rdb::swz;
using bf16 = __nv_bfloat16;

constexpr int TC_THREADS = 128;  // four warps, 16 keys (dK / dV) or 16 rows (dQ) each
constexpr int TK = 64;           // keys per tile
constexpr int TQ = 64;           // query rows per dQ block
constexpr int MROW = TK + 16;    // mask tile row bytes (padded)
constexpr float LOG2E = 1.4426950408889634f;

// Rows [t0, t0 + rows) of one head of a [B, T, heads, h] bf16 tensor
// (``src`` at [b, 0, head, 0]) into a swizzled [rows][HP] tile by
// cp.async; rows past T and columns past h are zero-filled.
template <int HP>
__device__ __forceinline__ void stage_rows(unsigned char* dst, const bf16* src, int T, int heads,
                                           int h, int t0, int rows) {
  constexpr int NCH = HP / 8;
  const int hc = h / 8;
  for (int e = threadIdx.x; e < rows * NCH; e += TC_THREADS) {
    const int r = e / NCH, c = e % NCH;
    const bool in = t0 + r < T && c < hc;
    rdb::cp_async16(dst + swz<HP>(r, c),
                    in ? src + static_cast<size_t>(t0 + r) * heads * h + c * 8 : src, in);
  }
}

// The mask bytes of query rows [r0, r0 + rows) x keys [k0, k0 + 64) of one
// batch row (``mb``: [Tq][Tk]) into a [rows][MROW] tile; bytes past Tq or
// Tk are 0. ``vec``: 16-byte cp.async chunks (Tk % 16 == 0, mb aligned),
// else byte loads.
__device__ __forceinline__ void stage_mask(int8_t* dst, const int8_t* mb, int Tq, int Tk, int r0,
                                           int rows, int k0, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < rows * (TK / 16); e += TC_THREADS) {
      const int r = e / (TK / 16), c = e % (TK / 16);
      const bool in = r0 + r < Tq && k0 + c * 16 < Tk;
      rdb::cp_async16(dst + r * MROW + c * 16,
                      in ? mb + static_cast<size_t>(r0 + r) * Tk + k0 + c * 16 : mb, in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * TK; e += TC_THREADS) {
      const int r = e / TK, c = e % TK;
      dst[r * MROW + c] =
          (r0 + r < Tq && k0 + c < Tk) ? mb[static_cast<size_t>(r0 + r) * Tk + k0 + c] : 0;
    }
  }
}

// LSE and D of rows [q0, q0 + rows) of one (batch row, query head) (``lse``
// and ``D`` at its row 0) into shared memory by cp.async; past Tq 0.
__device__ __forceinline__ void stage_stats(float* ls, float* ds, const float* lse,
                                            const float* D, int Tq, int q0, int rows) {
  for (int r = threadIdx.x; r < rows; r += TC_THREADS) {
    const bool in = q0 + r < Tq;
    rdb::cp_async4(ls + r, in ? lse + q0 + r : lse, in);
    rdb::cp_async4(ds + r, in ? D + q0 + r : D, in);
  }
}

// live[tile_of(r, c)] = 1 for every attended (query r, key c) among rows
// [r0, r0 + rows) x keys [c0, c0 + cols) of one batch row's mask (``mb``:
// [Tq][Tk]): the byte is set and, under causal, c <= r + offset. ``vec``:
// 16-byte loads, eight in flight a thread (c0 and cols multiples of 16 as
// well); a chunk's 16 keys share one tile.
template <typename TileOf>
__device__ __forceinline__ void mark_live(const int8_t* __restrict__ mb, int Tk, int r0, int rows,
                                          int c0, int cols, int causal, int offset, bool vec,
                                          int* live, TileOf tile_of) {
  if (vec) {
    constexpr int U = 8;
    const int cpr = cols / 16;
    const int total = rows * cpr;
    for (int e0 = threadIdx.x; e0 < total; e0 += U * TC_THREADS) {
      uint4 w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * TC_THREADS;
        w[u] = e < total ? *reinterpret_cast<const uint4*>(
                               mb + static_cast<size_t>(r0 + e / cpr) * Tk + c0 + (e % cpr) * 16)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if ((w[u].x | w[u].y | w[u].z | w[u].w) == 0u) continue;
        const int e = e0 + u * TC_THREADS;
        const int r = r0 + e / cpr, c = c0 + (e % cpr) * 16;
        bool any = !causal;
        if (causal) {
          const int8_t* by = reinterpret_cast<const int8_t*>(&w[u]);
#pragma unroll
          for (int i = 0; i < 16; ++i) any = any || (by[i] != 0 && c + i <= r + offset);
        }
        if (any) live[tile_of(r, c)] = 1;
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += TC_THREADS) {
      const int r = r0 + e / cols, c = c0 + e % cols;
      if (mb[static_cast<size_t>(r) * Tk + c] != 0 && (!causal || c <= r + offset))
        live[tile_of(r, c)] = 1;
    }
  }
}

// Warp 0 lists the set entries of live[0, n) in order and writes their
// count to *count.
__device__ __forceinline__ void compact_live(const int* live, int n, int* list, int* count) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int cnt = 0;
  for (int t0 = 0; t0 < n; t0 += 32) {
    const bool on = t0 + lane < n && live[t0 + lane] != 0;
    const unsigned bal = __ballot_sync(0xffffffffu, on);
    if (on) list[cnt + __popc(bal & ((1u << lane) - 1u))] = t0 + lane;
    cnt += __popc(bal);
  }
  if (lane == 0) *count = cnt;
}

// D[b, n, i] = rowsum(dO o O): two rows a warp, lane c of a half-warp
// reading 16-byte chunk c of its row (h / 8 <= 16 chunks).
__global__ void __launch_bounds__(256)
pre_bf16_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout, float* __restrict__ D,
                Shape s) {
  const long long row = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) / 16;
  const int lane = threadIdx.x % 16;
  const bool in = row < static_cast<long long>(s.B) * s.Tq * s.N;
  float acc = 0.f;
  if (in && lane < s.h / 8) {
    float a[8], d[8];
    rdb::load_vec(o + row * s.h + lane * 8, a);
    rdb::load_vec(dout + row * s.h + lane * 8, d);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc += a[i] * d[i];
  }
#pragma unroll
  for (int off = 8; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && lane == 0) {
    const int n = static_cast<int>(row % s.N);
    const long long bi = row / s.N;
    const int i = static_cast<int>(bi % s.Tq);
    const int b = static_cast<int>(bi / s.Tq);
    D[(static_cast<size_t>(b) * s.N + n) * s.Tq + i] = acc;
  }
}

// The fused kernel's pointers and shape.
struct BwdArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;
  const float* D;
  const int8_t* mask;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  Shape s;
};

// The dK / dV role's plan: BQ query rows a step (32 at HP 128, where a
// thread already holds 128 accumulator floats; 64 at HP 64). 16 at HP 128
// ran slower: the per-step barriers and waits doubled
// (flash_bwd_variants.py's ``dkdv_bq16``).
template <int HP>
struct KvPlan {
  static constexpr int BQ = HP == 128 ? 32 : 64;
  static constexpr int KT = TK * HP * 2;  // bytes of the K or the V tile
  static constexpr int QT = BQ * HP * 2;  // bytes of one Q or dO tile
  static size_t bytes(int ntq) {
    return 2 * static_cast<size_t>(KT) + 4 * static_cast<size_t>(QT) + 2 * BQ * MROW +
           sizeof(float) * 4 * BQ + sizeof(int) * (2 * static_cast<size_t>(ntq) + 1);
  }
};

// The dK / dV role: dK, dV of keys [k0, k0 + 64) of one (kv head, batch
// row); block ``blk`` of the role, key tile blk / (K B) (tile 0 first:
// under causal it walks the most rows). Warp w owns keys 16 w .. 16 w + 15
// across all HP columns of both gradients; the block walks (query head g
// of the group, live query tile) in order, double-buffered.
template <int HP>
__device__ __noinline__ void dkdv_block(unsigned char* kv_smem, int blk, const BwdArgs a) {
  const bf16* __restrict__ q = a.q;
  const bf16* __restrict__ k = a.k;
  const bf16* __restrict__ v = a.v;
  const bf16* __restrict__ dout = a.dout;
  const float* __restrict__ lse = a.lse;
  const float* __restrict__ D = a.D;
  const int8_t* __restrict__ mask = a.mask;
  const Shape s = a.s;
  using P = KvPlan<HP>;
  constexpr int BQ = P::BQ;
  constexpr int NCH = HP / 8;  // 16-byte chunks a row
  constexpr int KS = HP / 16;  // k-steps of S^T and dP^T (over the head dim)
  constexpr int NQ = BQ / 8;   // query n-tiles of S^T; NQ / 2 k-steps of dV, dK
  constexpr int ND = HP / 8;   // dim n-tiles of dV, dK
  unsigned char* ks = kv_smem;              // [64][HP]
  unsigned char* vs = ks + P::KT;           // [64][HP]
  unsigned char* qs = vs + P::KT;           // [2][BQ][HP]
  unsigned char* dos = qs + 2 * P::QT;      // [2][BQ][HP]
  int8_t* msk = reinterpret_cast<int8_t*>(dos + 2 * P::QT);  // [2][BQ][MROW]
  float* ls = reinterpret_cast<float*>(msk + 2 * BQ * MROW);  // [2][BQ]
  float* dd = ls + 2 * BQ;                                    // [2][BQ]
  const int ntq = (s.Tq + BQ - 1) / BQ;
  int* live = reinterpret_cast<int*>(dd + 2 * BQ);
  int* list = live + ntq;
  int* nlive = list + ntq;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w16 = (tid / 32) * 16;  // this warp's first key in the tile
  const int kvh = blk % s.K;
  const int b = blk / s.K % s.B;
  const int k0 = blk / (s.K * s.B) * TK;
  const int G = s.N / s.K;
  const int offset = s.Tk - s.Tq;
  const int hc = s.h / 8;
  const float sl2 = s.scale * LOG2E;
  const int8_t* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * s.Tq * s.Tk;
  const bool vec = mb != nullptr && s.Tk % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;

  stage_rows<HP>(ks, k + (static_cast<size_t>(b) * s.Tk * s.K + kvh) * s.h, s.Tk, s.K, s.h, k0,
                 TK);
  stage_rows<HP>(vs, v + (static_cast<size_t>(b) * s.Tk * s.K + kvh) * s.h, s.Tk, s.K, s.h, k0,
                 TK);
  rdb::cp_async_commit();

  // Live query tiles: some row of the tile attends some key of this one.
  for (int t = tid; t < ntq; t += TC_THREADS) {
    const int last = min(s.Tq, (t + 1) * BQ) - 1;
    live[t] = mb == nullptr && (!s.causal || k0 <= last + offset) ? 1 : 0;
  }
  __syncthreads();
  if (mb != nullptr)
    mark_live(mb, s.Tk, 0, s.Tq, k0, min(TK, s.Tk - k0), s.causal, offset, vec, live,
              [](int r, int) { return r / KvPlan<HP>::BQ; });
  __syncthreads();
  compact_live(live, ntq, list, nlive);
  __syncthreads();
  const int nl = *nlive;
  const int items = nl * G;  // item it: query head kvh * G + it / nl, tile list[it % nl]

  auto issue = [&](int it, int buf) {
    const int n = kvh * G + it / nl;
    const int q0 = list[it % nl] * BQ;
    const size_t head = (static_cast<size_t>(b) * s.Tq * s.N + n) * s.h;
    stage_rows<HP>(qs + buf * P::QT, q + head, s.Tq, s.N, s.h, q0, BQ);
    stage_rows<HP>(dos + buf * P::QT, dout + head, s.Tq, s.N, s.h, q0, BQ);
    const size_t row = (static_cast<size_t>(b) * s.N + n) * s.Tq;
    stage_stats(ls + buf * BQ, dd + buf * BQ, lse + row, D + row, s.Tq, q0, BQ);
    if (mb != nullptr) stage_mask(msk + buf * BQ * MROW, mb, s.Tq, s.Tk, q0, BQ, k0, vec);
    rdb::cp_async_commit();
  };
  if (items > 0) issue(0, 0);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[i][c] = dva[i][c] = 0.f;

  for (int it = 0; it < items; ++it) {
    const int buf = it & 1;
    if (it + 1 < items) {
      issue(it + 1, buf ^ 1);
      rdb::cp_async_wait<1>();
    } else {
      rdb::cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = list[it % nl] * BQ;
    const unsigned char* qt = qs + buf * P::QT;
    const unsigned char* ot = dos + buf * P::QT;
    const int8_t* mt = msk + buf * BQ * MROW;
    const float* lt = ls + buf * BQ;
    const float* dt = dd + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T over this warp's 16 keys: K and V as A
    // (re-read each step: the registers hold dK and dV), Q and dO as B.
    float st[NQ][4], pt[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[j][c] = pt[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, rdb::smem_addr(ks + swz<HP>(w16 + lane % 16, kk * 2 + lane / 16)));
      ldsm_x4(va, rdb::smem_addr(vs + swz<HP>(w16 + lane % 16, kk * 2 + lane / 16)));
#pragma unroll
      for (int np = 0; np < NQ / 2; ++np) {
        const int r = np * 16 + (lane % 8) + (lane / 16) * 8;
        const int c = kk * 2 + (lane / 8) % 2;
        uint32_t qf[4], of[4];
        ldsm_x4(qf, rdb::smem_addr(qt + swz<HP>(r, c)));
        ldsm_x4(of, rdb::smem_addr(ot + swz<HP>(r, c)));
        mma_bf16(st[2 * np], ka, qf[0], qf[1]);
        mma_bf16(st[2 * np + 1], ka, qf[2], qf[3]);
        mma_bf16(pt[2 * np], va, of[0], of[1]);
        mma_bf16(pt[2 * np + 1], va, of[2], of[3]);
      }
    }

    // P^T = exp(scale S^T - LSE) on attended cells, dS^T = P^T o (dP^T - D),
    // and both as bf16 A fragments. Cell (j, c): key k0 + w16 + lane / 4 +
    // 8 (c / 2), query q0 + 8 j + 2 (lane % 4) + c % 2.
    uint32_t pa[NQ / 2][4], sa[NQ / 2][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kl = w16 + lane / 4 + 8 * (c / 2);
        const int ql = 8 * j + 2 * (lane % 4) + c % 2;
        const int key = k0 + kl, qi = q0 + ql;
        bool ok = key < s.Tk && qi < s.Tq && (!s.causal || key <= qi + offset);
        if (mb != nullptr) ok = ok && mt[ql * MROW + kl] != 0;
        const float p = ok ? ex2(fmaf(st[j][c], sl2, -lt[ql] * LOG2E)) : 0.f;
        st[j][c] = p;
        pt[j][c] = p * (pt[j][c] - dt[ql]);
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(st[j][0], st[j][1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(st[j][2], st[j][3]);
      sa[j / 2][(j % 2) * 2] = pack_bf16(pt[j][0], pt[j][1]);
      sa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pt[j][2], pt[j][3]);
    }

    // dV += P^T dO and dK += dS^T Q: k-steps of 16 queries, dO and Q read
    // by ldmatrix.trans, n-tiles of 8 dims in pairs.
#pragma unroll
    for (int kj = 0; kj < NQ / 2; ++kj) {
      const int r = kj * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int d = 0; d < ND / 2; ++d) {
        uint32_t of[4], qf[4];
        ldsm_x4_t(of, rdb::smem_addr(ot + swz<HP>(r, d * 2 + lane / 16)));
        ldsm_x4_t(qf, rdb::smem_addr(qt + swz<HP>(r, d * 2 + lane / 16)));
        mma_bf16(dva[2 * d], pa[kj], of[0], of[1]);
        mma_bf16(dva[2 * d + 1], pa[kj], of[2], of[3]);
        mma_bf16(dka[2 * d], sa[kj], qf[0], qf[1]);
        mma_bf16(dka[2 * d + 1], sa[kj], qf[2], qf[3]);
      }
    }
    __syncthreads();  // this buffer is free for the item after next
  }

  // The K and V tiles are free (with no item, once their copies landed):
  // stage dK (scaled) and dV there as bf16 rows, then 16-byte stores.
  rdb::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int kl = w16 + lane / 4 + 8 * hh;
      const int at = swz<HP>(kl, nd) + 4 * (lane % 4);
      *reinterpret_cast<uint32_t*>(ks + at) =
          pack_bf16(dka[nd][2 * hh] * s.scale, dka[nd][2 * hh + 1] * s.scale);
      *reinterpret_cast<uint32_t*>(vs + at) = pack_bf16(dva[nd][2 * hh], dva[nd][2 * hh + 1]);
    }
  }
  __syncthreads();
  for (int e = tid; e < TK * NCH; e += TC_THREADS) {
    const int r = e / NCH, c = e % NCH;
    if (k0 + r < s.Tk && c < hc) {
      const size_t at = ((static_cast<size_t>(b) * s.Tk + k0 + r) * s.K + kvh) * s.h + c * 8;
      *reinterpret_cast<uint4*>(a.dk + at) = *reinterpret_cast<const uint4*>(ks + swz<HP>(r, c));
      *reinterpret_cast<uint4*>(a.dv + at) = *reinterpret_cast<const uint4*>(vs + swz<HP>(r, c));
    }
  }
}

template <int HP>
struct QPlan {
  static constexpr int T = TQ * HP * 2;  // bytes of a [64][HP] tile
  static size_t bytes(int ntk) {
    return 6 * static_cast<size_t>(T) + 2 * TQ * MROW + sizeof(float) * 2 * TQ +
           sizeof(int) * (2 * static_cast<size_t>(ntk) + 1);
  }
};

// The dQ role: dQ of rows [q0, q0 + 64) of one (query head, batch row);
// block ``blk`` of the role, query tile ntq - 1 - blk / (N B) (the last
// first: under causal it walks the most keys). Warp w owns rows 16 w ..
// 16 w + 15 and holds their Q and dO fragments; the block walks the live
// key tiles, double-buffered, each as two 32-key halves in turn (a loop
// the compiler keeps rolled: unrolled, the two halves' fragments spilled
// at HP 128).
template <int HP>
__device__ __noinline__ void dq_block(unsigned char* q_smem, int blk, const BwdArgs a) {
  const bf16* __restrict__ q = a.q;
  const bf16* __restrict__ k = a.k;
  const bf16* __restrict__ v = a.v;
  const bf16* __restrict__ dout = a.dout;
  const float* __restrict__ lse = a.lse;
  const float* __restrict__ D = a.D;
  const int8_t* __restrict__ mask = a.mask;
  const Shape s = a.s;
  using P = QPlan<HP>;
  constexpr int NCH = HP / 8;
  constexpr int KS = HP / 16;  // k-steps of S and dP
  constexpr int ND = HP / 8;   // dim n-tiles of dQ
  unsigned char* qs = q_smem;            // [64][HP]
  unsigned char* dos = qs + P::T;        // [64][HP]
  unsigned char* ks = dos + P::T;        // [2][64][HP]
  unsigned char* vs = ks + 2 * P::T;     // [2][64][HP]
  int8_t* msk = reinterpret_cast<int8_t*>(vs + 2 * P::T);  // [2][64][MROW]
  float* ls = reinterpret_cast<float*>(msk + 2 * TQ * MROW);
  float* dd = ls + TQ;
  const int ntk = (s.Tk + TK - 1) / TK;
  int* live = reinterpret_cast<int*>(dd + TQ);
  int* list = live + ntk;
  int* nlive = list + ntk;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int w16 = (tid / 32) * 16;  // this warp's first row in the tile
  const int n = blk % s.N;
  const int b = blk / s.N % s.B;
  const int q0 = ((s.Tq + TQ - 1) / TQ - 1 - blk / (s.N * s.B)) * TQ;
  const int kvh = n / (s.N / s.K);
  const int rows = min(TQ, s.Tq - q0);
  const int offset = s.Tk - s.Tq;
  const int hc = s.h / 8;
  const float sl2 = s.scale * LOG2E;
  const int8_t* mb = mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * s.Tq * s.Tk;
  const bool vec = mb != nullptr && s.Tk % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0;
  const bf16* kb = k + (static_cast<size_t>(b) * s.Tk * s.K + kvh) * s.h;
  const bf16* vb = v + (static_cast<size_t>(b) * s.Tk * s.K + kvh) * s.h;

  const size_t head = (static_cast<size_t>(b) * s.Tq * s.N + n) * s.h;
  stage_rows<HP>(qs, q + head, s.Tq, s.N, s.h, q0, TQ);
  stage_rows<HP>(dos, dout + head, s.Tq, s.N, s.h, q0, TQ);
  const size_t row = (static_cast<size_t>(b) * s.N + n) * s.Tq;
  stage_stats(ls, dd, lse + row, D + row, s.Tq, q0, TQ);
  rdb::cp_async_commit();

  // Live key tiles: some row of this tile attends some key of the tile.
  const int kv_end = s.causal ? max(0, min(s.Tk, q0 + rows + offset)) : s.Tk;
  for (int t = tid; t < ntk; t += TC_THREADS) live[t] = mb == nullptr && t * TK < kv_end ? 1 : 0;
  __syncthreads();
  if (mb != nullptr)
    mark_live(mb, s.Tk, q0, rows, 0, s.Tk, s.causal, offset, vec, live,
              [](int, int c) { return c / TK; });
  __syncthreads();
  compact_live(live, ntk, list, nlive);

  auto issue = [&](int t, int buf) {
    const int kt0 = t * TK;
    stage_rows<HP>(ks + buf * P::T, kb, s.Tk, s.K, s.h, kt0, TK);
    stage_rows<HP>(vs + buf * P::T, vb, s.Tk, s.K, s.h, kt0, TK);
    if (mb != nullptr) stage_mask(msk + buf * TQ * MROW, mb, s.Tq, s.Tk, q0, TQ, kt0, vec);
    rdb::cp_async_commit();
  };

  rdb::cp_async_wait<0>();  // Q, dO and the row stats landed (this thread's part)
  __syncthreads();          // ... every thread's; the live list is written
  const int nl = *nlive;
  if (nl > 0) issue(list[0], 0);

  // Q and dO fragments (A operands), one per k-step, held for the walk;
  // this thread's two rows' LSE (log2 units) and D.
  uint32_t qa[KS][4], da[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int at = swz<HP>(w16 + lane % 16, kk * 2 + lane / 16);
    ldsm_x4(qa[kk], rdb::smem_addr(qs + at));
    ldsm_x4(da[kk], rdb::smem_addr(dos + at));
  }
  float l2[2], dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l2[hh] = ls[w16 + lane / 4 + 8 * hh] * LOG2E;
    dr[hh] = dd[w16 + lane / 4 + 8 * hh];
  }

  float dqa[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;

  for (int i = 0; i < nl; ++i) {
    const int buf = i & 1;
    if (i + 1 < nl) {
      issue(list[i + 1], buf ^ 1);
      rdb::cp_async_wait<1>();
    } else {
      rdb::cp_async_wait<0>();
    }
    __syncthreads();
    const int kt0 = list[i] * TK;
    const unsigned char* kt = ks + buf * P::T;
    const unsigned char* vt = vs + buf * P::T;
    const int8_t* mt = msk + buf * TQ * MROW;

#pragma unroll 1  // unrolled, the halves' fragments spill at HP 128
    for (int kh = 0; kh < 2; ++kh) {
      const int kb0 = kh * 32;
      // S = Q K^T and dP = dO V^T over the half's 32 keys: 4 n-tiles of 8.
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[j][c] = dp[j][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int key = kb0 + np * 16 + (lane % 8) + (lane / 16) * 8;
          const int at = swz<HP>(key, kk * 2 + (lane / 8) % 2);
          uint32_t kf[4], vf[4];
          ldsm_x4(kf, rdb::smem_addr(kt + at));
          ldsm_x4(vf, rdb::smem_addr(vt + at));
          mma_bf16(sc[2 * np], qa[kk], kf[0], kf[1]);
          mma_bf16(sc[2 * np + 1], qa[kk], kf[2], kf[3]);
          mma_bf16(dp[2 * np], da[kk], vf[0], vf[1]);
          mma_bf16(dp[2 * np + 1], da[kk], vf[2], vf[3]);
        }
      }
      // dS = P o (dP - D), P = exp(scale S - LSE) on attended cells, as bf16
      // A fragments. Cell (j, c): row q0 + w16 + lane / 4 + 8 (c / 2), key
      // kt0 + kb0 + 8 j + 2 (lane % 4) + c % 2.
      uint32_t sa[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint16_t mpair[2] = {0xffffu, 0xffffu};
        if (mb != nullptr) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            mpair[hh] = *reinterpret_cast<const uint16_t*>(
                mt + (w16 + lane / 4 + 8 * hh) * MROW + kb0 + 8 * j + 2 * (lane % 4));
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = q0 + w16 + lane / 4 + 8 * (c / 2);
          const int key = kt0 + kb0 + 8 * j + 2 * (lane % 4) + c % 2;
          bool ok = qi < s.Tq && key < s.Tk && ((mpair[c / 2] >> (8 * (c % 2))) & 0xffu) != 0;
          if (s.causal) ok = ok && key <= qi + offset;
          const float p = ok ? ex2(fmaf(sc[j][c], sl2, -l2[c / 2])) : 0.f;
          dp[j][c] = p * (dp[j][c] - dr[c / 2]);
        }
        sa[j / 2][(j % 2) * 2] = pack_bf16(dp[j][0], dp[j][1]);
        sa[j / 2][(j % 2) * 2 + 1] = pack_bf16(dp[j][2], dp[j][3]);
      }
      // dQ += dS K: 2 k-steps of 16 keys, K read by ldmatrix.trans.
#pragma unroll
      for (int kj = 0; kj < 2; ++kj) {
        const int key = kb0 + kj * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
        for (int d = 0; d < ND / 2; ++d) {
          uint32_t kf[4];
          ldsm_x4_t(kf, rdb::smem_addr(kt + swz<HP>(key, d * 2 + lane / 16)));
          mma_bf16(dqa[2 * d], sa[kj], kf[0], kf[1]);
          mma_bf16(dqa[2 * d + 1], sa[kj], kf[2], kf[3]);
        }
      }
    }
    __syncthreads();  // this buffer is free for the tile after next
  }

  // Each warp stages its own 16 rows (scaled, bf16) over its Q rows, whose
  // fragments it already holds, then stores them in 16-byte chunks.
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = w16 + lane / 4 + 8 * hh;
      *reinterpret_cast<uint32_t*>(qs + swz<HP>(rl, nd) + 4 * (lane % 4)) =
          pack_bf16(dqa[nd][2 * hh] * s.scale, dqa[nd][2 * hh + 1] * s.scale);
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * NCH; e += 32) {
    const int rl = w16 + e / NCH, c = e % NCH;
    if (rl < rows && c < hc)
      *reinterpret_cast<uint4*>(a.dq + ((static_cast<size_t>(b) * s.Tq + q0 + rl) * s.N + n) * s.h +
                                c * 8) = *reinterpret_cast<const uint4*>(qs + swz<HP>(rl, c));
  }
}

// One launch for both roles: blocks [0, n_kv) compute dK / dV, the rest
// dQ, each role's heaviest blocks first. The dK / dV role's blocks are few
// and, under causal, unequal (key tile 0 walks every query tile, the last
// one tile): as its light blocks finish, the dQ role's take their SMs, so
// its heaviest blocks set the time, not the sum of two launches. Each role
// is a function of its own (__noinline__): inlined into one body, ptxas
// spilled at HP 128.
template <int HP>
__global__ void __launch_bounds__(TC_THREADS)
bwd_bf16_kernel(BwdArgs a, int n_kv) {
  extern __shared__ __align__(128) unsigned char bwd_smem[];
  const int blk = static_cast<int>(blockIdx.x);
  if (blk < n_kv)
    dkdv_block<HP>(bwd_smem, blk, a);
  else
    dq_block<HP>(bwd_smem, blk - n_kv, a);
}

template <int HP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, const float* lse, const int8_t* mask, void* dq,
                        void* dk, void* dv, float* D, const Shape& s, cudaStream_t stream) {
  const BwdArgs a{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, D, mask,
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), s};
  const long long rows = static_cast<long long>(s.B) * s.Tq * s.N;
  pre_bf16_kernel<<<static_cast<unsigned>((rows + 15) / 16), 256, 0, stream>>>(
      static_cast<const bf16*>(o), a.dout, D, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ntk = (s.Tk + TK - 1) / TK;
  const long long n_kv = static_cast<long long>(ntk) * s.K * s.B;
  const long long blocks = n_kv + static_cast<long long>((s.Tq + TQ - 1) / TQ) * s.N * s.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t kv_smem = KvPlan<HP>::bytes((s.Tq + KvPlan<HP>::BQ - 1) / KvPlan<HP>::BQ);
  const size_t q_smem = QPlan<HP>::bytes(ntk);
  const size_t smem = kv_smem > q_smem ? kv_smem : q_smem;
  auto kern = bwd_bf16_kernel<HP>;
  err = rdb::raise_smem_limit(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(blocks), TC_THREADS, smem, stream>>>(a, static_cast<int>(n_kv));
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
    return narrow ? launch_bf16<64>(q, k, v, o, dout, l, m, dq, dk, dv, d, s, st)
                  : launch_bf16<128>(q, k, v, o, dout, l, m, dq, dk, dv, d, s, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
