// Weight-only int8 GEMM for Hopper (sm_90a): y = x . dequant(q)^T (+ bias).
//
// The port's counterpart of the XLA fusion the JAX package relies on for
// weight-only int8 (engine/decode.py::_mp -> models/quant.py::
// dequantize_tree: the convert and the scale fused into the consuming
// matmul); no pallas_call stands behind it.
//
// y[M, N] = x[M, K] . W[N, K]^T (+ bias[N]) with W[n, k] = wd(q[n, k]) *
// wd(scale[n % period]) rounded to the weight dtype wd (bf16 or f32, the
// model's), the sum in f32, y in x's dtype. Layouts: x [M, K] row-major;
// q [N, K] int8 row-major (K contiguous: each output channel's codes come
// in 16-byte loads); scale [period] f32; bias [N] in x's dtype or null;
// y [M, N]. K % 16 == 0.
//
// What bounds it on the H100: at decode (M = 16) the code bytes, one a
// weight (mlp_up [14336, 4096] is 58.7 MB: 0.0175 ms at 3.35 TB/s); at a
// prefill group (M = 256) the bf16 tensor-core rate. Design:
// - Up to 16 rows of bf16 x (decode), and f32 x over bf16 weights (the
//   lm_head of a bf16 model): mma.sync m16n8k16 (bf16 in, f32 accumulate)
//   in stream_kernel. Each warp streams its columns' codes from device
//   memory into registers, two 64-deep k chunks ahead of the one it
//   multiplies, with no barrier in the loop, so many loads stay in
//   flight; the codes become bf16 fragments in registers (code x scale,
//   rounded as the reference rounds its dequantized weight), never a
//   stored tile. f32 x is split into three bf16 terms (exact to f32's 24
//   bits), three products each.
// - More rows of bf16 x (prefill groups, chunks, verify windows):
//   tile_kernel, a shared-memory tile GEMM that converts each codes tile
//   once per block and feeds every warp by ldmatrix.
// - f32 x over f32 weights (every product of an f32 model): CUDA cores
//   (FMA), 16 rows x 128 columns a block through cp.async stages, each
//   thread 4 x 4 outputs.
// - Split-K: when the output tiles number fewer than three a SM, K is
//   split over gridDim.z; every split writes its f32 partial to the
//   scratch, and the last block of a tile to arrive sums the partials in
//   split order (so results do not depend on block timing), adds the bias,
//   writes y and resets the tile's counter to 0 (every launch leaves the
//   counters at 0: graphs replay them).

#include "common.cuh"

#include <algorithm>

namespace {

constexpr int BK = 64;        // k elements a pipeline stage
constexpr int THREADS = 128;
constexpr int SMS = 132;      // H100 SXM
constexpr int MAX_SPLIT = 32;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float code(uint32_t w, int byte) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * byte)));
}

template <bool WBF16>
__device__ __forceinline__ float weight_scale(const float* scale, int n, int N, int period) {
  if (n >= N) return 0.f;
  const float s = scale[n % period];
  return WBF16 ? rdb::round_to<bf16>(s) : s;
}

// The last split block of an output tile to arrive sums the partials
// ws[s][m][n] in split order, adds the bias and writes y.
template <typename T>
__device__ void finish_split(const float* __restrict__ ws, int* __restrict__ cnt,
                             const T* __restrict__ bias, T* __restrict__ y, int M,
                             int N, int m0, int n0, int BM, int BN) {
  __shared__ int last;
  __threadfence();  // this block's partial is visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    const int prev = atomicAdd(cnt + tile, 1);
    last = prev == static_cast<int>(gridDim.z) - 1;
    if (last) cnt[tile] = 0;  // every split has arrived
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Four outputs a thread at a time, so four loads of each split are in
  // flight together; each output still sums its splits in order.
  constexpr int U = 4;
  const size_t plane = static_cast<size_t>(M) * N;
  for (int c0 = threadIdx.x; c0 < BM * BN; c0 += U * blockDim.x) {
    float v[U];
    size_t at[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * blockDim.x;
      const int m = m0 + c / BN, n = n0 + c % BN;
      ok[u] = c < BM * BN && m < M && n < N;
      at[u] = ok[u] ? static_cast<size_t>(m) * N + n : 0;
      v[u] = 0.f;
    }
    for (int s = 0; s < static_cast<int>(gridDim.z); ++s)
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) v[u] += __ldcg(ws + s * plane + at[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u]) continue;
      const int n = static_cast<int>(at[u] % N);
      if (bias != nullptr) v[u] += rdb::to_f(bias[n]);
      y[at[u]] = rdb::from_f<T>(v[u]);
    }
  }
}

// One accumulator value of row m, column n: to y (with the bias) when K
// is not split, else to this split's partial.
template <typename T>
__device__ __forceinline__ void emit(float v, int m, int n, int M, int N,
                                     const T* __restrict__ bias, T* __restrict__ y,
                                     float* __restrict__ ws) {
  if (m >= M || n >= N) return;
  if (gridDim.z == 1) {
    if (bias != nullptr) v += rdb::to_f(bias[n]);
    y[static_cast<size_t>(m) * N + n] = rdb::from_f<T>(v);
  } else {
    ws[(static_cast<size_t>(blockIdx.z) * M + m) * N + n] = v;
  }
}

// --- tensor cores: bf16 x, or f32 x over bf16 weights -----------------------
// A block's 4 warps share NT n8 tiles (32 columns at NT = 4) and MT m16
// tiles, and split the split's k range between them: warp w takes the
// 64-deep chunks w, w + 4, ... Lane (g, qi) reads 16 code bytes of row g
// of each n8 tile at k offset 16 qi of a chunk, straight from device
// memory into registers, DEPTH chunks ahead of the one it multiplies (no
// shared memory in the loop, no barrier: the loads in flight are what
// bounds decode). In the chunk's 16-deep step j the lane's bytes
// 4j..4j+3 are the fragment's k 2qi, 2qi+1, 2qi+8, 2qi+9, and its x loads
// take the same k; the dot product is unchanged. At the end warps 1-3
// hand their sums to warp 0 through shared memory, added in warp order.
// SPLIT3 (f32 x over bf16 weights: the lm_head of a bf16 model) splits
// each x into three bf16 terms hi + mid + lo, exact to f32's 24 bits, and
// runs three products per weight fragment.
template <typename TA, int MT, int NT, bool SPLIT3>
__global__ void __launch_bounds__(THREADS)
stream_kernel(const TA* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scale, const TA* __restrict__ bias,
              TA* __restrict__ y, float* __restrict__ ws, int* __restrict__ cnt, int M,
              int N, int K, int period, int kps) {
  static_assert(SPLIT3 == std::is_same<TA, float>::value, "f32 x splits in three");
  constexpr int BN = NT * 8;
  constexpr int DEPTH = MT == 1 ? 2 : 1;  // chunks loaded ahead
  constexpr int WARPS = THREADS / 32;
  __shared__ float red[WARPS - 1][MT * NT * 4][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qi = lane & 3;
  const int m0 = blockIdx.x * 16 * MT;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * kps * BK;
  const int kend = min(K, kbeg + kps * BK);
  const int nchunks = (kend - kbeg + BK - 1) / BK;

  float sc[NT];
  const int8_t* qrow[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + nt * 8 + g;
    sc[nt] = weight_scale<true>(scale, n, N, period);
    qrow[nt] = n < N ? q + static_cast<size_t>(n) * K : nullptr;
  }
  auto load = [&](uint4 (&dst)[NT], int c) {
    const int k = kbeg + c * BK + 16 * qi;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      dst[nt] = (qrow[nt] != nullptr && k < kend)
                    ? __ldcs(reinterpret_cast<const uint4*>(qrow[nt] + k))
                    : make_uint4(0u, 0u, 0u, 0u);
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  uint4 cur[NT], nx1[NT], nx2[NT];
  load(cur, warp);
  if (DEPTH > 1) load(nx1, warp + WARPS);
  for (int c = warp; c < nchunks; c += WARPS) {
    load(DEPTH > 1 ? nx2 : nx1, c + DEPTH * WARPS);  // zero past the last chunk
    const int k = kbeg + c * BK + 16 * qi;
    const bool kin = k < kend;
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t a[MT][SPLIT3 ? 3 : 1][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + mt * 16 + g + 8 * h;
          const bool ok = kin && m < M;
          if constexpr (SPLIT3) {
            const float4 v = ok ? __ldg(reinterpret_cast<const float4*>(
                                      x + static_cast<size_t>(m) * K + k + 4 * j))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
            const float e[4] = {v.x, v.y, v.z, v.w};
            float hi[4], mid[4], lo[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              hi[i] = rdb::round_to<bf16>(e[i]);
              const float r = e[i] - hi[i];
              mid[i] = rdb::round_to<bf16>(r);
              lo[i] = r - mid[i];
            }
            a[mt][0][h] = rdb::pack_bf16(hi[0], hi[1]);
            a[mt][0][2 + h] = rdb::pack_bf16(hi[2], hi[3]);
            a[mt][1][h] = rdb::pack_bf16(mid[0], mid[1]);
            a[mt][1][2 + h] = rdb::pack_bf16(mid[2], mid[3]);
            a[mt][2][h] = rdb::pack_bf16(lo[0], lo[1]);
            a[mt][2][2 + h] = rdb::pack_bf16(lo[2], lo[3]);
          } else {
            const uint2 v = ok ? __ldg(reinterpret_cast<const uint2*>(
                                     x + static_cast<size_t>(m) * K + k + 4 * j))
                               : make_uint2(0u, 0u);
            a[mt][0][h] = v.x;
            a[mt][0][2 + h] = v.y;
          }
        }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t w = j == 0 ? cur[nt].x : j == 1 ? cur[nt].y : j == 2 ? cur[nt].z : cur[nt].w;
        const float s = sc[nt];
        const uint32_t b0 = rdb::pack_bf16(code(w, 0) * s, code(w, 1) * s);
        const uint32_t b1 = rdb::pack_bf16(code(w, 2) * s, code(w, 3) * s);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if constexpr (SPLIT3) {
            rdb::mma_bf16(acc[mt][nt], a[mt][2], b0, b1);  // smallest terms first
            rdb::mma_bf16(acc[mt][nt], a[mt][1], b0, b1);
          }
          rdb::mma_bf16(acc[mt][nt], a[mt][0], b0, b1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      cur[nt] = nx1[nt];
      if (DEPTH > 1) nx1[nt] = nx2[nt];
    }
  }

  if (warp > 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[warp - 1][(mt * NT + nt) * 4 + e][lane] = acc[mt][nt][e];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = acc[mt][nt][e];
#pragma unroll
          for (int w = 0; w < WARPS - 1; ++w) v += red[w][(mt * NT + nt) * 4 + e][lane];
          emit(v, m0 + mt * 16 + g + 8 * (e >> 1), n0 + nt * 8 + 2 * qi + (e & 1), M, N,
               bias, y, ws);
        }
  }
  if (gridDim.z > 1) finish_split(ws, cnt, bias, y, M, N, m0, n0, 16 * MT, BN);
}

// --- bf16 x at prefill widths (M > 16): a shared-memory tile GEMM ----------
// A block computes BM x 128 outputs with 8 warps (2 x 4, warp tiles of
// BM/2 x 32). Each 64-deep k tile of x and of the codes arrives with
// cp.async (3 stages); the block's threads convert the codes tile once
// (code x scale, rounded to bf16) into a bf16 tile that every warp reads
// with ldmatrix — converting once per block, not once per warp, is what
// a tall M needs. The bf16 tile is double-buffered: tile kt + 1 is
// converted while tile kt is multiplied, one barrier a tile. Rows are 128
// bytes with their 16-byte chunks XOR-swizzled by the row (no padding,
// conflict-free ldmatrix), so two blocks fit an SM.
constexpr int TILE_THREADS = 256;

template <int BM_>
struct TileCfg {
  static constexpr int BM = BM_, BN = 128, BKT = 64, STAGES = 3;
  static constexpr int MT = BM / 32, NT = 4;  // a warp's m16 / n8 tiles
  static constexpr int X_STAGE = BM * BKT * 2;
  static constexpr int C_STAGE = BN * BKT;
  static constexpr int W_BUF = BN * BKT * 2;
  static constexpr int SMEM = STAGES * (X_STAGE + C_STAGE) + 2 * W_BUF;
};

// bf16 element offset of 16-byte chunk c (0..7) of row r in a swizzled tile.
__device__ __forceinline__ int swz(int r, int c) { return (r * 8 + (c ^ (r & 7))) * 8; }

template <int BM>
__global__ void __launch_bounds__(TILE_THREADS)
tile_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
            const float* __restrict__ scale, const bf16* __restrict__ bias,
            bf16* __restrict__ y, float* __restrict__ ws, int* __restrict__ cnt, int M,
            int N, int K, int period, int kps) {
  using C = TileCfg<BM>;
  constexpr int BN = C::BN, BKT = C::BKT, STAGES = C::STAGES;
  constexpr int MT = C::MT, NT = C::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  int8_t* cs = reinterpret_cast<int8_t*>(smem + STAGES * C::X_STAGE);
  bf16* wt = reinterpret_cast<bf16*>(smem + STAGES * (C::X_STAGE + C::C_STAGE));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, qi = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * kps * BK;
  const int kend = min(K, kbeg + kps * BK);
  const int nk = (kend - kbeg + BKT - 1) / BKT;
  // Thread t converts half t % 2 of row t / 2 of every codes tile.
  const int crow = tid >> 1, chalf = tid & 1;
  const float sconv = weight_scale<true>(scale, n0 + crow, N, period);

  auto load = [&](int kt) {
    const int stage = kt % STAGES, k0 = kbeg + kt * BKT;
    bf16* xd = xs + stage * BM * BKT;
    int8_t* cd = cs + stage * BN * BKT;
    for (int c = tid; c < BM * 8; c += TILE_THREADS) {
      const int r = c >> 3, k = k0 + (c & 7) * 8;
      const bool ok = m0 + r < M && k < kend;
      rdb::cp_async16(xd + swz(r, c & 7), ok ? x + static_cast<size_t>(m0 + r) * K + k : x,
                      ok);
    }
    for (int c = tid; c < BN * (BKT / 16); c += TILE_THREADS) {
      const int r = c / (BKT / 16), k = k0 + (c % (BKT / 16)) * 16;
      const bool ok = n0 + r < N && k < kend;
      rdb::cp_async16(cd + r * BKT + (c % (BKT / 16)) * 16,
                      ok ? q + static_cast<size_t>(n0 + r) * K + k : q, ok);
    }
  };
  auto convert = [&](int kt) {
    const int8_t* src = cs + (kt % STAGES) * BN * BKT + crow * BKT + chalf * 32;
    bf16* dst = wt + (kt & 1) * BN * BKT;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 c = *reinterpret_cast<const uint4*>(src + 16 * h);
      const uint32_t w[4] = {c.x, c.y, c.z, c.w};
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[2 * i] = rdb::pack_bf16(code(w[i], 0) * sconv, code(w[i], 1) * sconv);
        o[2 * i + 1] = rdb::pack_bf16(code(w[i], 2) * sconv, code(w[i], 3) * sconv);
      }
      const int chunk = chalf * 4 + 2 * h;
      *reinterpret_cast<uint4*>(dst + swz(crow, chunk)) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(dst + swz(crow, chunk + 1)) =
          make_uint4(o[4], o[5], o[6], o[7]);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  if (nk > 0) load(0);
  rdb::cp_async_commit();
  if (nk > 1) load(1);
  rdb::cp_async_commit();
  rdb::cp_async_wait<1>();
  __syncthreads();
  if (nk > 0) convert(0);
  for (int kt = 0; kt < nk; ++kt) {
    rdb::cp_async_wait<0>();
    // Tile kt + 1 landed; tile kt's bf16 weights are whole; every warp is
    // done with tile kt - 1 (its stage and its bf16 buffer are free).
    __syncthreads();
    if (kt + 2 < nk) load(kt + 2);
    rdb::cp_async_commit();
    if (kt + 1 < nk) convert(kt + 1);
    const bf16* xa = xs + (kt % STAGES) * BM * BKT;
    const bf16* wb = wt + (kt & 1) * BN * BKT;
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        rdb::ldsm_x4(a[mt], rdb::smem_addr(xa + swz((wm * MT + mt) * 16 + (lane & 15),
                                                    2 * kk + (lane >> 4))));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        const int j = lane >> 3;
        rdb::ldsm_x4(b, rdb::smem_addr(wb + swz(wn * 32 + np * 16 + (j >> 1) * 8 + (lane & 7),
                                                2 * kk + (j & 1))));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          rdb::mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          rdb::mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  rdb::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        emit(acc[mt][nt][e], m0 + (wm * MT + mt) * 16 + g + 8 * (e >> 1),
             n0 + wn * 32 + nt * 8 + 2 * qi + (e & 1), M, N, bias, y, ws);
  if (gridDim.z > 1) finish_split(ws, cnt, bias, y, M, N, m0, n0, BM, BN);
}

// --- f32 x over f32 weights: CUDA cores ------------------------------------
struct FmaTile {
  static constexpr int BM = 16, BN = 128;
  static constexpr int LDC = BK + 4;  // bytes: 17 words, conflict-free column reads
  static constexpr int STAGES = 3;
  static constexpr int X_BYTES = BM * BK * 4;
  static constexpr int STAGE_BYTES = X_BYTES + BN * LDC;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
};

__global__ void __launch_bounds__(THREADS)
fma_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
           const float* __restrict__ scale, const float* __restrict__ bias,
           float* __restrict__ y, float* __restrict__ ws, int* __restrict__ cnt, int M,
           int N, int K, int period, int kps) {
  constexpr int BM = FmaTile::BM, BN = FmaTile::BN, LDC = FmaTile::LDC;
  constexpr int STAGES = FmaTile::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * kps * BK;
  const int kend = min(K, kbeg + kps * BK);
  const int nk = (kend - kbeg + BK - 1) / BK;

  // Thread (warp w, lane c): rows 4w..4w+3, columns c + 32j.
  float sc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) sc[j] = weight_scale<false>(scale, n0 + lane + 32 * j, N, period);

  auto load = [&](int stage, int kt) {
    unsigned char* base = smem + stage * FmaTile::STAGE_BYTES;
    float* xs = reinterpret_cast<float*>(base);
    unsigned char* cs = base + FmaTile::X_BYTES;
    const int k0 = kbeg + kt * BK;
    for (int c = tid; c < BM * (BK / 4); c += THREADS) {
      const int r = c / (BK / 4), k = k0 + (c % (BK / 4)) * 4;
      const bool ok = m0 + r < M && k < kend;
      rdb::cp_async16(xs + r * BK + (c % (BK / 4)) * 4,
                      ok ? x + static_cast<size_t>(m0 + r) * K + k : x, ok);
    }
    for (int c = tid; c < BN * (BK / 4); c += THREADS) {
      const int r = c / (BK / 4), k = k0 + (c % (BK / 4)) * 4;
      const bool ok = n0 + r < N && k < kend;
      rdb::cp_async4(cs + r * LDC + (c % (BK / 4)) * 4,
                     ok ? q + static_cast<size_t>(n0 + r) * K + k : q, ok);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    rdb::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    rdb::cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    rdb::cp_async_commit();
    const unsigned char* base = smem + (kt % STAGES) * FmaTile::STAGE_BYTES;
    const float* xs = reinterpret_cast<const float*>(base);
    const unsigned char* cs = base + FmaTile::X_BYTES;
#pragma unroll 4
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      float4 xv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        xv[r] = *reinterpret_cast<const float4*>(xs + (4 * warp + r) * BK + 4 * k4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t w =
            *reinterpret_cast<const uint32_t*>(cs + (lane + 32 * j) * LDC + 4 * k4);
        const float w0 = code(w, 0) * sc[j];
        const float w1 = code(w, 1) * sc[j];
        const float w2 = code(w, 2) * sc[j];
        const float w3 = code(w, 3) * sc[j];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float a = acc[r][j];
          a = fmaf(xv[r].x, w0, a);
          a = fmaf(xv[r].y, w1, a);
          a = fmaf(xv[r].z, w2, a);
          a = fmaf(xv[r].w, w3, a);
          acc[r][j] = a;
        }
      }
    }
  }
  rdb::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      emit(acc[r][j], m0 + 4 * warp + r, n0 + lane + 32 * j, M, N, bias, y, ws);
  if (gridDim.z > 1) finish_split(ws, cnt, bias, y, M, N, m0, n0, BM, BN);
}

// Split K until the blocks number ``target``: at least 2 chunks a split, at
// most MAX_SPLIT splits, partials within the scratch, and their f32 bytes
// (split x M x N x 4, written and read once) at most twice the codes'
// (N x K).
int pick_split(int tiles, int target, int chunks, int M, int N, int K, long long ws_len,
               int cnt_len, int* kps) {
  int split = 1;
  if (tiles < target && tiles <= cnt_len) {
    split = (target + tiles - 1) / tiles;
    split = std::min(split, std::max(1, chunks / 2));
    split = std::min(split, MAX_SPLIT);
    split = std::min(split, std::max(1, K / (2 * M)));
    while (split > 1 && static_cast<long long>(split) * M * N > ws_len) --split;
  }
  *kps = (chunks + split - 1) / split;
  return (chunks + *kps - 1) / *kps;  // no empty split
}

// grid (x, y, split) with x * y output tiles; x must cover M or N as the
// kernel reads it. ``target``: the blocks to aim for (split K up to it).
template <typename Kern, typename T>
int launch(Kern kern, dim3 tiles, int threads, int target, int smem, const void* x,
           const void* q, const void* scale, const void* bias, void* y, int M, int N, int K,
           int period, void* ws, long long ws_len, void* cnt, int cnt_len, cudaStream_t st) {
  if (tiles.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int kps = 0;
  tiles.z = pick_split(tiles.x * tiles.y, target, (K + BK - 1) / BK, M, N, K, ws_len,
                       cnt_len, &kps);
  if (smem > 0) {
    cudaError_t err = rdb::raise_smem_limit(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<tiles, threads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<const T*>(bias), static_cast<T*>(y),
      static_cast<float*>(ws), static_cast<int*>(cnt), M, N, K, period, kps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, int MT, bool SPLIT3>
int launch_stream(const void* x, const void* q, const void* scale, const void* bias,
                  void* y, int M, int N, int K, int period, void* ws, long long ws_len,
                  void* cnt, int cnt_len, cudaStream_t st) {
  constexpr int NT = 4, BN = NT * 8;
  const dim3 tiles((M + 16 * MT - 1) / (16 * MT), (N + BN - 1) / BN);
  return launch<decltype(&stream_kernel<TA, MT, NT, SPLIT3>), TA>(
      stream_kernel<TA, MT, NT, SPLIT3>, tiles, THREADS, 3 * SMS, 0, x, q, scale, bias, y, M,
      N, K, period, ws, ws_len, cnt, cnt_len, st);
}

template <int BM>
int launch_tile(const void* x, const void* q, const void* scale, const void* bias, void* y,
                int M, int N, int K, int period, void* ws, long long ws_len, void* cnt,
                int cnt_len, cudaStream_t st) {
  using C = TileCfg<BM>;
  const dim3 tiles((M + BM - 1) / BM, (N + C::BN - 1) / C::BN);
  // Short tiles split K toward two blocks an SM, tall ones toward one:
  // their partials cost more bytes.
  return launch<decltype(&tile_kernel<BM>), bf16>(tile_kernel<BM>, tiles, TILE_THREADS,
                                                  BM > 64 ? SMS : 2 * SMS, C::SMEM, x, q, scale, bias, y,
                                                  M, N, K, period, ws, ws_len, cnt,
                                                  cnt_len, st);
}

// bf16 x: up to 16 rows stream, taller M tiles; f32 x over bf16 weights
// streams at any M.
template <typename TA, bool SPLIT3>
int launch_mma(const void* x, const void* q, const void* scale, const void* bias, void* y,
               int M, int N, int K, int period, void* ws, long long ws_len, void* cnt,
               int cnt_len, cudaStream_t st) {
  if constexpr (!SPLIT3) {
    if (M > 64)
      return launch_tile<128>(x, q, scale, bias, y, M, N, K, period, ws, ws_len, cnt,
                              cnt_len, st);
    if (M > 16)
      return launch_tile<64>(x, q, scale, bias, y, M, N, K, period, ws, ws_len, cnt,
                             cnt_len, st);
    return launch_stream<TA, 1, false>(x, q, scale, bias, y, M, N, K, period, ws, ws_len,
                                       cnt, cnt_len, st);
  } else {
    if (M <= 16)
      return launch_stream<TA, 1, true>(x, q, scale, bias, y, M, N, K, period, ws, ws_len,
                                        cnt, cnt_len, st);
    if (M <= 32)
      return launch_stream<TA, 2, true>(x, q, scale, bias, y, M, N, K, period, ws, ws_len,
                                        cnt, cnt_len, st);
    return launch_stream<TA, 4, true>(x, q, scale, bias, y, M, N, K, period, ws, ws_len,
                                      cnt, cnt_len, st);
  }
}

}  // namespace

extern "C" int rdb_int8_weight_matmul(const void* x, const void* q, const void* scale,
                                      const void* bias, void* y, int M, int N, int K,
                                      int period, int act_bf16, int w_bf16, void* ws,
                                      long long ws_len, void* cnt, int cnt_len,
                                      void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || period <= 0 || N % period != 0 ||
      (act_bf16 && !w_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act_bf16)
    return launch_mma<bf16, false>(x, q, scale, bias, y, M, N, K, period, ws, ws_len, cnt,
                                   cnt_len, st);
  if (w_bf16)
    return launch_mma<float, true>(x, q, scale, bias, y, M, N, K, period, ws, ws_len, cnt,
                                   cnt_len, st);
  const dim3 tiles((N + FmaTile::BN - 1) / FmaTile::BN, (M + FmaTile::BM - 1) / FmaTile::BM);
  return launch<decltype(&fma_kernel), float>(fma_kernel, tiles, THREADS, 3 * SMS,
                                              FmaTile::SMEM, x, q, scale, bias, y, M, N, K,
                                              period, ws, ws_len, cnt, cnt_len, st);
}
