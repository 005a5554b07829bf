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
// q [N, K] int8 row-major (K contiguous); scale [period] f32; bias [N] in
// x's dtype or null; y [M, N]. K % 16 == 0.
//
// Four bodies; the entry point reports which one it launched.
//
// "prefill" (bf16 x, M > 16: prefill groups and chunks, verify windows, MoE
// experts at a fill): wgmma_kernel<BT, CH>, warp-specialised and swapped.
// It computes y^T = W . x^T, so the weight is wgmma's A operand, taken
// from registers, and the tokens are its N: one m64nBTk16 wgmma a 16-deep
// step, BT = 64, 128 or 256. What bounds it on the H100: the code bytes
// up to M ~ 128 (0.0175 ms for mlp_up's 58.7 MB at 3.35 TB/s), the bf16
// tensor-core rate above (2MNK at 989 TFLOP/s: 0.0304 ms for mlp_up at
// M 256), and in practice shared memory, which carries every x tile in
// (TMA) and out (wgmma's B reads) besides the codes. One producer thread
// keeps TMA copies of the codes (CH rows of 128 bytes, 128-byte swizzle;
// 64 at BT 256) and of the x tile (BT rows of 128 bytes, 128-byte swizzle,
// ragged rows and the K tail zero-filled) in flight through a ring of
// stages with full / empty mbarriers. Two consumer warpgroups read their
// rows' code bytes from the stage and make the A fragment in registers:
// each byte, offset by 128, is the low byte of the f32 2^23 + u, so one
// subtract gives the code exactly; its f32 has nothing below the top 16
// bits, which are its bf16; one correctly rounded bf16x2 multiply by the
// bf16 scale gives bf16(code x scale), the rounding dequantize_rows does.
// No bf16 weight tile is stored and no barrier but the ring's is crossed.
// CH = 128 (each warpgroup 64 channels of every stage) where the tiles
// fill most of the card; else CH = 64 (both warpgroups on the same 64
// channels, alternate stages), twice the blocks. When the tiles still leave
// SMs idle K is split over a thread-block cluster along z, the largest the
// card runs in one wave (cudaOccupancyMaxActiveClusters): each block leaves
// its f32 partial tile in its own shared memory, and after a cluster
// barrier block r sums rows r ceil(BT / S) .. of all partials through
// distributed shared memory in rank order (results do not depend on block
// timing), adds the bias and writes y row-major. No partial goes through
// device memory.
//
// "decode" (bf16 x, M <= 16: a decode step's slots) and "split3" (f32 x
// over bf16 weights: the lm_head and router of a bf16 model):
// stream_kernel, mma.sync m16n8k16 with every warp streaming its columns'
// codes from device memory into registers two 64-deep chunks ahead. What
// bounds it is the code bytes, one a weight, so nothing stands between a
// code's load and its use but registers. The codes become bf16 by the same
// byte-permute conversion as at prefill, which keeps the conversion units
// (16 results a clock an SM for int-to-float and float-to-bf16) out of the
// loop: with them the conversion, not the loads, set the pace. A TMA ring
// feeding wgmma m64n16k16 or mma.sync ran slower on the H100 at these
// shapes (ptxas serialises wgmmas whose A registers are redefined while
// in flight). Narrow products (q/o, down) run 16-warp blocks with K
// whole; k/v split K over a cluster of up to 8 blocks, summed through
// distributed shared memory in rank order. split3 splits x into three
// bf16 terms (exact to f32's 24 bits), three products each, and splits K
// over the caller's scratch.
//
// "fma" (f32 x over f32 weights: every product of an f32 model): CUDA
// cores, 16 rows x 128 columns a block through cp.async stages.
//
// split3 and fma split K over gridDim.z when their tiles number fewer than
// three a SM: every split writes its f32 partial to the caller's scratch,
// and the last block of a tile to arrive sums the partials in split order,
// adds the bias, writes y and resets the tile's counter to 0 (every launch
// leaves the counters at 0: graphs replay them).

#include "common.cuh"

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes via the runtime

#include <algorithm>

namespace {

constexpr int BK = 64;        // k elements a pipeline stage
constexpr int THREADS = 128;
constexpr int SMS = 132;      // H100 SXM
constexpr int MAX_SPLIT = 32;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// Body ids reported to the caller (ops/quant_matmul.py BODIES).
enum Body { PREFILL = 0, DECODE = 1, SPLIT3 = 2, FMA = 3 };

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
__device__ void finish_split(const float* __restrict__ ws, int* __restrict__ cnt,
                             const float* __restrict__ bias, float* __restrict__ y, int M,
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
      if (bias != nullptr) v[u] += bias[n];
      y[at[u]] = v[u];
    }
  }
}

// One accumulator value of row m, column n: to y (with the bias) when K
// is not split, else to this split's partial in the scratch (f32 x).
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

// --- thread-block clusters ---------------------------------------------------
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Shared address ``a`` of this block -> the same offset in block ``rank``.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// Cluster launch: grid ``grid`` in clusters of (1, 1, gridDim.z).
inline cudaLaunchConfig_t cluster_config(dim3 grid, int threads, int smem, cudaStream_t st,
                                         cudaLaunchAttribute (&at)[1]) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = grid.z;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  return cfg;
}

// Codes bytes b and b + 1 of word w, as the bf16 pair bf16(code x s) for
// the bf16 scale pair s2: each byte, offset by 128, is the low byte of the
// f32 2^23 + u, so one subtract gives the code exactly; a code's f32 has
// nothing below its top 16 bits, so those are its bf16; the product is one
// correctly rounded bf16x2 multiply (fma with -0), as dequantize_rows
// rounds codes.to(bf16) * scale.to(bf16).
__device__ __forceinline__ uint32_t dequant2(uint32_t w, uint32_t b, uint32_t s2) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | b)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | (b + 1))) - 8388736.f;
  const uint32_t v = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632u);
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(s2), "r"(0x80008000u));
  return r;
}

__device__ __forceinline__ uint32_t scale_pair(const float* scale, int n, int N, int period) {
  const float s = weight_scale<true>(scale, n, N, period);
  return rdb::pack_bf16(s, s);
}

// --- up to 16 rows: mma.sync from streamed registers -------------------------
// "decode" (bf16 x, M <= 16: a decode step's slots) and "split3" (f32 x over
// bf16 weights: the lm_head and router of a bf16 model). What bounds both
// is the code bytes, one a weight, so nothing stands between a code's load
// and its use but registers: a block's warps share NT n8 tiles (32
// columns at NT = 4) and MT m16 tiles, and split the split's k range
// between them: warp w takes the 64-deep chunks w, w + WARPS, ... Lane (g, qi)
// reads 16 code bytes of row g of each n8 tile at k offset 16 qi of a
// chunk, straight from device memory into registers, DEPTH chunks ahead of
// the one it multiplies (no shared memory in the loop, no barrier). In the
// chunk's 16-deep step j the lane's bytes 4j..4j+3 are the fragment's k
// 2qi, 2qi+1, 2qi+8, 2qi+9, and its x loads take the same k; the dot
// product is unchanged. At the end warps 1.. hand their sums to warp 0
// through shared memory, added in warp order. SPLIT3 splits each x into
// three bf16 terms hi + mid + lo, exact to f32's 24 bits, and runs three
// products per weight fragment.
// The codes become bf16 fragments by dequant2. A block has 4 warps; 16
// for bf16 x when the column tiles are few (q/o and down at decode), so
// one tile keeps 16 warps' loads in flight without splitting K. Where K must still be split (k/v), over
// gridDim.z: bf16 x over a thread-block cluster, each split's block
// leaving its partial tile in its own shared memory and the cluster's
// blocks summing it through distributed shared memory in rank order (no
// device-memory round trip); f32 x over the caller's scratch
// (finish_split).
template <typename TA, int MT, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
stream_kernel(const TA* __restrict__ x, const int8_t* __restrict__ q,
              const float* __restrict__ scale, const TA* __restrict__ bias,
              TA* __restrict__ y, float* __restrict__ ws, int* __restrict__ cnt, int M,
              int N, int K, int period, int kps) {
  constexpr bool SPLIT3 = std::is_same<TA, float>::value;
  constexpr int NT = 4, BN = NT * 8;
  constexpr int DEPTH = MT == 1 ? 2 : 1;  // chunks loaded ahead
  __shared__ float red[WARPS - 1][MT * NT * 4][32];
  __shared__ float part[SPLIT3 ? 1 : 16 * MT][BN];  // a split's partial tile (bf16 x)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, qi = lane & 3;
  const int m0 = blockIdx.x * 16 * MT;
  const int n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * kps * BK;
  const int kend = min(K, kbeg + kps * BK);
  const int nchunks = (kend - kbeg + BK - 1) / BK;

  uint32_t sc[NT];  // the bf16 scale, twice
  const int8_t* qrow[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = n0 + nt * 8 + g;
    sc[nt] = scale_pair(scale, n, N, period);
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
        const uint32_t b0 = dequant2(w, 0, sc[nt]);
        const uint32_t b1 = dequant2(w, 2, sc[nt]);
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
  const bool cluster = !SPLIT3 && gridDim.z > 1;
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
          const int r = mt * 16 + g + 8 * (e >> 1), cl = nt * 8 + 2 * qi + (e & 1);
          if (cluster)
            part[r][cl] = v;
          else
            emit(v, m0 + r, n0 + cl, M, N, bias, y, ws);
        }
  }
  if constexpr (SPLIT3) {
    if (gridDim.z > 1) finish_split(ws, cnt, bias, y, M, N, m0, n0, 16 * MT, BN);
  } else if (cluster) {
    // Block r sums rows r ceil(16 MT / S) .. of every split's partial in
    // rank order, adds the bias and writes y.
    cluster_sync();
    const int S = static_cast<int>(gridDim.z);
    const int rows = (16 * MT + S - 1) / S;
    const int rank = static_cast<int>(cluster_rank());
    for (int it = threadIdx.x; it < rows * BN; it += 32 * WARPS) {
      const int r = rank * rows + it / BN, cl = it % BN;
      const int m = m0 + r, n = n0 + cl;
      if (r >= 16 * MT || m >= M || n >= N) continue;
      const uint32_t at = rdb::smem_addr(&part[r][cl]);
      float v = 0.f;
      for (int p = 0; p < S; ++p) v += ld_cluster(cluster_addr(at, p));
      if (bias != nullptr) v += rdb::to_f(bias[n]);
      y[static_cast<size_t>(m) * N + n] = rdb::from_f<TA>(v);
    }
    cluster_sync();  // no block leaves while another reads its partial
  }
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
template <typename Kern>
int launch(Kern kern, dim3 tiles, int target, int smem, const void* x, const void* q,
           const void* scale, const void* bias, void* y, int M, int N, int K, int period,
           void* ws, long long ws_len, void* cnt, int cnt_len, cudaStream_t st) {
  if (tiles.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int kps = 0;
  tiles.z = pick_split(tiles.x * tiles.y, target, (K + BK - 1) / BK, M, N, K, ws_len,
                       cnt_len, &kps);
  if (smem > 0) {
    cudaError_t err = rdb::raise_smem_limit(kern, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<tiles, THREADS, smem, st>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<const float*>(bias), static_cast<float*>(y),
      static_cast<float*>(ws), static_cast<int*>(cnt), M, N, K, period, kps);
  return static_cast<int>(cudaGetLastError());
}

template <typename TA, int MT>
int launch_stream(const void* x, const void* q, const void* scale, const void* bias, void* y,
                  int M, int N, int K, int period, void* ws, long long ws_len, void* cnt,
                  int cnt_len, cudaStream_t st) {
  constexpr int BN = 32;
  dim3 tiles((M + 16 * MT - 1) / (16 * MT), (N + BN - 1) / BN);
  if constexpr (std::is_same<TA, float>::value) {
    return launch(stream_kernel<TA, MT, 4>, tiles, 3 * SMS, 0, x, q, scale, bias, y, M, N, K,
                  period, ws, ws_len, cnt, cnt_len, st);
  } else {
    if (tiles.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const int chunks = (K + BK - 1) / BK, n_tiles = tiles.x * tiles.y;
    // Enough tiles for three 4-warp blocks an SM: as they are. Enough for
    // a 16-warp block on most SMs (q/o, down): 16-warp blocks, K whole.
    // Fewer (k/v): 4-warp blocks, K split over a cluster toward three
    // blocks an SM, at least 2 chunks a split.
    const bool wide = n_tiles >= 3 * SMS || 4 * n_tiles < 3 * SMS;
    int split = 1;
    if (4 * n_tiles < 3 * SMS)
      split = std::max(1, std::min({MAX_CLUSTER, (3 * SMS + n_tiles - 1) / n_tiles,
                                    chunks / 2}));
    const int kps = (chunks + split - 1) / split;
    tiles.z = split;
    cudaLaunchAttribute at[1];
    const cudaLaunchConfig_t cfg = cluster_config(tiles, wide ? 128 : 512, 0, st, at);
    auto args = [&](auto kern) {
      return cudaLaunchKernelEx(
          &cfg, kern, static_cast<const TA*>(x), static_cast<const int8_t*>(q),
          static_cast<const float*>(scale), static_cast<const TA*>(bias), static_cast<TA*>(y),
          static_cast<float*>(nullptr), static_cast<int*>(nullptr), M, N, K, period, kps);
    };
    const cudaError_t err = wide ? args(stream_kernel<TA, MT, 4>) : args(stream_kernel<TA, MT, 16>);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
}

// --- bf16 x: the warp-specialised wgmma body --------------------------------
namespace wg {

constexpr int THREADS = 384;         // warpgroup 0 the producer, 1-2 the consumers
constexpr int PLD = 128 + 4;         // f32 partial row pitch: conflict-free scatter

// BT tokens x CH channels a block. CH = 128: each consumer warpgroup owns
// 64 channels and takes every stage. CH = 64 (the narrow products, whose
// 128-channel tiles leave SMs idle): both own the same 64 channels and
// take alternate stages, so twice the blocks stream codes.
template <int BT, int CH>
struct Cfg {
  // k a stage: 128 (code rows of 128 bytes, 128-byte swizzle: TMA streams
  // wide rows faster), but 64 beside 256 tokens' x (64-byte swizzle).
  static constexpr int KS = BT == 256 ? 64 : 128;
  static constexpr int STEPS = KS / 16;        // k16 steps a stage
  static constexpr int X_HALF = BT * BK * 2;   // x of 64 k: BT rows of 128 bytes
  static constexpr int X_BYTES = X_HALF * (KS / BK);
  static constexpr int C_BYTES = CH * KS;      // CH rows of KS bytes
  static constexpr int STAGE = X_BYTES + C_BYTES;
  static constexpr int STAGES = 200 * 1024 / STAGE;  // a ring of ~200 KB
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = 1024 + RING + 2 * STAGES * 8;  // 1024: alignment slack
  static constexpr int NREG = BT / 2;                        // f32 accumulators a thread
  // k16 steps a fragment buffer holds: a stage's 4, but 1 beside 256
  // tokens' 128 accumulators (168 registers a thread).
  static constexpr int UNIT = BT == 256 ? 1 : 4;
  static constexpr int UNITS = STEPS / UNIT;                 // fragment buffers a stage
  static constexpr int KSTEP = CH == 128 ? 1 : 2;            // stages apart a warpgroup takes
  static constexpr int RELEASE = CH / 16;                    // warps that release a stage
  static_assert(BT * PLD * 4 <= RING, "the partial tile fits in the ring");
  static_assert(X_BYTES % 1024 == 0 && C_BYTES % 1024 == 0, "stages stay 1024-byte aligned");
};

// The ring's barriers, TMA, and wgmma's descriptors, fences and m64n64
// product live in common.cuh (one copy for this file and kernel 1).
using rdb::desc_sw128;
using rdb::fence_regs;
using rdb::mbar_arrive;
using rdb::mbar_expect_tx;
using rdb::mbar_init;
using rdb::mbar_wait;
using rdb::tma_load;
using rdb::wg_commit;
using rdb::wg_fence;
using rdb::wg_wait;

// d[64 x 128] += a[64 x 16] (registers) . b[16 x 128] (shared, K-major).
__device__ __forceinline__ void mma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[64 x 256] += a[64 x 16] (registers) . b[16 x 256] (shared, K-major).
__device__ __forceinline__ void mma_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// One wgmma over the whole token tile: N = 2 NREG tokens.
template <int NREG>
__device__ __forceinline__ void mma(float (&d)[NREG], const uint32_t (&a)[4], uint64_t desc) {
  if constexpr (NREG == 32)
    rdb::mma_rs_n64<false>(d, a, desc);
  else if constexpr (NREG == 64)
    mma_n128(d, a, desc);
  else
    mma_n256(d, a, desc);
}

// Block (token tile x, channel tile y, split z): rows m0 .. m0 + BT of x
// against channels n0 .. n0 + CH over the split's kps stages of KS k.
// Clusters are (1, 1, gridDim.z): the splits of one output tile.
template <int BT, int CH>
__global__ void __launch_bounds__(THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmq,
             const float* __restrict__ scale, const bf16* __restrict__ bias,
             bf16* __restrict__ y, int M, int N, int K, int period, int kps) {
  using C = Cfg<BT, CH>;
  constexpr int STAGES = C::STAGES, UNIT = C::UNIT, KSTEP = C::KSTEP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t xs0 = rdb::smem_addr(smem);
  const uint32_t cs0 = xs0 + STAGES * C::X_BYTES;
  const uint32_t bar0 = cs0 + STAGES * C::C_BYTES;  // full[s] at 8 s, empty[s] at 8 (STAGES + s)
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (STAGES + s); };
  const int m0 = blockIdx.x * BT, n0 = blockIdx.y * CH;
  const int kt0 = blockIdx.z * kps;
  const int nk = max(0, min((K + C::KS - 1) / C::KS, kt0 + kps) - kt0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), C::RELEASE);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer warpgroup: one thread keeps the ring full.
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmx))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tmq))
                   : "memory");
      int st = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < nk; ++kt) {
        if (kt >= STAGES) mbar_wait(empty(st), ph ^ 1);  // its previous use released
        mbar_expect_tx(full(st), C::STAGE);
        const int k = (kt0 + kt) * C::KS;
        for (int h = 0; h < C::KS / BK; ++h)
          tma_load(xs0 + st * C::X_BYTES + h * C::X_HALF, &tmx, full(st), k + h * BK, m0);
        tma_load(cs0 + st * C::C_BYTES, &tmq, full(st), k, n0);
        if (++st == STAGES) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    cluster_sync();  // the consumers' partials are in place
    cluster_sync();  // every block of the cluster has read them
    return;
  }

  // Consumer warpgroups 1 and 2 (cw 0, 1): at CH = 128 channels 64 cw ..
  // of every stage, at CH = 64 all 64 channels of stages cw, cw + 2, ...
  const int tid = threadIdx.x - 128;
  const int cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, qi = lane & 3;
  const int r0 = (CH == 128 ? 64 * cw : 0) + 16 * warp + g;  // fragment rows r0, r0 + 8
  const uint32_t s0 = scale_pair(scale, n0 + r0, N, period);
  const uint32_t s1 = scale_pair(scale, n0 + r0 + 8, N, period);
  // Chunk c of code row r sits at 16 (c ^ (r & 7)) (128-byte swizzle) or
  // 16 (c ^ ((r >> 1) & 3)) (64-byte); rows r0 and r0 + 8 share the
  // pattern. The lane's bytes of k step c are 2qi, 2qi + 1 (word qi / 2,
  // low or high half) and 8 + 2qi, 9 + 2qi.
  const int swz = C::KS == 128 ? r0 & 7 : (r0 >> 1) & 3;
  const uint32_t wof = 4 * (qi >> 1), byte = 2 * (qi & 1);

  float acc[C::NREG];
#pragma unroll
  for (int i = 0; i < C::NREG; ++i) acc[i] = 0.f;
  // Fragments of UNIT k16 steps at a time, in two buffers: one unit's
  // wgmmas run while the next unit's codes are converted.
  uint32_t a0[UNIT][4], a1[UNIT][4];

  // Unit u of stage kt: k16 steps u * UNIT ...
  auto unit = [&](uint32_t (&f)[UNIT][4], uint32_t (&other)[UNIT][4], int kt, int u) {
    const int st = kt % STAGES;
    if (u == 0) {
      mbar_wait(full(st), (kt / STAGES) & 1);
      __syncwarp();
    }
    const unsigned char* row0 = smem + (cs0 - xs0) + st * C::C_BYTES + C::KS * r0;
    const unsigned char* row1 = row0 + C::KS * 8;
    uint32_t w[UNIT][4];
#pragma unroll
    for (int s = 0; s < UNIT; ++s) {
      const int off = 16 * ((u * UNIT + s) ^ swz) + wof;
      w[s][0] = *reinterpret_cast<const uint32_t*>(row0 + off);
      w[s][1] = *reinterpret_cast<const uint32_t*>(row1 + off);
      w[s][2] = *reinterpret_cast<const uint32_t*>(row0 + off + 8);
      w[s][3] = *reinterpret_cast<const uint32_t*>(row1 + off + 8);
    }
#pragma unroll
    for (int s = 0; s < UNIT; ++s) {
      f[s][0] = dequant2(w[s][0], byte, s0);
      f[s][1] = dequant2(w[s][1], byte, s1);
      f[s][2] = dequant2(w[s][2], byte, s0);
      f[s][3] = dequant2(w[s][3], byte, s1);
      fence_regs(f[s]);
    }
    // x of step c: 64-k half c / 4, 32 bytes a step within it.
    const int h = u * UNIT / 4;
    const uint64_t db = desc_sw128(xs0 + st * C::X_BYTES + h * C::X_HALF) - 2 * 4 * h;
    wg_fence();
#pragma unroll
    for (int s = 0; s < UNIT; ++s) mma<C::NREG>(acc, f[s], db + 2 * (u * UNIT + s));
    wg_commit();
    wg_wait<1>();  // the unit before is done: its fragments (and stage) are free
#pragma unroll
    for (int s = 0; s < UNIT; ++s) fence_regs(other[s]);
    if (u == 0 && kt >= KSTEP) {  // this warpgroup's stage before is done
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((kt - KSTEP) % STAGES));
    }
  };
  const int first = CH == 128 ? 0 : cw;
  if constexpr (C::UNITS % 2 == 0) {
    for (int kt = first; kt < nk; kt += KSTEP)
#pragma unroll
      for (int u = 0; u < C::UNITS; u += 2) {
        unit(a0, a1, kt, u);
        unit(a1, a0, kt, u + 1);
      }
  } else {
    for (int kt = first; kt < nk; kt += 2 * KSTEP) {
      unit(a0, a1, kt, 0);
      if (kt + KSTEP < nk) unit(a1, a0, kt + KSTEP, 0);
    }
  }
  wg_wait<0>();
#pragma unroll
  for (int s = 0; s < UNIT; ++s) {
    fence_regs(a0[s]);
    fence_regs(a1[s]);
  }
  fence_regs(acc);

  // The partial tile [BT tokens][128 columns] f32 over the ring, once both
  // consumer warpgroups are done with it; at CH = 64 warpgroup cw's sums
  // are columns 64 cw ...
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float* part = reinterpret_cast<float*>(smem);
  const int col0 = (CH == 128 ? 0 : 64 * cw) + r0;
#pragma unroll
  for (int i = 0; i < C::NREG; ++i) {
    const int t = 8 * (i >> 2) + 2 * qi + (i & 1);
    part[t * PLD + col0 + 8 * ((i >> 1) & 1)] = acc[i];
  }
  cluster_sync();

  // Block r of the S splits sums rows r ceil(BT / S) .. of every block's
  // partial in rank order (at CH = 64 both warpgroups' halves), adds the
  // bias and writes y.
  const int S = static_cast<int>(gridDim.z);
  const int rows = (BT + S - 1) / S;
  const int rank = static_cast<int>(cluster_rank());
  const uint32_t pbase = rdb::smem_addr(part);
  for (int it = tid; it < rows * (CH / 4); it += 256) {
    const int t = rank * rows + it / (CH / 4);
    const int c4 = 4 * (it % (CH / 4));
    const int m = m0 + t, n = n0 + c4;
    if (t >= BT || m >= M || n >= N) continue;
    const uint32_t at = pbase + 4 * (t * PLD + c4);
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < S; ++q) {
      const uint32_t peer = cluster_addr(at, q);
      float4 p = ld_cluster4(peer);
      if (CH == 64) {
        const float4 h = ld_cluster4(peer + 4 * 64);
        p.x += h.x;
        p.y += h.y;
        p.z += h.z;
        p.w += h.w;
      }
      v[0] += p.x;
      v[1] += p.y;
      v[2] += p.z;
      v[3] += p.w;
    }
    bf16* out = y + static_cast<size_t>(m) * N + n;
    if ((N & 3) == 0) {  // n + 3 < N too
      if (bias != nullptr)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] += __bfloat162float(bias[n + e]);
      *reinterpret_cast<uint2*>(out) =
          make_uint2(rdb::pack_bf16(v[0], v[1]), rdb::pack_bf16(v[2], v[3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N)
          out[e] = __float2bfloat16(v[e] + (bias != nullptr ? __bfloat162float(bias[n + e]) : 0.f));
    }
  }
  cluster_sync();  // no block leaves while another reads its partial
}

// A 2-D map of rows x inner elements (row pitch ``pitch`` bytes), boxes of
// box_rows x box_inner, out-of-bounds elements read as zeros.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType dtype, const void* base, int inner,
                int rows, size_t pitch, int box_inner, int box_rows, CUtensorMapSwizzle swz) {
  rdb::EncodeTiled encode = rdb::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(pitch)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// How many clusters of ``split`` blocks the card runs at once (cached; a
// size it cannot schedule counts as none).
template <int BT, int CH>
int max_clusters(int split) {
  static int known[MAX_CLUSTER + 1] = {};
  if (known[split] == 0) {
    cudaLaunchAttribute at[1];
    const cudaLaunchConfig_t cfg =
        cluster_config(dim3(1, 1, split), THREADS, Cfg<BT, CH>::SMEM, nullptr, at);
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, wgmma_kernel<BT, CH>, &cfg) != cudaSuccess) {
      cudaGetLastError();
      n = 0;
    }
    known[split] = n > 0 ? n : -1;
  }
  return std::max(known[split], 0);
}

template <int BT, int CH>
int launch(const void* x, const void* q, const void* scale, const void* bias, void* y, int M,
           int N, int K, int period, cudaStream_t st) {
  using C = Cfg<BT, CH>;
  auto kern = wgmma_kernel<BT, CH>;
  CUtensorMap tmx, tmq;
  if (!tensor_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, 2 * static_cast<size_t>(K),
                  BK, BT, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tmq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, K, N, static_cast<size_t>(K), C::KS,
                  CH, C::KS == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = rdb::raise_smem_limit(kern, C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tt = (M + BT - 1) / BT, ct = (N + CH - 1) / CH, nk = (K + C::KS - 1) / C::KS;
  if (ct > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // Split K over the largest cluster whose blocks all run in one wave (the
  // card holds that many clusters of that size at once) while each split
  // keeps at least 256 k.
  int split = 1;
  for (int s = 2; s <= MAX_CLUSTER && s * tt * ct <= SMS && nk * C::KS >= 256 * s; ++s)
    if (max_clusters<BT, CH>(s) >= tt * ct) split = s;
  const int kps = (nk + split - 1) / split;
  cudaLaunchAttribute at[1];
  const cudaLaunchConfig_t cfg = cluster_config(dim3(tt, ct, split), THREADS, C::SMEM, st, at);
  err = cudaLaunchKernelEx(&cfg, kern, tmx, tmq, static_cast<const float*>(scale),
                           static_cast<const bf16*>(bias), static_cast<bf16*>(y), M, N, K,
                           period, kps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// 128-channel tiles where they alone fill most of the card; else 64.
template <int BT>
int launch_bt(const void* x, const void* q, const void* scale, const void* bias, void* y,
              int M, int N, int K, int period, cudaStream_t st) {
  const int tiles = (M + BT - 1) / BT * ((N + 127) / 128);
  if (4 * tiles >= 3 * SMS)
    return launch<BT, 128>(x, q, scale, bias, y, M, N, K, period, st);
  return launch<BT, 64>(x, q, scale, bias, y, M, N, K, period, st);
}

}  // namespace wg


}  // namespace

extern "C" int rdb_int8_weight_matmul(const void* x, const void* q, const void* scale,
                                      const void* bias, void* y, int M, int N, int K,
                                      int period, int act_bf16, int w_bf16, void* ws,
                                      long long ws_len, void* cnt, int cnt_len,
                                      void* stream, int* body) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || period <= 0 || N % period != 0 ||
      (act_bf16 && !w_bf16) || body == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (act_bf16) {
    *body = M > 16 ? PREFILL : DECODE;
    if (M <= 16)
      return launch_stream<bf16, 1>(x, q, scale, bias, y, M, N, K, period, nullptr, 0, nullptr,
                                    0, st);
    if (M <= 64) return wg::launch_bt<64>(x, q, scale, bias, y, M, N, K, period, st);
    if (M <= 128) return wg::launch_bt<128>(x, q, scale, bias, y, M, N, K, period, st);
    return wg::launch_bt<256>(x, q, scale, bias, y, M, N, K, period, st);
  }
  if (w_bf16) {
    *body = SPLIT3;
    if (M <= 16)
      return launch_stream<float, 1>(x, q, scale, bias, y, M, N, K, period, ws, ws_len, cnt,
                                     cnt_len, st);
    if (M <= 32)
      return launch_stream<float, 2>(x, q, scale, bias, y, M, N, K, period, ws, ws_len, cnt,
                                     cnt_len, st);
    return launch_stream<float, 4>(x, q, scale, bias, y, M, N, K, period, ws, ws_len, cnt,
                                   cnt_len, st);
  }
  *body = FMA;
  const dim3 tiles((N + FmaTile::BN - 1) / FmaTile::BN, (M + FmaTile::BM - 1) / FmaTile::BM);
  return launch(fma_kernel, tiles, 3 * SMS, FmaTile::SMEM, x, q, scale, bias, y, M, N, K,
                period, ws, ws_len, cnt, cnt_len, st);
}
