// Shared helpers for the port's attention kernels (sm_90a, plain C ABI).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace rdb {

// The JAX kernels' "minus infinity": finite, so exp(NEG_INF - NEG_INF) == 1
// exactly as in the reference's online softmax.
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// int8 KV codes (|x| <= 127): exact in f32 and in bf16, so widening them
// here is the reference's cast of the codes to the query type.
template <> __device__ __forceinline__ float to_f<int8_t>(int8_t x) {
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, like XLA's convert
}

// p is cast to the operand type before the PV product in the JAX kernels
// (``p.astype(v.dtype)``); this reproduces that rounding in f32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Load VEC = 16 / sizeof(T) consecutive elements (one 16-byte transaction,
// global or shared) and widen them to f32. ``src`` must be 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = to_f<T>(e[i]);
}

// Two consecutive elements (4, 8 or 2 bytes, naturally aligned) widened.
template <typename T> __device__ __forceinline__ float2 load2(const void* p);
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(const void* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <> __device__ __forceinline__ float2 load2<float>(const void* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load2<int8_t>(const void* p) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(c.x), static_cast<float>(c.y));
}

// --- asynchronous copies (cp.async, sm_80+) --------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; when !pred nothing is read and the 16 bytes
// are zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// Wait until at most ``n`` of this thread's groups are pending (n < 4).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<3>(); break;
  }
}

// --- tensor cores (mma.sync, sm_80+) ---------------------------------------
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&h);
}

// Byte offset of 16-byte chunk c of row r in a [rows][HP] bf16 tile, the
// chunk index XOR-ed with r % 8: the 8 rows one ldmatrix reads hit 8
// different bank groups. A row holds HP / 8 (8 or 16) chunks, so the XOR
// stays inside the row. Kernel 1's tiles and its backward's.
template <int HP>
__device__ __forceinline__ int swz(int r, int c) {
  return r * (HP * 2) + ((c ^ (r & 7)) << 4);
}

// ex2.approx: the exp the fast __expf is built on, for scores already in
// log2 units.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two int8 codes as a bf16 pair (exact: |code| <= 127).
__device__ __forceinline__ uint32_t codes_bf16(int8_t lo, int8_t hi) {
  return pack_bf16(static_cast<float>(lo), static_cast<float>(hi));
}

// The online-softmax KV scan of one decode block — one (slot, KV head,
// split) and its R = Tq * G window rows, rows ordered (t, g) — shared by
// the slab and the paged decode kernels, as the JAX package shares
// ``_scan_tile`` between ``_decode_attention`` and
// ``_paged_decode_attention``: one body, and one combine, is what keeps the
// two bit-identical on equal data. The kernels differ only in where each
// KV tile's rows live and which (row, key) pairs are valid.
//
// Softmax rule, as _scan_tile: masked scores become NEG_INF before the
// running max, p = exp(s - m) is NOT zeroed for masked keys (it underflows
// to 0 once any key is attended; a row with no attended key averages V,
// like the reference), p rounds to T before PV, l == 0 finalizes to 0.
//
// T is the query/output type, TK the K/V element type: T itself, or int8
// codes (the int8 KV cache, _scan_tile's ks_ref/vs_ref branch). With int8
// codes each key j carries f32 scales ksc[j], vsc[j]; the score is
// (q . codes) * scale * ksc[j], the running sum takes the unscaled p, and
// the probability stored for PV is round_to<T>(p * vsc[j]) — the
// reference's order, so vsc is never folded into the V tile.
//
// Split-S (flash-decoding). The logical positions of a slot are cut into
// splits of SPLIT = 128 (two 64-key tiles); each split is its own block,
// so a decode step has K x B x splits blocks in flight instead of K x B.
// A split block scans its live tiles with the online softmax and, unless
// it is its slot's only live split, leaves (m, l, acc) in an f32
// workspace; the last live split of a (slot, KV head) to arrive (an
// atomic counter, reset by that block for the next launch) merges them,
// each weighted by exp(m_s - M), M the largest m_s, in split order. A
// split or tile that no window row attends is not read at all: its
// contribution after the merge would be exp(NEG_INF - M) = 0 for every
// row that attends a key elsewhere (callers scan everything when some row
// attends nothing, so that row still gets the mean of V). Skipping is
// therefore exact, and both kernels skip the same tiles on equal data.
//
// Tiles stay in their element type in shared memory (bf16, f32 or int8
// codes), 16-byte chunks XOR-swizzled against bank conflicts, and are
// widened where they are read. The query rows and every tile of a split
// are issued at once with cp.async (K0, V0, K1, V1 as separate groups),
// so tile 1 and tile 0's V land while tile 0's scores are computed.
//
// Per tile, three barriers: scores, the online-softmax update (one warp
// per row), then PV, added to acc as acc * alpha + p @ v. With a bf16
// query (the serving path) both products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate; the R rows padded to 16):
// each warp scores 8 keys and owns H / 8 output dims, its fragments
// loaded before its products; int8 codes are widened to bf16 (exact) as
// their fragments are read. With an f32 query the products are f32 FMAs
// (TF32 would not meet the f32 tolerance): four threads per key for the
// scores, one per (row, dim pair) for PV.
//
// Head dims. The body is H = 64 or 128 wide (four warps of NTW = 1 or 2
// output n-tiles each); the real head dim HV, a multiple of 16 (16 .. 64
// on the 64-wide body, 80 .. 128 on the 128-wide one), is a template
// argument too. Below H it rides the padded body: K/V tiles and query
// rows are H wide in shared memory, their columns past HV zero-filled by
// the same cp.async (src-size 0, nothing read from device memory), so
// every dot product and every PV column past HV adds exact zeros, and
// only the HV real columns are written out or merged. Device-memory bytes
// stay HV's; the shared memory and the products are H's (at HV = 16,
// four times the work of a 16-wide layout). At HV == H the code is the
// unpadded body's: HV is a constant, not a runtime value (a runtime HV
// took 16 more registers in one instantiation and cost 5-30% at 64 and
// 128 on an H100).
// The slab and paged kernels share it, so they stay bit-identical at
// every head dim.
//
// SPLIT is fixed at 128. Splits of 64 (twice the blocks, each with one
// tile) measured slower at the main shape on an H100 (700 W): slab decode
// 0.0211 against 0.0163 ms (a compile-time variant since removed;
// PERF.md). Callers size the merge's workspace for it, and the launch
// functions check the sizes they are given.

template <typename T, typename TK, int H, int HV = H>
struct DecodeScan {
  static constexpr int BS = 64;            // keys per KV tile
  static constexpr int SPLIT = 128;        // logical positions per split
  static constexpr int TILES = SPLIT / BS; // tiles per split, one buffer each
  static constexpr int THREADS = 256;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int SSTR = BS + 8;      // score row stride (floats)
  static constexpr int PARTS = THREADS / BS;       // threads per key (FMA scores)
  static constexpr int CH = 16 / sizeof(TK);       // elements per 16 B chunk
  static constexpr int NCH = H / CH;               // chunks per K/V row
  static constexpr int CPT = NCH / PARTS;          // chunks per thread
  static constexpr int ROWB = H * sizeof(TK);      // bytes per K/V row
  static constexpr int VEC_Q = 16 / sizeof(T);
  static constexpr bool QUANT = std::is_same<TK, int8_t>::value;
  static constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int NTW = H / 8 / WARPS;        // output n-tiles per warp (TC)
  static_assert(QUANT || std::is_same<TK, T>::value,
                "K/V are the query type or int8 codes");
  static_assert(NCH % PARTS == 0 && (NCH % 8 == 0 || NCH == 4),
                "head dim and element size give 4 or a multiple of 8 chunks");
  static_assert(!TC || NTW == 1 || NTW == 2, "padded head dim 64 or 128");
  static_assert(HV % 16 == 0 && HV <= H && (H == 64 || HV > 64),
                "real head dim: a multiple of 16 in 16..64 (H 64) or 80..128 (H 128)");
  static_assert(TILES == 2, "a split holds two tiles");

  // Physical chunk of logical chunk c in row j. Tensor-core path: XOR with
  // j % 8, so the 8 rows an ldmatrix reads hit 8 bank groups. FMA path:
  // the two keys a quarter-warp reads together land in different halves
  // of the 128-byte bank window.
  __device__ static __forceinline__ int phys(int c, int j) {
    if constexpr (TC) return c ^ (j & (NCH >= 8 ? 7 : NCH - 1));
    return NCH % 8 == 0 ? (c ^ ((j & 1) << 2)) : c;
  }
  __host__ __device__ static int padded_rows(int R) { return (R + 15) / 16 * 16; }
  // Bytes of the query rows: f32 [R][H], or bf16 [16 m-tiles][H] swizzled.
  __host__ __device__ static int q_bytes(int R) {
    const int a = 4 * R * H, b = 2 * padded_rows(R) * H;
    return a > b ? a : b;
  }

  // Shared-memory bytes of a block with R window rows, plus ``extra``
  // bytes of the caller's own (liveness flags), kept after everything.
  static size_t smem_bytes(int R, size_t extra) {
    return static_cast<size_t>(2) * TILES * BS * ROWB + q_bytes(R) +
           sizeof(float) * (static_cast<size_t>(R) * H + static_cast<size_t>(R) * SSTR +
                            2 * TILES * BS + 3 * R) +
           sizeof(int) + 16 + extra;
  }

  // Whether the merge's scratch ([nsplit][R] x 2 + [R] floats) fits in
  // the K/V tiles, where it is kept, and the caller's workspace (ws_len
  // floats) and counters (cnt_len) hold B x K (slot, KV head)s of
  // partials HV wide.
  static bool merge_fits(int R, int nsplit, int B, int K, long long ws_len, int cnt_len) {
    const long long need = static_cast<long long>(B) * K * nsplit * R * (HV + 2);
    return static_cast<size_t>(2 * nsplit + 1) * R * sizeof(float) <=
               static_cast<size_t>(2) * TILES * BS * ROWB &&
           need <= ws_len && static_cast<long long>(B) * K <= cnt_len;
  }

  unsigned char* kb;  // [TILES][BS][ROWB] K tiles (element type, swizzled)
  unsigned char* vb;  // [TILES][BS][ROWB] V tiles
  unsigned char* qs;  // query rows (see q_bytes)
  float* acc;         // [R][H]
  float* ss;          // [R][SSTR] scores, then probabilities
  float* ksc;         // [TILES][BS] K scales (int8 codes)
  float* vsc;         // [TILES][BS] V scales
  float* m_s;         // [R] running max
  float* l_s;         // [R] running sum
  float* a_s;         // [R] this tile's rescale factor
  int* last;          // the merge flag
  unsigned char* extra;
  int R, G;

  __device__ DecodeScan(unsigned char* smem, int R_, int G_) : R(R_), G(G_) {
    kb = smem;
    vb = kb + TILES * BS * ROWB;
    qs = vb + TILES * BS * ROWB;
    acc = reinterpret_cast<float*>(qs + q_bytes(R));
    ss = acc + R * H;
    ksc = ss + R * SSTR;
    vsc = ksc + TILES * BS;
    m_s = vsc + TILES * BS;
    l_s = m_s + R;
    a_s = l_s + R;
    last = reinterpret_cast<int*>(a_s + R);
    // 16-byte aligned: callers store 16-byte chunks there.
    extra = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(last + 1) + 15) & ~static_cast<uintptr_t>(15));
  }

  // Issue half ``part`` of tile ``i`` of this split (0: K and its scales,
  // 1: V and its scales) as one cp.async group: keys j < n at
  // src + j * rs (HV elements each), keys j >= n and the columns past HV
  // zero-filled; with int8 codes key j's scale at sc[j * sst]. Callers
  // issue K0, V0, K1, V1.
  __device__ void issue(int i, int part, const TK* __restrict__ src, size_t rs,
                        const float* __restrict__ sc, size_t sst, int n) {
    unsigned char* dst = (part ? vb : kb) + i * BS * ROWB;
    constexpr int nch = HV / CH;  // chunks of a row that hold data
    for (int e = threadIdx.x; e < BS * NCH; e += THREADS) {
      const int j = e / NCH, c = e % NCH;
      const bool in = j < n && c < nch;
      cp_async16(dst + j * ROWB + phys(c, j) * 16,
                 in ? src + static_cast<size_t>(j) * rs + c * CH : src, in);
    }
    if constexpr (QUANT) {
      float* sd = (part ? vsc : ksc) + i * BS;
      for (int j = threadIdx.x; j < BS; j += THREADS)
        cp_async4(sd + j, j < n ? sc + static_cast<size_t>(j) * sst : sc, j < n);
    }
    cp_async_commit();
  }

  // Query rows (t, g) <- q[b, t, kvh * G + g, :] (q [B, Tq, N, HV]), as
  // one cp.async group issued before the tiles': f32 rows, or bf16 rows
  // in 16-row m-tiles, ldmatrix-swizzled, pad rows and columns zero.
  __device__ void load_q(const T* __restrict__ q, int b, int Tq, int N, int kvh) {
    constexpr int QCH = H / VEC_Q;  // 16-byte chunks per row
    const int rows = TC ? padded_rows(R) : R;
    constexpr int qch = HV / VEC_Q;  // ... that hold data
    for (int e = threadIdx.x; e < rows * QCH; e += THREADS) {
      const int r = e / QCH, c = e % QCH;
      const bool in = r < R && c < qch;
      const T* src = q + ((static_cast<size_t>(b) * Tq + (in ? r / G : 0)) * N + kvh * G +
                          (in ? r % G : 0)) * HV + (in ? c * VEC_Q : 0);
      unsigned char* dst = TC ? qs + r * H * 2 + ((c ^ (r & 7)) << 4)
                              : qs + (r * H + c * VEC_Q) * sizeof(T);
      cp_async16(dst, src, in);
    }
    cp_async_commit();
  }

  // The running state starts at (m, l, acc) = (NEG_INF, 0, 0).
  __device__ void begin() {
    for (int e = threadIdx.x; e < R * H; e += THREADS) acc[e] = 0.f;
    for (int r = threadIdx.x; r < R; r += THREADS) {
      m_s[r] = NEG_INF;
      l_s[r] = 0.f;
    }
  }

  // The score of window row r (window position t) and key j of a tile.
  __device__ __forceinline__ float score(float dot, unsigned bits, int t, int j, int n,
                                         const float* kst, float scale) const {
    if (j >= n) return -INFINITY;  // ragged tail: not a key at all
    if (!((bits >> t) & 1u)) return NEG_INF;
    if constexpr (QUANT) return dot * scale * kst[j];
    return dot * scale;
  }

  // Tile ``i`` of the split's ``nt`` live ones (buffer i, ``n`` keys):
  // scores, the online-softmax update, then acc = acc * alpha + p @ v.
  // Groups were issued K0, V0, K1, V1: tile 1 and tile 0's V land while
  // tile 0's scores are computed. ``rows_valid(j)`` is a bit mask over
  // window positions t of the rows that attend key j.
  template <typename RowsValid>
  __device__ void tile(int i, int nt, int n, RowsValid rows_valid, float scale) {
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const unsigned char* kt = kb + i * BS * ROWB;
    const unsigned char* vt = vb + i * BS * ROWB;
    const float* kst = ksc + i * BS;
    const float* vst = vsc + i * BS;

    cp_async_wait_dyn(2 * (nt - i) - 1);  // q and this tile's K group landed
    __syncthreads();                      // ... for every thread; ss free

    if constexpr (TC) {
      // Scores: warp w takes keys 8w .. 8w + 7 for every 16-row m-tile.
      // The tile's K fragments are loaded once, all before the products.
      constexpr int KS = H / 16;
      const int j0 = 8 * warp + 2 * (lane % 4);  // this lane's two keys
      const unsigned bits0 = j0 < n ? rows_valid(j0) : 0u;
      const unsigned bits1 = j0 + 1 < n ? rows_valid(j0 + 1) : 0u;
      uint32_t kf[KS][2];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        if constexpr (QUANT) {
          const int key = 8 * warp + lane / 4;
          const int8_t* row = reinterpret_cast<const int8_t*>(
              kt + key * ROWB + phys(kk, key) * 16) + 2 * (lane % 4);
          kf[kk][0] = codes_bf16(row[0], row[1]);
          kf[kk][1] = codes_bf16(row[8], row[9]);
        } else {
          const int key = 8 * warp + lane % 8;
          ldsm_x2(kf[kk], smem_addr(kt + key * ROWB + phys(kk * 2 + (lane / 8) % 2, key) * 16));
        }
      }
      for (int mt = 0; mt * 16 < R; ++mt) {
        uint32_t qa[KS][4];
        const int qr = mt * 16 + lane % 16;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          const int qc = kk * 2 + lane / 16;
          ldsm_x4(qa[kk], smem_addr(qs + qr * H * 2 + ((qc ^ (qr & 7)) << 4)));
        }
        // Two accumulators (even and odd k-steps) halve the dependent chain.
        float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) mma_bf16(c[kk % 2], qa[kk], kf[kk][0], kf[kk][1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + lane / 4 + 8 * h;
          if (r < R) {
            const int t = r / G;
            ss[r * SSTR + j0] = score(c[0][2 * h] + c[1][2 * h], bits0, t, j0, n, kst, scale);
            ss[r * SSTR + j0 + 1] =
                score(c[0][2 * h + 1] + c[1][2 * h + 1], bits1, t, j0 + 1, n, kst, scale);
          }
        }
      }
    } else {
      // Scores: key j = tid / PARTS; this thread holds its chunks
      // part + PARTS * c in registers and takes every row's dot.
      const int j = tid / PARTS, part = tid % PARTS;
      const float* qf = reinterpret_cast<const float*>(qs);
      {
        float kr[CPT * CH];
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          load_vec<TK>(reinterpret_cast<const TK*>(kt + j * ROWB + phys(part + PARTS * c, j) * 16),
                       kr + c * CH);
        const unsigned bits = j < n ? rows_valid(j) : 0u;
        int t = 0, g = 0;
        for (int r = 0; r < R; ++r) {
          const float* qr = qf + r * H;
          float dot = 0.f;
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            const float4* q4 = reinterpret_cast<const float4*>(qr + (part + PARTS * c) * CH);
#pragma unroll
            for (int u = 0; u < CH / 4; ++u) {
              const float4 qv = q4[u];
              dot += qv.x * kr[c * CH + 4 * u] + qv.y * kr[c * CH + 4 * u + 1] +
                     qv.z * kr[c * CH + 4 * u + 2] + qv.w * kr[c * CH + 4 * u + 3];
            }
          }
          dot += __shfl_xor_sync(0xffffffffu, dot, 1);
          dot += __shfl_xor_sync(0xffffffffu, dot, 2);
          if (part == 0) ss[r * SSTR + j] = score(dot, bits, t, j, n, kst, scale);
          if (++g == G) { g = 0; ++t; }
        }
      }
    }
    cp_async_wait_dyn(2 * (nt - i) - 2);  // this tile's V group landed
    __syncthreads();

    // Online-softmax update: one warp per row, two keys per lane.
    for (int r = warp; r < R; r += WARPS) {
      float x[2];
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        x[u] = ss[r * SSTR + lane + 32 * u];
        mx = fmaxf(mx, x[u]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float p = expf(x[u] - m_cur);
        sum += p;
        if constexpr (QUANT) {
          ss[r * SSTR + lane + 32 * u] = round_to<T>(p * vst[lane + 32 * u]);
        } else {
          ss[r * SSTR + lane + 32 * u] = round_to<T>(p);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_cur;
      }
    }
    __syncthreads();

    if constexpr (TC) {
      // PV: warp w owns output n-tiles NTW w .. NTW w + NTW - 1. P (already
      // rounded to bf16, so packing it is exact) is read from ss. The V
      // fragments are loaded once, all before the products.
      constexpr int KJ = BS / 16;
      uint32_t vf[KJ][NTW][2];
#pragma unroll
      for (int kj = 0; kj < KJ; ++kj) {
        if constexpr (QUANT) {
          const int k = kj * 16 + 2 * (lane % 4);
#pragma unroll
          for (int u = 0; u < NTW; ++u) {
            const int d = (NTW * warp + u) * 8 + lane / 4;
            const int dc = d / CH, dw = d % CH;
            auto code = [&](int key) {
              return reinterpret_cast<const int8_t*>(vt + key * ROWB + phys(dc, key) * 16)[dw];
            };
            vf[kj][u][0] = codes_bf16(code(k), code(k + 1));
            vf[kj][u][1] = codes_bf16(code(k + 8), code(k + 9));
          }
        } else {
          const int key = kj * 16 + lane % 8 + ((lane / 8) % 2) * 8;
          if constexpr (NTW == 2) {
            uint32_t bf[4];
            ldsm_x4_t(bf, smem_addr(vt + key * ROWB + phys(2 * warp + lane / 16, key) * 16));
            vf[kj][0][0] = bf[0];
            vf[kj][0][1] = bf[1];
            vf[kj][NTW - 1][0] = bf[2];
            vf[kj][NTW - 1][1] = bf[3];
          } else {
            ldsm_x2_t(vf[kj][0], smem_addr(vt + key * ROWB + phys(warp, key) * 16));
          }
        }
      }
      for (int mt = 0; mt * 16 < R; ++mt) {
        const int r0 = mt * 16 + lane / 4, r1 = r0 + 8;
        float c[2][NTW][4];  // even and odd k-steps
#pragma unroll
        for (int u = 0; u < NTW; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[0][u][e] = c[1][u][e] = 0.f;
#pragma unroll
        for (int kj = 0; kj < KJ; ++kj) {
          const int k = kj * 16 + 2 * (lane % 4);
          uint32_t a[4] = {0u, 0u, 0u, 0u};
          if (r0 < R) {
            const float2 x = *reinterpret_cast<const float2*>(ss + r0 * SSTR + k);
            const float2 y = *reinterpret_cast<const float2*>(ss + r0 * SSTR + k + 8);
            a[0] = pack_bf16(x.x, x.y);
            a[2] = pack_bf16(y.x, y.y);
          }
          if (r1 < R) {
            const float2 x = *reinterpret_cast<const float2*>(ss + r1 * SSTR + k);
            const float2 y = *reinterpret_cast<const float2*>(ss + r1 * SSTR + k + 8);
            a[1] = pack_bf16(x.x, x.y);
            a[3] = pack_bf16(y.x, y.y);
          }
#pragma unroll
          for (int u = 0; u < NTW; ++u) mma_bf16(c[kj % 2][u], a, vf[kj][u][0], vf[kj][u][1]);
        }
#pragma unroll
        for (int u = 0; u < NTW; ++u) {
          const int d = (NTW * warp + u) * 8 + 2 * (lane % 4);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = h ? r1 : r0;
            if (r < R) {
              const float alpha = a_s[r];
              float2* ap = reinterpret_cast<float2*>(acc + r * H + d);
              const float2 old = *ap;
              *ap = make_float2(old.x * alpha + (c[0][u][2 * h] + c[1][u][2 * h]),
                                old.y * alpha + (c[0][u][2 * h + 1] + c[1][u][2 * h + 1]));
            }
          }
        }
      }
    } else {
      // acc = acc * alpha + p @ v; each thread owns (row, dim pair) cells.
      // Keys past n hold p = 0 and zero-filled V.
      for (int e = tid; e < R * (H / 2); e += THREADS) {
        const int r = e / (H / 2), d = 2 * (e % (H / 2));
        const int c = d / CH, w = (d % CH) * static_cast<int>(sizeof(TK));
        const int off0 = phys(c, 0) * 16 + w;  // even keys
        const int off1 = phys(c, 1) * 16 + w;  // odd keys
        const float* pr = ss + r * SSTR;
        float px = 0.f, py = 0.f;
        for (int j = 0; j < n; j += 2) {
          const float2 p2 = *reinterpret_cast<const float2*>(pr + j);
          const float2 v0 = load2<TK>(vt + j * ROWB + off0);
          const float2 v1 = load2<TK>(vt + (j + 1) * ROWB + off1);
          px += p2.x * v0.x;
          py += p2.x * v0.y;
          px += p2.y * v1.x;
          py += p2.y * v1.y;
        }
        const float alpha = a_s[r];
        acc[r * H + d] = acc[r * H + d] * alpha + px;
        acc[r * H + d + 1] = acc[r * H + d + 1] * alpha + py;
      }
    }
  }

  // out[b, t, kvh * G + g, :] <- acc / l (0 where l == 0), or the merge of
  // this (slot, KV head)'s ``n_live`` live splits when there are several:
  // partials go to ws[((b * K + kvh) * nsplit + split) * R * (HV + 2)] as
  // [m R][l R][acc R HV]; cnt[b * K + kvh] counts arrivals. ``split_live(s)``
  // must name the same splits in every block of the (slot, KV head). Only
  // the HV real columns of acc are written or merged.
  template <typename SplitLive>
  __device__ void finish(T* __restrict__ out, float* __restrict__ ws,
                         int* __restrict__ cnt, int b, int Tq, int N, int K,
                         int kvh, int split, int nsplit, int n_live,
                         SplitLive split_live) {
    const int tid = threadIdx.x;
    __syncthreads();
    const int RV = R * HV;  // real cells
    if (n_live == 1) {
      for (int e = tid; e < RV; e += THREADS) {
        const int r = e / HV, d = e % HV;
        const int t = r / G, g = r % G;
        const float l = l_s[r];
        out[((static_cast<size_t>(b) * Tq + t) * N + kvh * G + g) * HV + d] =
            from_f<T>(acc[r * H + d] / (l == 0.f ? 1.f : l));
      }
      return;
    }
    const size_t slot = static_cast<size_t>(b) * K + kvh;
    const size_t stride = static_cast<size_t>(R) * (HV + 2);
    float* part = ws + (slot * nsplit + split) * stride;
    for (int r = tid; r < R; r += THREADS) {
      part[r] = m_s[r];
      part[R + r] = l_s[r];
    }
    for (int e = tid; e < RV; e += THREADS) part[2 * R + e] = acc[(e / HV) * H + e % HV];
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(cnt + slot, 1) == n_live - 1;
    __syncthreads();
    if (!*last) return;
    __threadfence();
    // The merge, in two rounds of loads: every split's (m, l) into shared
    // memory (the K/V tiles are free now), then per row the largest m_s,
    // the split weights exp(m_s - M) and L; then per cell the weighted
    // accs, both cells of a thread at once. Loads are unconditional (a
    // void split's slot holds stale numbers, never used) so that they are
    // in flight together.
    const float* base = ws + slot * nsplit * stride;
    float* wts = reinterpret_cast<float*>(kb);  // [nsplit][R]: m, then weights
    float* lsp = wts + nsplit * R;              // [nsplit][R]: l
    float* Ls = lsp + nsplit * R;               // [R]
    for (int e = tid; e < nsplit * R; e += THREADS) {
      const int s = e / R, r = e % R;
      wts[e] = __ldcg(base + s * stride + r);
      lsp[e] = __ldcg(base + s * stride + R + r);
    }
    __syncthreads();
    for (int r = tid; r < R; r += THREADS) {
      float M = -INFINITY;
      for (int s = 0; s < nsplit; ++s)
        if (split_live(s)) M = fmaxf(M, wts[s * R + r]);
      float L = 0.f;
      for (int s = 0; s < nsplit; ++s) {
        float w = 0.f;
        if (split_live(s)) {
          w = expf(wts[s * R + r] - M);
          L += w * lsp[s * R + r];
        }
        wts[s * R + r] = w;
      }
      Ls[r] = L;
    }
    __syncthreads();
    for (int e0 = tid; e0 < RV; e0 += 2 * THREADS) {
      const int e1 = e0 + THREADS;
      const bool two = e1 < RV;
      const int r0 = e0 / HV, r1 = (two ? e1 : e0) / HV;
      float A0 = 0.f, A1 = 0.f;
#pragma unroll 4
      for (int s = 0; s < nsplit; ++s) {
        const float* p = base + s * stride + 2 * R;
        const float a0 = __ldcg(p + e0), a1 = __ldcg(p + (two ? e1 : e0));
        if (split_live(s)) {
          A0 += wts[s * R + r0] * a0;
          A1 += wts[s * R + r1] * a1;
        }
      }
      const float As[2] = {A0, A1};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (u == 1 && !two) break;
        const int e = u ? e1 : e0, r = u ? r1 : r0, d = e % HV;
        const float L = Ls[r];
        const int t = r / G, g = r % G;
        out[((static_cast<size_t>(b) * Tq + t) * N + kvh * G + g) * HV + d] =
            from_f<T>(As[u] / (L == 0.f ? 1.f : L));
      }
    }
    if (tid == 0) cnt[slot] = 0;  // ready for the next launch
  }
};

// Raise a kernel's dynamic shared-memory limit to at least `smem`; never
// lower it. A CUDA graph's launch of the kernel runs under the limit in
// force when it is replayed, so a later launch at a smaller shape (another
// engine's, on another thread) must not shrink it below what a captured
// shape needs. Callers hold the host launch lock.
template <typename Kern>
inline cudaError_t raise_smem_limit(Kern kern, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (static_cast<size_t>(attr.maxDynamicSharedSizeBytes) >= smem) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace rdb

extern "C" const char* rdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
