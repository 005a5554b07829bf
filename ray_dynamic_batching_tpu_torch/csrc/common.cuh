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

// Load VEC = 16 / sizeof(T) consecutive elements (one 16-byte transaction)
// and widen them to f32. ``src`` must be 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float* dst) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = to_f<T>(e[i]);
}

// The online-softmax KV scan of one decode block — one (slot, KV head) and
// its R = Tq * G window rows, rows ordered (t, g) — shared by the slab and
// the paged decode kernels, as the JAX package shares ``_scan_tile``
// between ``_decode_attention`` and ``_paged_decode_attention``: one body
// is what keeps the two numerically identical. The kernels differ only in
// where each KV tile's rows live and which (row, key) pairs are valid.
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
// reference's order, so vsc is never folded into the V tile (that would
// move the rounding point).
//
// Shared memory (f32): q [R][H+1], K tile [BS][H+1], V tile [BS][H],
// scores [R][BS], acc [R][H], m, l, alpha [R] each, and the tile's key
// scales [BS] x 2 (unused for T-typed K/V); the padded rows keep the
// score loop's reads conflict-free. q and each tile are staged with
// 16-byte loads — 16 / sizeof(T) query elements, 16 / sizeof(TK) K/V
// elements per load; the whole block must call every member.
template <typename T, typename TK, int H>
struct DecodeScan {
  static constexpr int BS = 64;          // keys per KV tile
  static constexpr int THREADS = 256;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int HP = H + 1;
  static constexpr int VEC_Q = 16 / sizeof(T);
  static constexpr int VEC_KV = 16 / sizeof(TK);
  static constexpr bool QUANT = std::is_same<TK, int8_t>::value;
  static_assert(QUANT || std::is_same<TK, T>::value,
                "K/V are the query type or int8 codes");

  static size_t smem_bytes(int R) {
    return sizeof(float) * (static_cast<size_t>(R) * HP + BS * HP + BS * H +
                            static_cast<size_t>(R) * BS +
                            static_cast<size_t>(R) * H + 3 * R + 2 * BS);
  }

  float* qs;   // [R][HP]
  float* ks;   // [BS][HP]
  float* vs;   // [BS][H]
  float* ss;   // [R][BS] scores, then probabilities
  float* acc;  // [R][H]
  float* m_s;  // [R] running max
  float* l_s;  // [R] running sum
  float* a_s;  // [R] this tile's rescale factor
  float* ksc;  // [BS] this tile's K scales (int8 codes)
  float* vsc;  // [BS] this tile's V scales
  int R, G;

  __device__ DecodeScan(float* smem, int R_, int G_) : R(R_), G(G_) {
    qs = smem;
    ks = qs + R * HP;
    vs = ks + BS * HP;
    ss = vs + BS * H;
    acc = ss + R * BS;
    m_s = acc + R * H;
    l_s = m_s + R;
    a_s = l_s + R;
    ksc = a_s + R;
    vsc = ksc + BS;
  }

  // Query rows (t, g) <- q[b, t, kvh * G + g, :] (q [B, Tq, N, H]); the
  // running state starts at (m, l, acc) = (NEG_INF, 0, 0).
  __device__ void begin(const T* __restrict__ q, int b, int Tq, int N, int kvh) {
    const int tid = threadIdx.x;
    for (int e = tid * VEC_Q; e < R * H; e += THREADS * VEC_Q) {
      const int r = e / H, d = e % H;
      const int t = r / G, g = r % G;
      float tmp[VEC_Q];
      load_vec<T>(q + ((static_cast<size_t>(b) * Tq + t) * N + kvh * G + g) * H + d, tmp);
#pragma unroll
      for (int i = 0; i < VEC_Q; ++i) {
        qs[r * HP + d + i] = tmp[i];
        acc[r * H + d + i] = 0.f;
      }
    }
    for (int r = tid; r < R; r += THREADS) {
      m_s[r] = NEG_INF;
      l_s[r] = 0.f;
    }
  }

  // One KV tile: key j < n lives at kt + j * rs (and vt + j * rs); keys
  // j >= n are past the end of the run and are not keys at all.
  // ``valid(r, j)`` says whether window row r attends key j. With int8
  // codes, key j's scales are kst[j * ss] and vst[j * ss]; otherwise the
  // scale pointers are unused.
  template <typename Valid>
  __device__ void tile(const TK* __restrict__ kt, const TK* __restrict__ vt,
                       size_t rs, const float* __restrict__ kst,
                       const float* __restrict__ vst, size_t ss_, int n,
                       Valid valid, float scale) {
    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    __syncthreads();  // previous tile consumed; q/acc/m/l initialised
    for (int e = tid * VEC_KV; e < BS * H; e += THREADS * VEC_KV) {
      const int r = e / H, d = e % H;
      float kv[VEC_KV], vv[VEC_KV];
      if (r < n) {
        load_vec<TK>(kt + static_cast<size_t>(r) * rs + d, kv);
        load_vec<TK>(vt + static_cast<size_t>(r) * rs + d, vv);
      } else {
#pragma unroll
        for (int i = 0; i < VEC_KV; ++i) kv[i] = vv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC_KV; ++i) {
        ks[r * HP + d + i] = kv[i];
        vs[r * H + d + i] = vv[i];
      }
    }
    if constexpr (QUANT) {
      for (int j = tid; j < BS; j += THREADS) {
        const bool in = j < n;
        ksc[j] = in ? kst[static_cast<size_t>(j) * ss_] : 0.f;
        vsc[j] = in ? vst[static_cast<size_t>(j) * ss_] : 0.f;
      }
    }
    __syncthreads();

    // Scores: one (row, key) pair per thread per pass.
    for (int e = tid; e < R * BS; e += THREADS) {
      const int r = e / BS, j = e % BS;
      float s;
      if (j < n) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < H; ++d) dot += qs[r * HP + d] * ks[j * HP + d];
        if constexpr (QUANT) {
          s = valid(r, j) ? dot * scale * ksc[j] : NEG_INF;
        } else {
          s = valid(r, j) ? dot * scale : NEG_INF;
        }
      } else {
        s = -INFINITY;  // ragged tail: not a key at all
      }
      ss[r * BS + j] = s;
    }
    __syncthreads();

    // Online-softmax update: one warp per row, two keys per lane.
    for (int r = warp; r < R; r += WARPS) {
      const float x0 = ss[r * BS + lane];
      const float x1 = ss[r * BS + lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_cur);
      const float p1 = expf(x1 - m_cur);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if constexpr (QUANT) {
        ss[r * BS + lane] = round_to<T>(p0 * vsc[lane]);
        ss[r * BS + lane + 32] = round_to<T>(p1 * vsc[lane + 32]);
      } else {
        ss[r * BS + lane] = round_to<T>(p0);
        ss[r * BS + lane + 32] = round_to<T>(p1);
      }
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_cur;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v; each thread owns fixed (row, dim) cells.
    for (int e = tid; e < R * H; e += THREADS) {
      const int r = e / H, d = e % H;
      float x = acc[e] * a_s[r];
#pragma unroll 8
      for (int j = 0; j < BS; ++j) x += ss[r * BS + j] * vs[j * H + d];
      acc[e] = x;
    }
  }

  // out[b, t, kvh * G + g, :] <- acc / l (0 where l == 0).
  __device__ void end(T* __restrict__ out, int b, int Tq, int N, int kvh) {
    __syncthreads();
    for (int e = threadIdx.x; e < R * H; e += THREADS) {
      const int r = e / H, d = e % H;
      const int t = r / G, g = r % G;
      const float l = l_s[r];
      const float denom = l == 0.f ? 1.f : l;
      out[((static_cast<size_t>(b) * Tq + t) * N + kvh * G + g) * H + d] =
          from_f<T>(acc[e] / denom);
    }
  }
};

}  // namespace rdb

extern "C" const char* rdb_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
