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
//
// Softmax rule, as _scan_tile: masked scores become NEG_INF before the
// running max, p = exp(s - m) is NOT zeroed for masked keys (it underflows
// to 0 once any key is attended; a row with no attended key averages V,
// like the reference), l == 0 finalizes to 0.
//
// What bounds it on the H100: the bytes of K/V (every step reads the whole
// slot capacity). This version stages each tile with 16-byte loads into
// shared memory; splitting S across blocks (more loads in flight per slot)
// and keeping K/V in bf16 in shared memory are the later speed-ups.

#include "common.cuh"

namespace {

constexpr int BS = 64;          // keys per KV tile (the kernel assumes 64)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <typename T, int H>
__global__ void __launch_bounds__(THREADS)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int8_t* __restrict__ mask,
              T* __restrict__ out, int Tq, int S, int N, int K, float scale) {
  constexpr int HP = H + 1;
  constexpr int VEC = 16 / sizeof(T);
  const int G = N / K;
  const int R = Tq * G;

  extern __shared__ float smem[];
  float* qs = smem;               // [R][HP]
  float* ks = qs + R * HP;        // [BS][HP]
  float* vs = ks + BS * HP;       // [BS][H]
  float* ss = vs + BS * H;        // [R][BS] scores, then probabilities
  float* acc = ss + R * BS;       // [R][H]
  float* m_s = acc + R * H;       // [R] running max
  float* l_s = m_s + R;           // [R] running sum
  float* a_s = l_s + R;           // [R] this tile's rescale factor

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;

  const size_t kv_rs = static_cast<size_t>(K) * H;
  const T* kb = k + static_cast<size_t>(b) * S * kv_rs + static_cast<size_t>(kvh) * H;
  const T* vb = v + static_cast<size_t>(b) * S * kv_rs + static_cast<size_t>(kvh) * H;

  // Query rows (t, g) -> q[b, t, kvh * G + g, :].
  for (int e = tid * VEC; e < R * H; e += THREADS * VEC) {
    const int r = e / H, d = e % H;
    const int t = r / G, g = r % G;
    float tmp[VEC];
    rdb::load_vec<T>(
        q + ((static_cast<size_t>(b) * Tq + t) * N + kvh * G + g) * H + d, tmp);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      qs[r * HP + d + i] = tmp[i];
      acc[r * H + d + i] = 0.f;
    }
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = rdb::NEG_INF;
    l_s[r] = 0.f;
  }

  for (int s0 = 0; s0 < S; s0 += BS) {
    __syncthreads();  // previous tile consumed; q/acc/m/l initialised
    for (int e = tid * VEC; e < BS * H; e += THREADS * VEC) {
      const int r = e / H, d = e % H;
      float kt[VEC], vt[VEC];
      if (s0 + r < S) {
        rdb::load_vec<T>(kb + static_cast<size_t>(s0 + r) * kv_rs + d, kt);
        rdb::load_vec<T>(vb + static_cast<size_t>(s0 + r) * kv_rs + d, vt);
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

    // Scores: one (row, key) pair per thread per pass.
    for (int e = tid; e < R * BS; e += THREADS) {
      const int r = e / BS, j = e % BS;
      const int pos = s0 + j;
      float s;
      if (pos < S) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < H; ++d) dot += qs[r * HP + d] * ks[j * HP + d];
        const bool valid =
            mask == nullptr ||
            mask[(static_cast<size_t>(b) * Tq + r / G) * S + pos] != 0;
        s = valid ? dot * scale : rdb::NEG_INF;
      } else {
        s = -INFINITY;  // ragged tail past S: not a key at all
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
      ss[r * BS + lane] = rdb::round_to<T>(p0);
      ss[r * BS + lane + 32] = rdb::round_to<T>(p1);
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
  __syncthreads();

  for (int e = tid; e < R * H; e += THREADS) {
    const int r = e / H, d = e % H;
    const int t = r / G, g = r % G;
    const float l = l_s[r];
    const float denom = l == 0.f ? 1.f : l;
    out[((static_cast<size_t>(b) * Tq + t) * N + kvh * G + g) * H + d] =
        rdb::from_f<T>(acc[e] / denom);
  }
}

template <typename T, int H>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int8_t* mask, void* out, int B, int Tq, int S, int N,
                   int K, float scale, cudaStream_t stream) {
  const int R = Tq * (N / K);
  const size_t smem = sizeof(float) * (static_cast<size_t>(R) * (H + 1) +
                                       BS * (H + 1) + BS * H + R * BS +
                                       static_cast<size_t>(R) * H + 3 * R);
  auto kern = decode_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(K, B);
  kern<<<grid, THREADS, smem, stream>>>(
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
