// Flash prefill attention for Hopper (sm_90a): bf16 on tensor cores.
//
// Replaces ray_dynamic_batching_tpu/ops/flash_attention.py::_flash_attention
// (Pallas body _attn_kernel): FlashAttention-2 forward with a tiled online
// softmax in f32, the int8 keep-mask [B, Tq, Tk] and the causal iota rule
// (key <= query + Tk - Tq), GQA by reading KV head n / (N / K), and 0 (not
// NaN) for a row with no attended key.
//
// Layouts: q/out [B, Tq, N, H]; k/v [B, Tk, K, H]; mask [B, Tq, Tk] int8;
// all contiguous.
//
// What bounds it on the H100. On the serving path every launch is a
// 64-row chunk over a 512-position row cache (slab prefill groups, long-
// fill chunks, paged chunks over the gathered view), and the mask voids
// most KV tiles: at the main shape 7 of 8. The work the function needs is
// the K/V of the live tiles plus q, out and the mask — bytes, 0.0015 ms at
// the main shape. This design runs at 0.0089 ms there on an H100 (700 W),
// about 6x the bound (chip_smoke.py phase 3, PERF.md): what is left is
// latency — the mask prepass, one tile's load, its products and the
// epilogue, each a dependent step of a block that has one tile of work.
// The bf16 design:
//
// - Mask-void tile skipping. Each block first reads its 64 rows of the
//   mask (<= 32 KB at Tk = 512) and marks every 64-key tile that some row
//   attends under the mask and the causal rule; it then walks the live
//   tiles only. Exact under the flash rule: a masked key's p is zeroed,
//   so a wholly masked tile leaves m, l and acc as they were. A block with
//   no live tile writes 0 rows.
// - Tensor cores: QK^T and PV as mma.sync.m16n8k16 (bf16 in, f32
//   accumulate); K by ldmatrix, V by ldmatrix.trans, Q's fragments held in
//   registers, each k-step's fragments loaded before its products. P stays
//   in registers: the score accumulator becomes the A fragment of PV,
//   rounded to bf16 on the way, which is the reference's p.astype(v.dtype).
//   The running sum takes the unrounded p, as the reference's does.
// - Eight warps a block: four 16-row query slabs times two key halves of
//   every tile, each warp with its own running (l, o). The two warps of a
//   slab share each tile's row max (one exchange through shared memory and
//   a 64-thread named barrier per tile), so both round p to bf16 against
//   the running max over the whole 64-key tile, exactly where the
//   reference rounds it (m_new = max(m_prev, tile max), then
//   p.astype(v.dtype)); at the end their o and l are summed. Two warps a
//   scheduler instead of one hide most of the mma and ldmatrix latency;
//   exp is the fast ex2-based one.
// - Narrow, asynchronous staging: Q, K, V (and each tile's mask bytes)
//   stay bf16 / int8 in shared memory, 16-byte chunks XOR-swizzled
//   against ldmatrix bank conflicts, loaded with cp.async into a double
//   buffer: the next live tile lands while this one is computed.
// - GQA: one block per (batch row, query head, 64-row tile) — 128 blocks
//   at the main shape, one wave on 132 SMs. Packing the G = 4 heads of a
//   KV head into one block reads each K/V tile once per 4 heads but
//   leaves 32 blocks of 32 warps for 132 SMs: a compile-time variant that
//   did so (since removed) measured 0.0589 against 0.0092 ms at the main
//   shape on an H100 (700 W; PERF.md), so K/V re-reads from L2 are the
//   cheaper side.
//
// f32 (the model-parity runs and f32 tests, tolerance 1e-4) keeps the
// first version's FMA body below: TF32 tensor cores keep ~3 decimal
// digits and would not meet 1e-4.

#include "common.cuh"

namespace {

using rdb::ldsm_x4;
using rdb::ldsm_x4_t;
using rdb::mma_bf16;
using rdb::pack_bf16;

// --- bf16: tensor cores ----------------------------------------------------
constexpr int TBQ = 64;   // query rows per head per block (4 slabs x 16)
constexpr int TBK = 64;   // keys per KV tile
constexpr int MROW = TBK + 16;  // mask tile row bytes (padded)

// Byte offset of 16-byte chunk c of row r in a [rows][H] bf16 tile, the
// chunk index XOR-ed with r % 8: the 8 rows one ldmatrix reads hit 8
// different bank groups.
template <int H>
__device__ __forceinline__ int swz(int r, int c) {
  return r * (H * 2) + ((c ^ (r & 7)) << 4);
}

template <int H>
struct FlashSmem {
  static constexpr int TILE = TBK * H * 2;  // bytes of one K or V tile
  // The key halves' sum at the end: per warp of the second half, its
  // (o, l) fragments, lane-minor.
  static constexpr int EXCH = 4 * (H / 2 + 2) * 32 * 4;
  static size_t bytes(int ntiles) {
    const size_t main = static_cast<size_t>(TBQ) * H * 2 + 4 * TILE + 2 * TBQ * MROW +
                        sizeof(int) * (2 * static_cast<size_t>(ntiles) + 1) +
                        sizeof(float) * 2 * TBQ;
    const size_t exch = static_cast<size_t>(TBQ) * H * 2 + EXCH;
    return main > exch ? main : exch;
  }
};

// Grid (ceil(Tq / 64), N, B), 8 warps a block: warp w takes query rows
// 16 (w % 4) .. + 15 and the key half w / 4 (32 keys) of every tile, with
// its own running (l, o) and the slab's shared running max; the two
// halves are summed once, at the end.
template <int H>
__global__ void __launch_bounds__(256)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                  int Tq, int Tk, int N, int K, float scale, int causal) {
  constexpr int THREADS = 256;
  constexpr int NCH = H / 8;   // 16-byte chunks per row
  constexpr int KS = H / 16;   // k-steps of QK^T
  constexpr int NT = H / 8;    // n-tiles of the output
  using Sm = FlashSmem<H>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* qs = tc_smem;                             // [64][H]
  unsigned char* ks = qs + TBQ * H * 2;                    // [2][64][H]
  unsigned char* vs = ks + 2 * Sm::TILE;                   // [2][64][H]
  int8_t* msk = reinterpret_cast<int8_t*>(vs + 2 * Sm::TILE);  // [2][64][MROW]
  int* live = reinterpret_cast<int*>(msk + 2 * TBQ * MROW);
  const int ntiles = (Tk + TBK - 1) / TBK;
  int* list = live + ntiles;
  int* nlive = list + ntiles;
  float* tmax = reinterpret_cast<float*>(nlive + 1);      // [2 halves][64 rows]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kh = warp / 4;           // key half of every tile
  const int w16 = (warp % 4) * 16;   // this warp's first row in the tile
  const int kb0 = 32 * kh;           // this warp's first key in a tile
  const int q0 = blockIdx.x * TBQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (N / K);
  const int rows = min(TBQ, Tq - q0);
  const int offset = Tk - Tq;

  const size_t q_rs = static_cast<size_t>(N) * H;
  const size_t kv_rs = static_cast<size_t>(K) * H;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Tk * kv_rs + static_cast<size_t>(kvh) * H;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Tk * kv_rs + static_cast<size_t>(kvh) * H;
  const int8_t* mb = mask == nullptr ? nullptr : mask + (static_cast<size_t>(b) * Tq + q0) * Tk;

  // The Q tile; rows past Tq are zero.
  for (int e = tid; e < TBQ * NCH; e += THREADS) {
    const int r = e / NCH, c = e % NCH;
    const bool in = r < rows;
    const __nv_bfloat16* src = q + (static_cast<size_t>(b) * Tq + q0 + (in ? r : 0)) * q_rs +
                               static_cast<size_t>(n) * H + c * 8;
    rdb::cp_async16(qs + swz<H>(r, c), src, in);
  }
  rdb::cp_async_commit();

  // Live tiles: some row attends some key of the tile.
  for (int t = tid; t < ntiles; t += THREADS) live[t] = 0;
  __syncthreads();
  if (mb != nullptr) {
    if (Tk % 16 == 0) {
      // 16-byte chunks, eight loads in flight per thread before any is used.
      constexpr int U = 8;
      const int cpr = Tk / 16;
      const int total = rows * cpr;
      for (int e0 = tid; e0 < total; e0 += U * THREADS) {
        uint4 w[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int e = e0 + u * THREADS;
          w[u] = e < total ? *reinterpret_cast<const uint4*>(
                                 mb + static_cast<size_t>(e / cpr) * Tk + (e % cpr) * 16)
                           : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if ((w[u].x | w[u].y | w[u].z | w[u].w) == 0u) continue;
          const int e = e0 + u * THREADS;
          const int r = e / cpr, c = e % cpr;
          bool any = !causal;
          if (causal) {
            const int8_t* by = reinterpret_cast<const int8_t*>(&w[u]);
#pragma unroll
            for (int i = 0; i < 16; ++i)
              any = any || (by[i] != 0 && c * 16 + i <= q0 + r + offset);
          }
          if (any) live[(c * 16) / TBK] = 1;
        }
      }
    } else {
      for (int e = tid; e < rows * Tk; e += THREADS) {
        const int r = e / Tk, key = e % Tk;
        if (mb[e] != 0 && (!causal || key <= q0 + r + offset)) live[key / TBK] = 1;
      }
    }
  } else {
    const int kv_end = causal ? min(Tk, q0 + rows + offset) : Tk;
    for (int t = tid; t < ntiles; t += THREADS) live[t] = t * TBK < kv_end ? 1 : 0;
  }
  __syncthreads();
  if (warp == 0) {  // compact the live tiles, 32 at a time
    int cnt = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const bool on = t0 + lane < ntiles && live[t0 + lane] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, on);
      if (on) list[cnt + __popc(bal & ((1u << lane) - 1u))] = t0 + lane;
      cnt += __popc(bal);
    }
    if (lane == 0) *nlive = cnt;
  }

  // One live tile -> buffer: K, V, and its mask bytes.
  auto issue = [&](int t, int buf) {
    const int k0 = t * TBK;
    unsigned char* kd = ks + buf * Sm::TILE;
    unsigned char* vd = vs + buf * Sm::TILE;
    for (int e = tid; e < TBK * NCH; e += THREADS) {
      const int r = e / NCH, c = e % NCH;
      const bool in = k0 + r < Tk;
      const size_t off = static_cast<size_t>(in ? k0 + r : 0) * kv_rs + c * 8;
      rdb::cp_async16(kd + swz<H>(r, c), kb + off, in);
      rdb::cp_async16(vd + swz<H>(r, c), vb + off, in);
    }
    if (mb != nullptr) {
      int8_t* md = msk + buf * TBQ * MROW;
      if (Tk % 16 == 0) {
        for (int e = tid; e < TBQ * (TBK / 16); e += THREADS) {
          const int r = e / (TBK / 16), c = e % (TBK / 16);
          const bool in = r < rows && k0 + c * 16 < Tk;
          rdb::cp_async16(md + r * MROW + c * 16,
                          in ? mb + static_cast<size_t>(r) * Tk + k0 + c * 16 : mb, in);
        }
      } else {
        for (int e = tid; e < TBQ * TBK; e += THREADS) {
          const int r = e / TBK, c = e % TBK;
          md[r * MROW + c] = (r < rows && k0 + c < Tk) ? mb[static_cast<size_t>(r) * Tk + k0 + c] : 0;
        }
      }
    }
    rdb::cp_async_commit();
  };

  rdb::cp_async_wait<0>();  // Q landed (this thread's part)
  __syncthreads();          // ... every thread's; the live list is written
  const int nl = *nlive;
  if (nl > 0) issue(list[0], 0);

  // Q fragments (A operands), one per k-step, held for the whole scan.
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qa[kk], rdb::smem_addr(qs + swz<H>(w16 + (lane % 16), kk * 2 + lane / 16)));

  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {rdb::NEG_INF, rdb::NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's columns; quad-summed at the end
  const int qrow0 = q0 + w16 + lane / 4;  // rows qrow0 and qrow0 + 8

  for (int i = 0; i < nl; ++i) {
    const int buf = i & 1;
    if (i + 1 < nl) {
      issue(list[i + 1], buf ^ 1);
      rdb::cp_async_wait<1>();
    } else {
      rdb::cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = list[i] * TBK;
    const unsigned char* kt = ks + buf * Sm::TILE;
    const unsigned char* vt = vs + buf * Sm::TILE;
    const int8_t* mt = msk + buf * TBQ * MROW;

    // S = Q K^T over this warp's 32 keys: 4 n-tiles of 8.
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    // Each k-step's K fragments are loaded before its products are
    // issued, so one ldmatrix latency is paid per k-step.
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t bf[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int key = kb0 + np * 16 + (lane % 8) + (lane / 16) * 8;
        ldsm_x4(bf[np], rdb::smem_addr(kt + swz<H>(key, kk * 2 + (lane / 8) % 2)));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16(s[2 * np], qa[kk], bf[np][0], bf[np][1]);
        mma_bf16(s[2 * np + 1], qa[kk], bf[np][2], bf[np][3]);
      }
    }

    // Validity, scale, row max. Cell (j, c): row qrow0 + 8 * (c / 2), key
    // k0 + kb0 + 8 j + 2 (lane % 4) + c % 2.
    unsigned valid = 0;
    float mx[2] = {rdb::NEG_INF, rdb::NEG_INF};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // The mask bytes of this lane's two keys, for its two rows.
      uint16_t mpair[2] = {0xffffu, 0xffffu};
      if (mb != nullptr) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          mpair[h] = *reinterpret_cast<const uint16_t*>(
              mt + (w16 + lane / 4 + 8 * h) * MROW + kb0 + 8 * j + 2 * (lane % 4));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int rl = w16 + lane / 4 + 8 * (c / 2);
        const int kl = kb0 + 8 * j + 2 * (lane % 4) + (c % 2);
        const int key = k0 + kl;
        bool ok = key < Tk && ((mpair[c / 2] >> (8 * (c % 2))) & 0xffu) != 0;
        if (causal) ok = ok && key <= q0 + rl + offset;
        const float x = ok ? s[j][c] * scale : rdb::NEG_INF;
        s[j][c] = x;
        valid |= (ok ? 1u : 0u) << (4 * j + c);
        mx[c / 2] = fmaxf(mx[c / 2], x);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    // The row max over the whole tile: this half's, then the other
    // half's through shared memory (a named barrier for the slab's two
    // warps; the previous tile's reads finished before the barrier that
    // ended it).
    if (lane % 4 == 0) {
      tmax[kh * TBQ + w16 + lane / 4] = mx[0];
      tmax[kh * TBQ + w16 + lane / 4 + 8] = mx[1];
    }
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + warp % 4) : "memory");
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], tmax[(1 - kh) * TBQ + w16 + lane / 4 + 8 * h]);
      const float m_new = fmaxf(m_r[h], mx[h]);
      corr[h] = __expf(m_r[h] - m_new);
      m_r[h] = m_new;
    }
    // P (masked keys exactly 0), its row sums, and the bf16 A fragments.
    uint32_t pa[2][4];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = ((valid >> (4 * j + c)) & 1u) ? __expf(s[j][c] - m_r[c / 2]) : 0.f;
        psum[c / 2] += p[c];
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_r[h] = l_r[h] * corr[h] + psum[h];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      o[nt][0] *= corr[0];
      o[nt][1] *= corr[0];
      o[nt][2] *= corr[1];
      o[nt][3] *= corr[1];
    }
    // O += P V: 4 k-steps of 16 keys, n-tiles of 8 dims in pairs.
    // V fragments in groups of four before their products, as for K.
#pragma unroll
    for (int kj = 0; kj < 2; ++kj) {
      const int key = kb0 + kj * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
      for (int d0 = 0; d0 < NT / 2; d0 += 4) {
        uint32_t bf[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          ldsm_x4_t(bf[u], rdb::smem_addr(vt + swz<H>(key, (d0 + u) * 2 + lane / 16)));
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          mma_bf16(o[2 * (d0 + u)], pa[kj], bf[u][0], bf[u][1]);
          mma_bf16(o[2 * (d0 + u) + 1], pa[kj], bf[u][2], bf[u][3]);
        }
      }
    }
    __syncthreads();  // this buffer is free for the tile after next
  }

  // Finalize: l over the quad; the second key half hands its (o, l) to
  // the first through shared memory (the K/V tiles are free now), which
  // adds them — both halves carry the same running max, so the sum needs
  // no weights; a row with no attended key keeps l == 0 and gives 0.
  float lq[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_r[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lq[h] = l;
  }
  float* xw = reinterpret_cast<float*>(ks) + (warp % 4) * (NT * 4 + 2) * 32 + lane;
  if (kh == 1) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) xw[(nt * 4 + c) * 32] = o[nt][c];
    xw[(NT * 4) * 32] = lq[0];
    xw[(NT * 4 + 1) * 32] = lq[1];
  }
  __syncthreads();
  if (kh == 1) return;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = lq[h] + xw[(NT * 4 + h) * 32];
    inv[h] = l == 0.f ? 1.f : 1.f / l;  // one reciprocal a row, not H divisions
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nt][c] += xw[(nt * 4 + c) * 32];
  unsigned char* ow = qs;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rl = w16 + lane / 4 + 8 * h;
      *reinterpret_cast<uint32_t*>(ow + swz<H>(rl, nt) + 4 * (lane % 4)) =
          pack_bf16(o[nt][2 * h] * inv[h], o[nt][2 * h + 1] * inv[h]);
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * NCH; e += 32) {
    const int rl = w16 + e / NCH, c = e % NCH;
    if (rl < rows)
      *reinterpret_cast<uint4*>(out + (static_cast<size_t>(b) * Tq + q0 + rl) * q_rs +
                                static_cast<size_t>(n) * H + c * 8) =
          *reinterpret_cast<const uint4*>(ow + swz<H>(rl, c));
  }
}

template <int H>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int8_t* mask, void* out, int B, int Tq, int Tk,
                        int N, int K, float scale, int causal,
                        cudaStream_t stream) {
  const size_t smem = FlashSmem<H>::bytes((Tk + TBK - 1) / TBK);
  auto kern = flash_bf16_kernel<H>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + TBQ - 1) / TBQ, N, B);
  kern<<<grid, 256, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), mask, static_cast<__nv_bfloat16*>(out),
      Tq, Tk, N, K, scale, causal);
  return cudaGetLastError();
}

// --- f32: the FMA body -----------------------------------------------------
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
    return launch_bf16<64>(q, k, v, m, out, B, Tq, Tk, N, K, scale, causal, st);
  if (dtype == 1 && H == 128)
    return launch_bf16<128>(q, k, v, m, out, B, Tq, Tk, N, K, scale, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
