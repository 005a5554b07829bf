// Paged decode attention for Hopper (sm_90a): split-S with in-launch merge.
//
// Replaces ray_dynamic_batching_tpu/ops/decode_attention.py::
// _paged_decode_attention (Pallas body: _scan_tile over page-table tiles):
// a fused KV scan for a small query window (1 <= Tq <= 8) over a page pool
// shared by all slots, each slot's logical KV run named by its row of the
// page table. Pools hold q's type, or int8 codes with f32 scale pools
// k_scale/v_scale [P, ps, K] paged by the same table (the reference's
// int8-pool branch, decode_attention.py:354-360 + _scan_tile).
//
// Layouts: q/out [B, Tq, N, H]; k/v pools [P, ps, K, H] (the caller passes
// the P real pages; the engine's sink page past them is never named);
// scales [P, ps, K] (offset (page * ps + off) * K + kvh); table [B, NP]
// int32, sentinel P = unallocated; lengths [B] int32. All contiguous. H
// is a multiple of 16 up to 128, on the slab kernel's padded bodies.
//
// Grid (splits, K, B), splits of 128 logical positions: the slab kernel's
// layout (csrc/decode_attention.cu), and the same scan and merge
// (rdb::DecodeScan, common.cuh), as both TPU kernels share _scan_tile. On
// a slab cache cut into pages the two give bit-identical outputs: they
// read the same live tiles into the same splits and merge the same
// partials in the same order. What differs is addressing and validity:
//
// - logical tile t covers positions [64 t, 64 t + 64) of page p = 64 t / ps,
//   read from physical page min(table[b, p], P - 1) (sentinel and stray
//   entries clamp to a real page; the length bound masks them), its
//   scales from the same page;
// - window row r = t' * G + g attends position pos iff pos <= lengths[b] + t',
//   computed here from the lengths (the staircase rule) — no mask stream.
//
// Tiles and splits wholly past lengths[b] + Tq - 1 are not read, and their
// blocks exit at once: every row attends position 0, so what they would
// add after the merge is exactly 0 (common.cuh).
//
// What bounds it on the H100: the bytes of the K/V positions each slot
// attends (int8 pools halve them, plus 4 bytes of scale per (key, head)
// row). Tiles are staged narrow with cp.async from wherever the page lies.
//
// At R = Tq * N / K = 1 both kernels take the single-row scan
// (rdb::RowScan): paged_row_kernel here, on the slab kernel's splits
// (split_tiles at S = NP * ps) and tiles, so the two stay bit-identical
// there too. gpt2_medium's paged step: 0.0198 ms on an H100 (700 W),
// 0.0306 on DecodeScan (chip_smoke.py phase 3, PERF.md).

#include "common.cuh"

namespace {

template <typename T, typename TK, int H, int HV>
__global__ void __launch_bounds__(rdb::DecodeScan<T, TK, H, HV>::THREADS)
paged_decode_kernel(const T* __restrict__ q, const TK* __restrict__ k,
                    const TK* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ cnt, int Tq,
                    int N, int K, int P, int ps, int NP, float scale) {
  using Scan = rdb::DecodeScan<T, TK, H, HV>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = N / K;
  Scan scan(smem, Tq * G, G);
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;

  // The split's table entries are read beside the length, not after it.
  const int* row = table + static_cast<size_t>(b) * NP;
  const int t0 = split * Scan::TILES;
  int pages[Scan::TILES];
#pragma unroll
  for (int u = 0; u < Scan::TILES; ++u) {
    const int p = (t0 + u) * Scan::BS / ps;
    pages[u] = p < NP ? row[p] : 0;
  }
  const int len = lengths[b];
  // Last attended logical position (row Tq - 1's), within the table.
  const int last_pos = min(NP * ps, len + Tq) - 1;
  auto split_live = [=](int s) { return s * Scan::SPLIT <= last_pos; };
  if (!split_live(split)) return;
  scan.load_q(q, b, Tq, N, kvh);
  const int n_live = min(nsplit, last_pos / Scan::SPLIT + 1);

  const size_t kv_rs = static_cast<size_t>(K) * HV;
  // The live tiles are a prefix of the split: t0 + u into buffer u, each
  // K then its V.
  const int nt = min(last_pos / Scan::BS + 1, t0 + Scan::TILES) - t0;
#pragma unroll
  for (int u = 0; u < Scan::TILES; ++u) {
    if (u >= nt) break;
    const int pos0 = (t0 + u) * Scan::BS;
    const int p = pos0 / ps;
    const size_t cell = static_cast<size_t>(min(pages[u], P - 1)) * ps + (pos0 - p * ps);
    const size_t off = cell * kv_rs + static_cast<size_t>(kvh) * HV;
    const size_t sc = cell * K + kvh;
    scan.issue(u, 0, k + off, kv_rs, k_scale == nullptr ? nullptr : k_scale + sc, K,
               Scan::BS);
    scan.issue(u, 1, v + off, kv_rs, v_scale == nullptr ? nullptr : v_scale + sc, K,
               Scan::BS);
  }
  scan.begin();
#pragma unroll
  for (int u = 0; u < Scan::TILES; ++u) {
    if (u >= nt) break;
    const int pos0 = (t0 + u) * Scan::BS;
    scan.tile(u, nt, Scan::BS,
              [=](int j) {
                // Row t' attends position pos0 + j iff pos0 + j <= len + t'.
                const int need = pos0 + j - len;
                if (need <= 0) return 0xffffffffu;
                return need >= 32 ? 0u : ~((1u << need) - 1u);
              },
              scale);
  }
  scan.finish(out, ws, cnt, b, Tq, N, K, kvh, split, nsplit, n_live, split_live);
}

// R = Tq * G = 1: the single-row scan (rdb::RowScan), on the slab
// kernel's splits of lt tiles (the same split_tiles rule at S = NP * ps),
// its live tiles the prefix up to lengths[b] (row 0 attends position pos
// iff pos <= lengths[b]).
template <typename T, typename TK, int HV>
__global__ void __launch_bounds__(rdb::RowScan<T, TK, HV>::THREADS)
paged_row_kernel(const T* __restrict__ q, const TK* __restrict__ k,
                 const TK* __restrict__ v, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, const int* __restrict__ table,
                 const int* __restrict__ lengths, T* __restrict__ out,
                 float* __restrict__ ws, int* __restrict__ cnt, int K, int P, int ps, int NP,
                 float scale, int lt) {
  using Scan = rdb::RowScan<T, TK, HV>;
  extern __shared__ __align__(16) unsigned char smem[];
  Scan scan(smem);
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* row = table + static_cast<size_t>(b) * NP;
  const int len = lengths[b];
  const int last_pos = min(NP * ps, len + 1) - 1;  // last attended position
  const int span = lt * Scan::BS;
  auto split_live = [=](int s) { return s * span <= last_pos; };
  if (!split_live(split)) return;
  const int n_live = min(nsplit, last_pos / span + 1);
  const int t0 = split * lt;
  const int nt = min(last_pos / Scan::BS + 1, t0 + lt) - t0;
  float qf[Scan::CH];
  Scan::load_q(q + (static_cast<size_t>(b) * K + kvh) * HV, lane, qf);

  const size_t kv_rs = static_cast<size_t>(K) * HV;
  auto issue = [&](int i) {
    const int pos0 = (t0 + i) * Scan::BS;
    const int p = pos0 / ps;
    const size_t cell = static_cast<size_t>(min(row[p], P - 1)) * ps + (pos0 - p * ps);
    const size_t off = cell * kv_rs + static_cast<size_t>(kvh) * HV;
    const size_t sc = cell * K + kvh;
    scan.issue(warp, i % Scan::STAGES, k + off, v + off, kv_rs,
               k_scale == nullptr ? nullptr : k_scale + sc,
               v_scale == nullptr ? nullptr : v_scale + sc, K, nullptr, Scan::BS, lane);
  };
  float m = rdb::NEG_INF, l = 0.f, acc[Scan::CH];
#pragma unroll
  for (int e = 0; e < Scan::CH; ++e) acc[e] = 0.f;
#pragma unroll
  for (int i = 0; i < Scan::STAGES - 1; ++i) {
    if (i < nt) issue(i);
    else rdb::cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    if (i + Scan::STAGES - 1 < nt) issue(i + Scan::STAGES - 1);
    else rdb::cp_async_commit();
    rdb::cp_async_wait<Scan::STAGES - 1>();  // this warp's copies of tile i landed
    __syncwarp();
    const int pos0 = (t0 + i) * Scan::BS;
    scan.tile(warp, i % Scan::STAGES, Scan::BS, lane, qf, scale,
              [=](int j, int8_t) { return pos0 + j <= len; }, m, l, acc);
    __syncwarp();  // the stage is free for tile i + STAGES
  }
  scan.merge_warps(warp, lane, m, l, acc);
  scan.finish(out + (static_cast<size_t>(b) * K + kvh) * HV, ws, cnt,
              static_cast<size_t>(b) * K + kvh, split, nsplit, n_live, split_live);
}

template <typename T, typename TK, int H, int HV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int* table, const int* lengths, void* out, float* ws,
                   long long ws_len, int* cnt, int cnt_len, int B, int Tq, int N,
                   int K, int P, int ps, int NP, float scale, int* body, cudaStream_t stream) {
  using Scan = rdb::DecodeScan<T, TK, H, HV>;
  if (ps % Scan::BS != 0) return cudaErrorInvalidValue;
  if (Scan::QUANT && (k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  if (Tq * (N / K) == 1) {
    using Row = rdb::RowScan<T, TK, HV>;
    const int S = NP * ps;
    const int lt = Row::split_tiles(B * K, S);
    const int nsplit = (S / Row::BS + lt - 1) / lt;
    if (!Row::merge_fits(nsplit, B, K, ws_len, cnt_len)) return cudaErrorInvalidValue;
    const size_t smem = Row::smem_bytes(0);
    auto kern = paged_row_kernel<T, TK, HV>;
    cudaError_t err = rdb::raise_smem_limit(kern, smem);
    if (err != cudaSuccess) return err;
    *body = 1;
    kern<<<dim3(nsplit, K, B), Row::THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const TK*>(k), static_cast<const TK*>(v), k_scale,
        v_scale, table, lengths, static_cast<T*>(out), ws, cnt, K, P, ps, NP, scale, lt);
    return cudaGetLastError();
  }
  if (!Scan::merge_fits(Tq * (N / K), (NP * ps + Scan::SPLIT - 1) / Scan::SPLIT, B, K,
                        ws_len, cnt_len))
    return cudaErrorInvalidValue;
  const size_t smem = Scan::smem_bytes(Tq * (N / K), 0);
  auto kern = paged_decode_kernel<T, TK, H, HV>;
  cudaError_t err = rdb::raise_smem_limit(kern, smem);
  if (err != cudaSuccess) return err;
  *body = 0;
  dim3 grid((NP * ps + Scan::SPLIT - 1) / Scan::SPLIT, K, B);
  kern<<<grid, Scan::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), k_scale, v_scale, table, lengths,
      static_cast<T*>(out), ws, cnt, Tq, N, K, P, ps, NP, scale);
  return cudaGetLastError();
}

// Head dim H -> the body it rides (64 wide for 16 .. 64, 128 wide for
// 80 .. 128) and its instantiation; other head dims are refused.
template <typename T, typename TK, typename... A>
cudaError_t by_head(int H, A... a) {
  switch (H) {
    case 16: return launch<T, TK, 64, 16>(a...);
    case 32: return launch<T, TK, 64, 32>(a...);
    case 48: return launch<T, TK, 64, 48>(a...);
    case 64: return launch<T, TK, 64, 64>(a...);
    case 80: return launch<T, TK, 128, 80>(a...);
    case 96: return launch<T, TK, 128, 96>(a...);
    case 112: return launch<T, TK, 128, 112>(a...);
    case 128: return launch<T, TK, 128, 128>(a...);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_h(const void* q, const void* k, const void* v,
                     const float* ks, const float* vs, const int* tb,
                     const int* ln, void* out, float* ws, long long wl, int* cnt,
                     int cl, int B, int Tq, int N, int K, int H, int P, int ps,
                     int NP, float scale, int kv_int8, int* body, cudaStream_t st) {
  if (kv_int8)
    return by_head<T, int8_t>(H, q, k, v, ks, vs, tb, ln, out, ws, wl, cnt, cl, B, Tq, N,
                              K, P, ps, NP, scale, body, st);
  return by_head<T, T>(H, q, k, v, static_cast<const float*>(nullptr),
                       static_cast<const float*>(nullptr), tb, ln, out, ws, wl, cnt, cl, B,
                       Tq, N, K, P, ps, NP, scale, body, st);
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. kv_int8: 0 = pools are
// q's type, 1 = int8 codes with f32 scale pools (both non-null).
// workspace / counters: as rdb_decode_attention's, with S = NP * ps.
// *body: 0 = the DecodeScan body, 1 = the single-row scan (R = 1).
// Returns a cudaError_t (0 = launched).
extern "C" int rdb_paged_decode_attention(const void* q, const void* k,
                                          const void* v, const void* k_scale,
                                          const void* v_scale,
                                          const void* table,
                                          const void* lengths, void* out, int B,
                                          int Tq, int N, int K, int H, int P,
                                          int ps, int NP, float scale,
                                          int dtype, int kv_int8,
                                          void* workspace, long long ws_len,
                                          void* counters, int cnt_len,
                                          void* stream, int* body) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_h<float>(q, k, v, ks, vs, tb, ln, out, ws, ws_len, cnt, cnt_len,
                           B, Tq, N, K, H, P, ps, NP, scale, kv_int8, body, st);
  if (dtype == 1)
    return launch_h<__nv_bfloat16>(q, k, v, ks, vs, tb, ln, out, ws, ws_len, cnt,
                                   cnt_len, B, Tq, N, K, H, P, ps, NP, scale,
                                   kv_int8, body, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
