// Slab decode attention for Hopper (sm_90a): split-S with in-launch merge.
//
// Replaces ray_dynamic_batching_tpu/ops/decode_attention.py::_decode_attention
// (Pallas bodies _decode_kernel + _scan_tile): a fused KV scan for a small
// query window (1 <= Tq <= 8) with an online softmax in f32 and the int8
// window mask [B, Tq, S]. K/V are q's type, or int8 codes of the int8 KV
// cache with f32 scales k_scale/v_scale [B, S, K] (the reference's scale
// BlockSpecs, decode_attention.py:268-279, and _scan_tile's ks/vs branch):
// the codes are read as 1-byte elements and the scales applied inside the
// products (rdb::DecodeScan), never as a dequantized tile in memory.
//
// Layouts: q/out [B, Tq, N, H]; k/v [B, S, K, H]; scales [B, S, K] (the
// cache's own layout: key pos of KV head kvh at (b * S + pos) * K + kvh);
// all contiguous; the mask [B, Tq, S] through its batch and row strides
// (ops/flash_attention.py keep_mask: a row stride of 0 or a multiple of 16
// of at least S), read in 16-byte chunks only. H is a multiple of 16 up
// to 128: the scan body is built 64 and 128 wide, and smaller head dims
// ride it zero-padded in shared memory (rdb::DecodeScan, common.cuh).
//
// One window row a (slot, KV head) — R = Tq * N / K = 1: Whisper's cross
// read over its 1500 states and its step, the GPT-2 steps — takes
// decode_row_kernel, the single-row scan (rdb::RowScan, common.cuh): no
// 16-row tensor-core padding and no block barrier a tile, 16-byte vector
// loads through a cp.async ring a warp, and splits long enough that the
// grid is one wave (Whisper's cross read: 3 splits of 8 tiles, not 12 of
// 2). On an H100 (700 W; chip_smoke.py phase 3, PERF.md): the cross read
// 0.0296 ms (0.0513 on DecodeScan; SDPA 0.0346; bound 0.0163),
// gpt2_medium's step 0.0213 (0.0402). Every other window keeps
// decode_kernel below.
//
// What bounds it on the H100: the bytes of the K/V positions that some
// window row attends (plus their scales), read once. With one block per
// (slot, KV head) walking all S positions, 128 blocks at the main shape
// would leave most SMs one block and the card mostly waiting. This design:
//
// - Grid (splits, K, B): a block per 128 logical positions of one
//   (slot, KV head); all G = N / K query heads times the Tq window rows
//   (R = Tq * G rows, ordered (t, g)) ride one read of each K/V tile —
//   GQA by layout. 512 blocks at the main shape.
// - Every block reads its slot's window mask row (Tq x S bytes) first
//   and marks the 64-key tiles that some row attends; it skips the void
//   tiles and the splits with none, and reads its own split's mask bytes
//   into shared memory for the scores. When some row attends no key at
//   all, nothing is skipped, so that row gets the reference's mean of V.
// - Live tiles are staged narrow with cp.async, all issued before the
//   first is computed; the products run on the tensor cores for a bf16
//   query; the scan and the merge of the splits are rdb::DecodeScan
//   (common.cuh), shared with the paged kernel.
//
// Measured at the main shape on an H100 (700 W; chip_smoke.py phase 3,
// PERF.md): 0.0155 ms against a bound of 0.0050 ms over the attended
// positions, about 3x.
// What is left is the chain of one block — the mask read, its tiles'
// loads, two tiles' products and, for slots of several splits, the
// partial write, the arrival and the merge's two rounds of loads — more
// than the bytes.

#include "common.cuh"

namespace {

template <typename T, typename TK, int H, int HV>
__global__ void __launch_bounds__(rdb::DecodeScan<T, TK, H, HV>::THREADS)
decode_kernel(const T* __restrict__ q, const TK* __restrict__ k,
              const TK* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale,
              const int8_t* __restrict__ mask, long long mbs, long long mrs,
              T* __restrict__ out, float* __restrict__ ws, int* __restrict__ cnt, int Tq,
              int S, int N, int K, float scale) {
  using Scan = rdb::DecodeScan<T, TK, H, HV>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = N / K;
  Scan scan(smem, Tq * G, G);
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ntiles = (S + Scan::BS - 1) / Scan::BS;
  const int p0 = split * Scan::SPLIT;            // first position of the split

  // Caller's shared bytes: this split's mask [Tq][SPLIT], then one flag
  // per tile of the slot, one per window row and one per split.
  int8_t* ms = reinterpret_cast<int8_t*>(scan.extra);
  unsigned char* live = scan.extra + Tq * Scan::SPLIT;
  unsigned char* row_any = live + ntiles;
  unsigned char* split_flags = row_any + Tq;
  bool all_live = mask == nullptr;
  if (mask != nullptr) {
    // Row t of the slot's mask at mb + t * mrs (mrs 0: one row for all),
    // read in 16-byte chunks (rdb::clear_past drops the bytes past S);
    // the first chunk's load is in flight across the barrier that
    // publishes the zeroed flags.
    const int8_t* mb = mask + b * mbs;
    const int cpr = (S + 15) / 16;
    uint4 w0 = make_uint4(0u, 0u, 0u, 0u);
    if (tid < Tq * cpr)
      w0 = *reinterpret_cast<const uint4*>(mb + (tid / cpr) * mrs + (tid % cpr) * 16);
    for (int t = tid; t < ntiles; t += Scan::THREADS) live[t] = 0;
    for (int t = tid; t < Tq; t += Scan::THREADS) row_any[t] = 0;
    for (int t = tid; t < nsplit; t += Scan::THREADS) split_flags[t] = 0;
    __syncthreads();
    for (int e = tid; e < Tq * cpr; e += Scan::THREADS) {
      const int t = e / cpr, pos = (e % cpr) * 16;
      const uint4 w = rdb::clear_past(
          e == tid ? w0 : *reinterpret_cast<const uint4*>(mb + t * mrs + pos), pos, S);
      if (pos >= p0 && pos < p0 + Scan::SPLIT)
        *reinterpret_cast<uint4*>(ms + t * Scan::SPLIT + pos - p0) = w;
      if ((w.x | w.y | w.z | w.w) != 0u) {
        live[pos / Scan::BS] = 1;
        split_flags[pos / Scan::SPLIT] = 1;
        row_any[t] = 1;
      }
    }
    __syncthreads();
    for (int t = 0; t < Tq; ++t) all_live = all_live || row_any[t] == 0;
  }
  auto tile_live = [&](int t) { return all_live || live[t] != 0; };
  // A split is live when one of its tiles is (the merge reads these in a
  // loop over splits).
  auto split_live = [=](int s) { return all_live || split_flags[s] != 0; };
  int n_live = 0;
  for (int s = 0; s < nsplit; ++s) n_live += split_live(s) ? 1 : 0;
  if (!split_live(split)) return;  // nothing to read; the merge skips it
  scan.load_q(q, b, Tq, N, kvh);

  const size_t kv_rs = static_cast<size_t>(K) * HV;
  const TK* kb = k + static_cast<size_t>(b) * S * kv_rs + static_cast<size_t>(kvh) * HV;
  const TK* vb = v + static_cast<size_t>(b) * S * kv_rs + static_cast<size_t>(kvh) * HV;
  // Scales of key pos: (b * S + pos) * K + kvh (null without int8 codes).
  const size_t sc0 = static_cast<size_t>(b) * S * K + kvh;
  // The split's live tiles into buffers 0 .. nt - 1, each K then its V.
  // A split has one or two live tiles: buffer i holds tile t0 + (i ? 1 : first).
  const int t0 = split * Scan::TILES;
  const bool live0 = tile_live(t0);
  const bool live1 = t0 + 1 < ntiles && tile_live(t0 + 1);
  const int first = live0 ? 0 : 1;
  const int nt = (live0 ? 1 : 0) + (live1 ? 1 : 0);
#pragma unroll
  for (int i = 0; i < Scan::TILES; ++i) {
    if (i >= nt) break;
    const int pos0 = (t0 + (i ? 1 : first)) * Scan::BS;
    const int nk = min(Scan::BS, S - pos0);
    const size_t sc = sc0 + static_cast<size_t>(pos0) * K;
    scan.issue(i, 0, kb + pos0 * kv_rs, kv_rs, k_scale == nullptr ? nullptr : k_scale + sc,
               K, nk);
    scan.issue(i, 1, vb + pos0 * kv_rs, kv_rs, v_scale == nullptr ? nullptr : v_scale + sc,
               K, nk);
  }
  scan.begin();
#pragma unroll
  for (int i = 0; i < Scan::TILES; ++i) {
    if (i >= nt) break;
    const int pos0 = (t0 + (i ? 1 : first)) * Scan::BS;
    const int8_t* mt = ms + (pos0 - p0);
    scan.tile(i, nt, min(Scan::BS, S - pos0),
              [=](int j) {
                if (mask == nullptr) return 0xffffffffu;
                unsigned bits = 0;
                for (int t = 0; t < Tq; ++t)
                  bits |= (mt[t * Scan::SPLIT + j] != 0 ? 1u : 0u) << t;
                return bits;
              },
              scale);
  }
  scan.finish(out, ws, cnt, b, Tq, N, K, kvh, split, nsplit, n_live, split_live);
}

// R = Tq * G = 1: the single-row scan (rdb::RowScan). Grid (splits of lt
// tiles, K, B), 128 threads. Every block reads its slot's mask row (S
// bytes, 16 at a time) for the live tiles and splits, as decode_kernel
// does; each warp stages its own keys' 16 mask bytes beside their K/V.
template <typename T, typename TK, int HV>
__global__ void __launch_bounds__(rdb::RowScan<T, TK, HV>::THREADS)
decode_row_kernel(const T* __restrict__ q, const TK* __restrict__ k,
                  const TK* __restrict__ v, const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale, const int8_t* __restrict__ mask,
                  long long mbs, T* __restrict__ out, float* __restrict__ ws,
                  int* __restrict__ cnt, int S, int K, float scale, int lt) {
  using Scan = rdb::RowScan<T, TK, HV>;
  extern __shared__ __align__(16) unsigned char smem[];
  Scan scan(smem);
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int ntiles = (S + Scan::BS - 1) / Scan::BS;

  // Caller's shared bytes: a flag per tile and per split, the row's flag,
  // then this split's live tiles in order and their count.
  unsigned char* live = scan.extra;
  unsigned char* split_flags = live + ntiles;
  unsigned char* row_any = split_flags + nsplit;
  int* list = reinterpret_cast<int*>((reinterpret_cast<uintptr_t>(row_any + 1) + 3) &
                                     ~static_cast<uintptr_t>(3));
  int* nlist = list + lt;
  const int8_t* mb = mask == nullptr ? nullptr : mask + b * mbs;
  bool all_live = true;
  if (mb != nullptr) {
    const int cpr = (S + 15) / 16;
    for (int t = tid; t < ntiles; t += Scan::THREADS) live[t] = 0;
    for (int t = tid; t < nsplit; t += Scan::THREADS) split_flags[t] = 0;
    if (tid == 0) *row_any = 0;
    __syncthreads();
    for (int e = tid; e < cpr; e += Scan::THREADS) {
      const uint4 w = rdb::clear_past(*reinterpret_cast<const uint4*>(mb + e * 16), e * 16, S);
      if ((w.x | w.y | w.z | w.w) != 0u) {
        live[e * 16 / Scan::BS] = 1;
        split_flags[e * 16 / (Scan::BS * lt)] = 1;
        *row_any = 1;
      }
    }
    __syncthreads();
    all_live = *row_any == 0;  // the row attends nothing: scan everything
  }
  auto split_live = [=](int s) { return all_live || split_flags[s] != 0; };
  int n_live = 0;
  for (int s = 0; s < nsplit; ++s) n_live += split_live(s) ? 1 : 0;
  if (!split_live(split)) return;  // nothing to read; the merge skips it
  const int t0 = split * lt, t1 = min(ntiles, t0 + lt);
  if (tid == 0) {
    int n = 0;
    for (int t = t0; t < t1; ++t)
      if (all_live || live[t] != 0) list[n++] = t;
    *nlist = n;
  }
  float qf[Scan::CH];
  Scan::load_q(q + (static_cast<size_t>(b) * K + kvh) * HV, lane, qf);
  __syncthreads();
  const int nt = *nlist;

  const size_t kv_rs = static_cast<size_t>(K) * HV;
  const size_t row0 = static_cast<size_t>(b) * S * kv_rs + static_cast<size_t>(kvh) * HV;
  const size_t sc0 = static_cast<size_t>(b) * S * K + kvh;
  auto issue = [&](int i) {
    const int pos0 = list[i] * Scan::BS;
    const size_t sc = sc0 + static_cast<size_t>(pos0) * K;
    scan.issue(warp, i % Scan::STAGES, k + row0 + pos0 * kv_rs, v + row0 + pos0 * kv_rs, kv_rs,
               k_scale == nullptr ? nullptr : k_scale + sc,
               v_scale == nullptr ? nullptr : v_scale + sc, K,
               mb == nullptr ? nullptr : mb + pos0, min(Scan::BS, S - pos0), lane);
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
    const int pos0 = list[i] * Scan::BS;
    scan.tile(warp, i % Scan::STAGES, min(Scan::BS, S - pos0), lane, qf, scale,
              [=](int, int8_t byte) { return mb == nullptr || byte != 0; }, m, l, acc);
    __syncwarp();  // the stage is free for tile i + STAGES
  }
  scan.merge_warps(warp, lane, m, l, acc);
  scan.finish(out + (static_cast<size_t>(b) * K + kvh) * HV, ws, cnt,
              static_cast<size_t>(b) * K + kvh, split, nsplit, n_live, split_live);
}

template <typename T, typename TK, int H, int HV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const int8_t* mask, long long mbs, long long mrs, void* out, float* ws,
                   long long ws_len, int* cnt, int cnt_len, int B, int Tq, int S, int N, int K,
                   float scale, int* body, cudaStream_t stream) {
  using Scan = rdb::DecodeScan<T, TK, H, HV>;
  if (Scan::QUANT && (k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  const int ntiles = (S + Scan::BS - 1) / Scan::BS;
  if (Tq * (N / K) == 1) {
    using Row = rdb::RowScan<T, TK, HV>;
    const int lt = Row::split_tiles(B * K, S);
    const int nsplit = (ntiles + lt - 1) / lt;
    if (!Row::merge_fits(nsplit, B, K, ws_len, cnt_len)) return cudaErrorInvalidValue;
    const size_t smem = Row::smem_bytes(ntiles + nsplit + 4 + sizeof(int) * (lt + 1));
    auto kern = decode_row_kernel<T, TK, HV>;
    cudaError_t err = rdb::raise_smem_limit(kern, smem);
    if (err != cudaSuccess) return err;
    *body = 1;
    kern<<<dim3(nsplit, K, B), Row::THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const TK*>(k), static_cast<const TK*>(v), k_scale,
        v_scale, mask, mbs, static_cast<T*>(out), ws, cnt, S, K, scale, lt);
    return cudaGetLastError();
  }
  const int nsplit = (S + Scan::SPLIT - 1) / Scan::SPLIT;
  if (!Scan::merge_fits(Tq * (N / K), nsplit, B, K, ws_len, cnt_len))
    return cudaErrorInvalidValue;
  const size_t smem = Scan::smem_bytes(Tq * (N / K), Tq * Scan::SPLIT + ntiles + Tq + nsplit);
  auto kern = decode_kernel<T, TK, H, HV>;
  cudaError_t err = rdb::raise_smem_limit(kern, smem);
  if (err != cudaSuccess) return err;
  *body = 0;
  dim3 grid(nsplit, K, B);
  kern<<<grid, Scan::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), k_scale, v_scale, mask, mbs, mrs, static_cast<T*>(out),
      ws, cnt, Tq, S, N, K, scale);
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
                     const float* ks, const float* vs, const int8_t* m, long long mbs,
                     long long mrs, void* out, float* ws, long long wl, int* cnt, int cl, int B,
                     int Tq, int S, int N, int K, int H, float scale, int kv_int8, int* body,
                     cudaStream_t st) {
  if (kv_int8)
    return by_head<T, int8_t>(H, q, k, v, ks, vs, m, mbs, mrs, out, ws, wl, cnt, cl, B, Tq, S,
                              N, K, scale, body, st);
  return by_head<T, T>(H, q, k, v, static_cast<const float*>(nullptr),
                       static_cast<const float*>(nullptr), m, mbs, mrs, out, ws, wl, cnt, cl,
                       B, Tq, S, N, K, scale, body, st);
}

}  // namespace

// dtype (of q and out): 0 = float32, 1 = bfloat16. kv_int8: 0 = k/v are
// q's type, 1 = int8 codes with f32 scales (both scale pointers non-null).
// H: a multiple of 16 in 16 .. 128 (others are refused). mask: int8
// [B, Tq, S] with batch stride mask_bs and row stride mask_rs in bytes
// (both multiples of 16, mask_rs 0 or at least S; 16-byte aligned), or
// null. workspace: ws_len f32, at least B * K * ceil(S / 128) * Tq *
// (N / K) * (H + 2); counters: cnt_len int32, at least B * K, zero before
// the first launch (each launch leaves them zero); smaller ones are
// refused. Launches sharing them must run in stream order. *body: 0 =
// the DecodeScan body, 1 = the single-row scan (R = Tq * N / K = 1).
// Returns a cudaError_t (0 = launched).
extern "C" int rdb_decode_attention(const void* q, const void* k, const void* v,
                                    const void* k_scale, const void* v_scale,
                                    const void* mask, long long mask_bs,
                                    long long mask_rs, void* out, int B, int Tq,
                                    int S, int N, int K, int H, float scale,
                                    int dtype, int kv_int8, void* workspace,
                                    long long ws_len, void* counters,
                                    int cnt_len, void* stream, int* body) {
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int8_t* m = static_cast<const int8_t*>(mask);
  float* ws = static_cast<float*>(workspace);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body == nullptr || mask_bs % 16 != 0 || mask_rs % 16 != 0 ||
      (m != nullptr && (reinterpret_cast<uintptr_t>(m) % 16 != 0 || (mask_rs != 0 && mask_rs < S))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_h<float>(q, k, v, ks, vs, m, mask_bs, mask_rs, out, ws, ws_len, cnt, cnt_len,
                           B, Tq, S, N, K, H, scale, kv_int8, body, st);
  if (dtype == 1)
    return launch_h<__nv_bfloat16>(q, k, v, ks, vs, m, mask_bs, mask_rs, out, ws, ws_len, cnt,
                                   cnt_len, B, Tq, S, N, K, H, scale, kv_int8, body, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Tiles a split of the single-row scan holds for B * K = BK (slot, KV
// head)s over S positions: RowScan::split_tiles, by which kernels 2 and
// 3 both cut their splits.
extern "C" int rdb_row_split_tiles(int BK, int S) {
  return rdb::RowScan<float, float, 64>::split_tiles(BK, S);
}
