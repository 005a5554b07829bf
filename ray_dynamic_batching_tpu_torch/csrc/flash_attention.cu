// Flash prefill attention for Hopper (sm_90a): bf16 on tensor cores.
//
// Replaces ray_dynamic_batching_tpu/ops/flash_attention.py::_flash_attention
// (Pallas body _attn_kernel): FlashAttention-2 forward with a tiled online
// softmax in f32, the int8 keep-mask [B, Tq, Tk] and the causal iota rule
// (key <= query + Tk - Tq), GQA by reading KV head n / (N / K), and 0 (not
// NaN) for a row with no attended key.
//
// Layouts: q/out [B, Tq, N, H]; k/v [B, Tk, K, H]; mask [B, Tq, Tk] int8.
// q, k and v take any batch and token strides (in elements, each a
// multiple of 16 bytes), so the views of a packed qkv projection go in as
// they are; heads are H apart and the last dim is contiguous. out is
// contiguous. The mask comes with its batch and row strides in bytes
// (ops/flash_attention.py keep_mask): the row stride is 0 for a key row
// that every query row reads (DistilBERT's and Whisper's key masks, gpt2's
// token mask under the causal flag) or a multiple of 16 of at least Tk,
// the batch stride a multiple of 16; so every mask read is a 16-byte load,
// cp.async or TMA box (bytes past Tk cleared or never read as attended),
// and a key row is read once a block. H is any multiple of 8 up to 128: rows are padded
// to HP = 64 or 128 in shared memory and in registers, the padded columns
// of Q, K and V are zero-filled (they add nothing to QK^T and give output
// columns that are never written), so both bodies reuse the HP tiles with
// a runtime width — ViT-G/14's 104 runs on the 128 tiles.
//
// Three bf16 bodies, picked by shape alone in bf16_body (no flag selects
// one; the entry point reports the one it launched, rdb_flash_body the one
// it would launch):
//
// A. The LLM shape (a mask or causal, or a K/V too large to stay in shared
//    memory; fewer than 128 query rows, head_dim past 64, or an LSE
//    output). On the serving path every launch is a 64-row chunk over a
//    512-position row cache (slab prefill groups, long-fill chunks, paged
//    chunks over the gathered view), and the mask voids most KV tiles: at
//    the main shape 7 of 8. The work the function needs is the K/V of the
//    live tiles plus q, out and the mask — bytes, 0.0015 ms at the main
//    shape. This design runs at 0.0089 ms there on an H100 (700 W), about
//    6x the bound (chip_smoke.py phase 3, PERF.md): what is left is
//    latency — the mask prepass, one tile's load, its products and the
//    epilogue, each a dependent step of a block that has one tile of work.
//
//    - Mask-void tile skipping. Each block first reads its 64 rows of the
//      mask (<= 32 KB at Tk = 512; one row of a key-row mask, the KROW
//      instantiation) and marks every 64-key tile that some
//      row attends under the mask and the causal rule; it then walks the
//      live tiles only. Exact under the flash rule: a masked key's p is
//      zeroed, so a wholly masked tile leaves m, l and acc as they were.
//      A block with no live tile writes 0 rows.
//    - Tensor cores: QK^T and PV as mma.sync.m16n8k16 (bf16 in, f32
//      accumulate); K by ldmatrix, V by ldmatrix.trans, Q's fragments held
//      in registers, each k-step's fragments loaded before its products.
//      P stays in registers: the score accumulator becomes the A fragment
//      of PV, rounded to bf16 on the way, which is the reference's
//      p.astype(v.dtype). The running sum takes the unrounded p, as the
//      reference's does.
//    - Eight warps a block: four 16-row query slabs times two key halves of
//      every tile, each warp with its own running (l, o). The two warps of
//      a slab share each tile's row max (one exchange through shared
//      memory and a 64-thread named barrier per tile), so both round p to
//      bf16 against the running max over the whole 64-key tile, exactly
//      where the reference rounds it (m_new = max(m_prev, tile max), then
//      p.astype(v.dtype)); at the end their o and l are summed. Two warps a
//      scheduler instead of one hide most of the mma and ldmatrix latency;
//      exp is the fast ex2-based one.
//    - Narrow, asynchronous staging: Q, K, V (and each tile's mask bytes)
//      stay bf16 / int8 in shared memory, 16-byte chunks XOR-swizzled
//      against ldmatrix bank conflicts, loaded with cp.async into a double
//      buffer: the next live tile lands while this one is computed.
//    - GQA: one block per (batch row, query head, 64-row tile) — 128 blocks
//      at the main shape, one wave on 132 SMs. Packing the G = 4 heads of a
//      KV head into one block reads each K/V tile once per 4 heads but
//      leaves 32 blocks of 32 warps for 132 SMs: a compile-time variant
//      that did so (since removed) measured 0.0589 against 0.0092 ms at
//      the main shape on an H100 (700 W; PERF.md), so K/V re-reads from L2
//      are the cheaper side.
//
// B. The vision shape (no mask, not causal, and one (batch row, KV head)'s
//    whole K and V fit in shared memory): ViT-B/16's 197 tokens of 12 x 64
//    at batch 64, ViT-G/14's 257 of 16 x 104. Every key is attended, so
//    the work is q, k and v read once and out written once — bytes, 77.5
//    MB or 0.0231 ms at ViT-B/16's b64 (FLOPs 7.6 G, 0.0077 ms at the bf16
//    peak). Body A spent it on a grid of (4 query tiles x N x B) blocks
//    that each read a head's K/V again, and on per-tile work this shape
//    does not need (the prepass, the max exchange, the halves' sum): 0.178
//    ms, against SDPA's 0.048. This body:
//
//    - One block per (query head, batch row): it loads that head's K and V
//      into shared memory once (cp.async, a commit group per 64-key tile up
//      to eight, all in flight at once, rows rounded up to 16 and
//      zero-filled), so K/V cross HBM once per query head. Its warps take
//      the 16-row query slabs in turn (197 rows are 13 slabs, 257 are 17),
//      each warp with its own Q slab buffer. The first round of slabs
//      starts on tile 0 while the later tiles land (a block barrier per
//      tile in that round only); each warp's next Q slab is fetched while
//      it computes.
//    - Each warp owns its 16 rows across all keys: no max exchange, no
//      named barrier, no sum of key halves; the output is written straight
//      from the accumulator registers.
//    - Nothing decided at run time inside the products: the head width is
//      a template (HL: 64, 112 for ViT-G/14's 104, or 128), and a tile
//      with keys past Tk is its own instantiation that skips the 16-key
//      groups wholly past it (197 keys: 13 groups of 16, not 16). Runtime
//      guards in the unrolled products cost ~20% on the card
//      (flash_variants.py's guarded_tiles, PERF.md).
//      Scores stay raw until the row max (a tree), then one FFMA and one
//      ex2 a score.
//    - Same products and rounding as body A: p is rounded to bf16 against
//      the running max over each whole 64-key tile (the warp holds the
//      whole tile), where the reference's p.astype(v.dtype) rounds it;
//      the running sum takes the unrounded p; keys past Tk get NEG_INF.
//      So the tolerance against flash_attention_plain is body A's (bf16
//      2e-2 absolute, chip_smoke.py phase 3: both accumulate in f32 from
//      the same bf16 inputs and differ by a couple of bf16 ulps).
//    - 4 warps a block at HP 64 (61 KB and at most 168 registers a
//      thread: 3 blocks an SM), 8 at HP 128 (168 KB at 257 tokens: 1).
//
//    What is left is mostly compute: a build that reads no K/V runs ~14%
//    (ViT-B/16) and ~6% (ViT-G/14) faster, one with 8 warps an SM instead
//    of 12 ~18% slower (flash_variants.py). On an H100 (700 W) the body
//    runs ~3x faster than body A did at ViT-B/16's shape but ~1.2x behind
//    SDPA (PERF.md): a tile's QK^T and PV, 32 mma.sync each, take ~3/4 of
//    its cycles. Builds that traded warps for work a warp (two slabs a
//    warp, a 128-key tile, a software pipeline across tiles), read Q from
//    global memory, or split the 13th slab over the four warps measured
//    no better; wgmma is the next step.
//
// C. Long rows (bf16, head_dim <= 64, Tq >= 128, no LSE, not body B's
//    case): Whisper-large-v3's encoder [8,1500,20,64] under its frame
//    mask, DistilBERT's [32,T,12,64] at T 128 / 256, gpt2_medium's no-cache
//    [8,T,16,64] at T 128 / 256 (causal + token mask). 4-24 live tiles a
//    row of dense work: what bounds it is the products (92 GFLOP at
//    Whisper's shape, 0.0819 ms at the bf16 peak) or, at the short rows,
//    q, k and v read once. Body A spent it on per-tile work long rows do
//    not need — a max exchange and a named barrier between key halves, a
//    block barrier a tile, the halves' sum — and, at Tk = 1500, on byte
//    loads of the mask: 3.04 ms at Whisper's shape against SDPA's 0.459.
//    This body is Hopper's warp-specialised layout (namespace bodyc):
//
//    - One block per (128 query rows, query head, batch row), 288 threads:
//      warpgroups 0 and 1 consume, warp 8 produces. One producer thread
//      keeps TMA loads in flight: Q once, then each live 64-key tile's K,
//      V and mask bytes (a 64 x 128 box of a dense mask, or 64 bytes of a
//      key row) through a 3-stage ring with full / empty mbarriers. TMA
//      zero-fills rows past Tq / Tk and columns past h, so there are no
//      edge cases in the consumers' loads.
//    - Each consumer warpgroup owns 64 query rows across the whole tile:
//      S = Q K^T is four SS-wgmma m64n64k16 (Q and K from shared memory,
//      128-byte swizzled as TMA lands them), so a quad of lanes holds a
//      row's 64 scores and the row max over the whole tile is two
//      shuffles — no max exchange, no named barrier, no halves' sum. p is
//      rounded to bf16 against that running max, where the reference's
//      p.astype(v.dtype) rounds it; the running sum takes the unrounded p;
//      keys past Tk and masked keys get NEG_INF and p = 0.
//    - O += P V is four RS-wgmma m64n64k16: P from registers (the score
//      accumulator's layout is the A fragment's), V from shared memory as
//      an MN-major operand (a [key][dim] tile, transposed by the
//      instruction). ptxas does not serialise them (no C7513).
//    - Void tiles are skipped as body A skips them (the same prepass, a
//      key row read once); a row with no attended key gives 0.
//    - Two blocks an SM (~92 KB of shared memory, 96 registers a thread,
//      a few spilled): one block's softmax overlaps the other's products.
//
//    On an H100 (700 W; chip_smoke.py phase 3, PERF.md): Whisper's encoder
//    0.372 ms (SDPA 0.457; ~250 TFLOP/s, 4.5x the bound), DistilBERT T 256
//    0.047 (0.057), gpt2_medium T 256 0.016 (0.025). What is left: no
//    overlap of a warpgroup's softmax with its own products (FA3's
//    ping-pong), and at short rows the prepass, Q's load and the epilogue.
//
// f32 (the model-parity runs and f32 tests, tolerance 1e-4) keeps the
// first version's FMA body below: TF32 tensor cores keep ~3 decimal
// digits and would not meet 1e-4.

#include "common.cuh"

#include <cstring>

namespace {

using rdb::ex2;
using rdb::ldsm_x4;
using rdb::ldsm_x4_t;
using rdb::mma_bf16;
using rdb::pack_bf16;
using rdb::swz;

// Element strides of q, k and v over batch rows and tokens (a token
// stride times the length fits 32 bits; rdb_flash_attention checks), and
// the keep-mask's batch and row strides in bytes (multiples of 16; a row
// stride of 0: one key row for every query row of the batch row).
struct Strides {
  long long qb, kb, vb;
  int qt, kt, vt;
  long long mb, mr;
};

// A kernel's dynamic shared-memory limit, raised before a launch that needs
// more (never lowered: rdb::raise_smem_limit).
template <typename Kern>
cudaError_t set_smem(Kern kern, size_t smem) {
  return rdb::raise_smem_limit(kern, smem);
}

// --- bf16: tensor cores ----------------------------------------------------
constexpr int TBQ = 64;   // query rows per head per block (4 slabs x 16)
constexpr int TBK = 64;   // keys per KV tile
constexpr int MROW = TBK + 16;  // mask tile row bytes (padded)

template <int HP>
struct FlashSmem {
  static constexpr int TILE = TBK * HP * 2;  // bytes of one K or V tile
  // The key halves' sum at the end: per warp of the second half, its
  // (o, l) fragments, lane-minor.
  static constexpr int EXCH = 4 * (HP / 2 + 2) * 32 * 4;
  static size_t bytes(int ntiles) {
    const size_t main = static_cast<size_t>(TBQ) * HP * 2 + 4 * TILE + 2 * TBQ * MROW +
                        sizeof(int) * (2 * static_cast<size_t>(ntiles) + 1) +
                        sizeof(float) * 2 * TBQ;
    const size_t exch = static_cast<size_t>(TBQ) * HP * 2 + EXCH;
    return main > exch ? main : exch;
  }
};

// Body A. Grid (ceil(Tq / 64), N, B), 8 warps a block: warp w takes query
// rows 16 (w % 4) .. + 15 and the key half w / 4 (32 keys) of every tile,
// with its own running (l, o) and the slab's shared running max; the two
// halves are summed once, at the end. h <= HP is the head dim. KROW: the
// mask is one key row for every query row (row stride 0), read and staged
// once; otherwise rows are st.mr bytes apart.
template <int HP, bool KROW>
__global__ void __launch_bounds__(256)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                  float* __restrict__ lse, int Tq, int Tk, int N, int K, int h, Strides st,
                  float scale, int causal) {
  constexpr int THREADS = 256;
  constexpr int NCH = HP / 8;   // 16-byte chunks per row
  constexpr int KS = HP / 16;   // k-steps of QK^T
  constexpr int NT = HP / 8;    // n-tiles of the output
  using Sm = FlashSmem<HP>;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* qs = tc_smem;                             // [64][HP]
  unsigned char* ks = qs + TBQ * HP * 2;                   // [2][64][HP]
  unsigned char* vs = ks + 2 * Sm::TILE;                   // [2][64][HP]
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
  const int hc = h / 8;              // live chunks of a row

  const __nv_bfloat16* qb = q + b * st.qb + static_cast<size_t>(n) * h;
  const __nv_bfloat16* kb = k + b * st.kb + static_cast<size_t>(kvh) * h;
  const __nv_bfloat16* vb = v + b * st.vb + static_cast<size_t>(kvh) * h;
  // The block's mask rows: row r at mb + r * st.mr. A key-row mask (st.mr
  // 0) is read as its one row, for every query row.
  const int mrows = KROW ? 1 : rows;
  const int8_t* mb = mask == nullptr ? nullptr : mask + b * st.mb + q0 * st.mr;

  // The Q tile; rows past Tq and columns past h are zero.
  for (int e = tid; e < TBQ * NCH; e += THREADS) {
    const int r = e / NCH, c = e % NCH;
    const bool in = r < rows && c < hc;
    rdb::cp_async16(qs + swz<HP>(r, c), in ? qb + (q0 + r) * st.qt + c * 8 : qb, in);
  }
  rdb::cp_async_commit();

  // Live tiles: some row attends some key of the tile.
  for (int t = tid; t < ntiles; t += THREADS) live[t] = 0;
  __syncthreads();
  if (mb != nullptr) {
    // 16-byte chunks (bytes past Tk cleared), eight loads in flight per
    // thread before any is used. A key row stands for the block's last
    // row under the causal rule (the row that attends the most keys).
    constexpr int U = 8;
    const int cpr = (Tk + 15) / 16;
    const int total = mrows * cpr;
    for (int e0 = tid; e0 < total; e0 += U * THREADS) {
      uint4 w[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * THREADS;
        w[u] = e < total ? *reinterpret_cast<const uint4*>(mb + (e / cpr) * st.mr +
                                                           (e % cpr) * 16)
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * THREADS;
        const int r = KROW ? rows - 1 : e / cpr, c = e % cpr;
        if (Tk % 16 != 0) w[u] = rdb::clear_past(w[u], c * 16, Tk);
        if ((w[u].x | w[u].y | w[u].z | w[u].w) == 0u) continue;
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
      const bool in = k0 + r < Tk && c < hc;
      rdb::cp_async16(kd + swz<HP>(r, c), in ? kb + (k0 + r) * st.kt + c * 8 : kb, in);
      rdb::cp_async16(vd + swz<HP>(r, c), in ? vb + (k0 + r) * st.vt + c * 8 : vb, in);
    }
    if (mb != nullptr) {
      // Chunks past Tk are zero-filled; the bytes past Tk inside the last
      // one are never read as attended (key < Tk below).
      int8_t* md = msk + buf * TBQ * MROW;
      for (int e = tid; e < (KROW ? TBK / 16 : TBQ * (TBK / 16)); e += THREADS) {
        const int r = e / (TBK / 16), c = e % (TBK / 16);
        const bool in = r < mrows && k0 + c * 16 < Tk;
        rdb::cp_async16(md + r * MROW + c * 16, in ? mb + r * st.mr + k0 + c * 16 : mb, in);
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
    ldsm_x4(qa[kk], rdb::smem_addr(qs + swz<HP>(w16 + (lane % 16), kk * 2 + lane / 16)));

  float o[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {rdb::NEG_INF, rdb::NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's columns; quad-summed at the end

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
        ldsm_x4(bf[np], rdb::smem_addr(kt + swz<HP>(key, kk * 2 + (lane / 8) % 2)));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        mma_bf16(s[2 * np], qa[kk], bf[np][0], bf[np][1]);
        mma_bf16(s[2 * np + 1], qa[kk], bf[np][2], bf[np][3]);
      }
    }

    // Validity, scale, row max. Cell (j, c): row q0 + w16 + lane / 4 +
    // 8 * (c / 2), key k0 + kb0 + 8 j + 2 (lane % 4) + c % 2.
    unsigned valid = 0;
    float mx[2] = {rdb::NEG_INF, rdb::NEG_INF};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // The mask bytes of this lane's two keys, for its two rows.
      uint16_t mpair[2] = {0xffffu, 0xffffu};
      if (mb != nullptr) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          mpair[hh] = *reinterpret_cast<const uint16_t*>(
              mt + (KROW ? 0 : w16 + lane / 4 + 8 * hh) * MROW + kb0 + 8 * j + 2 * (lane % 4));
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
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
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
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], tmax[(1 - kh) * TBQ + w16 + lane / 4 + 8 * hh]);
      const float m_new = fmaxf(m_r[hh], mx[hh]);
      corr[hh] = __expf(m_r[hh] - m_new);
      m_r[hh] = m_new;
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
    for (int hh = 0; hh < 2; ++hh) l_r[hh] = l_r[hh] * corr[hh] + psum[hh];
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
          ldsm_x4_t(bf[u], rdb::smem_addr(vt + swz<HP>(key, (d0 + u) * 2 + lane / 16)));
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
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_r[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lq[hh] = l;
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
  for (int hh = 0; hh < 2; ++hh) {
    const float l = lq[hh] + xw[(NT * 4 + hh) * 32];
    inv[hh] = l == 0.f ? 1.f : 1.f / l;  // one reciprocal a row, not H divisions
    // Training: the row's log-sum-exp for the backward (LSE [B, N, Tq]);
    // null in every serving call.
    const int rl = w16 + lane / 4 + 8 * hh;
    if (lse != nullptr && lane % 4 == 0 && rl < rows)
      lse[(static_cast<size_t>(b) * N + n) * Tq + q0 + rl] = l == 0.f ? 0.f : m_r[hh] + logf(l);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nt][c] += xw[(nt * 4 + c) * 32];
  unsigned char* ow = qs;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int rl = w16 + lane / 4 + 8 * hh;
      *reinterpret_cast<uint32_t*>(ow + swz<HP>(rl, nt) + 4 * (lane % 4)) =
          pack_bf16(o[nt][2 * hh] * inv[hh], o[nt][2 * hh + 1] * inv[hh]);
    }
  }
  __syncwarp();
  for (int e = lane; e < 16 * NCH; e += 32) {
    const int rl = w16 + e / NCH, c = e % NCH;
    if (rl < rows && c < hc)
      *reinterpret_cast<uint4*>(out + ((static_cast<size_t>(b) * Tq + q0 + rl) * N + n) * h +
                                c * 8) = *reinterpret_cast<const uint4*>(ow + swz<HP>(rl, c));
  }
}

// --- body B: the vision shape ---------------------------------------------
// K/V tiles go out in at most TILE_GROUPS commit groups: tile t in group
// min(t, TILE_GROUPS - 1).
constexpr int TILE_GROUPS = 8;
// Wait until at most n (<= TILE_GROUPS) of this thread's cp.async groups
// are pending.
template <int I = 0>
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if constexpr (I < TILE_GROUPS) {
    if (n > I) {
      cp_async_wait_upto<I + 1>(n);
      return;
    }
  }
  rdb::cp_async_wait<I>();
}

// The max and the sum of v[0..7], as trees (three dependent steps, not
// seven).
__device__ __forceinline__ float tree_max8(const float (&v)[8]) {
  return fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])),
               fmaxf(fmaxf(v[4], v[5]), fmaxf(v[6], v[7])));
}
__device__ __forceinline__ float tree_sum8(const float (&v)[8]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

// The vision body's shape. HP: the row width in shared memory (64 or 128);
// HL <= HP: the columns computed, h rounded up to 16 (64, 112 or 128: the
// k-steps of QK^T and the output columns past HL are all zero, so they are
// not computed); WARPS a block, MINB blocks an SM (the register budget:
// 168 a thread at HP 64, so three blocks of 61 KB share an SM).
template <int HP, int HL>
struct Vision {
  static constexpr int WARPS = HP == 64 ? 4 : 8;
  static constexpr int MINB = HP == 64 ? 3 : 1;
  static constexpr int KS = HL / 16;   // k-steps of QK^T; column pairs of PV
  static constexpr int NT = HL / 8;    // n-tiles of the output
  __host__ __device__ static int kv_rows(int Tk) { return (Tk + 15) / 16 * 16; }
  // K and V [kv_rows][HP], then a [16][HP] Q buffer a warp.
  static size_t smem(int Tk) {
    return static_cast<size_t>(2 * kv_rows(Tk) + 16 * WARPS) * HP * 2;
  }
};

// One 64-key tile of the online softmax for a warp's 16-row slab. FULL:
// all 64 keys are < Tk; otherwise the 16-key groups from kg on are skipped
// (their rows lie past the K/V buffers' kv_rows) and keys past Tk get
// NEG_INF. Scores stay raw until the row max; p = 2^(s * scale2 - m), m
// the running max in log2 units: one FFMA and one ex2 a score. p is
// rounded to bf16 against the running max over the whole tile, where the
// reference's p.astype(v.dtype) rounds it; the running sum takes the
// unrounded p.
template <int HP, int HL, bool FULL>
__device__ __forceinline__ void vision_tile(float (&o)[Vision<HP, HL>::NT][4], float (&m_r)[2],
                                            float (&l_r)[2],
                                            const uint32_t (&qa)[Vision<HP, HL>::KS][4],
                                            const unsigned char* ks, const unsigned char* vs,
                                            int k0, int kg, int Tk, float scale2, int lane) {
  constexpr int KS = Vision<HP, HL>::KS;
  constexpr int NT = Vision<HP, HL>::NT;
  // S = Q K^T: 8 n-tiles of 8 keys.
  float s[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    uint32_t bf[4][4];
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      const int key = k0 + np * 16 + (lane % 8) + (lane / 16) * 8;
      if (FULL || np < kg)
        ldsm_x4(bf[np], rdb::smem_addr(ks + swz<HP>(key, kk * 2 + (lane / 8) % 2)));
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (!FULL && np >= kg) continue;
      mma_bf16(s[2 * np], qa[kk], bf[np][0], bf[np][1]);
      mma_bf16(s[2 * np + 1], qa[kk], bf[np][2], bf[np][3]);
    }
  }
  // The row max over the tile, P, its row sums, the bf16 A fragments of
  // PV. Cell (j, c): row lane / 4 + 8 (c / 2) of the slab, key k0 + 8 j +
  // 2 (lane % 4) + c % 2.
  if (!FULL) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k0 + 8 * j + 2 * (lane % 4) + (c % 2) >= Tk) s[j][c] = rdb::NEG_INF;
  }
  float mx[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx[0][j] = fmaxf(s[j][0], s[j][1]);
    mx[1][j] = fmaxf(s[j][2], s[j][3]);
  }
  float corr[2], neg_m[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float m = tree_max8(mx[hh]);
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_r[hh], m * scale2);
    corr[hh] = ex2(m_r[hh] - m_new);
    m_r[hh] = m_new;
    neg_m[hh] = -m_new;
  }
  uint32_t pa[4][4];
  float ps[2][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p[4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      p[c] = FULL || j < 2 * kg ? ex2(fmaf(s[j][c], scale2, neg_m[c / 2])) : 0.f;
    ps[0][j] = p[0] + p[1];
    ps[1][j] = p[2] + p[3];
    pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
    pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l_r[hh] = l_r[hh] * corr[hh] + tree_sum8(ps[hh]);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    o[nt][0] *= corr[0];
    o[nt][1] *= corr[0];
    o[nt][2] *= corr[1];
    o[nt][3] *= corr[1];
  }
  // O += P V: k-steps of 16 keys, column pairs (16 dims, two n-tiles) in
  // groups of four, each group's V fragments loaded before its products.
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) {
    if (!FULL && kj >= kg) continue;
    const int key = k0 + kj * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
#pragma unroll
    for (int d0 = 0; d0 < KS; d0 += 4) {
      uint32_t bf[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (d0 + u < KS)
          ldsm_x4_t(bf[u], rdb::smem_addr(vs + swz<HP>(key, (d0 + u) * 2 + lane / 16)));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (d0 + u >= KS) continue;
        mma_bf16(o[2 * (d0 + u)], pa[kj], bf[u][0], bf[u][1]);
        mma_bf16(o[2 * (d0 + u) + 1], pa[kj], bf[u][2], bf[u][3]);
      }
    }
  }
}

// Grid (N, B), Vision::WARPS warps a block; warp w takes the 16-row query
// slabs w, w + WARPS, ... over every key.
template <int HP, int HL>
__global__ void __launch_bounds__(Vision<HP, HL>::WARPS * 32, Vision<HP, HL>::MINB)
flash_vision_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int Tq, int Tk, int N, int K,
                    int h, Strides st, float scale) {
  using Cfg = Vision<HP, HL>;
  constexpr int WARPS = Cfg::WARPS;
  constexpr int THREADS = WARPS * 32;
  constexpr int NCH = HP / 8;   // 16-byte chunks per row
  constexpr int KS = Cfg::KS;
  constexpr int NT = Cfg::NT;
  extern __shared__ __align__(128) unsigned char vis_smem[];
  const int kv_rows = Cfg::kv_rows(Tk);
  unsigned char* ks = vis_smem;                      // [kv_rows][HP]
  unsigned char* vs = ks + kv_rows * HP * 2;         // [kv_rows][HP]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  unsigned char* qs = vs + kv_rows * HP * 2 + warp * 16 * HP * 2;  // [16][HP]
  const int n = blockIdx.x;
  const int b = blockIdx.y;
  const int kvh = n / (N / K);
  const int hc = h / 8;
  const int ntiles = (Tk + TBK - 1) / TBK;
  const int nslabs = (Tq + 15) / 16;
  const float scale2 = scale * 1.4426950408889634f;  // to log2 units

  const __nv_bfloat16* qb = q + b * st.qb + static_cast<size_t>(n) * h;
  const __nv_bfloat16* kb = k + b * st.kb + static_cast<size_t>(kvh) * h;
  const __nv_bfloat16* vb = v + b * st.vb + static_cast<size_t>(kvh) * h;

  // A slab of Q -> this warp's buffer, one commit group (an empty one past
  // the last slab); rows past Tq and columns past h are zero.
  auto load_q = [&](int slab) {
    for (int e = lane; slab < nslabs && e < 16 * NCH; e += 32) {
      const int r = e / NCH, c = e % NCH;
      const int row = slab * 16 + r;
      const bool in = row < Tq && c < hc;
      rdb::cp_async16(qs + swz<HP>(r, c), in ? qb + row * st.qt + c * 8 : qb, in);
    }
    rdb::cp_async_commit();
  };
  load_q(warp);
  // K and V, a group per 64-key tile (the tiles past the eighth share the
  // last); rows past Tk and columns past h are zero (so p = 0 meets V = 0,
  // never garbage).
  const int ngroups = min(ntiles, TILE_GROUPS);
  for (int t = 0; t < ntiles; ++t) {
    const int r0 = t * TBK;
    const int nrows = min(TBK, kv_rows - r0);
    for (int e = tid; e < nrows * NCH; e += THREADS) {
      const int r = r0 + e / NCH, c = e % NCH;
      const bool in = r < Tk && c < hc;
      rdb::cp_async16(ks + swz<HP>(r, c), in ? kb + r * st.kt + c * 8 : kb, in);
      rdb::cp_async16(vs + swz<HP>(r, c), in ? vb + r * st.vt + c * 8 : vb, in);
    }
    if (t < ngroups - 1 || t == ntiles - 1) rdb::cp_async_commit();
  }

  // Round 0 walks the tiles in order as they land (a block barrier each,
  // which every warp takes); the next slab's Q is fetched while the last
  // tile of this one is computed (round 0) or as soon as this slab's Q
  // fragments are in registers (later rounds).
  for (int round = 0, slab = warp; round == 0 || slab < nslabs; ++round, slab += WARPS) {
    const bool has = slab < nslabs;
    if (round == 0)
      cp_async_wait_upto(ngroups);  // the Q group, older than every tile's
    else
      rdb::cp_async_wait<0>();
    __syncwarp();
    uint32_t qa[KS][4];
    if (has) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qa[kk], rdb::smem_addr(qs + swz<HP>(lane % 16, kk * 2 + lane / 16)));
    }
    __syncwarp();  // the buffer is free for the next slab's Q
    if (round > 0) load_q(slab + WARPS);

    float o[NT][4];
#pragma unroll
    for (int i = 0; i < NT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    float m_r[2] = {rdb::NEG_INF, rdb::NEG_INF};  // log2 units
    float l_r[2] = {0.f, 0.f};  // this thread's columns; quad-summed at the end
    for (int t = 0; t < ntiles; ++t) {
      if (round == 0) {  // tile t landed, every thread's part
        cp_async_wait_upto(ngroups - 1 - min(t, ngroups - 1));
        __syncthreads();
        if (t == ntiles - 1) load_q(slab + WARPS);
      }
      if (!has) continue;
      const int k0 = t * TBK;
      if (k0 + TBK <= Tk)
        vision_tile<HP, HL, true>(o, m_r, l_r, qa, ks, vs, k0, 4, Tk, scale2, lane);
      else
        vision_tile<HP, HL, false>(o, m_r, l_r, qa, ks, vs, k0, (Tk - k0 + 15) / 16, Tk,
                                   scale2, lane);
    }
    if (!has) continue;

    // l over the quad; out straight from the accumulators, columns < h.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float l = l_r[hh];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l == 0.f ? 1.f : 1.f / l;
      const int row = slab * 16 + lane / 4 + 8 * hh;
      if (row >= Tq) continue;
      __nv_bfloat16* orow =
          out + ((static_cast<size_t>(b) * Tq + row) * N + n) * h + 2 * (lane % 4);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        if (nt * 8 < h)
          *reinterpret_cast<uint32_t*>(orow + nt * 8) =
              pack_bf16(o[nt][2 * hh] * inv, o[nt][2 * hh + 1] * inv);
    }
  }
}

template <int HP, int HL>
cudaError_t launch_vision(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, __nv_bfloat16* out, int B, int Tq,
                          int Tk, int N, int K, int h, Strides st, float scale,
                          size_t smem, cudaStream_t stream) {
  auto kern = flash_vision_kernel<HP, HL>;
  const cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(N, B), Vision<HP, HL>::WARPS * 32, smem, stream>>>(q, k, v, out, Tq, Tk, N, K,
                                                                  h, st, scale);
  return cudaGetLastError();
}

// --- body C: long rows at head_dim <= 64 ------------------------------------
// Warp-specialised on Hopper's TMA and wgmma (see the header). Grid
// (ceil(Tq / 128), N, B), 288 threads: warpgroups 0 and 1 consume (64 query
// rows each, over the whole of every live 64-key tile), warp 8 produces.
namespace bodyc {

constexpr int BQ = 128;          // query rows a block
constexpr int BK = 64;           // keys a tile
constexpr int STAGES = 3;        // the K / V / mask ring
constexpr int THREADS = 288;
constexpr int ROWB = 128;        // bytes of a 64-wide bf16 row
constexpr int Q_BYTES = BQ * ROWB;
constexpr int KV_BYTES = BK * ROWB;
constexpr int M_BYTES = BQ * BK;  // a dense mask tile; a key-row one uses 64 bytes of it
constexpr int STAGE = 2 * KV_BYTES + M_BYTES;

// Dynamic shared memory: 1024 of alignment slack, Q, the ring, 2 STAGES + 1
// mbarriers, the live list (ntiles) and its count.
inline size_t smem_bytes(int ntiles) {
  return 1024 + Q_BYTES + STAGES * STAGE + 8 * (2 * STAGES + 1) +
         sizeof(int) * (2 * static_cast<size_t>(ntiles) + 1);
}

__global__ void __launch_bounds__(THREADS, 2)
flash_long_kernel(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmm,
                  const int8_t* __restrict__ mask, __nv_bfloat16* __restrict__ out, int Tq,
                  int Tk, int N, int K, int h, Strides st, float scale, int causal) {
  extern __shared__ unsigned char raw_smem[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(raw_smem) + 1023) & ~static_cast<uintptr_t>(1023));
  const uint32_t qs = rdb::smem_addr(sm);
  const uint32_t ring = qs + Q_BYTES;
  const uint32_t bars = ring + STAGES * STAGE;
  auto kst = [&](int s) { return ring + s * STAGE; };
  auto vst = [&](int s) { return ring + s * STAGE + KV_BYTES; };
  auto mst = [&](int s) { return ring + s * STAGE + 2 * KV_BYTES; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  const uint32_t qbar = bars + 8 * 2 * STAGES;
  const int ntiles = (Tk + BK - 1) / BK;
  int* live = reinterpret_cast<int*>(sm + Q_BYTES + STAGES * STAGE + 8 * (2 * STAGES + 1));
  int* list = live + ntiles;
  int* nlive = list + ntiles;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (N / K);
  const int rows = min(BQ, Tq - q0);
  const int offset = Tk - Tq;
  const bool krow = st.mr == 0;
  const int8_t* mb = mask == nullptr ? nullptr : mask + b * st.mb + q0 * st.mr;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      rdb::mbar_init(full(s), 1);
      rdb::mbar_init(empty(s), 8);  // the consumer warps
    }
    rdb::mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Live tiles, as body A marks them: some row of the block attends some
  // key of the tile under the mask and the causal rule. A key row is read
  // once (it stands for the block's last row under the causal rule).
  for (int t = tid; t < ntiles; t += THREADS) live[t] = 0;
  __syncthreads();
  if (mb != nullptr) {
    const int cpr = (Tk + 15) / 16;
    const int total = (krow ? 1 : rows) * cpr;
    for (int e = tid; e < total; e += THREADS) {
      const int r = krow ? rows - 1 : e / cpr, c = e % cpr;
      const uint4 w = rdb::clear_past(
          *reinterpret_cast<const uint4*>(mb + (krow ? 0 : r) * st.mr + c * 16), c * 16, Tk);
      if ((w.x | w.y | w.z | w.w) == 0u) continue;
      bool any = !causal;
      if (causal) {
        const int8_t* by = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
        for (int i = 0; i < 16; ++i) any = any || (by[i] != 0 && c * 16 + i <= q0 + r + offset);
      }
      if (any) live[(c * 16) / BK] = 1;
    }
  } else {
    const int kv_end = causal ? min(Tk, q0 + rows + offset) : Tk;
    for (int t = tid; t < ntiles; t += THREADS) live[t] = t * BK < kv_end ? 1 : 0;
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
  __syncthreads();
  const int nl = *nlive;

  if (warp == 8) {
    // Producer: one thread keeps Q, then STAGES tiles of K, V and their
    // mask bytes in flight (TMA zero-fills rows past Tq / Tk and columns
    // past h).
    if (lane == 0) {
      rdb::prefetch_map(&tmq);
      rdb::prefetch_map(&tmk);
      rdb::prefetch_map(&tmv);
      if (mb != nullptr) rdb::prefetch_map(&tmm);
      rdb::mbar_expect_tx(qbar, Q_BYTES);
      rdb::tma_load4(qs, &tmq, qbar, 0, n, q0, b);
      const int mbox = mb == nullptr ? 0 : krow ? BK : M_BYTES;
      const int mbc = st.mb == 0 ? 0 : b;
      for (int i = 0; i < nl; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) rdb::mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        const int k0 = list[i] * BK;
        rdb::mbar_expect_tx(full(s), 2 * KV_BYTES + mbox);
        rdb::tma_load4(kst(s), &tmk, full(s), 0, kvh, k0, b);
        rdb::tma_load4(vst(s), &tmv, full(s), 0, kvh, k0, b);
        if (mb != nullptr) rdb::tma_load3(mst(s), &tmm, full(s), k0, krow ? 0 : q0, mbc);
      }
    }
    return;
  }

  // Consumers: warpgroup cw owns rows q0 + 64 cw .. + 63; this thread's
  // accumulator cells (j, c) sit at row rl + 8 (c / 2) of the block and
  // key (or output column) 8 j + 2 (lane % 4) + c % 2 of the tile.
  const int cw = warp / 4;
  const int rl = 64 * cw + 16 * (warp % 4) + lane / 4;
  const float scale2 = scale * 1.4426950408889634f;  // scores to log2 units
  const uint64_t qd = rdb::desc_sw128(qs + cw * (Q_BYTES / 2));
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_r[2] = {rdb::NEG_INF, rdb::NEG_INF};  // log2 units
  float l_r[2] = {0.f, 0.f};  // this thread's columns; quad-summed at the end
  rdb::mbar_wait(qbar, 0);
  for (int i = 0; i < nl; ++i) {
    const int s = i % STAGES;
    rdb::mbar_wait(full(s), (i / STAGES) & 1);
    const int k0 = list[i] * BK;
    // S = Q K^T: four k16 steps, Q and K both from shared memory.
    float sc[32];
    const uint64_t kd = rdb::desc_sw128(kst(s));
    rdb::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) rdb::mma_ss_n64(sc, qd + 2 * kk, kd + 2 * kk, kk);
    rdb::wg_commit();
    rdb::wg_wait<0>();
    rdb::fence_regs(sc);

    // Validity and the row max over the whole tile (the quad holds it).
    const int8_t* mt = reinterpret_cast<const int8_t*>(sm + (mst(s) - qs));
    uint32_t valid = 0;
    float mx[2] = {rdb::NEG_INF, rdb::NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint16_t mpair[2] = {0xffffu, 0xffffu};
      if (mb != nullptr) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          mpair[hh] = *reinterpret_cast<const uint16_t*>(
              mt + (krow ? 0 : (rl + 8 * hh) * BK) + 8 * j + 2 * (lane % 4));
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + 8 * j + 2 * (lane % 4) + (c % 2);
        bool ok = key < Tk && ((mpair[c / 2] >> (8 * (c % 2))) & 0xffu) != 0;
        if (causal) ok = ok && key <= q0 + rl + 8 * (c / 2) + offset;
        valid |= (ok ? 1u : 0u) << (4 * j + c);
        if (!ok) sc[4 * j + c] = rdb::NEG_INF;
        mx[c / 2] = fmaxf(mx[c / 2], sc[4 * j + c]);
      }
    }
    float corr[2], neg_m[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float m = mx[hh];
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const float m_new = fmaxf(m_r[hh], m * scale2);
      corr[hh] = rdb::ex2(m_r[hh] - m_new);
      m_r[hh] = m_new;
      neg_m[hh] = -m_new;
    }
    // P (masked keys exactly 0) rounded to bf16 as the A fragments of PV;
    // the running sums take the unrounded p.
    uint32_t pa[4][4];
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[c] = ((valid >> (4 * j + c)) & 1u) ? rdb::ex2(fmaf(sc[4 * j + c], scale2, neg_m[c / 2]))
                                             : 0.f;
        ps[c / 2] += p[c];
      }
      pa[j / 2][(j % 2) * 2] = rdb::pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = rdb::pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l_r[hh] = l_r[hh] * corr[hh] + ps[hh];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
    // O += P V: four k16 steps of 16 keys, P from registers, V (a [key][dim]
    // tile: MN-major) from shared memory.
    const uint64_t vd = rdb::desc_sw128_mn(vst(s));
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) rdb::fence_regs(pa[kj]);
    rdb::fence_regs(o);
    rdb::wg_fence();
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) rdb::mma_rs_n64<true>(o, pa[kj], vd + (KV_BYTES / 4 / 16) * kj);
    rdb::wg_commit();
    rdb::wg_wait<0>();
    rdb::fence_regs(o);
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) rdb::fence_regs(pa[kj]);
    __syncwarp();
    if (lane == 0) rdb::mbar_arrive(empty(s));  // this warp is done with the stage
  }

  // l over the quad; out straight from the accumulators, columns < h, rows
  // < Tq; a row with no attended key has l == 0 and o == 0.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float l = l_r[hh];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l == 0.f ? 1.f : 1.f / l;
    const int row = q0 + rl + 8 * hh;
    if (row >= Tq) continue;
    __nv_bfloat16* orow = out + ((static_cast<size_t>(b) * Tq + row) * N + n) * h + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * j < h)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            rdb::pack_bf16(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
  }
}

// A tensor map over a [B, T, heads, H] bf16 view (element strides: batch
// bs, token ts, heads H apart), boxes of `rows` tokens x 64 columns of one
// head, 128-byte swizzled; out-of-bounds reads are zeros. A size-1
// dimension's stride is never used and is replaced by a legal one.
bool qkv_map(CUtensorMap* map, const void* base, int B, int T, int heads, int h, long long bs,
             long long ts, int rows) {
  rdb::EncodeTiled encode = rdb::tensor_map_encoder();
  if (encode == nullptr) return false;
  const long long hb = 2LL * h;
  const long long tsb = T == 1 ? hb * heads : 2 * ts;
  const long long bsb = B == 1 ? tsb * T : 2 * bs;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hb), static_cast<cuuint64_t>(tsb),
                                 static_cast<cuuint64_t>(bsb)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The keep-mask as [B or 1, Tq or 1, Tk] bytes (batch stride mbs, row
// stride mrs, 0 meaning one of them), boxes of 64 keys x 128 rows (x 1
// for a key row); keys past Tk and rows past Tq read as zeros.
bool mask_map(CUtensorMap* map, const void* base, int B, int Tq, int Tk, long long mbs,
              long long mrs) {
  rdb::EncodeTiled encode = rdb::tensor_map_encoder();
  if (encode == nullptr) return false;
  const int rows = mrs == 0 ? 1 : Tq, bats = mbs == 0 ? 1 : B;
  const long long rsb = mrs == 0 ? (Tk + 15) / 16 * 16 : mrs;
  const long long bsb = mbs == 0 ? rsb * rows : mbs;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(Tk), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(bats)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(rsb), static_cast<cuuint64_t>(bsb)};
  const cuuint32_t box[3] = {BK, static_cast<cuuint32_t>(mrs == 0 ? 1 : BQ), 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   const int8_t* mask, __nv_bfloat16* out, int B, int Tq, int Tk, int N, int K,
                   int h, Strides st, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tmq, tmk, tmv, tmm;
  std::memset(&tmm, 0, sizeof(tmm));
  if (!qkv_map(&tmq, q, B, Tq, N, h, st.qb, st.qt, BQ) ||
      !qkv_map(&tmk, k, B, Tk, K, h, st.kb, st.kt, BK) ||
      !qkv_map(&tmv, v, B, Tk, K, h, st.vb, st.vt, BK) ||
      (mask != nullptr && !mask_map(&tmm, mask, B, Tq, Tk, st.mb, st.mr)))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes((Tk + BK - 1) / BK);
  const cudaError_t err = set_smem(flash_long_kernel, smem);
  if (err != cudaSuccess) return err;
  flash_long_kernel<<<dim3((Tq + BQ - 1) / BQ, N, B), THREADS, smem, stream>>>(
      tmq, tmk, tmv, tmm, mask, out, Tq, Tk, N, K, h, st, scale, causal);
  return cudaGetLastError();
}

}  // namespace bodyc

// The bf16 body a call takes, by shape alone (the one rule: launch_bf16
// launches by it, rdb_flash_body reports it): 2 the vision body, when
// nothing masks and one head's K and V fit in shared memory (never for
// training, which needs body A's LSE); 3 body C, rows of 128 queries and
// more at HP 64 with no LSE (training stays on A); else 1, body A.
template <int HP>
cudaError_t bf16_body(int Tq, int Tk, bool masked, bool causal, bool lse, int* body) {
  if (!masked && !causal && !lse && Tq > 0 && Tk > 0) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    if (Vision<HP, HP>::smem(Tk) <= static_cast<size_t>(optin)) {
      *body = 2;
      return cudaSuccess;
    }
  }
  *body = HP == 64 && !lse && Tq >= bodyc::BQ ? 3 : 1;
  return cudaSuccess;
}

template <int HP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int8_t* mask, void* out, float* lse, int B, int Tq, int Tk,
                        int N, int K, int h, Strides st, float scale, int causal, int* body,
                        cudaStream_t stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const int ntiles = (Tk + TBK - 1) / TBK;
  cudaError_t err = bf16_body<HP>(Tq, Tk, mask != nullptr, causal != 0, lse != nullptr, body);
  if (err != cudaSuccess) return err;
  if (*body == 2) {
    const size_t smem = Vision<HP, HP>::smem(Tk);
    if constexpr (HP == 64)
      return launch_vision<64, 64>(qp, kp, vp, op, B, Tq, Tk, N, K, h, st, scale, smem, stream);
    else if (h <= 112)
      return launch_vision<128, 112>(qp, kp, vp, op, B, Tq, Tk, N, K, h, st, scale, smem,
                                     stream);
    else
      return launch_vision<128, 128>(qp, kp, vp, op, B, Tq, Tk, N, K, h, st, scale, smem,
                                     stream);
  }
  if constexpr (HP == 64) {
    if (*body == 3)
      return bodyc::launch(qp, kp, vp, mask, op, B, Tq, Tk, N, K, h, st, scale, causal, stream);
  }
  const size_t smem = FlashSmem<HP>::bytes(ntiles);
  auto kern = mask != nullptr && st.mr == 0 ? flash_bf16_kernel<HP, true>
                                            : flash_bf16_kernel<HP, false>;
  err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + TBQ - 1) / TBQ, N, B);
  kern<<<grid, 256, smem, stream>>>(qp, kp, vp, mask, op, lse, Tq, Tk, N, K, h, st, scale,
                                    causal);
  return cudaGetLastError();
}

// --- f32: the FMA body -----------------------------------------------------
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per KV tile
constexpr int TPR = 4;        // threads per query row
constexpr int THREADS = BQ * TPR;

template <typename T, int HP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int8_t* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int N,
                 int K, int h, Strides st, float scale, int causal) {
  constexpr int HP1 = HP + 1;     // padded smem row (odd: no bank conflicts)
  constexpr int DPT = HP / TPR;   // head dims per thread
  constexpr int KPT = BK / TPR;   // keys per thread per tile
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PSTRIDE = BK + 1;

  extern __shared__ float smem[];
  float* qs = smem;               // [BQ][HP1]
  float* ks = qs + BQ * HP1;      // [BK][HP1]
  float* vs = ks + BK * HP1;      // [BK][HP]
  float* ps = vs + BK * HP;       // [BQ][BK + 1] probabilities of this tile

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = n / (N / K);
  const int qi = q0 + row;
  const bool row_live = qi < Tq;

  const T* qb = q + b * st.qb + static_cast<size_t>(n) * h;
  const T* kb = k + b * st.kb + static_cast<size_t>(kvh) * h;
  const T* vb = v + b * st.vb + static_cast<size_t>(kvh) * h;
  const int8_t* mrow =
      (mask != nullptr && row_live) ? mask + b * st.mb + qi * st.mr : nullptr;

  // Stage the query tile; rows past Tq and columns past h are zero.
  for (int e = tid * VEC; e < BQ * HP; e += THREADS * VEC) {
    const int r = e / HP, d = e % HP;
    float tmp[VEC];
    if (q0 + r < Tq && d < h) {
      rdb::load_vec<T>(qb + (q0 + r) * st.qt + d, tmp);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) tmp[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) qs[r * HP1 + d + i] = tmp[i];
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
    for (int e = tid * VEC; e < BK * HP; e += THREADS * VEC) {
      const int r = e / HP, d = e % HP;
      float kt[VEC], vt[VEC];
      if (k0 + r < Tk && d < h) {
        rdb::load_vec<T>(kb + (k0 + r) * st.kt + d, kt);
        rdb::load_vec<T>(vb + (k0 + r) * st.vt + d, vt);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) kt[i] = vt[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        ks[r * HP1 + d + i] = kt[i];
        vs[r * HP + d + i] = vt[i];
      }
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) s[jj] = 0.f;
    for (int d = 0; d < HP; ++d) {
      const float qd = qs[row * HP1 + d];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) s[jj] += qd * ks[(part + TPR * jj) * HP1 + d];
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
      for (int i = 0; i < DPT; ++i) acc[i] += p * vs[j * HP + part + TPR * i];
    }
  }

  if (row_live) {
    const float denom = l_i == 0.f ? 1.f : l_i;  // no attended key -> 0
    T* ob = out + ((static_cast<size_t>(b) * Tq + qi) * N + n) * h;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      if (part + TPR * i < h) ob[part + TPR * i] = rdb::from_f<T>(acc[i] / denom);
    if (lse != nullptr && part == 0)
      lse[(static_cast<size_t>(b) * N + n) * Tq + qi] = l_i == 0.f ? 0.f : m_i + logf(l_i);
  }
}

template <typename T, int HP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int8_t* mask, void* out, float* lse, int B, int Tq, int Tk,
                   int N, int K, int h, Strides st, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (HP + 1) + BK * (HP + 1) + BK * HP + BQ * (BK + 1));
  auto kern = flash_fwd_kernel<T, HP>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, N, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), mask, static_cast<T*>(out), lse, Tq, Tk, N, K, h, st,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. H: a multiple of 8, at most 128.
// *_bs / *_ts: q, k and v's batch and token strides in elements (a token
// stride times Tq or Tk at most 2^31 - 1). mask: int8 [B, Tq, Tk] or null,
// with batch stride mask_bs and row stride mask_rs in bytes: multiples of
// 16, mask_rs 0 (one key row for all rows) or at least Tk, the pointer
// 16-byte aligned. Returns a cudaError_t (0 = launched). lse: null
// (serving), or a [B, N, Tq] f32 buffer that gets each row's log-sum-exp
// of the scaled scores (0 for a row with no attended key), the saved state
// of flash_attention_bwd.cu; a call with lse takes body A (or the f32
// body), never the vision body or body C. *body: the body launched — 0
// the f32 FMA body, 1 body A, 2 the vision body (B), 3 body C.
extern "C" int rdb_flash_attention(const void* q, const void* k, const void* v,
                                   const void* mask, long long mask_bs, long long mask_rs,
                                   void* out, int B, int Tq, int Tk, int N, int K, int H,
                                   long long q_bs, long long q_ts, long long k_bs,
                                   long long k_ts, long long v_bs, long long v_ts, float scale,
                                   int causal, int dtype, void* lse_out, void* stream,
                                   int* body) {
  const int8_t* m = static_cast<const int8_t*>(mask);
  float* lse = static_cast<float*>(lse_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr long long I32 = 0x7fffffffLL;
  if (body == nullptr || H <= 0 || H > 128 || H % 8 != 0 || q_ts * Tq > I32 || k_ts * Tk > I32 ||
      v_ts * Tk > I32)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m != nullptr && (mask_bs % 16 != 0 || mask_rs % 16 != 0 || mask_bs < 0 ||
                       (mask_rs != 0 && mask_rs < Tk) ||
                       reinterpret_cast<uintptr_t>(m) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_bs, k_bs, v_bs, static_cast<int>(q_ts), static_cast<int>(k_ts),
                   static_cast<int>(v_ts), mask_bs, mask_rs};
  const bool narrow = H <= 64;
  if (dtype == 0) {
    *body = 0;
    return narrow ? launch<float, 64>(q, k, v, m, out, lse, B, Tq, Tk, N, K, H, st, scale, causal, s)
                  : launch<float, 128>(q, k, v, m, out, lse, B, Tq, Tk, N, K, H, st, scale, causal, s);
  }
  if (dtype == 1)
    return narrow ? launch_bf16<64>(q, k, v, m, out, lse, B, Tq, Tk, N, K, H, st, scale, causal,
                                    body, s)
                  : launch_bf16<128>(q, k, v, m, out, lse, B, Tq, Tk, N, K, H, st, scale, causal,
                                     body, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The body rdb_flash_attention launches for a call of this shape (its
// rule, bf16_body; the f32 FMA body for dtype 0), written to *body as
// rdb_flash_attention reports it; launches nothing. Returns a cudaError_t.
extern "C" int rdb_flash_body(int Tq, int Tk, int H, int dtype, int masked, int causal, int lse,
                              int* body) {
  if (body == nullptr || H <= 0 || H > 128 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    *body = 0;
    return 0;
  }
  return static_cast<int>(H <= 64 ? bf16_body<64>(Tq, Tk, masked, causal, lse, body)
                                  : bf16_body<128>(Tq, Tk, masked, causal, lse, body));
}
