// Single-token decode attention over the budgeted KV ring buffer, with the
// eviction probabilities emitted in the same pass: two entry points on one
// kernel body.
//
// `decode_attend_inflight` replaces the TPU kernel
// easykv_tpu/ops/pallas/decode_attention.py `fused_decode_attend_inflight`
// (body `_kernel_inflight`): the current token's K/V joins the softmax in
// flight, float or int8 KV, optional sliding window, and two StreamingLLM
// variants that rotate each cached K row by a row of f32 cos/sin tables
// (S, D/2), [x1*c - x2*s, x2*c + x1*s], before its QK product:
//   * `ordered` (the age-ordered, rotate-at-read cache of `decoding`): the
//     row at slot s by table row s;
//   * `rank` (the unordered cache of the encoding family): the row at slot
//     s by table row rank[b, h, s], its age rank (0 <= rank < S).
// An int8 row is rotated raw (rotation is linear) and its scale still folds
// into the logit. The TPU kernel builds the rotation from split-bf16 tables
// on its matrix unit (for `rank`, a two-level one-hot pick, R(128*qh) o
// R(m)); here the f32 table row itself is copied next to the K row, which
// computes the same rotation.
//
// `decode_attend` replaces `fused_decode_attend` (body `_kernel`): the same
// attention over a cache that already holds the token's row, with no
// in-flight term and no p_new; float or int8 KV and the sliding window, no
// rotation (the TPU kernel has none). The in-flight term is a template flag
// of the one body, compiled out of this entry.
//
// What bounds it on an H100: bytes. Each launch reads the K and V rows of
// one layer's visible slots once (11.7 MB at LLaMa-2-7B width with 712 of
// 768 slots visible, bf16; half that for an int8 cache) and does
// 4*B*Hq*S*D flops, ~0.5 flop per byte (1 for int8), far below the card's
// balance point. One block per (batch, kv-head) was 32 blocks on 132 SMs
// at B = 1, each pulling its whole head through a few rows in flight, and
// each block's rows went through its softmax and PV one after the other.
// The design:
//   * S splits over a thread-block cluster of c blocks per (batch, kv-head)
//     (ops/cuda/decode_attention.py split_plan: c a power of two up to 8,
//     so that the grid holds about one block an SM; c = 1 from 128 pairs):
//     block `rank` takes the contiguous run of 32-row tiles [rank*nt/c,
//     (rank+1)*nt/c). A block's shared memory stays within half an SM's
//     where the run allows, so that every cluster is resident at once
//     (clusters of 4 blocks, one an SM, did not all fit the GPCs: the grid
//     ran in two waves);
//   * every K and V tile of the run goes into shared memory by 16-byte
//     asynchronous copies (cp.async), a warp a tile, each lane's completion
//     counted on the tile's mbarrier, all of them issued at the block's
//     start where the run fits (S = 768, c = 4: 96 KB a block in bf16), else
//     in rounds of a ring of K tiles and one of V tiles: V no longer waits
//     for the softmax, and no register holds a row in flight. (One thread's
//     bulk copies, cp.async.bulk, of whole tiles were tried first: the
//     copies trickled in at ~7 GB/s an SM.) Masked rows are copied too (7%
//     of the bytes at the main path's 712 of 768; skipping them would put
//     pos's read before the first copy) and get -inf logits and zero
//     weights as before;
//   * the logits take a row a thread (the one-block kernel's lanes took 16
//     of a row and paid a shuffle tree and a dependent chain a row): a K
//     row's 16-byte chunks sit swizzled (chunk e of row r at e ^ (r mod
//     chunks)), so that a warp's rows read distinct banks, and a row's dot
//     sums each chunk in order and then the chunks pairwise in bit-reversed
//     order, which is the tree the lanes' shuffles formed: the same bits;
//   * the rotated variants copy each row's f32 table rows beside it (the
//     `ordered` tile's rows [s0, s0 + 32), the `rank` tile's rows of its
//     ranks, read from shared memory), so the gather is the copies', not the
//     registers'; a thread rotates chunk e with chunk e + chunks / 2, which
//     sit one step apart in the bit-reversed order, products rounded one
//     by one as before;
//   * the softmax spans the cluster and rounds as the one-block kernel did:
//     each block takes its local max, the cluster max comes through
//     distributed shared memory (max is exact in any order), every block
//     computes e = exp(l - m) with that global m, the block sums add in rank
//     order plus e_new into denom, p = e / denom; so each probability entry
//     is the one-block kernel's but for the order of denom's f32 sum;
//   * PV: each block's f32 partial over its run (threads = (row group, rep
//     row, lane-in-row), groups added in order), then rank r adds the c
//     partials of its D/c columns in rank order, plus p_new * vn. No
//     workspace, no ticket, no second launch: the same bits on every launch
//     and on any stream.
//
// Per block:
//   1. q's rep rows go to shared memory as fp32, with the run's pos (and
//      int8 scales, ranks);
//   2. logits: dot(q_r, k_s) * scale (* k_scale[s] for int8 K) for every
//      visible slot s and row r, -inf for a masked slot (pos < 0,
//      pos > q_pos, outside the window);
//   3. per r: m = max(-1e30, logits of every block, logit_new); e = exp(l -
//      m); denom = max(sum e + e_new, 1e-30); p = e / denom; p_new = e_new
//      / denom (without the in-flight term: logit_new = -1e30, e_new = 0);
//   4. out[r] = sum_s p[r][s] (* v_scale[s]) * v[s] + p_new[r] * vn (fp32
//      accumulation; the int8 cache is never dequantized into a copy, and
//      the in-flight vn stays in q's type);
//   5. probs[s] = mean_r p[r][s], p_new = mean_r p_new[r].
// Built with -DK1_NO_TABLES (a diagnostic build) the rank variant copies no
// table rows and rotates by whatever its slots hold: its time without the
// gather; with -DK1_STAMPS four blocks read the clock at each step
// (tools/torch_k1_k10_times.py --stamps).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "decode_common.cuh"
#include "tma_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace decode_common;
using namespace tma_ring;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;          // cache rows a tile: one a lane of the warp that copies it
constexpr int kMaxCluster = 8;
constexpr int kMaxPasses = 4;      // rep rows a PV thread keeps: 1, or up to this many
constexpr size_t kSmemLimit = 232448;

// 16 bytes from global memory into shared memory, asynchronously (L2 only)
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Arrives on `bar` once this thread's earlier asynchronous copies have landed
// (the barrier counts that arrival among its expected ones).
__device__ __forceinline__ void cp_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

#ifdef K1_NO_TABLES
constexpr bool kRankTables = false;   // diagnostic build: the rank variant gathers no table rows
#else
constexpr bool kRankTables = true;
#endif

#ifdef K1_STAMPS
// diagnostic build: thread 0 of blocks 0 and 1 and of the grid's last two
// blocks reads the nanosecond clock at each step (slots 0..15) and as it
// passes each K tile's (16..47) and V tile's (48..63) barrier
constexpr int kStampSlots = 64;
__device__ unsigned long long k1_stamps[4][kStampSlots];
__device__ __forceinline__ void stamp(int i) {
  const int b = blockIdx.x < 2 ? (int)blockIdx.x
                               : ((int)blockIdx.x >= (int)gridDim.x - 2
                                      ? 4 - ((int)gridDim.x - (int)blockIdx.x) : -1);
  if (threadIdx.x == 0 && b >= 0 && i < kStampSlots) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    k1_stamps[b][i] = t;
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

// The shared-memory layout of a block, from a 128-byte aligned base
// (mirrored by ops/cuda/decode_attention.py split_smem): the K ring (nk
// slots: a tile's rows, then with a rotation its cos and sin table rows;
// after the logits it holds the PV partials of the thread groups), the V
// ring (nv slots), q (rep, D) f32, the logits (rep, nmax) f32, the run's
// pos (and int8 scales, ranks), six rep-long f32 arrays and the warps'
// (rep, kWarps) reduce, the block's PV partial (rep, D) f32, the slots'
// mbarriers; 128 bytes of slack for the alignment. rot: 0 none, 1 ordered,
// 2 rank.
struct Geo {
  int lpr, rpt, groups, passes, nt, tpb, nmax;
  size_t kslot, vslot, kring, vring, qs, lg, pos, ksc, vsc, rank, small, part, bars, total;
};

__host__ __device__ inline Geo geometry(int rep, int S, int D, int ekv, int rot, int c, int nk,
                                        int nv) {
  Geo g;
  g.lpr = D / (16 / ekv);
  g.rpt = rep < kThreads / g.lpr ? rep : kThreads / g.lpr;
  g.groups = kThreads / (g.lpr * g.rpt);
  g.passes = (rep + g.rpt - 1) / g.rpt;
  g.nt = (S + kTile - 1) / kTile;
  g.tpb = (g.nt + c - 1) / c;
  g.nmax = g.tpb * kTile;
  g.kslot = align_to((size_t)kTile * D * ekv + (rot ? (size_t)kTile * D * 4 : 0), 128);
  g.vslot = align_to((size_t)kTile * D * ekv, 128);
  const size_t pv = (size_t)g.groups * rep * D * 4;
  const size_t kr = (size_t)nk * g.kslot > pv ? (size_t)nk * g.kslot : pv;
  const size_t meta = (size_t)g.nmax * 4;
  g.kring = 0;
  g.vring = align_to(kr, 128);
  g.qs = g.vring + (size_t)nv * g.vslot;
  g.lg = g.qs + (size_t)rep * D * 4;
  g.pos = g.lg + (size_t)rep * g.nmax * 4;
  g.ksc = g.pos + meta;
  g.vsc = g.ksc + (ekv == 1 ? meta : 0);
  g.rank = g.vsc + (ekv == 1 ? meta : 0);
  g.small = g.rank + (rot == 2 ? meta : 0);
  g.part = g.small + (size_t)(6 + kWarps) * rep * 4;
  g.bars = align_to(g.part + (size_t)rep * D * 4, 8);
  g.total = 128 + g.bars + (size_t)(nk + nv) * 8;
  return g;
}

template <typename KV>
__host__ __device__ inline bool shape_ok(int D) {
  const int v = 16 / (int)sizeof(KV);
  const int lpr = D / v;
  return D % v == 0 && lpr >= 1 && lpr <= 32 && (lpr & (lpr - 1)) == 0;
}

// Whether one launch with this plan can run: D a row of 1..32 sixteen-byte
// loads (a power of two), a rotation's table rows whole 16-byte copies (D %
// 8 == 0), 1 <= c <= min(8, tiles), 1..tiles-a-block slots a ring, at most
// kMaxPasses rep rows a PV thread, and the layout within the card's
// shared memory.
template <typename KV>
bool plan_ok(int rep, int S, int D, int rot, int c, int nk, int nv) {
  if (rep < 1 || S < 1 || !shape_ok<KV>(D) || (rot && D % 8)) return false;
  const Geo g = geometry(rep, S, D, (int)sizeof(KV), rot, c, nk, nv);
  return c >= 1 && c <= kMaxCluster && c <= g.nt && nk >= 1 && nv >= 1 && nk <= g.tpb &&
         nv <= g.tpb && g.passes <= kMaxPasses && g.total <= kSmemLimit;
}

// T: the type of q, kn, vn and out; KV: the cache's type (T, or int8 with
// per-slot scales ksc / vsc). kInflight: the in-flight token (kn, vn,
// p_new); without it those pointers are null and unread. NP: 1, or
// kMaxPasses where rep exceeds the rows one pass of the PV threads covers.
// grid: (B * Hkv) x c blocks in clusters of c consecutive blocks.
template <typename T, typename KV, bool kInflight, int NP, int ROT>
__global__ void __launch_bounds__(kThreads, 2)
decode_attend_kernel(const T* __restrict__ q, const T* __restrict__ kn, const T* __restrict__ vn,
                     const KV* __restrict__ k, const KV* __restrict__ v,
                     const int* __restrict__ pos, const int* __restrict__ q_pos,
                     const float* __restrict__ ksc, const float* __restrict__ vsc,
                     const float* __restrict__ rcos, const float* __restrict__ rsin,
                     const int* __restrict__ rank, T* __restrict__ out,
                     float* __restrict__ probs, float* __restrict__ p_new, int Hkv, int rep,
                     int S, int D, float scale, int window, int nk, int nv) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int V = VecOf<KV>::n;  // cache elements per 16 bytes
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks(), crank = (int)cluster.block_rank();
  constexpr int rot = ROT;   // 0 none, 1 ordered, 2 rank (rcos, rank given accordingly)
  const Geo geo = geometry(rep, S, D, (int)sizeof(KV), rot, c, nk, nv);
  const int LPR = geo.lpr, nmax = geo.nmax;
  unsigned char* kring = smem + geo.kring;
  unsigned char* vring = smem + geo.vring;
  float* qs = reinterpret_cast<float*>(smem + geo.qs);
  float* lg = reinterpret_cast<float*>(smem + geo.lg);       // logits, then probabilities
  int* pos_s = reinterpret_cast<int*>(smem + geo.pos);
  float* ksc_s = reinterpret_cast<float*>(smem + geo.ksc);
  float* vsc_s = reinterpret_cast<float*>(smem + geo.vsc);
  int* rank_s = reinterpret_cast<int*>(smem + geo.rank);
  float* lnew = reinterpret_cast<float*>(smem + geo.small);  // logit_new
  float* cmax = lnew + rep;   // the block's max (read by the cluster)
  float* csum = cmax + rep;   // the block's sum of e (read by the cluster)
  float* gmax = csum + rep;   // the cluster's m
  float* gden = gmax + rep;   // denom
  float* pn = gden + rep;     // p_new
  float* red = pn + rep;      // (rep, kWarps)
  float* part = reinterpret_cast<float*>(smem + geo.part);   // the block's PV partial
  uint64_t* kfull = reinterpret_cast<uint64_t*>(smem + geo.bars);
  uint64_t* vfull = kfull + nk;

  const int bh = blockIdx.x / c, b = bh / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t0 = (int)((long long)crank * geo.nt / c);
  const int ntb = (int)((long long)(crank + 1) * geo.nt / c) - t0;   // tiles of the run
  const int r0 = t0 * kTile;
  const int nb = (S < (t0 + ntb) * kTile ? S : (t0 + ntb) * kTile) - r0;   // rows of the run
  const size_t row0 = (size_t)bh * S + r0;                     // its first cache row
  const int qp = q_pos[b];
  const bool live = qp >= 0;
  const int d2 = D / 2;
  const uint32_t row_bytes = (uint32_t)(D * sizeof(KV));

  auto tile_rows = [&](int j) { return nb - j * kTile < kTile ? nb - j * kTile : kTile; };
  // Every lane of one warp copies its share of a tile by 16-byte
  // asynchronous copies; each lane's completion arrives on the tile's
  // barrier (32 arrivals). K tile j: its rows, each row's 16-byte chunks
  // swizzled (chunk e of row r at e ^ (r mod LPR), so that threads reading
  // one chunk of consecutive rows hit distinct banks), then a rotation's
  // table rows (rank's read the run's ranks from shared memory), swizzled
  // the same way, then done. V tiles keep their rows as they are.
  const int CPR = LPR;                    // 16-byte chunks a cache row
  const int TPR = D / 8;                  // 16-byte chunks a table row (D / 2 floats)
  auto k_rows = [&](int j) {
    unsigned char* dst = kring + (size_t)(j % nk) * geo.kslot;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(k + (row0 + (size_t)j * kTile) * D);
    for (int e = lane; e < tile_rows(j) * CPR; e += 32) {
      const int r = e / CPR, ch = e % CPR;
      cp16(dst + (r * CPR + (ch ^ (r & (CPR - 1)))) * 16, src + e * 16);
    }
  };
  auto k_tables = [&](int j) {
    unsigned char* dst = kring + (size_t)(j % nk) * geo.kslot + kTile * row_bytes;
    const int n = tile_rows(j);
    if constexpr (rot == 0 || (rot == 2 && !kRankTables)) return;
    for (int e = lane; e < n * TPR; e += 32) {
      const int r = e / TPR, ch = e % TPR;
      int t = r0 + j * kTile + r;             // ordered: the slot is the table row
      if (rot == 2) {
        t = rank_s[j * kTile + r];
        t = t < 0 ? 0 : (t >= S ? S - 1 : t);
      }
      const int o = (r * TPR + (ch ^ (r & (TPR - 1)))) * 16;
      cp16(dst + o, rcos + (size_t)t * d2 + ch * 4);
      cp16(dst + kTile * D * 2 + o, rsin + (size_t)t * d2 + ch * 4);
    }
  };
  auto v_rows = [&](int j) {
    unsigned char* dst = vring + (size_t)(j % nv) * geo.vslot;
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(v + (row0 + (size_t)j * kTile) * D);
    for (int e = lane; e < tile_rows(j) * CPR; e += 32) cp16(dst + e * 16, src + e * 16);
  };

  if (tid == 0) {
    for (int i = 0; i < nk + nv; ++i) bar_init(kfull + i, 32);
  }
  __syncthreads();
  // the first round of both rings, warp w taking tiles w, w + kWarps, ...
  for (int j = warp; j < ntb && j < nk; j += kWarps) {
    k_rows(j);
    if (rot != 2) {
      k_tables(j);
      cp_arrive(kfull + j % nk);
    }
  }
  if (rot != 2)
    for (int j = warp; j < ntb && j < nv; j += kWarps) {
      v_rows(j);
      cp_arrive(vfull + j % nv);
    }
  stamp(1);
  for (int i = tid; i < rep * D; i += kThreads) qs[i] = to_f(q[(size_t)bh * rep * D + i]);
  for (int i = tid; i < nb; i += kThreads) {
    pos_s[i] = pos[row0 + i];
    if (kQuant) {
      ksc_s[i] = ksc[row0 + i];
      vsc_s[i] = vsc[row0 + i];
    }
    if (rot == 2) rank_s[i] = rank[row0 + i];
  }
  __syncthreads();
  stamp(2);
  if (rot == 2) {
    for (int j = warp; j < ntb && j < nk; j += kWarps) {
      k_tables(j);
      cp_arrive(kfull + j % nk);
    }
    for (int j = warp; j < ntb && j < nv; j += kWarps) {
      v_rows(j);
      cp_arrive(vfull + j % nv);
    }
  }

  for (int r = warp; r < rep; r += kWarps) {
    float acc = 0.f;
    if constexpr (kInflight) {
      for (int d = lane; d < D; d += 32) acc += qs[r * D + d] * to_f(kn[(size_t)bh * D + d]);
      acc = warp_sum(acc);
    }
    if (lane == 0) lnew[r] = kInflight && live ? acc * scale : kNegInf;
  }
  __syncthreads();

  // logits: a row a thread, in rounds of the K ring's tiles (one round where
  // the ring holds the run). A row's dot sums each 16-byte chunk's V
  // products in order, then the chunks pairwise in bit-reversed order: the
  // tree the one-block kernel's lanes formed with their shuffles, so its
  // bits. The rotated variants rotate chunk c with chunk c + LPR / 2 (one
  // step apart in that order), products rounded one by one.
  const int bits = 31 - __clz(CPR);
  for (int t0k = 0; t0k < ntb; t0k += nk) {
    const int b_end = (t0k + nk) * kTile < nb ? (t0k + nk) * kTile : nb;
    for (int br = t0k * kTile + tid; br < b_end; br += kThreads) {
      const int tile = br >> 5, tr = br & (kTile - 1);
      bar_wait(kfull + tile % nk, (uint32_t)((tile / nk) & 1));
      if (tr == 0 && tile < 32) stamp(16 + tile);
      const int p = pos_s[br];
      const bool vis = p >= 0 && p <= qp && (window <= 0 || p > qp - window);
      const unsigned char* kt = kring + (size_t)(tile % nk) * geo.kslot;
      const KV* krow = reinterpret_cast<const KV*>(kt + tr * row_bytes);
      // the row's cos and sin table chunks (swizzled as the copies put them)
      const float* cta = reinterpret_cast<const float*>(kt + kTile * row_bytes) + tr * TPR * 4;
      auto tab = [&](int tc) { return (tc ^ (tr & (TPR - 1))) * 4; };
      for (int r = 0; r < rep; ++r) {
        float logit = 0.f;
        if (vis) {
          const float* qr = qs + r * D;
          float stack[6];
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            if (i >= CPR) break;
            float kr[2][V], part[2];
            int ch[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              ch[h] = bits ? (int)(__brev((unsigned)(i + h)) >> (32 - bits)) : 0;
              if (CPR > 1 || h == 0) load16(krow + (ch[h] ^ (tr & (CPR - 1))) * V, kr[h]);
            }
            if constexpr (rot != 0) {
              if (CPR >= 2) {     // chunk ch[0] < CPR / 2 pairs with ch[1] = ch[0] + CPR / 2
                float cv[V], sv[V];
                const int tc = ch[0] * V / 4;   // the table's 16-byte chunks of these elements
#pragma unroll
                for (int e4 = 0; e4 < V / 4; ++e4) {
                  load16(cta + tab(tc + e4), cv + 4 * e4);
                  load16(cta + kTile * d2 + tab(tc + e4), sv + 4 * e4);
                }
#pragma unroll
                for (int e = 0; e < V; ++e) {
                  const float x1 = kr[0][e], x2 = kr[1][e];
                  kr[0][e] = __fsub_rn(__fmul_rn(x1, cv[e]), __fmul_rn(x2, sv[e]));
                  kr[1][e] = __fadd_rn(__fmul_rn(x2, cv[e]), __fmul_rn(x1, sv[e]));
                }
              } else {            // one chunk a row: its halves pair
#pragma unroll
                for (int e = 0; e < V / 2; ++e) {
                  const float x1 = kr[0][e], x2 = kr[0][e + V / 2];
                  const float cs = cta[tab(e >> 2) + (e & 3)];
                  const float sn = cta[kTile * d2 + tab(e >> 2) + (e & 3)];
                  kr[0][e] = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
                  kr[0][e + V / 2] = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
                }
              }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (i + h >= CPR) break;
              float acc = 0.f;
#pragma unroll
              for (int e = 0; e < V; ++e) acc += qr[ch[h] * V + e] * kr[h][e];
              part[h] = acc;
            }
            // the pairwise sums of the chunks in order i, i + 1 (a binary counter)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n = i + h;
              if (n >= CPR) break;
              float vsum = part[h];
#pragma unroll
              for (int lv = 0; lv < 5; ++lv)
                if ((n >> lv) & 1) vsum = stack[lv] + vsum;
                else {
                  stack[lv] = vsum;
                  break;
                }
              if (n == CPR - 1) logit = vsum;
            }
          }
        }
        float xv = logit * scale;
        if (kQuant) xv *= ksc_s[br];
        lg[r * nmax + br] = vis ? xv : -INFINITY;
      }
    }
    if (t0k + nk < ntb) {   // the next round into the ring
      __syncthreads();
      for (int j = t0k + nk + warp; j < ntb && j < t0k + 2 * nk; j += kWarps) {
        k_rows(j);
        k_tables(j);
        cp_arrive(kfull + j % nk);
      }
    }
  }
  stamp(3);
  __syncthreads();
  stamp(4);

  // fp32 softmax per query row over the cluster; masked slots (-inf) get 0
  for (int r = 0; r < rep; ++r) {
    float m = kNegInf;
    for (int s = tid; s < nb; s += kThreads) m = fmaxf(m, lg[r * nmax + s]);
    m = warp_max(m);
    if (lane == 0) red[r * kWarps + warp] = m;
  }
  __syncthreads();
  for (int r = tid; r < rep; r += kThreads) {
    float m = kNegInf;
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[r * kWarps + w]);
    cmax[r] = m;
  }
  cluster.sync();
  stamp(5);
  if (warp == 0)   // lane j reads rank j's
    for (int r = 0; r < rep; ++r) {
      const float m = warp_max(lane < c ? cluster.map_shared_rank(cmax, lane)[r] : kNegInf);
      if (lane == 0) gmax[r] = fmaxf(m, lnew[r]);
    }
  __syncthreads();
  for (int r = 0; r < rep; ++r) {
    const float m = gmax[r];
    float sum = 0.f;
    for (int s = tid; s < nb; s += kThreads) {
      float* l = lg + r * nmax + s;
      const float e = *l == -INFINITY ? 0.f : expf(*l - m);
      *l = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) red[r * kWarps + warp] = sum;
  }
  __syncthreads();
  for (int r = tid; r < rep; r += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += red[r * kWarps + w];
    csum[r] = sum;
  }
  cluster.sync();
  stamp(6);
  if (warp == 0)   // the blocks' sums in rank order
    for (int r = 0; r < rep; ++r) {
      const float part_sum = lane < c ? cluster.map_shared_rank(csum, lane)[r] : 0.f;
      float sum = 0.f;
      for (int j = 0; j < c; ++j) sum += __shfl_sync(0xffffffffu, part_sum, j);
      if (lane == 0) {
        const float e_new = kInflight && live ? expf(lnew[r] - gmax[r]) : 0.f;
        const float denom = fmaxf(sum + e_new, 1e-30f);
        gden[r] = denom;
        pn[r] = e_new / denom;
      }
    }
  __syncthreads();
  for (int s = tid; s < nb; s += kThreads) {
    float acc = 0.f;
    for (int r = 0; r < rep; ++r) {
      float* l = lg + r * nmax + s;
      const float p = *l / gden[r];
      *l = p;
      acc += p;
    }
    probs[row0 + s] = acc / (float)rep;
  }
  if (kInflight && crank == 0 && tid == 0) {
    float acc = 0.f;
    for (int r = 0; r < rep; ++r) acc += pn[r];
    p_new[bh] = acc / (float)rep;
  }
  __syncthreads();
  stamp(7);

  // the run's P V: thread = (row group g, rep row rr [+ RPT p], lane-in-row
  // li), kUV rows of a thread at a time, in rounds of the V ring's tiles
  const int RPT = geo.rpt, G = geo.groups;
  const int li = tid % LPR, rr = (tid / LPR) % RPT, g = tid / (LPR * RPT);
  constexpr int kUV = NP == 1 ? 4 : 2;
  float acc[NP][V];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[p][e] = 0.f;
  for (int t0v = 0; t0v < ntb; t0v += nv) {
    const int t1v = t0v + nv < ntb ? t0v + nv : ntb;
    for (int j = t0v; j < t1v; ++j) {
      bar_wait(vfull + j % nv, (uint32_t)((j / nv) & 1));
      if (j < 16) stamp(48 + j);
    }
    const int b_end = t1v * kTile < nb ? t1v * kTile : nb;
    if (g < G)
      for (int b0 = t0v * kTile + g; b0 < b_end; b0 += kUV * G) {
        float w[kUV][NP], vr[kUV][V];
        bool any[kUV];
#pragma unroll
        for (int x = 0; x < kUV; ++x) {
          const int br = b0 + x * G;
          any[x] = false;
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            const int r = rr + p * RPT;
            w[x][p] = r < rep && br < b_end ? lg[r * nmax + br] : 0.f;
            if (kQuant && w[x][p] != 0.f) w[x][p] *= vsc_s[br];
            any[x] |= w[x][p] != 0.f;
          }
          if (any[x])
            load16(reinterpret_cast<const KV*>(vring + (size_t)((br >> 5) % nv) * geo.vslot) +
                       (size_t)(br & (kTile - 1)) * D + li * V,
                   vr[x]);
        }
#pragma unroll
        for (int x = 0; x < kUV; ++x)
          if (any[x])
#pragma unroll
            for (int p = 0; p < NP; ++p)
              if (w[x][p] != 0.f)
#pragma unroll
                for (int e = 0; e < V; ++e) acc[p][e] += w[x][p] * vr[x][e];
      }
    if (t1v < ntb) {   // the next round into the ring
      __syncthreads();
      for (int j = t1v + warp; j < ntb && j < t1v + nv; j += kWarps) {
        v_rows(j);
        cp_arrive(vfull + j % nv);
      }
    }
  }
  stamp(8);
  float* pvs = reinterpret_cast<float*>(kring);   // (G, rep, D): the K ring is done
  if (g < G)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int r = rr + p * RPT;
      if (r < rep)
#pragma unroll
        for (int e = 0; e < V; ++e) pvs[((size_t)g * rep + r) * D + li * V + e] = acc[p][e];
    }
  __syncthreads();
  for (int i = tid; i < rep * D; i += kThreads) {
    float o = 0.f;
    for (int gg = 0; gg < G; ++gg) o += pvs[(size_t)gg * rep * D + i];
    part[i] = o;
  }
  cluster.sync();
  stamp(9);
  // block `crank` adds the cluster's partials of its D / c columns, in rank order
  const int per = (D + c - 1) / c, d0 = crank * per;
  const int nd = D - d0 < per ? (D - d0 > 0 ? D - d0 : 0) : per;
  for (int i = tid; i < rep * nd; i += kThreads) {
    const int r = i / nd, d = d0 + i % nd;
    float pv[kMaxCluster];   // every rank's partial in flight, then added in rank order
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      pv[j] = j < c ? cluster.map_shared_rank(part, j)[r * D + d] : 0.f;
    float o = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < c) o += pv[j];
    if constexpr (kInflight) o += pn[r] * to_f(vn[(size_t)bh * D + d]);
    out[((size_t)bh * rep + r) * D + d] = from_f<T>(o);
  }
  stamp(10);
  cluster.sync();   // no block leaves while another reads its partial
  stamp(11);
}

template <typename T, typename KV, bool kInflight>
int launch(const void* q, const void* kn, const void* vn, const void* k, const void* v,
           const int* pos, const int* q_pos, const float* ksc, const float* vsc,
           const float* rcos, const float* rsin, const int* rank, void* out, float* probs,
           float* p_new, int B, int Hkv, int rep, int S, int D, float scale, int window, int c,
           int nk, int nv, cudaStream_t stream) {
  const int rot = rcos == nullptr ? 0 : (rank == nullptr ? 1 : 2);
  if (B < 1 || Hkv < 1 || !plan_ok<KV>(rep, S, D, rot, c, nk, nv))
    return (int)cudaErrorInvalidValue;
  if (std::is_same<KV, int8_t>::value && (ksc == nullptr || vsc == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geo geo = geometry(rep, S, D, (int)sizeof(KV), rot, c, nk, nv);
  auto kernel = geo.passes == 1 ? decode_attend_kernel<T, KV, kInflight, 1, 0>
                                : decode_attend_kernel<T, KV, kInflight, kMaxPasses, 0>;
  if constexpr (kInflight) {   // the rotated variants take the in-flight entry only
    if (rot == 1)
      kernel = geo.passes == 1 ? decode_attend_kernel<T, KV, kInflight, 1, 1>
                               : decode_attend_kernel<T, KV, kInflight, kMaxPasses, 1>;
    if (rot == 2)
      kernel = geo.passes == 1 ? decode_attend_kernel<T, KV, kInflight, 1, 2>
                               : decode_attend_kernel<T, KV, kInflight, kMaxPasses, 2>;
  }
  const cudaError_t ea =   // on the current device, for this launch's size
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.total);
  if (ea != cudaSuccess) return (int)ea;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * Hkv * c));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = geo.total;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)c;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)q, (const T*)kn, (const T*)vn, (const KV*)k, (const KV*)v, pos,
      q_pos, ksc, vsc, rcos, rsin, rank, (T*)out, probs, p_new, Hkv, rep, S, D, scale, window,
      nk, nv);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// One launch of either entry: the cache type picks KV, `dtype` T.
template <bool kInflight>
int dispatch(const void* q, const void* kn, const void* vn, const void* k, const void* v,
             const int* pos, const int* q_pos, const float* ksc, const float* vsc,
             const float* rcos, const float* rsin, const int* rank, void* out, float* probs,
             float* p_new, int B, int Hkv, int rep, int S, int D, float scale, int window,
             int dtype, int kv_int8, int c, int nk, int nv, cudaStream_t st) {
  if (dtype == 0 && kv_int8)
    return launch<float, int8_t, kInflight>(q, kn, vn, k, v, pos, q_pos, ksc, vsc, rcos, rsin,
                                            rank, out, probs, p_new, B, Hkv, rep, S, D, scale,
                                            window, c, nk, nv, st);
  if (dtype == 0)
    return launch<float, float, kInflight>(q, kn, vn, k, v, pos, q_pos, nullptr, nullptr, rcos,
                                           rsin, rank, out, probs, p_new, B, Hkv, rep, S, D,
                                           scale, window, c, nk, nv, st);
  if (dtype == 1 && kv_int8)
    return launch<__nv_bfloat16, int8_t, kInflight>(q, kn, vn, k, v, pos, q_pos, ksc, vsc,
                                                    rcos, rsin, rank, out, probs, p_new, B, Hkv,
                                                    rep, S, D, scale, window, c, nk, nv, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, kInflight>(
        q, kn, vn, k, v, pos, q_pos, nullptr, nullptr, rcos, rsin, rank, out, probs, p_new, B,
        Hkv, rep, S, D, scale, window, c, nk, nv, st);
  return (int)cudaErrorInvalidValue;
}

template <typename KV>
size_t smem_of(int rep, int S, int D, int rot, int c, int nk, int nv) {
  if (!plan_ok<KV>(rep, S, D, rot, c, nk, nv)) return 0;
  return geometry(rep, S, D, (int)sizeof(KV), rot, c, nk, nv).total;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of a launch with this plan takes, in
// bytes; 0 if the plan or D is not supported (a cache row must be 1..32
// sixteen-byte loads, a power of two; see plan_ok). dtype: 0 = float32, 1 =
// bfloat16; kv_int8: 1 for an int8 cache; rot: 0 none, 1 ordered, 2 rank;
// cluster, nk, nv: ops/cuda/decode_attention.py split_plan.
size_t decode_attend_inflight_smem(int rep, int S, int D, int dtype, int kv_int8, int rot,
                                   int cluster, int nk, int nv) {
  if (kv_int8) return smem_of<int8_t>(rep, S, D, rot, cluster, nk, nv);
  if (dtype == 0) return smem_of<float>(rep, S, D, rot, cluster, nk, nv);
  if (dtype == 1) return smem_of<__nv_bfloat16>(rep, S, D, rot, cluster, nk, nv);
  return 0;
}

// q, kn, vn and out share `dtype`; k and v too, unless kv_int8 = 1: then
// they are int8 with per-slot dequant scales k_scale, v_scale (B, Hkv, S)
// f32 (null otherwise). Every pointer of q..v is 16-byte aligned.
// rot_cos, rot_sin (S, D/2) f32, 16-byte aligned: the cached K row at slot
// s rotates by their row s (ordered), or by their row rank[b, h, s] when
// rank (B, Hkv, S) int32 is given; null for no rotation (rank then null
// too). window <= 0: no sliding window. cluster, nk, nv: the plan (blocks a
// (b, kv head), K and V ring slots). Returns the launch's error or
// cudaGetLastError().
int decode_attend_inflight(const void* q, const void* kn, const void* vn, const void* k,
                           const void* v, const int* pos, const int* q_pos,
                           const float* k_scale, const float* v_scale, const float* rot_cos,
                           const float* rot_sin, const int* rank, void* out,
                           float* probs, float* p_new, int B, int Hkv, int rep, int S,
                           int D, float scale, int window, int dtype, int kv_int8, int cluster,
                           int nk, int nv, void* stream) {
  if ((rot_cos == nullptr) != (rot_sin == nullptr)) return (int)cudaErrorInvalidValue;
  if (rank != nullptr && rot_cos == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, kn, vn, k, v, pos, q_pos, k_scale, v_scale, rot_cos, rot_sin, rank,
                        out, probs, p_new, B, Hkv, rep, S, D, scale, window, dtype, kv_int8,
                        cluster, nk, nv, (cudaStream_t)stream);
}

// The same attention over a cache that already holds the query token's row:
// no in-flight token, no p_new, no rotation. Arguments as above.
int decode_attend(const void* q, const void* k, const void* v, const int* pos,
                  const int* q_pos, const float* k_scale, const float* v_scale, void* out,
                  float* probs, int B, int Hkv, int rep, int S, int D, float scale, int window,
                  int dtype, int kv_int8, int cluster, int nk, int nv, void* stream) {
  return dispatch<false>(q, nullptr, nullptr, k, v, pos, q_pos, k_scale, v_scale, nullptr,
                         nullptr, nullptr, out, probs, nullptr, B, Hkv, rep, S, D, scale, window,
                         dtype, kv_int8, cluster, nk, nv, (cudaStream_t)stream);
}

#ifdef K1_STAMPS
// The diagnostic build's clock readings: 4 x kStampSlots u64 to `out`,
// then cleared.
int decode_attend_stamps(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k1_stamps, sizeof(k1_stamps));
  void* addr = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&addr, k1_stamps);
  if (e == cudaSuccess) e = cudaMemset(addr, 0, sizeof(k1_stamps));
  return (int)e;
}
#endif

}  // extern "C"
