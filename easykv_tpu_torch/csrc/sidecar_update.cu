// Per-step sidecar pass of a budgeted decode step, with the step's gated
// eviction folded in (kernel K2), and the stand-alone gated eviction event
// (kernel K4).
//
// K2 replaces the TPU kernel easykv_tpu/ops/pallas/sidecar_update.py
// `fused_write_update` (body `_write_kernel`, victim selection
// `_select_victim`), decode phase, k = 1, with or without the int8 cache's
// dequant-scale rows, with or without `compact`.
//
// For each (layer, batch, kv-head) row of S slots:
//   1. write slot = first slot with pos < 0 (slot 0 if the row is full);
//   2. score / score_sq update from this step's probabilities per policy
//      (h2o_head and roco accumulate, tova overwrites), under update_gate;
//   3. when the row is live: the new token's sidecars at the write slot
//      and, with an int8 cache, its K and V dequant scales there, in place;
//      a dead row (token_valid off) is left untouched, as the JAX package's
//      XLA decode write leaves it (its TPU kernel writes the scales, and the
//      rows of step 5, whatever the row, into a slot whose pos stays < 0);
//   4. when evict_gate fires: counter += 1 on every slot, victim selection
//      (h2o_head / tova: first minimum score; recency: oldest position;
//      random: the slot at age rank rand_rank; roco: the lowest mean score
//      among the feasible_k lowest stds, the k-th smallest std found
//      exactly by a 31-step bisection over its bit pattern), pos[victim]=-1;
//      with `compact` (ordered StreamingLLM decoding, pre-rotated cache)
//      the row's pos, score, score_sq and bumped counter shift down by one
//      at and above the victim instead (slot S-1 takes slot 0's values,
//      as jnp.roll does, and pos -1), and the victim slot (S when the gate
//      is off or no slot is a candidate) goes out for the K/V shift (K9);
//   5. with the step's K and V rows (kn, vn; the former kernel K3, which
//      replaces the TPU kernel easykv_tpu/ops/pallas/row_write.py
//      `write_rows`): the row's K and V at the write slot of step 1 (before
//      any `compact` shift, where K9 then moves them), when the row is live.
//
// K4 replaces `fused_evict` (body `_evict_kernel`), decode phase, k = 1:
// per row, counter += 1 under the gate, the same victim selection, and
// pos[victim] = -1. It runs after K2 when the eviction is not folded
// (ordered StreamingLLM decoding with the rotate-at-read cache).
//
// What bounds them on an H100: bytes. K2 reads pos, score, score_sq,
// counter and probs and writes score, score_sq and counter back: 32 bytes a
// slot, 25 MB per step at LLaMa-2-7B width and S=768. Without `compact` pos
// changes at two slots a row (the write slot and the victim), and only those
// two are stored; with it, pos changes from the victim on, but the kernel
// stores the whole row (4 bytes a slot above the bound). The scale rows cost
// 16 bytes a row, not a slot: the TPU kernel rewrites both (S,) rows in
// VMEM, here the two new scales are stored at the slot and the rest of each
// row is never touched (the same result, since the update is in place). K4
// reads the four sidecars and writes counter back: 20 bytes a slot (a row
// whose gate is off reads and writes only its counters).
//
// Step 5 moves 2 Dh elements a row (1 MB a step at LLaMa-2-7B width in
// bf16, 0.3 us at 3.35 TB/s), less than a launch of its own costs: as a
// kernel of its own (K3) it was bound by its launch, so K2 does it. The
// lane group that owns the row (its warp; on the wide path the block's
// first warp) loads the two rows with the sidecars, 16 bytes a lane (a
// bf16 Dh = 128 row pair is one load a lane, int8 16 lanes), and stores
// them once the write slot is chosen, before the selection. The copy is
// byte-wise, so every element type takes it.
//
// The rows are independent, so a warp owns a row of up to 768 slots (the
// launch plan is sidecar_update.row_plan, which this file checks): each
// lane holds its share of the row's pos, score, score_sq and counter in
// registers, in chunks of four slots (chunk j of lane t: slots 4 (t + 32 j)
// .. 4 (t + 32 j) + 3, so a warp's lanes move 512 contiguous bytes of an
// array a chunk), loaded as 16-byte vectors, all issued before the first
// use, and stored the same way (scalar accesses where S % 4 != 0 or a base
// is not 16-byte aligned). Every reduction is warp-synchronous
// (__reduce_add_sync / __reduce_min_sync, shuffles for the NaN-propagating
// float minimum, a lane's own values reduced pairwise): the selection has
// no block barrier. The bisection counts all keys only until the keys left
// inside its interval fit 8 a lane; they then move to registers of their
// own (and at 1 a lane again, counted by a ballot), so most of its 31 steps
// count a few keys. Roco's std is computed only for the candidates it
// decides (the others' keys are constants) and a mean only for the slots
// among the k lowest stds. Without `compact` the row is stored before its
// selection (only pos[victim] changes after it). Past 768 slots a row takes
// the wide path: a block of 8 warps keeps the row in shared memory (20
// bytes a slot) and walks it strided, one barrier a reduction step. The
// compact shift is a move within each lane's chunks plus one shuffle a
// chunk. The arithmetic is the plain version's, op by op, and this file is
// built with --fmad=false so that no multiply-add is contracted: victims,
// slots and sidecars are bit-exact with it. The float minimum stays a float
// reduction, so a NaN minimum matches no slot (victim S) and -0.0 equals
// +0.0 (the first zero wins), as in the plain version.
//
// Diagnostic builds: -DK2_NO_SELECT leaves the eviction event out (K2: the
// load, update and store alone; K4: the counter pass alone); -DK2_STAMPS
// has thread 0 of blocks 0, 1 and the grid's last two read the nanosecond
// clock at each phase (tools/torch_k2_k4_times.py --stamps).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTeamWarps = 8;             // a row's warps at most; the wide path's block
constexpr int kBlock = 32 * kTeamWarps;   // threads a block at most
constexpr unsigned kAll = 0xffffffffu;
constexpr int kIntMax = 0x7fffffff;
constexpr float kForce = 1e9f;      // policies.STD_FORCE
constexpr float kExclude = 1e30f;   // policies.STD_EXCLUDE
constexpr int kStdGuard = 10;       // policies.ROCO_STD_GUARD

enum Policy { kNone = 0, kH2O = 1, kRoco = 2, kTova = 3, kRecency = 4, kRandom = 5 };

#ifdef K2_STAMPS
// phases: 0 start, 1 row loaded and updated, 2 write slot chosen, 3 counters
// bumped, 4 selection keys, 5 k-th smallest, 6 victim, 7 shift, 8 end;
// inside the k-th smallest: 9 the first interval small enough to pack, 10
// packed, 11 small enough for one key a thread, 12 packed again; and
// over every block, the last end in [0][15] and the first start, bits
// flipped, in [1][15]
constexpr int kStampSlots = 16;
__device__ unsigned long long k2_stamps[4][kStampSlots];
__device__ __forceinline__ void stamp(int i) {
  const int b = blockIdx.x < 2 ? (int)blockIdx.x
                               : ((int)blockIdx.x >= (int)gridDim.x - 2
                                      ? 4 - ((int)gridDim.x - (int)blockIdx.x) : -1);
  if (threadIdx.x == 0 && (b >= 0 || i == 0 || i == 8)) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (b >= 0) k2_stamps[b][i] = t;
    if (i == 0) atomicMax(&k2_stamps[1][kStampSlots - 1], ~t);
    if (i == 8) atomicMax(&k2_stamps[0][kStampSlots - 1], t);
  }
}
#else
__device__ __forceinline__ void stamp(int) {}
#endif

// ---------------------------------------------------------------------------
// per-slot arithmetic (the plain version's, op by op), shared by both paths
// ---------------------------------------------------------------------------

// min that propagates NaN, as jnp.min / torch.amin do
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : ((b != b) ? b : (a < b ? a : b));
}

// step 2: the slot's score / score_sq update from this step's probability
__device__ __forceinline__ void update_slot(int policy, float pr, float gf, bool g_upd, float& c,
                                            float& q) {
  if (policy == kH2O || policy == kRoco) {
    c = c + pr * gf;
    if (policy == kRoco) q = q + pr * pr * gf;
  } else if (policy == kTova) {
    c = g_upd ? pr : c;
  }
}

__device__ __forceinline__ bool in_base(int p, int plen, int protect) {
  return p >= 0 && (!protect || p >= plen);
}

// roco's key: the bit pattern of the slot's std (forced near the newest
// position, excluded outside the candidates); non-negative floats keep
// their order as int32
__device__ __forceinline__ int roco_key(int p, float c, float q, float n, int npos, int plen,
                                        int protect) {
  const float mean = c / n;
  const float var = q / n - mean * mean;
  float std = sqrtf(var != var ? var : (var > 0.f ? var : 0.f));
  if (p >= npos - kStdGuard) std = kForce + (float)p * 1024.0f;
  if (!in_base(p, plen, protect)) std = kExclude;
  return __float_as_int(std);
}

// random's key: the position of a candidate, else INT_MAX
__device__ __forceinline__ int random_key(int p, int plen, int protect) {
  return in_base(p, plen, protect) ? p : kIntMax;
}

// h2o_head / tova / recency: the value whose first minimum is the victim
__device__ __forceinline__ float min_value(int policy, int p, float c, int npos, int plen,
                                           int recent_window, int protect) {
  bool cand = in_base(p, plen, protect);
  float x;
  if (policy == kRecency) {
    x = (float)p;
  } else {
    if (policy == kH2O) cand = cand && p < npos - recent_window;
    x = c;
  }
  return cand ? x : INFINITY;
}

// ---------------------------------------------------------------------------
// the threads that own a row
// ---------------------------------------------------------------------------

// A warp (the register path: its reductions need no barrier) or the whole
// block (the wide path, W warps: one barrier a reduction step, the warps'
// partials of consecutive reductions alternating between the two halves of
// `red`, so that a reduction never overwrites words the one before it is
// still reading).
template <bool SOLO>
struct Team {
  static constexpr bool kSolo = SOLO;
  int t, T;         // thread in the team, the team's threads
  int lane, warp;   // lane, warp in the team
  int W;            // the team's warps
  int* red;         // 2 x kTeamWarps words of shared memory
  int parity;
};

template <class TM>
__device__ __forceinline__ int* team_words(TM& tm) {
  int* buf = tm.red + tm.parity * kTeamWarps;
  tm.parity ^= 1;
  return buf;
}

template <class TM>
__device__ int team_sum(TM& tm, int x) {
  x = __reduce_add_sync(kAll, x);
  if constexpr (TM::kSolo) return x;
  int* buf = team_words(tm);
  if (tm.lane == 0) buf[tm.warp] = x;
  __syncthreads();
  int y = 0;
  for (int w = 0; w < tm.W; ++w) y += buf[w];
  return y;
}

template <class TM>
__device__ int team_min(TM& tm, int x) {
  x = __reduce_min_sync(kAll, x);
  if constexpr (TM::kSolo) return x;
  int* buf = team_words(tm);
  if (tm.lane == 0) buf[tm.warp] = x;
  __syncthreads();
  int y = kIntMax;
  for (int w = 0; w < tm.W; ++w) y = min(y, buf[w]);
  return y;
}

template <class TM>
__device__ float team_min_f(TM& tm, float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = nan_min(x, __shfl_xor_sync(kAll, x, o));
  if constexpr (TM::kSolo) return x;
  int* buf = team_words(tm);
  if (tm.lane == 0) buf[tm.warp] = __float_as_int(x);
  __syncthreads();
  float y = INFINITY;
  for (int w = 0; w < tm.W; ++w) y = nan_min(y, __int_as_float(buf[w]));
  return y;
}

// The team of this thread and its row; false for a warp past the last row.
// wib: the thread's warp in the block.
template <class TM>
__device__ __forceinline__ bool make_team(TM& tm, int W, int nrows, int* red, int& row,
                                          int& wib) {
  wib = threadIdx.x >> 5;
  tm.lane = threadIdx.x & 31;
  tm.W = W;
  tm.red = red;
  tm.parity = 0;
  if constexpr (TM::kSolo) {
    row = blockIdx.x * (blockDim.x >> 5) + wib;
    tm.t = tm.lane;
    tm.T = 32;
    tm.warp = 0;
  } else {
    row = blockIdx.x;
    tm.t = threadIdx.x;
    tm.T = blockDim.x;
    tm.warp = wib;
  }
  return row < nrows;
}

// ---------------------------------------------------------------------------
// the register path: a lane's share of the row in NCH chunks of 4 slots
// ---------------------------------------------------------------------------

template <int NCH>
struct Share {
  int p[NCH][4];
  float c[NCH][4], q[NCH][4], n[NCH][4];
};

template <class TM>
__device__ __forceinline__ int slot_of(const TM& tm, int j, int e) {
  return 4 * (tm.t + tm.T * j) + e;
}

// a lane's N values reduced pairwise (depth log2 N, not a chain of N)
template <int N, typename T, typename Op>
__device__ __forceinline__ T tree(T (&v)[N], Op op) {
#pragma unroll
  for (int w = 1; w < N; w *= 2)
#pragma unroll
    for (int i = 0; i + w < N; i += 2 * w) v[i] = op(v[i], v[i + w]);
  return v[0];
}
struct AddI { __device__ int operator()(int a, int b) const { return a + b; } };
struct MinI { __device__ int operator()(int a, int b) const { return min(a, b); } };
struct MinF { __device__ float operator()(float a, float b) const { return nan_min(a, b); } };

// chunk at slot s0 of a row (slots at or past S: 0, never read again)
__device__ __forceinline__ void load4(int (&v)[4], const int* g, int s0, int S, bool vec) {
  if (vec && s0 + 4 <= S) {
    const int4 x = *reinterpret_cast<const int4*>(g + s0);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = s0 + e < S ? g[s0 + e] : 0;
  }
}
__device__ __forceinline__ void load4(float (&v)[4], const float* g, int s0, int S, bool vec) {
  if (vec && s0 + 4 <= S) {
    const float4 x = *reinterpret_cast<const float4*>(g + s0);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = s0 + e < S ? g[s0 + e] : 0.f;
  }
}
__device__ __forceinline__ void store4(int* g, const int (&v)[4], int s0, int S, bool vec) {
  if (vec && s0 + 4 <= S) {
    *reinterpret_cast<int4*>(g + s0) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (s0 + e < S) g[s0 + e] = v[e];
  }
}
__device__ __forceinline__ void store4(float* g, const float (&v)[4], int s0, int S, bool vec) {
  if (vec && s0 + 4 <= S) {
    *reinterpret_cast<float4*>(g + s0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (s0 + e < S) g[s0 + e] = v[e];
  }
}

// The warp's exclusive prefix sum of x in lane order, and its total.
__device__ int warp_scan(const Team<true>& tm, int x, int& total) {
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, inc, o);
    if (tm.lane >= o) inc += y;
  }
  total = __shfl_sync(kAll, inc, 31);
  return inc - x;
}

constexpr int kPack = 8;   // keys a lane keeps once the bisection's interval holds few

// How many of the warp's keys lie below cand.
template <int N>
__device__ __forceinline__ int count_below(const int (&k)[N], int cand, Team<true>& tm) {
  if constexpr (N == 1) {
    return __popc(__ballot_sync(kAll, k[0] < cand));
  } else {
    int c[N];
#pragma unroll
    for (int m = 0; m < N; ++m) c[m] = k[m] < cand;
    return team_sum(tm, tree(c, AddI()));
  }
}

// The warp's keys in [lo, lo + bit) to `pack`, in lane order, then M of
// them to each lane's `out` (strided by the warp; INT_MAX past the last).
template <int N, int M>
__device__ __forceinline__ void pack_keys(const int (&k)[N], int lo, int bit, Team<true>& tm,
                                          int* pack, int (&out)[M]) {
  bool inside[N];
  int in = 0;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    inside[m] = k[m] >= lo && k[m] - lo < bit;
    in += inside[m];
  }
  int total;
  int at = warp_scan(tm, in, total);
  __syncwarp();   // every lane is done reading the pack before it is rewritten
  const int spare = kPack * tm.T + tm.t;   // a lane's own word for its other keys
#pragma unroll
  for (int m = 0; m < N; ++m) {
    pack[inside[m] ? at : spare] = k[m];
    at += inside[m];
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int idx = tm.t + tm.T * m;
    out[m] = idx < total ? pack[idx] : kIntMax;
  }
}

// Bisection steps i.. over keys k (those below them counted in base), each
// choosing one bit of the k-th smallest; stops after the step that leaves
// at most `cap` keys in the interval [lo, lo + bit). Returns false when
// every bit is chosen.
template <int N>
__device__ __forceinline__ bool bisect(const int (&k)[N], int want, Team<true>& tm, int base,
                                       int cap,
                                       int& i, int& lo, int& f_lo, int& f_hi) {
  for (; i < 31; ++i) {
    const int cand = lo | (1 << (30 - i));
    const int cnt = base + count_below(k, cand, tm);
    if (cnt < want) {
      lo = cand;
      f_lo = cnt;
    } else {
      f_hi = cnt;
    }
    if (f_hi - f_lo <= cap && i < 30) return true;
  }
  return false;
}

// Exact k-th smallest (1-indexed) of the row's int32 keys (padding holds
// INT_MAX, never below a candidate bound), by a 31-step bisection over the
// bit pattern: one warp sum a step. The counts at the interval's two ends
// give the keys inside it; once they fit kPack a lane, those keys move
// through `pack` ((kPack + 1) x 32 words of shared memory) into kPack
// registers a lane, and once they fit one a lane, into one: the later steps
// count those alone (the keys below the interval are counted once, at the
// move), one key a lane with a ballot.
template <int NCH>
__device__ int kth_smallest(const int (&key)[NCH][4], int want, Team<true>& tm, int* pack) {
  int flat[4 * NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) flat[4 * j + e] = key[j][e];
  int c[4 * NCH];
#pragma unroll
  for (int m = 0; m < 4 * NCH; ++m) c[m] = flat[m] < 0;
  int f_lo = team_sum(tm, tree(c, AddI()));   // keys below the interval
  int f_hi = 4 * NCH * tm.T;                   // keys below its end
  int lo = 0, i = 0;
  if (!bisect(flat, want, tm, 0, kPack * tm.T, i, lo, f_lo, f_hi)) return lo;
  stamp(9);
  int k8[kPack];
  pack_keys(flat, lo, 1 << (30 - i), tm, pack, k8);
  stamp(10);
  int base = f_lo;
  ++i;
  if (!bisect(k8, want, tm, base, tm.T, i, lo, f_lo, f_hi)) return lo;
  stamp(11);
  int k1[1];
  pack_keys(k8, lo, 1 << (30 - i), tm, pack, k1);
  stamp(12);
  base = f_lo;
  ++i;
  bisect(k1, want, tm, base, -1, i, lo, f_lo, f_hi);
  return lo;
}

// Index of the first occurrence of the minimum of the row's values (padding
// holds +inf and comes after every slot of its lane); a NaN minimum matches
// nothing and gives S.
template <int NCH, class TM>
__device__ int first_min_idx(const float (&val)[NCH][4], TM& tm, int S) {
  float v[4 * NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[4 * j + e] = val[j][e];
  const float m = team_min_f(tm, tree(v, MinF()));
  int at[4 * NCH];    // the lane's slots, ascending: its first match is their minimum
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) at[4 * j + e] = val[j][e] == m ? slot_of(tm, j, e) : kIntMax;
  const int idx = team_min(tm, tree(at, MinI()));
  return idx < S ? idx : S;
}

// Eviction victim of one row (index < S), or S when no slot is a candidate;
// x.n already bumped.
template <int NCH>
__device__ int select_victim(const Share<NCH>& x, Team<true>& tm, int S, int policy, int npos,
                             int plen, int rrank, int recent_window, int feasible_k,
                             int protect, int* pack) {
  float val[NCH][4];
  if (policy == kRandom || policy == kRoco) {
    int key[NCH][4];
    if (policy == kRoco) {
      // a std only where it decides the key: a candidate not forced (the
      // others' keys are constants); branches skip the slots no lane needs
#pragma unroll
      for (int j = 0; j < NCH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = x.p[j][e];
          int kk = __float_as_int(kExclude);
          if (in_base(p, plen, protect)) {
            if (p >= npos - kStdGuard)
              kk = __float_as_int(kForce + (float)p * 1024.0f);
            else
              kk = roco_key(p, x.c[j][e], x.q[j][e], x.n[j][e], npos, plen, protect);
          }
          key[j][e] = kk;
        }
    }
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (slot_of(tm, j, e) >= S) key[j][e] = kIntMax;
        else if (policy == kRandom) key[j][e] = random_key(x.p[j][e], plen, protect);
    stamp(4);
    const int kth = kth_smallest(key, policy == kRandom ? rrank + 1 : feasible_k, tm, pack);
    stamp(5);
    if (policy == kRandom) {   // S: no slot holds the key, no eviction
      int at[4 * NCH];
#pragma unroll
      for (int j = 0; j < NCH; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) at[4 * j + e] = key[j][e] == kth ? slot_of(tm, j, e) : kIntMax;
      const int idx = team_min(tm, tree(at, MinI()));
      return idx < S ? idx : S;
    }
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        val[j][e] = INFINITY;   // the mean only of the slots within the k lowest stds
        if (slot_of(tm, j, e) < S && key[j][e] <= kth) val[j][e] = x.c[j][e] / x.n[j][e];
      }
  } else {
    stamp(4);
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        val[j][e] = slot_of(tm, j, e) < S
                        ? min_value(policy, x.p[j][e], x.c[j][e], npos, plen, recent_window,
                                    protect)
                        : INFINITY;
  }
  return first_min_idx(val, tm, S);
}

// compact: every slot s >= from takes slot s + 1's pos, score, score_sq and
// counter (slot S-1 slot 0's, the roll by -1 of the TPU kernel), then
// pos[S-1] = -1. A chunk's last slot takes the next lane's first by a
// shuffle (lane 31 lane 0's next chunk).
template <int NCH>
__device__ void shift_down(Share<NCH>& x, const Team<true>& tm, int S, int from) {
  int np[NCH];
  float nc[NCH], nq[NCH], nn[NCH];
  const int src = (tm.lane + 1) & 31;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    np[j] = __shfl_sync(kAll, x.p[j][0], src);
    nc[j] = __shfl_sync(kAll, x.c[j][0], src);
    nq[j] = __shfl_sync(kAll, x.q[j][0], src);
    nn[j] = __shfl_sync(kAll, x.n[j][0], src);
  }
  // slot 0: lane 0's chunk 0, as lane 31 received it
  const int p0 = __shfl_sync(kAll, np[0], 31);
  const float c0 = __shfl_sync(kAll, nc[0], 31), q0 = __shfl_sync(kAll, nq[0], 31),
              n0 = __shfl_sync(kAll, nn[0], 31);
  if (tm.lane == 31) {   // lane 0's chunk j + 1 (ascending j: not yet moved)
#pragma unroll
    for (int j = 0; j + 1 < NCH; ++j) {
      np[j] = np[j + 1]; nc[j] = nc[j + 1]; nq[j] = nq[j + 1]; nn[j] = nn[j + 1];
    }
  }
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // ascending e: slot e + 1 is still unshifted
      const int s = slot_of(tm, j, e);
      if (s >= from && s < S) {
        if (s == S - 1) {
          x.p[j][e] = p0; x.c[j][e] = c0; x.q[j][e] = q0; x.n[j][e] = n0;
        } else if (e < 3) {
          x.p[j][e] = x.p[j][e + 1]; x.c[j][e] = x.c[j][e + 1];
          x.q[j][e] = x.q[j][e + 1]; x.n[j][e] = x.n[j][e + 1];
        } else {
          x.p[j][e] = np[j]; x.c[j][e] = nc[j]; x.q[j][e] = nq[j]; x.n[j][e] = nn[j];
        }
      }
      if (s == S - 1) x.p[j][e] = -1;
    }
}

// the thread's (chunk, element) of `slot`, when it holds it
template <class TM>
__device__ __forceinline__ bool holds(const TM& tm, int slot, int& jj, int& ee) {
  const int ci = slot >> 2;
  jj = ci / tm.T;
  ee = slot & 3;
  return ci - jj * tm.T == tm.t;
}

struct K2Args {
  int* pos;
  float *score, *ssq, *counter;
  const float *probs, *p_new;
  const int* q_pos;
  const uint8_t *token_valid, *update_gate;
  const float* counter_init;
  const uint8_t* evict_gate;
  const int *next_pos, *prompt_len, *rand_rank;
  const float *k_sc_new, *v_sc_new;
  float *k_scale, *v_scale;
  int *slot_out, *vslot_out;
  uint4 *k, *v;               // step 5: the cache's K and V, (L, B, H, S, row_words)
  const uint4 *kn, *vn;       // and the step's rows, (L, B, H, 1, row_words)
  int nrows, B, H, S, policy, evict, compact, recent_window, feasible_k, protect_prompt;
  int row_words;              // 16-byte words of a row; 0: no rows
  int warps, vec;
};

struct K4Args {
  int* pos;
  const float *score, *ssq;
  float* counter;
  const uint8_t* evict_gate;
  const int *next_pos, *prompt_len, *rand_rank;
  int nrows, B, H, S, policy, recent_window, feasible_k, protect_prompt;
  int warps, vec;
};

// Step 5: the row's K and V (2 n 16-byte words, K's first), word i = lane +
// 32 m of one warp; the first kRowWords a lane are loaded ahead and stored
// once the write slot is known, any further words copied then.
constexpr int kRowWords = 2;

__device__ __forceinline__ const uint4* row_src(const K2Args& a, int row, int i) {
  const int n = a.row_words;
  return i < n ? a.kn + (size_t)row * n + i : a.vn + (size_t)row * n + (i - n);
}

__device__ __forceinline__ uint4* row_dst(const K2Args& a, int row, int slot, int i) {
  const int n = a.row_words;
  const size_t at = ((size_t)row * a.S + slot) * n;
  return i < n ? a.k + at + i : a.v + at + (i - n);
}

__device__ __forceinline__ void rows_load(const K2Args& a, int row, int lane,
                                          uint4 (&w)[kRowWords]) {
#pragma unroll
  for (int m = 0; m < kRowWords; ++m) {
    const int i = lane + 32 * m;
    if (i < 2 * a.row_words) w[m] = *row_src(a, row, i);
  }
}

__device__ __forceinline__ void rows_store(const K2Args& a, int row, int slot, int lane,
                                           const uint4 (&w)[kRowWords]) {
#pragma unroll
  for (int m = 0; m < kRowWords; ++m) {
    const int i = lane + 32 * m;
    if (i < 2 * a.row_words) *row_dst(a, row, slot, i) = w[m];
  }
  for (int i = lane + 32 * kRowWords; i < 2 * a.row_words; i += 32)
    *row_dst(a, row, slot, i) = *row_src(a, row, i);
}

// the row's score, score_sq, counter and (with_pos) pos back to device memory
template <int NCH>
__device__ __forceinline__ void store_row(const K2Args& a, const Share<NCH>& x,
                                          const Team<true>& tm, size_t off, int S, bool vec,
                                          bool with_pos) {
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int s0 = slot_of(tm, j, 0);
    if (with_pos) store4(a.pos + off, x.p[j], s0, S, vec);
    store4(a.score + off, x.c[j], s0, S, vec);
    store4(a.ssq + off, x.q[j], s0, S, vec);
    store4(a.counter + off, x.n[j], s0, S, vec);
  }
}

template <int NCH>
__global__ void __launch_bounds__(kBlock) write_update_rows(const K2Args a) {
  __shared__ int red[2 * kTeamWarps];
  __shared__ int pack[(kPack + 1) * kBlock];
  Team<true> tm;
  int row, wib;
  if (!make_team(tm, a.warps, a.nrows, red, row, wib)) return;
  const int S = a.S, policy = a.policy;
  const int b = (row / a.H) % a.B;
  const size_t off = (size_t)row * S;
  const bool vec = a.vec != 0;

  const int qp = a.q_pos[b];
  const bool live = a.token_valid[b] != 0;
  const bool g_upd = a.update_gate[b] != 0;
  const float gf = g_upd ? 1.0f : 0.0f;
  const float cinit = a.counter_init[b];
  const float pn = a.p_new[row];
  // the row's other arguments, loaded with it (not after its stores)
  const bool scales = a.k_scale != nullptr;
  const float ksn = scales ? a.k_sc_new[row] : 0.f, vsn = scales ? a.v_sc_new[row] : 0.f;
#ifdef K2_NO_SELECT
  const bool fire = false;
#else
  const bool fire = a.evict && a.evict_gate[b] != 0;
#endif
  const int npos = fire ? a.next_pos[b] : 0, plen = fire ? a.prompt_len[b] : 0,
            rrank = fire ? a.rand_rank[b] : 0;
  uint4 rw[kRowWords] = {};
  rows_load(a, row, tm.t, rw);
  stamp(0);

  // 1-3: load (every chunk in flight before the first use), update, free slot
  Share<NCH> x;
  float pr[NCH][4];
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int s0 = slot_of(tm, j, 0);
    load4(x.p[j], a.pos + off, s0, S, vec);
    load4(x.c[j], a.score + off, s0, S, vec);
    load4(x.q[j], a.ssq + off, s0, S, vec);
    load4(x.n[j], a.counter + off, s0, S, vec);
    load4(pr[j], a.probs + off, s0, S, vec);
  }
  int free_at[4 * NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      update_slot(policy, pr[j][e], gf, g_upd, x.c[j][e], x.q[j][e]);
      const int s = slot_of(tm, j, e);
      free_at[4 * j + e] = s < S && x.p[j][e] < 0 ? s : kIntMax;
    }
  stamp(1);
  const int first_free = team_min(tm, tree(free_at, MinI()));
  const int slot = first_free < S ? first_free : 0;
  if (tm.t == 0) {
    a.slot_out[row] = slot;
    if (scales && live) {
      a.k_scale[off + slot] = ksn;
      a.v_scale[off + slot] = vsn;
    }
  }
  if (live) rows_store(a, row, slot, tm.t, rw);   // 5
  int jj, ee;
  const bool mine = live && holds(tm, slot, jj, ee);   // this lane writes the new token
  if (mine) {
    float s_new = 0.f, sq_new = 0.f;
    if (policy == kH2O || policy == kRoco || policy == kTova) s_new = pn * gf;
    if (policy == kRoco) sq_new = pn * pn * gf;
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j == jj && e == ee) {
          x.p[j][e] = qp;
          x.n[j][e] = cinit;
          x.c[j][e] = s_new;
          x.q[j][e] = sq_new;
        }
  }
  stamp(2);

  // 4: the gated eviction event on the freshly written row; with compact,
  // the slots at and above the victim shift down by one instead of the
  // victim's pos going to -1, and slot S-1 (now one past the end) gets -1.
  // Without compact the row is final but for pos[victim]: it is stored
  // before the selection, so that the stores drain while the row selects,
  // pos only at the write slot (the rest of it is unchanged), and the
  // victim's lane then stores its -1 (after the write slot's, should the
  // new token be the victim).
  if (fire) {
#pragma unroll
    for (int j = 0; j < NCH; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x.n[j][e] = x.n[j][e] + 1.0f;
  }
  stamp(3);
  if (!a.compact) {
    store_row(a, x, tm, off, S, vec, false);
    if (mine) a.pos[off + slot] = qp;
  }
  if (!fire) {
    if (a.compact) store_row(a, x, tm, off, S, vec, true);
    if (a.compact && tm.t == 0) a.vslot_out[row] = S;
    stamp(8);
    return;
  }
  const int victim = select_victim(x, tm, S, policy, npos, plen, rrank, a.recent_window,
                                   a.feasible_k, a.protect_prompt, pack + wib * 32 * (kPack + 1));
  stamp(6);
  if (a.compact) {
    shift_down(x, tm, S, victim);
    stamp(7);
    if (tm.t == 0) a.vslot_out[row] = victim;
    store_row(a, x, tm, off, S, vec, true);
  } else if (victim < S && holds(tm, victim, jj, ee)) {
    a.pos[off + victim] = -1;
  }
  stamp(8);
}

template <int NCH>
__global__ void __launch_bounds__(kBlock) evict_rows(const K4Args a) {
  __shared__ int red[2 * kTeamWarps];
  __shared__ int pack[(kPack + 1) * kBlock];
  Team<true> tm;
  int row, wib;
  if (!make_team(tm, a.warps, a.nrows, red, row, wib)) return;
  const int S = a.S;
  const int b = (row / a.H) % a.B;
  const size_t off = (size_t)row * S;
  const bool vec = a.vec != 0;
  const float g = a.evict_gate[b] != 0 ? 1.0f : 0.0f;
#ifdef K2_NO_SELECT
  const bool gated = false;
#else
  const bool gated = a.evict_gate[b] != 0;
#endif
  const int npos = a.next_pos[b], plen = a.prompt_len[b], rrank = a.rand_rank[b];
  stamp(0);
  Share<NCH> x;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int s0 = slot_of(tm, j, 0);
    load4(x.n[j], a.counter + off, s0, S, vec);
    if (gated) {
      load4(x.p[j], a.pos + off, s0, S, vec);
      load4(x.c[j], a.score + off, s0, S, vec);
      load4(x.q[j], a.ssq + off, s0, S, vec);
    }
  }
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x.n[j][e] = x.n[j][e] + 1.0f * g;
    store4(a.counter + off, x.n[j], slot_of(tm, j, 0), S, vec);
  }
  stamp(1);
  if (!gated) {          // the gate is per row: the whole warp leaves here
    stamp(8);
    return;
  }
  const int victim = select_victim(x, tm, S, a.policy, npos, plen, rrank, a.recent_window,
                                   a.feasible_k, a.protect_prompt, pack + wib * 32 * (kPack + 1));
  stamp(6);
  if (tm.t == 0 && victim < S) a.pos[off + victim] = -1;
  stamp(8);
}

// ---------------------------------------------------------------------------
// the wide path (S > 768): a block of 8 warps a row, the row in shared
// memory, each thread's slots strided by the block
// ---------------------------------------------------------------------------

__device__ int first_min_idx_wide(const float* val, int S, Team<false>& tm) {
  float m = INFINITY;
  for (int s = tm.t; s < S; s += tm.T) m = nan_min(m, val[s]);
  m = team_min_f(tm, m);
  int idx = S;
  for (int s = tm.t; s < S; s += tm.T)
    if (val[s] == m) { idx = s; break; }
  return team_min(tm, idx);
}

__device__ int kth_smallest_wide(const int* keys, int S, int k, Team<false>& tm) {
  int prefix = 0;
  for (int i = 0; i < 31; ++i) {
    const int cand = prefix | (1 << (30 - i));
    int cnt = 0;
    for (int s = tm.t; s < S; s += tm.T) cnt += keys[s] < cand;
    if (team_sum(tm, cnt) < k) prefix = cand;
  }
  return prefix;
}

// select_victim over the row in shared memory; val (and its int alias key):
// S floats of scratch. Each thread reads back only the slots it wrote.
__device__ int select_victim_wide(const int* pos, const float* sc, const float* sq,
                                  const float* cnt, float* val, int S, int policy, int npos,
                                  int plen, int rrank, int recent_window, int feasible_k,
                                  int protect, Team<false>& tm) {
  int* key = (int*)val;
  if (policy == kRandom) {
    for (int s = tm.t; s < S; s += tm.T) key[s] = random_key(pos[s], plen, protect);
    stamp(4);
    const int target = kth_smallest_wide(key, S, rrank + 1, tm);
    stamp(5);
    int idx = S;
    for (int s = tm.t; s < S; s += tm.T)
      if (key[s] == target) { idx = s; break; }
    return team_min(tm, idx);   // S: no slot holds the key, no eviction
  }
  if (policy == kRoco) {
    for (int s = tm.t; s < S; s += tm.T)
      key[s] = roco_key(pos[s], sc[s], sq[s], cnt[s], npos, plen, protect);
    stamp(4);
    const int kth = kth_smallest_wide(key, S, feasible_k, tm);
    stamp(5);
    for (int s = tm.t; s < S; s += tm.T)
      val[s] = key[s] <= kth ? sc[s] / cnt[s] : INFINITY;
  } else {
    stamp(4);
    for (int s = tm.t; s < S; s += tm.T)
      val[s] = min_value(policy, pos[s], sc[s], npos, plen, recent_window, protect);
  }
  return first_min_idx_wide(val, S, tm);
}

// arr[s] <- arr[(s + 1) % S] for every s >= from, through the scratch row tmp
template <typename T>
__device__ void shift_down_wide(T* arr, T* tmp, int S, int from, const Team<false>& tm) {
  for (int s = tm.t; s < S; s += tm.T) tmp[s] = s >= from ? arr[s + 1 < S ? s + 1 : 0] : arr[s];
  __syncthreads();
  for (int s = tm.t; s < S; s += tm.T) arr[s] = tmp[s];
  __syncthreads();
}

__global__ void __launch_bounds__(kBlock) write_update_wide(const K2Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int red[2 * kTeamWarps];
  const int S = a.S, policy = a.policy;
  int* pos = (int*)smem_raw;        // S
  float* sc = (float*)(pos + S);    // S
  float* sq = sc + S;               // S
  float* cnt = sq + S;              // S
  float* val = cnt + S;             // S: selection values / keys / shift scratch
  Team<false> tm;
  int row, wib;
  make_team(tm, kTeamWarps, a.nrows, red, row, wib);
  const int b = (row / a.H) % a.B;
  const size_t off = (size_t)row * S;
  const int qp = a.q_pos[b];
  const bool live = a.token_valid[b] != 0;
  const bool g_upd = a.update_gate[b] != 0;
  const float gf = g_upd ? 1.0f : 0.0f;
  const float pn = a.p_new[row];
  uint4 rw[kRowWords] = {};
  if (tm.t < 32) rows_load(a, row, tm.t, rw);
  stamp(0);

  int first_free = S;
  for (int s = tm.t; s < S; s += tm.T) {
    const int p = a.pos[off + s];
    float c = a.score[off + s], q = a.ssq[off + s];
    update_slot(policy, a.probs[off + s], gf, g_upd, c, q);
    if (p < 0 && first_free == S) first_free = s;
    pos[s] = p;
    sc[s] = c;
    sq[s] = q;
    cnt[s] = a.counter[off + s];
  }
  stamp(1);
  first_free = team_min(tm, first_free);
  const int slot = first_free < S ? first_free : 0;
  if (tm.t == 0) {
    a.slot_out[row] = slot;
    if (a.k_scale != nullptr && live) {
      a.k_scale[off + slot] = a.k_sc_new[row];
      a.v_scale[off + slot] = a.v_sc_new[row];
    }
    if (live) {
      float s_new = 0.f, sq_new = 0.f;
      if (policy == kH2O || policy == kRoco || policy == kTova) s_new = pn * gf;
      if (policy == kRoco) sq_new = pn * pn * gf;
      pos[slot] = qp;
      cnt[slot] = a.counter_init[b];
      sc[slot] = s_new;
      sq[slot] = sq_new;
    }
  }
  if (tm.t < 32 && live) rows_store(a, row, slot, tm.t, rw);   // 5
  __syncthreads();
  stamp(2);

  int victim = S;
#ifdef K2_NO_SELECT
  const bool fire = false;
#else
  const bool fire = a.evict && a.evict_gate[b] != 0;
#endif
  if (fire) {
    for (int s = tm.t; s < S; s += tm.T) cnt[s] = cnt[s] + 1.0f;
    stamp(3);
    victim = select_victim_wide(pos, sc, sq, cnt, val, S, policy, a.next_pos[b],
                                a.prompt_len[b], a.rand_rank[b], a.recent_window, a.feasible_k,
                                a.protect_prompt, tm);
    stamp(6);
    if (a.compact) {
      __syncthreads();   // every thread is done with val before the shift reuses it
      shift_down_wide(pos, (int*)val, S, victim, tm);
      shift_down_wide(sc, val, S, victim, tm);
      shift_down_wide(sq, val, S, victim, tm);
      shift_down_wide(cnt, val, S, victim, tm);
      if (tm.t == 0) pos[S - 1] = -1;
    } else if (tm.t == 0 && victim < S) {
      pos[victim] = -1;
    }
    __syncthreads();
    stamp(7);
  }
  if (a.compact && tm.t == 0) a.vslot_out[row] = victim;

  // without compact pos changed at the write slot and the victim alone
  for (int s = tm.t; s < S; s += tm.T) {
    if (a.compact) a.pos[off + s] = pos[s];
    a.score[off + s] = sc[s];
    a.ssq[off + s] = sq[s];
    a.counter[off + s] = cnt[s];
  }
  if (!a.compact && tm.t == 0) {   // the victim's -1 last: it may be the write slot
    if (live) a.pos[off + slot] = qp;
    if (victim < S) a.pos[off + victim] = -1;
  }
  stamp(8);
}

__global__ void __launch_bounds__(kBlock) evict_wide(const K4Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ int red[2 * kTeamWarps];
  const int S = a.S;
  int* pos = (int*)smem_raw;
  float* sc = (float*)(pos + S);
  float* sq = sc + S;
  float* cnt = sq + S;
  float* val = cnt + S;
  Team<false> tm;
  int row, wib;
  make_team(tm, kTeamWarps, a.nrows, red, row, wib);
  const int b = (row / a.H) % a.B;
  const size_t off = (size_t)row * S;
  const float g = a.evict_gate[b] != 0 ? 1.0f : 0.0f;
#ifdef K2_NO_SELECT
  const bool gated = false;
#else
  const bool gated = a.evict_gate[b] != 0;
#endif
  stamp(0);
  for (int s = tm.t; s < S; s += tm.T) {
    const float c = a.counter[off + s] + 1.0f * g;
    a.counter[off + s] = c;
    cnt[s] = c;
    if (gated) {
      pos[s] = a.pos[off + s];
      sc[s] = a.score[off + s];
      sq[s] = a.ssq[off + s];
    }
  }
  stamp(1);
  if (!gated) {           // the gate is per block: the whole block leaves here
    stamp(8);
    return;
  }
  const int victim = select_victim_wide(pos, sc, sq, cnt, val, S, a.policy, a.next_pos[b],
                                        a.prompt_len[b], a.rand_rank[b], a.recent_window,
                                        a.feasible_k, a.protect_prompt, tm);
  stamp(6);
  if (tm.t == 0 && victim < S) a.pos[off + victim] = -1;
  stamp(8);
}

// sidecar_update.row_plan's plan, as this file takes it: chunks 0 is the
// wide path (8 warps, one row a block), else 2, 4 or 6 chunks a lane of
// the one warp that owns a row, `rows` rows a block, covering S
bool plan_ok(int S, int warps, int chunks, int rows) {
  if (S < 1) return false;
  if (chunks == 0) return warps == kTeamWarps && rows == 1;
  if (chunks != 2 && chunks != 4 && chunks != 6) return false;
  if (warps != 1 || rows < 1 || rows > kTeamWarps) return false;
  return 128L * chunks >= S;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

cudaError_t wide_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// Dynamic shared memory a block of the plan takes: the wide path keeps the
// row's pos, score, score_sq, counter and a scratch row there; the register
// path none (its static arrays, the bisection's pack among them, take 9 KB
// a block).
size_t sidecar_smem(int S, int chunks) { return chunks == 0 ? (size_t)5 * 4 * S : 0; }

// policy: 0 none (full), 1 h2o_head, 2 roco, 3 tova, 4 recency, 5 random.
// evict = 0 skips step 4 (evict_gate .. rand_rank may then be null).
// compact = 1 (needs evict = 1): step 4 shifts the row down at the victim
// and writes each row's victim slot (S: none) to vslot_out (L, B, H).
// k_sc_new, v_sc_new (L, B, H, 1) and k_scale, v_scale (L, B, H, S): the
// int8 cache's scale rows, or all null for a float cache.
// k, v (L, B, H, S, row_bytes) and kn, vn (L, B, H, 1, row_bytes): the
// cache's K / V and the step's rows, written at the write slot (step 5),
// every pointer 16-byte aligned and row_bytes a multiple of 16; or all null
// (row_bytes ignored).
// (warps, chunks, rows): sidecar_update.row_plan(S).
// Updates pos / score / score_sq / counter (the scale rows, the K / V rows)
// in place. Returns cudaGetLastError().
int write_update(int* pos, float* score, float* score_sq, float* counter, const float* probs,
                 const float* p_new, const int* q_pos, const uint8_t* token_valid,
                 const uint8_t* update_gate, const float* counter_init,
                 const uint8_t* evict_gate, const int* next_pos, const int* prompt_len,
                 const int* rand_rank, const float* k_sc_new, const float* v_sc_new,
                 float* k_scale, float* v_scale, int* slot_out, int* vslot_out, void* k,
                 void* v, const void* kn, const void* vn, int L, int B, int H, int S,
                 int policy, int evict, int compact, int recent_window, int feasible_k,
                 int protect_prompt, int row_bytes, int warps, int chunks, int rows,
                 void* stream) {
  if (compact && (!evict || vslot_out == nullptr)) return (int)cudaErrorInvalidValue;
  if (!plan_ok(S, warps, chunks, rows)) return (int)cudaErrorInvalidValue;
  const bool with_rows = k != nullptr;
  if (with_rows && (v == nullptr || kn == nullptr || vn == nullptr || row_bytes < 16 ||
                    row_bytes % 16 != 0 || !aligned16(k) || !aligned16(v) ||
                    !aligned16(kn) || !aligned16(vn)))
    return (int)cudaErrorInvalidValue;
  const int nrows = L * B * H;
  const int vec = S % 4 == 0 && aligned16(pos) && aligned16(score) && aligned16(score_sq) &&
                  aligned16(counter) && aligned16(probs);
  const K2Args a{pos, score, score_sq, counter, probs, p_new, q_pos, token_valid, update_gate,
                 counter_init, evict_gate, next_pos, prompt_len, rand_rank, k_sc_new, v_sc_new,
                 k_scale, v_scale, slot_out, vslot_out, (uint4*)k, (uint4*)v,
                 (const uint4*)kn, (const uint4*)vn, nrows, B, H, S, policy, evict,
                 compact, recent_window, feasible_k, protect_prompt,
                 with_rows ? row_bytes / 16 : 0, warps, vec};
  cudaStream_t st = (cudaStream_t)stream;
  if (chunks == 0) {
    const size_t smem = sidecar_smem(S, chunks);
    cudaError_t err = wide_smem((const void*)write_update_wide, smem);
    if (err != cudaSuccess) return (int)err;
    write_update_wide<<<nrows, kBlock, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  const dim3 grid((nrows + rows - 1) / rows), block(32 * rows);
  if (chunks == 2) write_update_rows<2><<<grid, block, 0, st>>>(a);
  else if (chunks == 4) write_update_rows<4><<<grid, block, 0, st>>>(a);
  else write_update_rows<6><<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// K4: one gated eviction event over (L, B, H, S) sidecars, decode phase,
// k = 1; policy as above (not 0); (warps, chunks, rows) as above. Updates
// pos and counter in place. Returns cudaGetLastError().
int evict(int* pos, const float* score, const float* score_sq, float* counter,
          const uint8_t* evict_gate, const int* next_pos, const int* prompt_len,
          const int* rand_rank, int L, int B, int H, int S, int policy, int recent_window,
          int feasible_k, int protect_prompt, int warps, int chunks, int rows, void* stream) {
  if (policy == kNone) return (int)cudaErrorInvalidValue;
  if (!plan_ok(S, warps, chunks, rows)) return (int)cudaErrorInvalidValue;
  const int nrows = L * B * H;
  const int vec = S % 4 == 0 && aligned16(pos) && aligned16(score) && aligned16(score_sq) &&
                  aligned16(counter);
  const K4Args a{pos, score, score_sq, counter, evict_gate, next_pos, prompt_len, rand_rank,
                 nrows, B, H, S, policy, recent_window, feasible_k, protect_prompt, warps, vec};
  cudaStream_t st = (cudaStream_t)stream;
  if (chunks == 0) {
    const size_t smem = sidecar_smem(S, chunks);
    cudaError_t err = wide_smem((const void*)evict_wide, smem);
    if (err != cudaSuccess) return (int)err;
    evict_wide<<<nrows, kBlock, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  const dim3 grid((nrows + rows - 1) / rows), block(32 * rows);
  if (chunks == 2) evict_rows<2><<<grid, block, 0, st>>>(a);
  else if (chunks == 4) evict_rows<4><<<grid, block, 0, st>>>(a);
  else evict_rows<6><<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}

#ifdef K2_STAMPS
// The diagnostic build's clock readings: 4 x kStampSlots u64 to `out`,
// then cleared.
int sidecar_stamps(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k2_stamps, sizeof(k2_stamps));
  void* addr = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&addr, k2_stamps);
  if (e == cudaSuccess) e = cudaMemset(addr, 0, sizeof(k2_stamps));
  return (int)e;
}
#endif

}  // extern "C"
