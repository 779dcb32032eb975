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
//   3. when the row is live: the new token's sidecars at the write slot;
//      with an int8 cache, whether live or not (as the TPU kernel does: a
//      dead row's slot keeps pos < 0, so its bytes are inert): the new
//      token's K and V dequant scales at the write slot, in place;
//   4. when evict_gate fires: counter += 1 on every slot, victim selection
//      (h2o_head / tova: first minimum score; recency: oldest position;
//      random: the slot at age rank rand_rank; roco: the lowest mean score
//      among the feasible_k lowest stds, the k-th smallest std found
//      exactly by a 31-step bisection over its bit pattern), pos[victim]=-1;
//      with `compact` (ordered StreamingLLM decoding, pre-rotated cache)
//      the row's pos, score, score_sq and bumped counter shift down by one
//      at and above the victim instead (slot S-1 takes slot 0's values,
//      as jnp.roll does, and pos -1), and the victim slot (S when the gate
//      is off or no slot is a candidate) goes out for the K/V shift (K9).
//
// K4 replaces `fused_evict` (body `_evict_kernel`), decode phase, k = 1:
// per row, counter += 1 under the gate, the same victim selection, and
// pos[victim] = -1. It runs after K2 when the eviction is not folded
// (ordered StreamingLLM decoding with the rotate-at-read cache).
//
// What bounds them on an H100: bytes. K2 reads pos, score, score_sq,
// counter and probs and writes the first four back: 36 bytes a slot, 28 MB
// per step at LLaMa-2-7B width and S=768 (compact moves nothing more: the
// shift happens in shared memory). The scale rows cost 16 bytes a
// row, not a slot: the TPU kernel rewrites both (S,) rows in VMEM, here the
// two new scales are stored at the slot and the rest of each row is never
// touched (the same result, since the update is in place). K4 reads the
// four sidecars and writes pos and counter back: 24 bytes a slot (a row
// whose gate is off reads and writes only its counters). One block per row keeps the
// row's arrays in shared memory, so the 31 bisection rounds, the minimum
// searches and the shift re-read nothing from device memory; every
// reduction is a block reduction. The arithmetic is the plain version's,
// op by op, and this file is built with --fmad=false so that no
// multiply-add is contracted: victims, slots and sidecars are bit-exact
// with it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIntMax = 0x7fffffff;
constexpr float kForce = 1e9f;      // policies.STD_FORCE
constexpr float kExclude = 1e30f;   // policies.STD_EXCLUDE
constexpr int kStdGuard = 10;       // policies.ROCO_STD_GUARD

enum Policy { kNone = 0, kH2O = 1, kRoco = 2, kTova = 3, kRecency = 4, kRandom = 5 };

// min that propagates NaN, as jnp.min / torch.amin do
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ int warp_min_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_sum_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_min_f(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = nan_min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ int block_min_i(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_min_i(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  int y = lane < kWarps ? red[lane] : kIntMax;
  y = warp_min_i(y);
  __syncthreads();
  return y;
}
__device__ int block_sum_i(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum_i(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  int y = lane < kWarps ? red[lane] : 0;
  y = warp_sum_i(y);
  __syncthreads();
  return y;
}
__device__ float block_min_f(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_min_f(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float y = lane < kWarps ? red[lane] : INFINITY;
  y = warp_min_f(y);
  __syncthreads();
  return y;
}

// Index of the first occurrence of the minimum of val[0..S) (NaN-propagating:
// a NaN minimum matches nothing and gives S).
__device__ int first_min_idx(const float* val, int S, float* redf, int* redi) {
  float m = INFINITY;
  for (int s = threadIdx.x; s < S; s += kThreads) m = nan_min(m, val[s]);
  m = block_min_f(m, redf);
  int idx = S;
  for (int s = threadIdx.x; s < S; s += kThreads)
    if (val[s] == m) { idx = s; break; }
  return block_min_i(idx, redi);
}

// Exact k-th smallest (1-indexed) of non-negative int32 keys, by a 31-step
// bisection over the bit pattern.
__device__ int kth_smallest_bits(const int* keys, int S, int k, int* redi) {
  int prefix = 0;
  for (int i = 0; i < 31; ++i) {
    const int cand = prefix | (1 << (30 - i));
    int cnt = 0;
    for (int s = threadIdx.x; s < S; s += kThreads) cnt += keys[s] < cand;
    cnt = block_sum_i(cnt, redi);
    if (cnt < k) prefix = cand;
  }
  return prefix;
}

// Eviction victim of one row (index < S), or S when no slot is a candidate;
// `cnt` already bumped. pos/sc/sq/cnt: the row in shared memory; val (and
// its int alias key): S floats of scratch.
__device__ int select_victim(const int* pos, const float* sc, const float* sq,
                             const float* cnt, float* val, int S, int policy, int npos,
                             int plen, int rrank, int recent_window, int feasible_k,
                             int protect_prompt, float* redf, int* redi) {
  const int tid = threadIdx.x;
  int* key = (int*)val;
  if (policy == kRandom) {
    for (int s = tid; s < S; s += kThreads) {
      const int p = pos[s];
      const bool base = p >= 0 && (!protect_prompt || p >= plen);
      key[s] = base ? p : kIntMax;
    }
    __syncthreads();
    const int target = kth_smallest_bits(key, S, rrank + 1, redi);
    int idx = S;
    for (int s = tid; s < S; s += kThreads)
      if (key[s] == target) { idx = s; break; }
    return block_min_i(idx, redi);   // S: no slot holds the key, no eviction
  }
  if (policy == kRoco) {
    for (int s = tid; s < S; s += kThreads) {
      const int p = pos[s];
      const bool base = p >= 0 && (!protect_prompt || p >= plen);
      const float mean = sc[s] / cnt[s];
      const float var = sq[s] / cnt[s] - mean * mean;
      float std = sqrtf(var != var ? var : (var > 0.f ? var : 0.f));
      if (p >= npos - kStdGuard) std = kForce + (float)p * 1024.0f;
      if (!base) std = kExclude;
      key[s] = __float_as_int(std);
    }
    __syncthreads();
    const int kth = kth_smallest_bits(key, S, feasible_k, redi);
    for (int s = tid; s < S; s += kThreads)
      val[s] = key[s] <= kth ? sc[s] / cnt[s] : INFINITY;
  } else {
    for (int s = tid; s < S; s += kThreads) {
      const int p = pos[s];
      bool cand = p >= 0 && (!protect_prompt || p >= plen);
      float x;
      if (policy == kRecency) {
        x = (float)p;
      } else {
        if (policy == kH2O) cand = cand && p < npos - recent_window;
        x = sc[s];
      }
      val[s] = cand ? x : INFINITY;
    }
  }
  __syncthreads();
  return first_min_idx(val, S, redf, redi);
}

// arr[s] <- arr[(s + 1) % S] for every s >= from, in shared memory, through
// the scratch row tmp (the roll by -1 of the TPU kernel, wraparound included).
template <typename T>
__device__ void shift_down(T* arr, T* tmp, int S, int from) {
  for (int s = threadIdx.x; s < S; s += kThreads)
    tmp[s] = s >= from ? arr[s + 1 < S ? s + 1 : 0] : arr[s];
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += kThreads) arr[s] = tmp[s];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
write_update_kernel(int* __restrict__ pos_g, float* __restrict__ score_g,
                    float* __restrict__ ssq_g, float* __restrict__ counter_g,
                    const float* __restrict__ probs_g, const float* __restrict__ p_new_g,
                    const int* __restrict__ q_pos, const uint8_t* __restrict__ token_valid,
                    const uint8_t* __restrict__ update_gate,
                    const float* __restrict__ counter_init,
                    const uint8_t* __restrict__ evict_gate, const int* __restrict__ next_pos,
                    const int* __restrict__ prompt_len, const int* __restrict__ rand_rank,
                    const float* __restrict__ k_sc_new, const float* __restrict__ v_sc_new,
                    float* __restrict__ k_scale, float* __restrict__ v_scale,
                    int* __restrict__ slot_out, int* __restrict__ vslot_out, int B, int H,
                    int S, int policy, int evict, int compact, int recent_window,
                    int feasible_k, int protect_prompt) {
  extern __shared__ unsigned char smem_raw[];
  int* pos = (int*)smem_raw;        // S
  float* sc = (float*)(pos + S);    // S
  float* sq = sc + S;               // S
  float* cnt = sq + S;              // S
  float* val = cnt + S;             // S: selection values / keys / shift scratch
  __shared__ float redf[kWarps];
  __shared__ int redi[kWarps];

  const int row = blockIdx.x;
  const int b = (row / H) % B;
  const int tid = threadIdx.x;
  const size_t off = (size_t)row * S;

  const int qp = q_pos[b];
  const bool live = token_valid[b] != 0;
  const bool g_upd = update_gate[b] != 0;
  const float gf = g_upd ? 1.0f : 0.0f;
  const float cinit = counter_init[b];
  const float pn = p_new_g[row];

  // 1-3: load, free slot, score update
  int first_free = S;
  for (int s = tid; s < S; s += kThreads) {
    const int p = pos_g[off + s];
    float c = score_g[off + s], q2 = ssq_g[off + s];
    const float pr = probs_g[off + s];
    if (p < 0 && first_free == S) first_free = s;
    if (policy == kH2O || policy == kRoco) {
      c = c + pr * gf;
      if (policy == kRoco) q2 = q2 + pr * pr * gf;
    } else if (policy == kTova) {
      c = g_upd ? pr : c;
    }
    pos[s] = p;
    sc[s] = c;
    sq[s] = q2;
    cnt[s] = counter_g[off + s];
  }
  first_free = block_min_i(first_free, redi);
  const int slot = first_free < S ? first_free : 0;
  if (tid == 0) {
    slot_out[row] = slot;
    if (k_scale != nullptr) {
      k_scale[off + slot] = k_sc_new[row];
      v_scale[off + slot] = v_sc_new[row];
    }
    if (live) {
      float s_new = 0.f, sq_new = 0.f;
      if (policy == kH2O || policy == kRoco || policy == kTova) s_new = pn * gf;
      if (policy == kRoco) sq_new = pn * pn * gf;
      pos[slot] = qp;
      cnt[slot] = cinit;
      sc[slot] = s_new;
      sq[slot] = sq_new;
    }
  }
  __syncthreads();

  // 4: the gated eviction event on the freshly written row; with compact,
  // the rows at and above the victim shift down by one instead of the
  // victim's pos going to -1, and slot S-1 (now one past the end) gets -1
  int victim = S;
  if (evict && evict_gate[b] != 0) {
    for (int s = tid; s < S; s += kThreads) cnt[s] = cnt[s] + 1.0f;
    __syncthreads();
    victim = select_victim(pos, sc, sq, cnt, val, S, policy, next_pos[b], prompt_len[b],
                           rand_rank[b], recent_window, feasible_k, protect_prompt, redf,
                           redi);
    if (compact) {
      shift_down(pos, (int*)val, S, victim);
      shift_down(sc, val, S, victim);
      shift_down(sq, val, S, victim);
      shift_down(cnt, val, S, victim);
      if (tid == 0) pos[S - 1] = -1;
    } else if (tid == 0 && victim < S) {
      pos[victim] = -1;
    }
    __syncthreads();
  }
  if (compact && tid == 0) vslot_out[row] = victim;

  for (int s = tid; s < S; s += kThreads) {
    pos_g[off + s] = pos[s];
    score_g[off + s] = sc[s];
    ssq_g[off + s] = sq[s];
    counter_g[off + s] = cnt[s];
  }
}

// One gated eviction event (kernel K4): per row, counter += 1 when the
// row's gate fires, then the victim selection and pos[victim] = -1.
__global__ void __launch_bounds__(kThreads)
evict_kernel(int* __restrict__ pos_g, const float* __restrict__ score_g,
             const float* __restrict__ ssq_g, float* __restrict__ counter_g,
             const uint8_t* __restrict__ evict_gate, const int* __restrict__ next_pos,
             const int* __restrict__ prompt_len, const int* __restrict__ rand_rank, int B,
             int H, int S, int policy, int recent_window, int feasible_k,
             int protect_prompt) {
  extern __shared__ unsigned char smem_raw[];
  int* pos = (int*)smem_raw;
  float* sc = (float*)(pos + S);
  float* sq = sc + S;
  float* cnt = sq + S;
  float* val = cnt + S;
  __shared__ float redf[kWarps];
  __shared__ int redi[kWarps];

  const int row = blockIdx.x;
  const int b = (row / H) % B;
  const int tid = threadIdx.x;
  const size_t off = (size_t)row * S;
  const bool gated = evict_gate[b] != 0;
  const float g = gated ? 1.0f : 0.0f;
  for (int s = tid; s < S; s += kThreads) {
    const float c = counter_g[off + s] + 1.0f * g;
    counter_g[off + s] = c;
    cnt[s] = c;
    if (gated) {
      pos[s] = pos_g[off + s];
      sc[s] = score_g[off + s];
      sq[s] = ssq_g[off + s];
    }
  }
  if (!gated) return;     // the gate is per block: the whole block leaves here
  __syncthreads();
  const int victim = select_victim(pos, sc, sq, cnt, val, S, policy, next_pos[b],
                                   prompt_len[b], rand_rank[b], recent_window, feasible_k,
                                   protect_prompt, redf, redi);
  if (tid == 0 && victim < S) pos_g[off + victim] = -1;
}

}  // namespace

extern "C" {

size_t write_update_smem(int S) { return (size_t)5 * 4 * S; }

// policy: 0 none (full), 1 h2o_head, 2 roco, 3 tova, 4 recency, 5 random.
// evict = 0 skips step 4 (evict_gate .. rand_rank may then be null).
// compact = 1 (needs evict = 1): step 4 shifts the row down at the victim
// and writes each row's victim slot (S: none) to vslot_out (L, B, H).
// k_sc_new, v_sc_new (L, B, H, 1) and k_scale, v_scale (L, B, H, S): the
// int8 cache's scale rows, or all null for a float cache.
// Updates pos / score / score_sq / counter (and the scale rows) in place.
// Returns cudaGetLastError().
int write_update(int* pos, float* score, float* score_sq, float* counter, const float* probs,
                 const float* p_new, const int* q_pos, const uint8_t* token_valid,
                 const uint8_t* update_gate, const float* counter_init,
                 const uint8_t* evict_gate, const int* next_pos, const int* prompt_len,
                 const int* rand_rank, const float* k_sc_new, const float* v_sc_new,
                 float* k_scale, float* v_scale, int* slot_out, int* vslot_out, int L, int B,
                 int H, int S, int policy, int evict, int compact, int recent_window,
                 int feasible_k, int protect_prompt, void* stream) {
  if (compact && (!evict || vslot_out == nullptr)) return (int)cudaErrorInvalidValue;
  const size_t smem = write_update_smem(S);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        write_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  write_update_kernel<<<L * B * H, kThreads, smem, (cudaStream_t)stream>>>(
      pos, score, score_sq, counter, probs, p_new, q_pos, token_valid, update_gate,
      counter_init, evict_gate, next_pos, prompt_len, rand_rank, k_sc_new, v_sc_new, k_scale,
      v_scale, slot_out, vslot_out, B, H, S, policy, evict, compact, recent_window,
      feasible_k, protect_prompt);
  return (int)cudaGetLastError();
}

// K4: one gated eviction event over (L, B, H, S) sidecars, decode phase,
// k = 1; policy as above (not 0). Updates pos and counter in place.
// Returns cudaGetLastError().
int evict(int* pos, const float* score, const float* score_sq, float* counter,
          const uint8_t* evict_gate, const int* next_pos, const int* prompt_len,
          const int* rand_rank, int L, int B, int H, int S, int policy, int recent_window,
          int feasible_k, int protect_prompt, void* stream) {
  if (policy == kNone) return (int)cudaErrorInvalidValue;
  const size_t smem = write_update_smem(S);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        evict_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  evict_kernel<<<L * B * H, kThreads, smem, (cudaStream_t)stream>>>(
      pos, score, score_sq, counter, evict_gate, next_pos, prompt_len, rand_rank, B, H, S,
      policy, recent_window, feasible_k, protect_prompt);
  return (int)cudaGetLastError();
}

}  // extern "C"
