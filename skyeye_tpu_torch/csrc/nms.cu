// Greedy class-offset NMS for Hopper (sm_90a) in three stages, behind a plain C interface.
//
// Replaces the Pallas TPU kernels in skyeye_tpu/ops/pallas/nms_kernel.py:
//   pallas_batched_greedy_nms / _nms_batched_kernel (K1) and
//   pallas_greedy_nms / _nms_kernel (K2).
// Both run the same three kernels (K2 as a batch of one), launched in order on
// one stream by ops/nms_kernel.py, which allocates every buffer below.
//
// Semantics (those of skyeye_tpu/ops/nms.py::_greedy_nms): each greedy step
// takes the live candidate with the highest score, ties to the lowest index,
// and stops at the first step whose winner is not > 0; every live candidate
// whose IoU with the winner is > iou_thres dies. So a row with a NaN score
// keeps nothing (JAX's argmax picks the NaN, which is not > 0). Unused output
// slots hold index 0 and valid 0.
//
// The design rests on an equivalence: greedy NMS keeps exactly the candidates
// that survive a walk in the order (score descending, index ascending) over the
// candidates with score > 0, where a candidate survives when no earlier kept
// candidate overlaps it by IoU > iou_thres, and the walk stops at max_det kept.
// Run as JAX writes it, the greedy loop is a chain of dependent block-wide
// argmaxes, most of each step the IEEE divisions of its IoU pass. The stages
// below do more arithmetic than the loop needs, but on every SM at once, and
// leave one short sequential walk:
//
//   1. order  (grid: image x 128 candidates) ranks each positive candidate by
//             count, the number of positive candidates ahead of it in the order,
//             against the image's scores staged in shared memory, 256 keys a
//             warp; a warp's keys wholly behind or wholly ahead of the block's
//             cost no compares, so input already in score order (the serving
//             cut's) ranks fast. It scatters each box to sorted_boxes[rank] and
//             its index to order[rank]; block 0 of each image writes n_pos and
//             has_nan.
//   2. mask   (tiles of 4 column words x 64 rows, upper triangle, on every SM)
//             builds mask[r][w], bit c of which is IoU(r, c) > iou_thres for
//             sorted positions r < c < n_pos. A block stages 256 column boxes in
//             shared memory; a thread builds one 64-bit word; the words leave
//             through shared memory so that each row's four are one store.
//   3. walk   (one warp an image) visits the sorted candidates 64 at a time,
//             until max_det are kept: it ORs word cb of every row kept so far
//             (loads in flight together with the block's diagonal words) into
//             the block's "removed" bits, then resolves the block's diagonal in
//             rounds of warp-wide ORs (__reduce_or_sync), each keeping every
//             live row that no live row before it overlaps. It loads only the
//             words of the blocks it visits, so an image that reaches max_det
//             early reads little of its mask.
//
// Words of the mask are defined for rows r < n_pos and words r/64 <= w <
// ceil(n_pos/64) (ops/nms_kernel.py::mask_defined); the walk reads no other.
//
// A walk that keeps max_det by sorted position p reads no mask word beyond
// (p, p), and skyeye_s's candidates at conf 0.001 (chip_smoke.py, seeded
// weights) keep 300 of 4096 by position 490-535. So K1
// and K2 (skyeye_nms) build the mask and walk in two passes: first the square
// of positions below `limit` (ops/nms_kernel.py::walk_limit: 4 max_det, at least
// 1024), whose walk marks an image done when it keeps max_det or runs out of
// candidates there; then, for the images not done, the rest of the mask and a
// walk from the start. The keep set is the one-pass walk's either way.
//
// Bound: the function needs O(steps * k) operations, microseconds of the
// card's float32 rate; this design spends n_pos^2 compares in the order stage
// and up to n_pos^2 / 2 IoUs in the mask stage to keep the chain short.
//
// Bit-exact IoU: build with -fmad=false and without --use_fast_math, so each
// operation rounds alone, and keep JAX's order of operations,
// inter / (area + barea - inter + 1e-7). min, max and the clamp at 0 propagate
// NaN as jnp.minimum, jnp.maximum and jnp.clip do (PTX's min.NaN / max.NaN;
// fminf and fmaxf would drop the NaN). The IoU of (r, c) serves both orders:
// min and max commute and area_r + area_c rounds as area_c + area_r.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kOrderThreads = 256;
constexpr int kOrderWarps = kOrderThreads / 32;
constexpr int kOrderRows = 128;                      // candidates a block ranks, 4 a lane
constexpr int kRowsPerLane = kOrderRows / 32;
constexpr int kOrderTile = 2048;                     // scores staged in shared memory at once
constexpr int kSegment = kOrderTile / kOrderWarps;   // keys of a tile that one warp counts

constexpr int kWordBits = 64;
constexpr int kMaskWords = 4;                        // words a mask block builds for each row
constexpr int kMaskThreads = kWordBits * kMaskWords;

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A score's place in the order: positive floats order as their bits, and
// every score that is not > 0 (NaN, zeros of either sign, negatives) is 0.
__device__ __forceinline__ uint32_t score_key(float s) { return s > 0.f ? __float_as_uint(s) : 0u; }

__device__ __forceinline__ float box_area(float4 b) {
  return max_nan(b.z - b.x, 0.f) * max_nan(b.w - b.y, 0.f);
}

// IoU(candidate c, kept r) > thr, in the JAX formula's order of operations.
__device__ __forceinline__ bool overlaps(float4 r, float area_r, float4 c, float area_c,
                                         float thr) {
  const float iw = max_nan(min_nan(c.z, r.z) - max_nan(c.x, r.x), 0.f);
  const float ih = max_nan(min_nan(c.w, r.w) - max_nan(c.y, r.y), 0.f);
  const float inter = iw * ih;
  // a zero intersection gives an IoU of 0, or NaN where an area is NaN: neither
  // is above a threshold >= 0, so the division can be skipped
  if (inter == 0.f && thr >= 0.f) return false;
  return inter / (area_c + area_r - inter + 1e-7f) > thr;
}

// count[q] += the keys seg[e0, e1) (multiples of 4) that are >= floor[q]
__device__ __forceinline__ void count_at_least(const uint4* seg, int e0, int e1,
                                               const uint32_t (&floor)[kRowsPerLane],
                                               int (&count)[kRowsPerLane]) {
#pragma unroll 4
  for (int e = e0 / 4; e < e1 / 4; ++e) {
    const uint4 v = seg[e];
#pragma unroll
    for (int q = 0; q < kRowsPerLane; ++q)
      count[q] += (v.x >= floor[q]) + (v.y >= floor[q]) + (v.z >= floor[q]) + (v.w >= floor[q]);
  }
}

// Stage 1. Grid (B, ceil(k / 128)). Each block ranks 128 candidates, every
// warp over its own eighth of each staged tile; blocks without a positive
// candidate leave at once, except block 0, which also counts the image's
// positives and NaN scores.
__global__ void __launch_bounds__(kOrderThreads)
nms_order_kernel(const float* __restrict__ boxes, const float* __restrict__ scores, int k,
                 float4* __restrict__ sorted_boxes, int32_t* __restrict__ order,
                 int32_t* __restrict__ n_pos, int32_t* __restrict__ has_nan) {
  __shared__ __align__(16) uint32_t s_key[kOrderTile];
  __shared__ int s_count[kOrderWarps][kOrderRows];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* sc = scores + static_cast<size_t>(b) * k;
  const int i0 = blockIdx.y * kOrderRows;
  const bool first = blockIdx.y == 0;

  uint32_t key[kRowsPerLane];
  int count[kRowsPerLane];
  bool mine = false;
#pragma unroll
  for (int q = 0; q < kRowsPerLane; ++q) {
    const int i = i0 + 32 * q + lane;
    key[q] = i < k ? score_key(sc[i]) : 0u;
    count[q] = 0;
    mine |= key[q] != 0u;
  }
  mine = __syncthreads_or(mine);  // any of the block's candidates
  if (!mine && !first) return;
  // the block's positive keys lie in [blk_lo, blk_hi]; every warp holds them all
  uint32_t blk_lo = 0xffffffffu, blk_hi = 0u;
#pragma unroll
  for (int q = 0; q < kRowsPerLane; ++q) {
    blk_lo = min(blk_lo, key[q] != 0u ? key[q] : 0xffffffffu);
    blk_hi = max(blk_hi, key[q]);
  }
  blk_lo = __reduce_min_sync(0xffffffffu, blk_lo);
  blk_hi = __reduce_max_sync(0xffffffffu, blk_hi);

  int positives = 0, nan = 0;
  for (int t0 = 0; t0 < k; t0 += kOrderTile) {
    bool any = false;
    for (int e = tid; e < kOrderTile; e += kOrderThreads) {
      const float s = t0 + e < k ? sc[t0 + e] : 0.f;
      s_key[e] = score_key(s);
      any |= s > 0.f;
      positives += s > 0.f;
      nan |= s != s;
    }
    if (__syncthreads_or(any) && mine) {
      // keys t0 + warp * kSegment + [0, kSegment): a candidate j is ahead of i
      // when key_j > key_i, or key_j == key_i and j < i; key 0 is never ahead
      const int j0 = t0 + warp * kSegment;
      const uint4* seg = reinterpret_cast<const uint4*>(s_key + warp * kSegment);
      // a segment wholly behind or wholly ahead of the block's keys costs no
      // compares: input already in score order, as the serving cut hands it,
      // meets little else
      uint32_t seg_lo = 0xffffffffu, seg_hi = 0u;
#pragma unroll
      for (int h = 0; h < kSegment / 128; ++h) {
        const uint4 v = seg[lane + 32 * h];
        seg_lo = min(seg_lo, min(min(v.x, v.y), min(v.z, v.w)));
        seg_hi = max(seg_hi, max(max(v.x, v.y), max(v.z, v.w)));
      }
      seg_lo = __reduce_min_sync(0xffffffffu, seg_lo);
      seg_hi = __reduce_max_sync(0xffffffffu, seg_hi);
      if (seg_hi < blk_lo) {
        // every j behind every positive i
      } else if (seg_lo > blk_hi) {
#pragma unroll
        for (int q = 0; q < kRowsPerLane; ++q) count[q] += kSegment;  // every j ahead
      } else {
        // [0, own): before every i of the block, ties count; [own, own_end): the
        // block's own candidates; [own_end, kSegment): after every i
        const int own = min(max(i0 - j0, 0), kSegment);
        const int own_end = min(max(i0 + kOrderRows - j0, 0), kSegment);
        uint32_t floor[kRowsPerLane];
#pragma unroll
        for (int q = 0; q < kRowsPerLane; ++q) floor[q] = key[q];
        count_at_least(seg, 0, own, floor, count);
#pragma unroll
        for (int q = 0; q < kRowsPerLane; ++q) floor[q] = key[q] + 1u;  // keys are at most 0x7f800000
        count_at_least(seg, own_end, kSegment, floor, count);
        for (int e = own; e < own_end; e += 4) {
          const uint4 v = seg[e / 4];
#pragma unroll
          for (int q = 0; q < kRowsPerLane; ++q) {
            const int r = own + 32 * q + lane;  // i's place in the segment: ties count before it
            count[q] += (v.x >= key[q] + (e >= r)) + (v.y >= key[q] + (e + 1 >= r)) +
                        (v.z >= key[q] + (e + 2 >= r)) + (v.w >= key[q] + (e + 3 >= r));
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kRowsPerLane; ++q) s_count[warp][32 * q + lane] = count[q];
  __syncthreads();
  if (tid < kOrderRows) {
    const int i = i0 + tid;
    if (i < k && score_key(sc[i]) != 0u) {
      int rank = 0;
#pragma unroll
      for (int w = 0; w < kOrderWarps; ++w) rank += s_count[w][tid];
      const float* bx = boxes + (static_cast<size_t>(b) * k + i) * 4;
      sorted_boxes[static_cast<size_t>(b) * k + rank] = make_float4(bx[0], bx[1], bx[2], bx[3]);
      order[static_cast<size_t>(b) * k + rank] = i;
    }
  }
  if (first) {  // the image's positives and NaN scores, reduced over the block
    const int any_nan = __syncthreads_or(nan);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) positives += __shfl_down_sync(0xffffffffu, positives, off);
    if (lane == 0) s_count[0][warp] = positives;
    __syncthreads();
    if (tid == 0) {
      int total = 0;
      for (int w = 0; w < kOrderWarps; ++w) total += s_count[0][w];
      n_pos[b] = total;
      has_nan[b] = any_nan;
    }
  }
}

// Stage 2. Tile (g, rb) is words 4g..4g+3 of rows 64 rb..64 rb + 63; thread
// (q, row) builds word 4g + q of one row. Grid (B, blocks): a block builds the
// tiles blockIdx.y, + gridDim.y, ... of its pass's tile grid. The first pass
// builds the tiles of positions below `limit` (a multiple of 256), the second,
// for each image its first walk left undone, every other tile.
__global__ void __launch_bounds__(kMaskThreads)
nms_mask_kernel(const float4* __restrict__ sorted_boxes, const int32_t* __restrict__ n_pos,
                const int32_t* __restrict__ done, int k, int nw, int limit, bool second,
                float iou_thres, uint64_t* __restrict__ mask) {
  __shared__ float4 s_box[kMaskThreads];
  __shared__ float s_area[kMaskThreads];
  __shared__ uint64_t s_word[kWordBits][kMaskWords];
  const int b = blockIdx.x, tid = threadIdx.x;
  if (second && done[b]) return;
  const int n = n_pos[b];
  const float4* bx = sorted_boxes + static_cast<size_t>(b) * k;
  uint64_t* out = mask + static_cast<size_t>(b) * k * nw;
  const int groups = second ? (nw + kMaskWords - 1) / kMaskWords : limit / kMaskThreads;
  const int row_blocks = second ? nw : limit / kWordBits;
  const int q = tid / kWordBits, row = tid % kWordBits;

  for (int t = blockIdx.y; t < groups * row_blocks; t += gridDim.y) {
    const int g = t % groups, rb = t / groups;
    const bool first_pass_tile = rb * kWordBits < limit && (g + 1) * kMaskThreads <= limit;
    // no row, left of the diagonal, or the other pass's: the same in every thread
    if (rb * kWordBits >= n || (g + 1) * kMaskWords <= rb || first_pass_tile == second) continue;
    {
      const int c = g * kMaskThreads + tid;
      const float4 v = c < n ? bx[c] : make_float4(0.f, 0.f, 0.f, 0.f);
      s_box[tid] = v;
      s_area[tid] = box_area(v);
    }
    __syncthreads();
    const int r = rb * kWordBits + row, w = g * kMaskWords + q;
    uint64_t word = 0;
    if (r < n && w >= rb && w * kWordBits < n) {
      const float4 me = bx[r];
      const float me_area = box_area(me);
      const int c0 = w * kWordBits;
      const int lo = r >= c0 ? r - c0 + 1 : 0;  // columns after r
      const int hi = min(kWordBits, n - c0);    // columns below n_pos
      for (int cc = lo; cc < hi; ++cc) {
        if (overlaps(me, me_area, s_box[q * kWordBits + cc], s_area[q * kWordBits + cc],
                     iou_thres))
          word |= 1ull << cc;
      }
    }
    s_word[row][q] = word;
    __syncthreads();
    // each row's four words are one 32-byte store
    const int out_row = tid / kMaskWords, out_w = g * kMaskWords + tid % kMaskWords;
    const int rr = rb * kWordBits + out_row;
    if (rr < n && out_w < nw)
      out[static_cast<size_t>(rr) * nw + out_w] = s_word[out_row][tid % kMaskWords];
  }
}

__device__ __forceinline__ uint64_t diagonal_word(const uint64_t* m, int nw, int n, int cb,
                                                  int row) {
  const int r = cb * kWordBits + row;
  return r < n ? m[static_cast<size_t>(r) * nw + cb] : 0ull;
}

constexpr int kGather = 8;  // loads of kept rows' words a lane has in flight

__device__ __forceinline__ uint64_t warp_or(uint64_t v) {
  const uint32_t lo = __reduce_or_sync(0xffffffffu, static_cast<uint32_t>(v));
  const uint32_t hi = __reduce_or_sync(0xffffffffu, static_cast<uint32_t>(v >> 32));
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// The OR of the diagonal words of the block's rows in `rows`; the lane holds
// those of rows lane (d0) and lane + 32 (d1).
__device__ __forceinline__ uint64_t diagonal_union(uint64_t rows, uint64_t d0, uint64_t d1,
                                                   int lane) {
  return warp_or(((rows >> lane) & 1ull ? d0 : 0ull) | ((rows >> (lane + 32)) & 1ull ? d1 : 0ull));
}

// Stage 3. One warp an image. The sorted positions of the rows kept so far
// (at most min(max_det, k)) are in dynamic shared memory where they fit in
// kKeptInSmem, else in the image's keep_idx row, which the end turns into the
// original indices in place (each lane reads and writes its own slots). The
// first pass walks the positions below `limit` and marks an image done (if
// done is given) when it kept max_det there or had no more; the second walks
// the images not done from the start, over all their positions.
template <bool InSmem>
__global__ void __launch_bounds__(32)
nms_walk_kernel(const uint64_t* __restrict__ mask, const int32_t* __restrict__ order,
                const int32_t* __restrict__ n_pos, const int32_t* __restrict__ has_nan, int k,
                int nw, int max_det, int limit, bool second, int32_t* __restrict__ done,
                int32_t* __restrict__ keep_idx, uint8_t* __restrict__ keep_valid) {
  extern __shared__ int32_t s_smem[];
  const int b = blockIdx.x, lane = threadIdx.x;
  if (second && done[b]) return;
  const int n_all = has_nan[b] ? 0 : n_pos[b];  // a NaN score: the greedy loop stops at once
  const int n = min(n_all, limit);
  const uint64_t* m = mask + static_cast<size_t>(b) * k * nw;
  const int32_t* ord = order + static_cast<size_t>(b) * k;
  int32_t* out_idx = keep_idx + static_cast<size_t>(b) * max_det;
  uint8_t* out_valid = keep_valid + static_cast<size_t>(b) * max_det;
  int32_t* s_kept = InSmem ? s_smem : out_idx;

  int kept = 0;
  for (int cb = 0; cb * kWordBits < n && kept < max_det; ++cb) {
    const int base = cb * kWordBits;
    // in flight together: the block's diagonal words (rows lane and lane + 32)
    // and word cb of every row kept so far, whose OR is what they remove here
    const uint64_t d0 = diagonal_word(m, nw, n, cb, lane);
    const uint64_t d1 = diagonal_word(m, nw, n, cb, lane + 32);
    uint64_t removed = 0ull;
    for (int t = lane; t < kept; t += 32 * kGather) {
      uint64_t v[kGather];
#pragma unroll
      for (int u = 0; u < kGather; ++u) {
        const int tt = t + 32 * u;
        v[u] = tt < kept ? m[static_cast<size_t>(s_kept[tt]) * nw + cb] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < kGather; ++u) removed |= v[u];
    }
    removed = warp_or(removed);

    // Resolve the block in rounds. A live row that no live row before it
    // overlaps is kept whatever the rest decide (a root; the first live row is
    // one); the roots' overlaps die. Sparse overlaps take a round or two.
    const int rows = min(kWordBits, n - base);
    uint64_t live = (rows == kWordBits ? ~0ull : (1ull << rows) - 1ull) & ~removed;
    uint64_t kept_bits = 0ull;
    while (live != 0ull) {  // the same values in every lane
      const uint64_t roots = live & ~diagonal_union(live, d0, d1, lane);
      kept_bits |= roots;
      live &= ~(roots | diagonal_union(roots, d0, d1, lane));
    }
    // the walk keeps them in order, up to max_det
    while (__popcll(kept_bits) > max_det - kept) kept_bits &= ~(1ull << (63 - __clzll(static_cast<long long>(kept_bits))));
    const int kept_before = kept;
    kept += __popcll(kept_bits);
#pragma unroll
    for (int h = lane; h < kWordBits; h += 32) {
      if ((kept_bits >> h) & 1ull)
        s_kept[kept_before + __popcll(kept_bits & ((1ull << h) - 1ull))] = base + h;
    }
    __syncwarp();
  }
  // the outputs, kGather original indices a lane in flight at a time
  for (int t0 = 0; t0 < max_det; t0 += 32 * kGather) {
    int32_t v[kGather];
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int t = t0 + 32 * u + lane;
      v[u] = t < kept ? ord[s_kept[t]] : 0;
    }
#pragma unroll
    for (int u = 0; u < kGather; ++u) {
      const int t = t0 + 32 * u + lane;
      if (t < max_det) {
        out_idx[t] = v[u];
        out_valid[t] = t < kept;
      }
    }
  }
  if (!second && done != nullptr && lane == 0) done[b] = kept == max_det || n_all <= limit;
}

constexpr int kMaxGridYZ = 65535;
// blocks of the mask's second pass, over all images: about one wave of 132 SMs
// at 8 blocks each; an image its first walk finished leaves at once
constexpr int kSecondPassBlocks = 1056;
// kept positions the walk holds in shared memory: 48 KiB, the default limit
constexpr int kKeptInSmem = 48 * 1024 / sizeof(int32_t);

int words_per_row(int k) { return (k + kWordBits - 1) / kWordBits; }

// The first pass over positions below `limit` (rounded up to whole tiles), or
// the second over the rest.
cudaError_t launch_mask(const float* sorted_boxes, const int32_t* n_pos, const int32_t* done,
                        int batch, int k, int limit, bool second, float iou_thres,
                        uint64_t* mask, cudaStream_t stream) {
  const int nw = words_per_row(k);
  if (batch <= 0 || k <= 0 || reinterpret_cast<uintptr_t>(sorted_boxes) % 16)
    return cudaErrorInvalidValue;
  limit = (limit + kMaskThreads - 1) / kMaskThreads * kMaskThreads;
  const long long tiles = second ? static_cast<long long>((nw + kMaskWords - 1) / kMaskWords) * nw
                                 : static_cast<long long>(limit / kMaskThreads) * (limit / kWordBits);
  long long blocks = tiles;  // an image's; each block loops over the tiles past its own
  if (second) blocks = std::min(blocks, (kSecondPassBlocks + batch - 1LL) / batch);
  blocks = std::min(blocks, static_cast<long long>(kMaxGridYZ));
  nms_mask_kernel<<<dim3(batch, static_cast<unsigned>(blocks)), kMaskThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(sorted_boxes), n_pos, done, k, nw, limit, second,
      iou_thres, mask);
  return cudaGetLastError();
}

cudaError_t launch_walk(const uint64_t* mask, const int32_t* order, const int32_t* n_pos,
                        const int32_t* has_nan, int batch, int k, int max_det, int limit,
                        bool second, int32_t* done, int32_t* keep_idx, uint8_t* keep_valid,
                        cudaStream_t stream) {
  if (batch <= 0 || k <= 0 || max_det <= 0) return cudaErrorInvalidValue;
  const int held = std::min(max_det, k);
  if (held <= kKeptInSmem)
    nms_walk_kernel<true><<<batch, 32, held * sizeof(int32_t), stream>>>(
        mask, order, n_pos, has_nan, k, words_per_row(k), max_det, limit, second, done,
        keep_idx, keep_valid);
  else
    nms_walk_kernel<false><<<batch, 32, 0, stream>>>(
        mask, order, n_pos, has_nan, k, words_per_row(k), max_det, limit, second, done,
        keep_idx, keep_valid);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Stage 1 of K1/K2. boxes (B, k, 4) and scores (B, k) float32, any alignment;
// writes sorted_boxes (B, k, 4) (16-byte aligned) and order (B, k) for the
// first n_pos[b] positions of each image, n_pos (B,) and has_nan (B,).
// Returns a cudaError_t.
int skyeye_nms_order(const float* boxes, const float* scores, int batch, int k,
                     float* sorted_boxes, int32_t* order, int32_t* n_pos, int32_t* has_nan,
                     void* stream) {
  // blocks of 128 candidates on grid.y: k up to 8.4 M, whose mask no card holds
  const int row_blocks = (k + kOrderRows - 1) / kOrderRows;
  if (batch <= 0 || k <= 0 || row_blocks > kMaxGridYZ ||
      reinterpret_cast<uintptr_t>(sorted_boxes) % 16)
    return cudaErrorInvalidValue;
  const dim3 grid(batch, row_blocks);
  nms_order_kernel<<<grid, kOrderThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      boxes, scores, k, reinterpret_cast<float4*>(sorted_boxes), order, n_pos, has_nan);
  return static_cast<int>(cudaGetLastError());
}

// Stage 2 alone, in one pass: mask (B, k, ceil(k / 64)) uint64 from stage 1's
// sorted_boxes and n_pos. Returns a cudaError_t.
int skyeye_nms_mask(const float* sorted_boxes, const int32_t* n_pos, int batch, int k,
                    float iou_thres, uint64_t* mask, void* stream) {
  return static_cast<int>(launch_mask(sorted_boxes, n_pos, nullptr, batch, k, k, false,
                                      iou_thres, mask, static_cast<cudaStream_t>(stream)));
}

// Stage 3 alone, in one pass: keep_idx (B, max_det) int32 and keep_valid
// (B, max_det) bool from the mask, order, n_pos and has_nan. Returns a
// cudaError_t.
int skyeye_nms_walk(const uint64_t* mask, const int32_t* order, const int32_t* n_pos,
                    const int32_t* has_nan, int batch, int k, int max_det, int32_t* keep_idx,
                    uint8_t* keep_valid, void* stream) {
  return static_cast<int>(launch_walk(mask, order, n_pos, has_nan, batch, k, max_det, k, false,
                                      nullptr, keep_idx, keep_valid,
                                      static_cast<cudaStream_t>(stream)));
}

// K1 and K2 (a batch of one), with the buffers of
// ops/nms_kernel.py::scratch_layout, on one stream: the order; the mask of the
// positions below `limit` and the walk over them; where limit < k, the rest of
// the mask and the whole walk for the images that first walk left undone (it
// kept fewer than max_det and had more positions). Returns a cudaError_t.
int skyeye_nms(const float* boxes, const float* scores, int batch, int k, float iou_thres,
               int max_det, int limit, float* sorted_boxes, int32_t* order, int32_t* n_pos,
               int32_t* has_nan, int32_t* done, uint64_t* mask, int32_t* keep_idx,
               uint8_t* keep_valid, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (limit <= 0) return cudaErrorInvalidValue;
  limit = (limit + kMaskThreads - 1) / kMaskThreads * kMaskThreads;  // whole tiles
  if (limit > k) limit = k;
  int err = skyeye_nms_order(boxes, scores, batch, k, sorted_boxes, order, n_pos, has_nan,
                             stream);
  if (err == 0)
    err = launch_mask(sorted_boxes, n_pos, nullptr, batch, k, limit, false, iou_thres, mask, s);
  if (err == 0)
    err = launch_walk(mask, order, n_pos, has_nan, batch, k, max_det, limit, false, done,
                      keep_idx, keep_valid, s);
  if (err == 0 && limit < k)
    err = launch_mask(sorted_boxes, n_pos, done, batch, k, limit, true, iou_thres, mask, s);
  if (err == 0 && limit < k)
    err = launch_walk(mask, order, n_pos, has_nan, batch, k, max_det, k, true, done, keep_idx,
                      keep_valid, s);
  return err;
}

}  // extern "C"
